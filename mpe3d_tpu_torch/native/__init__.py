"""The port's C++ wire parser and result formatter, bound with ctypes.

Port of ``mpe3d_tpu/native/__init__.py`` with its own copy of the source
(``frameparse.cpp``): a single-pass parser of wire JSON into dense
``[F, C, S, J]`` buffers (``parse_frames_native``, sized exactly by the
counting pass ``count_frames_native``) and the serve response serializer
(``format_result_native``).  The library is built at first use with
``g++`` into ``mpe3d_tpu_torch/_build/libmpe3d_torch_frame.so`` (git-
ignored), and again when the source is newer than the library.  Its name
and directory are the port's own, so the port never loads the JAX
package's build.

When ``g++`` or the build fails, ``load_library`` returns None (with one
line on stderr) and every function here returns None: callers take the
python path (``data/frames.py::parse_frame``, ``json.dumps``), which is
host code with the same results.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "frameparse.cpp"
BUILD_DIR = SRC.parent.parent / "_build"
LIB_PATH = BUILD_DIR / "libmpe3d_torch_frame.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _build() -> None:
    """Compile to a per-process name and rename into place, so concurrent
    first uses never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_PATH.name}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)


def load_library() -> Optional[ctypes.CDLL]:
    """Build (once) and load the library; None on any failure."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if (not LIB_PATH.exists()
                    or LIB_PATH.stat().st_mtime < SRC.stat().st_mtime):
                _build()
            lib = ctypes.CDLL(str(LIB_PATH))
        except (OSError, subprocess.SubprocessError) as e:
            print(f"[mpe3d_torch.native] build/load failed "
                  f"({type(e).__name__}: {e}); using the python parser",
                  file=sys.stderr)
            _lib = None
            return None
        lib.mpe3d_count_frames.restype = ctypes.c_int64
        lib.mpe3d_count_frames.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.mpe3d_parse_frames_v3.restype = ctypes.c_int
        lib.mpe3d_parse_frames_v3.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64,
            f32, f32, f32, u8, u8,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mpe3d_format_result.restype = ctypes.c_int64
        lib.mpe3d_format_result.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            f32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_double, ctypes.c_char_p, ctypes.c_int64,
        ]
        _lib = lib
        return lib


def count_frames_native(text: bytes) -> Optional[int]:
    """Exact top-level frame count (None if the library is unavailable or
    the text does not open a list)."""
    lib = load_library()
    if lib is None:
        return None
    if isinstance(text, str):
        text = text.encode()
    n = lib.mpe3d_count_frames(text, len(text))
    return None if n < 0 else int(n)


def format_result_native(seq: int, poses: np.ndarray,
                         quality: Optional[np.ndarray] = None,
                         track_ids: Optional[np.ndarray] = None,
                         dropped: int = 0,
                         latency_ms: float = 0.0) -> Optional[str]:
    """One serve response line (``serve.PoseServer._finish``'s record:
    poses 4 decimals, quality 2, latency 3), newline included; None when
    the library is unavailable or a value is non-finite (the caller then
    serialises with ``json.dumps``)."""
    lib = load_library()
    if lib is None:
        return None
    poses = np.ascontiguousarray(poses, np.float32)
    P = int(poses.shape[0])
    J = int(poses.shape[1]) if poses.ndim == 3 else 0
    q_buf = (np.ascontiguousarray(quality, np.float32)
             if quality is not None else None)
    t_buf = (np.ascontiguousarray(track_ids, np.int32)
             if track_ids is not None else None)
    if (q_buf is not None and q_buf.shape != (P,)) or (
            t_buf is not None and t_buf.shape != (P,)):
        raise ValueError(f"format_result_native: quality and track_ids must "
                         f"have one entry a pose ({P})")
    cap = 128 + P * 48 + P * J * 3 * 16
    out = ctypes.create_string_buffer(cap)
    n = lib.mpe3d_format_result(
        seq, dropped, poses, P, J,
        q_buf.ctypes.data if q_buf is not None else None,
        t_buf.ctypes.data if t_buf is not None else None,
        float(latency_ms), out, cap)
    if n <= 0:
        return None
    return out.raw[:n].decode()


def parse_frames_native(text: bytes, camera_names: Sequence[str],
                        max_skeletons: int, n_joints: int,
                        with_gt: bool = False, max_gt_persons: int = 16
                        ) -> Optional[Tuple[np.ndarray, ...]]:
    """Parse a wire JSON list of frames into dense buffers.

    Returns (kp [F,C,S,J,2], valid, prob, in_view, present, timestamps),
    plus (gt [F,C,P,J,3] in wire cm, gt_valid [F,C,P,J], gt_pvalid [F,C,P],
    gt_count [F,C] with -1 where the camera entry had no GT list, gt_order
    [F,C]: the camera key's position in the frame, -1 where absent) with
    ``with_gt``; None when the library is unavailable or the text does not
    parse."""
    lib = load_library()
    if lib is None:
        return None
    if isinstance(text, str):
        text = text.encode()
    C, S, J = len(camera_names), max_skeletons, n_joints
    n = lib.mpe3d_count_frames(text, len(text))
    if n < 0:
        return None
    F_cap = max(int(n), 1)
    kp = np.zeros((F_cap, C, S, J, 2), np.float32)
    valid = np.zeros((F_cap, C, S, J), np.float32)
    prob = np.zeros((F_cap, C, S, J), np.float32)
    in_view = np.zeros((F_cap, C, S, J), np.uint8)
    present = np.zeros((F_cap, C, S), np.uint8)
    ts = np.zeros((F_cap, C), np.float64)
    if with_gt:
        P = max_gt_persons
        gt = np.zeros((F_cap, C, P, J, 3), np.float32)
        gt_valid = np.zeros((F_cap, C, P, J), np.uint8)
        gt_pvalid = np.zeros((F_cap, C, P), np.uint8)
        gt_count = np.full((F_cap, C), -1, np.int32)
        gt_order = np.full((F_cap, C), -1, np.int32)
        gt_args = (gt.ctypes.data, gt_valid.ctypes.data,
                   gt_pvalid.ctypes.data, gt_count.ctypes.data,
                   gt_order.ctypes.data, P)
    else:
        gt_args = (None, None, None, None, None, 0)
    names = (ctypes.c_char_p * C)(*[c.encode() for c in camera_names])
    n_out = ctypes.c_int64(0)
    rc = lib.mpe3d_parse_frames_v3(text, len(text), names, C, S, J, F_cap,
                                   kp, valid, prob, in_view, present, ts,
                                   *gt_args, ctypes.byref(n_out))
    if rc != 0:
        return None
    F = n_out.value
    out = (kp[:F], valid[:F], prob[:F], in_view[:F].astype(bool),
           present[:F].astype(bool), ts[:F])
    if with_gt:
        out = out + (gt[:F], gt_valid[:F].astype(bool),
                     gt_pvalid[:F].astype(bool), gt_count[:F],
                     gt_order[:F])
    return out
