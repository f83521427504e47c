"""Build and load the port's CUDA kernels: one shared library, bound with
``ctypes``.

Every ``csrc/*.cu`` file (with the shared ``csrc/*.cuh`` headers) exposes
plain ``extern "C"`` functions (device pointers, sizes, a
``cudaStream_t``; they return ``cudaGetLastError()`` after their
launches), so the build needs neither PyTorch's headers nor ``ninja``.
Each source compiles in its own ``nvcc`` process, all started together::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c -o _build/<source>.o csrc/<source>.cu

and one more call links the objects::

    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o _build/libmpe3d_kernels.so _build/*.o

at first use, into ``mpe3d_tpu_torch/_build/`` (git-ignored), and again only
when a hash of the sources and flags changes.  A missing ``nvcc`` or a
failed build raises with the compiler's output, once every compiler it
started has ended.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_PATH = BUILD_DIR / "libmpe3d_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")
LINK_FLAGS = ARCH_FLAGS + ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argtypes of every exported function: pointers and the stream as c_void_p
# (ctypes would otherwise pass Python ints as 32-bit C ints and cut them)
_SIGNATURES = {
    # x0, pw, e1, e2, inc, weights, dims(host), splits(host), n_layers, H,
    # E, D, edge_const, alpha, slope, h1, z, xa, xb, out, stream
    "gat_stack_forward": [_P] * 6 + [ctypes.POINTER(_I)] * 2 + [_I] * 5
                         + [_F, _F] + [_P] * 6,
    # x, w1, b1, w2, b2, attn_l, attn_r, pw, e1, e2, H, E, d_in, nh, d,
    # edge_const, alpha, slope, last, s1, s2, h1, z, att, l1m, l2m, xout,
    # stream
    "gat_k1_layer": [_P] * 10 + [_I] * 6 + [_F, _F] + [_I] * 3 + [_P] * 7,
    # l1m, l2m, pw, head_ptr, head_ent, z, att, H, nh, d, edge_const, alpha,
    # slope, xout, stream
    "gat_k2_layer": [_P] * 7 + [_I] * 4 + [_F, _F, _P, _P],
    # e1, e2, H, E, head_ptr, head_ent, stream
    "gat_tiled_incidence": [_P, _P, _I, _I, _P, _P, _P],
    # x, pw, e1, e2, weights, layers(host int64), n_layers, H, E, alpha,
    # slope, h1, z, att, l1m, l2m, head_ptr, head_ent, acts, out, stream
    "gat_tiled_stack": [_P] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
                       + [_I] * 3 + [_F, _F] + [_P] * 10,
    # x, y, layers, tiles, block_tiles, ws, n_sync, acts_off, parts_off,
    # M, n_layers, n_blocks, slope, any_int8, stream
    "mlp_run": [_P] * 6 + [_I, ctypes.c_longlong, ctypes.c_longlong]
               + [_I] * 3 + [_F, _I, _P],
    "mlp_run_blocks": [],
    # x, w1, b1, w2, b2, out, h, ldh, N, D, F, alpha, s1, s2, stream
    "gat_fused_proj": [_P] * 7 + [_I] * 4 + [_F, _I, _I, _P],
    # scores, pmask, pairs, used_pos, kp, valid, prob, observed, cams,
    # cam_world, E, C, S, J, Cu, P, threshold, min_views, k_cap, prior,
    # gate_on, gate_px, img_w, img_h, persons, person_mask, net, gkp, gval,
    # gobs, B, stream
    "frame_decode_pack": [_P] * 10 + [_I] * 6 + [_F, _I, _I, _I, _I]
                         + [_F] * 3 + [_P] * 6 + [_I, _P],
}


@dataclass
class KernelLibrary:
    cdll: ctypes.CDLL
    build_seconds: float      # 0.0 when the cached build matched
    compiler_output: str      # nvcc's stderr (ptxas register/spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (searched PATH and $CUDA_HOME/bin, "
                       "default /usr/local/cuda/bin): the CUDA kernels of "
                       "mpe3d_tpu_torch cannot be built")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


@functools.lru_cache(maxsize=1)
def library() -> KernelLibrary:
    """The loaded kernel library, built first if the sources changed."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    digest = _digest(sources + sorted(SRC_DIR.glob("*.cuh")))
    stamp = BUILD_DIR / "libmpe3d_kernels.sha256"
    log = BUILD_DIR / "build.log"
    seconds = 0.0
    if not (LIB_PATH.exists() and stamp.exists()
            and stamp.read_text() == digest):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        output = _compile_and_link(sources)
        seconds = time.perf_counter() - t0
        log.write_text(output)
        stamp.write_text(digest)
    cdll = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(cdll, seconds,
                         log.read_text() if log.exists() else "")


def _compile_and_link(sources) -> str:
    """Compile every source in its own ``nvcc`` process, all at once, then
    link the objects into ``LIB_PATH``; returns the compilers' output."""
    nvcc, tag = _nvcc(), os.getpid()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    jobs = []
    for src, obj in zip(sources, objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE,
                                           text=True)))
    outputs, failed = [], []
    for cmd, proc in jobs:              # wait for every compiler first
        out, err = proc.communicate()
        outputs.append(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}{err}")
    tmp = BUILD_DIR / f"libmpe3d_kernels.{tag}.so"
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):"
                               f"\n{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return "".join(outputs)


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
