"""Device time of the decode + gather + pack kernel by phase, on the card.

    python3 -m mpe3d_tpu_torch.tools.decode_phases

Builds a copy of ``csrc/frame_decode_pack.cu`` in which thread 0 reads the
%globaltimer after a block barrier at each phase boundary (the eligible
pairs' keys, their order, the candidates, the walk, persons, the gather,
the prior) into its own library under ``mpe3d_tpu_torch/_build/``, calls
it on the inputs ``tools/gat_timing.py`` times (the S=4 random-matcher
frame for each prior, with k_cap 64 and with no pair eligible; the S=16
frame scored by geometric consistency at k_cap 64 and k_cap = E, "mean" and
IRLS), and prints the median microseconds of each phase over 30 calls with
the eligible pairs, trips and persons of the call, as one JSON line a case.
The barriers the stamps add make the total a little longer than the
kernel's own time.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

from mpe3d_tpu_torch.ops import _build
from mpe3d_tpu_torch.ops import frame_kernel as fk

PHASES = ("keys", "order", "walk", "persons", "gather", "prior")
STAMP = ("{ __syncthreads(); if (threadIdx.x == 0) { unsigned long long t; "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
         "g_stamps[K] = t; } }\n")
# (a line of the kernel, the stamp index, the stamp before or after it)
MARKS = (("  const Layout lay(E, H, P, C, Cu, J, S);\n  int* cluster", 0,
          "before"),
         ("  const int n_elig = n_elig_s;\n", 1, "after"),
         ("  // ---- the walk: one warp", 2, "before"),
         ("  // ---- components -> persons", 3, "before"),
         ("  // ---- gather and fields 0-9", 4, "before"),
         ("  // ---- triangulated prior, gate", 5, "before"))
END = "item % J, q);\n  }\n}\n"


def instrumented_source() -> str:
    """The kernel source with the phase stamps and a reader of them."""
    src = (_build.SRC_DIR / "frame_decode_pack.cu").read_text()
    for line, k, where in MARKS + ((END, 6, "end"),):
        if src.count(line) != 1:
            raise RuntimeError(f"decode_phases: the kernel changed, no single "
                               f"{line!r} to stamp")
        stamp = STAMP.replace("K]", f"{k}]")
        if where == "end":
            counts = ("  if (threadIdx.x == 0) { g_stamps[8] = n_elig; "
                      "g_stamps[9] = n_live; g_stamps[10] = n_persons; }\n")
            src = src.replace(line, line[:-2] + stamp + counts + "}\n")
        else:
            src = src.replace(line, stamp + line if where == "before"
                              else line + stamp)
    src = src.replace("namespace {\n", "__device__ unsigned long long "
                      "g_stamps[16];\nnamespace {\n", 1)
    return src + ('\nextern "C" int read_stamps(unsigned long long* out) '
                  '{ return cudaMemcpyFromSymbol(out, g_stamps, '
                  'sizeof(g_stamps)); }\n')


def build() -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "decode_phases.cu"
    lib = _build.BUILD_DIR / "libdecode_phases.so"
    src.write_text(instrumented_source())
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-o", str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    cdll = ctypes.CDLL(str(lib))
    cdll.frame_decode_pack.argtypes = _build._SIGNATURES["frame_decode_pack"]
    cdll.frame_decode_pack.restype = ctypes.c_int
    cdll.read_stamps.argtypes = [ctypes.c_void_p]
    return cdll


def phases(lib, args, kw, n: int = 30) -> dict:
    """Median microseconds of each phase of ``n`` calls on these inputs."""
    out = fk.frame_decode_pack(*args, **kw)       # buffers of the outputs
    rows = []
    for _ in range(n):
        code = lib.frame_decode_pack(
            *(t.data_ptr() for t in args), args[0].shape[0], kw["n_cameras"],
            args[4].shape[1], args[4].shape[2], args[4].shape[0], kw["P"],
            kw["threshold"], kw["min_views"], kw["k_cap"],
            fk.PRIORS.index(kw["prior"]), int(kw["gate_px"] is not None),
            0.0 if kw["gate_px"] is None else kw["gate_px"],
            float(kw["image_size"][0]), float(kw["image_size"][1]),
            *(t.data_ptr() for t in out), 1,
            torch.cuda.current_stream().cuda_stream)
        _build.check(code, "decode_phases")
        torch.cuda.synchronize()
        stamps = (ctypes.c_ulonglong * 16)()
        lib.read_stamps(stamps)
        rows.append(list(stamps))
    res = {name: statistics.median((r[i + 1] - r[i]) / 1e3 for r in rows)
           for i, name in enumerate(PHASES)}
    res["total"] = statistics.median((r[6] - r[0]) / 1e3 for r in rows)
    res["eligible, trips, persons"] = rows[0][8:11]
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_phases: no CUDA device", file=sys.stderr)
        return 1
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.checkpoint import (load_lifter_checkpoint,
                                            load_matcher_checkpoint)
    from mpe3d_tpu_torch.config import PANOPTIC, LifterConfig, MatcherConfig
    from mpe3d_tpu_torch.data.frames import parse_frame
    from mpe3d_tpu_torch.data.synthetic import (generate_frames,
                                                synthetic_ring_rig)
    from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline
    from mpe3d_tpu_torch.tools import gat_timing
    lib = build()
    rc, demo = PANOPTIC, os.path.join(gat_timing.REPO, "models_demo",
                                      "pan_irls_bf16")
    rig = synthetic_ring_rig(rc)
    mtree, mcfg = load_matcher_checkpoint(
        os.path.join(demo, "skeleton_matching"),
        MatcherConfig(in_dim=rc.matcher_feature_dim))
    ltree, lcfg, prior = load_lifter_checkpoint(
        os.path.join(demo, "pose_estimator"),
        LifterConfig(in_dim=rc.lifter_input_dim, out_dim=rc.n_joints * 3))

    def pipeline(S, tree):
        return PoseEstimationPipeline(
            rc, rig, weights.matcher_from_tree(tree, mcfg, "cuda"),
            weights.lifter_from_tree(ltree, lcfg, "cuda"), slot_buckets=(S,),
            person_buckets=(8 if S == 4 else 16,), lifter_prior=prior,
            device="cuda")

    f4 = parse_frame(generate_frames(rc, rig, 1, n_people=(2, 3),
                                     seed=1)[0], rc)
    f16 = parse_frame(generate_frames(rc, rig, 1, n_people=(10, 14),
                                      seed=2)[0], rc, max_skeletons=16)
    args, kw = pipeline(4, weights.random_matcher_tree(mcfg, 0)
                        ).frame_stage_inputs(f4)
    for p in fk.PRIORS:
        for label, extra in (("k64", {}),
                             ("k0", {"threshold": float("inf")})):
            print(json.dumps({"case": f"S=4 {p} {label}", **phases(
                lib, args, dict(kw, prior=p, **extra))}), flush=True)
    cargs, ckw = gat_timing.crowded_decode_inputs(pipeline(16, mtree), f16)
    for label, k_cap in (("k64", 64), ("kE", ckw["k_cap"])):
        for p in ("mean", "irls"):
            print(json.dumps({"case": f"S=16 {p} {label}", **phases(
                lib, cargs, dict(ckw, k_cap=k_cap, prior=p))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
