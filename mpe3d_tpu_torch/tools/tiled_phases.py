"""Device time of the tiled GAT's incidence build and K2 by phase, on the
card.

    python3 -m mpe3d_tpu_torch.tools.tiled_phases

Builds a copy of ``csrc/gat_tiled.cu`` in which thread 0 of every block
reads the %globaltimer after a block barrier at each phase boundary into
its own library under ``mpe3d_tpu_torch/_build/``: of ``tiled_incidence``
(its loads, the segment counts, the two scans, the placement walk) and of
``k2_heads`` (the head max, the weight staging, the sums, the epilogue).
Calls them on the inputs ``chip_smoke.py`` gives the tiled stack at
Panoptic S=16 (frame 0 of ``generate_frames(..., n_people=(10, 14),
seed=2)``, the trained matcher of ``models_demo/pan_irls_bf16``), K2 of
each layer on the plain K1's state of that layer, and prints, as one JSON
line each, the median nanoseconds of each phase over 30 calls (K2: the
median over the blocks, and the span from the first block's start to the
last block's end).  The barriers the stamps add make a kernel a little
longer than it is.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

from mpe3d_tpu_torch.ops import _build, gat_tiled

INC_PHASES = ("loads", "counts", "scan_segments", "scan_heads", "placement")
K2_PHASES = ("head_max", "staging", "sums", "epilogue")
MAX_BLOCKS = 4096
STAMP = ("{ __syncthreads(); if (threadIdx.x == 0) { unsigned long long t; "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
         "g_stamps[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + K] = t; } }\n")
# (a line of the kernel, the stamp index, the stamp before or after it)
MARKS = (
    ("  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;\n"
     "  const int n_ent", 0, "before"),
    ("  for (int st = 0; st < steps; ++st) {          // pass 1: segment "
     "counts\n", 1, "before"),
    ("  for (int h = warp; h < H; h += INC_WARPS) {   // scan across the "
     "segments\n", 2, "before"),
    ("  if (warp == 0) {                              // scan across the "
     "heads\n", 3, "before"),
    ("  for (int st = 0; st < steps; ++st) {          // pass 2: placement\n",
     4, "before"),
    ("*off += __popc(peers);\n    __syncwarp();\n  }\n", 5, "after"),
    ("  const int h = blockIdx.x, tid = threadIdx.x, F = nh * d;\n", 0,
     "before"),
    ("    atomicMax(&smax[tid], max_key(ls));\n  }\n  __syncthreads();\n", 1,
     "after"),
    ("      w = p > 0.f ? expf(float(w) - key_value(smax[kk])) * p : 0.f;\n"
     "    }\n    __syncthreads();\n", 2, "after"),
    ("  if (den_owner) {\n    const float es", 3, "before"),
    ("    xout[(size_t)h * F + f] = leaky(v, slope);\n  }\n", 4, "after"),
)


def instrumented_source() -> str:
    """The kernel source with the phase stamps and a reader of them."""
    src = (_build.SRC_DIR / "gat_tiled.cu").read_text()
    for line, k, where in MARKS:
        if src.count(line) != 1:
            raise RuntimeError(f"tiled_phases: the kernel changed, no single "
                               f"{line!r} to stamp")
        stamp = STAMP.replace("+ K]", f"+ {k}]")
        src = src.replace(line, stamp + line if where == "before"
                          else line + stamp)
    src = src.replace("namespace {\n", "__device__ unsigned long long "
                      f"g_stamps[8 * {MAX_BLOCKS}];\nnamespace {{\n", 1)
    return src + ('\nextern "C" int read_stamps(unsigned long long* out, '
                  'int n) { return cudaMemcpyFromSymbol(out, g_stamps, '
                  'n * sizeof(unsigned long long)); }\n')


def build() -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "tiled_phases.cu"
    lib = _build.BUILD_DIR / "libtiled_phases.so"
    src.write_text(instrumented_source())
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                           str(_build.SRC_DIR), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    cdll = ctypes.CDLL(str(lib))
    for name in ("gat_tiled_incidence", "gat_k2_layer"):
        getattr(cdll, name).argtypes = _build._SIGNATURES[name]
        getattr(cdll, name).restype = ctypes.c_int
    cdll.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return cdll


def phases(lib, fn, args, names, n_blocks: int, n: int = 30) -> dict:
    """Median nanoseconds of each phase (the median block of each call),
    and of the span of the whole grid, over ``n`` calls."""
    rows, spans = [], []
    for _ in range(n):
        _build.check(getattr(lib, fn)(*args), fn)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (8 * n_blocks))()
        lib.read_stamps(buf, 8 * n_blocks)
        blocks = [buf[8 * b:8 * b + len(names) + 1] for b in range(n_blocks)]
        rows.append([statistics.median(s[i + 1] - s[i] for s in blocks)
                     for i in range(len(names))])
        spans.append(max(s[-1] for s in blocks) - min(s[0] for s in blocks))
    out = {name: statistics.median(r[i] for r in rows)
           for i, name in enumerate(names)}
    out["span"] = statistics.median(spans)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("tiled_phases: no CUDA device", file=sys.stderr)
        return 1
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.checkpoint import (load_lifter_checkpoint,
                                            load_matcher_checkpoint)
    from mpe3d_tpu_torch.config import PANOPTIC, LifterConfig, MatcherConfig
    from mpe3d_tpu_torch.data.frames import parse_frame
    from mpe3d_tpu_torch.data.synthetic import (generate_frames,
                                                synthetic_ring_rig)
    from mpe3d_tpu_torch.ops.gat_kernel import layer_views
    from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline
    from mpe3d_tpu_torch.tools import gat_timing
    lib = build()
    rc, demo = PANOPTIC, os.path.join(gat_timing.REPO, "models_demo",
                                      "pan_irls_bf16")
    rig = synthetic_ring_rig(rc)
    mtree, mcfg = load_matcher_checkpoint(
        os.path.join(demo, "skeleton_matching"),
        MatcherConfig(in_dim=rc.matcher_feature_dim))
    ltree, lcfg, _ = load_lifter_checkpoint(
        os.path.join(demo, "pose_estimator"),
        LifterConfig(in_dim=rc.lifter_input_dim, out_dim=rc.n_joints * 3))
    pipe = PoseEstimationPipeline(
        rc, rig, weights.matcher_from_tree(mtree, mcfg, "cuda"),
        weights.lifter_from_tree(ltree, lcfg, "cuda"), slot_buckets=(16,),
        person_buckets=(16,), lifter_prior="mean", device="cuda")
    f16 = parse_frame(generate_frames(rc, rig, 1, n_people=(10, 14),
                                      seed=2)[0], rc, max_skeletons=16)
    x, pw, gtopo, _ = pipe.gat_stage_inputs(f16)
    m = pipe.matcher
    H, E = gtopo.n_heads, gtopo.n_pairs
    alpha, slope = m.cfg.alpha, m.cfg.hidden_slope
    stream = torch.cuda.current_stream().cuda_stream
    inc = torch.empty(H + 1 + 2 * E, dtype=torch.int32, device="cuda")
    ptr, ent = inc.data_ptr(), inc.data_ptr() + 4 * (H + 1)
    print(json.dumps({"kernel": "tiled_incidence", "H": H, "E": E, **phases(
        lib, "gat_tiled_incidence", (gtopo.e1.data_ptr(),
                                     gtopo.e2.data_ptr(), H, E, ptr, ent,
                                     stream), INC_PHASES, 1)}), flush=True)
    e1, e2 = gtopo.e1.long(), gtopo.e2.long()
    xin = x
    for l, ((_, d, nh), lw) in enumerate(zip(m.dims[:-1],
                                             layer_views(m.flat, m.dims))):
        const = l == 0
        xe, state = gat_tiled.k1_plain(xin, pw, e1, e2, H, lw, nh, d, alpha,
                                       slope, False, const)
        z, a1, a2, l1m, l2m = state
        z = z.reshape(z.shape[0], -1).contiguous()
        att = torch.cat([a1, a2], 1).contiguous()
        l1m, l2m = l1m.contiguous(), l2m.contiguous()
        out = torch.empty((H + E, nh * d), device="cuda")
        args = (l1m.data_ptr(), l2m.data_ptr(), pw.data_ptr(), ptr, ent,
                z.data_ptr(), att.data_ptr(), H, nh, d, int(const), alpha,
                slope, out.data_ptr(), stream)
        n_blocks = H * -(-nh * d // 128)
        print(json.dumps({"kernel": "k2_heads", "layer": l,
                          "blocks": n_blocks, **phases(
                              lib, "gat_k2_layer", args, K2_PHASES,
                              n_blocks)}), flush=True)
        xin = torch.cat([gat_tiled.k2_plain(state, pw, e1, e2, H, nh, d,
                                            alpha, slope, const), xe])
    return 0


if __name__ == "__main__":
    sys.exit(main())
