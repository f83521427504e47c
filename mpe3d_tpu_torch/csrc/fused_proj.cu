// The GAT layer's projection for Hopper, on the fp64 tensor cores:
//   h = leaky(x w1 + b1, alpha),  out = h w2 + b2
// x [N, D], w1 [D, D], w2 [D, F]; fp32 operands, fp64 sums.
//
// Replaces the TPU kernel mpe3d_tpu/ops/fused_proj.py::_pallas_proj (:48,
// pallas_call :68; entry fused_linear_leaky_linear :84), the projection of
// the per-layer GAT (mpe3d_tpu/models/gat.py::_gat_layer, proj :175-189).
// Python side, tile plan and plain PyTorch version:
// mpe3d_tpu_torch/ops/fused_proj.py.
//
// Precision: fp32 operands (no TF32, no bf16: the reference runs this
// product at precision="highest"); every product is exact and every sum is
// an fp64 sum (f64_mma.cuh), rounded to fp32 once with its bias; h is stored
// as its fp32 value, as the reference stores it.  fp32 sums drifted to
// 1.46e-3 on the trained matcher's logits in the tiled GAT kernels' first
// form (gat_tiled.cu).
//
// Bound on an H100 SXM, per frame of the default 5-layer matcher (layers
// 902->902->400, 400->400->400, 400->400->320, 320->320->150, 150->150->1):
// rows x 2 x 1.96 M weights, 0.70 GFLOP at S=4 (180 rows), 10.3 GFLOP at
// S=16 (2640 rows); at 67 TFLOP/s (the fp32 SIMT peak, and the fp64
// tensor-core peak) 10.5 us and 154 us: compute-bound (the 7.8 MB of
// weights are 2.3 us at 3.35 TB/s).
//
// Design: each product is a 2-D tiled GEMM of 64 x 64 block tiles on the
// fp64 tensor cores, the shared GEMM of the three GAT kernels (f64_gemm in
// f64_mma.cuh: a 4-stage cp.async ring, fused bias (+ LeakyReLU)
// epilogue), two CUDA launches a call: fc1 with the bias + LeakyReLU
// epilogue into an fp32 scratch h (L2-resident: 0.65 MB at S=4, 9.5 MB at
// S=16; rows padded to a multiple of 4 floats), then fc2 with the bias
// epilogue.  A GEMM with fewer tiles than SMs splits k across the blocks
// of a thread-block cluster (the split count, at most 8, comes from the
// tile plan, ops/fused_proj.py::proj_plan, which fills the 132 SMs at
// S=4) and sums the partial tiles in split order through distributed
// shared memory: no partial goes to device memory, no atomics, the same
// bits from run to run.

#include <cuda_runtime.h>

#include "f64_mma.cuh"

// x [N, D], w1 [D, D], b1 [D], w2 [D, F], b2 [F], out [N, F], all fp32 and
// contiguous; h: [N, ldh] fp32 scratch, ldh >= D (a multiple of 4 lets fc2
// copy h in 16-byte pieces).  s1, s2: k-splits (cluster sizes, 1..8) of fc1
// and fc2 (proj_plan).  Two launches on ``stream``, no synchronisation.
extern "C" int gat_fused_proj(const float* x, const float* w1,
                              const float* b1, const float* w2,
                              const float* b2, float* out, float* h, int ldh,
                              int N, int D, int F, float alpha, int s1,
                              int s2, cudaStream_t stream) {
  const cudaError_t err = mpe3d::f64_gemm(x, D, w1, b1, h, ldh, N, D, D, s1,
                                          alpha, 1, stream);
  if (err != cudaSuccess) return err;
  return mpe3d::f64_gemm(h, ldh, w2, b2, out, F, N, F, D, s2, 0.f, 0,
                         stream);
}
