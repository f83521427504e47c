// The GAT layer's projection for Hopper, in one launch:
//   out = leaky(x w1 + b1, alpha) w2 + b2
// x [N, D], w1 [D, D], w2 [D, F]; fp32 operands, fp64 sums.
//
// Replaces the TPU kernel mpe3d_tpu/ops/fused_proj.py::_pallas_proj (:48,
// pallas_call :68; entry fused_linear_leaky_linear :84), the projection of
// the per-layer GAT (mpe3d_tpu/models/gat.py::_gat_layer, proj :175-189).
// Python side and plain PyTorch version: mpe3d_tpu_torch/ops/fused_proj.py.
//
// As on the TPU, where the intermediate stays in VMEM, each block keeps its
// rows of the intermediate h = leaky(x w1 + b1) in shared memory and runs
// fc2 from there: h never goes to device memory.
//
// Precision: fp32 operands (no TF32, no bf16: the reference runs this
// product at precision="highest"); every sum is accumulated in fp64, where
// each fp32 product is exact, and rounded to fp32 once with its bias: h is
// stored as its fp32 value, as the reference stores it.  fp32 sums drifted
// to 1.46e-3 on the trained matcher's logits in the tiled GAT kernels'
// first form (gat_tiled.cu); fp64 sums keep this kernel well inside the
// 1e-5 x (1 + max |out|) it is held to.
//
// Bound on an H100 SXM, per frame of the default 5-layer matcher (in_dim
// 902, layers 902->902->400, 400->400->400, 400->400->320, 320->320->150,
// 150->150->1): rows x 2 x 1.96 M weights, 0.70 GFLOP at S=4 (180 rows),
// 10.3 GFLOP at S=16 (2640 rows); at the 67 TFLOP/s fp32 peak 10.5 us and
// 154 us: compute-bound (the 7.8 MB of weights are 2.3 us at 3.35 TB/s).
// This first version is simple and right: a block owns RT = 8 rows, stages
// them in shared memory as fp64 (so the inner loop converts only the
// weight, once per RT fused multiply-adds: fp32 -> fp64 conversions run at a
// quarter of the fp64 FMA rate), and each thread owns output columns, reading
// weight rows coalesced across the warp and broadcasting the staged rows.
// fp64 FMA runs at half the fp32 rate, so 2x the fp32 bound is the floor of
// this design; the grid is ceil(N / 8) blocks (23 at S=4, 330 at S=16), so
// small buckets leave most SMs idle.

#include <cuda_runtime.h>

#include "fp32_gemm.cuh"

namespace {

using mpe3d::leaky;

constexpr int RT = 8;           // rows a block owns
constexpr int THREADS = 256;
constexpr int MAX_D = 1024;     // input / hidden width: 2 x RT x D doubles
                                // of shared memory (128 KB at 1024)

// acc[r] = sum_k a[k][r] * w[k * ld + c] over k < K, fp64, k ascending;
// a is [K][RT] in shared memory.
__device__ __forceinline__ void column_sums(const double* __restrict__ a,
                                            const float* __restrict__ w,
                                            size_t ld, int c, int K,
                                            double* acc) {
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.0;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const double wv = double(w[(size_t)k * ld + c]);
    const double2* ak = reinterpret_cast<const double2*>(a + (size_t)k * RT);
#pragma unroll
    for (int r = 0; r < RT / 2; ++r) {
      const double2 v = ak[r];
      acc[2 * r] = fma(v.x, wv, acc[2 * r]);
      acc[2 * r + 1] = fma(v.y, wv, acc[2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
fused_proj_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ out,
                  int N, int D, int F, float alpha) {
  extern __shared__ double smem[];
  double* xs = smem;                       // [D][RT]: this block's rows of x
  double* hs = smem + (size_t)D * RT;      // [D][RT]: their intermediate
  const size_t row0 = (size_t)blockIdx.x * RT;
  const int rows = min(RT, N - (int)row0);

  for (int i = threadIdx.x; i < RT * D; i += THREADS) {
    const int r = i / D, k = i % D;
    xs[(size_t)k * RT + r] =
        r < rows ? double(x[(row0 + r) * D + k]) : 0.0;
  }
  __syncthreads();
  double acc[RT];
  for (int c = threadIdx.x; c < D; c += THREADS) {
    column_sums(xs, w1, D, c, D, acc);
    const double bc = double(b1[c]);
#pragma unroll
    for (int r = 0; r < RT; ++r)
      hs[(size_t)c * RT + r] = double(leaky(float(acc[r] + bc), alpha));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < F; c += THREADS) {
    column_sums(hs, w2, F, c, D, acc);
    const double bc = double(b2[c]);
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (r < rows) out[(row0 + r) * F + c] = float(acc[r] + bc);
  }
}

}  // namespace

// x [N, D], w1 [D, D], b1 [D], w2 [D, F], b2 [F], out [N, F]; all fp32 and
// contiguous, D <= 1024.
extern "C" int gat_fused_proj(const float* x, const float* w1,
                              const float* b1, const float* w2,
                              const float* b2, float* out, int N, int D,
                              int F, float alpha, cudaStream_t stream) {
  if (N < 1 || D < 1 || D > MAX_D || F < 1) return cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(double) * RT * (size_t)D;
  cudaError_t err = cudaFuncSetAttribute(
      fused_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_proj_kernel<<<(N + RT - 1) / RT, THREADS, smem, stream>>>(
      x, w1, b1, w2, b2, out, N, D, F, alpha);
  return cudaGetLastError();
}
