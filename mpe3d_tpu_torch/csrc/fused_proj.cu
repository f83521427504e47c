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
// fp64 tensor cores (f64_tile_product, a 4-stage cp.async ring), two CUDA
// launches a call: fc1 with the bias + LeakyReLU epilogue into an fp32
// scratch h (L2-resident: 0.65 MB at S=4, 9.5 MB at S=16; rows padded to a
// multiple of 4 floats), then fc2 with
// the bias epilogue.  A GEMM with fewer tiles than SMs splits k across the
// blocks of a thread-block cluster (the split count, at most 8, comes from
// the tile plan, ops/fused_proj.py::proj_plan, which fills the 132 SMs at
// S=4): each block leaves its fp64 partial tile in its own shared memory,
// the cluster synchronises, and block r sums slice r of the tile over the
// cluster's blocks in split order through distributed shared memory.  No
// partial goes to device memory, there are no counters and no atomics, and
// the sum is the same bit for bit from run to run.  Block b is split
// b % splits (its cluster rank) of tile b / splits, tiles row-major over
// (row tile, column tile), as the plan enumerates them.  The shared-memory
// attribute is set once per process.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "f64_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using mpe3d::F64_BK;
using mpe3d::F64_BM;
using mpe3d::F64_BN;
using mpe3d::F64_MI;
using mpe3d::F64_NI;
using mpe3d::F64_THREADS;
using mpe3d::F64Acc;
using mpe3d::F64Smem;
using mpe3d::f64_acc_col;
using mpe3d::f64_acc_row;
using mpe3d::f64_tile_product;

constexpr int TILE = F64_BM * F64_BN;

__device__ __forceinline__ float leaky(float v, float a) {
  return v >= 0.f ? v : a * v;
}

// C[M, N] = epi(A[M, K] B[K, N] + bias); epi = LeakyReLU(alpha) if act.
// Launched in clusters of ``splits`` blocks along x.
__global__ void __launch_bounds__(F64_THREADS)
proj_gemm_kernel(const float* __restrict__ A, int lda,
                 const float* __restrict__ B, const float* __restrict__ bias,
                 float* __restrict__ C, int ldc, int M, int N, int K,
                 int splits, float alpha, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  F64Smem& s = *reinterpret_cast<F64Smem*>(smem);
  const int tiles_n = (N + F64_BN - 1) / F64_BN;
  const int ksteps = (K + F64_BK - 1) / F64_BK;
  const int tile = blockIdx.x / splits, split = blockIdx.x % splits;
  const int row0 = (tile / tiles_n) * F64_BM, col0 = (tile % tiles_n) * F64_BN;
  const int ks0 = (int)((long long)split * ksteps / splits);
  const int ks1 = (int)((long long)(split + 1) * ksteps / splits);

  F64Acc acc;
#pragma unroll
  for (int mi = 0; mi < F64_MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < F64_NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0;
  f64_tile_product(s, A, lda, B, M, N, K, row0, col0, ks0, ks1, acc);

  if (splits == 1) {
#pragma unroll
    for (int mi = 0; mi < F64_MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < F64_NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + f64_acc_row(mi, e);
          const int c = col0 + f64_acc_col(ni, e);
          if (r < M && c < N) {
            const float v = float(acc[mi][ni][e] + double(bias[c]));
            C[(size_t)r * ldc + c] = act ? leaky(v, alpha) : v;
          }
        }
    return;
  }

  // the partial tile in this block's (now idle) ring: 32 KB of its 74 KB
  double* part = reinterpret_cast<double*>(smem);
  static_assert(sizeof(double) * TILE <= sizeof(F64Smem), "tile fits");
#pragma unroll
  for (int mi = 0; mi < F64_MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < F64_NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[f64_acc_row(mi, e) * F64_BN + f64_acc_col(ni, e)] =
            acc[mi][ni][e];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int i0 = split * TILE / splits, i1 = (split + 1) * TILE / splits;
  for (int i = i0 + threadIdx.x; i < i1; i += F64_THREADS) {
    const int r = row0 + i / F64_BN, c = col0 + i % F64_BN;
    if (r >= M || c >= N) continue;
    double sum = 0.0;
    for (int p = 0; p < splits; ++p)
      sum += cluster.map_shared_rank(part, p)[i];
    const float v = float(sum + double(bias[c]));
    C[(size_t)r * ldc + c] = act ? leaky(v, alpha) : v;
  }
  cluster.sync();   // no block leaves while another reads its tile
}

int blocks(int M, int N, int splits) {
  return ((M + F64_BM - 1) / F64_BM) * ((N + F64_BN - 1) / F64_BN) * splits;
}

cudaError_t launch(const float* A, int lda, const float* B,
                   const float* bias, float* C, int ldc, int M, int N, int K,
                   int splits, float alpha, int act, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks(M, N, splits));
  cfg.blockDim = dim3(F64_THREADS);
  cfg.dynamicSmemBytes = sizeof(F64Smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, proj_gemm_kernel, A, lda, B, bias, C, ldc,
                            M, N, K, splits, alpha, act);
}

}  // namespace

// x [N, D], w1 [D, D], b1 [D], w2 [D, F], b2 [F], out [N, F], all fp32 and
// contiguous; h: [N, ldh] fp32 scratch, ldh >= D (a multiple of 4 lets fc2
// copy h in 16-byte pieces).  s1, s2: k-splits (cluster sizes, 1..8) of fc1
// and fc2 (proj_plan).  Two launches on ``stream``, no synchronisation.
extern "C" int gat_fused_proj(const float* x, const float* w1,
                              const float* b1, const float* w2,
                              const float* b2, float* out, float* h, int ldh,
                              int N, int D, int F, float alpha, int s1,
                              int s2, cudaStream_t stream) {
  static cudaError_t setup = cudaFuncSetAttribute(
      proj_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(F64Smem));
  if (setup != cudaSuccess) return setup;
  const int kmax = (D + F64_BK - 1) / F64_BK;
  if (N < 1 || D < 1 || F < 1 || ldh < D || s1 < 1 || s2 < 1 || s1 > 8 ||
      s2 > 8 || s1 > kmax || s2 > kmax)
    return cudaErrorInvalidValue;
  cudaError_t err =
      launch(x, D, w1, b1, h, ldh, N, D, D, s1, alpha, 1, stream);
  if (err != cudaSuccess) return err;
  err = launch(h, ldh, w2, b2, out, F, N, F, D, s2, 0.f, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
