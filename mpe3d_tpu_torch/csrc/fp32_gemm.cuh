// Shared pieces of the GAT kernels (gat_stack.cu, gat_tiled.cu): the
// LeakyReLU and a tiled GEMM of fp32 operands with a fused bias + LeakyReLU
// epilogue.  No tensor cores, no TF32, no bf16: rounded operands move pair
// scores across the 0.5 decision threshold.  The accumulator type is a
// template parameter; both GAT kernels instantiate double (every fp32
// product is exact in fp64, the sum is rounded to fp32 once).
#pragma once

#include <cuda_runtime.h>

// Internal linkage: every .cu that includes this header gets its own copy,
// so the one shared library links without duplicate kernel symbols.
namespace mpe3d {
namespace {

constexpr int BM = 64, BN = 64, BK = 16;   // GEMM tile; 256 threads, 4x4 each

__device__ __forceinline__ float leaky(float v, float a) {
  return v >= 0.f ? v : a * v;
}

__device__ __forceinline__ double fma_acc(double a, double b, double c) {
  return fma(a, b, c);
}

// C[M, N] = act(A[M, K] B[K, N] + bias[N]); row-major, k ascending, sums in
// Acc.
template <typename Acc>
__global__ void __launch_bounds__(256)
gemm_bias_act(const float* __restrict__ A, const float* __restrict__ B,
              const float* __restrict__ bias, float* __restrict__ C,
              int M, int N, int K, float slope, int act) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  Acc acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += 256) {
      const int m = i / BK, k = i % BK;
      const int gr = row0 + m, gk = k0 + k;
      As[k][m] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : 0.f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += 256) {
      const int k = i / BN, n = i % BN;
      const int gk = k0 + k, gc = col0 + n;
      Bs[k][n] = (gk < K && gc < N) ? B[(size_t)gk * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fma_acc(Acc(a[i]), Acc(b[j]), acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= N) continue;
      float v = float(acc[i][j] + Acc(bias[c]));
      if (act) v = leaky(v, slope);
      C[(size_t)r * N + c] = v;
    }
  }
}

// Launch C = act(A B + bias) for A [M, K], B [K, N] on one stream.
template <typename Acc>
inline void launch_gemm(const float* A, const float* B, const float* bias,
                        float* C, int M, int N, int K, float slope, int act,
                        cudaStream_t stream) {
  gemm_bias_act<Acc><<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM), 256, 0,
                  stream>>>(A, B, bias, C, M, N, K, slope, act);
}

}  // namespace
}  // namespace mpe3d
