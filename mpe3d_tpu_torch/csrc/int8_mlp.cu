// One int8 weight-only lifter layer for Hopper:
//   y = act(((x * rscale) -> bf16) @ wq, fp32 sums) * scale + b)
// with int8 weights wq, fp32 per-output-column scales and per-input-row
// scales (the two-sided quantisation of models/mlp.py), for any row count.
//
// Replaces two TPU kernels that compute the same layer:
//   * the int8 layer kind of mpe3d_tpu/ops/fused_mlp.py::_fused_mlp_call
//     (:57, int8 branches :80-83, :93, :126; pallas_call :143);
//   * mpe3d_tpu/ops/quant_matmul.py::_pallas_int8_matmul (:73, pallas_call
//     :94; entry int8_weight_matmul :109, oracle xla_int8_matmul :44).
// Python side and plain PyTorch version: mpe3d_tpu_torch/ops/quant_matmul.py.
//
// Numerics follow both TPU kernels: the row scale folds into the fp32
// activation (one fp32 multiply), the product is rounded to bf16 (round to
// nearest even); int8 -> bf16 is exact for |q| <= 127 and every bf16 x int8
// product is exact in fp32, so the only roundings are the fp32 sums (fixed
// order here), then acc * scale and + b as two rounded operations (no
// contraction), then LeakyReLU.
//
// Bound on an H100 SXM: the 8 int8 layers of the 29.1 M-param serving lifter
// stream 29.0 MB of weights per frame for at most 16 rows of activations,
// 8.7 us at 3.35 TB/s; their 0.47 GFLOP at 8 rows is far below any compute
// peak.  Weight streaming is everything.  Design, as the bf16 layer kernel
// (fused_mlp.cu): each block owns a slab of 32 output columns, so one
// 32-byte sector of a weight row; lane quads read a sector as four 8-byte
// loads, so every weight byte is read once, coalesced; 64 K-rows are in
// flight per block step; the input rows sit in shared memory in chunks of
// 512 K with the row scale folded in; partial sums are reduced with warp
// shuffles and then across the block's 8 warps in a fixed order.  int8 is
// turned into fp32 with a byte permute and one fp32 subtract (exact), not
// with the conversion unit, which runs at a quarter of the FMA rate.  Rows
// beyond 16 take a second grid dimension of 16-row tiles, each streaming the
// weights again.  No K alignment is needed: rows are read one at a time with
// stride N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 32;      // output columns per block
constexpr int KC = 512;       // K rows of x staged in shared memory at a time
constexpr int THREADS = 256;  // 8 warps; 64 K-rows x 4 column groups
constexpr int ROW_TILE = 16;  // rows of one block

// 8 int8 weights (little-endian bytes of v) -> fp32: each byte, biased by
// 128 into 0..255, becomes the low mantissa byte of 2^23 (0x4B000000), so
// float(bits) - (2^23 + 128) is the signed value, exactly.
__device__ __forceinline__ void unpack_int8x8(const uint2 v, float* f) {
  const uint32_t u[2] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[4 * h + i] =
          __uint_as_float(__byte_perm(u[h], 0x4B000000u, 0x7540u | i)) -
          8388736.f;
}

template <int MR>
__global__ void __launch_bounds__(THREADS)
mlp_int8_layer_kernel(const float* __restrict__ x,
                      const int8_t* __restrict__ wq,
                      const float* __restrict__ scale,
                      const float* __restrict__ rscale,
                      const float* __restrict__ b, float* __restrict__ y,
                      int M, int K, int N, float alpha, int act) {
  // x chunk while streaming; the cross-warp partial sums afterwards
  __shared__ float smem[MR * KC];
  float(*xs)[KC] = reinterpret_cast<float(*)[KC]>(smem);
  float(*red)[MR][COLS] = reinterpret_cast<float(*)[MR][COLS]>(smem);
  static_assert(THREADS / 32 * COLS <= KC, "partial sums fit the x buffer");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg = lane & 3;                  // which 8 columns of the slab
  const int kr = warp * 8 + (lane >> 2);    // this thread's K row, 0..63
  const int n0 = blockIdx.x * COLS + cg * 8;
  const size_t m0 = (size_t)blockIdx.y * ROW_TILE;
  const int rows = min(MR, M - (int)m0);
  x += m0 * K;
  y += m0 * N;

  float acc[MR][8];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < MR * KC; i += THREADS) {
      const int m = i / KC, k = i % KC;
      float v = 0.f;
      if (m < rows && k < kc) {
        v = x[(size_t)m * K + k0 + k];
        if (rscale != nullptr) v = __fmul_rn(v, rscale[k0 + k]);
      }
      xs[m][k] = __bfloat162float(__float2bfloat16_rn(v));
    }
    __syncthreads();
#pragma unroll 4
    for (int k = kr; k < kc; k += 64) {
      const uint2 raw = *reinterpret_cast<const uint2*>(
          wq + (size_t)(k0 + k) * N + n0);
      float wf[8];
      unpack_int8x8(raw, wf);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float xv = xs[m][k];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, wf[j], acc[m][j]);
      }
    }
  }

  // lanes sharing a column group differ in lane bits 2..4
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
  __syncthreads();                          // done with xs: reuse as red
  if ((lane >> 2) == 0) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[warp][m][cg * 8 + j] = acc[m][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * COLS; i += THREADS) {
    const int m = i / COLS, c = i % COLS;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < THREADS / 32; ++wi) s += red[wi][m][c];
    const int n = blockIdx.x * COLS + c;
    float v = __fmul_rn(s, scale[n]);
    if (b != nullptr) v = __fadd_rn(v, b[n]);
    if (act) v = v > 0.f ? v : __fmul_rn(alpha, v);
    y[(size_t)m * N + n] = v;
  }
}

}  // namespace

// x [M, K] fp32, wq [K, N] int8 (8-byte aligned), scale [N] fp32, rscale [K]
// fp32 or null (no row scales), b [N] fp32 or null, y [M, N] fp32; M >= 1,
// N a multiple of 32.  act != 0 applies LeakyReLU(alpha).
extern "C" int mlp_int8_layer(const float* x, const void* wq,
                              const float* scale, const float* rscale,
                              const float* b, float* y, int M, int K, int N,
                              float alpha, int act, cudaStream_t stream) {
  if (M < 1 || K < 1 || N < COLS || N % COLS != 0 ||
      reinterpret_cast<uintptr_t>(wq) % 8 != 0)
    return cudaErrorInvalidValue;
  const int8_t* w = static_cast<const int8_t*>(wq);
  const dim3 grid(N / COLS, (M + ROW_TILE - 1) / ROW_TILE);
  if (M <= 8)
    mlp_int8_layer_kernel<8><<<grid, THREADS, 0, stream>>>(
        x, w, scale, rscale, b, y, M, K, N, alpha, act);
  else
    mlp_int8_layer_kernel<16><<<grid, THREADS, 0, stream>>>(
        x, w, scale, rscale, b, y, M, K, N, alpha, act);
  return cudaGetLastError();
}
