// One lifter layer for Hopper: y = act(bf16(x) W + b), bf16 weights, fp32
// accumulation, for at most 16 rows.
//
// Replaces the bf16 layer kind of the TPU kernel
// mpe3d_tpu/ops/fused_mlp.py::_fused_mlp_call (pallas_call at :143; entry
// fused_mlp_forward :223, packing pack_fused_layers :154).  Python side and
// plain PyTorch version: mpe3d_tpu_torch/ops/fused_mlp.py.
//
// Numerics follow the TPU kernel (fused_mlp.py:114-117): activations stay
// fp32 between layers and are rounded to bf16 (round to nearest even) as
// operands; bf16 x bf16 products are exact in fp32 and summed in fp32.
//
// Bound on an H100 SXM: the serving lifter (1260->3072->3072->2048->2048->
// 1024x4->54) streams 58.3 MB of bf16 weights per frame for 8 rows of
// activations -- 17.4 us at 3.35 TB/s, against 0.47 GFLOP (0.5 us of the
// bf16 tensor-core peak).  Weight streaming is everything.  Design: each
// block owns a slab of 16 output columns; lane pairs read one 32-byte sector
// of a weight row as two 16-byte vector loads, so every weight byte is read
// once, coalesced; 128 K-rows are in flight per block; the <=16 input rows
// sit in shared memory in chunks of 512 K; partial sums are reduced with warp
// shuffles and then across the block's 8 warps in a fixed order.  The wrapper
// launches it once per layer (9 launches per frame); one persistent launch for
// the whole network is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 16;      // output columns per block
constexpr int KC = 512;       // K rows of x staged in shared memory at a time
constexpr int THREADS = 256;  // 8 warps; 128 K-rows x 2 column groups

__device__ __forceinline__ void unpack_bf16x8(const uint4 v, float* f) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);            // lower address
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

template <int MR>
__global__ void __launch_bounds__(THREADS)
mlp_bf16_layer_kernel(const float* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ b, float* __restrict__ y,
                      int M, int K, int N, float slope, int act) {
  __shared__ float xs[MR][KC];
  __shared__ float red[THREADS / 32][MR][COLS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg = lane & 1;                  // which 8 columns of the slab
  const int kr = warp * 16 + (lane >> 1);   // this thread's K row, 0..127
  const int n0 = blockIdx.x * COLS + cg * 8;

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
      const float v = (m < M && k < kc) ? x[(size_t)m * K + k0 + k] : 0.f;
      xs[m][k] = __bfloat162float(__float2bfloat16_rn(v));
    }
    __syncthreads();
#pragma unroll 4
    for (int k = kr; k < kc; k += 128) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          w + (size_t)(k0 + k) * N + n0);
      float wf[8];
      unpack_bf16x8(raw, wf);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float xv = xs[m][k];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, wf[j], acc[m][j]);
      }
    }
  }

  // lanes sharing a column group differ in lane bits 1..4
#pragma unroll
  for (int off = 2; off < 32; off <<= 1)
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
  if ((lane >> 1) == 0) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[warp][m][cg * 8 + j] = acc[m][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * COLS; i += THREADS) {
    const int m = i / COLS, c = i % COLS;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < THREADS / 32; ++wi) s += red[wi][m][c];
    const int n = blockIdx.x * COLS + c;
    float v = s + b[n];
    if (act) v = v >= 0.f ? v : slope * v;
    y[(size_t)m * N + n] = v;
  }
}

}  // namespace

// x [M, K] fp32, w [K, N] bf16 (16-byte aligned), b [N] fp32, y [M, N] fp32;
// M <= 16, N a multiple of 16.
extern "C" int mlp_bf16_layer(const float* x, const void* w, const float* b,
                              float* y, int M, int K, int N, float slope,
                              int act, cudaStream_t stream) {
  if (M < 1 || M > 16 || N % COLS != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;
  const dim3 grid(N / COLS);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  if (M <= 8)
    mlp_bf16_layer_kernel<8><<<grid, THREADS, 0, stream>>>(x, wb, b, y, M, K,
                                                           N, slope, act);
  else
    mlp_bf16_layer_kernel<16><<<grid, THREADS, 0, stream>>>(x, wb, b, y, M,
                                                            K, N, slope, act);
  return cudaGetLastError();
}
