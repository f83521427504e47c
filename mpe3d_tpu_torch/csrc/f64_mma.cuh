// An fp64 tensor-core tile product of fp32 operands for Hopper (sm_90):
//   acc[64 x 64] += A[row0 :, k] B[k, col0 :]  over a range of k,
// A [M, K] and B [K, N] row-major fp32, acc in fp64 registers.  Every fp32
// product is exact in fp64 and every sum is an fp64 sum, so a caller that
// rounds acc + bias to fp32 once gets the fp64-summed result of the
// reference's precision="highest" product, with no TF32 or bf16 rounding.
//
// Why the tensor cores: the H100 runs fp64 mma.sync at 67 TFLOP/s (SXM data
// sheet), the same rate as its fp32 SIMT peak and twice its fp64 SIMT FMA,
// so fp64 sums no longer cost 2x.
//
// Shape: a block of 128 threads (4 warps, 2 x 2) owns a 64 x 64 tile; a warp
// owns 32 x 32 = 2 m16 x 4 n8 fragments of mma.sync.m16n8k8.f64 (sm_90);
// 64 x 32 warp tiles (128 x 64 blocks) spilled registers and ran slower on
// the H100 (PERF.md PR 8).  k advances in stages of BK = 32 through a
// 4-deep cp.async ring of fp32 tiles, A stored [m][k] (row stride 36
// floats) and B [k][n] (72 floats), strides at which the fragment loads hit
// 32 distinct banks.  Each fragment element is loaded as fp32 and converted
// to fp64 in registers: on the H100 that beat converting each stage once
// into an fp64 tile, which doubled the shared-memory bytes of every
// fragment load and cost a second barrier a stage (PERF.md PR 8).  Rows of
// A and of B are copied in
// 16-byte pieces where the row stride and the base allow (the scratch h of
// the projection is padded for it), else in 8-byte pieces (even strides:
// the GAT widths 902 and 150), else in 4-byte ones.  Out-of-range rows,
// columns and k are zero-filled by the copy itself.
//
// On it, f64_gemm (end of this header) is the one GEMM of the three GAT
// kernels: the fc1/fc2 products of gat_stack.cu, of K1 in gat_tiled.cu and
// of the projection in fused_proj.cu.  It tiles C in 64 x 64 block tiles
// with a fused bias (+ LeakyReLU) epilogue and splits k over the blocks of
// a thread-block cluster where a GEMM has fewer tiles than the card has
// SMs; the split counts come from the tile plan
// (ops/fused_proj.py::gemm_plan).
//
// Internal linkage: every .cu that includes this header gets its own copy
// of the kernel, so the one shared library links without duplicate
// symbols.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mpe3d {
namespace {

constexpr int F64_BM = 64, F64_BN = 64, F64_BK = 32, F64_STAGES = 4;
constexpr int F64_THREADS = 128;
constexpr int F64_WM = 32, F64_WN = 32;   // warp tile
constexpr int F64_MI = F64_WM / 16, F64_NI = F64_WN / 8;
constexpr int F64_LDA = F64_BK + 4;       // floats: [m][k] rows of A
constexpr int F64_LDB = F64_BN + 8;       // floats: [k][n] rows of B

// 73.7 KB of dynamic shared memory (three blocks an SM)
struct F64Smem {
  float a32[F64_STAGES][F64_BM * F64_LDA];
  float b32[F64_STAGES][F64_BK * F64_LDB];
};

// a warp's accumulators: F64_MI x F64_NI fragments of 4 doubles
using F64Acc = double[F64_MI][F64_NI][4];

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 or 16 bytes global -> shared; ``bytes`` < size zero-fills the rest
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d += a b for one m16n8k8 fp64 fragment: a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4); b0 (t, g), b1 (t+4, g); d0/d1 (g, 2t / 2t+1),
// d2/d3 (g+8, 2t / 2t+1), with g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void mma_f64_16x8x8(double (&d)[4],
                                               const double (&a)[4],
                                               const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Copy the floats [c, c + V) of a row of ``len`` floats (zero past ``len``
// or when the row is out of range) in one V * 4-byte piece
template <int V>
__device__ __forceinline__ void copy_piece(uint32_t dst, const float* row,
                                           int c, int len, bool row_ok) {
  const int valid = row_ok ? max(0, min(V, len - c)) : 0;
  const float* src = valid ? row + c : row;
  if (V == 4)
    cp_async16(dst, src, 4 * valid);
  else if (V == 2)
    cp_async8(dst, src, 4 * valid);
  else
    cp_async4(dst, src, 4 * valid);
}

// rows x cols floats of ``src`` (row stride ld; rows from r0 < R, columns
// from c0 < C) into ``dst`` (row stride dld) in V-float pieces
template <int V>
__device__ __forceinline__ void copy_tile(uint32_t dst, int dld,
                                          const float* __restrict__ src,
                                          size_t ld, int rows, int cols,
                                          int r0, int R, int c0, int C) {
  for (int i = threadIdx.x; i < rows * cols / V; i += F64_THREADS) {
    const int r = i / (cols / V), c = (i % (cols / V)) * V;
    copy_piece<V>(dst + 4 * (r * dld + c), src + (size_t)(r0 + r) * ld, c0 + c,
                  C, r0 + r < R);
  }
}

// Issue the copies of k-stage ``ks`` (k in [32 ks, 32 ks + 32)) into ring
// slot ``slot``: A rows row0.. (row stride lda) as [m][k], B columns
// col0.. as [k][n]; av, bv: the piece width (floats) each operand allows.
__device__ __forceinline__ void f64_issue_stage(
    F64Smem& s, int slot, const float* __restrict__ A, int lda,
    const float* __restrict__ B, int M, int N, int K, int row0, int col0,
    int ks, int av, int bv) {
  const int k0 = ks * F64_BK;
  const uint32_t a = smem_u32(s.a32[slot]), b = smem_u32(s.b32[slot]);
  if (av == 4)
    copy_tile<4>(a, F64_LDA, A, lda, F64_BM, F64_BK, row0, M, k0, K);
  else if (av == 2)
    copy_tile<2>(a, F64_LDA, A, lda, F64_BM, F64_BK, row0, M, k0, K);
  else
    copy_tile<1>(a, F64_LDA, A, lda, F64_BM, F64_BK, row0, M, k0, K);
  if (bv == 4)
    copy_tile<4>(b, F64_LDB, B, N, F64_BK, F64_BN, k0, K, col0, N);
  else if (bv == 2)
    copy_tile<2>(b, F64_LDB, B, N, F64_BK, F64_BN, k0, K, col0, N);
  else
    copy_tile<1>(b, F64_LDB, B, N, F64_BK, F64_BN, k0, K, col0, N);
}

// widest piece (4, 2 or 1 floats) rows of stride ld at base p allow
__device__ __forceinline__ int piece_width(const float* p, int ld) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return (ld % 4 == 0 && a % 16 == 0) ? 4 : (ld % 2 == 0 && a % 8 == 0) ? 2
                                                                        : 1;
}

// acc (a warp's 32 x 32 fragments, see mma_f64_16x8x8) += the product
// over k-stages [ks0, ks1) of the 64 x 64 tile at (row0, col0); A has row
// stride lda.  Must be called by all F64_THREADS threads of the block;
// leaves the ring drained.
__device__ __forceinline__ void f64_tile_product(
    F64Smem& s, const float* __restrict__ A, int lda,
    const float* __restrict__ B, int M, int N, int K, int row0, int col0,
    int ks0, int ks1, F64Acc& acc) {
  const int av = piece_width(A, lda), bv = piece_width(B, N);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * F64_WM, wn = (warp & 1) * F64_WN;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s0 = 0; s0 < F64_STAGES - 1; ++s0) {
    if (ks0 + s0 < ks1)
      f64_issue_stage(s, s0, A, lda, B, M, N, K, row0, col0, ks0 + s0, av,
                      bv);
    cp_async_commit();
  }
  for (int ks = ks0; ks < ks1; ++ks) {
    const int slot = (ks - ks0) % F64_STAGES;
    cp_async_wait<F64_STAGES - 2>();
    // every thread's copies of this stage landed; every warp is done with
    // the slot refilled below (read in the iteration before)
    __syncthreads();
    const int nxt = ks + F64_STAGES - 1;
    if (nxt < ks1)
      f64_issue_stage(s, (nxt - ks0) % F64_STAGES, A, lda, B, M, N, K, row0,
                      col0, nxt, av, bv);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < F64_BK; kk += 8) {
      const float* ak = s.a32[slot] + (wm + g) * F64_LDA + kk + t;
      const float* bk = s.b32[slot] + (kk + t) * F64_LDB + wn + g;
      double a[F64_MI][4], b[F64_NI][2];
#pragma unroll
      for (int mi = 0; mi < F64_MI; ++mi) {
        a[mi][0] = double(ak[(mi * 16) * F64_LDA]);
        a[mi][1] = double(ak[(mi * 16 + 8) * F64_LDA]);
        a[mi][2] = double(ak[(mi * 16) * F64_LDA + 4]);
        a[mi][3] = double(ak[(mi * 16 + 8) * F64_LDA + 4]);
      }
#pragma unroll
      for (int ni = 0; ni < F64_NI; ++ni) {
        b[ni][0] = double(bk[ni * 8]);
        b[ni][1] = double(bk[4 * F64_LDB + ni * 8]);
      }
#pragma unroll
      for (int mi = 0; mi < F64_MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < F64_NI; ++ni)
          mma_f64_16x8x8(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Tile coordinates of accumulator element e (0..3) of fragment (mi, ni) of
// this thread: row and column offsets inside the 64 x 64 tile.
__device__ __forceinline__ int f64_acc_row(int mi, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp >> 1) * F64_WM + mi * 16 + (lane >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int f64_acc_col(int ni, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp & 1) * F64_WN + ni * 8 + (lane & 3) * 2 + (e & 1);
}

__device__ __forceinline__ float leaky(float v, float a) {
  return v >= 0.f ? v : a * v;
}

constexpr int F64_TILE = F64_BM * F64_BN;
constexpr int F64_MAX_SPLITS = 8;   // portable cluster size

// C[M, N] (row stride ldc) = epi(A[M, K] (row stride lda) B[K, N] + bias);
// epi = LeakyReLU(alpha) if act.  Launched in clusters of ``splits`` blocks
// along x: block b is split b % splits (its cluster rank) of tile
// b / splits, tiles row-major over (row tile, column tile), as the plan
// enumerates them (GemmPlan.block_work).  Split s takes the k-stages
// [s ksteps / splits, (s + 1) ksteps / splits).  With one split the block
// rounds acc + bias to fp32 once and stores it.  With more, each block
// leaves its fp64 partial tile in its own (now idle) ring, the cluster
// synchronises, and block r sums slice r of the tile over the cluster's
// blocks in split order through distributed shared memory: no partial
// goes to device memory, no counters, no atomics, the same bits every run.
__global__ void __launch_bounds__(F64_THREADS)
f64_gemm_kernel(const float* __restrict__ A, int lda,
                const float* __restrict__ B, const float* __restrict__ bias,
                float* __restrict__ C, int ldc, int M, int N, int K,
                int splits, float alpha, int act) {
  namespace cg = cooperative_groups;
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
  static_assert(sizeof(double) * F64_TILE <= sizeof(F64Smem), "tile fits");
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
  const int i0 = split * F64_TILE / splits;
  const int i1 = (split + 1) * F64_TILE / splits;
  for (int i = i0 + threadIdx.x; i < i1; i += F64_THREADS) {
    const int r = row0 + i / F64_BN, c = col0 + i % F64_BN;
    if (r >= M || c >= N) continue;
    // all the cluster's partials in flight at once, then summed in order
    double v[F64_MAX_SPLITS];
#pragma unroll
    for (int p = 0; p < F64_MAX_SPLITS; ++p)
      v[p] = p < splits ? cluster.map_shared_rank(part, p)[i] : 0.0;
    double sum = 0.0;
#pragma unroll
    for (int p = 0; p < F64_MAX_SPLITS; ++p)
      if (p < splits) sum += v[p];
    const float out = float(sum + double(bias[c]));
    C[(size_t)r * ldc + c] = act ? leaky(out, alpha) : out;
  }
  cluster.sync();   // no block leaves while another reads its tile
}

// Launch f64_gemm_kernel on ``stream`` (one CUDA launch); returns the
// launch's error.  Refuses splits outside [1, min(8, k-stages)].  The
// shared-memory attribute is set once per process.
inline cudaError_t f64_gemm(const float* A, int lda, const float* B,
                            const float* bias, float* C, int ldc, int M,
                            int N, int K, int splits, float alpha, int act,
                            cudaStream_t stream) {
  static const cudaError_t setup = cudaFuncSetAttribute(
      f64_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(F64Smem));
  if (setup != cudaSuccess) return setup;
  const int ksteps = (K + F64_BK - 1) / F64_BK;
  if (M < 1 || N < 1 || K < 1 || lda < K || ldc < N || splits < 1 ||
      splits > F64_MAX_SPLITS || splits > ksteps)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((M + F64_BM - 1) / F64_BM) *
                     ((N + F64_BN - 1) / F64_BN) * splits);
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
  const cudaError_t err = cudaLaunchKernelEx(&cfg, f64_gemm_kernel, A, lda,
                                             B, bias, C, ldc, M, N, K,
                                             splits, alpha, act);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
}  // namespace mpe3d
