// Grid-tiled GAT matcher layer (alt-3 graph, inference) for Hopper: the
// crowded-bucket form of the GAT stack; the fc products on the fp64 tensor
// cores, the attention on the CUDA cores.
//
// Replaces the two TPU kernels of mpe3d_tpu/ops/gat_tiled.py:
//   K1 = _k1_layer (:86, pallas_call :194): the fc1 -> LeakyReLU -> fc2
//        projection, the attention terms, the edge-destination softmax
//        (out_e) and the masked head-destination logits l1m/l2m;
//   K2 = _k2_layer (:225, pallas_call :268): the exp-shifted edge weights
//        and the head sums den [H, nh] / num [H, F].
// The reference's XLA glue around them (head-side projection :335-338, the
// masked per-head max of K1 and its combine :351, the epilogue out_h =
// (es zh + num) / (es + den) :355-358 and the inter-layer LeakyReLU) runs
// inside these kernels: the head max in K2, next to its only reader.
// Python side and plain PyTorch version: mpe3d_tpu_torch/ops/gat_tiled.py.
//
// Rows of x: n < H are head nodes, H <= n < H+E edge nodes.  With
// edge_const every edge row is the same vector (the alt-3 edge one-hot), so
// only rows 0..H are projected and every edge reads row H of z.
//
// Translation from the TPU kernels: they gather endpoints and scatter head
// sums with 0/1 incidence matmuls over edge blocks (for Mosaic).  Here
// endpoints are gathered by index (e1/e2), and the head sums read an
// incidence list built on the card once a stack call (tiled_incidence):
// the entries ent = 2e + role of every edge endpoint, grouped by head, each
// head's in ascending (edge, role) order.  No incidence matrix, no per-head
// degree cap (a compacted pruned edge set has any degree, 0 included), no
// host sync (under pruning e1/e2 are gathered on the card every frame).
// Each head's sums run in that order: deterministic, no float atomics
// (run-to-run differences near the 0.5 threshold flip persons).
//
// Precision: operands and stored activations are fp32 (no TF32, no bf16);
// the sums -- the fc products, the attention terms and the head sums -- are
// accumulated in fp64 (each fp32 product is exact there) and rounded to fp32
// once.  The trained matcher's logits reach |130| and cancel heavily near 0,
// so fp32 rounding differences grow there: the first form of this kernel,
// with fp32 sums along k, was 1.46e-3 from its plain version at Panoptic
// S=10, past the 1e-4 x (1 + |logit|) it is held to (chip_smoke.py prints
// each form's distance from an fp64 evaluation).
//
// Bound on an H100 SXM at Panoptic S=16 (H=80, E=2560, the 1.96 M-weight
// 5-layer stack, edge_const): 81 rows x 2 x 1.174 M weights for layer 0 and
// 2640 rows x 2 x 0.781 M for layers 1-4, 4.31 GFLOP, 64.3 us at 67 TFLOP/s
// (the fp64 tensor-core peak, m16n8k8); compute-bound, the fc products of
// layers 1-4 almost all of it.  K2 moves 10.6 MB a stack (z's edge rows
// of layers 1-3, the incidence build included) and computes little: bound
// by its bytes, 3.2 us; on the card by its chains of dependent loads and
// of fp64 sums, which keep the parent's order.
//
// Design: K1's fc1 and fc2 run on f64_gemm (f64_mma.cuh, shared with
// gat_stack.cu and the projection): 64 x 64 tiles on mma.sync.m16n8k8.f64.
// Layers 1-4 have 2640 rows (42 x 7 tiles at fc1) and run unsplit; layer 0
// under edge_const has 81 rows (2 row tiles), so the tile plan
// (ops/fused_proj.py::gemm_plan, passed in per call) splits its k over a
// thread-block cluster to fill the card.  K1 is 4 launches a layer (the
// last layer too): fc1, fc2, the attention terms, the edge kernel.  K2 is
// one launch a layer on a grid of (head, tile of FT features) blocks (320
// at S=16 for F = 400), each reading only its head's entries of the list:
// the masked max of the heads its tile covers, the weights staged in
// shared memory, den and its features' num summed in fp64 in entry order,
// the epilogue.  gat_tiled_stack runs the whole stack from one host call:
// the incidence build, then K1 and K2 a layer (K1 alone on the last).

#include <math_constants.h>

#include "f64_mma.cuh"

namespace {

using mpe3d::f64_gemm;
using mpe3d::leaky;

constexpr int MAX_NH = 16;           // attention heads per layer
constexpr int MAX_F = 512;           // features per layer (nh * d)
constexpr int MAX_HEADS = 512;       // head nodes (the incidence build)
constexpr int INC_THREADS = 1024;    // the incidence build: one block
constexpr int INC_WARPS = INC_THREADS / 32;
constexpr int FT = 128;              // features of a K2 block (its threads)
constexpr int K2_CHUNK = 256;        // entries a K2 block stages per step
constexpr int K2_BATCH = 32;         // z rows a K2 thread loads ahead
constexpr int INC_STEPS = 8;         // steps of the incidence build in registers
constexpr int MAX_PAIRS = 32767;     // pairs: 2E entries fit its 16-bit offsets
constexpr int HEAD_BITS = 10;        // bits of a head index + 1 (<= MAX_HEADS)
static_assert(MAX_HEADS < (1 << HEAD_BITS), "head bits");
constexpr int LAYER_COLS = 13;       // int64 columns of a gat_tiled_stack layer

// att[n, 0:nh] = a1, att[n, nh:2nh] = a2; one thread per (row, head).
__global__ void attn_terms(const float* __restrict__ z,
                           const float* __restrict__ attn_l,
                           const float* __restrict__ attn_r,
                           float* __restrict__ att, int N, int nh, int d) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= N * nh) return;
  const int n = t / nh, k = t % nh;
  const float* zr = z + (size_t)n * nh * d + k * d;
  double s1 = 0.0, s2 = 0.0;
#pragma unroll 8
  for (int j = 0; j < d; ++j) {
    s1 = fma(double(zr[j]), double(attn_l[k * d + j]), s1);
    s2 = fma(double(zr[j]), double(attn_r[k * d + j]), s2);
  }
  att[(size_t)n * 2 * nh + k] = float(s1);
  att[(size_t)n * 2 * nh + nh + k] = float(s2);
}

// K1, edge part: one thread per (edge, feature).  The softmax over
// {self, head e1, head e2} gives the edge's next activation row H+e (leaky
// applied), or the logit on the last layer.  The thread of each head's first
// feature also writes the masked head-destination logits l1m/l2m.
__global__ void k1_edges(const float* __restrict__ z,
                         const float* __restrict__ att,
                         const float* __restrict__ pw,
                         const int* __restrict__ e1,
                         const int* __restrict__ e2, int H, int E, int nh,
                         int d, int edge_const, float alpha, float slope,
                         int last, float* __restrict__ l1m,
                         float* __restrict__ l2m, float* __restrict__ xout) {
  const int F = nh * d;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= E * F) return;
  const int e = t / F, f = t % F, k = f / d;
  const int n = H + (edge_const ? 0 : e), h1 = e1[e], h2 = e2[e];
  const float a1e = att[(size_t)n * 2 * nh + k];
  const float a2e = att[(size_t)n * 2 * nh + nh + k];
  const float l0 = leaky(a1e + a2e, alpha);
  const float l1 = leaky(att[(size_t)h1 * 2 * nh + k] + a2e, alpha);
  const float l2 = leaky(att[(size_t)h2 * 2 * nh + k] + a2e, alpha);
  const float mx = fmaxf(l0, fmaxf(l1, l2));
  const float x0 = expf(l0 - mx), x1 = expf(l1 - mx), x2 = expf(l2 - mx);
  const float s = x0 + x1 + x2;
  const float v = (x0 / s) * z[(size_t)n * F + f]
                + (x1 / s) * z[(size_t)h1 * F + f]
                + (x2 / s) * z[(size_t)h2 * F + f];
  if (last) {
    xout[e] = v;
    return;
  }
  xout[(size_t)(H + e) * F + f] = leaky(v, slope);
  if (f % d == 0) {
    const bool live = pw[e] > 0.f;
    l1m[(size_t)e * nh + k] =
        live ? leaky(a1e + att[(size_t)h1 * 2 * nh + nh + k], alpha)
             : -CUDART_INF_F;
    l2m[(size_t)e * nh + k] =
        live ? leaky(a1e + att[(size_t)h2 * 2 * nh + nh + k], alpha)
             : -CUDART_INF_F;
  }
}

// The lanes of the warp whose h equals this lane's (as __match_any_sync,
// no faster here): one ballot per bit of h + 1 in [0, 2^bits).
__device__ __forceinline__ unsigned same_head_lanes(int h, int bits) {
  const unsigned v = (unsigned)(h + 1);
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < HEAD_BITS; ++b) {
    if (b < bits) {
      const unsigned m = __ballot_sync(0xffffffffu, (v >> b) & 1u);
      peers &= ((v >> b) & 1u) ? m : ~m;
    }
  }
  return peers;
}

// The incidence list of one stack call, one block: head_ent holds the
// entries ent = 2e + role (role 0: endpoint e1[e], role 1: e2[e]) grouped by
// head, head h's at [head_ptr[h], head_ptr[h+1]) in ascending ent order.
// Warp w owns the w-th of 32 contiguous segments of the entries and walks
// it 32 entries a step, in ascending order.  Pass 1 counts each head's
// entries in each segment (wc[h][w], 16-bit counts updated by 32-bit
// shared atomics: a count does not depend on the order of its adds); the
// counts are scanned across the segments and then across the heads
// (head_ptr).  Pass 2 walks the segments again: an entry's place is
// head_ptr[h], plus its head's entries in the earlier segments and steps
// (wc, advanced by the step's first lane of the head), plus its rank among
// the step's lanes of that head (same_head_lanes).  Integers only: the
// same list on every run.  Endpoints outside [0, H) are left out.  Four
// block barriers; the heads of up to INC_STEPS steps stay in registers
// between the passes (E <= 4096), later ones are read again.
__global__ void __launch_bounds__(INC_THREADS)
tiled_incidence(const int* __restrict__ e1, const int* __restrict__ e2,
                int H, int E, int* __restrict__ head_ptr,
                int* __restrict__ head_ent) {
  __shared__ unsigned wc32[MAX_HEADS * INC_WARPS / 2];   // 32 KB
  __shared__ int tot[MAX_HEADS], ptr[MAX_HEADS];
  unsigned short* wc = reinterpret_cast<unsigned short*>(wc32);  // [h][w]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_ent = 2 * E, bits = 32 - __clz(H);
  const int steps = (n_ent + INC_THREADS - 1) / INC_THREADS;
  const int seg0 = warp * steps * 32;           // first entry of the segment
  const unsigned below = (1u << lane) - 1u;
  auto head_of = [&](int st) {
    const int ent = seg0 + st * 32 + lane;
    if (ent >= n_ent) return -1;
    const int h = (ent & 1) ? e2[ent >> 1] : e1[ent >> 1];
    return h >= 0 && h < H ? h : -1;
  };
  auto step_head = [&](const int* hv, int st) {
    int h = -1;
#pragma unroll
    for (int j = 0; j < INC_STEPS; ++j)
      if (j == st) h = hv[j];
    return st < INC_STEPS ? h : head_of(st);
  };
  for (int i = tid; i < MAX_HEADS * INC_WARPS / 2; i += INC_THREADS)
    wc32[i] = 0u;
  int hv[INC_STEPS];
#pragma unroll
  for (int st = 0; st < INC_STEPS; ++st) hv[st] = st < steps ? head_of(st) : -1;
  __syncthreads();
  for (int st = 0; st < steps; ++st) {          // pass 1: segment counts
    const int h = step_head(hv, st);
    if (h >= 0)
      atomicAdd(&wc32[(h * INC_WARPS + warp) >> 1], 1u << (16 * (warp & 1)));
  }
  __syncthreads();
  for (int h = warp; h < H; h += INC_WARPS) {   // scan across the segments
    const int v = wc[h * INC_WARPS + lane];
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    wc[h * INC_WARPS + lane] = (unsigned short)(incl - v);
    if (lane == 31) tot[h] = incl;
  }
  __syncthreads();
  if (warp == 0) {                              // scan across the heads
    constexpr int PER = MAX_HEADS / 32;
    int c[PER], sum = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int h = lane * PER + j;
      c[j] = h < H ? tot[h] : 0;
      sum += c[j];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    int run = incl - sum;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int h = lane * PER + j;
      if (h < H) head_ptr[h] = ptr[h] = run;
      run += c[j];
    }
    if (lane == 31) head_ptr[H] = incl;
  }
  __syncthreads();
  for (int st = 0; st < steps; ++st) {          // pass 2: placement
    const int h = step_head(hv, st);
    const unsigned peers = same_head_lanes(h, bits);
    unsigned short* off = wc + ((h >= 0 ? h : 0) * INC_WARPS + warp);
    if (h >= 0) head_ent[ptr[h] + *off + __popc(peers & below)] =
        seg0 + st * 32 + lane;
    __syncwarp();
    if (h >= 0 && (peers & below) == 0) *off += __popc(peers);
    __syncwarp();
  }
}

// A float's order as an unsigned key (atomicMax takes it): -inf lowest,
// and its inverse.
__device__ __forceinline__ unsigned max_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// K2: one block per (head h, tile of FT features).  Reads head h's entries
// of the incidence list; m[k] = max of the self logit and the masked
// logits l1m/l2m of the entries, for each head k the tile's features cover
// (shared atomicMax on order keys: exact, order-independent), the logits
// of the first K2_CHUNK entries kept in shared memory for the next step;
// stages the weights pw > 0 ? exp(l - m[k]) * pw : 0 (fp32, stored as
// fp64, [head][entry]) of K2_CHUNK entries at a time in shared memory and
// sums num [f] and den [k] over them in entry order in fp64 (den in the
// same loop; the thread of the first feature of head k in the tile gives
// it to the epilogue); the weights of K2_BATCH entries are loaded into
// registers ahead of their products, and the z rows a batch ahead (the
// first batch before the max is known); then the epilogue: the head's
// next activations leaky((es zh + num) / (es + den), slope) of the tile's
// features.
__global__ void __launch_bounds__(FT)
k2_heads(const float* __restrict__ l1m, const float* __restrict__ l2m,
         const float* __restrict__ pw, const int* __restrict__ head_ptr,
         const int* __restrict__ head_ent, const float* __restrict__ z,
         const float* __restrict__ att, int H, int nh, int d,
         int edge_const, float alpha, float slope,
         float* __restrict__ xout) {
  __shared__ double wt[MAX_NH * K2_CHUNK];  // logit, then weight: [kk][i]
  __shared__ float pws[K2_CHUNK];           // pw of entry i
  __shared__ int row[K2_CHUNK];             // z row of entry i
  __shared__ unsigned smax[MAX_NH];         // max_key of m[k_lo + kk]
  __shared__ float sls[MAX_NH], ses[MAX_NH], sden[MAX_NH];
  const int h = blockIdx.x, tid = threadIdx.x, F = nh * d;
  const int f0 = blockIdx.y * FT, f = f0 + tid;
  const int k_lo = f0 / d, nk = (min(F, f0 + FT) - 1) / d - k_lo + 1;
  const int beg = head_ptr[h], n = head_ptr[h + 1] - beg;
  const int* ents = head_ent + beg;
  const float* ah = att + (size_t)h * 2 * nh;
  const bool feat = f < F;
  const int kf = (feat ? f / d : k_lo) - k_lo;
  const bool den_owner = feat && (tid == 0 || f % d == 0);
  const float zh = feat ? z[(size_t)h * F + f] : 0.f;
  auto logit = [&](int ent, int k) {
    const size_t i = (size_t)(ent >> 1) * nh + k;
    return (ent & 1) ? l2m[i] : l1m[i];
  };
  auto stage_entry = [&](int i, int ent) {
    pws[i] = pw[ent >> 1];
    row[i] = H + (edge_const ? 0 : ent >> 1);
  };
  if (tid < MAX_NH) smax[tid] = 0u;
  __syncthreads();

  // head max: groups of nk threads, thread kk of a group on head k_lo + kk
  const int groups = FT / nk;
  if (tid < groups * nk) {
    const int kk = tid % nk;
    float mx = -CUDART_INF_F;
#pragma unroll 2
    for (int i = tid / nk; i < n; i += groups) {
      const int ent = ents[i];
      const float l = logit(ent, k_lo + kk);
      mx = fmaxf(mx, l);
      if (i < K2_CHUNK) {
        wt[kk * K2_CHUNK + i] = l;
        if (kk == 0) stage_entry(i, ent);
      }
    }
    if (tid / nk < n) atomicMax(&smax[kk], max_key(mx));
  }
  if (tid < nk) {
    const int k = k_lo + tid;
    const float ls = leaky(ah[k] + ah[nh + k], alpha);
    sls[tid] = ls;
    atomicMax(&smax[tid], max_key(ls));
  }
  __syncthreads();
  float zv[K2_BATCH];              // the z rows of a batch
#pragma unroll
  for (int j = 0; j < K2_BATCH; ++j)
    zv[j] = feat && j < n ? z[(size_t)row[j] * F + f] : 0.f;

  double den = 0.0, num = 0.0;
  for (int c0 = 0; c0 < n; c0 += K2_CHUNK) {
    const int cn = min(K2_CHUNK, n - c0);
    if (c0 > 0) {                  // the logits of this chunk from memory
      for (int s = tid; s < cn * nk; s += FT) {
        const int i = s / nk, kk = s - i * nk, ent = ents[c0 + i];
        wt[kk * K2_CHUNK + i] = logit(ent, k_lo + kk);
        if (kk == 0) stage_entry(i, ent);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < K2_BATCH; ++j)
        zv[j] = feat && j < cn ? z[(size_t)row[j] * F + f] : 0.f;
    }
    for (int s = tid; s < nk * cn; s += FT) {
      const int kk = s / cn, i = s - kk * cn;
      const float p = pws[i];
      double& w = wt[kk * K2_CHUNK + i];
      w = p > 0.f ? expf(float(w) - key_value(smax[kk])) * p : 0.f;
    }
    __syncthreads();
    if (feat) {
      // every thread also sums its head's den (the same value for the
      // threads of one head; the den owner's is kept): no branch a step
      double acc = num, dacc = den;
      const int kb = kf * K2_CHUNK;
      for (int i0 = 0; i0 < cn; i0 += K2_BATCH) {
        float zn[K2_BATCH];        // the next batch's z rows, loaded ahead
#pragma unroll
        for (int j = 0; j < K2_BATCH; ++j) {
          const int i = i0 + K2_BATCH + j;
          zn[j] = i < cn ? z[(size_t)row[i] * F + f] : 0.f;
        }
        double wv[K2_BATCH];
        if (i0 + K2_BATCH <= cn) {
#pragma unroll
          for (int j = 0; j < K2_BATCH; ++j) wv[j] = wt[kb + i0 + j];
#pragma unroll
          for (int j = 0; j < K2_BATCH; ++j) {
            acc = fma(wv[j], double(zv[j]), acc);
            dacc += wv[j];
          }
        } else {
#pragma unroll
          for (int j = 0; j < K2_BATCH; ++j)
            wv[j] = i0 + j < cn ? wt[kb + i0 + j] : 0.0;
#pragma unroll
          for (int j = 0; j < K2_BATCH; ++j) {
            if (i0 + j < cn) {
              acc = fma(wv[j], double(zv[j]), acc);
              dacc += wv[j];
            }
          }
        }
#pragma unroll
        for (int j = 0; j < K2_BATCH; ++j) zv[j] = zn[j];
      }
      num = acc;
      den = dacc;
    }
    __syncthreads();
  }
  if (den_owner) {
    const float es = expf(sls[kf] - key_value(smax[kf]));
    ses[kf] = es;
    sden[kf] = float(es + den);
  }
  __syncthreads();
  if (feat) {
    const float v = float(double(ses[kf]) * zh + num) / sden[kf];
    xout[(size_t)h * F + f] = leaky(v, slope);
  }
}

bool layer_ok(int nh, int d) {
  return nh >= 1 && nh <= MAX_NH && d >= 1 && nh * d <= MAX_F;
}

cudaError_t incidence(const int* e1, const int* e2, int H, int E,
                      int* head_ptr, int* head_ent, cudaStream_t stream) {
  if (H < 1 || H > MAX_HEADS || E < 1 || E > MAX_PAIRS)
    return cudaErrorInvalidValue;
  tiled_incidence<<<1, INC_THREADS, 0, stream>>>(e1, e2, H, E, head_ptr,
                                                 head_ent);
  return cudaGetLastError();
}

cudaError_t k1_layer(const float* x, const float* w1, const float* b1,
                     const float* w2, const float* b2, const float* attn_l,
                     const float* attn_r, const float* pw, const int* e1,
                     const int* e2, int H, int E, int d_in, int nh, int d,
                     int edge_const, float alpha, float slope, int last,
                     int s1, int s2, float* h1, float* z, float* att,
                     float* l1m, float* l2m, float* xout,
                     cudaStream_t stream) {
  const int F = nh * d;
  if (!layer_ok(nh, d) || d_in < 1 || H < 1 || E < 1)
    return cudaErrorInvalidValue;
  const int rows = H + (edge_const ? 1 : E);
  const int ldh = (d_in + 3) / 4 * 4;   // 16-byte rows for fc2's copies
  cudaError_t err = f64_gemm(x, d_in, w1, b1, h1, ldh, rows, d_in, d_in, s1,
                             alpha, 1, stream);
  if (err != cudaSuccess) return err;
  err = f64_gemm(h1, ldh, w2, b2, z, F, rows, F, d_in, s2, 0.f, 0, stream);
  if (err != cudaSuccess) return err;
  attn_terms<<<(rows * nh + 127) / 128, 128, 0, stream>>>(z, attn_l, attn_r,
                                                          att, rows, nh, d);
  k1_edges<<<(E * F + 127) / 128, 128, 0, stream>>>(
      z, att, pw, e1, e2, H, E, nh, d, edge_const, alpha, slope, last, l1m,
      l2m, xout);
  return cudaGetLastError();
}

cudaError_t k2_layer(const float* l1m, const float* l2m, const float* pw,
                     const int* head_ptr, const int* head_ent,
                     const float* z, const float* att, int H, int nh, int d,
                     int edge_const, float alpha, float slope, float* xout,
                     cudaStream_t stream) {
  if (!layer_ok(nh, d) || H < 1 || H > MAX_HEADS)
    return cudaErrorInvalidValue;
  const dim3 grid(H, (nh * d + FT - 1) / FT);
  k2_heads<<<grid, FT, 0, stream>>>(l1m, l2m, pw, head_ptr, head_ent, z, att,
                                    H, nh, d, edge_const, alpha, slope, xout);
  return cudaGetLastError();
}

}  // namespace

// The incidence list of a stack call (tiled_incidence): head_ptr [H+1],
// head_ent [2E] int32, from the endpoints e1/e2 [E].  H <= 512, E <= 32767.
extern "C" int gat_tiled_incidence(const int* e1, const int* e2, int H,
                                   int E, int* head_ptr, int* head_ent,
                                   cudaStream_t stream) {
  return incidence(e1, e2, H, E, head_ptr, head_ent, stream);
}

// K1 of one layer.  x: rows 0..H-1 heads, then edge rows (only row H is read
// under edge_const); w1 [d_in, d_in], b1 [d_in], w2 [d_in, F], b2 [F],
// attn_l/attn_r [F].  s1, s2: the k-splits of fc1 and fc2 (the tile plan's,
// 1..8).  Scratch: h1 [rows, ldh] with ldh = d_in rounded up to 4 floats,
// z [rows, F], att [rows, 2 nh] with rows = H + (edge_const ? 1 : E).
// Outputs: l1m/l2m [E, nh], and xout: the logits [E] on the last layer,
// else the next layer's activations [H + E, F], of which K1 writes the edge
// rows.
extern "C" int gat_k1_layer(
    const float* x, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* attn_l, const float* attn_r,
    const float* pw, const int* e1, const int* e2, int H, int E, int d_in,
    int nh, int d, int edge_const, float alpha, float slope, int last,
    int s1, int s2, float* h1, float* z, float* att, float* l1m, float* l2m,
    float* xout, cudaStream_t stream) {
  return k1_layer(x, w1, b1, w2, b2, attn_l, attn_r, pw, e1, e2, H, E, d_in,
                  nh, d, edge_const, alpha, slope, last, s1, s2, h1, z, att,
                  l1m, l2m, xout, stream);
}

// K2 of one layer (not the last): the head rows of xout [H + E, F] from
// K1's l1m/l2m, z and att, and the stack call's incidence list.
extern "C" int gat_k2_layer(
    const float* l1m, const float* l2m, const float* pw, const int* head_ptr,
    const int* head_ent, const float* z, const float* att, int H, int nh,
    int d, int edge_const, float alpha, float slope, float* xout,
    cudaStream_t stream) {
  return k2_layer(l1m, l2m, pw, head_ptr, head_ent, z, att, H, nh, d,
                  edge_const, alpha, slope, xout, stream);
}

// The whole tiled stack from one host call: the incidence list, then K1 and
// K2 of each layer (K1 alone on the last), on the stream in that order.
// layers [n_layers, LAYER_COLS] int64, host memory, a row a layer: d_in, d,
// nh, the k-splits s1 and s2, edge_const, the offsets (floats) of w1, b1,
// w2, b2, attn_l and attn_r in weights, and of the layer's activations
// [H + E, F] in acts (unused on the last layer, which writes the logits
// [E] to out).  Scratch as gat_k1_layer's and gat_tiled_incidence's.
extern "C" int gat_tiled_stack(
    const float* x, const float* pw, const int* e1, const int* e2,
    const float* weights, const long long* layers, int n_layers, int H,
    int E, float alpha, float slope, float* h1, float* z, float* att,
    float* l1m, float* l2m, int* head_ptr, int* head_ent, float* acts,
    float* out, cudaStream_t stream) {
  if (n_layers < 1) return cudaErrorInvalidValue;
  cudaError_t err = incidence(e1, e2, H, E, head_ptr, head_ent, stream);
  const float* xin = x;
  for (int l = 0; l < n_layers && err == cudaSuccess; ++l) {
    const long long* r = layers + (size_t)l * LAYER_COLS;
    const int d_in = (int)r[0], d = (int)r[1], nh = (int)r[2];
    const int const_ = (int)r[5], last = l == n_layers - 1;
    float* xout = last ? out : acts + r[12];
    err = k1_layer(xin, weights + r[6], weights + r[7], weights + r[8],
                   weights + r[9], weights + r[10], weights + r[11], pw, e1,
                   e2, H, E, d_in, nh, d, const_, alpha, slope, last,
                   (int)r[3], (int)r[4], h1, z, att, l1m, l2m, xout, stream);
    if (err == cudaSuccess && !last)
      err = k2_layer(l1m, l2m, pw, head_ptr, head_ent, z, att, H, nh, d,
                     const_, alpha, slope, xout, stream);
    xin = xout;
  }
  return err;
}
