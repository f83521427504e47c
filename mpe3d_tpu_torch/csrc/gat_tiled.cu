// Grid-tiled GAT matcher layer (alt-3 graph, inference) for Hopper, in fp32
// CUDA cores: the crowded-bucket form of the GAT stack.
//
// Replaces the two TPU kernels of mpe3d_tpu/ops/gat_tiled.py:
//   K1 = _k1_layer (:86, pallas_call :194): the fc1 -> LeakyReLU -> fc2
//        projection, the attention terms, the edge-destination softmax
//        (out_e), the masked head-destination logits l1m/l2m and the masked
//        per-head max;
//   K2 = _k2_layer (:225, pallas_call :268): the exp-shifted edge weights
//        and the head sums den [H, nh] / num [H, F].
// The reference's XLA glue around them (head-side projection :335-338, the
// max combine :351, the epilogue out_h = (es zh + num) / (es + den) :355-358
// and the inter-layer LeakyReLU) runs inside these two entry points.
// Python side and plain PyTorch version: mpe3d_tpu_torch/ops/gat_tiled.py.
//
// Rows of x: n < H are head nodes, H <= n < H+E edge nodes.  With
// edge_const every edge row is the same vector (the alt-3 edge one-hot), so
// only rows 0..H are projected and every edge reads row H of z.
//
// Translation from the TPU kernels: they gather endpoints and scatter head
// sums with 0/1 incidence matmuls over edge blocks (for Mosaic).  Here
// endpoints are gathered by index (e1/e2) and each head is one block that
// scans the edge endpoints in ascending edge order: no incidence matrix, no
// per-head degree cap (a compacted pruned edge set has any degree), no host
// sync.  K2 compacts a head's incident edges chunk by chunk with a block
// prefix sum and sums them in ascending edge order: deterministic, no float
// atomics (run-to-run differences near the 0.5 threshold flip persons).
//
// Precision: operands and stored activations are fp32 (no TF32, no bf16);
// the sums -- the fc products, the attention terms and the head sums -- are
// accumulated in fp64 (each fp32 product is exact there) and rounded to fp32
// once.  The trained matcher's logits reach |130| and cancel heavily near 0,
// so fp32 rounding differences grow there: the first form of this kernel,
// with fp32 sums along k (the GEMM gat_stack.cu uses), was 1.46e-3 from its
// plain version at Panoptic S=10, past the 1e-4 x (1 + |logit|) it is held
// to (chip_smoke.py prints each form's distance from an fp64 evaluation).
// fp64 sums run at the card's 34 TFLOP/s FP64 rate, half the fp32 one.
//
// Bound on an H100 SXM at Panoptic S=16 (H=80, E=2560, the 1.96 M-weight
// 5-layer stack, edge_const): 81 rows x 2 x 1.174 M weights for layer 0 and
// 2640 rows x 2 x 0.781 M for layers 1-4, about 4.3 GFLOP of fp32 FMA,
// 64 us at the 67 TFLOP/s non-tensor-core peak; compute-bound.  This first
// version is simple and right: the shared tiled GEMM (fp64 sums) for the
// projection, then small kernels; per layer K1 is 5 launches (2 GEMMs,
// attention terms, edge kernel, head max) and K2 one.

#include <math_constants.h>

#include "fp32_gemm.cuh"

namespace {

using mpe3d::launch_gemm;
using mpe3d::leaky;

constexpr int MAX_NH = 16;       // attention heads per layer
constexpr int MAX_F = 512;       // features per layer (nh * d)
constexpr int HT = 256;          // threads of a per-head block
constexpr int CHUNK = HT;        // edges scanned per step of a head block

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

// K1, head part: one block per head.  m[h, k] = max of the self logit and
// the masked logits of every edge with e1 == h (l1m) or e2 == h (l2m),
// found by a scan of all edge endpoints.  Exact: max is order-independent.
__global__ void __launch_bounds__(HT)
k1_head_max(const float* __restrict__ att, const float* __restrict__ l1m,
            const float* __restrict__ l2m, const int* __restrict__ e1,
            const int* __restrict__ e2, int E, int nh, float alpha,
            float* __restrict__ m) {
  __shared__ float red[HT][MAX_NH + 1];
  const int h = blockIdx.x;
  float mx[MAX_NH];
#pragma unroll
  for (int k = 0; k < MAX_NH; ++k) mx[k] = -CUDART_INF_F;
  for (int e = threadIdx.x; e < E; e += HT) {
    if (e1[e] == h)
#pragma unroll
      for (int k = 0; k < MAX_NH; ++k)
        if (k < nh) mx[k] = fmaxf(mx[k], l1m[(size_t)e * nh + k]);
    if (e2[e] == h)
#pragma unroll
      for (int k = 0; k < MAX_NH; ++k)
        if (k < nh) mx[k] = fmaxf(mx[k], l2m[(size_t)e * nh + k]);
  }
#pragma unroll
  for (int k = 0; k < MAX_NH; ++k) red[threadIdx.x][k] = mx[k];
  __syncthreads();
  if (threadIdx.x < nh) {
    const int k = threadIdx.x;
    float v = leaky(att[(size_t)h * 2 * nh + k] + att[(size_t)h * 2 * nh + nh + k],
                    alpha);
    for (int i = 0; i < HT; ++i) v = fmaxf(v, red[i][k]);
    m[(size_t)h * nh + k] = v;
  }
}

// K2: one block per head.  Scans the edges in chunks of CHUNK, compacts the
// incident ones (role 1 before role 2 within an edge) in ascending edge
// order with a block prefix sum, weights each by exp(l - m[h]) * pw, and
// sums den [nh] and num [F] sequentially in that order.  Then the epilogue:
// the head's next activation row leaky((es zh + num) / (es + den), slope).
__global__ void __launch_bounds__(HT)
k2_heads(const float* __restrict__ l1m, const float* __restrict__ l2m,
         const float* __restrict__ pw, const int* __restrict__ e1,
         const int* __restrict__ e2, const float* __restrict__ z,
         const float* __restrict__ att, const float* __restrict__ m, int H,
         int E, int nh, int d, int edge_const, float alpha, float slope,
         float* __restrict__ xout) {
  __shared__ int list[2 * CHUNK];             // edge * 2 + role
  __shared__ float wt[2 * CHUNK * MAX_NH];    // weight of each entry, head k
  __shared__ int warp_sum[HT / 32];
  __shared__ int n_list;
  const int h = blockIdx.x, F = nh * d, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const float* mh = m + (size_t)h * nh;
  double den = 0.0;                           // thread k < nh: head k
  double num[MAX_F / HT];                     // features tid, tid + HT
#pragma unroll
  for (int j = 0; j < MAX_F / HT; ++j) num[j] = 0.0;

  for (int base = 0; base < E; base += CHUNK) {
    const int e = base + tid;
    const bool r1 = e < E && e1[e] == h;
    const bool r2 = e < E && e2[e] == h;
    // block exclusive prefix sum of the per-thread entry counts
    int c = (int)r1 + (int)r2, incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (tid == 0) {
      int run = 0;
      for (int w = 0; w < HT / 32; ++w) {
        const int v = warp_sum[w];
        warp_sum[w] = run;
        run += v;
      }
      n_list = run;
    }
    __syncthreads();
    int pos = warp_sum[warp] + incl - c;
    if (r1) list[pos++] = 2 * e;
    if (r2) list[pos] = 2 * e + 1;
    __syncthreads();
    const int n = n_list;
    for (int i = tid; i < n * nh; i += HT) {
      const int ent = list[i / nh], k = i % nh, ee = ent >> 1;
      const float l = (ent & 1) ? l2m[(size_t)ee * nh + k]
                                : l1m[(size_t)ee * nh + k];
      const float p = pw[ee];
      wt[i] = p > 0.f ? expf(l - mh[k]) * p : 0.f;
    }
    __syncthreads();
    if (tid < nh)
      for (int i = 0; i < n; ++i) den += wt[i * nh + tid];
#pragma unroll
    for (int j = 0; j < MAX_F / HT; ++j) {
      const int f = tid + j * HT;
      if (f < F) {
        const int k = f / d;
        double acc = num[j];
        for (int i = 0; i < n; ++i) {
          const int ee = list[i] >> 1;
          const size_t row = H + (edge_const ? 0 : ee);
          acc = fma(double(wt[i * nh + k]), double(z[row * F + f]), acc);
        }
        num[j] = acc;
      }
    }
    __syncthreads();
  }
  // epilogue: den of head k lives in thread k; share it
  __shared__ float sden[MAX_NH], ses[MAX_NH];
  if (tid < nh) {
    const float ls = leaky(att[(size_t)h * 2 * nh + tid]
                           + att[(size_t)h * 2 * nh + nh + tid], alpha);
    const float es = expf(ls - mh[tid]);
    ses[tid] = es;
    sden[tid] = float(es + den);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < MAX_F / HT; ++j) {
    const int f = tid + j * HT;
    if (f < F) {
      const int k = f / d;
      const float v =
          float(double(ses[k]) * z[(size_t)h * F + f] + num[j]) / sden[k];
      xout[(size_t)h * F + f] = leaky(v, slope);
    }
  }
}

}  // namespace

// K1 of one layer.  x: rows 0..H-1 heads, then edge rows (only row H is read
// under edge_const); w1 [d_in, d_in], b1 [d_in], w2 [d_in, F], b2 [F],
// attn_l/attn_r [F].  Scratch: h1 [rows, d_in], z [rows, F], att [rows, 2 nh]
// with rows = H + (edge_const ? 1 : E).  Outputs: l1m/l2m [E, nh], m [H, nh],
// and xout: the logits [E] on the last layer, else the next layer's
// activations [H + E, F], of which K1 writes the edge rows.
extern "C" int gat_k1_layer(
    const float* x, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* attn_l, const float* attn_r,
    const float* pw, const int* e1, const int* e2, int H, int E, int d_in,
    int nh, int d, int edge_const, float alpha, float slope, int last,
    float* h1, float* z, float* att, float* l1m, float* l2m, float* m,
    float* xout, cudaStream_t stream) {
  const int F = nh * d;
  if (nh < 1 || nh > MAX_NH || F > MAX_F || H < 1 || E < 1)
    return cudaErrorInvalidValue;
  const int rows = H + (edge_const ? 1 : E);
  launch_gemm<double>(x, w1, b1, h1, rows, d_in, d_in, alpha, 1, stream);
  launch_gemm<double>(h1, w2, b2, z, rows, F, d_in, 0.f, 0, stream);
  attn_terms<<<(rows * nh + 127) / 128, 128, 0, stream>>>(z, attn_l, attn_r,
                                                          att, rows, nh, d);
  k1_edges<<<(E * F + 127) / 128, 128, 0, stream>>>(
      z, att, pw, e1, e2, H, E, nh, d, edge_const, alpha, slope, last, l1m,
      l2m, xout);
  if (!last)
    k1_head_max<<<H, HT, 0, stream>>>(att, l1m, l2m, e1, e2, E, nh, alpha, m);
  return cudaGetLastError();
}

// K2 of one layer (not the last): the head rows of xout [H + E, F] from
// K1's l1m/l2m, m, z and att.
extern "C" int gat_k2_layer(
    const float* l1m, const float* l2m, const float* pw, const int* e1,
    const int* e2, const float* z, const float* att, const float* m, int H,
    int E, int nh, int d, int edge_const, float alpha, float slope,
    float* xout, cudaStream_t stream) {
  if (nh < 1 || nh > MAX_NH || nh * d > MAX_F || H < 1 || E < 1)
    return cudaErrorInvalidValue;
  k2_heads<<<H, HT, 0, stream>>>(l1m, l2m, pw, e1, e2, z, att, m, H, E, nh, d,
                                 edge_const, alpha, slope, xout);
  return cudaGetLastError();
}
