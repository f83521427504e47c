// GAT matcher stack (alt-3 graph, inference) for Hopper, in fp32 CUDA cores.
//
// Replaces the TPU kernel mpe3d_tpu/ops/gat_kernel.py::_gat_megakernel
// (pallas_call at :232; body gat_stack_values :95-200).  Python side and
// plain PyTorch version: mpe3d_tpu_torch/ops/gat_kernel.py.
//
// Per layer (rows n < H are head nodes, rows H..H+E-1 edge nodes):
//   h1 = leaky(x w1 + b1, alpha);  z = h1 w2 + b2            [N, F = nh*d]
//   a1[n,k] = <z[n, k-block], attn_l[k]>,  a2 likewise with attn_r
//   edge e:  softmax over {self, head e1, head e2} of leaky(a1[src] + a2[e])
//   head h:  softmax over {self} + live incident edges of
//            leaky(a1[src] + a2[h]), exact per-destination max shift,
//            incident edges weighted by pw (0 = dead pair)
//   between layers: leaky(out, slope)
// The last layer (F = 1) writes the edge logits and skips the head branch.
//
// Translation from the TPU kernel: the TPU form gathers endpoint rows and
// scatters head sums with 0/1 incidence matmuls (inc1/inc2 [E, H]) and
// reduces each head's d-block with 0/1 segment matmuls, because Mosaic
// wants rank-2 matmuls.  Here endpoint rows are gathered by index (e1/e2),
// each d-block is reduced directly, and each head sums over its own list
// of incident edges (inc [H, D], built on the host from the topology).
//
// Bound on an H100 SXM at the serving bucket (H=20, E=160, 902-dim input):
// 180 rows x 2 x 1.96 M weights = 0.70 GFLOP of fp32 FMA, 10.5 us at the
// 67 TFLOP/s non-tensor-core peak; the 7.8 MB of fp32 weights are 2.3 us at
// 3.35 TB/s.  Compute-bound.  This first version is simple and right: a
// tiled GEMM with a fused bias + LeakyReLU epilogue for fc1 and fc2, then
// three small kernels per layer (attention terms, edge destinations, head
// destinations) -- 24 launches for the 5-layer stack, issued from one host
// call.  No tensor cores and no TF32: rounded operands move scores across
// the 0.5 decision threshold.
//
// Precision, as in gat_tiled.cu: fp32 operands and stored activations; the
// sums -- the fc products, the attention terms and the head sums -- are
// accumulated in fp64 (each fp32 product is exact there) and rounded to
// fp32 once.  With fp32 sums along k this kernel was 1e-4-level from an fp64
// evaluation on the trained matcher's logits at S=16, ten times the tiled
// kernels' (chip_smoke.py phase 3 prints both).

#include "fp32_gemm.cuh"

namespace {

using mpe3d::launch_gemm;
using mpe3d::leaky;

constexpr int MAX_NH = 16;                 // attention heads per layer
constexpr int MAX_D = 64;                  // incident edges per head

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

// Edge destinations: one thread per (edge, feature).  Writes the next
// layer's activation row H+e (leaky applied), or the logit on the last layer.
__global__ void edge_out(const float* __restrict__ z,
                         const float* __restrict__ att,
                         const int* __restrict__ e1, const int* __restrict__ e2,
                         int H, int E, int nh, int d, float alpha, float slope,
                         int last, float* __restrict__ xout) {
  const int F = nh * d;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= E * F) return;
  const int e = t / F, f = t % F, k = f / d;
  const int n = H + e, h1 = e1[e], h2 = e2[e];
  const float a2e = att[(size_t)n * 2 * nh + nh + k];
  const float l0 = leaky(att[(size_t)n * 2 * nh + k] + a2e, alpha);
  const float l1 = leaky(att[(size_t)h1 * 2 * nh + k] + a2e, alpha);
  const float l2 = leaky(att[(size_t)h2 * 2 * nh + k] + a2e, alpha);
  const float mx = fmaxf(l0, fmaxf(l1, l2));
  const float x0 = expf(l0 - mx), x1 = expf(l1 - mx), x2 = expf(l2 - mx);
  const float s = x0 + x1 + x2;
  const float v = (x0 / s) * z[(size_t)n * F + f]
                + (x1 / s) * z[(size_t)h1 * F + f]
                + (x2 / s) * z[(size_t)h2 * F + f];
  xout[(size_t)(last ? e : n) * F + f] = last ? v : leaky(v, slope);
}

// Head destinations: one block per head.  Threads k < nh first find the
// exact max over {self} + live incident edges and the softmax weights,
// then all threads form each feature's weighted sum.
__global__ void head_out(const float* __restrict__ z,
                         const float* __restrict__ att,
                         const float* __restrict__ pw,
                         const int* __restrict__ inc, int H, int D, int nh,
                         int d, float alpha, float slope,
                         float* __restrict__ xout) {
  __shared__ float wself[MAX_NH], denom[MAX_NH];
  __shared__ float wedge[MAX_D][MAX_NH];
  const int h = blockIdx.x, F = nh * d;
  const int* hinc = inc + (size_t)h * D;
  if (threadIdx.x < nh) {
    const int k = threadIdx.x;
    const float a2h = att[(size_t)h * 2 * nh + nh + k];
    const float ls = leaky(att[(size_t)h * 2 * nh + k] + a2h, alpha);
    float m = ls;
    for (int i = 0; i < D; ++i) {
      const int e = hinc[i];
      if (pw[e] > 0.f)
        m = fmaxf(m, leaky(att[(size_t)(H + e) * 2 * nh + k] + a2h, alpha));
    }
    const float es = expf(ls - m);
    double den = es;
    for (int i = 0; i < D; ++i) {
      const int e = hinc[i];
      float x = 0.f;
      if (pw[e] > 0.f)
        x = expf(leaky(att[(size_t)(H + e) * 2 * nh + k] + a2h, alpha) - m)
            * pw[e];
      wedge[i][k] = x;
      den += x;
    }
    wself[k] = es;
    denom[k] = float(den);
  }
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const int k = f / d;
    double num = double(wself[k]) * z[(size_t)h * F + f];
    for (int i = 0; i < D; ++i)
      num = fma(double(wedge[i][k]), double(z[(size_t)(H + hinc[i]) * F + f]),
                num);
    xout[(size_t)h * F + f] = leaky(float(num) / denom[k], slope);
  }
}

}  // namespace

// Whole stack for one frame.  weights: per layer, flat and in order,
// w1 [d_in, d_in], b1 [d_in], w2 [d_in, F], b2 [F], attn_l [F], attn_r [F].
// dims (host): per layer d_in, d_out, nh.  Scratch (device): h1 [N, max d_in],
// z / xa / xb [N, max F], att [N, 2 max nh].  out: [E] logits.
extern "C" int gat_stack_forward(
    const float* x0, const float* pw, const int* e1, const int* e2,
    const int* inc, const float* weights, const int* dims, int n_layers,
    int H, int E, int D, float alpha, float slope, float* h1, float* z,
    float* att, float* xa, float* xb, float* out, cudaStream_t stream) {
  const int N = H + E;
  if (D > MAX_D) return cudaErrorInvalidValue;
  const float* x = x0;
  const float* w = weights;
  for (int l = 0; l < n_layers; ++l) {
    const int d_in = dims[3 * l], d = dims[3 * l + 1], nh = dims[3 * l + 2];
    const int F = nh * d;
    if (nh > MAX_NH) return cudaErrorInvalidValue;
    const float* w1 = w;
    const float* b1 = w1 + (size_t)d_in * d_in;
    const float* w2 = b1 + d_in;
    const float* b2 = w2 + (size_t)d_in * F;
    const float* al = b2 + F;
    const float* ar = al + F;
    w = ar + F;
    const bool last = l == n_layers - 1;
    float* xo = (l % 2 == 0) ? xa : xb;

    launch_gemm<double>(x, w1, b1, h1, N, d_in, d_in, alpha, 1, stream);
    launch_gemm<double>(h1, w2, b2, z, N, F, d_in, 0.f, 0, stream);
    attn_terms<<<(N * nh + 127) / 128, 128, 0, stream>>>(z, al, ar, att, N,
                                                         nh, d);
    edge_out<<<(E * F + 127) / 128, 128, 0, stream>>>(
        z, att, e1, e2, H, E, nh, d, alpha, slope, last ? 1 : 0,
        last ? out : xo);
    if (!last)
      head_out<<<H, 128, 0, stream>>>(z, att, pw, inc, H, D, nh, d, alpha,
                                      slope, xo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    x = xo;
  }
  return cudaSuccess;
}
