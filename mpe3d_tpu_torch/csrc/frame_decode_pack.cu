// Whole-frame decode + gather + pack for Hopper: greedy person decode,
// components -> persons, per-person gather, lifter-input fields 0-9, the
// triangulated prior (mean / median / IRLS) with its gate, fields 10-13.
//
// Replaces the decode ... pack part of the TPU kernel
// mpe3d_tpu/ops/frame_kernel.py::_frame_kernel_call (pallas_call at :829;
// decode :527-609, persons :611-640, gather :642-671, prior :673-741).  The
// GAT before it and the MLP after it run through the port's other kernels
// (csrc/gat_stack.cu, csrc/fused_mlp.cu) on the same stream.  Python side
// and plain PyTorch version: mpe3d_tpu_torch/ops/frame_kernel.py.
//
// Design: ONE thread block of 256 threads, all state in shared memory.
//  * decode: n_live = min(#eligible, k_cap) is counted on the device
//    (__syncthreads_count); each trip is a block-wide argmax over the
//    remaining scores (ties -> lowest pair index, the order of a stable
//    descending sort, as lax.top_k gives), then warp 0 applies the union
//    step.  Camera sets are 32-bit masks (C <= 32): linked[h] (cameras head
//    h is linked to) and ccams[root] (cameras of a cluster), under the
//    reference merge quirk (matching/decode_device.py:155-163).
//  * persons: member counts, root_ok = count >= min_views, prefix rank of
//    the roots, persons[p, c] = the LARGEST slot of person p's heads on
//    camera c (the quirk can put two heads of one camera in one cluster).
//  * gather: one thread per (person, used camera, joint) copies the slot's
//    kp / valid / prob / observed (zeros where no slot) and writes fields
//    0-9 of pack_lifter_input, masked by observed.
//  * prior: one thread per (person, joint), geometry in fp32 exactly as the
//    reference's element-wise code (10 fixed-point undistortion steps, the
//    adjugate 3x3 solve with its 1e-20 det clamp, 2 refinement steps per
//    pair, 5 Huber rounds for IRLS); joint 0 never contributes; the gate
//    takes the masked LOWER median of the reprojection residuals.
//
// Bound on an H100 SXM at the serving bucket (E=160 pairs, H=20 heads,
// P=8, 5 used cameras, 18 joints): about 60 KB in and out (0.02 us at
// 3.35 TB/s) and well under a MFLOP; the work is a serial chain (one trip
// per live pair, each a block reduction and a barrier), so the kernel is
// latency-bound, far above either bound.  It is the simple, right form:
// what it removes is the host round-trip and the hundreds of small
// launches of the eager path, not device time.
//
// Numerics: no fast math; IEEE division and sqrt (nvcc's defaults), fp32
// throughout.  nvcc may contract a*b+c into an FMA, so results differ from
// the CPU's in the last bits.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <cfloat>
#include <climits>

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int MAX_CU = 8;
constexpr int MAX_PAIRS = MAX_CU * (MAX_CU - 1) / 2;

struct Args {
  const float* scores;            // [E]
  const float* pmask;             // [E]
  const int* pairs;               // [E, 4]: a, b, cam(a), cam(b)
  const int* used_pos;            // [Cu] matching row of each used camera
  const float* kp;                // [Cu, S, J, 2]
  const float* valid;             // [Cu, S, J]
  const float* prob;              // [Cu, S, J]
  const unsigned char* observed;  // [Cu, S, J]
  const float* cams;              // [Cu, 21]: fx fy cx cy k1 k2 p1 p2 k3 P
  const float* cam_world;         // [Cu, 12]: T_cw[:3, :4]
  int E, C, S, J, Cu, P;
  float threshold;
  int min_views, k_cap, prior, gate_on;
  float gate_px, img_w, img_h;
  int* persons;                   // [P, C]
  unsigned char* person_mask;     // [P]
  float* net;                     // [P, Cu, J, 14]
  float* gkp;                     // [P, Cu, J, 2]
  float* gval;                    // [P, Cu, J]
  unsigned char* gobs;            // [P, Cu, J]
};

// Shared-memory layout shared by the kernel and the host entry point.
struct Layout {
  int heads_off, persons_off, phase_off, total;
  __host__ __device__ Layout(int E, int H, int P, int C, int Cu, int J) {
    heads_off = 0;                                  // 5 int arrays [H]
    persons_off = heads_off + 5 * H * 4;            // int [P * C]
    phase_off = (persons_off + P * C * 4 + 15) / 16 * 16;
    const int decode = 8 * E;                       // rem [E], pk [E]
    const int pcj = P * Cu * J;
    const int gather = 16 * pcj + pcj;              // 4 floats + 1 byte
    total = phase_off + (decode > gather ? decode : gather);
  }
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// cv2-style fixed-point undistortion (geometry/camera.py::undistort_points).
__device__ void undistort(const float* cc, float u, float v, float& x,
                          float& y) {
  const float fx = cc[0], fy = cc[1], cx = cc[2], cy = cc[3];
  const float k1 = cc[4], k2 = cc[5], p1 = cc[6], p2 = cc[7], k3 = cc[8];
  const float xd = (u - cx) / fx, yd = (v - cy) / fy;
  x = xd;
  y = yd;
  for (int it = 0; it < 10; ++it) {
    const float r2 = x * x + y * y;
    const float f = 1.f + r2 * (k1 + r2 * (k2 + r2 * k3));
    const float dx = 2.f * p1 * x * y + p2 * (r2 + 2.f * x * x);
    const float dy = p1 * (r2 + 2.f * y * y) + 2.f * p2 * x * y;
    const float nx = (xd - dx) / f, ny = (yd - dy) / f;
    x = nx;
    y = ny;
  }
}

// geometry/triangulate.py::_solve3x3 (adjugate, |det| < 1e-20 -> 1e-20).
__device__ void solve3x3(const float M[3][3], const float b[3], float x[3]) {
  const float a = M[0][0], d = M[0][1], g = M[0][2];
  const float e = M[1][1], h = M[1][2], c = M[1][0];
  const float f = M[2][0], i = M[2][1], k = M[2][2];
  const float A00 = e * k - h * i, A01 = h * f - c * k, A02 = c * i - e * f;
  const float A10 = g * i - d * k, A11 = a * k - g * f, A12 = d * f - a * i;
  const float A20 = d * h - g * e, A21 = g * c - a * h, A22 = a * e - d * c;
  float det = a * A00 + d * A01 + g * A02;
  if (fabsf(det) < 1e-20f) det = 1e-20f;
  x[0] = (A00 * b[0] + A10 * b[1] + A20 * b[2]) / det;
  x[1] = (A01 * b[0] + A11 * b[1] + A21 * b[2]) / det;
  x[2] = (A02 * b[0] + A12 * b[1] + A22 * b[2]) / det;
}

// geometry/triangulate.py::triangulate_pair, 2 refinement steps.
__device__ void triangulate_pair(float x1, float y1, float x2, float y2,
                                 const float* P1, const float* P2,
                                 float out[3]) {
  float B[4][3], d[4];
  const float xs[4] = {x1, y1, x2, y2};
  for (int r = 0; r < 4; ++r) {
    const float* Pm = r < 2 ? P1 : P2;
    const int row = r % 2;
    for (int k = 0; k < 3; ++k) B[r][k] = xs[r] * Pm[8 + k] - Pm[4 * row + k];
    d[r] = xs[r] * Pm[11] - Pm[4 * row + 3];
  }
  float M[3][3], rhs[3];
  for (int a = 0; a < 3; ++a) {
    for (int c = 0; c < 3; ++c) {
      float s = 0.f;
      for (int r = 0; r < 4; ++r) s += B[r][a] * B[r][c];
      M[a][c] = s;
    }
    float s = 0.f;
    for (int r = 0; r < 4; ++r) s += B[r][a] * d[r];
    rhs[a] = -s;
  }
  solve3x3(M, rhs, out);
  for (int step = 0; step < 2; ++step) {
    float res[4];
    for (int r = 0; r < 4; ++r) {
      float s = 0.f;
      for (int k = 0; k < 3; ++k) s += B[r][k] * out[k];
      res[r] = s + d[r];
    }
    for (int a = 0; a < 3; ++a) {
      float s = 0.f;
      for (int r = 0; r < 4; ++r) s += B[r][a] * res[r];
      rhs[a] = -s;
    }
    float corr[3];
    solve3x3(M, rhs, corr);
    for (int k = 0; k < 3; ++k) out[k] += corr[k];
  }
}

// Value of ascending rank `target` among vals[0..n) where valid (others
// count as `big`), ties broken by list index (a counting selection).
__device__ float select_rank(const float* vals, const bool* ok, int n,
                             int target, float big) {
  float out = big;
  for (int q = 0; q < n; ++q) {
    const float vq = ok[q] ? vals[q] : big;
    int rank = 0;
    for (int r = 0; r < n; ++r) {
      const float vr = ok[r] ? vals[r] : big;
      rank += (vr < vq || (vr == vq && r < q)) ? 1 : 0;
    }
    if (rank == target) out = vq;
  }
  return out;
}

// geometry/triangulate.py::triangulate_irls for one (person, joint).
__device__ void irls(const float* cams, const float* xn, const float* yn,
                     const bool* v, int Cu, float X[3]) {
  float B1[MAX_CU][3], B2[MAX_CU][3], d1[MAX_CU], d2[MAX_CU], delta[MAX_CU];
  for (int c = 0; c < Cu; ++c) {
    const float* cc = cams + 21 * c;
    const float* Pm = cc + 9;
    delta[c] = 4.f / ((cc[0] + cc[1]) * 0.5f);
    for (int k = 0; k < 3; ++k) {
      B1[c][k] = xn[c] * Pm[8 + k] - Pm[k];
      B2[c][k] = yn[c] * Pm[8 + k] - Pm[4 + k];
    }
    d1[c] = xn[c] * Pm[11] - Pm[3];
    d2[c] = yn[c] * Pm[11] - Pm[7];
  }
  float w[MAX_CU];
  auto solve = [&](float out[3]) {
    float M1[3][3] = {}, M2[3][3] = {}, b1[3] = {}, b2[3] = {};
    for (int c = 0; c < Cu; ++c) {
      const float wj = v[c] ? w[c] : 0.f;
      for (int a = 0; a < 3; ++a) {
        const float u1 = B1[c][a] * wj, u2 = B2[c][a] * wj;
        for (int k = 0; k < 3; ++k) {
          M1[a][k] += u1 * B1[c][k];
          M2[a][k] += u2 * B2[c][k];
        }
        b1[a] += u1 * d1[c];
        b2[a] += u2 * d2[c];
      }
    }
    float M[3][3], rhs[3];
    for (int a = 0; a < 3; ++a) {
      for (int k = 0; k < 3; ++k)
        M[a][k] = M1[a][k] + M2[a][k] + (a == k ? 1e-8f : 0.f);
      rhs[a] = -(b1[a] + b2[a]);
    }
    solve3x3(M, rhs, out);
  };
  for (int c = 0; c < Cu; ++c) w[c] = 1.f;
  solve(X);
  for (int it = 0; it < 5; ++it) {
    float r[MAX_CU], z2[MAX_CU];
    for (int c = 0; c < Cu; ++c) {
      const float* Pm = cams + 21 * c + 9;
      float xc[3];
      for (int k = 0; k < 3; ++k)
        xc[k] = (Pm[4 * k] * X[0] + Pm[4 * k + 1] * X[1]
                 + Pm[4 * k + 2] * X[2]) + Pm[4 * k + 3];
      const float z = fmaxf(xc[2], 1e-4f);
      const float rx = xc[0] / z - xn[c], ry = xc[1] / z - yn[c];
      r[c] = sqrtf(rx * rx + ry * ry);
      z2[c] = xc[2];
      w[c] = fminf(delta[c] / fmaxf(r[c], 1e-12f), 1.f);
    }
    // hard-zero the far tail, but only where >= 3 cameras remain
    int nz = 0;
    for (int c = 0; c < Cu; ++c)
      nz += (r[c] > 10.f * delta[c] ? 0.f : w[c]) > 0.f && v[c];
    if (nz >= 3)
      for (int c = 0; c < Cu; ++c)
        if (r[c] > 10.f * delta[c]) w[c] = 0.f;
    // drop behind-camera views only where >= 2 weighted views remain
    int nzb = 0;
    for (int c = 0; c < Cu; ++c) nzb += (z2[c] > 1e-4f ? w[c] : 0.f) > 0.f && v[c];
    if (nzb >= 2)
      for (int c = 0; c < Cu; ++c)
        if (!(z2[c] > 1e-4f)) w[c] = 0.f;
    solve(X);
  }
}

__global__ void __launch_bounds__(THREADS) frame_decode_pack_kernel(Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float cam_s[MAX_CU * 21], cw_s[MAX_CU * 12];
  __shared__ float warp_v[NWARP];
  __shared__ int warp_i[NWARP];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int E = g.E, C = g.C, S = g.S, J = g.J, Cu = g.Cu, P = g.P;
  const int H = C * S;
  const Layout lay(E, H, P, C, Cu, J);
  int* cluster = reinterpret_cast<int*>(smem + lay.heads_off);
  unsigned* linked = reinterpret_cast<unsigned*>(cluster + H);
  unsigned* ccams = linked + H;
  int* root_ok = reinterpret_cast<int*>(ccams + H);
  int* rank = root_ok + H;
  int* persons_s = reinterpret_cast<int*>(smem + lay.persons_off);
  float* rem = reinterpret_cast<float*>(smem + lay.phase_off);
  unsigned* pk = reinterpret_cast<unsigned*>(rem + E);

  for (int i = tid; i < Cu * 21; i += THREADS) cam_s[i] = g.cams[i];
  for (int i = tid; i < Cu * 12; i += THREADS) cw_s[i] = g.cam_world[i];
  for (int h = tid; h < H; h += THREADS) {
    cluster[h] = -1;
    linked[h] = 1u << (h / S);          // each head starts on its own camera
    ccams[h] = 0u;
  }

  // ---- decode: eligible pairs, counted on the device -------------------
  int n_elig = 0;
  for (int base = 0; base < E; base += THREADS) {
    const int i = base + tid;
    bool el = false;
    if (i < E) {
      const float s = g.scores[i];
      el = g.pmask[i] > 0.5f && s > g.threshold;
      rem[i] = el ? s : -CUDART_INF_F;
      const int* pr = g.pairs + 4 * i;
      pk[i] = unsigned(pr[0]) | unsigned(pr[1]) << 10 | unsigned(pr[2]) << 20
              | unsigned(pr[3]) << 25;
    }
    n_elig += __syncthreads_count(el);
  }
  const int n_live = n_elig < g.k_cap ? n_elig : g.k_cap;

  for (int t = 0; t < n_live; ++t) {
    float bv = -CUDART_INF_F;
    int bi = INT_MAX;
    for (int i = tid; i < E; i += THREADS) {
      const float v = rem[i];
      if (v > bv) { bv = v; bi = i; }     // ascending i: first max kept
    }
    warp_argmax(bv, bi);
    if (lane == 0) { warp_v[warp] = bv; warp_i[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bv = lane < NWARP ? warp_v[lane] : -CUDART_INF_F;
      bi = lane < NWARP ? warp_i[lane] : INT_MAX;
      warp_argmax(bv, bi);
      const unsigned p = pk[bi];
      const int a = p & 1023u, b = (p >> 10) & 1023u;
      const unsigned bA = 1u << ((p >> 20) & 31u), bB = 1u << ((p >> 25) & 31u);
      const int ka = cluster[a], kb = cluster[b];
      const bool ah = ka >= 0, bh = kb >= 0;
      const unsigned cA = ah ? ccams[ka] : 0u, cB = bh ? ccams[kb] : 0u;
      const bool reject = (linked[b] & bA) || (linked[a] & bB) || (cA & bB)
                          || (cB & bA) || (cA & cB);
      __syncwarp();
      if (!reject) {
        const int root = ah ? ka : (bh ? kb : a);
        const bool merge = ah && bh;
        for (int h = lane; h < H; h += 32) {
          if ((merge && cluster[h] == kb) || h == a || h == b)
            cluster[h] = root;
        }
        if (lane == 0) {
          // cameras the surviving root gains: a new pair both, an
          // extension the other endpoint's, a merge none (the quirk)
          ccams[root] |= (!ah && !bh) ? (bA | bB) : merge ? 0u
                                                          : (ah ? bB : bA);
          if (merge && kb != root) ccams[kb] = 0u;
          linked[a] |= bB;
          linked[b] |= bA;
        }
      }
      if (lane == 0) rem[bi] = -CUDART_INF_F;
    }
    __syncthreads();
  }

  // ---- components -> persons -------------------------------------------
  for (int h = tid; h < H; h += THREADS) {
    int n = 0;
    for (int h2 = 0; h2 < H; ++h2) n += cluster[h2] == h;
    root_ok[h] = n >= g.min_views;
  }
  __syncthreads();
  for (int h = tid; h < H; h += THREADS) {
    int n = 0;
    for (int h2 = 0; h2 <= h; ++h2) n += root_ok[h2];
    rank[h] = n - 1;
  }
  __syncthreads();
  const int n_persons = rank[H - 1] + 1;
  for (int pc = tid; pc < P * C; pc += THREADS) {
    const int p = pc / C, c = pc % C;
    int best = -1;
    for (int s = 0; s < S; ++s) {
      const int k = cluster[c * S + s];
      if (k >= 0 && root_ok[k] && rank[k] == p) best = s;   // s ascending
    }
    persons_s[pc] = best;
    g.persons[pc] = best;
  }
  for (int p = tid; p < P; p += THREADS) g.person_mask[p] = p < n_persons;
  __syncthreads();

  // ---- gather and fields 0-9 (the decode's smem is reused) ---------------
  const int pcj = P * Cu * J;
  float* sx = reinterpret_cast<float*>(smem + lay.phase_off);
  float* sy = sx + pcj;
  float* sxn = sy + pcj;
  float* syn = sxn + pcj;
  bool* sob = reinterpret_cast<bool*>(syn + pcj);
  const float hw = g.img_w / 2.f, hh = g.img_h / 2.f;
  for (int i = tid; i < pcj; i += THREADS) {
    const int j = i % J, cu = (i / J) % Cu, p = i / (J * Cu);
    const int mc = g.used_pos[cu];
    const int slot = mc >= 0 ? persons_s[p * C + mc] : -1;
    float u = 0.f, v = 0.f, val = 0.f, pr = 0.f;
    bool ob = false;
    if (slot >= 0) {
      const int src = (cu * S + slot) * J + j;
      u = g.kp[2 * src];
      v = g.kp[2 * src + 1];
      val = g.valid[src];
      pr = g.prob[src];
      ob = g.observed[src] != 0;
    }
    g.gkp[2 * i] = u;
    g.gkp[2 * i + 1] = v;
    g.gval[i] = val;
    g.gobs[i] = ob;
    float xn, yn;
    undistort(cam_s + 21 * cu, u, v, xn, yn);
    sx[i] = u;
    sy[i] = v;
    sxn[i] = xn;
    syn[i] = yn;
    sob[i] = ob;
    const float m = ob ? 1.f : 0.f;
    const float* cw = cw_s + 12 * cu;
    float* o = g.net + (size_t)i * 14;
    o[0] = val * m;
    o[1] = (u - hw) / hw * m;
    o[2] = (v - hh) / hh * m;
    o[3] = pr * m;
    for (int k = 0; k < 3; ++k) {
      o[4 + k] = cw[4 * k + 3] / 10.f * m;
      o[7 + k] = (cw[4 * k] * xn + cw[4 * k + 1] * yn + cw[4 * k + 2])
                 / 10.f * m;
    }
  }
  __syncthreads();

  // ---- triangulated prior, gate, fields 10-13 ----------------------------
  for (int i = tid; i < P * J; i += THREADS) {
    const int p = i / J, j = i % J;
    float xn[MAX_CU], yn[MAX_CU];
    bool tob[MAX_CU], inc[MAX_CU];
    int n_view = 0;
    for (int c = 0; c < Cu; ++c) {
      const int q = (p * Cu + c) * J + j;
      xn[c] = sxn[q];
      yn[c] = syn[q];
      inc[c] = sob[q];
      tob[c] = inc[c] && j > 0;          // joint 0 never contributes
      n_view += tob[c];
    }
    float X[3] = {0.f, 0.f, 0.f};
    bool ok;
    if (g.prior == 2) {
      irls(cam_s, xn, yn, tob, Cu, X);
      ok = n_view > 1;
    } else {
      float pts[MAX_PAIRS][3];
      bool pv[MAX_PAIRS];
      int np = 0, n_valid = 0;
      for (int a = 0; a < Cu; ++a)
        for (int b = a + 1; b < Cu; ++b, ++np) {
          triangulate_pair(xn[a], yn[a], xn[b], yn[b], cam_s + 21 * a + 9,
                           cam_s + 21 * b + 9, pts[np]);
          pv[np] = tob[a] && tob[b];
          n_valid += pv[np];
        }
      bool keep[MAX_PAIRS];
      if (g.prior == 1) {                 // pairs near the median x
        float xs[MAX_PAIRS];
        for (int q = 0; q < np; ++q) xs[q] = pts[q][0];
        const float med = select_rank(xs, pv, np, n_valid / 2, FLT_MAX);
        for (int q = 0; q < np; ++q)
          keep[q] = pv[q] && fabsf(pts[q][0] - med) < 0.05f;
      } else {
        for (int q = 0; q < np; ++q) keep[q] = pv[q];
      }
      float n = 0.f, sum[3] = {0.f, 0.f, 0.f};
      for (int q = 0; q < np; ++q) {
        const float w = keep[q] ? 1.f : 0.f;
        n += w;
        for (int k = 0; k < 3; ++k) sum[k] += pts[q][k] * w;
      }
      for (int k = 0; k < 3; ++k) X[k] = sum[k] / fmaxf(n, 1.f);
      ok = n_valid > 0;
    }
    if (!ok) X[0] = X[1] = X[2] = 0.f;
    if (g.gate_on && ok) {
      // masked lower median of the prior's reprojection residuals
      float d[MAX_CU];
      int nv = 0;
      for (int c = 0; c < Cu; ++c) {
        const float* cc = cam_s + 21 * c;
        const float* Pm = cc + 9;
        float pc[3];
        for (int k = 0; k < 3; ++k)
          pc[k] = (Pm[4 * k] * X[0] + Pm[4 * k + 1] * X[1]
                   + Pm[4 * k + 2] * X[2]) + Pm[4 * k + 3];
        float z = pc[2];
        if (fabsf(z) < 1e-4f) z = z < 0.f ? -1e-4f : 1e-4f;
        const float x0 = pc[0] / z, y0 = pc[1] / z;
        const float r2 = x0 * x0 + y0 * y0;
        const float f = 1.f + r2 * (cc[4] + r2 * (cc[5] + r2 * cc[8]));
        const float pu = x0 * f * cc[0] + cc[2];
        const float pv = y0 * f * cc[1] + cc[3];
        const int q = (p * Cu + c) * J + j;
        const float du = fminf(fmaxf(sx[q] - pu, -1e5f), 1e5f);
        const float dv = fminf(fmaxf(sy[q] - pv, -1e5f), 1e5f);
        d[c] = sqrtf(du * du + dv * dv);
        nv += inc[c];
      }
      const int target = nv > 0 ? (nv + 1) / 2 - 1 : 0;
      const float resid = select_rank(d, inc, Cu, target, CUDART_INF_F);
      if (nv > 0 && resid > g.gate_px) ok = false;
    }
    const float okf = ok ? 1.f : 0.f;
    for (int c = 0; c < Cu; ++c) {
      float* o = g.net + ((size_t)(p * Cu + c) * J + j) * 14;
      o[10] = okf;
      for (int k = 0; k < 3; ++k) o[11 + k] = X[k] * okf / 10.f;
    }
  }
}

}  // namespace

// Decode + gather + pack of one frame on `stream`: one block of 256 threads.
// Sizes: E <= 4096, H = C*S <= 1024, C <= 32, Cu <= 8; prior 0 mean,
// 1 median, 2 irls; gate_on 0/1.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for sizes out of range).
extern "C" int frame_decode_pack(
    const float* scores, const float* pmask, const int* pairs,
    const int* used_pos, const float* kp, const float* valid,
    const float* prob, const unsigned char* observed, const float* cams,
    const float* cam_world, int E, int C, int S, int J, int Cu, int P,
    float threshold, int min_views, int k_cap, int prior, int gate_on,
    float gate_px, float img_w, float img_h, int* persons,
    unsigned char* person_mask, float* net, float* gkp, float* gval,
    unsigned char* gobs, cudaStream_t stream) {
  const int H = C * S;
  if (E < 1 || E > 4096 || H < 1 || H > 1024 || C > 32 || Cu < 1
      || Cu > MAX_CU || P < 1 || J < 1 || prior < 0 || prior > 2)
    return cudaErrorInvalidValue;
  const Layout lay(E, H, P, C, Cu, J);
  if (lay.total > 200 * 1024) return cudaErrorInvalidValue;
  if (lay.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        frame_decode_pack_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (err != cudaSuccess) return err;
  }
  Args g{scores, pmask, pairs, used_pos, kp, valid, prob, observed, cams,
         cam_world, E, C, S, J, Cu, P, threshold, min_views, k_cap, prior,
         gate_on, gate_px, img_w, img_h, persons, person_mask, net, gkp,
         gval, gobs};
  frame_decode_pack_kernel<<<1, THREADS, lay.total, stream>>>(g);
  return cudaGetLastError();
}
