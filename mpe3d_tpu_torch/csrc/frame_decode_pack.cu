// Whole-frame decode + gather + pack for Hopper: greedy person decode,
// components -> persons, per-person gather, lifter-input fields 0-9, the
// triangulated prior (mean / median / IRLS) with its gate, fields 10-13.
//
// Replaces the decode ... pack part of the TPU kernel
// mpe3d_tpu/ops/frame_kernel.py::_frame_kernel_call (pallas_call at :829;
// decode :527-609, persons :611-640, gather :642-671, prior :673-741).  The
// GAT before it and the MLP after it run through the port's other kernels
// (csrc/gat_stack.cu or csrc/gat_tiled.cu, csrc/fused_mlp.cu) on the same
// stream.  Python side and plain PyTorch version:
// mpe3d_tpu_torch/ops/frame_kernel.py.
//
// Bound on an H100 SXM at the serving bucket (E=160 pairs, H=20 heads,
// P=8, 5 used cameras, 18 joints): about 60 KB in and out (0.02 us at
// 3.35 TB/s) and well under a MFLOP.  What the kernel waits on is its
// serial chains: the greedy decode takes the live pairs one at a time, and
// each (person, joint) prior is a chain of small solves.  The design keeps
// those chains short and their steps cheap.
//
// Design: ONE thread block of 256 threads, all state in shared memory.
//  * decode order, built once: each eligible pair (pair present, score
//    above the threshold) gets a 64-bit key, the order-preserving bits of
//    its score inverted (descending), then its index (ascending): ascending
//    keys are the order of a stable descending sort, ties to the lower pair
//    index, as lax.top_k gives (matching/decode_device.py:106).  The keys
//    are compacted into shared memory (a shared counter: their order there
//    does not matter, the keys carry it).  Up to 1024 eligible pairs, each
//    key's place is the count of smaller keys (one pass, no barrier within);
//    past that the keys are padded to a power of two and bitonic-sorted by
//    the block.  The first n_live = min(#eligible, k_cap) are the trips, in
//    order.
//  * the walk: ONE warp takes the n_live candidates in order with __syncwarp
//    only, no block barrier and no scan of the pairs a trip: each trip reads
//    its pair, tests the reject rule and applies the union step (a merge
//    relabels the heads in parallel over the lanes).  Camera sets are 32-bit
//    masks (C <= 32): linked[h] (cameras head h is linked to) and
//    ccams[root] (cameras of a cluster), under the reference merge quirk
//    (matching/decode_device.py:155-163).  The other warps meanwhile
//    undistort the (0, 0) pixel of each camera (the gathered value of an
//    empty slot) and, where shared memory allows, stage every slot's
//    observations with their undistortion.
//  * persons: member counts, root_ok = count >= min_views, prefix rank of
//    the roots, persons[p, c] = the LARGEST slot of person p's heads on
//    camera c (the quirk can put two heads of one camera in one cluster).
//  * gather: one thread per (decoded person, used camera, joint) copies the
//    slot's kp / valid / prob / observed (zeros where no slot) and writes
//    fields 0-9 of pack_lifter_input, masked by observed; the rows past the
//    decoded persons (no slot, nothing observed, prior not ok) are zeros.
//  * prior: each (person, joint) of a decoded person takes a group of up to
//    8 lanes, as many as keep them all in one round of the block: for the
//    mean and median priors lane l triangulates the camera pairs l, l + G,
//    ... into the group's slot of shared memory (the Panoptic rig's 5 used
//    cameras give 10 pairs) and takes the median's rank tests of the same
//    pairs; IRLS is a chain of six small solves, kept whole in each lane's
//    registers; the lanes write the fields of cameras l, l + G, ...  Every
//    joint's arithmetic keeps the reference's order: geometry in fp32 as
//    its element-wise code (10 fixed-point undistortion steps, the adjugate
//    3x3 solve with its 1e-20 det clamp, 2 refinement steps per pair, 5
//    Huber rounds for IRLS); joint 0 never contributes; the gate takes the
//    masked LOWER median of the reprojection residuals.
//
// Numerics: no fast math; IEEE division and sqrt (nvcc's defaults), fp32
// throughout.  nvcc may contract a*b+c into an FMA, so results differ from
// the CPU's in the last bits.

#include <cuda_runtime.h>
#include <atomic>
#include <math_constants.h>
#include <cfloat>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CU = 8;
constexpr int RANK_SORT = 1024;  // keys ordered by counting, sorted past it
constexpr int MAX_DEVICES = 64;
// shared memory up to which the frame's observations are staged
constexpr int STAGE_LIMIT = 160 * 1024;

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

// Shared-memory layout shared by the kernel and the host entry point: the
// heads' state and the persons; one area for the decode (sort keys and the
// candidates in order) and then the gather and the prior's group slots;
// and, where it fits, the frame's observations of every slot staged with
// their undistortion.
struct Layout {
  int heads_off, persons_off, phase_off, scratch_off, scratch_slot;
  int stage_off, n_pad, total;
  bool staged;
  __host__ __device__ Layout(int E, int H, int P, int C, int Cu, int J,
                             int S) {
    heads_off = 0;                                  // 5 int arrays [H]
    persons_off = heads_off + 5 * H * 4;            // int [P * C]
    phase_off = (persons_off + P * C * 4 + 15) / 16 * 16;
    n_pad = 1;                                      // keys of a sort
    while (n_pad < E) n_pad <<= 1;
    const int decode = 8 * n_pad + 4 * E;           // keys, candidates
    const int pcj = P * Cu * J;
    const int np = Cu * (Cu - 1) / 2;
    scratch_slot = 3 * np + 1;    // floats a group: the pairs, the median
    scratch_off = (phase_off + 17 * pcj + 15) / 16 * 16;
    // gathered observations (4 floats + 1 byte), then a slot for each of
    // the at most THREADS groups of the prior
    const int gather = scratch_off - phase_off + 4 * scratch_slot * THREADS;
    stage_off = (phase_off + (decode > gather ? decode : gather) + 15) / 16
                * 16;
    const int stage = 25 * Cu * S * J;              // 6 floats + 1 byte
    staged = stage_off + stage <= STAGE_LIMIT;
    total = staged ? stage_off + stage : stage_off;
  }
};

// Sort key of an eligible pair: the score's order-preserving bits,
// inverted (descending), then the pair index (ascending).  -0 is taken as
// +0, as the comparison of scores does.
__device__ __forceinline__ unsigned long long decode_key(float s, int i) {
  const unsigned u = s == 0.f ? 0u : __float_as_uint(s);
  const unsigned asc = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (unsigned long long)(~asc) << 32 | (unsigned)i;
}

// Ascending bitonic sort of keys[0, n), n a power of two, by the block.
__device__ void bitonic_sort(unsigned long long* keys, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += THREADS) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = keys[i], b = keys[ixj];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
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
__device__ __forceinline__ void solve3x3(const float M[3][3],
                                         const float b[3], float x[3]) {
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

// geometry/triangulate.py::triangulate_pair, 2 refinement steps (one call
// site: its arrays stay in registers).
__device__ __noinline__ float3 triangulate_pair(float x1, float y1, float x2,
                                                float y2, const float* P1,
                                                const float* P2) {
  float B[4][3], d[4], out[3];
  const float xs[4] = {x1, y1, x2, y2};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* Pm = r < 2 ? P1 : P2;
    const int row = r % 2;
#pragma unroll
    for (int k = 0; k < 3; ++k) B[r][k] = xs[r] * Pm[8 + k] - Pm[4 * row + k];
    d[r] = xs[r] * Pm[11] - Pm[4 * row + 3];
  }
  float M[3][3], rhs[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) s += B[r][a] * B[r][c];
      M[a][c] = s;
    }
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) s += B[r][a] * d[r];
    rhs[a] = -s;
  }
  solve3x3(M, rhs, out);
#pragma unroll
  for (int step = 0; step < 2; ++step) {
    float res[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) s += B[r][k] * out[k];
      res[r] = s + d[r];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) s += B[r][a] * res[r];
      rhs[a] = -s;
    }
    float corr[3];
    solve3x3(M, rhs, corr);
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k] += corr[k];
  }
  return make_float3(out[0], out[1], out[2]);
}

// Value of ascending rank `target` among vals[0..N) where bit q of `ok` is
// set and q < n (others count as `big`), ties broken by list index (a
// counting selection), unrolled so that vals stays in registers.
template <int N>
__device__ __forceinline__ float select_rank(const float (&vals)[N],
                                             unsigned ok, int n, int target,
                                             float big) {
  float out = big;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float vq = q < n && (ok >> q) & 1u ? vals[q] : big;
    int rank = 0;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const float vr = r < n && (ok >> r) & 1u ? vals[r] : big;
      rank += (r < n && (vr < vq || (vr == vq && r < q))) ? 1 : 0;
    }
    if (q < n && rank == target) out = vq;
  }
  return out;
}

// Cameras (a, b), a < b, of camera pair q in the reference's order
// (0, 1), (0, 2), ..., (0, Cu - 1), (1, 2), ...
__device__ __forceinline__ void pair_cameras(int q, int Cu, int& a, int& b) {
  a = 0;
  while (q >= Cu - 1 - a) {
    q -= Cu - 1 - a;
    ++a;
  }
  b = a + 1 + q;
}

// The G lanes (1, 2, 4 or 8) that take one decoded (person, joint), and
// their slot of shared memory: lane l takes the camera pairs l, l + G, ...
// of the mean and median priors and the output fields of the cameras l,
// l + G, ...
struct Group {
  int l, G;           // lane in the group, lanes of the group
  unsigned mask;      // the group's lanes in the warp
  float* slot;        // the group's values in shared memory
};

// geometry/triangulate.py::triangulate_irls for one (person, joint): a
// chain of six small solves, so every per-camera value stays in registers
// (loops over the MAX_CU cameras, unrolled and guarded); the lanes of the
// joint's group run it alike (the same X on each).
__device__ __forceinline__ void irls(const float* cams, const float* delta,
                                     const float* xn_s, const float* yn_s,
                                     int stride, unsigned v, int Cu,
                                     float X[3]) {
  float xn[MAX_CU], yn[MAX_CU], B1[MAX_CU][3], B2[MAX_CU][3], d1[MAX_CU];
  float d2[MAX_CU], w[MAX_CU];
#pragma unroll
  for (int c = 0; c < MAX_CU; ++c) {
    const int cc = c < Cu ? c : 0;
    const float* Pm = cams + 21 * cc + 9;
    xn[c] = xn_s[cc * stride];
    yn[c] = yn_s[cc * stride];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      B1[c][k] = xn[c] * Pm[8 + k] - Pm[k];
      B2[c][k] = yn[c] * Pm[8 + k] - Pm[4 + k];
    }
    d1[c] = xn[c] * Pm[11] - Pm[3];
    d2[c] = yn[c] * Pm[11] - Pm[7];
    w[c] = 1.f;
  }
  auto solve = [&]() {
    float M1[3][3] = {}, M2[3][3] = {}, b1[3] = {}, b2[3] = {};
#pragma unroll
    for (int c = 0; c < MAX_CU; ++c) {
      if (c < Cu) {
        const float wj = (v >> c) & 1u ? w[c] : 0.f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float u1 = B1[c][a] * wj, u2 = B2[c][a] * wj;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            M1[a][k] += u1 * B1[c][k];
            M2[a][k] += u2 * B2[c][k];
          }
          b1[a] += u1 * d1[c];
          b2[a] += u2 * d2[c];
        }
      }
    }
    float M[3][3], rhs[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        M[a][k] = M1[a][k] + M2[a][k] + (a == k ? 1e-8f : 0.f);
      rhs[a] = -(b1[a] + b2[a]);
    }
    solve3x3(M, rhs, X);
  };
  solve();
  for (int it = 0; it < 5; ++it) {
    float r[MAX_CU], z2[MAX_CU];
    int nz = 0, nzb = 0;
#pragma unroll
    for (int c = 0; c < MAX_CU; ++c) {
      if (c < Cu) {
        const float* Pm = cams + 21 * c + 9;
        float xc[3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          xc[k] = (Pm[4 * k] * X[0] + Pm[4 * k + 1] * X[1]
                   + Pm[4 * k + 2] * X[2]) + Pm[4 * k + 3];
        const float z = fmaxf(xc[2], 1e-4f);
        const float rx = xc[0] / z - xn[c], ry = xc[1] / z - yn[c];
        r[c] = sqrtf(rx * rx + ry * ry);
        z2[c] = xc[2];
        w[c] = fminf(delta[c] / fmaxf(r[c], 1e-12f), 1.f);
        nz += (r[c] > 10.f * delta[c] ? 0.f : w[c]) > 0.f && (v >> c) & 1u;
      }
    }
    // hard-zero the far tail, but only where >= 3 cameras remain
#pragma unroll
    for (int c = 0; c < MAX_CU; ++c) {
      if (c < Cu) {
        if (nz >= 3 && r[c] > 10.f * delta[c]) w[c] = 0.f;
        // drop behind-camera views only where >= 2 weighted views remain
        nzb += (z2[c] > 1e-4f ? w[c] : 0.f) > 0.f && (v >> c) & 1u;
      }
    }
    if (nzb >= 2) {
#pragma unroll
      for (int c = 0; c < MAX_CU; ++c)
        if (c < Cu && !(z2[c] > 1e-4f)) w[c] = 0.f;
    }
    solve();
  }
}

// The mean (or median) prior of one (person, joint) on its group: lane l
// triangulates the camera pairs l, l + G, ... into the group's slot; the
// median's rank test is split over the lanes the same way; every lane then
// sums the kept pairs in the reference's order.  Returns #valid pairs.
__device__ int pair_prior(const Group& q, const float* cam_s,
                          const float* xn, const float* yn, int stride,
                          unsigned tob, int Cu, bool median, float X[3]) {
  const int np = Cu * (Cu - 1) / 2;
  for (int u = q.l; u < np; u += q.G) {
    int a, b;
    pair_cameras(u, Cu, a, b);
    const float3 pt = triangulate_pair(
        xn[a * stride], yn[a * stride], xn[b * stride], yn[b * stride],
        cam_s + 21 * a + 9, cam_s + 21 * b + 9);
    q.slot[3 * u] = pt.x;
    q.slot[3 * u + 1] = pt.y;
    q.slot[3 * u + 2] = pt.z;
  }
  unsigned pv = 0;
  for (int u = 0, a = 0; a < Cu; ++a)
    for (int b = a + 1; b < Cu; ++b, ++u)
      if ((tob >> a) & (tob >> b) & 1u) pv |= 1u << u;
  const int n_valid = __popc(pv);
  __syncwarp(q.mask);
  unsigned keep = pv;
  if (median) {
    // pairs near the median x: the lower median of the valid pairs' x
    // (invalid ones count as FLT_MAX), ties by pair index
    const int target = n_valid / 2;
    for (int u = q.l; u < np; u += q.G) {
      const float vu = (pv >> u) & 1u ? q.slot[3 * u] : FLT_MAX;
      int rank = 0;
      for (int r = 0; r < np; ++r) {
        const float vr = (pv >> r) & 1u ? q.slot[3 * r] : FLT_MAX;
        rank += (vr < vu || (vr == vu && r < u)) ? 1 : 0;
      }
      if (rank == target) q.slot[3 * np] = vu;
    }
    __syncwarp(q.mask);
    const float med = q.slot[3 * np];
    for (int u = 0; u < np; ++u)
      if (!(fabsf(q.slot[3 * u] - med) < 0.05f)) keep &= ~(1u << u);
  }
  float n = 0.f, sum[3] = {0.f, 0.f, 0.f};
  for (int u = 0; u < np; ++u) {
    const float w = (keep >> u) & 1u ? 1.f : 0.f;
    n += w;
#pragma unroll
    for (int k = 0; k < 3; ++k) sum[k] += q.slot[3 * u + k] * w;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) X[k] = sum[k] / fmaxf(n, 1.f);
  __syncwarp(q.mask);
  return n_valid;
}

// The prior, gate and fields 10-13 of decoded person p's joint j on the
// group ``q`` (the fields of camera c written by lane c mod G).
__device__ void prior_joint(const Args& g, const float* cam_s,
                            const float* delta_s, const float* sx,
                            const float* sy,
                            const float* sxn, const float* syn,
                            const unsigned char* sob, int p, int j,
                            const Group& q) {
  const int Cu = g.Cu, J = g.J;
  const int i0 = p * Cu * J + j;           // camera c's entry: i0 + c J
  unsigned inc = 0;
  for (int c = 0; c < Cu; ++c)
    if (sob[i0 + c * J]) inc |= 1u << c;
  const unsigned tob = j > 0 ? inc : 0u;   // joint 0 never contributes
  float X[3] = {0.f, 0.f, 0.f};
  bool ok;
  if (g.prior == 2) {
    // fewer than two views: not ok, whatever IRLS gives
    ok = __popc(tob) > 1;
    if (ok) irls(cam_s, delta_s, sxn + i0, syn + i0, J, tob, Cu, X);
  } else {
    ok = pair_prior(q, cam_s, sxn + i0, syn + i0, J, tob, Cu, g.prior == 1,
                    X) > 0;
  }
  if (!ok) X[0] = X[1] = X[2] = 0.f;
  if (g.gate_on && ok) {
    // masked lower median of the prior's reprojection residuals
    float d[MAX_CU];
#pragma unroll
    for (int c = 0; c < MAX_CU; ++c) {
      const float* cc = cam_s + 21 * (c < Cu ? c : 0);
      const float* Pm = cc + 9;
      float pc[3];
#pragma unroll
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
      const int i = i0 + (c < Cu ? c : 0) * J;
      const float du = fminf(fmaxf(sx[i] - pu, -1e5f), 1e5f);
      const float dv = fminf(fmaxf(sy[i] - pv, -1e5f), 1e5f);
      d[c] = sqrtf(du * du + dv * dv);
    }
    const int nv = __popc(inc);
    const int target = nv > 0 ? (nv + 1) / 2 - 1 : 0;
    const float resid = select_rank(d, inc, Cu, target, CUDART_INF_F);
    if (nv > 0 && resid > g.gate_px) ok = false;
  }
  const float okf = ok ? 1.f : 0.f;
  for (int c = q.l; c < Cu; c += q.G) {
    float* o = g.net + ((size_t)(p * Cu + c) * J + j) * 14;
    o[10] = okf;
    for (int k = 0; k < 3; ++k) o[11 + k] = X[k] * okf / 10.f;
  }
}

__global__ void __launch_bounds__(THREADS) frame_decode_pack_kernel(Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float cam_s[MAX_CU * 21], cw_s[MAX_CU * 12];
  __shared__ float xz_s[MAX_CU], yz_s[MAX_CU];   // undistorted (0, 0)
  __shared__ float delta_s[MAX_CU];              // IRLS Huber scales
  __shared__ int used_s[MAX_CU];
  __shared__ int n_elig_s;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int E = g.E, C = g.C, S = g.S, J = g.J, Cu = g.Cu, P = g.P;
  const int H = C * S;
  const Layout lay(E, H, P, C, Cu, J, S);
  int* cluster = reinterpret_cast<int*>(smem + lay.heads_off);
  unsigned* linked = reinterpret_cast<unsigned*>(cluster + H);
  unsigned* ccams = linked + H;
  int* root_ok = reinterpret_cast<int*>(ccams + H);
  int* rank = root_ok + H;
  int* persons_s = reinterpret_cast<int*>(smem + lay.persons_off);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(smem + lay.phase_off);
  unsigned* cand = reinterpret_cast<unsigned*>(keys + lay.n_pad);
  // the staged observations of every (used camera, slot, joint)
  const int csj = Cu * S * J;
  float* st_u = reinterpret_cast<float*>(smem + lay.stage_off);
  float* st_v = st_u + csj;
  float* st_val = st_v + csj;
  float* st_pr = st_val + csj;
  float* st_xn = st_pr + csj;
  float* st_yn = st_xn + csj;
  unsigned char* st_ob = reinterpret_cast<unsigned char*>(st_yn + csj);

  for (int i = tid; i < Cu * 21; i += THREADS) cam_s[i] = g.cams[i];
  for (int i = tid; i < Cu * 12; i += THREADS) cw_s[i] = g.cam_world[i];
  if (tid < Cu) used_s[tid] = g.used_pos[tid];
  for (int h = tid; h < H; h += THREADS) {
    cluster[h] = -1;
    linked[h] = 1u << (h / S);          // each head starts on its own camera
    ccams[h] = 0u;
  }
  if (tid == 0) n_elig_s = 0;
  __syncthreads();

  // ---- decode order: the eligible pairs' keys, sorted once ---------------
  for (int i = tid; i < E; i += THREADS) {
    const float s = g.scores[i];
    if (g.pmask[i] > 0.5f && s > g.threshold)
      keys[atomicAdd(&n_elig_s, 1)] = decode_key(s, i);
  }
  __syncthreads();
  const int n_elig = n_elig_s;
  const int n_live = n_elig < g.k_cap ? n_elig : g.k_cap;
  auto pack = [&](unsigned long long key) {
    const int* pr = g.pairs + 4 * (int)(key & 0xffffffffu);
    return unsigned(pr[0]) | unsigned(pr[1]) << 10 | unsigned(pr[2]) << 20
           | unsigned(pr[3]) << 25;
  };
  if (n_elig <= RANK_SORT) {
    // a key's place in the order is the count of smaller keys (all keys
    // differ: they hold the pair index); only the first n_live are trips
    for (int t = tid; t < n_elig; t += THREADS) {
      const unsigned long long kt = keys[t];
      int rank = 0;
      for (int j = 0; j < n_elig; ++j) rank += keys[j] < kt;
      if (rank < n_live) cand[rank] = pack(kt);
    }
  } else {
    int n_sort = 1;
    while (n_sort < n_elig) n_sort <<= 1;
    for (int i = n_elig + tid; i < n_sort; i += THREADS) keys[i] = ~0ull;
    __syncthreads();
    bitonic_sort(keys, n_sort);
    for (int t = tid; t < n_live; t += THREADS) cand[t] = pack(keys[t]);
  }
  __syncthreads();

  // ---- the walk: one warp, the candidates in order ----------------------
  if (warp == 0) {
    for (int t = 0; t < n_live; ++t) {
      const unsigned p = cand[t];
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
        if (merge) {
          for (int h = lane; h < H; h += 32)
            if (cluster[h] == kb || h == a || h == b) cluster[h] = root;
        }
        if (lane == 0) {
          if (!merge) cluster[a] = cluster[b] = root;
          // cameras the surviving root gains: a new pair both, an
          // extension the other endpoint's, a merge none (the quirk)
          ccams[root] |= (!ah && !bh) ? (bA | bB) : merge ? 0u
                                                          : (ah ? bB : bA);
          if (merge && kb != root) ccams[kb] = 0u;
          linked[a] |= bB;
          linked[b] |= bA;
        }
      }
      __syncwarp();
    }
  } else {
    // meanwhile: each camera's undistorted (0, 0) and IRLS scale, and,
    // where they fit, every slot's observations with their undistortion
    const int t = tid - 32;
    if (t < Cu) {
      undistort(cam_s + 21 * t, 0.f, 0.f, xz_s[t], yz_s[t]);
      delta_s[t] = 4.f / ((cam_s[21 * t] + cam_s[21 * t + 1]) * 0.5f);
    }
    if (lay.staged) {
      for (int i = t; i < csj; i += THREADS - 32) {
        const float u = g.kp[2 * i], v = g.kp[2 * i + 1];
        st_u[i] = u;
        st_v[i] = v;
        st_val[i] = g.valid[i];
        st_pr[i] = g.prob[i];
        st_ob[i] = g.observed[i];
        undistort(cam_s + 21 * (i / (S * J)), u, v, st_xn[i], st_yn[i]);
      }
    }
  }
  __syncthreads();

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
  const int n_persons = min(rank[H - 1] + 1, P);
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
  const int pcj = P * Cu * J, live = n_persons * Cu * J;
  float* sx = reinterpret_cast<float*>(smem + lay.phase_off);
  float* sy = sx + pcj;
  float* sxn = sy + pcj;
  float* syn = sxn + pcj;
  unsigned char* sob = reinterpret_cast<unsigned char*>(syn + pcj);
  const float hw = g.img_w / 2.f, hh = g.img_h / 2.f;
  for (int i = tid; i < live; i += THREADS) {
    const int j = i % J, cu = (i / J) % Cu, p = i / (J * Cu);
    const int mc = used_s[cu];
    const int slot = mc >= 0 ? persons_s[p * C + mc] : -1;
    float u = 0.f, v = 0.f, val = 0.f, pr = 0.f;
    bool ob = false;
    float xn = xz_s[cu], yn = yz_s[cu];
    if (slot >= 0) {
      const int src = (cu * S + slot) * J + j;
      if (lay.staged) {
        u = st_u[src];
        v = st_v[src];
        val = st_val[src];
        pr = st_pr[src];
        ob = st_ob[src] != 0;
        xn = st_xn[src];
        yn = st_yn[src];
      } else {
        u = g.kp[2 * src];
        v = g.kp[2 * src + 1];
        val = g.valid[src];
        pr = g.prob[src];
        ob = g.observed[src] != 0;
        undistort(cam_s + 21 * cu, u, v, xn, yn);
      }
    }
    g.gkp[2 * i] = u;
    g.gkp[2 * i + 1] = v;
    g.gval[i] = val;
    g.gobs[i] = ob;
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
  // rows past the persons: no slot, nothing observed, the prior not ok:
  // every output zero
  for (int i = live * 14 + tid; i < pcj * 14; i += THREADS) g.net[i] = 0.f;
  for (int i = 2 * live + tid; i < 2 * pcj; i += THREADS) g.gkp[i] = 0.f;
  for (int i = live + tid; i < pcj; i += THREADS) {
    g.gval[i] = 0.f;
    g.gobs[i] = 0;
  }
  __syncthreads();

  // ---- triangulated prior, gate, fields 10-13 ----------------------------
  // a group of lanes a decoded (person, joint): as many lanes (up to 8) as
  // keep every item in one round of the block
  const int n_items = n_persons * J;
  int G = 8;
  while (G > 1 && n_items * G > THREADS) G >>= 1;
  float* scratch = reinterpret_cast<float*>(smem + lay.scratch_off);
  for (int base = 0; base < n_items; base += THREADS / G) {
    const int item = base + tid / G;
    if (item >= n_items) continue;
    const Group q{lane % G, G, ((1u << G) - 1u) << (lane / G * G),
                  scratch + (tid / G) * lay.scratch_slot};
    prior_joint(g, cam_s, delta_s, sx, sy, sxn, syn, sob, item / J,
                item % J, q);
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
  const Layout lay(E, H, P, C, Cu, J, S);
  if (lay.total > 200 * 1024) return cudaErrorInvalidValue;
  // the kernel's dynamic shared memory limit, raised once per device to
  // the largest size asked for so far (not on every call)
  static std::atomic<int> allowed[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (lay.total > 48 * 1024 && lay.total > allowed[dev].load()) {
    err = cudaFuncSetAttribute(frame_decode_pack_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               lay.total);
    if (err != cudaSuccess) return err;
    allowed[dev].store(lay.total);
  }
  Args g{scores, pmask, pairs, used_pos, kp, valid, prob, observed, cams,
         cam_world, E, C, S, J, Cu, P, threshold, min_views, k_cap, prior,
         gate_on, gate_px, img_w, img_h, persons, person_mask, net, gkp,
         gval, gobs};
  frame_decode_pack_kernel<<<1, THREADS, lay.total, stream>>>(g);
  return cudaGetLastError();
}
