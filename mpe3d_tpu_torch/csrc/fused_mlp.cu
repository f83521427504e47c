// A run of consecutive lifter layers for Hopper, in ONE persistent launch:
// for each layer, y = act(bf16(x) W + b) with bf16 weights W, or
// y = act((bf16(x * rscale) Wq) * scale + b) with int8 weights Wq, fp32
// sums, for at most 256 rows.  A bf16 lifter is one run (9 layers, 1
// launch a frame, or a batch chunk's rows in one launch, in groups of 256
// past that), and so is an int8 one (8 int8 layers and its bf16 head).
//
// Replaces the TPU kernel mpe3d_tpu/ops/fused_mlp.py::_fused_mlp_call
// (:57, pallas_call at :143; entry fused_mlp_forward :223, packing
// pack_fused_layers :154), both of its layer kinds (bf16 'w', int8 'q':
// :80-83, :93, :126), which also runs the whole network in one launch with
// the weights streamed in double-buffered K-tiles; and, as a run of one
// int8 layer, mpe3d_tpu/ops/quant_matmul.py::_pallas_int8_matmul (:73,
// pallas_call :94), which holds all M rows in one block and streams each
// weight tile once: so does a launch here, for its up to 256 rows.
// Python side, tile plan and plain PyTorch version:
// mpe3d_tpu_torch/ops/fused_mlp.py (and ops/quant_matmul.py).
//
// Numerics follow the TPU kernel (fused_mlp.py:93, 114-117, 126):
// activations are rounded to bf16 (round to nearest even) as operands, an
// int8 layer's first multiplied by its row scales in fp32; int8 -> bf16 is
// exact for |q| <= 127; bf16 x bf16 products are exact and summed in fp32
// (mma.sync.m16n8k16 bf16 -> fp32); then acc * scale (int8), + b and
// LeakyReLU as separately rounded fp32 operations.  Between layers only
// the bf16 operand of the next layer is kept, rounded once, by the block
// that produces it: bf16(act), or bf16(act * rscale_next) where the next
// layer is int8 (its row scale folded by the producer: the same bits as
// the plain version's fold, then bf16).
//
// Bound on an H100 SXM: the serving lifter (1260->3072->3072->2048->2048->
// 1024x4->54) streams 58.3 MB of bf16 weights per frame (29.1 MB of int8
// and a 0.1 MB bf16 head for an int8 lifter) for 8 rows of activations --
// 17.4 us (8.7 us) at 3.35 TB/s, against 0.47 GFLOP (0.5 us of the bf16
// tensor-core peak).  Weight streaming is everything, and it must not stop
// at layer boundaries: no weight depends on an activation.
//
// Design:
// * The plan (ops/fused_mlp.py::plan_run) cuts every layer into tiles of
//   64 output columns (a slab) x a K-chunk of whole 16-row k-blocks, and
//   gives each of the grid's blocks (one an SM, co-resident: cooperative
//   launch) a contiguous range of each layer's tiles, chunk-major, so a
//   block's tiles in a layer mostly share one activation chunk.  Layers with
//   fewer slabs than blocks split K (the plan's split count balances the
//   weight bytes per block: an int8 row costs half a bf16 one; past 32 rows
//   every layer with K > 512 is split).  The tile
//   list comes from the device table the wrapper builds once per packed run
//   and row count.
// * Weights stream through a ring of 16 KB stages (10 up to 16 rows, 8
//   past them), issued by all threads a ring less one stage ahead of the
//   one they consume, walking the block's tile list across layer
//   boundaries, so while a block waits for the previous layer's
//   activations up to 144 KB (112 KB) of its next weights (about a whole
//   layer's share) are already in flight.  A bf16 stage is 128 rows
//   x 64 columns (16-byte cp.async, rows XOR-swizzled for conflict-free
//   ldmatrix.trans).  An int8 stage holds 256 rows x 64 columns, the same
//   16 KB: int8 rows are half as wide, and keeping the stage's bytes keeps
//   the ring's depth in bytes and halves the stages (barriers) a tile
//   takes, where 128-row 8 KB stages would halve the bytes in flight.
//   The packing stores int8 weights slab by slab, each 16-row k-block's
//   1024 bytes in the order of the m16n8k16 A fragments (ops/fused_mlp.py::
//   int8_fragments): a stage is one contiguous 16 KB copy, and each lane
//   reads the bytes of its fragments for two m-tiles with one 16-byte
//   shared load, conflict-free (sm_90 has no ldmatrix for bytes).  A byte
//   becomes bf16 in registers: biased by 128 into the low mantissa byte of
//   2^23, minus 2^23 + 128, is the exact fp32 value, whose high 16 bits are
//   the exact bf16 (two packed by one byte permute).
// * Compute: the transposed product y^T = W^T x^T, so the weights are the
//   m16 operand and the <=64 activation rows the n8 operand (NT = 1, 2, 4
//   or 8 n8 tiles, straight 32-bit loads from the staged chunk), every
//   loaded weight fragment applied to all of them.  The 8 warps are KG
//   groups along a stage's rows times MG groups along its 4 m16 tiles
//   (64 columns): up to 16 rows (NT <= 2) all 8 split the rows (16 a warp
//   for bf16, 32 for int8) and hold all 4 m-tiles; at 32 rows 4 x 2, at 64
//   rows 2 x 4, so a thread keeps 32 accumulators (MT m-tiles x NT n8
//   tiles x 4) at every row count; the KG warps' sums of a tile are added
//   in a fixed tree order.
// * Rows and shared memory (the row class of a launch, Rows<NT>): the
//   staged chunk holds NT x 8 rows of up to KC k-rows, so past 16 rows the
//   ring has 8 stages (128 KB), and past 32 rows KC is 512: every class
//   stays within the 227 KB a block may have (ops/fused_mlp.py::
//   run_smem_bytes mirrors the sizes for the plan).
// * Split-K: a split tile stores its fp32 partial [M x 64] in scratch.  When
//   a block leaves a layer it counts its split tiles in per-slab counters
//   (integer atomics); the block that completes a slab loads the slab's
//   partials into shared memory at once (one round trip; up to 16 rows the
//   plan keeps them within 32 KB, past that they go in passes of as many
//   outputs as the staged chunk's space holds), sums them in chunk order,
//   applies the epilogue and
//   writes the bf16 operand of the next layer (fp32 output for the run's
//   last layer): the same bits from run to run.  Then it arrives at the
//   layer's grid barrier; a block waits on that barrier only when it starts
//   a tile of the next layer.  Barrier and slab counters are words of the
//   caller's workspace, zeroed on the stream before the launch: no device
//   globals, so two calls on two streams do not collide.  Each block loads
//   its tile records and the layer table into shared memory once, so no
//   loop waits on a global load to find its next tile.
// * What bounds it on the card: not the stream but the chain at each layer
//   boundary (partials, counters, barrier, activations: several dependent
//   L2 round trips), a few microseconds a layer (PERF.md, findings).
//
// The wide row classes (65-128 rows, 129-256 rows: a batch chunk's rows,
// 250 at S=4, 252 in ARPLAB, 96 at S=16, in ONE launch; the narrow classes
// above are unchanged).  Bound for the serving lifter at 250 rows: its
// weights once, 17.4 us of bytes, against 14.7 us of bf16 tensor math
// (3.7 GFLOP).  Four 64-row launches stream the weights 4 times and pay
// the chain 4 times (0.69 ms of device time at 250 rows on an H100); one
// wide launch takes 0.16 ms (PERF.md, the kernel table).  Design:
// * wgmma (m64n64k16, fp32 sums) on the transposed product: the slab's
//   64 columns are the M operand, from registers (warp w of a warpgroup
//   holds m16 tile w as an mma.sync A fragment: ldmatrix.trans of the ring
//   rows, or int8 bytes made bf16 as above); the activation rows are the
//   N operand, from shared memory in the 128-byte swizzled K-major layout
//   (8-row atoms of 64 k-values, 1024 bytes; descriptor: SBO 1024 bytes,
//   the k16 step's 32-byte offset in its atom row).  The two warpgroups
//   take pieces of 64 rows in turn (one each up to 128 rows, two past),
//   so no warp sums meet.  A piece's 8 k16 steps of a stage go into zeroed
//   registers, as one committed and waited group, then are added to its
//   fp32 sums: no tensor-core sum runs past 128 k-rows (one set over a
//   whole chunk drifted 2-5 times further from the plain layers).
// * Chunks are whole ring stages (128 bf16, 256 int8 rows) and the rows
//   past M are zero, so no wgmma sits in a divergent path.  A bf16
//   stage's activations (128 k-rows of 128 or 256 rows, 32 or 64 KB) are
//   copied by cp.async into one of two windows while the stage before
//   computes on the other (a group of the ring's FIFO: waiting for it
//   waits for the ring's older stages too); an int8 stage's 256 rows are
//   copied, with the ring drained, in a window of up to 512 (128 rows) or
//   256 (256 rows) k-rows.
// * The run's x is made the first layer's bf16 operand once, by all
//   blocks (a prologue and its barrier), so every layer reads bf16 rows.
// * Split-K: tiles store fp32 partials [M x 64] as above; a split layer
//   then has every block sum a near-equal share of its outputs in chunk
//   order (a barrier when all partials are written, then one when the
//   outputs are), where one block a slab would read 4 x 64 KB at 256 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;              // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int SLAB = 64;                  // output columns of a tile
constexpr int SROWS = 128;                // bf16 weight rows of a stage
constexpr int SROWS8 = 256;               // int8 weight rows of a stage
constexpr int FRAG = 16 * SLAB;           // bytes of an int8 k-block
constexpr int MAX_LAYER_TILES = 64;       // tiles of one layer a block owns
constexpr int MAX_BLOCK_TILES = 96;       // tiles a block owns in a run
constexpr int MAX_RUN_LAYERS = 16;        // layers of a run
constexpr int LAYER_FIELDS = 12;          // int64 words of a layer record
constexpr int NACC_MAX = 32;              // accumulators a thread
// the warp sums' exchange: at most 4 warps write NACC_MAX floats a lane
constexpr size_t RED_BYTES = (size_t)(WARPS / 2) * NACC_MAX * 32 * 4;

// The row class of a launch, NT n8 tiles of activation rows (M <= 8 NT):
// warps as KG groups along the rows of a stage times MG groups along its
// four m16 tiles (MT a warp); the ring's 16 KB stages and the staged
// chunk's k-rows (KC, stride XS_LD: 8 mod 64, so the n8 loads are
// conflict-free).
template <int NT>
struct Rows {
  static constexpr int MG = NT >= 4 ? NT / 2 : 1;
  static constexpr int KG = WARPS / MG;
  static constexpr int MT = 4 / MG;
  static constexpr int NACC = MT * NT * 4;
  static constexpr int STAGES = NT <= 2 ? 10 : 8;
  static constexpr int KC = NT <= 4 ? 1024 : 512;
  static constexpr int XS_LD = KC + 8;
  static constexpr int XS_ROWS = NT < 2 ? 16 : NT * 8;
  // loads in flight a thread: of the staged chunk, and float4 loads of
  // the slab partials (up to 16 rows 64 bytes, as 16 floats before)
  static constexpr int X_BATCH = NT <= 4 ? 8 : 16;
  static constexpr int R_BATCH4 = NT <= 2 ? 4 : 16;
  static constexpr size_t RING = (size_t)STAGES * SROWS * SLAB * 2;
  static constexpr size_t XS = (size_t)XS_ROWS * XS_LD * 2;
  static constexpr size_t SMEM = RING + XS + RED_BYTES;
  // floats of slab partials one pass of the reduction holds
  static constexpr int PART_CAP = (int)(XS / 4);
  static_assert(NACC <= NACC_MAX, "accumulators");
  static_assert(SMEM + 6 * 1024 <= 227 * 1024, "shared memory");
};

// The wide row classes, 65 to 128 rows (NT = 16) and 129 to 256 rows
// (NT = 32): wgmma.  The two warpgroups split the rows in pieces of 64
// (NP a warpgroup: rows (2 j + wg) 64 for j < NP), each warp of a group
// one m16 tile of the slab, so no warp sums meet.  XS holds the staged
// activations of MP rows in wgmma's 128-byte swizzled K-major layout: two
// windows of a bf16 stage's 128 k-rows, or one of KCW k-rows for int8
// stages; 5 ring stages.
constexpr int PIECE = 64;                 // rows of one wgmma (n64)
constexpr int WIDE_ROWS = 256;
template <int NP>
struct WideRows {
  static constexpr int MP = 2 * NP * PIECE;
  static constexpr int STAGES = 5;
  static constexpr size_t RING = (size_t)STAGES * SROWS * SLAB * 2;
  static constexpr size_t XS = 128 * 1024;
  static constexpr int KCW = (int)(XS / ((size_t)MP * 128)) * 64;
  // + up to 1 KB to align the window to the swizzle's 1024-byte atoms
  static constexpr size_t SMEM = RING + XS + 1024;
  static_assert(SMEM + 6 * 1024 <= 227 * 1024, "shared memory");
};
template <>
struct Rows<16> : WideRows<1> {};
template <>
struct Rows<32> : WideRows<2> {};

struct Layer {
  const void* w;            // bf16 [K, N] row-major, or int8 fragments
                            // [ceil(N / 64)][ceil(K / 16)][1024]
  const float* b;           // [N]
  int K, N, act, int8;
  long long in_off;         // bf16 elements into acts; -1: the run's x
  long long out_off;        // bf16 elements into acts; -1: the run's y
  const float* scale;       // int8: [N] column scales
  const float* rs_in;       // int8: [K] row scales, folded into the run's x
  const float* rs_next;     // the next layer's row scales [N], or null
};

struct Tile {
  int layer, n0, r0, r1;    // columns [n0, n0 + 64), rows [r0, r1)
  int part;                 // float offset of its partial; -1: not split
  int cnt;                  // sync word of its slab
  int nsplit;               // K-chunks of its slab
  int pbase;                // float offset of its slab's first partial
};

// record: w, b, K, N, act, in_off, out_off, int8, scale, rs_in, rs_next, 0
// (a kernel built without the int8 kind reads the first seven)
template <bool INT8>
__device__ __forceinline__ Layer load_layer(const long long* t, int l) {
  const long long* p = t + LAYER_FIELDS * l;
  if (!INT8)
    return {reinterpret_cast<const void*>(p[0]),
            reinterpret_cast<const float*>(p[1]), (int)p[2], (int)p[3],
            (int)p[4], 0, p[5], p[6], nullptr, nullptr, nullptr};
  return {reinterpret_cast<const void*>(p[0]),
          reinterpret_cast<const float*>(p[1]), (int)p[2], (int)p[3],
          (int)p[4], (int)p[7], p[5], p[6],
          reinterpret_cast<const float*>(p[8]),
          reinterpret_cast<const float*>(p[9]),
          reinterpret_cast<const float*>(p[10])};
}

__device__ __forceinline__ Tile load_tile(const int* t, int i) {
  const int4 a = *reinterpret_cast<const int4*>(t + 8 * i);
  const int4 b = *(reinterpret_cast<const int4*>(t + 8 * i) + 1);
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// physical byte offset of 16-byte chunk c (0..7) of ring row ``row``
__device__ __forceinline__ uint32_t ring_off(int row, int c) {
  return (uint32_t)(row * SLAB + ((c ^ (row & 7)) << 3)) * 2;
}

// copies of the weight rows [r, r + a stage's rows) of tile t, at most to
// t.r1, into a stage.  bf16: rows past K and columns past N are
// zero-filled.  int8: whole k-blocks of the tile's slab, one contiguous
// piece of the fragment layout (padded with zeros to whole k-blocks and
// slabs at packing).
template <bool INT8>
__device__ __forceinline__ void issue_stage(uint32_t slot, const Layer& L,
                                            const Tile& t, int r) {
  if (INT8 && L.int8) {
    const int rows = min(SROWS8, t.r1 - r);
    const char* src = static_cast<const char*>(L.w) +
                      ((size_t)(t.n0 / SLAB) * ((L.K + 15) / 16) + r / 16) *
                          FRAG;
    for (int i = threadIdx.x; i < rows * 4; i += THREADS)
      cp_async16(slot + i * 16, src + (size_t)i * 16, 16);
    return;
  }
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(L.w);
  const int rows = min(SROWS, t.r1 - r);
  for (int i = threadIdx.x; i < rows * 8; i += THREADS) {
    const int row = i >> 3, c = i & 7;
    const int k = r + row, n = t.n0 + c * 8;
    const bool ok = k < L.K && n < L.N;
    cp_async16(slot + ring_off(row, c),
               ok ? static_cast<const void*>(w + (size_t)k * L.N + n)
                  : static_cast<const void*>(w),
               ok ? 16 : 0);
  }
}

// 4 int8 weights (bytes of v) -> two bf16x2 registers {b0, b1}, {b2, b3}:
// each byte, biased by 128 into 0..255, becomes the low mantissa byte of
// 2^23 (0x4B000000), so float(bits) - (2^23 + 128) is the signed value,
// exactly; its high 16 bits are then the exact bf16.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t v, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = v ^ 0x80808080u;
  const float f0 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u)) - 8388736.f;
  const float f1 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541u)) - 8388736.f;
  const float f2 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542u)) - 8388736.f;
  const float f3 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543u)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632u);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632u);
}

// the n8 operand (activation rows nt*8 + g, k = xk + 2t, +1 and +8, +9)
template <int LD>
__device__ __forceinline__ void load_b(const __nv_bfloat16* xs, int nt,
                                       int xk, uint32_t& b0, uint32_t& b1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = xs + (nt * 8 + g) * LD + xk + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an int8 stage: warp (kg, mg) takes the 16 / KG k-blocks from kg * 16 / KG
// of its ``rows`` rows and the m-tiles mg * MT, ...; lane l's 16 bytes at
// p * 512 + 16 l of a k-block are its A fragments of m-tiles 2p and 2p + 1
// (4 registers of 2 bytes each), of which a warp of one m-tile loads 8
template <int NT>
__device__ __forceinline__ void mma_stage_int8(
    uint32_t slot, const __nv_bfloat16* xs, int xk0, int rows,
    float (&acc)[Rows<NT>::MT][NT][4]) {
  using R = Rows<NT>;
  constexpr int MT = R::MT, KB = SROWS8 / 16 / R::KG;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kg = warp / R::MG, mg = warp % R::MG;
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
    const int kb = kg * KB + kk;
    if (kb * 16 >= rows) return;
    uint32_t a[MT][4];
    if constexpr (MT >= 2) {
#pragma unroll
      for (int p = 0; p < (MT + 1) / 2; ++p) {
        uint32_t q[4];
        asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(q[0]), "=r"(q[1]), "=r"(q[2]), "=r"(q[3])
                     : "r"(slot + kb * FRAG + (mg * MT / 2 + p) * 512 +
                           lane * 16));
#pragma unroll
        for (int ml = 0; ml < 2; ++ml) {
          const int mt = (2 * p + ml) % MT;
          int8x4_to_bf16(q[2 * ml], a[mt][0], a[mt][1]);
          int8x4_to_bf16(q[2 * ml + 1], a[mt][2], a[mt][3]);
        }
      }
    } else {
      uint32_t q[2];
      asm volatile("ld.shared.v2.u32 {%0,%1}, [%2];\n"
                   : "=r"(q[0]), "=r"(q[1])
                   : "r"(slot + kb * FRAG + (mg >> 1) * 512 + lane * 16 +
                         (mg & 1) * 8));
      int8x4_to_bf16(q[0], a[0][0], a[0][1]);
      int8x4_to_bf16(q[1], a[0][2], a[0][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b0, b1;
      load_b<R::XS_LD>(xs, nt, xk0 + kb * 16, b0, b1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma16816(acc[mt][nt], a[mt], b0, b1);
    }
  }
}

// a bf16 stage: warp (kg, mg) takes the 8 / KG 16-row slices from
// kg * 8 / KG of its ``rows`` rows and the m-tiles mg * MT, ...
template <int NT>
__device__ __forceinline__ void mma_stage(uint32_t slot,
                                          const __nv_bfloat16* xs, int xk0,
                                          int rows,
                                          float (&acc)[Rows<NT>::MT][NT][4]) {
  using R = Rows<NT>;
  constexpr int MT = R::MT, KS = SROWS / 16 / R::KG;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kg = warp / R::MG, mg = warp % R::MG;
  const int j = lane >> 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int kr = (kg * KS + ks) * 16;
    if (kr >= rows) return;
    // A = W^T: matrices (cols 0-7 | 8-15) x (k 0-7 | 8-15) of each m16 tile
    const int row = kr + (lane & 7) + ((j >> 1) << 3);
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t addr =
          slot + ring_off(row, (mg * MT + mt) * 2 + (j & 1));
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
          "[%4];\n"
          : "=r"(a[mt][0]), "=r"(a[mt][1]), "=r"(a[mt][2]), "=r"(a[mt][3])
          : "r"(addr));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* p =
          xs + (nt * 8 + g) * R::XS_LD + xk0 + kr + 2 * t;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[mt][nt][0]), "+f"(acc[mt][nt][1]),
              "+f"(acc[mt][nt][2]), "+f"(acc[mt][nt][3])
            : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]),
              "r"(b0), "r"(b1));
    }
  }
}

// rows [r0, r1) of the layer input, rows m < 8 NT of them (zero past M and
// past K), as bf16 into xs; the run's x is fp32, multiplied by the row
// scales of an int8 layer and rounded here, later layers' inputs are
// already the bf16 operands
template <int NT, bool INT8>
__device__ void stage_x(__nv_bfloat16* xs, const float* __restrict__ x,
                        const __nv_bfloat16* acts, const Layer& L, int M,
                        int r0, int r1) {
  constexpr int XS_LD = Rows<NT>::XS_LD, X_BATCH = Rows<NT>::X_BATCH;
  const int kc = r1 - r0;
  if (L.in_off < 0) {
    const int total = NT * 8 * kc;
    for (int base = 0; base < total; base += THREADS * X_BATCH) {
      float v[X_BATCH];
#pragma unroll
      for (int q = 0; q < X_BATCH; ++q) {
        const int i = base + q * THREADS + threadIdx.x;
        const int m = i / kc, k = r0 + i % kc;
        const bool in = i < total && m < M && k < L.K;
        v[q] = in ? x[(size_t)m * L.K + k] : 0.f;
        if (INT8 && L.int8 && in) v[q] = __fmul_rn(v[q], L.rs_in[k]);
      }
#pragma unroll
      for (int q = 0; q < X_BATCH; ++q) {
        const int i = base + q * THREADS + threadIdx.x;
        if (i < total)
          xs[(i / kc) * XS_LD + i % kc] = __float2bfloat16_rn(v[q]);
      }
    }
  } else {   // K and the offsets are multiples of 16: 16-byte pieces
    const int per_row = kc / 8, total = NT * 8 * per_row;
    const __nv_bfloat16* in = acts + L.in_off;
    for (int base = 0; base < total; base += THREADS * X_BATCH) {
      uint4 v[X_BATCH];
#pragma unroll
      for (int q = 0; q < X_BATCH; ++q) {
        const int i = base + q * THREADS + threadIdx.x;
        const int m = i / per_row, k = r0 + (i % per_row) * 8;
        v[q] = (i < total && m < M && k < L.K)
                   ? __ldcg(reinterpret_cast<const uint4*>(
                         in + (size_t)m * L.K + k))
                   : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int q = 0; q < X_BATCH; ++q) {
        const int i = base + q * THREADS + threadIdx.x;
        if (i < total)
          *reinterpret_cast<uint4*>(xs + (i / per_row) * XS_LD +
                                    (i % per_row) * 8) = v[q];
      }
    }
  }
}

// ---- the wide class: wgmma -------------------------------------------

// the shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address, leading offset 16 bytes (unused: 16 k-values
// lie in one 128-byte row), 1024 bytes from one 8-row atom to the next
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D[64 columns x 64 rows] += A (this warp's m16 tile of the slab in the
// registers of an m16n8k16 A fragment) x B (64 activation rows x k16 at
// ``desc``), fp32 sums
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      "{%32, %33, %34, %35},"
      " %36,"
      " p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// the registers a wgmma reads or writes, ordered against the code around
// (the compiler does not know the instruction is asynchronous)
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// cp.async copies of rows [r, r + 128) of the layer input (bf16 rows of
// (K + 15) & ~15 elements: the run's x as the prologue left it, or the
// outputs of the layer before; zero past M and past K) into ``dst``, the
// B operand of wgmma_n64: MP rows in 8-row atoms of 64 k-values a 128-byte
// row, 16-byte chunks swizzled by the row (chunk c of row m at c ^ (m &
// 7)), two columns of 64 k; 16-byte pieces, a row's 256 bytes from 16
// neighbouring threads
template <int MP>
__device__ __forceinline__ void issue_window(uint32_t dst,
                                             const __nv_bfloat16* in, int K,
                                             int M, int r) {
  const int ld = (K + 15) & ~15;
  for (int i = threadIdx.x; i < MP * 16; i += THREADS) {
    const int m = i >> 4, c8 = i & 15, k = r + c8 * 8;
    const bool ok = m < M && k < K;
    cp_async16(dst + (c8 >> 3) * MP * 128 + (m >> 3) * 1024 + (m & 7) * 128 +
                   (((c8 & 7) ^ (m & 7)) << 4),
               ok ? static_cast<const void*>(in + (size_t)m * ld + k)
                  : static_cast<const void*>(in),
               ok ? 16 : 0);
  }
}

// a stage on the wide class (whole: the plan's chunks are whole stages):
// warp w of warpgroup wg loads the A fragments of m16 tile w (ldmatrix.
// trans of the bf16 ring rows, or an int8 stage's bytes made bf16 in
// registers) for 8 k16 steps at a time; then, piece by piece, issues their
// 8 wgmma into zeroed registers, waits, and adds those to the piece's
// sums in fp32.  So no tensor-core sum runs past 8 steps (128 k-rows), as
// in the narrow classes, whose warps split a stage's rows: one register
// set over a whole chunk (40-48 steps) rounded 2-5 times further from the
// plain layer on the trained lifter.  The ring slot and the registers are
// free when it returns
template <int NP, bool INT8>
__device__ __forceinline__ void mma_stage_wide(uint32_t slot, uint32_t xs,
                                               int xk0, bool q8,
                                               float (&acc)[NP][32]) {
  constexpr int MP = WideRows<NP>::MP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp & 3, wg = warp >> 2, j4 = lane >> 3;
  const int steps = INT8 && q8 ? SROWS8 / 16 : SROWS / 16;
  for (int h = 0; h < steps; h += 8) {
    uint32_t a[8][4];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      if (INT8 && q8) {
        uint32_t q[2];
        asm volatile("ld.shared.v2.u32 {%0,%1}, [%2];\n"
                     : "=r"(q[0]), "=r"(q[1])
                     : "r"(slot + (h + ks) * FRAG + (w >> 1) * 512 +
                           lane * 16 + (w & 1) * 8));
        int8x4_to_bf16(q[0], a[ks][0], a[ks][1]);
        int8x4_to_bf16(q[1], a[ks][2], a[ks][3]);
      } else {
        const int row = ks * 16 + (lane & 7) + ((j4 >> 1) << 3);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
            "[%4];\n"
            : "=r"(a[ks][0]), "=r"(a[ks][1]), "=r"(a[ks][2]), "=r"(a[ks][3])
            : "r"(slot + ring_off(row, w * 2 + (j4 & 1))));
      }
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      float d[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] = 0.f;
      fence_regs(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const int xk = xk0 + (h + ks) * 16;
        // the step's 16 k-values in their column of the window, then the
        // piece's first 8-row atom
        const uint32_t col = xs + (uint32_t)((xk >> 6) * MP * 128 +
                                             (xk & 63) * 2);
        wgmma_n64(d, a[ks],
                  sw128_desc(col + (uint32_t)(2 * j + wg) * PIECE * 128));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(d);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] += d[i];
    }
  }
}

// float4 k4 < total4 of one pass of a slab's partials into buf: the
// pass's outputs [e0, e0 + cnt) of each of its chunks (chunk p's at
// src + p * per), ``B`` float4 loads in flight a thread; WHOLE: the pass
// is the whole slab (cnt == per), so the source is contiguous
template <int B, bool WHOLE>
__device__ __forceinline__ void load_partials(float4* buf, const float* src,
                                              int total4, int per, int e0,
                                              int cnt) {
  for (int base = 0; base < total4; base += THREADS * B) {
    float4 v[B];
#pragma unroll
    for (int q = 0; q < B; ++q) {
      const int k4 = base + q * THREADS + threadIdx.x, k = 4 * k4;
      const int off = WHOLE ? k : (k / cnt) * per + e0 + k % cnt;
      v[q] = k4 < total4 ? __ldcg(reinterpret_cast<const float4*>(src + off))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < B; ++q) {
      const int k4 = base + q * THREADS + threadIdx.x;
      if (k4 < total4) buf[k4] = v[q];
    }
  }
}

// the epilogue of one output: (* scale), + b, LeakyReLU, each rounded on
// its own (the scale's product by __fmul_rn, so that it is not contracted
// with the bias); fp32 into y for the run's last layer, else the bf16
// operand of the next layer (times its row scale when it is int8).  The
// bf16 kind's expressions (and its stage product) are written as they were
// before the int8 kind joined: the __fadd_rn / __fmul_rn forms of the same
// operations and a shared stage helper measured slower on an H100
template <bool INT8>
__device__ __forceinline__ void store_out(const Layer& L, float* y,
                                          __nv_bfloat16* acts, int m,
                                          int col, float v, float slope) {
  if (INT8 && L.int8) v = __fmul_rn(v, L.scale[col]);
  v += L.b[col];
  if (L.act) v = v >= 0.f ? v : slope * v;
  if (L.out_off < 0) {
    y[(size_t)m * L.N + col] = v;
  } else {
    if (INT8 && L.rs_next != nullptr) v = __fmul_rn(v, L.rs_next[col]);
    acts[L.out_off + (size_t)m * L.N + col] = __float2bfloat16_rn(v);
  }
}

// the wide classes' reduction of a split layer: once every block has
// written its partials, block b sums the b-th of gridDim.x near-equal
// shares of the layer's outputs (slab by slab, row by row), each over its
// ``splits`` chunks in chunk order (the partial of slab j, chunk p at
// parts + (j splits + p) M 64), and applies the epilogue
template <bool INT8>
__device__ void reduce_share(const Layer& L, const float* parts, int splits,
                             float* y, __nv_bfloat16* acts, int M,
                             float slope) {
  constexpr int B = 8;
  const int per = M * SLAB;
  const int total4 = (L.N + SLAB - 1) / SLAB * per / 4;
  const int b0 = (int)((long long)blockIdx.x * total4 / gridDim.x);
  const int b1 = (int)((long long)(blockIdx.x + 1) * total4 / gridDim.x);
  for (int g0 = b0; g0 < b1; g0 += THREADS * B) {
    float4 s[B];
    const float* src[B];
#pragma unroll
    for (int q = 0; q < B; ++q) {
      const int g = g0 + q * THREADS + threadIdx.x, e = 4 * g;
      src[q] = parts + (size_t)(e / per) * splits * per + e % per;
      s[q] = g < b1 ? __ldcg(reinterpret_cast<const float4*>(src[q]))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int p = 1; p < splits; ++p)
#pragma unroll
      for (int q = 0; q < B; ++q)
        if (g0 + q * THREADS + threadIdx.x < b1) {
          const float4 v = __ldcg(
              reinterpret_cast<const float4*>(src[q] + (size_t)p * per));
          s[q].x += v.x;
          s[q].y += v.y;
          s[q].z += v.z;
          s[q].w += v.w;
        }
#pragma unroll
    for (int q = 0; q < B; ++q) {
      const int g = g0 + q * THREADS + threadIdx.x, e = 4 * g;
      if (g >= b1) continue;
      const int r = e % per, m = r / SLAB, c = e / per * SLAB + r % SLAB;
      const float v[4] = {s[q].x, s[q].y, s[q].z, s[q].w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i < L.N) store_out<INT8>(L, y, acts, m, c + i, v[i], slope);
    }
  }
}

// INT8: the run has int8 layers (a bf16-only run takes the instance built
// without the int8 kind, whose code is the bf16 kind's alone)
template <int NT, bool INT8>
__global__ void __launch_bounds__(THREADS, 1)
mlp_run_kernel(const float* __restrict__ x, float* __restrict__ y,
               const long long* __restrict__ layers,
               const int* __restrict__ tiles,
               const int* __restrict__ block_tiles, __nv_bfloat16* acts,
               float* parts, int* sync, int M, int n_layers, float slope) {
  using R = Rows<NT>;
  constexpr bool WIDE = NT >= 16;
  constexpr int STAGES = R::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);
  // the staged activations follow the ring (the wide class's window from
  // the next 1024-byte boundary, the swizzle's atom)
  unsigned char* xsb = smem + R::RING;
  if constexpr (WIDE)
    xsb += ((ring + (uint32_t)R::RING + 1023u) & ~1023u) -
           (ring + (uint32_t)R::RING);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(xsb);
  // the block's tile records and the layer table, loaded once: the loops
  // below then never wait on a global load to find their next tile
  __shared__ __align__(16) int tile_tab[MAX_BLOCK_TILES * 8];
  __shared__ long long layer_tab[MAX_RUN_LAYERS * LAYER_FIELDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = block_tiles[blockIdx.x];
  const int n_tiles = block_tiles[blockIdx.x + 1] - t0;
  for (int i = threadIdx.x; i < n_tiles * 8; i += THREADS)
    tile_tab[i] = tiles[8 * t0 + i];
  for (int i = threadIdx.x; i < n_layers * LAYER_FIELDS; i += THREADS)
    layer_tab[i] = layers[i];
  __syncthreads();
  // tile indices below are the block's own, 0..n_tiles
  const int t_beg = 0, t_end = n_tiles;

  // issue cursor: tile it, next row ir
  int it = t_beg, ir = 0;
  Tile itile;
  Layer ilayer;
  if (it < t_end) {
    itile = load_tile(tile_tab, it);
    ilayer = load_layer<INT8>(layer_tab, itile.layer);
    ir = itile.r0;
  }
  int islot = 0;
  auto issue_next = [&]() {
    if (it < t_end) {
      issue_stage<INT8>(ring + islot * (SROWS * SLAB * 2), ilayer, itile, ir);
      ir += INT8 && ilayer.int8 ? SROWS8 : SROWS;
      if (ir >= itile.r1 && ++it < t_end) {
        itile = load_tile(tile_tab, it);
        ilayer = load_layer<INT8>(layer_tab, itile.layer);
        ir = itile.r0;
      }
    }
    cp_async_commit();
    islot = islot + 1 == STAGES ? 0 : islot + 1;
  };
  for (int s = 0; s < STAGES - 1; ++s) issue_next();

  if constexpr (WIDE) {
    constexpr int NP = NT / 16, MP = R::MP, KCW = R::KCW;
    const int wg = warp >> 2, w = warp & 3;
    const uint32_t xs_s = smem_u32(xsb);
    // prologue: the run's x as the first layer's bf16 operand (times its
    // row scales where it is int8), rows of (K0 + 15) & ~15 zero-padded
    // elements at its input offset; every block converts a share, then
    // arrives at the prologue's barrier (word 2 L)
    {
      const Layer L0 = load_layer<INT8>(layer_tab, 0);
      const int ld = (L0.K + 15) & ~15, total = M * ld / 2;
      __nv_bfloat162* x16 =
          reinterpret_cast<__nv_bfloat162*>(acts + L0.in_off);
      for (int i = blockIdx.x * THREADS + threadIdx.x; i < total;
           i += gridDim.x * THREADS) {
        const int m = 2 * i / ld, k = 2 * i % ld;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = k + e < L0.K ? x[(size_t)m * L0.K + k + e] : 0.f;
          if (INT8 && L0.int8 && k + e < L0.K)
            v[e] = __fmul_rn(v[e], L0.rs_in[k + e]);
        }
        x16[i] = __floats2bfloat162_rn(v[0], v[1]);
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) atomicAdd(&sync[2 * n_layers], 1);
    }
    // bf16 stages: two windows of a stage's 128 rows, WIN bytes each (the
    // current one wbuf; wnext: the first row of the next stage's, copying,
    // or -1); int8 stages: a window of rows [x_lo, x_hi) of layer x_layer
    constexpr uint32_t WIN = MP * SROWS * 2;
    int wbuf = 0, wnext = -1;
    int x_layer = -1, x_lo = 0, x_hi = 0, slot = 0, ti = t_beg;
    for (int l = 0; l < n_layers; ++l) {
      const Layer L = load_layer<INT8>(layer_tab, l);
      if (ti < t_end && load_tile(tile_tab, ti).layer == l) {
        // the layer's input is complete: the prologue's, or layer l - 1's
        // outputs (its barrier, word l - 1)
        if (threadIdx.x == 0) {
          const int* word = sync + (l == 0 ? 2 * n_layers : l - 1);
          while (ld_acquire(word) < (int)gridDim.x) __nanosleep(32);
        }
        __syncthreads();
        const __nv_bfloat16* in = acts + L.in_off;
        for (; ti < t_end; ++ti) {
          const Tile t = load_tile(tile_tab, ti);
          if (t.layer != l) break;
          float acc[NP][32];
#pragma unroll
          for (int j = 0; j < NP; ++j)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
          const bool q8 = INT8 && L.int8;
          const int step = q8 ? SROWS8 : SROWS;
          for (int r = t.r0; r < t.r1; r += step) {
            const uint32_t st = ring + slot * (SROWS * SLAB * 2);
            if (!q8) {
              // a bf16 stage: its window was prefetched by the stage
              // before in this layer (its group the second newest), or
              // is copied now, with the ring drained
              if (wnext < 0) {
                issue_window<MP>(xs_s + wbuf * WIN, in, L.K, M, r);
                cp_async_commit();
                cp_async_wait<0>();
              } else {
                cp_async_wait<1>();
              }
              asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
              __syncthreads();
              // the next stage's window, where it is in this layer, into
              // the other buffer (free: its stage's wgmma have completed)
              const int nti = r + step < t.r1 ? ti : ti + 1;
              wnext = -1;
              if (nti < t_end && load_tile(tile_tab, nti).layer == l) {
                wnext = nti == ti ? r + step : load_tile(tile_tab, nti).r0;
                issue_window<MP>(xs_s + (wbuf ^ 1) * WIN, in, L.K, M,
                                 wnext);
              }
              cp_async_commit();
              mma_stage_wide<NP, INT8>(st, xs_s + wbuf * WIN, 0, false, acc);
              wbuf ^= 1;
              x_layer = -1;
            } else {
              // an int8 stage (256 rows): windows of KCW rows, copied with
              // the ring drained
              if (l != x_layer || r < x_lo || r + step > x_hi) {
                __syncthreads();
                x_layer = l;
                x_lo = r;
                x_hi = min(r + KCW, t.r1);
                for (int k = x_lo; k < x_hi; k += SROWS)
                  issue_window<MP>(xs_s + (k - x_lo) / 64 * MP * 128, in,
                                   L.K, M, k);
                cp_async_commit();
                cp_async_wait<0>();
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                __syncthreads();
              }
              cp_async_wait<STAGES - 2>();
              __syncthreads();
              mma_stage_wide<NP, INT8>(st, xs_s, r - x_lo, true, acc);
            }
            issue_next();
            slot = slot + 1 == STAGES ? 0 : slot + 1;
          }
          // D of a piece: columns w * 16 + g (+ 8), rows 8 i + 2 q (+ 1)
          const int g = lane >> 2, q = lane & 3;
#pragma unroll
          for (int j = 0; j < NP; ++j)
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = w * 16 + g + (e >> 1) * 8;
                const int m = (2 * j + wg) * PIECE + i * 8 + q * 2 + (e & 1);
                if (m >= M) continue;
                if (t.part >= 0)
                  parts[t.part + m * SLAB + c] = acc[j][i * 4 + e];
                else if (t.n0 + c < L.N)
                  store_out<INT8>(L, y, acts, m, t.n0 + c, acc[j][i * 4 + e],
                                  slope);
              }
        }
      }
      // a split layer: every block sums its share of the outputs once all
      // partials are written (barrier word L + l)
      const long long split = layer_tab[LAYER_FIELDS * l + 11];
      if (split != 0) {
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) {
          atomicAdd(&sync[n_layers + l], 1);
          while (ld_acquire(&sync[n_layers + l]) < (int)gridDim.x)
            __nanosleep(32);
        }
        __syncthreads();
        reduce_share<INT8>(L, parts + (split & ((1LL << 40) - 1)),
                           (int)(split >> 40), y, acts, M, slope);
      }
      // the layer's outputs are written: its barrier, word l
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) atomicAdd(&sync[l], 1);
    }
  } else {
    constexpr int MT = R::MT, NACC = R::NACC;
    const int kg = warp / R::MG, mg = warp % R::MG;
    float* red = reinterpret_cast<float*>(smem + R::RING + R::XS);
    __shared__ int last[MAX_LAYER_TILES];
    __shared__ int any_last;
    // the block leaves layer ``cur`` (its tiles [lt0, lt_end)) and every
    // layer before ``upto`` it has no tile in
    int cur = -1, lt0 = t_beg;
    auto leave = [&](int upto, int lt_end) {
      if (cur >= 0) {
        __threadfence();
        __syncthreads();
        const int n = lt_end - lt0;
        if (threadIdx.x == 0) any_last = 0;
        __syncthreads();
        if (threadIdx.x < n) {
          const Tile t = load_tile(tile_tab, lt0 + threadIdx.x);
          const int done =
              t.nsplit > 1 && atomicAdd(&sync[t.cnt], 1) == t.nsplit - 1;
          last[threadIdx.x] = done;
          if (done) any_last = 1;
        }
        __syncthreads();
        if (any_last) {
          // the slab's partials into shared memory (the staged activations'
          // space, free until the next layer), R_BATCH4 float4 loads in
          // flight a thread (load_partials), then each output summed over
          // them in chunk order; where they do not fit at once, in passes of
          // ``cnt`` outputs (whole slab rows, so no float4 crosses a chunk)
          __threadfence();
          const Layer L = load_layer<INT8>(layer_tab, cur);
          const int per = M * SLAB;
          float* buf = reinterpret_cast<float*>(xs);
          for (int i = 0; i < n; ++i) {
            if (!last[i]) continue;
            const Tile t = load_tile(tile_tab, lt0 + i);
            const int step = t.nsplit * per <= R::PART_CAP
                                 ? per : R::PART_CAP / t.nsplit / SLAB * SLAB;
            for (int e0 = 0; e0 < per; e0 += step) {
              const int cnt = min(step, per - e0), total4 = t.nsplit * cnt / 4;
              float4* buf4 = reinterpret_cast<float4*>(buf);
              if (cnt == per)
                load_partials<R::R_BATCH4, true>(buf4, parts + t.pbase, total4,
                                                 per, e0, cnt);
              else
                load_partials<R::R_BATCH4, false>(buf4, parts + t.pbase,
                                                  total4, per, e0, cnt);
              __syncthreads();
              for (int e = threadIdx.x; e < cnt; e += THREADS) {
                const int col = t.n0 + (e0 + e) % SLAB;
                if (col >= L.N) continue;
                float s = buf[e];
                for (int p = 1; p < t.nsplit; ++p) s += buf[p * cnt + e];
                store_out<INT8>(L, y, acts, (e0 + e) / SLAB, col, s, slope);
              }
              __syncthreads();
            }
          }
        }
        __threadfence();
        __syncthreads();
      }
      if (threadIdx.x == 0)
        for (int l = cur < 0 ? 0 : cur; l < upto; ++l) atomicAdd(&sync[l], 1);
    };

    int x_layer = -1, x_r0 = -1;
    int slot = 0;
    for (int ti = t_beg; ti < t_end; ++ti) {
      const Tile t = load_tile(tile_tab, ti);
      const Layer L = load_layer<INT8>(layer_tab, t.layer);
      if (t.layer != cur) {
        leave(t.layer, ti);
        cur = t.layer;
        lt0 = ti;
        if (t.layer > 0 && threadIdx.x == 0) {
          while (ld_acquire(&sync[t.layer - 1]) < (int)gridDim.x)
            __nanosleep(32);
        }
        __syncthreads();
      }
      if (t.layer != x_layer || t.r0 != x_r0) {
        __syncthreads();
        stage_x<NT, INT8>(xs, x, acts, L, M, t.r0, t.r1);
        __syncthreads();
        x_layer = t.layer;
        x_r0 = t.r0;
      }
      float acc[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      const bool q8 = INT8 && L.int8;
      const int step = q8 ? SROWS8 : SROWS;
      for (int r = t.r0; r < t.r1; r += step) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        const uint32_t st = ring + slot * (SROWS * SLAB * 2);
        if (q8)
          mma_stage_int8<NT>(st, xs, r - t.r0, min(step, t.r1 - r), acc);
        else
          mma_stage<NT>(st, xs, r - t.r0, min(step, t.r1 - r), acc);
        issue_next();
        slot = slot + 1 == STAGES ? 0 : slot + 1;
      }
      // each m-group's warp sums in a fixed tree over its k-groups:
      // kg += kg + h for h = KG / 2, ..., 1
#pragma unroll
      for (int h = R::KG / 2; h >= 1; h >>= 1) {
        if (kg >= h && kg < 2 * h) {
          float* dst =
              red + (size_t)((kg - h) * R::MG + mg) * NACC * 32 + lane;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                dst[((mt * NT + nt) * 4 + e) * 32] = acc[mt][nt][e];
        }
        __syncthreads();
        if (kg < h) {
          const float* src =
              red + (size_t)(kg * R::MG + mg) * NACC * 32 + lane;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[mt][nt][e] += src[((mt * NT + nt) * 4 + e) * 32];
        }
        __syncthreads();
      }
      if (kg == 0) {
        const int g = lane >> 2, q = lane & 3;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              // column in the slab, activation row
              const int c = (mg * MT + mt) * 16 + g + (e >> 1) * 8;
              const int m = nt * 8 + q * 2 + (e & 1);
              if (m >= M) continue;
              if (t.part >= 0)
                parts[t.part + m * SLAB + c] = acc[mt][nt][e];
              else if (t.n0 + c < L.N)
                store_out<INT8>(L, y, acts, m, t.n0 + c, acc[mt][nt][e], slope);
            }
      }
    }
    leave(n_layers, t_end);
  }
}

// the kernel's instances: [int8 kind][row class: M <= 8, 16, 32, 64, 128,
// 256], and each row class's dynamic shared memory
constexpr int N_CLASSES = 6;
const void* const KERNELS[2][N_CLASSES] = {
    {(const void*)mlp_run_kernel<1, false>,
     (const void*)mlp_run_kernel<2, false>,
     (const void*)mlp_run_kernel<4, false>,
     (const void*)mlp_run_kernel<8, false>,
     (const void*)mlp_run_kernel<16, false>,
     (const void*)mlp_run_kernel<32, false>},
    {(const void*)mlp_run_kernel<1, true>,
     (const void*)mlp_run_kernel<2, true>,
     (const void*)mlp_run_kernel<4, true>,
     (const void*)mlp_run_kernel<8, true>,
     (const void*)mlp_run_kernel<16, true>,
     (const void*)mlp_run_kernel<32, true>}};
const size_t SMEM[N_CLASSES] = {Rows<1>::SMEM,  Rows<2>::SMEM,
                                Rows<4>::SMEM,  Rows<8>::SMEM,
                                Rows<16>::SMEM, Rows<32>::SMEM};

int row_class(int M) {
  return M <= 8 ? 0 : M <= 16 ? 1 : M <= 32 ? 2 : M <= 64 ? 3 : M <= 128 ? 4
                                                                        : 5;
}

}  // namespace

// blocks of the persistent grid on this device: resident blocks per SM
// (the least occupancy of the instances at the kernel's shared memory) x
// SMs; sets the shared-memory attribute of every instance once per process
extern "C" int mlp_run_blocks() {
  static int cached = 0;
  if (cached) return cached;
  int dev, sms, least = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  for (int q = 0; q < 2; ++q)
    for (int c = 0; c < N_CLASSES; ++c) {
      int per_sm = 0;
      if (cudaFuncSetAttribute(KERNELS[q][c],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM[c]) != cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, KERNELS[q][c], THREADS, SMEM[c]) != cudaSuccess ||
          per_sm < 1)
        return -1;
      least = least == 0 || per_sm < least ? per_sm : least;
    }
  cached = least * sms;
  return cached;
}

// x [M, K0] fp32, y [M, N_last] fp32, M in 1..256; layers [L][12] int64,
// tiles [T][8] int32, block_tiles [n_blocks + 1] int32 (device tables of
// ops/fused_mlp.py::run_tables); ws: n_sync int32 sync words (zeroed here),
// then the bf16 activations at acts_off bytes and the fp32 partials at
// parts_off bytes; any_int8: the run has an int8 layer.  One cooperative
// launch of n_blocks blocks (refused if they cannot all be resident);
// returns the CUDA error code.
extern "C" int mlp_run(const float* x, float* y, const long long* layers,
                       const int* tiles, const int* block_tiles, void* ws,
                       int n_sync, long long acts_off, long long parts_off,
                       int M, int n_layers, int n_blocks, float slope,
                       int any_int8, cudaStream_t stream) {
  if (M < 1 || M > WIDE_ROWS || n_layers < 1 || n_layers > MAX_RUN_LAYERS ||
      n_blocks < 1 || mlp_run_blocks() < 1)
    return cudaErrorInvalidValue;
  int* sync = static_cast<int*>(ws);
  cudaError_t err =
      cudaMemsetAsync(sync, 0, sizeof(int) * (size_t)n_sync, stream);
  if (err != cudaSuccess) return err;
  __nv_bfloat16* acts = reinterpret_cast<__nv_bfloat16*>(
      static_cast<char*>(ws) + acts_off);
  float* parts =
      reinterpret_cast<float*>(static_cast<char*>(ws) + parts_off);
  void* args[] = {&x, &y, &layers, &tiles, &block_tiles, &acts, &parts,
                  &sync, &M, &n_layers, &slope};
  const int c = row_class(M);
  err = cudaLaunchCooperativeKernel(KERNELS[any_int8 != 0][c], dim3(n_blocks),
                                    dim3(THREADS), args, SMEM[c], stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
