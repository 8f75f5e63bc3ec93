// Fused BoundedME cascade for Hopper (sm_90a): fp32 (on an fp32 or a bf16
// table), int8, int4 and pq pull tiers, each with or without adaptive early
// exit.
//
// Replaces `fused_cascade_batched_pallas` and `fused_cascade_pallas`
// (src/repro/kernels/fused_cascade.py, kernel body `_make_kernel`, scratch
// `_scratch`, tier switch `_resolve_qkind`): one launch runs the whole
// multi-round cascade of a (B, N) query batch, or of one query, from the
// first pull to the final top-k_out extraction.  Two entries, one body.
//
// What bounds it.  Every pull reads one stored (R, Cs) tile of the table —
// fp32 (Cs = C, 4 bytes a cell), bf16 (Cs = C, 2 bytes), int8 (Cs = C, 1
// byte), nibble-packed int4 (Cs = C/2) or pq codes (Cs = C/w) — and does a
// few operations per byte, so the pulls are memory-bound: their least time
// is the pulled bytes over the card's memory rate, which only many SMs with
// many loads in flight reach.
// Between rounds the cascade must stop: every survivor's accumulator is
// complete before it is ranked, and the next round pulls the kept tiles.
// Those round ends (15 at the qwen1.5-0.5b table) are serial work per query
// and a barrier across the card each; with the pulls spread over the card
// they take most of a launch.
//
// What the design does.
//  * One persistent cooperative launch: one 512-thread CTA per SM (the grid
//    is the card's SM count, checked for co-residency; the launch writes
//    its gridDim.x back for the caller to read), all B queries in one
//    grid.  Round boundaries are grid syncs.  The TPU kernel's VMEM
//    scratch (accumulator, M2 accumulator, survivor list, pq lookup table,
//    active / t_stop lanes) lives in per-query device workspace that the
//    wrapper allocates; it is written inside the launch, so it is read with
//    plain loads, never through the read-only path.
//  * Pulls are spread over every warp of the grid.  A work item is one
//    (query b, survivor slot) and belongs to warp (slot * B + b) mod W for
//    the whole round; that warp walks the item's steps of the round in step
//    order.  Within a round the survivor list is fixed and every tile
//    receives only its own pulls, so each tile's sum is accumulated in
//    column order exactly as on the TPU, whichever warp takes it.  The
//    warp finds its items' steps from the flat schedule's layout
//    (`flatten_schedule`: column-major, slot-minor; segment geometry from
//    rounds_meta) without scanning the steps; the wrapper refuses a
//    schedule laid out otherwise before it launches.
//  * When the batch shares one block permutation (the wrapper is given
//    one cols row expanded over the batch: the engine's decode path),
//    round 1 — the identity survivor list and the same columns for every
//    query — loads each (tile, column) cell once and dots it with all B
//    queries; each query's partial is the same sequence of operations as
//    a lone pull, so results do not depend on the shared read.
//  * Pulls run on CUDA cores (no TF32, no tensor cores).  fp32: float4
//    loads of four rows, then an FMA dot and a butterfly per row.  A bf16
//    table (the tied embedding of a bf16 model, as the TPU kernel DMAs it
//    in its own dtype) is the same tier instantiated on 2-byte cells: a
//    lane reads the same four consecutive cells as 8 bytes, widens each
//    exactly to f32 (its bits shifted up 16) and runs the same FMA chain,
//    so a launch is bitwise the fp32 launch on the widened table and pulls
//    half its bytes.  int8 and
//    int4 (R = 8, 16-byte aligned rows): the tile's 16-byte loads are all
//    issued before any is reduced (C = 512 int8: 8 a lane); __dp4a, then a
//    transposing shuffle reduction that ends with lane r holding row r.
//    int4 feeds its nibbles to __dp4a as 16 times themselves (masks
//    w << 4 & 0xF0F0F0F0 and w & 0xF0F0F0F0) and shifts the exact sum down
//    by 4.  Integer sums are exact in any order; part = float(raw) *
//    (vscale * qscale) as two rounded float ops.  pq: the query's lookup
//    table lut[col][s][k] is built once per launch; one warp runs 32 / R
//    items at once, lane r + R*i summing row r of item i over s in order.
//  * Every float op whose rounding the plain PyTorch version repeats is
//    written as __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn, so no FMA
//    contraction changes it.
//  * Round ends run in shared memory, one CTA per query (CTAs loop over
//    queries when B exceeds the grid).  The CTA builds its T survivors'
//    64-bit keys (order-preserving score bits, then the complemented slot:
//    descending key order is score descending, slot ascending; -0.0 and
//    +0.0 equal; rows past n_valid score -inf) in dynamic shared memory,
//    finds the n_keep-th key by an MSB-first radix select, compacts the
//    kept keys in place and sorts them with a bitonic network whose
//    comparators all put the larger key first, so the power-of-two padding
//    is virtual and never stored; its stages shorter than 256 positions
//    run in registers (eight keys a thread, shuffles between lanes).  That
//    is the TPU's extraction order.
//    The final top-k_out over the n_final * R rows uses the same select and
//    sort.  Keys of a table too large for shared memory go to a per-CTA
//    device workspace instead, through the same code.
//  * Adaptive early exit: after each elimination an active query certifies
//    its survivors' rows (k_cert block-wide maxima of the same keys give the
//    top rows by mean and the least of their lower bounds; one more pass
//    takes the largest upper bound of the other rows).  A certified query
//    pulls nothing more, still eliminates on its frozen accumulator, and its
//    finish divides by its own t_stop.
//  * The kernel returns unscaled block means, like the TPU kernel; the
//    caller applies the padding rescale or an exact rescore.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kSlotMask = (1u << 29) - 1u;   // schedule.SLOT_MASK
constexpr unsigned kPullBit = 1u << 30;           // schedule.PULL_BIT
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStaticSmem = 8192;   // bytes kept for the static shared arrays
constexpr int kPerThread = 8;       // keys a thread holds while compacting
constexpr int kSortAll = 2048;      // round ends of at most this many keys sort them all

// kBF16 is the fp32 tier on a bf16 table: f32 queries, f32 accumulators.
enum Tier : int { kF32 = 0, kI8 = 1, kI4 = 2, kPQ = 3, kBF16 = 4 };

struct Args {
  const void* V4;        // (n_tiles, n_blocks, R, Cs) f32 / bf16 / int8 / packed / codes
  const void* Qb;        // (B, n_blocks, C): f32 (fp32, bf16, pq) or int8 (int8, int4)
  const float* vscale;   // (n_tiles, n_blocks), int tiers
  const float* qscale;   // (B, n_blocks), int tiers
  const float* codebook; // (n_blocks, Cs, n_codes, w), pq
  const float* cert;     // (n_rounds + 1, 2): a_l, b_l, adaptive
  const int* slotcode;   // (S,)
  const int* rmeta;      // (n_rounds + 1, 3): t_cum, n_surv, n_keep
  const int* cols;       // (B, S)
  int* ids;              // (B, k_out)
  float* vals;           // (B, k_out)
  int* rused;            // (B,), adaptive
  float* acc;            // workspace (B, n_tiles, R)
  float* acc2;           // workspace (B, n_tiles, R), bernstein
  int* surv;             // workspace (B, n_tiles)
  int* tmp;              // workspace (B, n_tiles)
  int* state;            // workspace (2B): active, t_stop per query
  int* grid_out;         // (1,): the launch writes its gridDim.x here
  unsigned long long* keys;  // workspace (grid, P), or null: keys in shared memory
  float* lut;            // workspace (B, n_blocks * Cs * n_codes), pq
  int B, n_tiles, n_blocks, R, C, Cs, S, n_rounds, t_final, n_final, k_out;
  int n_codes, k_cert, P;
  int vec;               // 1: the tier's 16-byte vector loads are legal
  int shared_cols;       // 1: every query's cols row is the same
  long long n_valid;
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

__device__ __forceinline__ int warp_sum_int(int s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// One query's partial of one pulled tile: lanes [lo, hi) hold rows
// [lo, hi), lane r row r.
struct Part {
  float v;
  int lo, hi;
};

// ---- fp32 pulls, on an fp32 or a bf16 table ---------------------------------

// A bf16 cell is its 16 bits (uint16_t); widening it to f32 is exact.
using bf16_bits = uint16_t;

__device__ __forceinline__ float widen(unsigned bits16) {
  return __uint_as_float(bits16 << 16);
}

// Cells 4i .. 4i + 3 of a row, as f32.
__device__ __forceinline__ float4 load4(const float* v, size_t i) {
  return __ldg(reinterpret_cast<const float4*>(v) + i);
}

__device__ __forceinline__ float4 load4(const bf16_bits* v, size_t i) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(v) + i);
  return make_float4(widen(u.x & 0xffffu), __uint_as_float(u.x & 0xffff0000u),
                     widen(u.y & 0xffffu), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float load1(const float* v, size_t i) { return __ldg(v + i); }

__device__ __forceinline__ float load1(const bf16_bits* v, size_t i) {
  return widen(__ldg(v + i));
}

// Dot of an (8, 128 * JR) tile with each listed query's block; for each
// half of four rows the loads of all four rows are issued before any is
// reduced, and the half is emitted per query.
template <int JR, class T, class Emit>
__device__ __forceinline__ void pull8(const T* __restrict__ v,
                                      const float* __restrict__ Qb,
                                      size_t q_stride, int b0, int b1,
                                      int bstep, int lane, Emit&& emit) {
  constexpr int C4 = 32 * JR;
#pragma unroll
  for (int h = 0; h < 8; h += 4) {
    float4 t[4][JR];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < JR; ++k)
        t[r][k] = load4(v, (h + r) * C4 + lane + 32 * k);
    for (int b = b0; b < b1; b += bstep) {
      const float4* q = reinterpret_cast<const float4*>(Qb + b * q_stride);
      float4 qv[JR];
#pragma unroll
      for (int k = 0; k < JR; ++k) qv[k] = __ldg(q + lane + 32 * k);
      float mine = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < JR; ++k) {
          s = fmaf(t[r][k].x, qv[k].x, s);
          s = fmaf(t[r][k].y, qv[k].y, s);
          s = fmaf(t[r][k].z, qv[k].z, s);
          s = fmaf(t[r][k].w, qv[k].w, s);
        }
        s = warp_sum(s);
        if (lane == h + r) mine = s;
      }
      emit(b, Part{mine, h, h + 4});
    }
  }
}

// Any R <= 32 and any C; lane r returns row r.
template <class T>
__device__ float pull_f32_any(const T* __restrict__ v,
                              const float* __restrict__ q, int R, int C,
                              int lane) {
  float mine = 0.f;
  for (int r = 0; r < R; ++r) {
    float s = 0.f;
    for (int c = lane; c < C; c += 32)
      s = fmaf(load1(v, (size_t)r * C + c), __ldg(q + c), s);
    s = warp_sum(s);
    if (lane == r) mine = s;
  }
  return mine;
}

// ---- int8 and int4 pulls: exact integer dots ------------------------------

// Eight per-row sums spread over the warp -> lane l holds the total of row
// (l >> 2) & 7.  Three exchange steps halve the values a lane carries, two
// butterflies finish: 9 shuffles instead of 8 x 5.
__device__ __forceinline__ int transpose_reduce8(const int (&v)[8], int lane) {
  const bool h = lane & 16, g = lane & 8, f = lane & 4;
  int a4[4], a2[2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    a4[j] = (h ? v[j + 4] : v[j]) + __shfl_xor_sync(kFull, h ? v[j] : v[j + 4], 16);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    a2[j] = (g ? a4[j + 2] : a4[j]) + __shfl_xor_sync(kFull, g ? a4[j] : a4[j + 2], 8);
  int x = (f ? a2[1] : a2[0]) + __shfl_xor_sync(kFull, f ? a2[0] : a2[1], 4);
  x += __shfl_xor_sync(kFull, x, 2);
  x += __shfl_xor_sync(kFull, x, 1);
  return x;
}

// An (8, 16 V)-byte tile held as NV = V / 4 16-byte vectors a lane: vector
// k = lane + 32 i of the tile is row k / V, column vector k % V.  Returns,
// in lane r < 8, row r's total of the per-vector sums p.
template <int V>
__device__ __forceinline__ int reduce_rows(int (&p)[V / 4], int lane) {
  constexpr int NV = V / 4;
  if constexpr (V >= 32) {             // vector i of every lane is row i / (V/32)
    constexpr int m = V / 32;
    int rows[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      rows[r] = p[r * m];
#pragma unroll
      for (int u = 1; u < m; ++u) rows[r] += p[r * m + u];
    }
    return __shfl_sync(kFull, transpose_reduce8(rows, lane), (4 * lane) & 31);
  } else {                             // V lanes per row, 32 / V rows per i
    constexpr int g = 32 / V;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int o = V / 2; o > 0; o >>= 1) p[i] += __shfl_xor_sync(kFull, p[i], o);
    int mine = 0;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int x = __shfl_sync(kFull, p[i], (lane % g) * V);
      if (lane / g == i) mine = x;
    }
    return mine;
  }
}

__device__ __forceinline__ int dot4_i8(const int4 x, const int4 y, int s) {
  s = __dp4a(x.x, y.x, s);
  s = __dp4a(x.y, y.y, s);
  s = __dp4a(x.z, y.z, s);
  return __dp4a(x.w, y.w, s);
}

// 16 times the dot of 32 signed nibbles (the low and high halves of 16
// packed bytes) with two int8 query vectors.
__device__ __forceinline__ int dot4_i4(const int4 x, const int4 lo,
                                       const int4 hi, int s) {
  const unsigned xs[4] = {static_cast<unsigned>(x.x), static_cast<unsigned>(x.y),
                          static_cast<unsigned>(x.z), static_cast<unsigned>(x.w)};
  const int ls[4] = {lo.x, lo.y, lo.z, lo.w};
  const int hs[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    s = __dp4a(static_cast<int>((xs[u] << 4) & 0xF0F0F0F0u), ls[u], s);
    s = __dp4a(static_cast<int>(xs[u] & 0xF0F0F0F0u), hs[u], s);
  }
  return s;
}

// R = 8 rows of V 16-byte vectors each: every load of the tile first, then
// for each listed query the __dp4a dots and one reduction of all rows.
// Emits each query's exact integer row dots; the caller scales them.
template <int V, bool I4, class Emit>
__device__ __forceinline__ void pull_int8rows(const int4* __restrict__ v,
                                              const int8_t* __restrict__ Qb,
                                              size_t q_stride, int Cs, int b0,
                                              int b1, int bstep, int lane,
                                              Emit&& emit) {
  constexpr int NV = V / 4;
  int4 x[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) x[i] = __ldg(v + lane + 32 * i);
  for (int b = b0; b < b1; b += bstep) {
    const int8_t* q = Qb + b * q_stride;
    int p[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int u = (lane + 32 * i) % V;
      if constexpr (I4) {
        const int4 lo = __ldg(reinterpret_cast<const int4*>(q) + u);
        const int4 hi = __ldg(reinterpret_cast<const int4*>(q + Cs) + u);
        p[i] = dot4_i4(x[i], lo, hi, 0);
      } else {
        p[i] = dot4_i8(x[i], __ldg(reinterpret_cast<const int4*>(q) + u), 0);
      }
    }
    const int raw = reduce_rows<V>(p, lane);
    emit(b, I4 ? (raw >> 4) : raw);
  }
}

// Any R and C: lane r returns row r's exact dot (the int4 form unpacks).
__device__ int pull_int_any(const int8_t* __restrict__ v,
                            const int8_t* __restrict__ q, int R, int Cs,
                            bool i4, int lane) {
  int mine = 0;
  for (int r = 0; r < R; ++r) {
    int s = 0;
    for (int c = lane; c < Cs; c += 32) {
      const int p = static_cast<int>(__ldg(v + (size_t)r * Cs + c));
      if (i4) {
        const int lo = static_cast<int>(static_cast<int8_t>(p << 4)) >> 4;
        const int hi = static_cast<int>(static_cast<int8_t>(p)) >> 4;
        s += lo * static_cast<int>(__ldg(q + c)) +
             hi * static_cast<int>(__ldg(q + Cs + c));
      } else {
        s += p * static_cast<int>(__ldg(q + c));
      }
    }
    s = warp_sum_int(s);
    if (lane == r) mine = s;
  }
  return mine;
}

// ---- one pulled cell, for one query or for all queries sharing it -------

// Adds one query's partial of a tile to its accumulators: lanes [lo, hi)
// hold rows lo .. hi - 1.
template <bool TRACK_VAR>
__device__ __forceinline__ void add_rows(const Args& a, int b, int tile,
                                         float part, int lo, int hi,
                                         int lane) {
  if (lane < lo || lane >= hi || lane >= a.R) return;
  const size_t row = (static_cast<size_t>(b) * a.n_tiles + tile) * a.R + lane;
  a.acc[row] = __fadd_rn(a.acc[row], part);
  if constexpr (TRACK_VAR) a.acc2[row] = __fadd_rn(a.acc2[row], __fmul_rn(part, part));
}

// Pulls cell (tile, col) for queries b0, b0 + bstep, ... < b1 (all of them
// share the cell) and accumulates each query's partial.
template <int TIER, bool TRACK_VAR>
__device__ void pull_cell(const Args& a, int tile, int col, int b0, int b1,
                          int bstep, int lane) {
  const size_t cell = static_cast<size_t>(tile) * a.n_blocks + col;
  const size_t tile_cells = static_cast<size_t>(a.R) * a.Cs;
  const size_t q_stride = static_cast<size_t>(a.n_blocks) * a.C;
  if constexpr (TIER == kF32 || TIER == kBF16) {
    using T = std::conditional_t<TIER == kBF16, bf16_bits, float>;
    const T* v = static_cast<const T*>(a.V4) + cell * tile_cells;
    const float* Q = static_cast<const float*>(a.Qb) + static_cast<size_t>(col) * a.C;
    auto emit = [&](int b, Part p) { add_rows<TRACK_VAR>(a, b, tile, p.v, p.lo, p.hi, lane); };
    if (a.vec) {
      switch (a.C >> 7) {
        case 1: pull8<1>(v, Q, q_stride, b0, b1, bstep, lane, emit); return;
        case 2: pull8<2>(v, Q, q_stride, b0, b1, bstep, lane, emit); return;
        case 4: pull8<4>(v, Q, q_stride, b0, b1, bstep, lane, emit); return;
        default: break;
      }
    }
    for (int b = b0; b < b1; b += bstep)
      emit(b, Part{pull_f32_any(v, Q + b * q_stride, a.R, a.C, lane), 0, a.R});
  } else {
    constexpr bool I4 = TIER == kI4;
    const int8_t* v = static_cast<const int8_t*>(a.V4) + cell * tile_cells;
    const int8_t* Q = static_cast<const int8_t*>(a.Qb) + static_cast<size_t>(col) * a.C;
    const float vs = __ldg(a.vscale + cell);
    auto emit = [&](int b, int raw) {
      const float scale = __fmul_rn(
          vs, __ldg(a.qscale + static_cast<size_t>(b) * a.n_blocks + col));
      add_rows<TRACK_VAR>(a, b, tile, __fmul_rn(__int2float_rn(raw), scale), 0, a.R, lane);
    };
    const int4* v16 = reinterpret_cast<const int4*>(v);
    if (a.vec && a.R == 8) {
      switch (a.Cs / 16) {
        case 4: pull_int8rows<4, I4>(v16, Q, q_stride, a.Cs, b0, b1, bstep, lane, emit); return;
        case 8: pull_int8rows<8, I4>(v16, Q, q_stride, a.Cs, b0, b1, bstep, lane, emit); return;
        case 16: pull_int8rows<16, I4>(v16, Q, q_stride, a.Cs, b0, b1, bstep, lane, emit); return;
        case 32: pull_int8rows<32, I4>(v16, Q, q_stride, a.Cs, b0, b1, bstep, lane, emit); return;
        case 64: pull_int8rows<64, I4>(v16, Q, q_stride, a.Cs, b0, b1, bstep, lane, emit); return;
        default: break;
      }
    }
    for (int b = b0; b < b1; b += bstep)
      emit(b, pull_int_any(v, Q + b * q_stride, a.R, a.Cs, I4, lane));
  }
}

// ---- pq pulls --------------------------------------------------------------

// Row r of query b's pull of cell (tile, col): sum_s lut[col][s][code],
// over s in order, added to the row's accumulators.
template <bool TRACK_VAR>
__device__ void pq_row(const Args& a, int b, int tile, int col, int r) {
  const size_t cell = static_cast<size_t>(tile) * a.n_blocks + col;
  const uint8_t* row = static_cast<const uint8_t*>(a.V4) + (cell * a.R + r) * a.Cs;
  const size_t per_q = static_cast<size_t>(a.n_blocks) * a.Cs * a.n_codes;
  const float* lut = a.lut + b * per_q + static_cast<size_t>(col) * a.Cs * a.n_codes;
  float s = lut[__ldg(row)];
  for (int j = 1; j < a.Cs; ++j) s = __fadd_rn(s, lut[j * a.n_codes + __ldg(row + j)]);
  const size_t acc_row = (static_cast<size_t>(b) * a.n_tiles + tile) * a.R + r;
  a.acc[acc_row] = __fadd_rn(a.acc[acc_row], s);
  if constexpr (TRACK_VAR) a.acc2[acc_row] = __fadd_rn(a.acc2[acc_row], __fmul_rn(s, s));
}

// ---- keys, select, sort and block reductions ------------------------------

// Descending order of the key is (score descending, index ascending).
// -0.0 and +0.0 compare equal, as they do in the TPU kernel's max.  A real
// entry's key is never 0.
__device__ __forceinline__ unsigned long long make_key(float score, int idx) {
  unsigned u = __float_as_uint(score == 0.f ? 0.f : score);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned long long>(0xffffffffu - static_cast<unsigned>(idx));
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(key & 0xffffffffull));
}

__device__ __forceinline__ int next_pow2(int x) {
  int n = 1;
  while (n < x) n <<= 1;
  return n;
}

// Static shared memory of one CTA's round ends.
struct Smem {
  unsigned long long red_key[kWarps + 1];
  float red_f[kWarps + 1];
  int hist[256];
  int wsum[kWarps];
  int digit, rem, done;
};

// The k-th largest of n distinct keys (0 < k < n), as a threshold: exactly k
// keys are >= it.  MSB-first radix select, 8 bits a pass; it stops as soon
// as every key of the chosen prefix is kept.
__device__ unsigned long long radix_select(const unsigned long long* keys,
                                           int n, int k, Smem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long prefix = 0ull, mask = 0ull;
  int rem = k;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += kThreads) sm.hist[i] = 0;
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += kThreads) {
      const int j = j0 + threadIdx.x;
      int d = -1;
      if (j < n) {
        const unsigned long long key = keys[j];
        if ((key & mask) == prefix) d = static_cast<int>((key >> shift) & 0xFFull);
      }
      const unsigned live = __ballot_sync(kFull, d >= 0);
      if (live == 0u) continue;
      const int lo = __reduce_min_sync(kFull, d >= 0 ? d : 256);
      if (lo == __reduce_max_sync(kFull, d)) {   // one digit: one add
        if (lane == __ffs(live) - 1) atomicAdd(&sm.hist[lo], __popc(live));
        continue;
      }
      const unsigned peers = __match_any_sync(kFull, d);
      if (d >= 0 && lane == __ffs(peers) - 1) atomicAdd(&sm.hist[d], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {       // lane l owns bins 255 - 8l down to 248 - 8l
      int s = 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) s += sm.hist[255 - 8 * lane - u];
      int incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const int L = __ffs(__ballot_sync(kFull, incl >= rem)) - 1;
      if (lane == L) {
        int cum = incl - s;
        for (int d = 255 - 8 * lane;; --d) {
          const int h = sm.hist[d];
          if (cum + h >= rem) {
            sm.digit = d;
            sm.rem = rem - cum;
            sm.done = h == rem - cum;
            break;
          }
          cum += h;
        }
      }
    }
    __syncthreads();
    prefix |= static_cast<unsigned long long>(sm.digit) << shift;
    mask |= 0xFFull << shift;
    rem = sm.rem;
    const bool done = sm.done;
    __syncthreads();
    if (done) break;
  }
  return prefix;
}

// Moves the keys >= thr to the front of keys[0, n), in no order.  A chunk
// is read into registers before any of it is written, and its kept keys
// land below the chunk's end, so nothing unread is overwritten.
__device__ void compact(unsigned long long* keys, int n,
                        unsigned long long thr, Smem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int j0 = 0; j0 < n; j0 += kThreads * kPerThread) {
    unsigned long long x[kPerThread];
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int j = j0 + u * kThreads + threadIdx.x;
      x[u] = j < n ? keys[j] : 0ull;
      cnt += x[u] >= thr;
    }
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) sm.wsum[warp] = incl;
    __syncthreads();
    int off = base + incl - cnt, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) off += sm.wsum[w];
      total += sm.wsum[w];
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u)
      if (x[u] >= thr) keys[off++] = x[u];
    base += total;
    __syncthreads();
  }
}

// ---- the sort: a bitonic network, eight keys a thread in registers -------

using u64 = unsigned long long;

__device__ __forceinline__ void ce(u64& hi, u64& lo) {   // larger key to hi
  if (hi < lo) {
    const u64 t = hi;
    hi = lo;
    lo = t;
  }
}

// Half-cleaner of distance J < 8 within a thread's eight keys.
template <int J>
__device__ __forceinline__ void thread_half(u64 (&x)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if ((e & J) == 0) ce(x[e], x[e + J]);
}

// Flip stage of merge level K <= 8 within a thread's eight keys.
template <int K>
__device__ __forceinline__ void thread_flip(u64 (&x)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if ((e & (K / 2)) == 0) ce(x[e], x[e ^ (K - 1)]);
}

// A stage whose partners lie in lane ^ m (distance >= 8): the flip stage
// pairs key e with the partner's key 7 - e.  `lower`: this lane holds the
// lower positions and keeps the larger keys.
__device__ __forceinline__ void lane_stage(u64 (&x)[8], int m, bool flip,
                                           bool lower) {
  u64 y[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) y[e] = __shfl_xor_sync(kFull, flip ? x[e ^ 7] : x[e], m);
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = lower == (x[e] > y[e]) ? x[e] : y[e];
}

// Merge levels k_first .. k_last (powers of two; all <= 256, or one
// level) over every group of 256 positions, in registers: thread t holds
// positions 8t .. 8t + 7 of its group of 4,096.  A level k <= 256 runs its
// flip stage and all its half-cleaners; a longer level its half-cleaners
// of distance < 256.  Positions from n on are the virtual least key: read
// as 0, never written.
__device__ void register_pass(u64* keys, int n, int np, int k_first,
                              int k_last) {
  const int lane = threadIdx.x & 31;
  for (int base = (threadIdx.x >> 5) * 256; base < np; base += kThreads * 8) {
    const int i0 = base + lane * 8;
    u64 x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = i0 + e < n ? keys[i0 + e] : 0ull;
    for (int k = k_first; k <= k_last; k <<= 1) {
      if (k == 2) {
        thread_flip<2>(x);
        continue;
      }
      if (k == 4) {
        thread_flip<4>(x);
        thread_half<1>(x);
        continue;
      }
      if (k == 8) {
        thread_flip<8>(x);
        thread_half<2>(x);
        thread_half<1>(x);
        continue;
      }
      int j = min(k, 256) >> 1;
      if (k <= 256) {
        lane_stage(x, (k - 1) >> 3, true, (lane & (j >> 3)) == 0);
        j >>= 1;
      }
      for (; j >= 8; j >>= 1) lane_stage(x, j >> 3, false, (lane & (j >> 3)) == 0);
      thread_half<4>(x);
      thread_half<2>(x);
      thread_half<1>(x);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (i0 + e < n) keys[i0 + e] = x[e];
  }
  __syncthreads();
}

// Sorts keys[0, n) descending.  A bitonic network over next_pow2(n)
// positions in which every comparator puts the larger key at the lower
// position: the virtual padding past n is the least key and never moves,
// so comparators that reach past n are skipped and the padding is never
// stored.  Stages of distance >= 256 run in shared memory, four
// comparators a thread in flight; the rest in registers.
__device__ void sort_desc(u64* keys, int n) {
  const int np = next_pow2(n);
  if (np <= 1) return;
  register_pass(keys, n, np, 2, min(np, 256));
  for (int k = 512; k <= np; k <<= 1) {
    for (int j = k >> 1; j >= 256; j >>= 1) {
      for (int p0 = threadIdx.x; p0 < np / 2; p0 += 4 * kThreads) {
        int il[4][2];
        u64 xy[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int p = p0 + u * kThreads;
          const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
          const int l = j == (k >> 1) ? (i ^ (k - 1)) : i + j;
          il[u][0] = i;
          il[u][1] = p < np / 2 && l < n ? l : -1;
          if (il[u][1] >= 0) {
            xy[u][0] = keys[i];
            xy[u][1] = keys[l];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (il[u][1] >= 0 && xy[u][0] < xy[u][1]) {
            keys[il[u][0]] = xy[u][1];
            keys[il[u][1]] = xy[u][0];
          }
        }
      }
      __syncthreads();
    }
    register_pass(keys, n, np, k, k);
  }
}

// Leaves the largest min(k, n) of keys[0, n) at the front, sorted
// descending.  Up to kSortAll keys are sorted whole: fewer barriers than a
// select, a compaction and a sort.
__device__ void select_top(unsigned long long* keys, int n, int k, Smem& sm) {
  if (k < n && n > kSortAll) {
    compact(keys, n, radix_select(keys, n, k, sm), sm);
    n = k;
  }
  sort_desc(keys, n);
}

// Block-wide maximum; every thread returns it.
__device__ unsigned long long block_max_key(unsigned long long x, Smem& sm) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(kFull, x, o);
    x = y > x ? y : x;
  }
  if ((threadIdx.x & 31) == 0) sm.red_key[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long m = sm.red_key[0];
    for (int w = 1; w < kWarps; ++w) m = sm.red_key[w] > m ? sm.red_key[w] : m;
    sm.red_key[kWarps] = m;
  }
  __syncthreads();
  const unsigned long long m = sm.red_key[kWarps];
  __syncthreads();
  return m;
}

__device__ float block_max_float(float x, Smem& sm) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  if ((threadIdx.x & 31) == 0) sm.red_f[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = sm.red_f[0];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, sm.red_f[w]);
    sm.red_f[kWarps] = m;
  }
  __syncthreads();
  const float m = sm.red_f[kWarps];
  __syncthreads();
  return m;
}

// ---- round ends, one CTA per query -------------------------------------------

// One query's per-query workspace.
struct Query {
  float* acc;
  float* acc2;
  int* surv;
  int* tmp;
  __device__ Query(const Args& a, int b) {
    const size_t rows = static_cast<size_t>(b) * a.n_tiles * a.R;
    acc = a.acc + rows;
    acc2 = a.acc2 ? a.acc2 + rows : nullptr;
    surv = a.surv + static_cast<size_t>(b) * a.n_tiles;
    tmp = a.tmp + static_cast<size_t>(b) * a.n_tiles;
  }
};

// Round end: keep the best n_keep of the first n_surv slots, in order.
__device__ void eliminate(const Args& a, int rnd, const Query& q,
                          unsigned long long* keys, Smem& sm) {
  const int R = a.R;
  const int t_cum = __ldg(a.rmeta + 3 * rnd);
  const int T = min(__ldg(a.rmeta + 3 * rnd + 1), a.n_tiles);
  const int keep = min(__ldg(a.rmeta + 3 * rnd + 2), T);
  const float denom = static_cast<float>(t_cum * a.C);
  if (R == 8 && denom > 0.f) {
    // max_r RN(acc_r / d) = RN(max_r acc_r / d) for d > 0: one division a
    // tile; four tiles' loads in flight a thread, two float4 each
    constexpr int U = 4;
    for (int j0 = threadIdx.x; j0 < T; j0 += U * kThreads) {
      int tile[U];
      float4 lo[U], hi[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * kThreads;
        tile[u] = j < T ? q.surv[j] : 0;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4* t4 = reinterpret_cast<const float4*>(q.acc + static_cast<size_t>(tile[u]) * 8);
        lo[u] = t4[0];
        hi[u] = t4[1];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * kThreads;
        if (j >= T) continue;
        const float v[8] = {lo[u].x, lo[u].y, lo[u].z, lo[u].w,
                            hi[u].x, hi[u].y, hi[u].z, hi[u].w};
        const long long row0 = static_cast<long long>(tile[u]) * 8;
        float m = -INFINITY;
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (row0 + r < a.n_valid) m = fmaxf(m, v[r]);
        keys[j] = make_key(m / denom, j);
      }
    }
  } else {
    for (int j = threadIdx.x; j < T; j += kThreads) {
      const long long row0 = static_cast<long long>(q.surv[j]) * R;
      float m = -INFINITY;
      for (int r = 0; r < R; ++r)
        if (row0 + r < a.n_valid) m = fmaxf(m, q.acc[row0 + r] / denom);
      keys[j] = make_key(m, j);
    }
  }
  __syncthreads();
  if (keep <= 0) return;
  select_top(keys, T, keep, sm);
  for (int j = threadIdx.x; j < keep; j += kThreads)
    q.tmp[j] = q.surv[key_index(keys[j])];
  __syncthreads();
  for (int j = threadIdx.x; j < keep; j += kThreads) q.surv[j] = q.tmp[j];
  __syncthreads();
}

// One survivor row's mean and confidence radius at a round end.
template <bool TRACK_VAR>
struct CertRow {
  float mu, rad;
  bool valid;
  __device__ CertRow(const Args& a, const Query& q, int j, float denom,
                     float denom_c, float ca, float cb) {
    const long long row = static_cast<long long>(q.surv[j / a.R]) * a.R + j % a.R;
    valid = row < a.n_valid;
    mu = __fdiv_rn(q.acc[row], denom);
    if constexpr (TRACK_VAR) {
      const float v = __fsub_rn(__fdiv_rn(q.acc2[row], denom_c), __fmul_rn(mu, mu));
      rad = __fadd_rn(__fmul_rn(ca, __fsqrt_rn(fmaxf(v, 0.f))), cb);
    } else {
      rad = cb;
    }
  }
  __device__ float mean() const { return valid ? mu : -INFINITY; }
  __device__ float upper() const { return valid ? __fadd_rn(mu, rad) : -INFINITY; }
  __device__ float lower() const { return valid ? __fsub_rn(mu, rad) : -INFINITY; }
};

// Does the query certify at round `rnd`?  Over the keep * R rows of the
// post-elimination survivors: the top k_cert rows by mean must have lower
// bounds at or above every other row's upper bound.  The survivors are in
// (tile max descending, slot ascending) order and rows are numbered
// slot-major, so each tile ahead of a row's tile holds a row that is ahead
// of it: the top k_cert rows lie in the first k_cert tiles, and only their
// rows are searched for them.
template <bool TRACK_VAR>
__device__ bool certify(const Args& a, int rnd, const Query& q, Smem& sm) {
  const int t_cum = __ldg(a.rmeta + 3 * rnd);
  const int T = min(__ldg(a.rmeta + 3 * rnd + 1), a.n_tiles);
  const int n = min(__ldg(a.rmeta + 3 * rnd + 2), T) * a.R;
  const float denom = static_cast<float>(t_cum * a.C);
  const float denom_c = __fmul_rn(denom, static_cast<float>(a.C));
  const float ca = __ldg(a.cert + 2 * rnd), cb = __ldg(a.cert + 2 * rnd + 1);
  unsigned long long prev = ~0ull;
  float minlb = INFINITY;
  const int n_top = min(n, a.k_cert * a.R);
  for (int t = 0; t < a.k_cert; ++t) {
    unsigned long long best = 0ull;
    for (int j = threadIdx.x; j < n_top; j += kThreads) {
      const CertRow<TRACK_VAR> c(a, q, j, denom, denom_c, ca, cb);
      const unsigned long long key = make_key(c.mean(), j);
      if (key < prev && key > best) best = key;
    }
    best = block_max_key(best, sm);
    if (best == 0ull) {      // fewer rows than k_cert: a padding row
      minlb = -INFINITY;
      break;
    }
    const CertRow<TRACK_VAR> c(a, q, key_index(best), denom, denom_c, ca, cb);
    minlb = fminf(minlb, c.lower());
    prev = best;
  }
  float maxub = -INFINITY;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const CertRow<TRACK_VAR> c(a, q, j, denom, denom_c, ca, cb);
    if (make_key(c.mean(), j) < prev) maxub = fmaxf(maxub, c.upper());
  }
  maxub = block_max_float(maxub, sm);
  return minlb >= maxub;
}

// Top k_out of the n_final * R rows of query b's final survivors.
__device__ void finalize(const Args& a, int b, const Query& q,
                         unsigned long long* keys, int t_used, Smem& sm) {
  const int R = a.R;
  const float denom = static_cast<float>(max(1, t_used) * a.C);
  const int NF = min(a.n_final, a.n_tiles) * R;
  for (int j = threadIdx.x; j < NF; j += kThreads) {
    const long long row = static_cast<long long>(q.surv[j / R]) * R + j % R;
    keys[j] = make_key(row < a.n_valid ? q.acc[row] / denom : -INFINITY, j);
  }
  __syncthreads();
  const int kk = min(a.k_out, NF);
  select_top(keys, NF, kk, sm);
  int* ids = a.ids + static_cast<size_t>(b) * a.k_out;
  float* vals = a.vals + static_cast<size_t>(b) * a.k_out;
  for (int j = threadIdx.x; j < kk; j += kThreads) {
    const int p = key_index(keys[j]);
    const long long row = static_cast<long long>(q.surv[p / R]) * R + p % R;
    ids[j] = static_cast<int>(row);
    vals[j] = row < a.n_valid ? q.acc[row] / denom : -INFINITY;
  }
  __syncthreads();
}

// ---- the kernel ------------------------------------------------------------

// Query b's pq lookup table lut[(col * Cs + s) * n_codes + k], each sum
// taken over j in order with one rounded multiply and one rounded add per
// term; the whole grid builds all queries' tables.
__device__ void build_luts(const Args& a, size_t gtid, size_t gstride) {
  const int w = a.C / a.Cs;
  const size_t per_q = static_cast<size_t>(a.n_blocks) * a.Cs * a.n_codes;
  const float* Q = static_cast<const float*>(a.Qb);
  for (size_t i = gtid; i < per_q * a.B; i += gstride) {
    const size_t b = i / per_q, k = i % per_q;
    const float* qs = Q + b * a.n_blocks * a.C + (k / a.n_codes) * w;
    const float* cb = a.codebook + k * w;
    float v = __fmul_rn(__ldg(qs), __ldg(cb));
    for (int j = 1; j < w; ++j) v = __fadd_rn(v, __fmul_rn(__ldg(qs + j), __ldg(cb + j)));
    a.lut[i] = v;
  }
}

// ---- walking the flat schedule ---------------------------------------------

// Segment `rnd` of a schedule laid out as `flatten_schedule` lays it out
// (column-major, slot-minor): round rnd < n_rounds pulls P = t_cum - t_prev
// columns of its T = n_surv slots and ends on its last step, or is one
// step that pulls nothing when P = 0; after the rounds, the remaining
// steps walk n_final slots column by column.  Step base + p * T + s is
// slot s of column p.
struct Seg {
  int T, P, len;
};

__device__ Seg segment_of(const Args& a, int rnd, int pos, int t_prev) {
  if (rnd < a.n_rounds) {
    const int T = __ldg(a.rmeta + 3 * rnd + 1);
    const int P = __ldg(a.rmeta + 3 * rnd) - t_prev;
    return P > 0 ? Seg{T, P, P * T} : Seg{1, 1, 1};
  }
  const int T = max(a.n_final, 1), len = a.S - pos;
  return Seg{T, (len + T - 1) / T, len};
}

__device__ __forceinline__ bool query_active(const Args& a, bool adaptive,
                                             unsigned amask, int b) {
  return !adaptive ||
         (a.B <= 32 ? ((amask >> b) & 1u) != 0u : a.state[2 * b] != 0);
}

// The cols row of query b: a shared batch's cols are one row.
__device__ __forceinline__ size_t cols_row(const Args& a, int b) {
  return a.shared_cols ? size_t{0} : static_cast<size_t>(b) * a.S;
}

// Pulls one segment laid out as `segment_of` says, without scanning it:
// item m = slot * B + b belongs to warp m mod W, which walks the item's
// columns in order.  With `shared` (round 1 of a batch sharing its cols)
// an item is a slot and is pulled once for all queries.  pq runs 32 / R
// items of a warp at once, lane r + R*i on row r of item i.
template <int TIER, bool ADAPTIVE, bool TRACK_VAR>
__device__ void walk_segment(const Args& a, const Seg& g, int base,
                             bool shared, unsigned amask, int W, int gw,
                             int lane) {
  const int T = min(g.T, a.n_tiles);
  auto col_of = [&](int b, int step) {
    if (step >= a.S) return -1;
    const unsigned code = static_cast<unsigned>(__ldg(a.slotcode + step));
    if ((code & kPullBit) == 0u) return -1;
    const int col = __ldg(a.cols + cols_row(a, b) + step);
    return col >= 0 && col < a.n_blocks ? col : -1;
  };
  if constexpr (TIER == kPQ) {
    const int G = 32 / a.R, i = lane / a.R, r = lane % a.R;
    const long long n_items = static_cast<long long>(T) * a.B;
    for (long long m0 = gw; m0 < n_items; m0 += static_cast<long long>(W) * G) {
      const long long m = m0 + static_cast<long long>(i) * W;
      if (lane >= G * a.R || m >= n_items) continue;
      const int s = static_cast<int>(m / a.B), b = static_cast<int>(m % a.B);
      if (!query_active(a, ADAPTIVE, amask, b)) continue;
      const int tile = a.surv[static_cast<size_t>(b) * a.n_tiles + s];
      for (int p = 0; p < g.P; ++p) {
        const int col = col_of(b, base + p * g.T + s);
        if (col >= 0) pq_row<TRACK_VAR>(a, b, tile, col, r);
      }
    }
  } else if (shared) {
    for (int s = gw; s < T; s += W) {
      const int tile = a.surv[s];
      for (int p = 0; p < g.P; ++p) {
        const int col = col_of(0, base + p * g.T + s);
        if (col >= 0) pull_cell<TIER, TRACK_VAR>(a, tile, col, 0, a.B, 1, lane);
      }
    }
  } else {
    const long long n_items = static_cast<long long>(T) * a.B;
    for (long long m = gw; m < n_items; m += W) {
      const int s = static_cast<int>(m / a.B), b = static_cast<int>(m % a.B);
      if (!query_active(a, ADAPTIVE, amask, b)) continue;
      const int tile = a.surv[static_cast<size_t>(b) * a.n_tiles + s];
      for (int p = 0; p < g.P; ++p) {
        const int col = col_of(b, base + p * g.T + s);
        if (col >= 0) pull_cell<TIER, TRACK_VAR>(a, tile, col, b, b + 1, 1, lane);
      }
    }
  }
}

// Round end `rnd` of every query, one CTA per query: eliminate, then an
// active query certifies.
template <bool ADAPTIVE, bool TRACK_VAR>
__device__ void round_end(const Args& a, int rnd, unsigned long long* keys,
                          Smem& sm) {
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const Query q(a, b);
    eliminate(a, rnd, q, keys, sm);
    if (ADAPTIVE && a.state[2 * b] != 0 && certify<TRACK_VAR>(a, rnd, q, sm)) {
      if (threadIdx.x == 0) {
        a.state[2 * b] = 0;
        a.state[2 * b + 1] = __ldg(a.rmeta + 3 * rnd);
        a.rused[b] = rnd + 1;
      }
    }
    __syncthreads();
  }
}

template <int TIER, bool ADAPTIVE, bool TRACK_VAR>
__global__ void __launch_bounds__(kThreads, 1) cascade_kernel(Args a) {
  extern __shared__ unsigned long long dyn_keys[];
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = gridDim.x * kWarps, gw = blockIdx.x * kWarps + warp;
  const size_t gtid = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t gstride = static_cast<size_t>(gridDim.x) * kThreads;
  unsigned long long* keys =
      a.keys ? a.keys + static_cast<size_t>(blockIdx.x) * a.P : dyn_keys;

  const size_t n_rows = static_cast<size_t>(a.B) * a.n_tiles * a.R;
  for (size_t i = gtid; i < n_rows; i += gstride) {
    a.acc[i] = 0.f;
    if constexpr (TRACK_VAR) a.acc2[i] = 0.f;
  }
  for (size_t i = gtid; i < static_cast<size_t>(a.B) * a.n_tiles; i += gstride)
    a.surv[i] = static_cast<int>(i % a.n_tiles);
  if constexpr (ADAPTIVE) {
    for (size_t i = gtid; i < static_cast<size_t>(a.B); i += gstride) {
      a.state[2 * i] = 1;
      a.state[2 * i + 1] = a.t_final;
      a.rused[i] = a.n_rounds;
    }
  }
  if constexpr (TIER == kPQ) build_luts(a, gtid, gstride);
  if (gtid == 0) *a.grid_out = static_cast<int>(gridDim.x);
  grid.sync();

  int pos = 0, t_prev = 0;
  for (int rnd = 0;; ++rnd) {
    const Seg g = segment_of(a, rnd, pos, t_prev);
    if (g.len > 0) {
      const unsigned amask = ADAPTIVE && a.B <= 32
          ? __ballot_sync(kFull, lane < a.B && a.state[2 * lane] != 0) : kFull;
      walk_segment<TIER, ADAPTIVE, TRACK_VAR>(
          a, g, pos, a.shared_cols && rnd == 0, amask, W, gw, lane);
      grid.sync();
    }
    if (rnd >= a.n_rounds) break;
    round_end<ADAPTIVE, TRACK_VAR>(a, rnd, keys, sm);
    grid.sync();
    t_prev = __ldg(a.rmeta + 3 * rnd);
    pos += g.len;
  }
  for (int b = blockIdx.x; b < a.B; b += gridDim.x)
    finalize(a, b, Query(a, b), keys, ADAPTIVE ? a.state[2 * b + 1] : a.t_final, sm);
}

// One cooperative launch over every SM: one CTA per SM, the round ends'
// keys in dynamic shared memory unless the wrapper gave a workspace.
template <int TIER, bool ADAPTIVE, bool TRACK_VAR>
cudaError_t launch_inst(const Args& a, cudaStream_t stream) {
  auto kern = cascade_kernel<TIER, ADAPTIVE, TRACK_VAR>;
  // the shared-memory size this instance was last set up and checked for
  // on a device; a smaller one fits too
  static int ready_dev = -1;
  static size_t ready_smem = 0;
  int dev = 0, sms = 0, per_sm = 1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = a.keys ? 0 : static_cast<size_t>(a.P) * sizeof(unsigned long long);
  if (err == cudaSuccess && (dev != ready_dev || smem > ready_smem)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    if (err == cudaSuccess && per_sm >= 1) {
      ready_dev = dev;
      ready_smem = smem;
    }
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  Args copy = a;
  void* params[] = {&copy};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(sms),
                                    dim3(kThreads), params, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int TIER>
cudaError_t launch_tier(const Args& a, int adaptive, int track_var,
                        cudaStream_t stream) {
  if (!adaptive) return launch_inst<TIER, false, false>(a, stream);
  if (!track_var) return launch_inst<TIER, true, false>(a, stream);
  return launch_inst<TIER, true, true>(a, stream);
}

cudaError_t launch(int tier, const Args& a, int adaptive, int track_var,
                   cudaStream_t stream) {
  switch (tier) {
    case kF32: return launch_tier<kF32>(a, adaptive, track_var, stream);
    case kI8: return launch_tier<kI8>(a, adaptive, track_var, stream);
    case kI4: return launch_tier<kI4>(a, adaptive, track_var, stream);
    case kPQ: return launch_tier<kPQ>(a, adaptive, track_var, stream);
    case kBF16: return launch_tier<kBF16>(a, adaptive, track_var, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The grid of a launch on the current device: its SM count (one CTA each)
// and how many 64-bit round-end keys fit in a CTA's shared memory (above
// that the wrapper passes a keys workspace of (grid, P)).
extern "C" int fused_cascade_config(int* sms, int* key_capacity) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *key_capacity = (optin - kStaticSmem) / static_cast<int>(sizeof(unsigned long long));
  return static_cast<int>(err);
}

// The batched entry, for every tier: tier 0 fp32, 1 int8, 2 int4, 3 pq,
// 4 fp32 on a bf16 table.
// With shared_cols every query reads cols row 0 (the wrapper sets it for
// cols that are one row expanded over the batch).  Returns the launch's
// cudaError_t (0 on success); the wrapper raises on anything else.
extern "C" int fused_cascade_batched(
    int tier, int adaptive, int track_var, int shared_cols, const void* V4,
    const void* Qb, const float* vscale, const float* qscale,
    const float* codebook, const float* cert, const int* slotcode,
    const int* rmeta, const int* cols, int* ids, float* vals, int* rused,
    float* acc, float* acc2, int* surv, int* tmp, int* state, int* grid_out,
    unsigned long long* keys, float* lut, int B, int n_tiles, int n_blocks,
    int R, int C, int Cs, int S, int n_rounds, int t_final, int n_final,
    int k_out, int n_codes, int k_cert, int P, int vec, long long n_valid,
    cudaStream_t stream) {
  Args a{V4, Qb, vscale, qscale, codebook, cert, slotcode, rmeta, cols, ids,
         vals, rused, acc, acc2, surv, tmp, state, grid_out, keys, lut, B,
         n_tiles, n_blocks, R, C, Cs, S, n_rounds, t_final, n_final, k_out,
         n_codes, k_cert, P, vec, shared_cols, n_valid};
  return static_cast<int>(launch(tier, a, adaptive, track_var, stream));
}

// The single-query entry (replaces `fused_cascade_pallas`): qb (n_blocks, C),
// qscale (n_blocks,), cols (S,), ids and vals (k_out,), a scalar rused, and
// workspace for one query.  The TPU's two kernels are one `_make_kernel`
// body; here the same templated body runs over the same grid.  The layouts
// are those of a B = 1 batch, so its outputs equal a B = 1 batched launch
// bit for bit.
extern "C" int fused_cascade(
    int tier, int adaptive, int track_var, const void* V4, const void* qb,
    const float* vscale, const float* qscale, const float* codebook,
    const float* cert, const int* slotcode, const int* rmeta, const int* cols,
    int* ids, float* vals, int* rused, float* acc, float* acc2, int* surv,
    int* tmp, int* state, int* grid_out, unsigned long long* keys, float* lut,
    int n_tiles, int n_blocks, int R, int C, int Cs, int S, int n_rounds,
    int t_final, int n_final, int k_out, int n_codes, int k_cert, int P,
    int vec, long long n_valid, cudaStream_t stream) {
  Args a{V4, qb, vscale, qscale, codebook, cert, slotcode, rmeta, cols, ids,
         vals, rused, acc, acc2, surv, tmp, state, grid_out, keys, lut, 1,
         n_tiles, n_blocks, R, C, Cs, S, n_rounds, t_final, n_final, k_out,
         n_codes, k_cert, P, vec, 0, n_valid};
  return static_cast<int>(launch(tier, a, adaptive, track_var, stream));
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
