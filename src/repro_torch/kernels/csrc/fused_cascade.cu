// Fused BoundedME cascade for Hopper (sm_90a): fp32, int8, int4 and pq
// pull tiers, each with or without adaptive early exit.
//
// Replaces `fused_cascade_batched_pallas` and `fused_cascade_pallas`
// (src/repro/kernels/fused_cascade.py, kernel body `_make_kernel`, scratch
// `_scratch`, tier switch `_resolve_qkind`): one launch runs the whole
// multi-round cascade of a (B, N) query batch, or of one query, from the
// first pull to the final top-k_out extraction.  Two entries, one body.
//
// What bounds it.  Every pull reads one stored (R, Cs) tile of the table —
// fp32 (Cs = C, 4 bytes a cell), int8 (Cs = C, 1 byte), nibble-packed int4
// (Cs = C/2) or pq codes (Cs = C/w) — and does a few operations per byte, so
// the work is memory-bound: the least time is the pulled bytes over the
// card's memory rate.  This version runs one block per query, so a batch of
// B queries occupies B of the 132 SMs and the rate one SM can load at, not
// HBM, limits it.  Reading each pulled tile once for all queries of a batch
// (they share one block permutation) is where a later version gains.  The
// single-query entry runs one block, so 131 of 132 SMs idle; splitting one
// query over a thread-block cluster is where that entry gains.
//
// What the design does.
//  * The TPU kernel's sequential (B, S) grid becomes one block per query
//    that loops over the flat schedule.  Its VMEM/SMEM scratch (accumulator,
//    M2 accumulator, survivor list, score buffer, pq lookup table) does not
//    fit in shared memory at real table sizes, so it lives in per-query
//    device workspace that the wrapper allocates; at a few MB per batch it
//    stays in L2.
//  * Within a round the survivor list is fixed and every tile receives only
//    its own pulls.  Warp w takes the steps whose survivor slot is
//    congruent to w modulo the warp count and walks them in step order, so
//    each tile's sum is accumulated in column order exactly as on the TPU;
//    the block synchronises only at round ends.
//  * Pulls run on CUDA cores (no TF32, no tensor cores).  fp32: float4
//    loads of every row, an FMA dot, a butterfly of shuffles per row.
//    int8: 16-byte loads and __dp4a, an exact int32 sum in any order, then
//    part = float(raw) * (vscale * qscale) as two rounded float ops.  int4:
//    each packed byte holds column k (low nibble) and k + C/2 (high); the
//    masks w << 4 & 0xF0F0F0F0 and w & 0xF0F0F0F0 turn four bytes into four
//    signed nibbles times 16, which __dp4a takes as they are, and the exact
//    sum is shifted down by 4 at the end; then the int8 path.  pq: the
//    query's lookup table lut[col][s][k] = sum_j q[col][s*w + j] *
//    cb[col][s][k][j] is built once per launch for all column blocks (the
//    TPU builds it per pull: the same values), and lane r sums row r's
//    lut[col][s][code] over s in order.
//  * Every float op whose rounding the plain PyTorch version repeats is
//    written as __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn, so no FMA
//    contraction changes it: the int8 and int4 accumulators, the M2
//    accumulator, the pq sums and the certification radii match the plain
//    version bit for bit.
//  * Elimination keeps the top n_keep slots by (score descending, slot
//    ascending) and writes them in that order, which is what the TPU
//    kernel's iterative max extraction with NaN marking produces.  The
//    pair is packed into one 64-bit key (order-preserving float bits, then
//    the complemented slot) and sorted by a block-wide bitonic sort.  The
//    final top-k_out over the n_final * R surviving rows uses the same sort.
//  * Adaptive early exit keeps per-query active / t_stop / rounds_used lanes
//    in shared memory.  After each round-end elimination an active query
//    certifies its survivors' rows: k_cert block-wide maxima of the same
//    64-bit keys (each the largest key below the previous one, which is the
//    TPU's extraction order without marking) give the top rows by mean and
//    the least of their lower bounds; one more pass takes the largest upper
//    bound of the other rows.  A certified query skips its later pulls,
//    still eliminates on its frozen accumulator, and its finish divides by
//    the pulls it actually made.
//  * The kernel returns unscaled block means, like the TPU kernel; the
//    caller applies the padding rescale or an exact rescore.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kSlotMask = (1u << 29) - 1u;   // schedule.SLOT_MASK
constexpr unsigned kEndBit = 1u << 29;            // schedule.END_BIT
constexpr unsigned kPullBit = 1u << 30;           // schedule.PULL_BIT
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Tier : int { kF32 = 0, kI8 = 1, kI4 = 2, kPQ = 3 };

struct Args {
  const void* V4;        // (n_tiles, n_blocks, R, Cs) f32 / int8 / packed / codes
  const void* Qb;        // (B, n_blocks, C): f32 (fp32, pq) or int8 (int8, int4)
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
  unsigned long long* keys;  // workspace (B, P)
  float* lut;            // workspace (B, n_blocks * Cs * n_codes), pq
  int n_tiles, n_blocks, R, C, Cs, S, n_rounds, t_final, n_final, k_out;
  int n_codes, k_cert, P;
  int vec;               // 1: the tier's 16-byte vector loads are legal
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

// ---- fp32 pulls ----------------------------------------------------------

// Dot of an (8, 128 * JR) tile with the query block; lane r returns row r.
// The loads of four rows are issued before any of them is reduced.
template <int JR>
__device__ __forceinline__ float pull8(const float4* __restrict__ v,
                                       const float4* __restrict__ q,
                                       int lane) {
  constexpr int C4 = 32 * JR;
  float4 qv[JR];
#pragma unroll
  for (int k = 0; k < JR; ++k) qv[k] = __ldg(q + lane + 32 * k);
  float mine = 0.f;
#pragma unroll
  for (int h = 0; h < 8; h += 4) {
    float4 t[4][JR];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < JR; ++k)
        t[r][k] = __ldg(v + (h + r) * C4 + lane + 32 * k);
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
  }
  return mine;
}

// Any R <= 32 and any C; lane r returns row r.
__device__ float pull_f32_any(const float* __restrict__ v,
                              const float* __restrict__ q, int R, int C,
                              int lane) {
  float mine = 0.f;
  for (int r = 0; r < R; ++r) {
    float s = 0.f;
    for (int c = lane; c < C; c += 32)
      s = fmaf(__ldg(v + (size_t)r * C + c), __ldg(q + c), s);
    s = warp_sum(s);
    if (lane == r) mine = s;
  }
  return mine;
}

__device__ __forceinline__ float pull_f32(const Args& a, const float* v,
                                          const float* q, int lane) {
  if (a.vec) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    switch (a.C >> 7) {
      case 1: return pull8<1>(v4, q4, lane);
      case 2: return pull8<2>(v4, q4, lane);
      case 4: return pull8<4>(v4, q4, lane);
      default: break;
    }
  }
  return pull_f32_any(v, q, a.R, a.C, lane);
}

// ---- int8 and int4 pulls: exact integer dots; lane r returns row r ------

__device__ int pull_i8(const Args& a, const int8_t* __restrict__ v,
                       const int8_t* __restrict__ q, int lane) {
  const int R = a.R, C = a.C;
  int mine = 0;
  for (int r = 0; r < R; ++r) {
    int s = 0;
    if (a.vec) {           // C % 16 == 0, 16-byte aligned rows
      const int4* vr = reinterpret_cast<const int4*>(v + (size_t)r * C);
      const int4* q4 = reinterpret_cast<const int4*>(q);
      for (int k = lane; k < C / 16; k += 32) {
        const int4 x = __ldg(vr + k), y = __ldg(q4 + k);
        s = __dp4a(x.x, y.x, s);
        s = __dp4a(x.y, y.y, s);
        s = __dp4a(x.z, y.z, s);
        s = __dp4a(x.w, y.w, s);
      }
    } else {
      for (int c = lane; c < C; c += 32)
        s += static_cast<int>(__ldg(v + (size_t)r * C + c)) *
             static_cast<int>(__ldg(q + c));
    }
    s = warp_sum_int(s);
    if (lane == r) mine = s;
  }
  return mine;
}

// Packed rows of Cs = C/2 bytes: byte k holds column k in its low nibble
// and column k + Cs in its high nibble (the half-split layout).
__device__ int pull_i4(const Args& a, const int8_t* __restrict__ v,
                       const int8_t* __restrict__ q, int lane) {
  const int R = a.R, Cs = a.Cs;
  int mine = 0;
  for (int r = 0; r < R; ++r) {
    int s = 0;
    if (a.vec) {           // Cs % 16 == 0, 16-byte aligned rows
      // each signed nibble enters __dp4a as 16 times itself, so the sum
      // is 16 times the dot, exactly; one shift at the end divides it out
      const int4* vr = reinterpret_cast<const int4*>(v + (size_t)r * Cs);
      const int4* qlo = reinterpret_cast<const int4*>(q);
      const int4* qhi = reinterpret_cast<const int4*>(q + Cs);
      for (int k = lane; k < Cs / 16; k += 32) {
        const int4 x = __ldg(vr + k), lo = __ldg(qlo + k), hi = __ldg(qhi + k);
        const int xs[4] = {x.x, x.y, x.z, x.w};
        const int ls[4] = {lo.x, lo.y, lo.z, lo.w};
        const int hs[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned w = static_cast<unsigned>(xs[u]);
          s = __dp4a(static_cast<int>((w << 4) & 0xF0F0F0F0u), ls[u], s);
          s = __dp4a(static_cast<int>(w & 0xF0F0F0F0u), hs[u], s);
        }
      }
    } else {
      for (int c = lane; c < Cs; c += 32) {
        const int p = static_cast<int>(__ldg(v + (size_t)r * Cs + c));
        const int lo = static_cast<int>(static_cast<int8_t>(p << 4)) >> 4;
        const int hi = static_cast<int>(static_cast<int8_t>(p)) >> 4;
        s += 16 * (lo * static_cast<int>(__ldg(q + c)) +
                   hi * static_cast<int>(__ldg(q + Cs + c)));
      }
    }
    s = warp_sum_int(s) >> 4;
    if (lane == r) mine = s;
  }
  return mine;
}

// ---- pq pulls ------------------------------------------------------------

// Query b's table of lut[(col * Cs + s) * n_codes + k], each sum taken over
// j in order with one rounded multiply and one rounded add per term.
__device__ void build_lut(const Args& a, const float* __restrict__ q,
                          float* lut) {
  const int w = a.C / a.Cs;
  const int n = a.n_blocks * a.Cs * a.n_codes;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float* qs = q + static_cast<size_t>(i / a.n_codes) * w;
    const float* cb = a.codebook + static_cast<size_t>(i) * w;
    float v = __fmul_rn(__ldg(qs), __ldg(cb));
    for (int j = 1; j < w; ++j) v = __fadd_rn(v, __fmul_rn(__ldg(qs + j), __ldg(cb + j)));
    lut[i] = v;
  }
}

// Lane r returns sum_s lut[col][s][codes[r][s]], summed over s in order.
__device__ float pull_pq(const Args& a, const uint8_t* __restrict__ codes,
                         const float* lut_col, int lane) {
  if (lane >= a.R) return 0.f;
  const uint8_t* row = codes + static_cast<size_t>(lane) * a.Cs;
  float s = lut_col[__ldg(row)];
  for (int j = 1; j < a.Cs; ++j)
    s = __fadd_rn(s, lut_col[j * a.n_codes + __ldg(row + j)]);
  return s;
}

// ---- keys, sort and block reductions --------------------------------------

// Descending order of the key is (score descending, index ascending).
// -0.0 and +0.0 compare equal, as they do in the TPU kernel's max.  A real
// entry's key is never 0, so 0 pads.
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

// Block-wide bitonic sort of n (a power of two) keys, descending.  Key 0
// pads and sorts last.
__device__ void sort_desc(unsigned long long* keys, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < n / 2; p += kThreads) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int l = i + j;
        const unsigned long long x = keys[i], y = keys[l];
        const bool desc = (i & k) == 0;
        if (desc ? (x < y) : (x > y)) {
          keys[i] = y;
          keys[l] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Block-wide maximum; every thread returns it.  `red` holds kWarps + 1.
__device__ unsigned long long block_max_key(unsigned long long x,
                                            unsigned long long* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(kFull, x, o);
    x = y > x ? y : x;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long m = red[0];
    for (int w = 1; w < kWarps; ++w) m = red[w] > m ? red[w] : m;
    red[kWarps] = m;
  }
  __syncthreads();
  const unsigned long long m = red[kWarps];
  __syncthreads();
  return m;
}

__device__ float block_max_float(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red[0];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
    red[kWarps] = m;
  }
  __syncthreads();
  const float m = red[kWarps];
  __syncthreads();
  return m;
}

// ---- round ends ------------------------------------------------------------

// Round end: keep the best n_keep of the first n_surv slots.
__device__ void eliminate(const Args& a, int rnd, const float* acc, int* surv,
                          int* tmp, unsigned long long* keys) {
  const int R = a.R;
  const int t_cum = __ldg(a.rmeta + 3 * rnd);
  const int T = min(__ldg(a.rmeta + 3 * rnd + 1), a.n_tiles);
  const int keep = min(__ldg(a.rmeta + 3 * rnd + 2), T);
  const float denom = static_cast<float>(t_cum * a.C);
  const int n = next_pow2(T);
  for (int j = threadIdx.x; j < n; j += kThreads) {
    unsigned long long key = 0ull;
    if (j < T) {
      const long long row0 = static_cast<long long>(surv[j]) * R;
      float m = -INFINITY;
      for (int r = 0; r < R; ++r)
        if (row0 + r < a.n_valid) m = fmaxf(m, acc[row0 + r] / denom);
      key = make_key(m, j);
    }
    keys[j] = key;
  }
  __syncthreads();
  sort_desc(keys, n);
  for (int j = threadIdx.x; j < keep; j += kThreads)
    tmp[j] = surv[key_index(keys[j])];
  __syncthreads();
  for (int j = threadIdx.x; j < keep; j += kThreads) surv[j] = tmp[j];
  __syncthreads();
}

// One survivor row's mean and confidence radius at a round end.
template <bool TRACK_VAR>
struct CertRow {
  float mu, rad;
  bool valid;
  __device__ CertRow(const Args& a, const float* acc, const float* acc2,
                     const int* surv, int j, float denom, float denom_c,
                     float ca, float cb) {
    const long long row = static_cast<long long>(surv[j / a.R]) * a.R + j % a.R;
    valid = row < a.n_valid;
    mu = __fdiv_rn(acc[row], denom);
    if constexpr (TRACK_VAR) {
      const float v = __fsub_rn(__fdiv_rn(acc2[row], denom_c), __fmul_rn(mu, mu));
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
// bounds at or above every other row's upper bound.
template <bool TRACK_VAR>
__device__ bool certify(const Args& a, int rnd, const float* acc,
                        const float* acc2, const int* surv,
                        unsigned long long* red_key, float* red_f) {
  const int t_cum = __ldg(a.rmeta + 3 * rnd);
  const int T = min(__ldg(a.rmeta + 3 * rnd + 1), a.n_tiles);
  const int n = min(__ldg(a.rmeta + 3 * rnd + 2), T) * a.R;
  const float denom = static_cast<float>(t_cum * a.C);
  const float denom_c = __fmul_rn(denom, static_cast<float>(a.C));
  const float ca = __ldg(a.cert + 2 * rnd), cb = __ldg(a.cert + 2 * rnd + 1);
  unsigned long long prev = ~0ull;
  float minlb = INFINITY;
  for (int t = 0; t < a.k_cert; ++t) {
    unsigned long long best = 0ull;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const CertRow<TRACK_VAR> c(a, acc, acc2, surv, j, denom, denom_c, ca, cb);
      const unsigned long long key = make_key(c.mean(), j);
      if (key < prev && key > best) best = key;
    }
    best = block_max_key(best, red_key);
    if (best == 0ull) {      // fewer rows than k_cert: a padding row
      minlb = -INFINITY;
      break;
    }
    const CertRow<TRACK_VAR> c(a, acc, acc2, surv, key_index(best), denom,
                               denom_c, ca, cb);
    minlb = fminf(minlb, c.lower());
    prev = best;
  }
  float maxub = -INFINITY;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const CertRow<TRACK_VAR> c(a, acc, acc2, surv, j, denom, denom_c, ca, cb);
    if (make_key(c.mean(), j) < prev) maxub = fmaxf(maxub, c.upper());
  }
  maxub = block_max_float(maxub, red_f);
  return minlb >= maxub;
}

// Top k_out of the n_final * R rows of the final survivors.
__device__ void finalize(const Args& a, const float* acc, const int* surv,
                         unsigned long long* keys, int* ids, float* vals,
                         int t_used) {
  const int R = a.R;
  const float denom = static_cast<float>(max(1, t_used) * a.C);
  const int NF = min(a.n_final, a.n_tiles) * R;
  const int n = next_pow2(NF);
  for (int j = threadIdx.x; j < n; j += kThreads) {
    unsigned long long key = 0ull;
    if (j < NF) {
      const long long row = static_cast<long long>(surv[j / R]) * R + j % R;
      key = make_key(row < a.n_valid ? acc[row] / denom : -INFINITY, j);
    }
    keys[j] = key;
  }
  __syncthreads();
  sort_desc(keys, n);
  for (int j = threadIdx.x; j < min(a.k_out, NF); j += kThreads) {
    const int p = key_index(keys[j]);
    const long long row = static_cast<long long>(surv[p / R]) * R + p % R;
    ids[j] = static_cast<int>(row);
    vals[j] = row < a.n_valid ? acc[row] / denom : -INFINITY;
  }
}

// ---- the kernel ------------------------------------------------------------

template <int TIER, bool ADAPTIVE, bool TRACK_VAR>
__global__ void __launch_bounds__(kThreads, 1) cascade_kernel(Args a) {
  __shared__ int s_active, s_tstop, s_rused;
  __shared__ unsigned long long red_key[kWarps + 1];
  __shared__ float red_f[kWarps + 1];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = a.R;
  const size_t tile_cells = static_cast<size_t>(R) * a.Cs;
  float* acc = a.acc + static_cast<size_t>(b) * a.n_tiles * R;
  float* acc2 = TRACK_VAR ? a.acc2 + static_cast<size_t>(b) * a.n_tiles * R : nullptr;
  int* surv = a.surv + static_cast<size_t>(b) * a.n_tiles;
  int* tmp = a.tmp + static_cast<size_t>(b) * a.n_tiles;
  unsigned long long* keys = a.keys + static_cast<size_t>(b) * a.P;
  const int* cols = a.cols + static_cast<size_t>(b) * a.S;
  const size_t q_off = static_cast<size_t>(b) * a.n_blocks * a.C;
  float* lut = TIER == kPQ
      ? a.lut + static_cast<size_t>(b) * a.n_blocks * a.Cs * a.n_codes : nullptr;

  for (size_t i = threadIdx.x; i < static_cast<size_t>(a.n_tiles) * R; i += kThreads) {
    acc[i] = 0.f;
    if constexpr (TRACK_VAR) acc2[i] = 0.f;
  }
  for (int j = threadIdx.x; j < a.n_tiles; j += kThreads) surv[j] = j;
  if constexpr (TIER == kPQ) build_lut(a, static_cast<const float*>(a.Qb) + q_off, lut);
  if (threadIdx.x == 0) {
    s_active = 1;
    s_tstop = a.t_final;
    s_rused = a.n_rounds;
  }
  __syncthreads();

  int pos = 0, rnd = 0;
  while (pos < a.S) {
    // Every warp scans the same segment of steps, up to and including the
    // next round-end step, and pulls the steps of its own slots in order;
    // a certified query pulls nothing more.
    const bool active = !ADAPTIVE || s_active;
    int seg_end = a.S;
    bool has_end = false;
    for (int c = pos; c < a.S; c += 32) {
      const int i = c + lane;
      const unsigned code = i < a.S ? static_cast<unsigned>(__ldg(a.slotcode + i)) : 0u;
      const unsigned ends = __ballot_sync(kFull, (code & kEndBit) != 0u);
      const int lim = ends ? __ffs(ends) : 32;
      const int slot = static_cast<int>(code & kSlotMask);
      const bool mine = active && lane < lim && (code & kPullBit) != 0u &&
                        slot % kWarps == warp;
      unsigned todo = __ballot_sync(kFull, mine);
      while (todo) {
        const int bit = __ffs(todo) - 1;
        todo &= todo - 1;
        const int s = __shfl_sync(kFull, slot, bit);
        const int col = __ldg(cols + c + bit);
        if (s >= a.n_tiles || col < 0 || col >= a.n_blocks) continue;
        const int tile = surv[s];
        const size_t cell = static_cast<size_t>(tile) * a.n_blocks + col;
        float part;
        if constexpr (TIER == kF32) {
          part = pull_f32(a, static_cast<const float*>(a.V4) + cell * tile_cells,
                          static_cast<const float*>(a.Qb) + q_off +
                              static_cast<size_t>(col) * a.C, lane);
        } else if constexpr (TIER == kPQ) {
          part = pull_pq(a, static_cast<const uint8_t*>(a.V4) + cell * tile_cells,
                         lut + static_cast<size_t>(col) * a.Cs * a.n_codes, lane);
        } else {
          const int8_t* v = static_cast<const int8_t*>(a.V4) + cell * tile_cells;
          const int8_t* q = static_cast<const int8_t*>(a.Qb) + q_off +
                            static_cast<size_t>(col) * a.C;
          const int raw = TIER == kI8 ? pull_i8(a, v, q, lane) : pull_i4(a, v, q, lane);
          const float scale = __fmul_rn(__ldg(a.vscale + cell),
                                        __ldg(a.qscale + static_cast<size_t>(b) * a.n_blocks + col));
          part = __fmul_rn(__int2float_rn(raw), scale);
        }
        if (lane < R) {
          const size_t row = static_cast<size_t>(tile) * R + lane;
          acc[row] = __fadd_rn(acc[row], part);
          if constexpr (TRACK_VAR) acc2[row] = __fadd_rn(acc2[row], __fmul_rn(part, part));
        }
      }
      if (ends) {
        seg_end = c + lim;
        has_end = true;
        break;
      }
    }
    pos = seg_end;
    __syncthreads();
    if (has_end) {
      if (rnd < a.n_rounds) {
        eliminate(a, rnd, acc, surv, tmp, keys);
        if (ADAPTIVE && s_active &&
            certify<TRACK_VAR>(a, rnd, acc, acc2, surv, red_key, red_f)) {
          if (threadIdx.x == 0) {
            s_active = 0;
            s_tstop = __ldg(a.rmeta + 3 * rnd);
            s_rused = rnd + 1;
          }
          __syncthreads();
        }
      }
      ++rnd;
    }
  }
  finalize(a, acc, surv, keys, a.ids + static_cast<size_t>(b) * a.k_out,
           a.vals + static_cast<size_t>(b) * a.k_out,
           ADAPTIVE ? s_tstop : a.t_final);
  if (ADAPTIVE && threadIdx.x == 0) a.rused[b] = s_rused;
}

template <int TIER>
cudaError_t launch_tier(const Args& a, int B, int adaptive, int track_var,
                        cudaStream_t stream) {
  if (!adaptive)
    cascade_kernel<TIER, false, false><<<B, kThreads, 0, stream>>>(a);
  else if (!track_var)
    cascade_kernel<TIER, true, false><<<B, kThreads, 0, stream>>>(a);
  else
    cascade_kernel<TIER, true, true><<<B, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(int tier, const Args& a, int B, int adaptive,
                   int track_var, cudaStream_t stream) {
  switch (tier) {
    case kF32: return launch_tier<kF32>(a, B, adaptive, track_var, stream);
    case kI8: return launch_tier<kI8>(a, B, adaptive, track_var, stream);
    case kI4: return launch_tier<kI4>(a, B, adaptive, track_var, stream);
    case kPQ: return launch_tier<kPQ>(a, B, adaptive, track_var, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The batched entry, for every tier: tier 0 fp32, 1 int8, 2 int4, 3 pq.
// Returns the launch's cudaError_t (0 on success); the wrapper raises on
// anything else.
extern "C" int fused_cascade_batched(
    int tier, int adaptive, int track_var, const void* V4, const void* Qb,
    const float* vscale, const float* qscale, const float* codebook,
    const float* cert, const int* slotcode, const int* rmeta, const int* cols,
    int* ids, float* vals, int* rused, float* acc, float* acc2, int* surv,
    int* tmp, unsigned long long* keys, float* lut, int B, int n_tiles,
    int n_blocks, int R, int C, int Cs, int S, int n_rounds, int t_final,
    int n_final, int k_out, int n_codes, int k_cert, int P, int vec,
    long long n_valid, cudaStream_t stream) {
  Args a{V4, Qb, vscale, qscale, codebook, cert, slotcode, rmeta, cols, ids,
         vals, rused, acc, acc2, surv, tmp, keys, lut, n_tiles, n_blocks, R,
         C, Cs, S, n_rounds, t_final, n_final, k_out, n_codes, k_cert, P, vec,
         n_valid};
  return static_cast<int>(launch(tier, a, B, adaptive, track_var, stream));
}

// The single-query entry (replaces `fused_cascade_pallas`): qb (n_blocks, C),
// qscale (n_blocks,), cols (S,), ids and vals (k_out,), a scalar rused, and
// workspace for one query.  The TPU's two kernels are one `_make_kernel`
// body; here the same templated body runs as one block.  The layouts are
// those of a B = 1 batch, so its outputs equal a B = 1 batched launch bit
// for bit.
extern "C" int fused_cascade(
    int tier, int adaptive, int track_var, const void* V4, const void* qb,
    const float* vscale, const float* qscale, const float* codebook,
    const float* cert, const int* slotcode, const int* rmeta, const int* cols,
    int* ids, float* vals, int* rused, float* acc, float* acc2, int* surv,
    int* tmp, unsigned long long* keys, float* lut, int n_tiles,
    int n_blocks, int R, int C, int Cs, int S, int n_rounds, int t_final,
    int n_final, int k_out, int n_codes, int k_cert, int P, int vec,
    long long n_valid, cudaStream_t stream) {
  Args a{V4, qb, vscale, qscale, codebook, cert, slotcode, rmeta, cols, ids,
         vals, rused, acc, acc2, surv, tmp, keys, lut, n_tiles, n_blocks, R,
         C, Cs, S, n_rounds, t_final, n_final, k_out, n_codes, k_cert, P, vec,
         n_valid};
  return static_cast<int>(launch(tier, a, 1, adaptive, track_var, stream));
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
