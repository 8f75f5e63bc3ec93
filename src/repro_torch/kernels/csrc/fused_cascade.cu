// Fused BoundedME cascade for Hopper (sm_90a), fp32 tier.
//
// Replaces `fused_cascade_batched_pallas` (src/repro/kernels/fused_cascade.py,
// kernel body `_make_kernel`, scratch `_scratch`) for float32 tables: one
// launch runs the whole multi-round cascade of a (B, N) query batch, from
// the first pull to the final top-k_out extraction.
//
// What bounds it.  Every pull reads one (R, C) fp32 tile of the table and
// does 2 flops per 4 bytes, so the work is memory-bound: the least time is
// the pulled bytes over the card's memory rate.  This first version runs one
// block per query, so a batch of B queries occupies B of the 132 SMs and the
// rate one SM can load at, not HBM, limits it.  Reading each pulled tile
// once for all queries of a batch (they share one block permutation) is
// where a later version gains.
//
// What the design does.
//  * The TPU kernel's sequential (B, S) grid becomes one block per query
//    that loops over the flat schedule.  Its VMEM/SMEM scratch (accumulator,
//    survivor list, score buffer) does not fit in shared memory at real table
//    sizes, so it lives in per-query device workspace that the wrapper
//    allocates; at a few MB per batch it stays in L2.
//  * Within a round the survivor list is fixed and every tile receives only
//    its own pulls.  Warp w takes the steps whose survivor slot is
//    congruent to w modulo the warp count and walks them in step order, so
//    each tile's sum is accumulated in column order exactly as on the TPU;
//    the block synchronises only at round ends.
//  * A pull is a plain fp32 FMA dot of the (R, C) tile with the query block
//    on CUDA cores (no TF32, no tensor cores): each lane loads float4s of
//    every row, then a butterfly of shuffles reduces each row.
//  * Elimination keeps the top n_keep slots by (score descending, slot
//    ascending) and writes them in that order, which is what the TPU
//    kernel's iterative max extraction with NaN marking produces.  The
//    pair is packed into one 64-bit key (order-preserving float bits, then
//    the complemented slot) and sorted by a block-wide bitonic sort.  The
//    final top-k_out over the n_final * R surviving rows uses the same sort.
//  * The kernel returns unscaled block means, like the TPU kernel; the
//    caller applies the padding rescale.

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

struct Args {
  const float* V4;      // (n_tiles, n_blocks, R, C)
  const float* Qb;      // (B, n_blocks, C)
  const int* slotcode;  // (S,)
  const int* rmeta;     // (n_rounds + 1, 3): t_cum, n_surv, n_keep
  const int* cols;      // (B, S)
  int* ids;             // (B, k_out)
  float* vals;          // (B, k_out)
  float* acc;           // workspace (B, n_tiles, R)
  int* surv;            // workspace (B, n_tiles)
  int* tmp;             // workspace (B, n_tiles)
  unsigned long long* keys;  // workspace (B, P)
  int n_tiles, n_blocks, R, C, S, n_rounds, t_final, n_final, k_out;
  long long n_valid;
  int P;
  int vec;              // 1: R == 8, C in {128, 256, 512}, 16-byte aligned
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

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
__device__ float pull_any(const float* __restrict__ v,
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

__device__ __forceinline__ float pull(const Args& a, const float* v,
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
  return pull_any(v, q, a.R, a.C, lane);
}

// Descending order of the key is (score descending, index ascending).
// -0.0 and +0.0 compare equal, as they do in the TPU kernel's max.
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

// Top k_out of the n_final * R rows of the final survivors.
__device__ void finalize(const Args& a, const float* acc, const int* surv,
                         unsigned long long* keys, int* ids, float* vals) {
  const int R = a.R;
  const float denom = static_cast<float>(max(1, a.t_final) * a.C);
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

__global__ void __launch_bounds__(kThreads, 1) fused_cascade_f32(Args a) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = a.R, C = a.C;
  float* acc = a.acc + static_cast<size_t>(b) * a.n_tiles * R;
  int* surv = a.surv + static_cast<size_t>(b) * a.n_tiles;
  int* tmp = a.tmp + static_cast<size_t>(b) * a.n_tiles;
  unsigned long long* keys = a.keys + static_cast<size_t>(b) * a.P;
  const int* cols = a.cols + static_cast<size_t>(b) * a.S;
  const float* q = a.Qb + static_cast<size_t>(b) * a.n_blocks * C;
  const size_t tile_elems = static_cast<size_t>(R) * C;

  for (size_t i = threadIdx.x; i < static_cast<size_t>(a.n_tiles) * R; i += kThreads)
    acc[i] = 0.f;
  for (int j = threadIdx.x; j < a.n_tiles; j += kThreads) surv[j] = j;
  __syncthreads();

  int pos = 0, rnd = 0;
  while (pos < a.S) {
    // Every warp scans the same segment of steps, up to and including the
    // next round-end step, and pulls the steps of its own slots in order.
    int seg_end = a.S;
    bool has_end = false;
    for (int c = pos; c < a.S; c += 32) {
      const int i = c + lane;
      const unsigned code = i < a.S ? static_cast<unsigned>(__ldg(a.slotcode + i)) : 0u;
      const unsigned ends = __ballot_sync(kFull, (code & kEndBit) != 0u);
      const int lim = ends ? __ffs(ends) : 32;
      const int slot = static_cast<int>(code & kSlotMask);
      const bool mine = lane < lim && (code & kPullBit) != 0u && slot % kWarps == warp;
      unsigned todo = __ballot_sync(kFull, mine);
      while (todo) {
        const int bit = __ffs(todo) - 1;
        todo &= todo - 1;
        const int s = __shfl_sync(kFull, slot, bit);
        const int col = __ldg(cols + c + bit);
        if (s >= a.n_tiles || col < 0 || col >= a.n_blocks) continue;
        const int tile = surv[s];
        const float* v = a.V4 + (static_cast<size_t>(tile) * a.n_blocks + col) * tile_elems;
        const float part = pull(a, v, q + static_cast<size_t>(col) * C, lane);
        if (lane < R) acc[static_cast<size_t>(tile) * R + lane] += part;
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
      if (rnd < a.n_rounds) eliminate(a, rnd, acc, surv, tmp, keys);
      ++rnd;
    }
  }
  finalize(a, acc, surv, keys, a.ids + static_cast<size_t>(b) * a.k_out,
           a.vals + static_cast<size_t>(b) * a.k_out);
}

}  // namespace

extern "C" int fused_cascade_batched_f32(
    const float* V4, const float* Qb, const int* slotcode, const int* rmeta,
    const int* cols, int* ids, float* vals, float* acc, int* surv, int* tmp,
    unsigned long long* keys, int B, int n_tiles, int n_blocks, int R, int C,
    int S, int n_rounds, int t_final, int n_final, int k_out,
    long long n_valid, int P, int vec, cudaStream_t stream) {
  Args a{V4, Qb, slotcode, rmeta, cols, ids, vals, acc, surv, tmp, keys,
         n_tiles, n_blocks, R, C, S, n_rounds, t_final, n_final, k_out,
         n_valid, P, vec};
  fused_cascade_f32<<<B, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_cascade_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
