// Exact blocked matvec for Hopper (sm_90a), f32 or bf16 operands:
//
//     out = W @ q,   W (n, d), q (d,)  ->  out (n,) f32
//
// Replaces `blocked_matvec_pallas` (src/repro/kernels/blocked_matvec.py):
// the exhaustive MIPS baseline and the roofline comparator of the bandit
// kernel.  The TPU kernel runs a (n / tile_n, d / tile_d) grid of
// (tile_n, tile_d) tiles and carries each row's f32 sum across the d tiles.
//
// What bounds it.  Every entry of W is read once for one multiply-add, so
// the work is memory-bound: the least time is the bytes of W (plus q and
// the output) over the card's memory rate, 3.35 TB/s.  To keep that rate a
// card needs some 25 KB in flight per SM without a break; a grid of one
// block per tile_n rows leaves a tail where only part of the SMs stream,
// and a warp that loads, then stops to reduce, leaves gaps.
//
// What the design does (stream.cuh, repro_torch/kernels/stream.py).
//  * A persistent grid of min(chunks, SMs x CTAs per SM) CTAs.  Chunk c
//    is the `rows` rows of one stage from row c * rows on (stream.py);
//    CTA i takes chunks i, i + grid, i + 2 grid, ...  SMs do not stream at
//    one rate: with one contiguous range per CTA the fastest CTAs finished
//    a quarter of the run early; interleaved chunks of one stage keep
//    every SM streaming until the last round of chunks.  Block 0 writes
//    gridDim.x to grid_out.
//  * Bulk branch: one producer lane copies W into a ring of S stages
//    (about 64 KB per CTA), one 1-D bulk copy per stage: `rows` whole rows,
//    or `slabs` tile_d slabs of one row where a row exceeds a stage, and
//    notes the stage's chunk beside it.  The copies run ahead of the
//    consumers by up to S stages, with no load instruction and no
//    register in the consumers' way.
//  * q is copied into shared memory once per CTA.  Consumers read only
//    shared memory: one dot per (row, slab), over `group` lanes (about
//    eight 16-byte vectors a lane: 16 lanes for a 512-wide f32 slab, so a
//    warp reduces two dots at once in four steps), partial sums to shared
//    memory; after one barrier of the consumer warps each row's slab sums
//    are added in slab order b = 0 ... d / tile_d - 1, as the TPU grid's
//    inner axis adds its tiles.  A row split over stages carries its sum
//    from stage to stage.
//  * Plain-load branch (ldg), for a W whose pointer or slab bytes are not
//    16-byte aligned: the same grid, chunks, stages and sums (the ring
//    carries the notes only), each entry loaded from device memory.
// The wrapper refuses shapes the tiles do not divide before any launch, as
// the TPU wrapper does.  No tensor cores: a matvec does two operations per
// loaded entry, far below what they need.

#include "stream.cuh"

namespace {

using namespace stream;

struct Args {
  const void* W;
  const void* q;
  float* out;
  int* grid_out;       // (1,): block 0 writes gridDim.x here
  int n, d, tile_d, n_slabs, n_chunks;   // chunk c: rows [c, c + 1) * rows
  int rows, slabs, stages, stage_bytes, group, pairs;
  int info_off, ring_off, q_off, part_off;
};

// Stage sl of chunk c: its `rows` rows starting at `row`, slabs
// [s0, s0 + sh) of each; `first` / `last` where the stage begins or ends
// its rows' sums.  A chunk of whole rows is one stage; a chunk of one row
// longer than a stage is `pieces` stages of `slabs` slabs.
struct Stage {
  int row, rows, s0, sh;
  bool first, last;
};

__device__ __forceinline__ int pieces_of(const Args& a) {
  return (a.n_slabs + a.slabs - 1) / a.slabs;
}

__device__ __forceinline__ Stage stage_of(const Args& a, int c, int sl) {
  Stage st;
  int r1;
  chunk_span(c, a.rows, a.n, &st.row, &r1);
  st.rows = r1 - st.row;
  st.s0 = sl * a.slabs;
  st.sh = min(a.slabs, a.n_slabs - st.s0);
  st.first = sl == 0;
  st.last = sl == pieces_of(a) - 1;
  return st;
}

template <typename T, bool BULK>
__global__ void __launch_bounds__(kThreads) matvec_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const T* W = static_cast<const T*>(a.W);
  const T* q = static_cast<const T*>(a.q);
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.grid_out = gridDim.x;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + a.stages;
  // per ring slot: chunk (-1: no more work), stage
  int* info = reinterpret_cast<int*>(smem + a.info_off);
  unsigned char* ring = smem + a.ring_off;
  T* qs = reinterpret_cast<T*>(smem + a.q_off);
  float* part = reinterpret_cast<float*>(smem + a.part_off);
  const size_t d = a.d;
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      bar_init(full + i, 1);
      bar_init(empty + i, kConsumerWarps);
    }
    fence_bar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {            // the producer warp
    if (threadIdx.x == kConsumers) {
      int s = 0;
      const int n_sl = pieces_of(a);
      for (int c = blockIdx.x; c < a.n_chunks; c += gridDim.x) {
        for (int sl = 0; sl < n_sl; ++sl, ++s) {
          const int slot = s % a.stages;
          if (s >= a.stages) wait(empty + slot, ((s / a.stages) - 1) & 1);
          int* note = info + kSlotInts * slot;
          note[0] = c;
          note[1] = sl;
          if (BULK) {
            const Stage st = stage_of(a, c, sl);
            const uint32_t bytes = static_cast<uint32_t>(st.rows) * st.sh *
                                   a.tile_d * sizeof(T);
            arrive_expect(full + slot, bytes);
            bulk_copy(ring + static_cast<size_t>(slot) * a.stage_bytes,
                      W + st.row * d + static_cast<size_t>(st.s0) * a.tile_d,
                      bytes, full + slot);
          } else {
            arrive(full + slot);
          }
        }
      }
      const int slot = s % a.stages;          // no more work
      if (s >= a.stages) wait(empty + slot, ((s / a.stages) - 1) & 1);
      info[kSlotInts * slot] = -1;
      arrive(full + slot);
    }
    return;
  }

  if (BULK) {
    // the query, while the first copies are in flight
    for (int i = threadIdx.x; i < a.d; i += kConsumers) qs[i] = q[i];
    consumers_sync();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = a.group, per_warp = 32 / group;
  const int gi = lane / group, gl = lane % group;
  const int n_groups = kConsumerWarps * per_warp;
  const int n16 = a.tile_d * static_cast<int>(sizeof(T)) / 16;
  const int rot = BULK && n16 % group == 0 ? (lane - gl) % n16 : 0;
  float carry = 0.f;
  for (int s = 0;; ++s) {
    const int slot = s % a.stages;
    wait(full + slot, (s / a.stages) & 1);
    const int* note = info + kSlotInts * slot;
    if (note[0] < 0) break;
    const Stage st = stage_of(a, note[0], note[1]);
    const int pairs = st.rows * st.sh;
    const T* src =
        BULK ? reinterpret_cast<const T*>(ring + static_cast<size_t>(slot) *
                                                     a.stage_bytes)
             : W + st.row * d + static_cast<size_t>(st.s0) * a.tile_d;
    float* pb = part + (s & 1) * a.pairs;
    // dot p of the stage: row p / sh, slab s0 + p % sh, at p * tile_d
    for (int base = warp * per_warp; base < pairs; base += n_groups) {
      const int p = base + gi;
      float v = 0.f;
      if (p < pairs) {
        const int qo = (st.s0 + p % st.sh) * a.tile_d;
        const T* vp = src + static_cast<size_t>(p) * a.tile_d;
        v = BULK ? dot_shared<T>(vp, qs + qo, n16, gl, group, rot)
                 : dot_global<T>(vp, q + qo, a.tile_d, gl, group);
      }
      v = group_sum(v, group);
      if (p < pairs && gl == 0) pb[p] = v;
    }
    __syncwarp();
    if (lane == 0) arrive(empty + slot);
    consumers_sync();
    // each row's slab sums in slab order; only a one-row stage carries
    for (int j = threadIdx.x; j < st.rows; j += kConsumers) {
      float v = st.first ? 0.f : carry;
      for (int b = 0; b < st.sh; ++b) v += pb[j * st.sh + b];
      if (st.last)
        a.out[st.row + j] = v;
      else
        carry = v;
    }
  }
}

template <typename T, bool BULK>
cudaError_t launch_inst(const Args& a, int grid, int smem,
                        cudaStream_t stream) {
  cudaError_t err = set_smem<matvec_kernel<T, BULK>>(smem);
  if (err != cudaSuccess) return err;
  matvec_kernel<T, BULK><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t config(int bulk, int smem, int* sms, int* per_sm) {
  return bulk ? occupancy<matvec_kernel<T, true>>(smem, sms, per_sm)
              : occupancy<matvec_kernel<T, false>>(smem, sms, per_sm);
}

}  // namespace

// How many CTAs of a launch with this dtype (0 f32, 1 bf16), branch and
// dynamic shared memory fit on one SM, and the SM count.
extern "C" int blocked_matvec_config(int dtype, int bulk, int smem, int* sms,
                                     int* per_sm) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dtype == 0 ? config<float>(bulk, smem, sms, per_sm)
                                     : config<__nv_bfloat16>(bulk, smem, sms,
                                                             per_sm));
}

// dtype 0: f32 operands, 1: bf16.  W is (n, d), d % tile_d == 0 (the
// wrapper checks); the geometry (bulk ... smem) is the wrapper's GEOMETRY
// fields of a stream.Stream.  Returns the launch's cudaError_t.
extern "C" int blocked_matvec(int dtype, const void* W, const void* q,
                              float* out, int* grid_out, int n,
                              int grid, int d, int tile_d, int bulk,
                              int rows, int slabs, int stages,
                              int stage_bytes, int group, int pairs,
                              int info_off, int ring_off, int q_off,
                              int part_off, int smem, cudaStream_t stream) {
  if (grid == 0) return 0;
  Args a{W,      q,           out,   grid_out,
         n,      d,           tile_d, d / tile_d, (n + rows - 1) / rows,
         rows,   slabs,       stages, stage_bytes, group,
         pairs,  info_off,    ring_off, q_off,   part_off};
  cudaError_t err;
  if (dtype == 0)
    err = bulk ? launch_inst<float, true>(a, grid, smem, stream)
               : launch_inst<float, false>(a, grid, smem, stream);
  else if (dtype == 1)
    err = bulk ? launch_inst<__nv_bfloat16, true>(a, grid, smem, stream)
               : launch_inst<__nv_bfloat16, false>(a, grid, smem, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
