// Gathered tile-dots for Hopper (sm_90a), f32 or bf16 operands:
//
//     out[t, r] = sum_b  V4[idx[t], cols[b], r, :] . qsel[b, :]     (T, R) f32
//
// Replaces `gather_block_dot_pallas` (src/repro/kernels/gather_dot.py), the
// per-round pull step of BoundedME before the cascade was fused.
//
// What bounds it.  Each gathered (R, C) cell is read once and each entry
// takes one multiply-add, so the work is memory-bound: the least time is
// the gathered bytes (T * dt * R * C entries, plus qsel, idx, cols and the
// output) over the card's memory rate, 3.35 TB/s.  A cell is small (2 KB
// at C = 128 in bf16), so a block per tile that loads one 16-byte vector a
// lane and then reduces keeps too few bytes in flight to reach that rate.
//
// What the design does (stream.cuh, repro_torch/kernels/stream.py).  The
// TPU grid (T, dt) gathers one cell per step through scalar-prefetched
// idx/cols and carries out[t] across the inner axis.  Here:
//  * A persistent grid of min(chunks, SMs x CTAs per SM) CTAs.  Chunk c
//    is the `chunk` tiles from tile c * chunk on, the whole tiles about
//    one stage holds (stream.py); CTA i takes chunks i, i + grid, ... and
//    walks each chunk's (t, b) cells in order.  Block 0 writes gridDim.x
//    to grid_out.
//  * Bulk branch: the producer warp's lanes read idx and cols and copy
//    whole cells (one contiguous span each) into a ring of S stages, `rows`
//    cells a stage, one 1-D bulk copy per cell, and note the stage's chunk
//    and each cell's block b beside it.  A cell whose tile or column index is
//    out of range is not copied (a copy from a wild address faults) and
//    noted -1: its rows come out NaN.  The notes are written before the
//    arrive that sets the stage's bytes: a stage of no valid cell expects
//    none and completes on that arrive.
//  * qsel is copied into shared memory once per CTA.  Consumers read only
//    shared memory: one dot per cell row, over `group` lanes (about eight
//    16-byte vectors a lane: 2 lanes a row at C = 128 in bf16, so a warp
//    reduces 16 rows at once in one step), partial sums to shared memory;
//    after one barrier of the consumer warps one thread per row adds its
//    cells in order b = 0 ... dt - 1, as the TPU's inner axis does,
//    carrying the sum from stage to stage within the chunk.
//  * Plain-load branch (ldg), for a V4 whose pointer or row bytes are not
//    16-byte aligned: the same grid, chunks, stages and sums (the ring
//    carries the notes only), each entry loaded from device memory.
// Repeated idx entries are allowed: each is its own gathered tile.

#include "stream.cuh"

namespace {

using namespace stream;

struct Args {
  const void* V4;
  const int* idx;
  const int* cols;
  const void* qsel;
  float* out;
  int* grid_out;       // (1,): block 0 writes gridDim.x here
  int T, n_tiles, n_blocks, R, C, dt, n_chunks;
  int chunk, rows, stages, stage_bytes, group, pairs;
  int info_off, ring_off, q_off, part_off, carry_off;
};

// the cell (t, b) of V4, or -1 where idx[t] or cols[b] is out of range
__device__ __forceinline__ long long cell_of(const Args& a, int t, int b) {
  const int tile = __ldg(a.idx + t), col = __ldg(a.cols + b);
  if (tile < 0 || tile >= a.n_tiles || col < 0 || col >= a.n_blocks) return -1;
  return static_cast<long long>(tile) * a.n_blocks + col;
}

template <typename T, bool BULK>
__global__ void __launch_bounds__(kThreads) gather_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const T* V4 = static_cast<const T*>(a.V4);
  const T* qsel = static_cast<const T*>(a.qsel);
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.grid_out = gridDim.x;
  const int dt = a.dt, R = a.R, C = a.C;
  const size_t cell_elems = static_cast<size_t>(R) * C;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + a.stages;
  // per ring slot: chunk (-1: no more work), stage, and on the bulk branch
  // two notes per cell (below)
  const int slot_ints = kSlotInts + (BULK ? 2 * a.rows : 0);
  int* info = reinterpret_cast<int*>(smem + a.info_off);
  unsigned char* ring = smem + a.ring_off;
  T* qs = reinterpret_cast<T*>(smem + a.q_off);
  float* part = reinterpret_cast<float*>(smem + a.part_off);
  float* carry = reinterpret_cast<float*>(smem + a.carry_off);
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      bar_init(full + i, 1);
      bar_init(empty + i, kConsumerWarps);
    }
    fence_bar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {            // the producer warp
    // The warp walks the CTA's chunks; lane 0 notes each stage and arrives
    // on its slot, and on the bulk branch the lanes look up a stage's cells
    // and copy them in parallel.
    const int pl = threadIdx.x - kConsumers;
    const uint32_t cell_bytes = static_cast<uint32_t>(cell_elems * sizeof(T));
    int s = 0, t0, t1;
    for (int c = blockIdx.x; c < a.n_chunks; c += gridDim.x) {
      chunk_span(c, a.chunk, a.T, &t0, &t1);
      const int n_items = (t1 - t0) * dt;
      for (int i0 = 0, sl = 0; i0 < n_items; i0 += a.rows, ++sl, ++s) {
        const int slot = s % a.stages;
        if (s >= a.stages) wait(empty + slot, ((s / a.stages) - 1) & 1);
        int* note = info + slot * slot_ints;
        // Every note of the slot is written before lane 0's arrive below:
        // the arrive releases them, and a stage that expects no bytes (no
        // valid cell) completes on it.
        if (pl == 0) {
          note[0] = c;
          note[1] = sl;
        }
        if (BULK) {
          // note[kSlotInts + j]: cell j's block b, or -1 where it is not
          // copied; note[kSlotInts + rows + j]: the cell's index in V4
          int* cell_b = note + kSlotInts;
          int* cell_at = cell_b + a.rows;
          const int cnt = min(a.rows, n_items - i0);
          int valid = 0;
          for (int j = pl; j < cnt; j += 32) {
            const int item = i0 + j, b = item % dt;
            const long long cell = cell_of(a, t0 + item / dt, b);
            cell_b[j] = cell >= 0 ? b : -1;
            cell_at[j] = static_cast<int>(cell);
            valid += cell >= 0;
          }
          valid = __reduce_add_sync(kFull, valid);
          __syncwarp();                 // the lanes' notes before the arrive
          if (pl == 0) arrive_expect(full + slot, valid * cell_bytes);
          __syncwarp();                 // the bytes expected before a copy
          unsigned char* dst =
              ring + static_cast<size_t>(slot) * a.stage_bytes;
          for (int j = pl; j < cnt; j += 32) {
            const int cell = cell_at[j];
            if (cell >= 0)
              bulk_copy(dst + static_cast<size_t>(j) * cell_bytes,
                        V4 + static_cast<size_t>(cell) * cell_elems,
                        cell_bytes, full + slot);
          }
        } else if (pl == 0) {
          arrive(full + slot);
        }
      }
      // the next chunk's idx entries, fetched while the consumers drain
      // this one
      if (pl == 0 && c + gridDim.x < a.n_chunks)
        prefetch_l1(a.idx + (c + gridDim.x) * a.chunk);
    }
    const int slot = s % a.stages;            // no more work
    if (s >= a.stages) wait(empty + slot, ((s / a.stages) - 1) & 1);
    if (pl == 0) {
      info[slot * slot_ints] = -1;
      arrive(full + slot);
    }
    return;
  }

  if (BULK) {
    // the query blocks, while the first copies are in flight
    for (int i = threadIdx.x; i < dt * C; i += kConsumers) qs[i] = qsel[i];
    consumers_sync();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = a.group, per_warp = 32 / group;
  const int gi = lane / group, gl = lane % group;
  const int n_groups = kConsumerWarps * per_warp;
  const int n16 = C * static_cast<int>(sizeof(T)) / 16;
  const int rot = BULK && n16 % group == 0 ? (lane - gl) % n16 : 0;
  for (int s = 0;; ++s) {
    const int slot = s % a.stages;
    wait(full + slot, (s / a.stages) & 1);
    const int* note = info + slot * slot_ints;
    if (note[0] < 0) break;
    int t0, t1;
    chunk_span(note[0], a.chunk, a.T, &t0, &t1);
    const int n_items = (t1 - t0) * dt;
    const int i0 = note[1] * a.rows, cnt = min(a.rows, n_items - i0);
    const int pairs = cnt * R;
    const T* src = reinterpret_cast<const T*>(
        ring + static_cast<size_t>(slot) * a.stage_bytes);
    float* pb = part + (s & 1) * a.pairs;
    // dot p of the stage: row p % R of cell i0 + p / R, at p * C
    for (int base = warp * per_warp; base < pairs; base += n_groups) {
      const int p = base + gi;
      float v = 0.f;
      bool bad = false;
      if (p < pairs) {
        const int j = p / R;
        if (BULK) {
          const int b = note[kSlotInts + j];
          bad = b < 0;
          if (!bad)
            v = dot_shared<T>(src + static_cast<size_t>(p) * C,
                              qs + static_cast<size_t>(b) * C, n16, gl, group,
                              rot);
        } else {
          const int item = i0 + j, b = item % dt;
          const long long cell = cell_of(a, t0 + item / dt, b);
          bad = cell < 0;
          if (!bad)
            v = dot_global<T>(
                V4 + (cell * R + (p - j * R)) * static_cast<size_t>(C),
                qsel + static_cast<size_t>(b) * C, C, gl, group);
        }
      }
      v = group_sum(v, group);
      if (p < pairs && gl == 0) pb[p] = bad ? __int_as_float(0x7fffffff) : v;
    }
    __syncwarp();
    if (lane == 0) arrive(empty + slot);
    consumers_sync();
    // each row's cells in block order, the sum carried across stages
    for (int r = threadIdx.x; r < R; r += kConsumers) {
      float acc = carry[r];
      for (int j = 0; j < cnt; ++j) {
        const int item = i0 + j, b = item % dt;
        if (b == 0) acc = 0.f;
        acc += pb[j * R + r];
        if (b == dt - 1)
          a.out[static_cast<size_t>(t0 + item / dt) * R + r] = acc;
      }
      carry[r] = acc;
    }
  }
}

template <typename T, bool BULK>
cudaError_t launch_inst(const Args& a, int grid, int smem,
                        cudaStream_t stream) {
  cudaError_t err = set_smem<gather_kernel<T, BULK>>(smem);
  if (err != cudaSuccess) return err;
  gather_kernel<T, BULK><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t config(int bulk, int smem, int* sms, int* per_sm) {
  return bulk ? occupancy<gather_kernel<T, true>>(smem, sms, per_sm)
              : occupancy<gather_kernel<T, false>>(smem, sms, per_sm);
}

}  // namespace

// How many CTAs of a launch with this dtype (0 f32, 1 bf16), branch and
// dynamic shared memory fit on one SM, and the SM count.
extern "C" int gather_block_dot_config(int dtype, int bulk, int smem,
                                       int* sms, int* per_sm) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dtype == 0 ? config<float>(bulk, smem, sms, per_sm)
                                     : config<__nv_bfloat16>(bulk, smem, sms,
                                                             per_sm));
}

// dtype 0: f32 operands, 1: bf16; idx holds T tiles, cols dt blocks; the
// geometry (bulk ... smem) is the wrapper's GEOMETRY fields of a
// stream.Stream.  Returns the
// launch's cudaError_t.
extern "C" int gather_block_dot(int dtype, const void* V4, const int* idx,
                                const int* cols, const void* qsel, float* out,
                                int* grid_out, int T, int grid,
                                int n_tiles, int n_blocks, int R, int C,
                                int dt, int bulk, int chunk, int rows,
                                int stages, int stage_bytes, int group,
                                int pairs, int info_off, int ring_off,
                                int q_off, int part_off, int carry_off,
                                int smem, cudaStream_t stream) {
  if (grid == 0) return 0;
  Args a{V4,       idx,      cols,     qsel,   out,
         grid_out, T,        n_tiles,  n_blocks,
         R,        C,        dt,       (T + chunk - 1) / chunk,
         chunk,    rows,     stages,   stage_bytes, group,
         pairs,    info_off, ring_off, q_off,  part_off, carry_off};
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
