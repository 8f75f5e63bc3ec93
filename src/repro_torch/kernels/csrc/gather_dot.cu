// Gathered tile-dots for Hopper (sm_90a), f32 or bf16 operands:
//
//     out[t, r] = sum_b  V4[idx[t], cols[b], r, :] . qsel[b, :]     (T, R) f32
//
// Replaces `gather_block_dot_pallas` (src/repro/kernels/gather_dot.py), the
// per-round pull step of BoundedME before the cascade was fused.
//
// What bounds it.  Each gathered (R, C) tile is read once and each entry
// takes one multiply-add, so the work is memory-bound: the least time is
// the gathered bytes (T * dt * R * C entries, plus qsel, idx, cols and the
// output) over the card's memory rate.
//
// What the design does.  The TPU grid (T, dt) gathers one tile per step
// through scalar-prefetched idx/cols and carries out[t] across the inner
// axis.  Here one block of 8 warps takes one gathered tile t and reads idx
// and cols itself; warp w takes rows w, w + 8, ... and, for each row, walks
// the dt blocks in order b = 0 ... dt - 1 as the TPU's inner axis does: a
// coalesced row dot (16-byte loads where aligned, row_dot.cuh), a warp
// reduction, then one f32 add into the row's sum.  19,200 tiles at the
// qwen1.5-0.5b table are enough blocks to keep every SM loading.  A tile
// or column index out of range gives NaN rows rather than a stray read.

#include "row_dot.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads) gather_dot_kernel(
    const T* __restrict__ V4, const int* __restrict__ idx,
    const int* __restrict__ cols, const T* __restrict__ qsel,
    float* __restrict__ out, int n_tiles, int n_blocks, int R, int C, int dt,
    int vec) {
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = __ldg(idx + t);
  for (int r = warp; r < R; r += kWarps) {
    float acc = 0.f;
    for (int b = 0; b < dt; ++b) {
      const int col = __ldg(cols + b);
      if (tile < 0 || tile >= n_tiles || col < 0 || col >= n_blocks) {
        acc = __int_as_float(0x7fffffff);
        break;
      }
      const size_t cell = static_cast<size_t>(tile) * n_blocks + col;
      const T* v = V4 + (cell * R + r) * static_cast<size_t>(C);
      acc += rowdot::warp_sum(rowdot::row_dot<T>(
          v, qsel + static_cast<size_t>(b) * C, C, vec != 0, lane));
    }
    if (lane == 0) out[static_cast<size_t>(t) * R + r] = acc;
  }
}

}  // namespace

// dtype 0: f32 operands, 1: bf16.  Returns the launch's cudaError_t.
extern "C" int gather_block_dot(int dtype, const void* V4, const int* idx,
                                const int* cols, const void* qsel, float* out,
                                int n_tiles, int n_blocks, int R, int C, int T,
                                int dt, int vec, cudaStream_t stream) {
  if (T == 0) return 0;
  if (dtype == 0)
    gather_dot_kernel<float><<<T, kThreads, 0, stream>>>(
        static_cast<const float*>(V4), idx, cols,
        static_cast<const float*>(qsel), out, n_tiles, n_blocks, R, C, dt,
        vec);
  else if (dtype == 1)
    gather_dot_kernel<__nv_bfloat16><<<T, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(V4), idx, cols,
        static_cast<const __nv_bfloat16*>(qsel), out, n_tiles, n_blocks, R, C,
        dt, vec);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
