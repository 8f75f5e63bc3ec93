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
// the output) over the card's memory rate.
//
// What the design does.  One block of 8 warps per tile_n rows; warp w takes
// rows w, w + 8, ... and for each row walks the d / tile_d slabs in order:
// a coalesced dot of the slab (16-byte loads where aligned, row_dot.cuh),
// a warp reduction, then one f32 add into the row's sum, as the TPU grid's
// inner axis adds its tiles.  The wrapper refuses shapes the tiles do not
// divide before any launch, as the TPU wrapper does.  No tensor cores: a
// matvec does two operations per loaded entry, far below what they need.

#include "row_dot.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads) matvec_kernel(
    const T* __restrict__ W, const T* __restrict__ q, float* __restrict__ out,
    int d, int tile_n, int tile_d, int vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * tile_n;
  for (int r = warp; r < tile_n; r += kWarps) {
    const T* w = W + (row0 + r) * static_cast<size_t>(d);
    float acc = 0.f;
    for (int j = 0; j < d; j += tile_d)
      acc += rowdot::warp_sum(
          rowdot::row_dot<T>(w + j, q + j, tile_d, vec != 0, lane));
    if (lane == 0) out[row0 + r] = acc;
  }
}

}  // namespace

// dtype 0: f32 operands, 1: bf16.  n % tile_n == 0 and d % tile_d == 0 (the
// wrapper checks).  Returns the launch's cudaError_t.
extern "C" int blocked_matvec(int dtype, const void* W, const void* q,
                              float* out, int n, int d, int tile_n, int tile_d,
                              int vec, cudaStream_t stream) {
  if (n == 0) return 0;
  const int grid = n / tile_n;
  if (dtype == 0)
    matvec_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(W), static_cast<const float*>(q), out, d,
        tile_n, tile_d, vec);
  else if (dtype == 1)
    matvec_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(W),
        static_cast<const __nv_bfloat16*>(q), out, d, tile_n, tile_d, vec);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
