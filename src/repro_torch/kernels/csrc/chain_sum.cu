// Chain sums of a bf16 tensor over its leading dimensions for Hopper
// (sm_90a), in the order of XLA's CPU reduce:
//
//     g (d_0, ..., d_{k-1}, W) contiguous, k <= 4  ->  out (W,)
//
// each add taken in f32 and rounded to bf16.
//
// Replaces no TPU kernel.  It is the port's counterpart of the bf16
// `reduce` that the JAX package's program asks for where it transposes
// the broadcast of a bf16 bias (`q + bq` in `_qkv`, `b_up` and `b_down`
// in `mlp`, whisper's `enc_pos`, mamba2's `D`): XLA's StableHLO is
// `stablehlo.reduce` with a bf16 init and a bf16 `add`, which XLA's CPU
// build runs as one f32 add and one conversion back to bf16 per element.  Its order: where no
// reduced dimension exceeds 32, one chain over the leading dimensions in
// row-major order; otherwise (XLA's tree reduction) windows of 32 along
// each dimension longer than 32 (the whole of a shorter one), padded with
// zeros split low and high, each window a chain in row-major order, and
// then the same again over the grid of window sums.  PyTorch's own sums
// accumulate a bf16 tensor in f32 and round once, which is another
// program; a loop of 16-bit tensor adds is this one but makes one launch
// per row.
//
// One launch is one pass: `chain_sum` sums each window of a (G, w, pad, n)
// pass (kernels/chain_sum.py::passes plans them on the host, the last pass
// being one window over the whole grid) into out (n_0, ..., n_{k-1}, W).
//
// What bounds it.  Each input element is read once for one add, so the
// least time is the bytes moved (2 rows W + 2 W) over the card's memory
// rate, 3.35 TB/s.  The sum of one window is a chain of dependent adds that
// no reordering may shorten: its latency, w adds of some 4 cycles each plus
// the conversions, is the floor of one thread's work.
//
// What the design does.  One thread per (window, column) walks the window
// in order: adjacent threads read adjacent columns, so a warp's loads of
// one element are one coalesced read.  Blocks of 64 threads over the
// columns (gridDim.x) and the windows (gridDim.y) spread the work over as
// many SMs as there are column groups times windows.  The window is
// clipped to the grid first (the padding's zeros are skipped: adding +0 to
// a sum that starts at +0 changes nothing), which leaves a box walked row
// by row, a row being its extent along the last leading dimension (at most
// 32, XLA's window): a row's loads are issued together, into registers,
// while the chain of the row before runs, so the chain waits on no load
// but the first.  No shared memory, no atomics, no reordering: the result
// is bitwise the plain version's (`kernels/ref.py::chain_sum_ref`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kRow = 32;       // the most elements of a row: XLA's window
constexpr int kDims = 4;       // leading dimensions, ones put in front

struct Pass {
  long long G[kDims];   // the grid this pass reads
  long long w[kDims];   // window extents
  long long p[kDims];   // zeros padded below each dimension
  long long n[kDims];   // windows along each dimension
  long long W, windows;
};

using T = __nv_bfloat16;

// Row `row` of a window's box (m <= kRow elements, W apart) into v.
__device__ __forceinline__ void load_row(const T* __restrict__ row,
                                         long long W, int m, T (&v)[kRow]) {
#pragma unroll
  for (int t = 0; t < kRow; ++t)
    if (t < m) v[t] = row[t * W];
}

// acc plus the m elements of v in order, one f32 add and one bf16 rounding
// each.
__device__ __forceinline__ T chain_row(T acc, int m, const T (&v)[kRow]) {
#pragma unroll
  for (int t = 0; t < kRow; ++t)
    if (t < m)
      acc = __float2bfloat16_rn(
          __fadd_rn(__bfloat162float(acc), __bfloat162float(v[t])));
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    chain_sum_kernel(const T* __restrict__ in, T* __restrict__ out, Pass a) {
  const long long c = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (c >= a.W) return;
  for (long long J = blockIdx.y; J < a.windows; J += gridDim.y) {
    long long lo[kDims], hi[kDims];
    long long rem = J;
    bool empty = false;
#pragma unroll
    for (int i = kDims - 1; i >= 0; --i) {
      const long long b = (rem % a.n[i]) * a.w[i] - a.p[i];
      rem /= a.n[i];
      lo[i] = b > 0 ? b : 0;
      hi[i] = b + a.w[i] < a.G[i] ? b + a.w[i] : a.G[i];
      empty = empty || lo[i] >= hi[i];
    }
    T acc = __float2bfloat16_rn(0.0f);
    if (!empty) {
      const int m = static_cast<int>(hi[3] - lo[3]);
      const long long s2 = a.G[3] * a.W, s1 = a.G[2] * s2,
                      s0 = a.G[1] * s1;
      const T* base = in + lo[3] * a.W + c;
      long long i0 = lo[0], i1 = lo[1], i2 = lo[2];
      T cur[kRow], nxt[kRow];
      load_row(base + i0 * s0 + i1 * s1 + i2 * s2, a.W, m, cur);
      while (true) {
        // the next row of the box, in row-major order
        long long j0 = i0, j1 = i1, j2 = i2;
        bool more = true;
        if (++j2 == hi[2]) {
          j2 = lo[2];
          if (++j1 == hi[1]) {
            j1 = lo[1];
            if (++j0 == hi[0]) more = false;
          }
        }
        if (more) load_row(base + j0 * s0 + j1 * s1 + j2 * s2, a.W, m, nxt);
        acc = chain_row(acc, m, cur);
        if (!more) break;
#pragma unroll
        for (int t = 0; t < kRow; ++t)
          if (t < m) cur[t] = nxt[t];
        i0 = j0;
        i1 = j1;
        i2 = j2;
      }
    }
    out[J * a.W + c] = acc;
  }
}

cudaError_t launch(const void* in, void* out, const Pass& a,
                   cudaStream_t stream) {
  const long long bx = (a.W + kThreads - 1) / kThreads;
  const long long by = a.windows < 65535 ? a.windows : 65535;
  if (bx > 0x7fffffffLL || by < 1) return cudaErrorInvalidValue;
  chain_sum_kernel<<<dim3(static_cast<unsigned>(bx),
                          static_cast<unsigned>(by)),
                     kThreads, 0, stream>>>(static_cast<const T*>(in),
                                            static_cast<T*>(out), a);
  return cudaGetLastError();
}

}  // namespace

// One pass over bf16 `in`.  `geo` holds 4 k values: G, w, p and n of each
// leading dimension, in that order; the kernel puts 4 - k dimensions of
// extent 1 in front.  A window may be at most kRow long in the last
// dimension (`passes` never makes a longer one).  Returns the cudaError_t
// of the launch.
extern "C" int chain_sum(const void* in, void* out, int k,
                         const long long* geo, long long W,
                         cudaStream_t stream) {
  if (k < 1 || k > kDims || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Pass a;
  a.W = W;
  a.windows = 1;
  for (int i = 0; i < kDims; ++i) {
    const int d = i - (kDims - k);   // the caller's dimension, or < 0
    a.G[i] = d >= 0 ? geo[d] : 1;
    a.w[i] = d >= 0 ? geo[k + d] : 1;
    a.p[i] = d >= 0 ? geo[2 * k + d] : 0;
    a.n[i] = d >= 0 ? geo[3 * k + d] : 1;
    if (a.n[i] < 1 || a.w[i] < 0 || a.G[i] < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    a.windows *= a.n[i];
  }
  if (a.w[kDims - 1] > kRow) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(in, out, a, stream));
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
