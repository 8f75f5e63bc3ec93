// The streaming ring shared by blocked_matvec.cu and gather_dot.cu.
//
// A CTA of either kernel has eight consumer warps and one producer warp.
// The producer's first lane takes the CTA's chunks of work (CTA i: chunks
// i, i + grid, i + 2 grid, ...) and hands their stages to the consumers
// through an S-stage ring in dynamic shared memory: on the bulk branch it
// fills each stage with 1-D bulk copies (cp.async.bulk ...
// mbarrier::complete_tx::bytes), on the plain-load branch the ring carries
// only its notes of which stage is which.  A slot's notes are written
// before the producer arrives on its full barrier, since a stage that
// expects no bytes completes on that arrive.  Stage s waits on full[s % S] with parity (s / S) & 1, and the
// producer refills a slot once the eight consumer warps have arrived on
// empty[s % S].  The host decides the geometry and the shared-memory layout
// (repro_torch/kernels/stream.py) and passes it in.
//
// Dots run on CUDA cores: `group` lanes (a power of two up to 32) share one
// dot, multiply in f32 and add with FMA, then add their parts with group_sum.
// On the bulk branch a group is as narrow as leaves each lane about eight
// 16-byte vectors, so a warp reduces several dots at once in few steps.
// A bf16 entry is widened to f32 first, so each product is exact in f32 and
// only the order of the sum within a dot differs from the TPU kernels'.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stream {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr unsigned kFull = 0xffffffffu;
// ints noted per ring slot (stream.SLOT_INTS): the stage's chunk (-1: no
// more work) and its stage within the chunk
constexpr int kSlotInts = 2;

// Chunk c of `work` units cut into chunks of `chunk`: units [*lo, *hi).
__device__ __forceinline__ void chunk_span(int c, int chunk, int work, int* lo,
                                           int* hi) {
  *lo = c * chunk;
  *hi = min(*lo + chunk, work);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_bar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// adds bytes to the transfer the barrier's current phase waits for
__device__ __forceinline__ void expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// bytes and both addresses 16-byte aligned
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the eight consumer warps only (the producer warp never joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ float group_sum(float s, int group) {
  for (int o = group >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// s + x . y over one 16-byte vector of each (4 f32 or 8 bf16 entries)
template <typename T>
__device__ __forceinline__ float fma16(uint4 x, uint4 y, float s);

template <>
__device__ __forceinline__ float fma16<float>(uint4 x, uint4 y, float s) {
  s = fmaf(__uint_as_float(x.x), __uint_as_float(y.x), s);
  s = fmaf(__uint_as_float(x.y), __uint_as_float(y.y), s);
  s = fmaf(__uint_as_float(x.z), __uint_as_float(y.z), s);
  return fmaf(__uint_as_float(x.w), __uint_as_float(y.w), s);
}

__device__ __forceinline__ float fma_bf16x2(uint32_t x, uint32_t y, float s) {
  s = fmaf(__uint_as_float(x << 16), __uint_as_float(y << 16), s);
  return fmaf(__uint_as_float(x & 0xffff0000u), __uint_as_float(y & 0xffff0000u),
              s);
}

template <>
__device__ __forceinline__ float fma16<__nv_bfloat16>(uint4 x, uint4 y,
                                                      float s) {
  s = fma_bf16x2(x.x, y.x, s);
  s = fma_bf16x2(x.y, y.y, s);
  s = fma_bf16x2(x.z, y.z, s);
  return fma_bf16x2(x.w, y.w, s);
}

// One lane's part of the dot of n16 16-byte vectors in shared memory: lane
// `lane` of a group of `group` takes the vectors k = lane (mod group).  It
// starts `rot` vectors further on and wraps (rot a multiple of group, n16
// too, or rot = 0), so groups that read rows lying a multiple of 128 bytes
// apart read different banks.
template <typename T>
__device__ __forceinline__ float dot_shared(const T* v, const T* q, int n16,
                                            int lane, int group, int rot) {
  const uint4* v4 = reinterpret_cast<const uint4*>(v);
  const uint4* q4 = reinterpret_cast<const uint4*>(q);
  float s = 0.f;
  int k = lane + rot;
  if (k >= n16) k -= n16;
#pragma unroll 4
  for (int i = lane; i < n16; i += group) {
    s = fma16<T>(v4[k], q4[k], s);
    k += group;
    if (k >= n16) k -= n16;
  }
  return s;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One lane's part of the dot of n entries in device memory, one entry a
// load (the plain-load branch: any alignment).
template <typename T>
__device__ __forceinline__ float dot_global(const T* __restrict__ v,
                                            const T* __restrict__ q, int n,
                                            int lane, int group) {
  float s = 0.f;
  for (int c = lane; c < n; c += group)
    s = fmaf(widen(__ldg(v + c)), widen(__ldg(q + c)), s);
  return s;
}

// Lets kernel Kern launch with `smem` bytes of dynamic shared memory on the
// current device.  It remembers the most it was set to on the first 16
// devices, so a launch costs no driver call once set.
template <auto Kern>
cudaError_t set_smem(int smem) {
  static int most[16] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 16 && smem <= most[dev])) return err;
  err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && dev < 16) most[dev] = smem;
  return err;
}

// Lets kernel Kern launch with `smem` bytes of dynamic shared memory on the
// current device and reads how many CTAs of it fit on one SM.
template <auto Kern>
cudaError_t occupancy(int smem, int* sms, int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = set_smem<Kern>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, Kern, kThreads,
                                                        smem);
  return err;
}

}  // namespace stream
