// Row dots on CUDA cores, shared by gather_dot.cu and blocked_matvec.cu.
//
// row_dot<T> returns one lane's part of the dot of C contiguous entries of
// a row with C contiguous query entries: lane l takes entries l, l + 32, ...
// (or 16-byte vectors of them), multiplies in f32 and adds with FMA.  A
// bf16 entry is widened to f32 first, so each product is exact in f32 and
// only the order of the sum differs from the TPU kernels' f32 dots.
// warp_sum then adds the 32 parts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rowdot {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// vec: the row and the query are 16-byte aligned and C is a multiple of the
// entries in 16 bytes (4 f32, 8 bf16).
template <typename T>
__device__ float row_dot(const T* __restrict__ v, const T* __restrict__ q,
                         int C, bool vec, int lane);

template <>
__device__ __forceinline__ float row_dot<float>(const float* __restrict__ v,
                                                const float* __restrict__ q,
                                                int C, bool vec, int lane) {
  float s = 0.f;
  if (vec) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int k = lane; k < C / 4; k += 32) {
      const float4 x = __ldg(v4 + k), y = __ldg(q4 + k);
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
      s = fmaf(x.z, y.z, s);
      s = fmaf(x.w, y.w, s);
    }
  } else {
    for (int c = lane; c < C; c += 32) s = fmaf(__ldg(v + c), __ldg(q + c), s);
  }
  return s;
}

template <>
__device__ __forceinline__ float row_dot<__nv_bfloat16>(
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ q,
    int C, bool vec, int lane) {
  float s = 0.f;
  if (vec) {
    const uint4* v8 = reinterpret_cast<const uint4*>(v);
    const uint4* q8 = reinterpret_cast<const uint4*>(q);
    for (int k = lane; k < C / 8; k += 32) {
      const uint4 x = __ldg(v8 + k), y = __ldg(q8 + k);
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yv = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 a = __bfloat1622float2(xv[u]);
        const float2 b = __bfloat1622float2(yv[u]);
        s = fmaf(a.x, b.x, s);
        s = fmaf(a.y, b.y, s);
      }
    }
  } else {
    for (int c = lane; c < C; c += 32)
      s = fmaf(__bfloat162float(v[c]), __bfloat162float(q[c]), s);
  }
  return s;
}

}  // namespace rowdot
