// Helpers shared by the CUDA sources of repro_torch (spmv_kernels.cu and
// ssd_chunk.cu). The build hashes every file under csrc/, so an edit here
// rebuilds the library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One 16-byte copy from device memory into shared memory that bypasses L1
// (cp.async.cg); wait for it with cp.async.wait_group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// The accumulator of a value type: the type itself for float and double,
// float for bf16 (every product and sum of a bf16 kernel is an f32 FMA, as
// the Pallas kernels accumulate bf16 in f32).
template <typename T>
struct AccOf {
  using type = T;
};
template <>
struct AccOf<__nv_bfloat16> {
  using type = float;
};
template <typename T>
using Acc = typename AccOf<T>::type;

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// An accumulator rounded to the value type once, at the store.
template <typename T>
__device__ __forceinline__ T from_acc(Acc<T> v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace
