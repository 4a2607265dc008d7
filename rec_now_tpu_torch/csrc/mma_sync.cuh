// The mma.sync building blocks shared by the kernels that run split TF32
// on m16n8k8 products fed by cp.async (csrc/cin.cu's
// cin_layer_mma_kernel and cin_stack_tc_kernel, csrc/multi_dense.cu's
// multi_dense_tc): the TF32 products and the copies to shared memory.
// Each source that includes it gets its own copy (an anonymous
// namespace).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b, the same with a zero accumulator
__device__ __forceinline__ void mma_tf32_new(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// copy 4 (8, 16) bytes to shared memory, or zeros when !full
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
               :: "r"(s), "l"(src), "r"(full ? 8 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N));
}

}  // namespace
