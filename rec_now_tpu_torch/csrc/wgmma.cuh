// Hopper building blocks shared by the kernels that run wgmma fed by TMA
// (csrc/cin.cu's cin_layer_tc_kernel, csrc/multi_dense.cu's
// linear_wg_kernel): split TF32, mbarriers, TMA copies, named barriers,
// wgmma's shared-memory descriptor and its m64nNk8 TF32 products, and
// cuTensorMapEncodeTiled looked up at run time, and the per-device
// queries a cooperative launch needs (the opt-in shared memory, the SM
// count, the blocks that can be resident).  Each source that includes it
// gets its own copy (an anonymous namespace).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

// v = hi + lo: hi is v rounded to TF32 by two integer operations (half a
// TF32 ulp added, the low 13 bits cleared; cvt.rna.tf32.f32 compiles to
// four, with an infinity test that these finite values do not need), and
// lo = v - hi is exact in f32, its low bits ignored by the tensor cores.
// Each product's error stays below 2^-21 of it, near f32's 2^-24.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(b)), "r"(count));
}

// Waits for the phase of parity `parity` to complete; a phase that never
// does (a lost copy) traps after 2^24 tries instead of hanging the card.
// The loop lives inside the asm, so the compiler sees no divergent path
// before the wgmma that follow (it would serialize them).
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nadd.u32 n, n, 1;\nsetp.lt.u32 p, n, 16777216;\n"
      "@p bra LAB_WAIT;\ntrap;\nDONE:\n}\n"
      :: "r"(smem_u32(b)), "r"(parity) : "memory");
}

// One arrival on the mbarrier from the lane whose `lane` is 0 (a
// predicate, not a branch).
__device__ __forceinline__ void mbar_arrive_lane0(uint64_t* b, int lane) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.s32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :: "r"(smem_u32(b)), "r"(lane) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(b)), "r"(bytes) : "memory");
}

// A box of the 4-D tensor map at (c0, c1, c2, c3) into dst, completing
// on the mbarrier.
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile in SWIZZLE_128B:
// rows of 128 bytes (4 k-steps of 8 TF32), 8-row groups 1,024 bytes
// apart; k-step i of a row starts i * 32 bytes in.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma uses across this point.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A (64 x 8, registers: rows g and g + 8 of the warp's 16, columns
// t and t + 4) * B (8 x N, the descriptor's K-major tile); scale_d 0
// starts a chain.  One overload for each N the kernel is built for.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[100],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %105, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99}, "
      "{%100, %101, %102, %103}, %104, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// A box of the 2-D tensor map at (c0, c1) into dst, completing on the
// mbarrier.
__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime (no
// link against libcuda); nullptr where libcuda lacks it.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load(std::memory_order_acquire);
  if (f) return f;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t e = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
  if (e != cudaSuccess || q != cudaDriverEntryPointSuccess || !p) {
    cudaGetLastError();
    return nullptr;
  }
  f = reinterpret_cast<EncodeTiled>(p);
  fn.store(f, std::memory_order_release);
  return f;
}

// Device attributes and kernel attributes are read and set once per
// device (they cost host time on every launch otherwise); devices past
// kMaxDevices are queried every time.
constexpr int kMaxDevices = 64;

// What query(&v) gives for `device`, cached in slots[device]; 0 when the
// query fails.
template <typename Query>
int per_device(int device, std::atomic<int>* slots, Query query) {
  const bool cached = device >= 0 && device < kMaxDevices;
  int v = cached ? slots[device].load(std::memory_order_relaxed) : 0;
  if (v > 0) return v;
  if (query(&v) != cudaSuccess) return 0;
  if (cached) slots[device].store(v, std::memory_order_relaxed);
  return v;
}

int optin_smem(int device) {
  static std::atomic<int> slots[kMaxDevices];
  return per_device(device, slots, [&](int* v) {
    return cudaDeviceGetAttribute(
        v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device); });
}

int sm_count(int device) {
  static std::atomic<int> slots[kMaxDevices];
  return per_device(device, slots, [&](int* v) {
    return cudaDeviceGetAttribute(v, cudaDevAttrMultiProcessorCount,
                                  device); });
}

// Lets `kernel` take up to the device's opt-in shared memory; done[] is
// the caller's flag per device, one array per kernel.
cudaError_t allow_optin_smem(const void* kernel, int device,
                             std::atomic<bool>* done) {
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && done[device].load(std::memory_order_acquire))
    return cudaSuccess;
  const int cap = optin_smem(device);
  if (cap == 0) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  if (e == cudaSuccess && cached)
    done[device].store(true, std::memory_order_release);
  return e;
}

// Blocks of `kernel` (`threads` a block, the device's opt-in shared
// memory) that can be resident at once: the cooperative launch's largest
// grid; 0 where the device cannot launch it cooperatively or a query
// fails.  slots[] and done[] are the caller's, one array each per kernel.
int coop_resident(const void* kernel, int threads, int device,
                  std::atomic<int>* slots, std::atomic<bool>* done) {
  return per_device(device, slots, [&](int* v) -> cudaError_t {
    int coop = 0, per_sm = 0;
    cudaError_t e = cudaDeviceGetAttribute(
        &coop, cudaDevAttrCooperativeLaunch, device);
    if (e == cudaSuccess) e = allow_optin_smem(kernel, device, done);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, threads, optin_smem(device));
    if (e != cudaSuccess) return e;
    *v = coop ? per_sm * sm_count(device) : 0;
    return cudaSuccess;
  });
}

}  // namespace
