// The host-side runtime that every CUDA source of the package includes
// (all of csrc/*.cu but wire.cu, which is host C++ built without CUDA's
// headers): making a device current, the per-device attribute cache, the
// dynamic shared memory opt-in, a cooperative launch's largest grid, the
// return-on-error macro and the extern "C" error_string that
// ops/_build.py types for every library.  Each source compiles into a
// library of its own, so each gets its own copy (an anonymous namespace)
// and its own error_string.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

// Returns the cudaError_t of `expr` from the enclosing function unless it
// is cudaSuccess.
#define CUDA_TRY(expr)                                       \
  do {                                                       \
    const cudaError_t rc_ = static_cast<cudaError_t>(expr);  \
    if (rc_ != cudaSuccess) return rc_;                      \
  } while (0)

namespace {

// Device attributes and kernel attributes are read and set once per
// device (they cost host time on every launch otherwise); devices past
// kMaxDevices are queried every time.
constexpr int kMaxDevices = 64;

// Makes `device` current, setting it only when it is not (cudaSetDevice
// costs host time even then), and first clears an unread error of an
// earlier runtime call, so that the check after the launch reports the
// launch alone.
cudaError_t use_device(int device) {
  cudaGetLastError();
  int current = -1;
  const cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess || current == device) return e;
  return cudaSetDevice(device);
}

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

// Lets `kernel` take `bytes` of dynamic shared memory (past the 48 KB
// default), once per device: done[] is the kernel's own flag per device,
// one array per kernel.  bytes <= 0 (an opt-in the device did not report)
// is refused.
cudaError_t allow_smem(const void* kernel, int bytes, int device,
                       std::atomic<bool>* done) {
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && done[device].load(std::memory_order_acquire))
    return cudaSuccess;
  if (bytes <= 0) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
    if (e == cudaSuccess)
      e = allow_smem(kernel, optin_smem(device), device, done);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, threads, optin_smem(device));
    if (e != cudaSuccess) return e;
    *v = coop ? per_sm * sm_count(device) : 0;
    return cudaSuccess;
  });
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
