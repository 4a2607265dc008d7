// Dense-apply row-wise Adagrad pass over an embedding table, for Hopper
// (sm_90a), f32, in place.
//
// Replaces adagrad_dense_pass (rec_now_tpu/ops/pallas/table_update_kernel.py,
// pallas_call at :142; the XLA form at rec_now_tpu/embedding/sharded.py:
// 708-715).  For every row r of the logical (V, D) table:
//     acc[r]   += mean_d g[r, d]^2
//     table[r] -= lr / sqrt(max(acc[r], eps)) * g[r]
// Rows whose gradient is zero keep their values exactly.
//
// Taken from the math, not from the TPU blocks: the TPU packs 128 / D
// rows per lane line and turns the per-row mean and the scale broadcast
// into matmuls against (W, P) group matrices.  Here the table is the
// logical (V, D) tensor: D / 4 consecutive threads own one row, one
// float4 each, so a warp reads and writes whole 64-byte rows with 16-byte
// accesses, and the row's sum of squares is a butterfly of D / 4 lanes
// (__shfl_xor_sync).  The update multiplies and subtracts without
// contraction to an FMA, as the plain PyTorch version does.
//
// What bounds it: bytes.  Each element of table and g is read once, each
// of table written once, acc read and written once: (3 D + 2) * 4 bytes a
// row, 520 MB for 2.6M rows of D = 16, 0.155 ms at 3.35 TB/s.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
adagrad_kernel(float4* __restrict__ table, float* __restrict__ acc,
               const float4* __restrict__ g, long long n4, int lanes, int D,
               float lr, float eps) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = idx < n4;
  const float4 gv = live ? g[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
  float sq = gv.x * gv.x + gv.y * gv.y + gv.z * gv.z + gv.w * gv.w;
  // every lane of the warp takes part, live or not: lanes of one row
  // (lanes divides 32) never straddle a warp
  for (int off = lanes >> 1; off > 0; off >>= 1)
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (!live) return;
  const long long row = idx / lanes;
  const float a = acc[row] + sq / (float)D;
  const float scale = lr / sqrtf(fmaxf(a, eps));
  float4 tv = table[idx];
  tv.x = __fsub_rn(tv.x, __fmul_rn(scale, gv.x));
  tv.y = __fsub_rn(tv.y, __fmul_rn(scale, gv.y));
  tv.z = __fsub_rn(tv.z, __fmul_rn(scale, gv.z));
  tv.w = __fsub_rn(tv.w, __fmul_rn(scale, gv.w));
  table[idx] = tv;
  if (idx % lanes == 0) acc[row] = a;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// table (V, D), g (V, D), acc (V,): f32, contiguous, 16-byte aligned;
// D a multiple of 4 with D / 4 dividing 32.  Returns a cudaError_t.
int adagrad_dense_f32(float* table, float* acc, const float* g, long long V,
                      int D, float lr, float eps, int device, void* stream) {
  if (D % 4 != 0 || 32 % (D / 4) != 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaGetLastError();
  const long long n4 = V * (D / 4);
  if (n4 == 0) return cudaSuccess;
  const long long blocks = (n4 + kThreads - 1) / kThreads;
  adagrad_kernel<<<(unsigned)blocks, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(table), acc,
      reinterpret_cast<const float4*>(g), n4, D / 4, D, lr, eps);
  return cudaGetLastError();
}

}  // extern "C"
