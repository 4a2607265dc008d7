// Row gather, pooled row gather and row scatter-add on the logical (R, D)
// f32 embedding table, for Hopper (sm_90a).
//
// ---- gather_rows_f32 (kernel B11) ----
//
// Replaces packed_gather (rec_now_tpu/ops/pallas/gather_kernel.py:94,
// pallas_call at :136), the drop-in for the take + lane select of
// ShardedEmbeddingTable._fetch_rows (rec_now_tpu/embedding/sharded.py:
// 206-218).  For every id k:
//     out[k, :] = table[clamp(ids[k], 0, R - 1), :]
// Ids outside [0, R) clamp into it, as the TPU kernel clamps the physical
// row (gather_kernel.py:101-104, :115).  Forward only, as on the TPU: the
// wrapper refuses a table that requires grad.
//
// Taken from the function, not from the TPU blocks: the TPU DMAs whole
// 128-lane packed lines into VMEM and selects the row's lanes with a 0/1
// matmul.  Here the table is the logical (V, D) tensor, so a row is D
// contiguous floats: D / 4 consecutive threads own one output row and move
// it as float4 pieces (D = 16: 4 threads, one 64-byte row), with a scalar
// loop when D is not a multiple of 4 or a pointer is not 16-byte aligned.
// Each thread reads its row's id itself (the TPU scalar-prefetches them).
//
// What bounds it: bytes.  N rows of D * 4 bytes read and written once, and
// the N ids: 29 MB for the 212,992 ids of a B = 8,192 batch of 26 fields at
// D = 16, 0.0087 ms at 3.35 TB/s.  The rows are random, so each read is a
// whole 64-byte row (two 32-byte sectors) and L2 keeps the hot rows.
//
// ---- scatter_add_rows_f32 (kernel B12) ----
//
// Replaces expand_lines (rec_now_tpu/ops/pallas/expand_kernel.py:45,
// pallas_call at :64) together with the scatter it feeds: the (N, P * D)
// one-hot lines and their .at[pr].add into the dense-gradient buffer
// (ShardedEmbeddingTable._scatter_dense_grads, sharded.py:661-674) and
// into the table in the sparse path's write-backs (:648, :829-831).  On
// the logical table that is, in place:
//     out[ids[k], :] += vals[k, :]   for every k with 0 <= ids[k] < R
// Duplicate ids sum; ids outside [0, R) are dropped, as the scatter drops
// the out-of-range sentinel rows (sharded.py:234-236).  The one-hot lines
// are a lane-packing artifact and the bf16 buffer a TPU choice: neither is
// kept (the buffer stays f32).
//
// Taken from the function: each thread reads one id and adds a piece of
// its row with an atomic (a fire-and-forget RED to L2).  When D % 4 == 0
// and out and vals are 16-byte aligned, a piece is a float4 added by one
// vector atomic (atomicAdd(float4*, float4), global memory on compute
// capability 9.x): D / 4 neighbouring threads share a row, and a hot row
// takes a quarter as many atomics as with one f32 atomic per column, the
// scalar loop kept for the rest (D = 5, misaligned views).  Atomics sum
// duplicates in no fixed order, so two runs may differ in the last bits
// of a row hit many times.
//
// What bounds it: bytes.  vals and ids read once, and each distinct row
// that an in-range id names read and written once: at most 29 MB for
// 212,992 ids at D = 16, ~0.009 ms at 3.35 TB/s; the atomics to the hot
// rows (a zipf stream's row 1 of a field takes ~2,000 adds a batch)
// serialise in L2.
//
// ---- gather_pool_rows_f32 (the pooled multi-hot lookup) ----
//
// Replaces no TPU kernel: the JAX package has one id a field.  DLRM's
// multi-hot fields (MLPerf's Criteo 1TB: 214 ids an example over 26
// fields) sum-pool each field's rows.  For every example b and field f,
// with field f's ids in columns [starts[f], starts[f + 1]) of row b:
//     out[b, f, :] = sum_j table[clamp(ids[b, j], 0, R - 1), :]
// added in column order, as the plain version adds them.  B11 and a sum
// would write and read again a (B, sum(hotness), D) intermediate: at
// B = 8,192 and D = 128, 898 MB a request against the 109 MB pooled.
//
// Taken from the function: D / 4 neighbouring threads own one pooled row
// (D = 128: a warp, one 512-byte row a step), read a field's ids (every
// thread of the row the same id, one broadcast load) and keep four rows
// in flight before adding them in order; the scalar loop as B11's for D
// not a multiple of 4 or a pointer off the 16-byte grid.  Row offsets
// are 64-bit: a 102M-row table of 128 floats holds 1.3e10.
//
// What bounds it: bytes.  The distinct rows read once, the (B, F, D)
// pooled rows written, the ids read: at B = 8,192 and the published
// hotness 1.75M rows of 512 bytes, ~1 GB a request, ~0.3 ms at 3.35 TB/s.
//
// The C entry points, like every entry point of the package's sources,
// make the device current through runtime.cuh's `use_device` and check the
// launch after it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "runtime.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

template <typename Idx>
__device__ __forceinline__ long long clamp_row(Idx id, long long rows) {
  const long long r = static_cast<long long>(id);
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
gather4_kernel(const float4* __restrict__ table, const Idx* __restrict__ ids,
               float4* __restrict__ out, long long n4, int lanes,
               long long rows) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const long long k = i / lanes;
    const int c = (int)(i - k * lanes);
    const long long r = clamp_row(__ldg(ids + k), rows);
    out[i] = __ldg(table + r * lanes + c);
  }
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
gather1_kernel(const float* __restrict__ table, const Idx* __restrict__ ids,
               float* __restrict__ out, long long n, int D, long long rows) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const long long k = i / D;
    const int c = (int)(i - k * D);
    const long long r = clamp_row(__ldg(ids + k), rows);
    out[i] = __ldg(table + r * D + c);
  }
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
scatter_add1_kernel(float* __restrict__ out, const Idx* __restrict__ ids,
                    const float* __restrict__ vals, long long n, int D,
                    long long rows) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const long long k = i / D;
    const long long r = static_cast<long long>(__ldg(ids + k));
    if (r < 0 || r >= rows) continue;
    atomicAdd(out + r * D + (i - k * D), __ldg(vals + i));
  }
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
scatter_add4_kernel(float4* __restrict__ out, const Idx* __restrict__ ids,
                    const float4* __restrict__ vals, long long n4, int lanes,
                    long long rows) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const long long k = i / lanes;
    const long long r = static_cast<long long>(__ldg(ids + k));
    if (r < 0 || r >= rows) continue;
    atomicAdd(out + r * lanes + (i - k * lanes), __ldg(vals + i));
  }
}

__device__ __forceinline__ void add4(float4& a, const float4 v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
gather_pool4_kernel(const float4* __restrict__ table,
                    const Idx* __restrict__ ids,
                    const int* __restrict__ starts, int F, int nids,
                    float4* __restrict__ out, long long n4, int lanes,
                    long long rows) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const long long k = i / lanes;            // pooled row (b, f)
    const int c = (int)(i - k * lanes);
    const long long b = k / F;
    const int f = (int)(k - b * F);
    const Idx* col = ids + b * nids;
    const int hi = __ldg(starts + f + 1);
    int j = __ldg(starts + f);
    const float4* t = table + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (; j + 4 <= hi; j += 4) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = __ldg(t + clamp_row(__ldg(col + j + u), rows) * lanes);
#pragma unroll
      for (int u = 0; u < 4; ++u) add4(acc, v[u]);
    }
    for (; j < hi; ++j)
      add4(acc, __ldg(t + clamp_row(__ldg(col + j), rows) * lanes));
    out[i] = acc;
  }
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
gather_pool1_kernel(const float* __restrict__ table,
                    const Idx* __restrict__ ids,
                    const int* __restrict__ starts, int F, int nids,
                    float* __restrict__ out, long long n, int D,
                    long long rows) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const long long k = i / D;
    const int c = (int)(i - k * D);
    const long long b = k / F;
    const int f = (int)(k - b * F);
    const Idx* col = ids + b * nids;
    const int hi = __ldg(starts + f + 1);
    float acc = 0.f;
    for (int j = __ldg(starts + f); j < hi; ++j)
      acc += __ldg(table + clamp_row(__ldg(col + j), rows) * D + c);
    out[i] = acc;
  }
}

unsigned blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename Idx>
void launch_gather(const float* table, long long rows, int D, const Idx* ids,
                   long long n, float* out, cudaStream_t s) {
  const bool vec = D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(table) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) {
    const long long n4 = n * (D / 4);
    gather4_kernel<Idx><<<blocks_for(n4), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(table), ids,
        reinterpret_cast<float4*>(out), n4, D / 4, rows);
  } else {
    gather1_kernel<Idx><<<blocks_for(n * D), kThreads, 0, s>>>(
        table, ids, out, n * D, D, rows);
  }
}

template <typename Idx>
void launch_pool(const float* table, long long rows, int D, const Idx* ids,
                 const int* starts, int F, int nids, long long batch,
                 float* out, cudaStream_t s) {
  const bool vec = D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(table) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) {
    const long long n4 = batch * F * (D / 4);
    gather_pool4_kernel<Idx><<<blocks_for(n4), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(table), ids, starts, F, nids,
        reinterpret_cast<float4*>(out), n4, D / 4, rows);
  } else {
    const long long n = batch * F * D;
    gather_pool1_kernel<Idx><<<blocks_for(n), kThreads, 0, s>>>(
        table, ids, starts, F, nids, out, n, D, rows);
  }
}

template <typename Idx>
void launch_scatter(float* out, long long rows, int D, const Idx* ids,
                    long long n, const float* vals, cudaStream_t s) {
  const bool vec = D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(vals)) & 15) == 0;
  if (vec) {
    const long long n4 = n * (D / 4);
    scatter_add4_kernel<Idx><<<blocks_for(n4), kThreads, 0, s>>>(
        reinterpret_cast<float4*>(out), ids,
        reinterpret_cast<const float4*>(vals), n4, D / 4, rows);
  } else {
    scatter_add1_kernel<Idx><<<blocks_for(n * D), kThreads, 0, s>>>(
        out, ids, vals, n * D, D, rows);
  }
}

}  // namespace

extern "C" {

// table (rows, D) f32 contiguous; ids (n,) int32 (ids64 = 0) or int64
// (ids64 = 1) contiguous; out (n, D) f32 contiguous.  rows >= 1.  Returns a
// cudaError_t; n = 0 or D = 0 launches nothing.
int gather_rows_f32(const float* table, long long rows, int D,
                    const void* ids, int ids64, long long n, float* out,
                    int device, void* stream) {
  if (rows < 1 || D < 0 || n < 0) return cudaErrorInvalidValue;
  CUDA_TRY(use_device(device));
  if (n == 0 || D == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids64)
    launch_gather(table, rows, D, static_cast<const long long*>(ids), n, out,
                  s);
  else
    launch_gather(table, rows, D, static_cast<const int*>(ids), n, out, s);
  return cudaGetLastError();
}

// table (rows, D) f32 contiguous; ids (batch, nids) int32 (ids64 = 0) or
// int64 (ids64 = 1) contiguous; starts (F + 1,) int32 on the device, field
// f's ids in columns [starts[f], starts[f + 1]), starts[F] = nids; out
// (batch, F, D) f32 contiguous.  rows >= 1, F >= 1.  Returns a cudaError_t;
// batch = 0 or D = 0 launches nothing.
int gather_pool_rows_f32(const float* table, long long rows, int D,
                         const void* ids, int ids64, long long batch,
                         int nids, const int* starts, int F, float* out,
                         int device, void* stream) {
  if (rows < 1 || D < 0 || batch < 0 || nids < 0 || F < 1)
    return cudaErrorInvalidValue;
  CUDA_TRY(use_device(device));
  if (batch == 0 || D == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids64)
    launch_pool(table, rows, D, static_cast<const long long*>(ids), starts,
                F, nids, batch, out, s);
  else
    launch_pool(table, rows, D, static_cast<const int*>(ids), starts, F,
                nids, batch, out, s);
  return cudaGetLastError();
}

// out (rows, D) f32 contiguous, added to in place; ids (n,) int32 or int64
// as above; vals (n, D) f32 contiguous.  Ids outside [0, rows) are dropped.
// Returns a cudaError_t; n = 0 or D = 0 launches nothing.
int scatter_add_rows_f32(float* out, long long rows, int D, const void* ids,
                         int ids64, long long n, const float* vals,
                         int device, void* stream) {
  if (rows < 0 || D < 0 || n < 0) return cudaErrorInvalidValue;
  CUDA_TRY(use_device(device));
  if (n == 0 || D == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids64)
    launch_scatter(out, rows, D, static_cast<const long long*>(ids), n, vals,
                   s);
  else
    launch_scatter(out, rows, D, static_cast<const int*>(ids), n, vals, s);
  return cudaGetLastError();
}

}  // extern "C"
