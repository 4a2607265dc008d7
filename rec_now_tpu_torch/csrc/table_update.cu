// Dense-apply optimizer passes over an embedding table, for Hopper
// (sm_90a), f32, in place: row-wise Adagrad and lazy Adam.
//
// ---- adagrad_dense_f32 ----
//
// Replaces adagrad_dense_pass (rec_now_tpu/ops/pallas/table_update_kernel.py,
// pallas_call at :142; the XLA form at rec_now_tpu/embedding/sharded.py:
// 708-715).  For every row r of the logical (V, D) table:
//     acc[r]   += mean_d g[r, d]^2
//     table[r] -= lr / sqrt(max(acc[r], eps)) * g[r]
// Rows whose gradient is zero keep their values exactly.
//
// Taken from the math, not from the TPU blocks: the TPU packs 128 / D
// rows per lane line (pack 1 where D does not divide 128) and turns the
// per-row mean and the scale broadcast into matmuls against (W, P) group
// matrices.  Here the table is the logical (V, D) tensor, and the pass
// takes any D >= 1, as the TPU kernel does, by one of three layouts:
//   * D in {4, 8, 16, 32, 64, 128}, every tensor on the 16-byte grid
//     (adagrad_kernel): D / 4 consecutive threads own one row, one float4
//     each, so a warp reads and writes whole rows with 16-byte accesses,
//     and the row's sum of squares is a butterfly of D / 4 lanes
//     (__shfl_xor_sync);
//   * any other D % 4 == 0 on the grid (config 5's CAN table, D = 272 =
//     68 float4s): a warp per row (adagrad_row_kernel<float4>), its lanes
//     striding over the row's float4s, the sum of squares a full-warp
//     butterfly;
//   * D % 4 != 0, or a tensor off the grid: the same warp per row on
//     float lanes (adagrad_row_kernel<float>), as gather.cu's 1-float
//     kernels.
// The update multiplies and subtracts without contraction to an FMA, as
// the plain PyTorch version does.
//
// What bounds it: bytes.  Each element of table and g is read once, each
// of table written once, acc read and written once: (3 D + 2) * 4 bytes a
// row, 520 MB for 2.6M rows of D = 16, 0.155 ms at 3.35 TB/s; 327 MB for
// 100,000 rows of D = 272, 0.0977 ms.  The warp-per-row kernel reads g
// twice (the sum, then the update): the second read finds the row in L1.
//
// ---- adam_dense_f32 ----
//
// Replaces adam_dense_pass (rec_now_tpu/ops/pallas/table_update_kernel.py,
// pallas_call at :186; the XLA form at rec_now_tpu/embedding/sharded.py:
// 765-782).  Lazy Adam: for every row r whose touched flag is set (the row
// was looked up this step, whatever its summed gradient), with t the step
// count read from the device (never from the host, so a step does not wait
// for the card), c1 = 1 - b1^t and c2 = 1 - b2^t:
//     m[r] = b1 m[r] + (1 - b1) g[r]
//     v[r] = b2 v[r] + (1 - b2) g[r]^2
//     table[r] -= lr (m[r] / c1) / (sqrt(v[r] / c2) + eps)
// A row whose flag is clear reads nothing but its flag and writes nothing:
// its table, m and v stay bit-identical.
//
// Taken from the math, not from the TPU blocks: the TPU broadcasts the
// (T, P) touched counts across each packed line with a matmul against a
// group matrix.  Here a warp owns a chunk of kChunk (64) flags: each lane
// reads 2 with one 2-byte load, a ballot leaves at once a chunk with no
// row touched, and a warp scan lists the chunk's touched rows in shared
// memory in row order.  The warp then updates them D / 4 lanes a row, 32 /
// (D / 4) rows at a time, one float4 each of g, m, v and the table, for D
// in {4, 8, 16, 32, 64, 128} on the 16-byte grid (adam_chunk_kernel).  Any
// other D (config 5's CAN table: 272) runs adam_rows_kernel: a warp per 8
// flags, taking its touched rows one at a time, its lanes striding over a
// row's float4s (D % 4 == 0 on the grid) or floats, each lane's loads of
// up to 4 vectors issued together.  Its first form gave a warp 64 flags
// and a row's vectors one load at a time: a B = 8,192 batch's 1,427 CAN
// rows fill every row of its hottest chunks (64 of 64), and the warp of
// such a chunk took 192 dependent steps, 0.1416 ms on the H100.  A B =
// 8,192 batch touches 36,302 of config 2's 2.6M rows (1.4%), so the grid is
// V / 64 warps (1.3M threads), where a thread per float4 of the table
// (10.4M threads) spent the pass on threads that read a flag and left.  The
// chunk is small because the ids are zipf-skewed: the same batch touches
// up to 408 rows of one 512-flag chunk, which a warp took 51 dependent
// steps over.  Device time a call on the H100 at config 2's shapes
// (tools/probe_adam_chunks.py): 35 us a thread per float4; 40 us with
// 512-flag chunks; 21-23 us with 32-, 64- or 128-flag chunks (a warp's
// dependent loads, flags then rows, times the waves of warps); 29-34 us
// with a thread a row (fewer rows in flight); 17-19 us for a persistent
// grid that loads a warp's next chunk's flags first; 12 us for a list built
// with atomics and a persistent grid over it, in three operations, host
// work that these host-bound steps cannot spare.  No list leaves the warp,
// so no atomics and one launch.  Each product and sum is rounded on its own
// (no FMA contraction), in the order of the plain PyTorch version.
//
// What bounds it: bytes.  Table, m, v and g read, table, m and v written,
// the flag read: (7 D * 4 + 1) bytes a touched row, 1.167 GB for 2.6M
// rows of D = 16 if every row were touched, 0.348 ms at 3.35 TB/s.  A step
// of B = 8,192 touches at most B * 26 = 213k of the 2.6M rows (8%): the
// bytes this run's data needs are the flags plus 7 D * 4 a touched row.
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "runtime.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;         // flags a warp: 2 a lane
constexpr int kWarps = kThreads / 32;
constexpr int kRowFlags = 8;       // flags a warp of the wide Adam pass
constexpr int kBatch = 4;          // vectors a lane loads at once there

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

// A lane's vector (a float4 or one float) of a row: its sum of squares
// and the scaled subtraction, each product rounded on its own.
__device__ __forceinline__ float sumsq(float4 v) {
  return v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
}
__device__ __forceinline__ float sumsq(float v) { return v * v; }
__device__ __forceinline__ void sub_scaled(float4& t, float s, float4 g) {
  t.x = __fsub_rn(t.x, __fmul_rn(s, g.x));
  t.y = __fsub_rn(t.y, __fmul_rn(s, g.y));
  t.z = __fsub_rn(t.z, __fmul_rn(s, g.z));
  t.w = __fsub_rn(t.w, __fmul_rn(s, g.w));
}
__device__ __forceinline__ void sub_scaled(float& t, float s, float g) {
  t = __fsub_rn(t, __fmul_rn(s, g));
}

// A warp per row of n vectors (D / 4 float4s, or D floats): the lanes
// stride over the row, the sum of squares is a full-warp butterfly.
template <typename Vec>
__global__ void __launch_bounds__(kThreads)
adagrad_row_kernel(Vec* __restrict__ table, float* __restrict__ acc,
                   const Vec* __restrict__ g, long long V, int n, int D,
                   float lr, float eps) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= V) return;                 // the whole warp
  const int lane = threadIdx.x & 31;
  const Vec* gr = g + row * n;
  float sq = 0.f;
  for (int i = lane; i < n; i += 32) sq += sumsq(gr[i]);
  for (int off = 16; off > 0; off >>= 1)
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  const float a = acc[row] + sq / (float)D;
  const float scale = lr / sqrtf(fmaxf(a, eps));
  Vec* tr = table + row * n;
  for (int i = lane; i < n; i += 32) {
    Vec tv = tr[i];
    sub_scaled(tv, scale, gr[i]);
    tr[i] = tv;
  }
  if (lane == 0) acc[row] = a;
}

__device__ __forceinline__ void adam_lane(float& w, float& m, float& v,
                                          float g, float lr, float b1,
                                          float omb1, float b2, float omb2,
                                          float c1, float c2, float eps) {
  m = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(omb1, g));
  v = __fadd_rn(__fmul_rn(b2, v), __fmul_rn(omb2, __fmul_rn(g, g)));
  const float upd = __fdiv_rn(__fmul_rn(lr, __fdiv_rn(m, c1)),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), eps));
  w = __fsub_rn(w, upd);
}

__global__ void __launch_bounds__(kThreads)
adam_chunk_kernel(float4* __restrict__ table, float4* __restrict__ m,
                  float4* __restrict__ v, const float4* __restrict__ g,
                  const unsigned char* __restrict__ touched,
                  const int* __restrict__ count, long long V, int lanes,
                  bool flags2, float lr, float b1, float omb1, float b2,
                  float omb2, float eps) {
  __shared__ unsigned char rows[kWarps][kChunk];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long base = ((long long)blockIdx.x * kWarps + w) * kChunk;
  if (base >= V) return;                // the whole warp
  const long long f0 = base + 2 * lane;
  unsigned mine = 0u;                   // bit b: row f0 + b is touched
  if (flags2 && f0 + 2 <= V) {
    const unsigned short q =
        __ldg(reinterpret_cast<const unsigned short*>(touched + f0));
    mine = ((q & 0xffu) ? 1u : 0u) | ((q >> 8) ? 2u : 0u);
  } else {                              // the last chunk's tail
    for (int b = 0; b < 2 && f0 + b < V; ++b)
      if (touched[f0 + b]) mine |= 1u << b;
  }
  if (__ballot_sync(0xffffffffu, mine != 0u) == 0u) return;
  // the chunk's touched rows in row order: lane l's after lanes < l's
  const int n = __popc(mine);
  int at = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, at, o);
    if (lane >= o) at += u;
  }
  const int total = __shfl_sync(0xffffffffu, at, 31);
  at -= n;
  for (unsigned b = mine; b; b &= b - 1u)
    rows[w][at++] = (unsigned char)(2 * lane + __ffs(b) - 1);
  __syncwarp();
  const float t = (float)__ldg(count);
  const float c1 = __fsub_rn(1.f, powf(b1, t));
  const float c2 = __fsub_rn(1.f, powf(b2, t));
  const int per = 32 / lanes, q = lane % lanes;   // rows a step, my float4
  for (int k = lane / lanes; k < total; k += per) {
    const long long idx = (base + rows[w][k]) * lanes + q;
    const float4 gv = g[idx];
    float4 tv = table[idx], mv = m[idx], vv = v[idx];
    adam_lane(tv.x, mv.x, vv.x, gv.x, lr, b1, omb1, b2, omb2, c1, c2, eps);
    adam_lane(tv.y, mv.y, vv.y, gv.y, lr, b1, omb1, b2, omb2, c1, c2, eps);
    adam_lane(tv.z, mv.z, vv.z, gv.z, lr, b1, omb1, b2, omb2, c1, c2, eps);
    adam_lane(tv.w, mv.w, vv.w, gv.w, lr, b1, omb1, b2, omb2, c1, c2, eps);
    table[idx] = tv;
    m[idx] = mv;
    v[idx] = vv;
  }
}

struct AdamArgs {
  float lr, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void adam_vec(float4& w, float4& m, float4& v,
                                         float4 g, const AdamArgs& a,
                                         float c1, float c2) {
  adam_lane(w.x, m.x, v.x, g.x, a.lr, a.b1, a.omb1, a.b2, a.omb2, c1, c2,
            a.eps);
  adam_lane(w.y, m.y, v.y, g.y, a.lr, a.b1, a.omb1, a.b2, a.omb2, c1, c2,
            a.eps);
  adam_lane(w.z, m.z, v.z, g.z, a.lr, a.b1, a.omb1, a.b2, a.omb2, c1, c2,
            a.eps);
  adam_lane(w.w, m.w, v.w, g.w, a.lr, a.b1, a.omb1, a.b2, a.omb2, c1, c2,
            a.eps);
}
__device__ __forceinline__ void adam_vec(float& w, float& m, float& v,
                                         float g, const AdamArgs& a,
                                         float c1, float c2) {
  adam_lane(w, m, v, g, a.lr, a.b1, a.omb1, a.b2, a.omb2, c1, c2, a.eps);
}

// Any other D: a warp per kRowFlags flags (a zipf batch touches every row
// of its hottest chunks, so a warp of 64 flags would take up to 64 rows
// one after another); the warp takes its touched rows one at a time, its
// lanes striding over a row's n vectors (D / 4 float4s, or D floats),
// each lane's loads for kBatch of them issued before their update.
template <typename Vec>
__global__ void __launch_bounds__(kThreads)
adam_rows_kernel(Vec* __restrict__ table, Vec* __restrict__ m,
                 Vec* __restrict__ v, const Vec* __restrict__ g,
                 const unsigned char* __restrict__ touched,
                 const int* __restrict__ count, long long V, int n,
                 AdamArgs a) {
  const int lane = threadIdx.x & 31;
  const long long base =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRowFlags;
  if (base >= V) return;                // the whole warp
  const bool mine = lane < kRowFlags && base + lane < V &&
                    __ldg(touched + base + lane) != 0;
  unsigned rows = __ballot_sync(0xffffffffu, mine);  // bit b: base + b
  if (rows == 0u) return;
  const float t = (float)__ldg(count);
  const float c1 = __fsub_rn(1.f, powf(a.b1, t));
  const float c2 = __fsub_rn(1.f, powf(a.b2, t));
  for (; rows; rows &= rows - 1u) {
    const long long r0 = (base + __ffs(rows) - 1) * n;
    for (int i0 = 0; i0 < n; i0 += 32 * kBatch) {
      Vec tv[kBatch], mv[kBatch], vv[kBatch], gv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + 32 * u + lane;
        if (i < n) {
          tv[u] = table[r0 + i];
          mv[u] = m[r0 + i];
          vv[u] = v[r0 + i];
          gv[u] = g[r0 + i];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + 32 * u + lane;
        if (i < n) {
          adam_vec(tv[u], mv[u], vv[u], gv[u], a, c1, c2);
          table[r0 + i] = tv[u];
          m[r0 + i] = mv[u];
          v[r0 + i] = vv[u];
        }
      }
    }
  }
}

// How a pass lays a (V, D) table on the lanes: D / 4 threads a row (D in
// {4, ..., 128}, every tensor 16-byte aligned), a warp per row on float4s
// (other D % 4 == 0, aligned), or a warp per row on floats.
enum class Layout { kLanes, kRowVec4, kRowFloat };

Layout layout_of(int D, std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  if (D % 4 != 0 || (bits & 15) != 0) return Layout::kRowFloat;
  return 32 % (D / 4) == 0 ? Layout::kLanes : Layout::kRowVec4;
}

}  // namespace

extern "C" {

// table (V, D), g (V, D), acc (V,): f32, contiguous; any D >= 1 (the
// layout from D and the pointers' alignment).  Returns a cudaError_t.
int adagrad_dense_f32(float* table, float* acc, const float* g, long long V,
                      int D, float lr, float eps, int device, void* stream) {
  if (D < 1) return cudaErrorInvalidValue;
  CUDA_TRY(use_device(device));
  if (V == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long row_blocks = (V + kWarps - 1) / kWarps;
  switch (layout_of(D, {table, g})) {
    case Layout::kLanes: {
      const long long n4 = V * (D / 4);
      const long long blocks = (n4 + kThreads - 1) / kThreads;
      adagrad_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
          reinterpret_cast<float4*>(table), acc,
          reinterpret_cast<const float4*>(g), n4, D / 4, D, lr, eps);
      break;
    }
    case Layout::kRowVec4:
      adagrad_row_kernel<float4><<<(unsigned)row_blocks, kThreads, 0, s>>>(
          reinterpret_cast<float4*>(table), acc,
          reinterpret_cast<const float4*>(g), V, D / 4, D, lr, eps);
      break;
    case Layout::kRowFloat:
      adagrad_row_kernel<float><<<(unsigned)row_blocks, kThreads, 0, s>>>(
          table, acc, g, V, D, D, lr, eps);
      break;
  }
  return cudaGetLastError();
}

// table, m, v, g (V, D) f32, contiguous, any D >= 1; touched (V,) bytes (0
// or 1); count a device int32 (the step, already advanced); omb1 = 1 - b1
// and omb2 = 1 - b2 as the host rounds them.  Returns a cudaError_t.
int adam_dense_f32(float* table, float* m, float* v, const float* g,
                   const unsigned char* touched, const int* count,
                   long long V, int D, float lr, float b1, float omb1,
                   float b2, float omb2, float eps, int device,
                   void* stream) {
  if (D < 1) return cudaErrorInvalidValue;
  CUDA_TRY(use_device(device));
  if (V == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool flags2 = reinterpret_cast<uintptr_t>(touched) % 2 == 0;
  const Layout layout = layout_of(D, {table, m, v, g});
  const long long flags_a_block =
      (long long)kWarps * (layout == Layout::kLanes ? kChunk : kRowFlags);
  const unsigned blocks = (unsigned)((V + flags_a_block - 1) / flags_a_block);
  const AdamArgs a{lr, b1, omb1, b2, omb2, eps};
  switch (layout) {
    case Layout::kLanes:
      adam_chunk_kernel<<<blocks, kThreads, 0, s>>>(
          reinterpret_cast<float4*>(table), reinterpret_cast<float4*>(m),
          reinterpret_cast<float4*>(v), reinterpret_cast<const float4*>(g),
          touched, count, V, D / 4, flags2, lr, b1, omb1, b2, omb2, eps);
      break;
    case Layout::kRowVec4:
      adam_rows_kernel<float4><<<blocks, kThreads, 0, s>>>(
          reinterpret_cast<float4*>(table), reinterpret_cast<float4*>(m),
          reinterpret_cast<float4*>(v), reinterpret_cast<const float4*>(g),
          touched, count, V, D / 4, a);
      break;
    case Layout::kRowFloat:
      adam_rows_kernel<float><<<blocks, kThreads, 0, s>>>(
          table, m, v, g, touched, count, V, D, a);
      break;
  }
  return cudaGetLastError();
}

}  // extern "C"
