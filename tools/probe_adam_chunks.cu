// Designs of the lazy Adam pass (kernel B10, rec_now_tpu_torch/csrc/
// table_update.cu) side by side, for tools/probe_adam_chunks.py.  Every
// design updates the same touched rows with the same adam_lane, so each is
// bit-equal to the others; they differ in how threads find the rows:
//   0  a thread per float4 of the table, each reading its row's flag
//      (the port's first kernel);
//   1  a warp per chunk of 32 * kPer flags, the chunk's touched rows listed
//      in shared memory, D / 4 lanes a row (kMode 0) or a thread a row
//      (kMode 1), for chunks of 32 to 512 flags;
//   2  a list of the touched rows built with one atomic a warp, then a
//      persistent grid over the list's items (a memset and two launches);
//   3  a persistent grid of warps striding over 64-flag chunks, each
//      warp's next chunk's flags loaded before it updates this chunk's
//      rows (D / 4 lanes a row).
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -shared; D = 16.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32, kLanes = 4;

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

struct Args {
  float4 *t, *m, *v;
  const float4* g;
  const unsigned char* flags;
  const int* count;
  long long V;
  float lr, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void corrections(const Args& a, float& c1,
                                            float& c2) {
  const float t = (float)__ldg(a.count);
  c1 = __fsub_rn(1.f, powf(a.b1, t));
  c2 = __fsub_rn(1.f, powf(a.b2, t));
}

__device__ __forceinline__ void update(const Args& a, long long i, float c1,
                                       float c2) {
  const float4 gv = a.g[i];
  float4 tv = a.t[i], mv = a.m[i], vv = a.v[i];
  adam_lane(tv.x, mv.x, vv.x, gv.x, a.lr, a.b1, a.omb1, a.b2, a.omb2, c1, c2,
            a.eps);
  adam_lane(tv.y, mv.y, vv.y, gv.y, a.lr, a.b1, a.omb1, a.b2, a.omb2, c1, c2,
            a.eps);
  adam_lane(tv.z, mv.z, vv.z, gv.z, a.lr, a.b1, a.omb1, a.b2, a.omb2, c1, c2,
            a.eps);
  adam_lane(tv.w, mv.w, vv.w, gv.w, a.lr, a.b1, a.omb1, a.b2, a.omb2, c1, c2,
            a.eps);
  a.t[i] = tv;
  a.m[i] = mv;
  a.v[i] = vv;
}

__global__ void __launch_bounds__(kThreads) per_float4(Args a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.V * kLanes || !a.flags[i / kLanes]) return;
  float c1, c2;
  corrections(a, c1, c2);
  update(a, i, c1, c2);
}

template <int kPer, int kMode>
__global__ void __launch_bounds__(kThreads) per_chunk(Args a) {
  constexpr int kChunk = 32 * kPer;
  __shared__ unsigned short rows[kWarps][kChunk];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long base = ((long long)blockIdx.x * kWarps + w) * kChunk;
  if (base >= a.V) return;
  const long long f0 = base + kPer * lane;
  unsigned mine = 0u;
  for (int b = 0; b < kPer && f0 + b < a.V; ++b)
    if (a.flags[f0 + b]) mine |= 1u << b;
  if (__ballot_sync(0xffffffffu, mine != 0u) == 0u) return;
  const int n = __popc(mine);
  int at = n;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, at, o);
    if (lane >= o) at += u;
  }
  const int total = __shfl_sync(0xffffffffu, at, 31);
  at -= n;
  for (unsigned b = mine; b; b &= b - 1u)
    rows[w][at++] = (unsigned short)(kPer * lane + __ffs(b) - 1);
  __syncwarp();
  float c1, c2;
  corrections(a, c1, c2);
  if (kMode == 0) {
    const int per = 32 / kLanes, q = lane % kLanes;
    for (int k = lane / kLanes; k < total; k += per)
      update(a, (base + rows[w][k]) * kLanes + q, c1, c2);
  } else {
    for (int k = lane; k < total; k += 32) {
      const long long r = (base + rows[w][k]) * kLanes;
#pragma unroll
      for (int q = 0; q < kLanes; ++q) update(a, r + q, c1, c2);
    }
  }
}

// Flags [f0, f0 + 2) as bits.
__device__ __forceinline__ unsigned two_flags(const Args& a, long long f0) {
  unsigned bits = 0u;
  for (int b = 0; b < 2 && f0 + b < a.V; ++b)
    if (a.flags[f0 + b]) bits |= 1u << b;
  return bits;
}

__global__ void __launch_bounds__(kThreads) persistent_chunks(Args a) {
  constexpr int kChunk = 64;
  __shared__ unsigned char rows[kWarps][kChunk];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long nwarps = (long long)gridDim.x * kWarps;
  const long long chunks = (a.V + kChunk - 1) / kChunk;
  long long c = (long long)blockIdx.x * kWarps + w;
  float c1, c2;
  corrections(a, c1, c2);
  unsigned next = c < chunks ? two_flags(a, c * kChunk + 2 * lane) : 0u;
  for (; c < chunks; c += nwarps) {
    const unsigned mine = next;
    if (c + nwarps < chunks)
      next = two_flags(a, (c + nwarps) * kChunk + 2 * lane);
    if (__ballot_sync(0xffffffffu, mine != 0u) == 0u) continue;
    const int n = __popc(mine);
    int at = n;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, at, o);
      if (lane >= o) at += u;
    }
    const int total = __shfl_sync(0xffffffffu, at, 31);
    at -= n;
    __syncwarp();                       // the last chunk's rows are read
    for (unsigned b = mine; b; b &= b - 1u)
      rows[w][at++] = (unsigned char)(2 * lane + __ffs(b) - 1);
    __syncwarp();
    const int per = 32 / kLanes, q = lane % kLanes;
    for (int k = lane / kLanes; k < total; k += per)
      update(a, (c * kChunk + rows[w][k]) * kLanes + q, c1, c2);
  }
}

__global__ void __launch_bounds__(kThreads)
build_list(Args a, int* list, int* len) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long base = ((long long)blockIdx.x * kWarps + w) * 512;
  if (base >= a.V) return;
  const long long f0 = base + 16 * lane;
  unsigned mine = 0u;
  for (int b = 0; b < 16 && f0 + b < a.V; ++b)
    if (a.flags[f0 + b]) mine |= 1u << b;
  const int n = __popc(mine);
  int at = n;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, at, o);
    if (lane >= o) at += u;
  }
  const int total = __shfl_sync(0xffffffffu, at, 31);
  at -= n;
  if (total == 0) return;
  int start = lane == 31 ? atomicAdd(len, total) : 0;
  start = __shfl_sync(0xffffffffu, start, 31);
  for (unsigned b = mine; b; b &= b - 1u)
    list[start + at++] = (int)(f0 + __ffs(b) - 1);
}

__global__ void __launch_bounds__(kThreads)
over_list(Args a, const int* list, const int* len) {
  const long long items = (long long)__ldg(len) * kLanes;
  float c1, c2;
  corrections(a, c1, c2);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < items; i += (long long)gridDim.x * blockDim.x)
    update(a, (long long)list[i / kLanes] * kLanes + i % kLanes, c1, c2);
}

unsigned chunk_blocks(long long V, int chunk) {
  return (unsigned)(((V + chunk - 1) / chunk + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" {

// One call of design `design` (see probe_adam_chunks.py's DESIGNS) on
// table, m, v, g (V, 16) f32 with flags (V,) bytes and the step count on
// the device; scratch: V + 1 int32 for the list design.  Returns a
// cudaError_t.
int adam_design(int design, float* t, float* m, float* v, const float* g,
                const unsigned char* flags, const int* count, long long V,
                int* scratch, int sms) {
  const Args a{reinterpret_cast<float4*>(t), reinterpret_cast<float4*>(m),
               reinterpret_cast<float4*>(v),
               reinterpret_cast<const float4*>(g), flags, count, V, 1e-3f,
               0.9f, 1.f - 0.9f, 0.999f, 1.f - 0.999f, 1e-7f};
  switch (design) {
    case 0:
      per_float4<<<(unsigned)((V * kLanes + kThreads - 1) / kThreads),
                   kThreads>>>(a);
      break;
    case 1: per_chunk<16, 0><<<chunk_blocks(V, 512), kThreads>>>(a); break;
    case 2: per_chunk<4, 0><<<chunk_blocks(V, 128), kThreads>>>(a); break;
    case 3: per_chunk<2, 0><<<chunk_blocks(V, 64), kThreads>>>(a); break;
    case 4: per_chunk<1, 0><<<chunk_blocks(V, 32), kThreads>>>(a); break;
    case 5: per_chunk<4, 1><<<chunk_blocks(V, 128), kThreads>>>(a); break;
    case 6: per_chunk<1, 1><<<chunk_blocks(V, 32), kThreads>>>(a); break;
    case 8: persistent_chunks<<<sms * 4, kThreads>>>(a); break;
    case 9: persistent_chunks<<<sms * 8, kThreads>>>(a); break;
    default:
      cudaMemsetAsync(scratch, 0, sizeof(int));
      build_list<<<chunk_blocks(V, 512), kThreads>>>(a, scratch + 1,
                                                     scratch);
      over_list<<<sms * 8, kThreads>>>(a, scratch + 1, scratch);
  }
  return cudaGetLastError();
}

}  // extern "C"
