// CIN (xDeepFM) kernels for Hopper (sm_90a), f32 in and out.
//
// Replaces four Pallas TPU kernels of rec_now_tpu/ops/pallas/cin_kernel.py:
//   * cin_flat_f32      <- _cin_flat_fwd_impl / _cin_tile_kernel
//       one CIN layer  out[m, k] = sum_{f,h} W[k,f,h] * x0[m,f] * prev[m,h]
//   * cin_stack_sum_f32 <- _cin_stack_fwd_impl / _stack_fwd_kernel
//       the whole stack plus channel sum
//       out[m] = [sum_f x0[m,f]] + sum_{i<n} sum_k h_i[m,k]
//                + sum_f x0[m,f] * sum_h Wc[f,h] * h_{n-1}[m,h]
//       with the last layer collapsed, Wc = sum_k W_n[k] (exact, see
//       cin_kernel.py:307-316).
//   * cin_flat_bwd_f32      <- _cin_flat_bwd / _cin_bwd_tile_kernel
//       dx0 and dprev through A = g W in one row kernel
//       (cin_bwd_rows_kernel), dW in one weight-gradient kernel over the
//       flattened (f, h) axis (cin_wgrad_kernel); see "Backward" below.
//   * cin_stack_sum_bwd_f32 <- _cin_stack_bwd / _stack_bwd_kernel
//       dx0 (and the hidden gradients) as layer contractions with permuted
//       operands, the weight gradients through cin_wgrad_kernel.
//   Both backwards are bound by f32 FMA issue, like the forward.
//
// Taken from the math, not from the TPU blocks: the TPU kernel turns the
// broadcast of x0 over channels and the reduction over fields into 0/1
// matmuls (R, SEL) to avoid lane shuffles.  Here x0[m, f] is a plain
// shared-memory read, so a row's work is
//     t[k]   = sum_h W[k, f, h] * prev[h]        (per field f)
//     acc[k] += x0[f] * t[k]
// and no (M, F, K) or (M, F, H) intermediate ever leaves the SM.
//
// What bounds it: at config 3 (M = 8192*16 rows, F = 26, Ks = (64, 64))
// the stack does ~5.9 G multiply-adds over ~14 MB of input, ~840 FLOP per
// byte, so it is bound by arithmetic (f32 FMA, not the tensor cores:
// 67 TFLOP/s on an H100 SXM -> ~0.18 ms; memory floor ~4 us).  The design
// therefore aims at FMA issue rate, as an SGEMM micro-kernel does:
//   * the layer is a product over the (f, h) pairs,
//       out[m, k] = sum_{f,h} (x0[m, f] * prev[m, h]) * W[k, f, h],
//     so each thread keeps an RT x KT (8 x 8 at config 3) block of
//     rows x channels in registers and, per (f, h), does RT multiplies
//     and RT*KT FMAs against two float4 loads of its rows' prev values
//     and two float4 broadcasts of the 8 weights;
//   * a block owns BM = 32*RT consecutive rows (lane l has rows
//     l*RT .. l*RT+RT-1) and KC = 64 channels (one warp per 8); the x0
//     and hidden tiles live in shared memory transposed, [channel][row],
//     so a warp's row reads are contiguous; the stack's hidden layers
//     never touch device memory;
//   * weights stream through a fixed 16 KB shared chunk of
//     (FC fields x HC prev channels x KC channels), so any K, F, H fits
//     (config 3's layer-2 weight alone is 426 KB).  A small kernel first
//     lays each weight out as (F, H, K), so consecutive threads load
//     consecutive channels: coalesced reads and conflict-free shared
//     stores.  The next chunk is fetched into registers while the
//     current one is multiplied;
//   * RT (8, 4, 2 or 1) is the largest whose tiles fit the 227 KB opt-in
//     shared memory.
// bf16/TF32 tensor cores (wgmma) are not used: the plain f32 arithmetic
// keeps the comparison with the PyTorch reference tight.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#define CIN_TRY(expr)                     \
  do {                                    \
    const int rc_ = (expr);               \
    if (rc_ != cudaSuccess) return rc_;   \
  } while (0)

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int KT = 8;                   // channels per thread
constexpr int KC = kWarps * KT;         // channels per weight chunk
constexpr int FC = 4;                   // fields per weight chunk
constexpr int HC = 16;                  // prev channels per weight chunk
constexpr int kWChunk = FC * HC * KC;   // floats (16 KB)
constexpr int kPer = kWChunk / kThreads;
constexpr int kMaxLayers = 64;

struct StackWeights {
  const float* w[kMaxLayers];   // non-last layers as (F, H_{i-1}, K_i)
  int k[kMaxLayers];
};

__host__ __device__ constexpr int tile_ld(int rt) {  // 16-byte rows
  return 32 * rt + 4;
}

// Copy rows [m0, m0 + bm) of a row-major (M, C) matrix into a transposed
// shared tile dst[c * ld + m]; rows past M read as zero.  Each thread
// keeps kBatch loads in flight: a kernel stages its tiles before any work
// it could hide them behind.
constexpr int kBatch = 8;
__device__ __forceinline__ void load_tile_t(const float* __restrict__ src,
                                            int M, int C, int m0, int bm,
                                            int ld, float* __restrict__ dst) {
  const int n = bm * C;
  for (int base = threadIdx.x; base < n; base += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      const int m = idx / C;
      v[u] = (idx < n && m0 + m < M)
                 ? __ldg(src + (size_t)(m0 + m) * C + (idx - m * C))
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      if (idx < n) {
        const int m = idx / C;
        dst[(idx - m * C) * ld + m] = v[u];
      }
    }
  }
}

// v[i] = p[i], i < RT, from 16-byte aligned shared memory.
template <int RT>
__device__ __forceinline__ void load_rows(const float* __restrict__ p,
                                          float (&v)[RT]) {
  if constexpr (RT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < RT / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < RT; ++i) v[i] = p[i];
  }
}

// This thread's share of weight chunk c (fields f0 = (c / nh) * FC ..,
// prev channels h0 = (c % nh) * HC .., channels k0 ..) of Wt (F, H, K);
// element r lands at ws[threadIdx.x + r * kThreads] = chunk (f, h, k),
// k fastest.  Out-of-range entries are zero.
__device__ __forceinline__ void fetch_chunk(const float* __restrict__ Wt,
                                            int F, int H, int K, int k0,
                                            int nh, int c,
                                            float (&pre)[kPer]) {
  const int f0 = (c / nh) * FC;
  const int h0 = (c % nh) * HC;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int idx = threadIdx.x + r * kThreads;
    const int k = idx % KC;
    const int h = (idx / KC) % HC;
    const int f = idx / (KC * HC);
    pre[r] = (f0 + f < F && h0 + h < H && k0 + k < K)
                 ? __ldg(Wt + ((size_t)(f0 + f) * H + (h0 + h)) * K + k0 + k)
                 : 0.f;
  }
}

// acc[i][j] = sum_{f,h} W[k, f, h] * x0[row_i, f] * prev[row_i, h] for the
// thread's rows row_i = lane * RT + i of the tile and channels
// k = k0 + warp * KT + j, with the weight given as Wt (F, H, K).  Starts
// with a barrier, so the caller's tile writes are visible and ws is free.
template <int RT>
__device__ __forceinline__ void layer_chunk(
    const float* __restrict__ x0s, int F, const float* __restrict__ prevs,
    int H, const float* __restrict__ Wt, int K, int k0,
    float* __restrict__ ws, float (&acc)[RT][KT]) {
  constexpr int LD = tile_ld(RT);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < KT; ++j) acc[i][j] = 0.f;

  const int nh = (H + HC - 1) / HC;
  const int n_chunks = ((F + FC - 1) / FC) * nh;
  float pre[kPer];
  fetch_chunk(Wt, F, H, K, k0, nh, 0, pre);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kPer; ++r) ws[threadIdx.x + r * kThreads] = pre[r];
    __syncthreads();
    if (c + 1 < n_chunks) fetch_chunk(Wt, F, H, K, k0, nh, c + 1, pre);
    const int f0 = (c / nh) * FC;
    const int h0 = (c % nh) * HC;
    const int fn = min(FC, F - f0);
    const int hn = min(HC, H - h0);
    const float* prow = prevs + h0 * LD + lane * RT;
    for (int f = 0; f < fn; ++f) {
      float xv[RT];
      load_rows<RT>(x0s + (f0 + f) * LD + lane * RT, xv);
      const float* wrow = ws + f * HC * KC + warp * KT;
#pragma unroll 2
      for (int h = 0; h < hn; ++h) {
        float p[RT];
        load_rows<RT>(prow + h * LD, p);
        const float4 wa = *reinterpret_cast<const float4*>(wrow + h * KC);
        const float4 wb =
            *reinterpret_cast<const float4*>(wrow + h * KC + 4);
        const float w8[KT] = {wa.x, wa.y, wa.z, wa.w,
                              wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float u = xv[i] * p[i];
#pragma unroll
          for (int j = 0; j < KT; ++j) acc[i][j] = fmaf(u, w8[j], acc[i][j]);
        }
      }
    }
  }
}

// out[m, k] (=, or += with accumulate) sum_{f,h} W[k,f,h] x0[m,f] prev[m,h]
// (+ add_row[m] when add_row is given).  The backward reuses it with other
// operands in the x0 / prev / W roles (see cin_flat_bwd_f32).
template <int RT>
__global__ void __launch_bounds__(kThreads)
cin_flat_kernel(const float* __restrict__ x0, const float* __restrict__ prev,
                const float* __restrict__ Wt, float* __restrict__ out, int M,
                int F, int H, int K, int accumulate,
                const float* __restrict__ add_row) {
  constexpr int BM = 32 * RT;
  constexpr int LD = tile_ld(RT);
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // 16-byte aligned
  float* x0s = ws + kWChunk;
  float* prevs = x0s + F * LD;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * BM;
  load_tile_t(x0, M, F, m0, BM, LD, x0s);
  load_tile_t(prev, M, H, m0, BM, LD, prevs);
  for (int k0 = 0; k0 < K; k0 += KC) {
    float acc[RT][KT];
    layer_chunk<RT>(x0s, F, prevs, H, Wt, K, k0, ws, acc);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int m = m0 + lane * RT + i;
      if (m >= M) continue;
      const float base = add_row ? add_row[m] : 0.f;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int k = k0 + warp * KT + j;
        if (k >= K) continue;
        float* o = out + (size_t)m * K + k;
        *o = (accumulate ? *o : 0.f) + (acc[i][j] + base);
      }
    }
  }
}

template <int RT>
__global__ void __launch_bounds__(kThreads)
cin_stack_kernel(const float* __restrict__ x0, StackWeights sw, int n_mid,
                 const float* __restrict__ wc, float* __restrict__ out, int M,
                 int F, int h_max, int output_input) {
  constexpr int BM = 32 * RT;
  constexpr int LD = tile_ld(RT);
  constexpr int TPR = kThreads / BM;    // threads per row, last layer
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  float* x0s = ws + kWChunk;
  float* buf_a = x0s + F * LD;
  float* buf_b = buf_a + h_max * LD;
  float* red = buf_b + h_max * LD;       // kWarps * BM
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * BM;
  load_tile_t(x0, M, F, m0, BM, LD, x0s);

  float rs[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) rs[i] = 0.f;
  const float* prev = x0s;
  int H = F;
  for (int l = 0; l < n_mid; ++l) {
    float* next = (l & 1) ? buf_b : buf_a;
    const int K = sw.k[l];
    for (int k0 = 0; k0 < K; k0 += KC) {
      float acc[RT][KT];
      layer_chunk<RT>(x0s, F, prev, H, sw.w[l], K, k0, ws, acc);
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int k = k0 + warp * KT + j;
        if (k >= K) break;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          next[k * LD + lane * RT + i] = acc[i][j];
          rs[i] += acc[i][j];
        }
      }
    }
    prev = next;
    H = K;
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) red[warp * BM + lane * RT + i] = rs[i];
  __syncthreads();   // last hidden tile and all ws readers done

  // collapsed last layer: z = sum_f x0[f] * sum_h Wc[f, h] * prev[h]
  const int row = threadIdx.x % BM;
  const int part = threadIdx.x / BM;
  float z = 0.f;
  for (int f = part; f < F; f += TPR) {
    const float* wr = wc + (size_t)f * H;
    float t = 0.f;
    for (int h = 0; h < H; ++h) t = fmaf(__ldg(wr + h), prev[h * LD + row], t);
    z = fmaf(x0s[f * LD + row], t, z);
  }
  ws[part * BM + row] = z;
  __syncthreads();
  if (threadIdx.x < BM) {
    const int r = threadIdx.x;
    float total = 0.f;
    if (output_input)
      for (int f = 0; f < F; ++f) total += x0s[f * LD + r];
    for (int w = 0; w < kWarps; ++w) total += red[w * BM + r];
    for (int p = 0; p < TPR; ++p) total += ws[p * BM + r];
    if (m0 + r < M) out[m0 + r] = total;
  }
}

// wc[f, h] = sum_k W[k, f, h]: the channel-collapsed last layer.
__global__ void collapse_kernel(const float* __restrict__ W, int K, int FH,
                                float* __restrict__ wc) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= FH) return;
  float s = 0.f;
  for (int k = 0; k < K; ++k) s += W[(size_t)k * FH + idx];
  wc[idx] = s;
}

// Wt[(f * H + h) * K + k] = W[k, f, h]: the layout layer_chunk streams.
__global__ void to_fhk_kernel(const float* __restrict__ W, int K, int FH,
                              float* __restrict__ Wt) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)K * FH) return;
  const int k = (int)(idx % K);
  Wt[idx] = W[(size_t)k * FH + idx / K];
}

int to_fhk(const float* W, int K, int FH, float* Wt, cudaStream_t s) {
  const size_t n = (size_t)K * FH;
  to_fhk_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(W, K, FH, Wt);
  return cudaGetLastError();
}

size_t flat_smem(int rt, int F, int H) {
  return (kWChunk + (size_t)(F + H) * tile_ld(rt)) * sizeof(float);
}

size_t stack_smem(int rt, int F, int h_max) {
  return (kWChunk + (size_t)(F + 2 * h_max) * tile_ld(rt) +
          (size_t)kWarps * 32 * rt) * sizeof(float);
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

// Largest rows-per-thread (8, 4, 2, 1) whose tiles fit the opt-in shared
// memory, or 0.
template <typename SmemFn>
int pick_rt(int device, SmemFn smem) {
  const int cap = optin_smem(device);
  for (int rt = 8; rt >= 1; rt /= 2)
    if (smem(rt) <= (size_t)cap) return rt;
  return 0;
}

template <int RT>
int launch_flat(const float* x0, const float* prev, const float* Wt,
                float* out, int M, int F, int H, int K, int accumulate,
                const float* add_row, int device, cudaStream_t s) {
  static std::atomic<bool> done[kMaxDevices];
  CIN_TRY(allow_optin_smem((const void*)cin_flat_kernel<RT>, device, done));
  const size_t smem = flat_smem(RT, F, H);
  const int grid = (M + 32 * RT - 1) / (32 * RT);
  cin_flat_kernel<RT><<<grid, kThreads, smem, s>>>(x0, prev, Wt, out, M, F,
                                                   H, K, accumulate, add_row);
  return cudaGetLastError();
}

// One layer contraction with Wt laid out (F, H, K); see cin_flat_kernel.
int layer(const float* x0, int F, const float* prev, int H, const float* Wt,
          int K, float* out, int M, int accumulate, const float* add_row,
          int device, cudaStream_t s) {
  if (M == 0) return cudaSuccess;
  const int rt = pick_rt(device, [&](int r) { return flat_smem(r, F, H); });
  if (rt == 0) return cudaErrorInvalidValue;
  if (rt == 8)
    return launch_flat<8>(x0, prev, Wt, out, M, F, H, K, accumulate, add_row,
                          device, s);
  if (rt == 4)
    return launch_flat<4>(x0, prev, Wt, out, M, F, H, K, accumulate, add_row,
                          device, s);
  if (rt == 2)
    return launch_flat<2>(x0, prev, Wt, out, M, F, H, K, accumulate, add_row,
                          device, s);
  return launch_flat<1>(x0, prev, Wt, out, M, F, H, K, accumulate, add_row,
                        device, s);
}

template <int RT>
int launch_stack(const float* x0, const StackWeights& sw, int n_mid,
                 const float* wc, float* out, int M, int F, int h_max,
                 int output_input, int device, cudaStream_t s) {
  static std::atomic<bool> done[kMaxDevices];
  CIN_TRY(allow_optin_smem((const void*)cin_stack_kernel<RT>, device, done));
  const size_t smem = stack_smem(RT, F, h_max);
  const int grid = (M + 32 * RT - 1) / (32 * RT);
  cin_stack_kernel<RT><<<grid, kThreads, smem, s>>>(x0, sw, n_mid, wc, out, M,
                                                    F, h_max, output_input);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward.  With A[m, f, h] = sum_k g[m,k] W[k,f,h] (one multiply-add per
// (channel, f, h) a row),
//   dx0[m, f]   = sum_h A[m,f,h] prev[m,h],
//   dprev[m, h] = sum_f A[m,f,h] x0[m,f]
// cost one multiply-add per (f, h) each, so cin_flat_bwd_f32 forms A once
// in registers and never again (cin_bwd_rows_kernel).  The weight
// gradient is a reduction over rows of the flattened products,
//   dW[k, n] = sum_m g[m,k] u[m,n],  u[m, f*H + h] = x0[m,f] prev[m,h],
// which the TPU sums on its sequential grid (cin_kernel.py:210, :421).
// Here blocks run in parallel: cin_wgrad_kernel gives each block a slice
// of rows and a (64 channels x 128 flattened columns) output tile, forms u
// once per staged row, writes one partial per row slice, and
// reduce_kernel sums the partials in a fixed order (no atomics, so the
// result does not change from run to run).  Both are f32 FMA-bound like
// the forward: config 3's two layers take ~75 GFLOP of least work on
// ~204 MB of input and output (1.11 ms at 67 TFLOP/s, 61 us at 3.35 TB/s),
// so both kernels keep register tiles (8 x 4 a thread) fed from shared
// memory, as an SGEMM micro-kernel does.  cin_stack_sum_bwd_f32's
// dx0 and hidden gradients stay layer contractions with other operands
// in the x0 / prev / W roles of cin_flat_kernel:
//   dx0[m, f]   = layer(x0' = g, prev' = prev, Wt' = W laid out (K, H, F)),
//   dprev[m, h] = layer(x0' = g, prev' = x0, Wt' = W as stored (K, F, H)).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(full ? 4 : 0));
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

// The row kernel.  A block owns BM = 16 * RT rows, staged transposed
// ([channel][row]) once: g (K x BM), x0 (F x BM), prev (H x BM).  The
// prev channels go in passes of up to RB_PASS; in a pass of width hw a
// thread owns RT rows x RB_CT consecutive h of one field:
//   cg = t % S (S = hw / RB_CT rounded up to a power of two), rg = the
//   row group, fl = t / (16 S) the field within a chunk of FPC = 16 / S
//   fields,
// so a chunk's 16 * FPC * S = 256 (rows, field, h) blocks cover all
// threads, lanes of one (rows, field) are S consecutive lanes of a warp
// and no output axis pads past a multiple of RB_CT.  W is read as
// stored, (K, F*H), in chunks of FPC whole fields x RB_KT channels,
// double-buffered by cp.async (16 bytes a copy where H % 4 == 0 and W is
// aligned, else 4) into [k][fl * HP + h] (HP = RB_CT * S, the pad
// zero-filled).  Per field chunk a thread sums A over k in registers,
// then
//   dprev block += A * x0[rows, f]   (registers, the same (rows, h) in
//                                     every chunk of the pass),
//   dx0[rows, f] = sum over its S lanes of A * prev[rows, h]   (shuffles;
//                  the first lane writes it, adding to earlier passes'),
// and at the pass's end each thread writes its dprev block, or, where a
// chunk holds several fields, the FPC fields' blocks are first added in
// field order through shared memory.  dx0 and dprev are written in a
// fixed order.  At config 3's shapes the tiles take 98 KB (layer 2) and
// 78 KB (layer 1), so two blocks share an SM, one's tile loads hidden
// behind the other's work.
constexpr int RB_CT = 4;                    // h per thread
constexpr int RB_COLS = 64;                 // W columns per chunk: FPC * HP
constexpr int RB_KT = 32;                   // channels per chunk
constexpr int RB_PASS = 64;                 // h per pass
constexpr int RB_STAGE = RB_KT * RB_COLS;   // floats per chunk buffer
constexpr int RB_SUM = RB_PASS / 2;         // h of a pass summed in smem

__host__ __device__ constexpr int rows_ld(int rt) { return 16 * rt + 4; }

// The chunk buffers, which hold the pass's dprev sum at its end.
__host__ __device__ constexpr int rows_wreg(int rt) {
  return 2 * RB_STAGE > RB_SUM * rows_ld(rt) ? 2 * RB_STAGE
                                             : RB_SUM * rows_ld(rt);
}

size_t rows_smem(int rt, int F, int H, int K) {
  return (rows_wreg(rt) + (size_t)(K + F + H) * rows_ld(rt)) * sizeof(float);
}

template <int RT>
__global__ void __launch_bounds__(kThreads, 2)
cin_bwd_rows_kernel(const float* __restrict__ x0,
                    const float* __restrict__ prev,
                    const float* __restrict__ W, const float* __restrict__ g,
                    float* __restrict__ dx0, float* __restrict__ dprev,
                    int M, int F, int H, int K, int vec) {
  constexpr int BM = 16 * RT;
  constexpr int LD = rows_ld(RT);
  extern __shared__ float4 smem4[];
  float* wbuf = reinterpret_cast<float*>(smem4);   // chunks, then dprev
  float* gs = wbuf + rows_wreg(RT);                // K x LD
  float* x0s = gs + K * LD;                        // F x LD
  float* prevs = x0s + F * LD;                     // H x LD
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int FH = F * H;
  load_tile_t(g, M, K, m0, BM, LD, gs);
  load_tile_t(x0, M, F, m0, BM, LD, x0s);
  load_tile_t(prev, M, H, m0, BM, LD, prevs);
  const int nkt = (K + RB_KT - 1) / RB_KT;

  for (int h0 = 0; h0 < H; h0 += RB_PASS) {
    const int hw = min(RB_PASS, H - h0);
    int S = 1;
    while (S * RB_CT < hw) S <<= 1;
    const int FPC = 16 / S;
    const int HP = RB_CT * S;
    const int cg = t & (S - 1);
    const int rg = (t / S) & 15;
    const int fl = t / (16 * S);
    const int nsteps = ((F + FPC - 1) / FPC) * nkt;

    // chunk `step` (fields (step / nkt) * FPC .., channels
    // (step % nkt) * RB_KT ..) into buffer `buf`
    auto stage = [&](int step, int buf) {
      float* dst = wbuf + buf * RB_STAGE;
      const int f0 = (step / nkt) * FPC;
      const int k0 = (step % nkt) * RB_KT;
      if (vec) {
        for (int idx = t; idx < RB_STAGE / 4; idx += kThreads) {
          const int k = idx / (RB_COLS / 4);
          const int q = idx % (RB_COLS / 4);          // quad of the row
          const int f = f0 + q / S;
          const int h = (q % S) * 4;
          const bool ok = k0 + k < K && f < F && h < hw;
          cp_async16(dst + k * RB_COLS + q * 4,
                     ok ? W + (size_t)(k0 + k) * FH + f * H + h0 + h : W, ok);
        }
      } else {
        for (int idx = t; idx < RB_STAGE; idx += kThreads) {
          const int k = idx / RB_COLS;
          const int col = idx % RB_COLS;
          const int f = f0 + col / HP;
          const int h = col % HP;
          const bool ok = k0 + k < K && f < F && h < hw;
          cp_async4(dst + idx,
                    ok ? W + (size_t)(k0 + k) * FH + f * H + h0 + h : W, ok);
        }
      }
      cp_async_commit();
    };

    float dp[RT][RB_CT], acc[RT][RB_CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RB_CT; ++j) dp[i][j] = 0.f;
    stage(0, 0);
    for (int step = 0; step < nsteps; ++step) {
      if (step + 1 < nsteps) {
        stage(step + 1, (step + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int kt = step % nkt;
      if (kt == 0) {
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < RB_CT; ++j) acc[i][j] = 0.f;
      }
      const float* wp = wbuf + (step & 1) * RB_STAGE + fl * HP + cg * RB_CT;
      const float* gp = gs + kt * RB_KT * LD + rg * RT;
      const int kn = min(RB_KT, K - kt * RB_KT);
#pragma unroll 8
      for (int k = 0; k < kn; ++k) {
        const float4 w4 = *reinterpret_cast<const float4*>(wp + k * RB_COLS);
        const float w[RB_CT] = {w4.x, w4.y, w4.z, w4.w};
        float gv[RT];
        load_rows<RT>(gp + k * LD, gv);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < RB_CT; ++j)
            acc[i][j] = fmaf(gv[i], w[j], acc[i][j]);
      }
      const int f = (step / nkt) * FPC + fl;
      // uniform across a warp where S > 1 (a warp holds one field)
      if (kt == nkt - 1 && f < F) {
        float xv[RT], part[RT];
        load_rows<RT>(x0s + f * LD + rg * RT, xv);
#pragma unroll
        for (int i = 0; i < RT; ++i) part[i] = 0.f;
#pragma unroll
        for (int j = 0; j < RB_CT; ++j) {
          const int h = cg * RB_CT + j;
          if (h < hw) {
            float pv[RT];
            load_rows<RT>(prevs + (h0 + h) * LD + rg * RT, pv);
#pragma unroll
            for (int i = 0; i < RT; ++i) {
              part[i] = fmaf(acc[i][j], pv[i], part[i]);
              dp[i][j] = fmaf(acc[i][j], xv[i], dp[i][j]);
            }
          }
        }
        for (int o = S / 2; o > 0; o >>= 1)
#pragma unroll
          for (int i = 0; i < RT; ++i)
            part[i] += __shfl_xor_sync(0xffffffffu, part[i], o);
        if (cg == 0) {
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const int m = m0 + rg * RT + i;
            if (m < M) {
              float* d = dx0 + (size_t)m * F + f;
              *d = (h0 ? *d : 0.f) + part[i];
            }
          }
        }
      }
      __syncthreads();   // buffer step & 1 is refilled next step
    }

    if (FPC == 1) {      // the thread's block is the pass's dprev there
      const bool v4 = H % 4 == 0 && cg * RB_CT + 3 < hw &&
                      reinterpret_cast<uintptr_t>(dprev) % 16 == 0;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int m = m0 + rg * RT + i;
        if (m >= M) continue;
        float* d = dprev + (size_t)m * H + h0 + cg * RB_CT;
        if (v4) {
          *reinterpret_cast<float4*>(d) =
              make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
        } else {
#pragma unroll
          for (int j = 0; j < RB_CT; ++j)
            if (cg * RB_CT + j < hw) d[j] = dp[i][j];
        }
      }
      continue;          // wbuf is restaged after the loop's last barrier
    }
    // the FPC fields' blocks added in field order (HP <= RB_SUM here)
    float* dps = wbuf;   // [h][row], RB_SUM x LD
    for (int r = 0; r < FPC; ++r) {
      if (fl == r) {
#pragma unroll
        for (int j = 0; j < RB_CT; ++j) {
          float* d = dps + (cg * RB_CT + j) * LD + rg * RT;
#pragma unroll
          for (int i = 0; i < RT; ++i) d[i] = (r ? d[i] : 0.f) + dp[i][j];
        }
      }
      __syncthreads();
    }
    for (int idx = t; idx < BM * hw; idx += kThreads) {
      const int m = idx / hw;
      const int h = idx - m * hw;
      if (m0 + m < M) dprev[(size_t)(m0 + m) * H + h0 + h] = dps[h * LD + m];
    }
    __syncthreads();   // wbuf is staged again by the next pass
  }
}

template <int RT>
int launch_rows(const float* x0, const float* prev, const float* W,
                const float* g, float* dx0, float* dprev, int M, int F,
                int H, int K, int vec, int device, cudaStream_t s) {
  static std::atomic<bool> done[kMaxDevices];
  CIN_TRY(allow_optin_smem((const void*)cin_bwd_rows_kernel<RT>, device,
                           done));
  const int grid = (M + 16 * RT - 1) / (16 * RT);
  cin_bwd_rows_kernel<RT><<<grid, kThreads, rows_smem(RT, F, H, K), s>>>(
      x0, prev, W, g, dx0, dprev, M, F, H, K, vec);
  return cudaGetLastError();
}

// dx0 (M, F) and dprev (M, H) of one layer for g (M, K).
int bwd_rows(const float* x0, const float* prev, const float* W,
             const float* g, float* dx0, float* dprev, int M, int F, int H,
             int K, int device, cudaStream_t s) {
  if (M == 0) return cudaSuccess;
  const int rt = pick_rt(device, [&](int r) {
    return rows_smem(r, F, H, K); });
  if (rt == 0) return cudaErrorInvalidValue;
  const int vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
  if (rt == 8)
    return launch_rows<8>(x0, prev, W, g, dx0, dprev, M, F, H, K, vec,
                          device, s);
  if (rt == 4)
    return launch_rows<4>(x0, prev, W, g, dx0, dprev, M, F, H, K, vec,
                          device, s);
  if (rt == 2)
    return launch_rows<2>(x0, prev, W, g, dx0, dprev, M, F, H, K, vec,
                          device, s);
  return launch_rows<1>(x0, prev, W, g, dx0, dprev, M, F, H, K, vec, device,
                        s);
}

// The weight-gradient kernel.  Block (tile, split) computes
//   part[split][k][n] = sum over rows m of its slice of A[m,k] U[m,n],
//   U[m, f*H + h] = X[m,f] P[m,h],
// for a WG_KT x WG_NT tile of (k, n): nothing pads past the ragged last
// tile of the flattened F*H axis.  Each thread stages one fixed column of
// U (its f, h found once) for every other row, forming the product as it
// stages, and holds 8 channels x 4 columns in registers; the next WG_RB
// rows are fetched into registers while the current ones are multiplied.
// The partials are written as float4 where N % 4 == 0 and the scratch is
// 16-byte aligned (cin_stack_sum_bwd_f32 hands in an offset of its own).
constexpr int WG_KT = 64;    // channels per tile
constexpr int WG_NT = 128;   // flattened (f, h) columns per tile
constexpr int WG_RB = 32;    // rows staged at a time
constexpr int WG_UP = WG_RB * WG_NT / kThreads;   // U values a thread stages
constexpr int WG_AP = WG_RB * WG_KT / kThreads;   // A values a thread stages

__global__ void __launch_bounds__(kThreads)
cin_wgrad_kernel(const float* __restrict__ A, int K,
                 const float* __restrict__ X, int F,
                 const float* __restrict__ P, int H, int M, int rows,
                 float* __restrict__ part) {
  __shared__ __align__(16) float as[WG_RB][WG_KT + 4];
  __shared__ __align__(16) float us[WG_RB][WG_NT + 4];
  const int N = F * H;
  const int nn = (N + WG_NT - 1) / WG_NT;
  const int n0 = (blockIdx.x % nn) * WG_NT;
  const int k0 = (blockIdx.x / nn) * WG_KT;
  const int t = threadIdx.x;
  const int uc = t % WG_NT, ur = t / WG_NT;   // staging: column, first row
  const int un = n0 + uc;
  const bool u_ok = un < N;
  const int uf = u_ok ? un / H : 0;
  const int uh = u_ok ? un - uf * H : 0;
  const int ac = t % WG_KT, ar = t / WG_KT;
  const bool a_ok = k0 + ac < K;
  // compute: 8 channels (kg) x 4 columns (ng); a warp holds 4 kg x 8 ng,
  // so its reads of both operands are mostly broadcasts
  const int lane = t % 32, warp = t / 32;
  const int kg = (warp & 1) * 4 + lane / 8;
  const int ng = (warp >> 1) * 8 + lane % 8;
  const int m_begin = blockIdx.y * rows;
  const int m_end = min(M, m_begin + rows);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // raw x0 and prev values: their product is formed when they are
  // stored, so no instruction waits on the loads before the multiply loop
  float px[WG_UP], pp[WG_UP], pa[WG_AP];
  auto fetch = [&](int r0) {
#pragma unroll
    for (int i = 0; i < WG_UP; ++i) {
      const int m = r0 + ur + i * (kThreads / WG_NT);
      const bool ok = u_ok && m < m_end;
      px[i] = ok ? __ldg(X + (size_t)m * F + uf) : 0.f;
      pp[i] = ok ? __ldg(P + (size_t)m * H + uh) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < WG_AP; ++i) {
      const int m = r0 + ar + i * (kThreads / WG_KT);
      pa[i] = (a_ok && m < m_end) ? __ldg(A + (size_t)m * K + k0 + ac) : 0.f;
    }
  };
  if (m_begin < m_end) fetch(m_begin);
  for (int r0 = m_begin; r0 < m_end; r0 += WG_RB) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < WG_UP; ++i)
      us[ur + i * (kThreads / WG_NT)][uc] = px[i] * pp[i];
#pragma unroll
    for (int i = 0; i < WG_AP; ++i) as[ar + i * (kThreads / WG_KT)][ac] = pa[i];
    __syncthreads();
    if (r0 + WG_RB < m_end) fetch(r0 + WG_RB);
#pragma unroll
    for (int r = 0; r < WG_RB; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[r][kg * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[r][kg * 8 + 4]);
      const float4 u4 = *reinterpret_cast<const float4*>(&us[r][ng * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float u[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], u[j], acc[i][j]);
    }
  }
  float* dst = part + (size_t)blockIdx.y * K * N;
  const int n = n0 + ng * 4;
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + kg * 8 + i;
    if (k >= K) continue;
    float* o = dst + (size_t)k * N + n;
    if (vec && n + 3 < N) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) o[j] = acc[i][j];
    }
  }
}

// out[i] = sum_s part[s * n + i], s in order.
__global__ void reduce_kernel(const float* __restrict__ part, int splits,
                              size_t n, float* __restrict__ out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += part[(size_t)p * n + i];
    out[i] = s;
  }
}

// Blocks of cin_wgrad_kernel resident on one SM, cached per device; 0
// when the query fails.
int wgrad_resident(int device) {
  static std::atomic<int> slots[kMaxDevices];
  return per_device(device, slots, [](int* v) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(v, cin_wgrad_kernel,
                                                         kThreads, 0); });
}

// Row slices of one weight gradient (K, N = F*H) over M rows: as many
// blocks as the card holds at once (one full wave, each block the same
// rows, so no tail and the fewest partials), at most one a WG_RB rows;
// 0 when M is 0, -1 when the device cannot be read.
int wgrad_splits(int M, int K, int N, int device) {
  if (M == 0) return 0;
  const int slots = sm_count(device) * wgrad_resident(device);
  if (slots == 0) return -1;
  const int tiles = ((N + WG_NT - 1) / WG_NT) * ((K + WG_KT - 1) / WG_KT);
  const int want = slots / tiles;
  const int most = (M + WG_RB - 1) / WG_RB;
  return want < 1 ? 1 : (want > most ? most : want);
}

// out (K, F, H) = sum_m A[m,k] X[m,f] P[m,h]; part holds
// wgrad_splits(M, K, F * H, device) * K * F * H floats.
int weight_grad(const float* A, int K, const float* X, int F, const float* P,
                int H, int M, float* part, float* out, int device,
                cudaStream_t s) {
  const int N = F * H;
  const size_t n = (size_t)K * N;
  const int splits = wgrad_splits(M, K, N, device);
  if (splits < 0) return cudaErrorInvalidValue;
  if (splits == 0) return cudaMemsetAsync(out, 0, n * sizeof(float), s);
  const int per = (M + splits - 1) / splits;
  const int rows = (per + WG_RB - 1) / WG_RB * WG_RB;
  const int tiles = ((N + WG_NT - 1) / WG_NT) * ((K + WG_KT - 1) / WG_KT);
  cin_wgrad_kernel<<<dim3(tiles, splits), kThreads, 0, s>>>(A, K, X, F, P, H,
                                                            M, rows, part);
  CIN_TRY(cudaGetLastError());
  const size_t want = (n + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  reduce_kernel<<<blocks, 256, 0, s>>>(part, splits, n, out);
  return cudaGetLastError();
}

// Wt[(k * H + h) * F + f] = W[(k * F + f) * H + h]: (K, F, H) -> (K, H, F).
__global__ void to_khf_kernel(const float* __restrict__ W, int K, int F,
                              int H, float* __restrict__ Wt) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)K * F * H) return;
  const int f = (int)(idx % F);
  const size_t kh = idx / F;
  const int h = (int)(kh % H);
  const int k = (int)(kh / H);
  Wt[idx] = W[((size_t)k * F + f) * H + h];
}

int to_khf(const float* W, int K, int F, int H, float* Wt, cudaStream_t s) {
  const size_t n = (size_t)K * F * H;
  to_khf_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(W, K, F, H, Wt);
  return cudaGetLastError();
}

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

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x0 (M, F), prev (M, H), W (K, F, H) -> out (M, K); all f32, contiguous;
// scratch holds K * F * H floats.  Returns a cudaError_t (0 on success).
int cin_flat_f32(const float* x0, const float* prev, const float* W,
                 float* scratch, float* out, int M, int F, int H, int K,
                 int device, void* stream) {
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = to_fhk(W, K, F * H, scratch, s);
  if (rc != cudaSuccess) return rc;
  return layer(x0, F, prev, H, scratch, K, out, M, 0, nullptr, device, s);
}

// x0 (M, F); weights[i] (ks[i], F, H_{i-1}) with H_0 = F, i < n_layers;
// out (M,).  scratch holds sum_{i < n-1} ks[i] * F * H_{i-1} floats (the
// non-last weights as (F, H, K)) plus F * H_{n-1} (the collapsed last
// layer).  Returns a cudaError_t (0 on success).
int cin_stack_sum_f32(const float* x0, const float* const* weights,
                      const int* ks, int n_layers, float* scratch, float* out,
                      int M, int F, int output_input, int device,
                      void* stream) {
  if (n_layers < 1 || n_layers - 1 > kMaxLayers) return cudaErrorInvalidValue;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_mid = n_layers - 1;
  int h_max = 0;
  for (int l = 0; l < n_mid; ++l) h_max = ks[l] > h_max ? ks[l] : h_max;
  const int rt =
      pick_rt(device, [&](int r) { return stack_smem(r, F, h_max); });
  if (rt == 0) return cudaErrorInvalidValue;
  StackWeights sw = {};
  int h = F;
  for (int l = 0; l < n_mid; ++l) {
    int rc = to_fhk(weights[l], ks[l], F * h, scratch, s);
    if (rc != cudaSuccess) return rc;
    sw.w[l] = scratch;
    sw.k[l] = ks[l];
    scratch += (size_t)ks[l] * F * h;
    h = ks[l];
  }
  const int fh = F * h;
  collapse_kernel<<<(fh + 255) / 256, 256, 0, s>>>(weights[n_mid], ks[n_mid],
                                                    fh, scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (rt == 8)
    return launch_stack<8>(x0, sw, n_mid, scratch, out, M, F, h_max,
                           output_input, device, s);
  if (rt == 4)
    return launch_stack<4>(x0, sw, n_mid, scratch, out, M, F, h_max,
                           output_input, device, s);
  if (rt == 2)
    return launch_stack<2>(x0, sw, n_mid, scratch, out, M, F, h_max,
                           output_input, device, s);
  return launch_stack<1>(x0, sw, n_mid, scratch, out, M, F, h_max,
                         output_input, device, s);
}

// Floats of partial sums that one weight gradient of K x N values over M
// rows needs (cin_flat_bwd_f32's scratch, with N = F * H), or -1 when
// the device cannot be read.
long long cin_dw_scratch(int M, int K, int N, int device) {
  const int splits = wgrad_splits(M, K, N, device);
  return splits < 0 ? -1 : (long long)splits * K * N;
}

// The backward of cin_flat_f32: x0 (M, F), prev (M, H), W (K, F, H),
// g (M, K) -> dx0 (M, F), dprev (M, H), dW (K, F, H).  scratch holds
// cin_dw_scratch(M, K, F * H, device) floats.
int cin_flat_bwd_f32(const float* x0, const float* prev, const float* W,
                     const float* g, float* scratch, float* dx0,
                     float* dprev, float* dW, int M, int F, int H, int K,
                     int device, void* stream) {
  CIN_TRY(use_device(device));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CIN_TRY(bwd_rows(x0, prev, W, g, dx0, dprev, M, F, H, K, device, s));
  return weight_grad(g, K, x0, F, prev, H, M, scratch, dW, device, s);
}

// Floats of scratch cin_stack_sum_bwd_f32 needs for these layers, or -1
// when the device cannot be read.
long long cin_stack_bwd_scratch(const int* ks, int n_layers, int M, int F,
                                int device) {
  const int n_mid = n_layers - 1;
  long long total = 0, hid = 0, h_max = 0;
  int h = F;
  // the collapsed layer's weight gradient: K' = F, N = H_{n-1} (below)
  for (int l = 0; l < n_mid; ++l) {
    total += 2LL * ks[l] * F * h;            // (F, H, K) and (K, H, F)
    hid += ks[l];
    h_max = ks[l] > h_max ? ks[l] : h_max;
    h = ks[l];
  }
  long long dw_max = cin_dw_scratch(M, F, h, device);
  h = F;
  for (int l = 0; l < n_mid; ++l) {
    const long long n = cin_dw_scratch(M, ks[l], F * h, device);
    dw_max = n > dw_max ? n : dw_max;
    h = ks[l];
  }
  if (dw_max < 0) return -1;
  total += 2LL * F * h;                      // Wc and its transpose
  return total + (long long)M * (hid + 2 * h_max) + dw_max;
}

// The backward of cin_stack_sum_f32 (replaces _cin_stack_bwd,
// cin_kernel.py:519-568): x0 (M, F), the layers' weights, g (M,) ->
// dx0 (M, F), dws[l] (K_l, F, H_{l-1}) for the non-last layers and
// dwc (F, H_{n-1}), the gradient every channel of the last layer shares.
// The hidden layers are recomputed into scratch (M x K_l each); the
// gradient into each hidden layer is g from the channel sum plus what
// flows back from the layer above.
int cin_stack_sum_bwd_f32(const float* x0, const float* g,
                          const float* const* weights, const int* ks,
                          int n_layers, float* scratch, float* dx0,
                          float* const* dws, float* dwc, int M, int F,
                          int output_input, int device, void* stream) {
  if (n_layers < 1 || n_layers - 1 > kMaxLayers) return cudaErrorInvalidValue;
  CIN_TRY(use_device(device));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_mid = n_layers - 1;
  int hin[kMaxLayers + 1];
  hin[0] = F;
  for (int l = 0; l < n_mid; ++l) hin[l + 1] = ks[l];
  const int hl = hin[n_mid];
  long long h_max = 0;
  for (int l = 0; l < n_mid; ++l) h_max = ks[l] > h_max ? ks[l] : h_max;

  // scratch: relaid weights, Wc, Wc^T, hiddens, two dh buffers, partials
  const float* w_fhk[kMaxLayers];
  const float* w_khf[kMaxLayers];
  float* hid[kMaxLayers];
  float* p = scratch;
  for (int l = 0; l < n_mid; ++l) {
    const size_t n = (size_t)ks[l] * F * hin[l];
    CIN_TRY(to_fhk(weights[l], ks[l], F * hin[l], p, s));
    w_fhk[l] = p;
    p += n;
    CIN_TRY(to_khf(weights[l], ks[l], F, hin[l], p, s));
    w_khf[l] = p;
    p += n;
  }
  float* wc = p;
  p += (size_t)F * hl;
  float* wct = p;
  p += (size_t)F * hl;
  collapse_kernel<<<(F * hl + 255) / 256, 256, 0, s>>>(
      weights[n_mid], ks[n_mid], F * hl, wc);
  CIN_TRY(cudaGetLastError());
  CIN_TRY(to_khf(wc, 1, F, hl, wct, s));     // (F, H) -> (H, F)
  for (int l = 0; l < n_mid; ++l) {
    hid[l] = p;
    p += (size_t)M * ks[l];
  }
  float* dh_buf[2] = {p, p + (size_t)M * h_max};
  p += 2 * (size_t)M * h_max;
  float* part = p;

  // recompute the hidden layers
  for (int l = 0; l < n_mid; ++l)
    CIN_TRY(layer(x0, F, l ? hid[l - 1] : x0, hin[l], w_fhk[l], ks[l],
                  hid[l], M, 0, nullptr, device, s));
  const float* h_last = n_mid ? hid[n_mid - 1] : x0;

  // collapsed last layer: out += sum_f x0[f] sum_h Wc[f,h] h_last[h]
  CIN_TRY(layer(g, 1, h_last, hl, wct, F, dx0, M, 0,
                output_input ? g : nullptr, device, s));
  CIN_TRY(weight_grad(x0, F, g, 1, h_last, hl, M, part, dwc, device, s));
  if (n_mid == 0)                            // h_last is x0 itself
    return layer(g, 1, x0, F, wc, F, dx0, M, 1, nullptr, device, s);
  int cur = 0;
  CIN_TRY(layer(g, 1, x0, F, wc, hl, dh_buf[cur], M, 0, g, device, s));
  for (int l = n_mid - 1; l >= 0; --l) {
    const float* dh = dh_buf[cur];
    const float* prev = l ? hid[l - 1] : x0;
    CIN_TRY(layer(dh, ks[l], prev, hin[l], w_khf[l], F, dx0, M, 1, nullptr,
                  device, s));
    CIN_TRY(weight_grad(dh, ks[l], x0, F, prev, hin[l], M, part, dws[l],
                        device, s));
    if (l == 0) {                            // prev is x0
      CIN_TRY(layer(dh, ks[l], x0, F, weights[l], F, dx0, M, 1, nullptr,
                    device, s));
    } else {                                 // + g: h_l's channel sum
      CIN_TRY(layer(dh, ks[l], x0, F, weights[l], hin[l], dh_buf[1 - cur], M,
                    0, g, device, s));
      cur = 1 - cur;
    }
  }
  return cudaSuccess;
}

}  // extern "C"
