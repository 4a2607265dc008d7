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
//   * cin_stack_sum_bwd_f32 <- _cin_stack_bwd / _stack_bwd_kernel
//       dx0 (and dprev) as layer contractions with permuted operands, the
//       weight gradients as a row reduction (cin_dw_kernel) in two passes;
//       see "Backward" below.  Both are bound by f32 FMA issue, like the
//       forward.
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
// shared tile dst[c * ld + m]; rows past M read as zero.
__device__ __forceinline__ void load_tile_t(const float* __restrict__ src,
                                            int M, int C, int m0, int bm,
                                            int ld, float* __restrict__ dst) {
  for (int idx = threadIdx.x; idx < bm * C; idx += kThreads) {
    const int m = idx / C;
    const int c = idx - m * C;
    dst[c * ld + m] =
        (m0 + m < M) ? src[(size_t)(m0 + m) * C + c] : 0.f;
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

// Largest rows-per-thread (8, 4, 2, 1) whose tiles fit the opt-in shared
// memory, or 0.
template <typename SmemFn>
int pick_rt(int device, SmemFn smem) {
  int cap = 0;
  if (cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  for (int rt = 8; rt >= 1; rt /= 2)
    if (smem(rt) <= (size_t)cap) return rt;
  return 0;
}

template <int RT>
int launch_flat(const float* x0, const float* prev, const float* Wt,
                float* out, int M, int F, int H, int K, int accumulate,
                const float* add_row, cudaStream_t s) {
  const size_t smem = flat_smem(RT, F, H);
  cudaError_t e = cudaFuncSetAttribute(
      cin_flat_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
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
                          s);
  if (rt == 4)
    return launch_flat<4>(x0, prev, Wt, out, M, F, H, K, accumulate, add_row,
                          s);
  if (rt == 2)
    return launch_flat<2>(x0, prev, Wt, out, M, F, H, K, accumulate, add_row,
                          s);
  return launch_flat<1>(x0, prev, Wt, out, M, F, H, K, accumulate, add_row,
                        s);
}

template <int RT>
int launch_stack(const float* x0, const StackWeights& sw, int n_mid,
                 const float* wc, float* out, int M, int F, int h_max,
                 int output_input, cudaStream_t s) {
  const size_t smem = stack_smem(RT, F, h_max);
  cudaError_t e = cudaFuncSetAttribute(
      cin_stack_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int grid = (M + 32 * RT - 1) / (32 * RT);
  cin_stack_kernel<RT><<<grid, kThreads, smem, s>>>(x0, sw, n_mid, wc, out, M,
                                                    F, h_max, output_input);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward.  Every d/d(x0), d/d(prev) term is again a layer contraction,
// with other operands in the x0 / prev / W roles of cin_flat_kernel:
//   dx0[m, f]   = sum_{k,h} g[m,k] prev[m,h] W[k,f,h]
//               = layer(x0' = g, prev' = prev, W'[f][k][h] = W[k,f,h]),
//                 i.e. Wt' (F'=K, H'=H, K'=F) = W laid out (K, H, F);
//   dprev[m, h] = sum_{k,f} g[m,k] x0[m,f] W[k,f,h]
//               = layer(x0' = g, prev' = x0, Wt' = W as stored (K, F, H)).
// The weight gradient is a reduction over rows,
//   dW[k, f, h] = sum_m g[m,k] x0[m,f] prev[m,h],
// which the TPU sums on its sequential grid (cin_kernel.py:210, :421).
// Here blocks run in parallel: cin_dw_kernel gives each block a slice of
// rows and a (4 fields x 64 channels x 64 prev channels) output tile held
// in registers (8 x 8 per thread), writes one partial per row slice, and
// reduce_kernel sums the partials in a fixed order (no atomics, so the
// result does not change from run to run).
// ---------------------------------------------------------------------------

constexpr int DW_FC = 4;        // fields per block
constexpr int DW_KB = 64;       // channels per block
constexpr int DW_HB = 64;       // prev channels per block
constexpr int DW_RB = 32;       // rows staged in shared memory at a time
constexpr int DW_ROWS = 1024;   // rows per partial

// part[s][k][f][h] = sum over rows m of slice s of A[m,k] X[m,f] P[m,h].
__global__ void __launch_bounds__(kThreads)
cin_dw_kernel(const float* __restrict__ A, int K, const float* __restrict__ X,
              int F, const float* __restrict__ P, int H, int M,
              float* __restrict__ part) {
  __shared__ __align__(16) float as[DW_RB][DW_KB];
  __shared__ __align__(16) float ps[DW_RB][DW_HB];
  __shared__ float xs[DW_RB][DW_FC];
  const int nk = (K + DW_KB - 1) / DW_KB;
  const int nh = (H + DW_HB - 1) / DW_HB;
  int tile = blockIdx.x;
  const int k0 = (tile % nk) * DW_KB;
  tile /= nk;
  const int h0 = (tile % nh) * DW_HB;
  const int f0 = (tile / nh) * DW_FC;
  const int t = threadIdx.x;
  const int fl = t >> 6;            // field of this thread
  const int kb = (t >> 3) & 7;      // its 8 channels
  const int hb = t & 7;             // its 8 prev channels
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int m_begin = blockIdx.y * DW_ROWS;
  const int m_end = min(M, m_begin + DW_ROWS);
  for (int r0 = m_begin; r0 < m_end; r0 += DW_RB) {
    __syncthreads();
    for (int idx = t; idx < DW_RB * DW_KB; idx += kThreads) {
      const int r = idx / DW_KB;
      const int c = idx - r * DW_KB;
      const int m = r0 + r;
      as[r][c] = (m < m_end && k0 + c < K) ? A[(size_t)m * K + k0 + c] : 0.f;
      ps[r][c] = (m < m_end && h0 + c < H) ? P[(size_t)m * H + h0 + c] : 0.f;
    }
    if (t < DW_RB * DW_FC) {
      const int r = t / DW_FC;
      const int c = t - r * DW_FC;
      const int m = r0 + r;
      xs[r][c] = (m < m_end && f0 + c < F) ? X[(size_t)m * F + f0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < DW_RB; ++r) {
      const float xv = xs[r][fl];
      const float4 a0 = *reinterpret_cast<const float4*>(&as[r][kb * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[r][kb * 8 + 4]);
      const float4 p0 = *reinterpret_cast<const float4*>(&ps[r][hb * 8]);
      const float4 p1 = *reinterpret_cast<const float4*>(&ps[r][hb * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float p[8] = {xv * p0.x, xv * p0.y, xv * p0.z, xv * p0.w,
                          xv * p1.x, xv * p1.y, xv * p1.z, xv * p1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], p[j], acc[i][j]);
    }
  }
  const int f = f0 + fl;
  if (f >= F) return;
  float* dst = part + (size_t)blockIdx.y * K * F * H;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + kb * 8 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int h = h0 + hb * 8 + j;
      if (h < H) dst[((size_t)k * F + f) * H + h] = acc[i][j];
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

int dw_splits(int M) { return (M + DW_ROWS - 1) / DW_ROWS; }

// out (K, F, H) = sum_m A[m,k] X[m,f] P[m,h]; part holds
// dw_splits(M) * K * F * H floats.
int weight_grad(const float* A, int K, const float* X, int F, const float* P,
                int H, int M, float* part, float* out, cudaStream_t s) {
  const size_t n = (size_t)K * F * H;
  const int splits = dw_splits(M);
  if (splits == 0) return cudaMemsetAsync(out, 0, n * sizeof(float), s);
  const int tiles = ((F + DW_FC - 1) / DW_FC) * ((H + DW_HB - 1) / DW_HB) *
                    ((K + DW_KB - 1) / DW_KB);
  cin_dw_kernel<<<dim3(tiles, splits), kThreads, 0, s>>>(A, K, X, F, P, H, M,
                                                         part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
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

#define CIN_TRY(expr)                     \
  do {                                    \
    const int rc_ = (expr);               \
    if (rc_ != cudaSuccess) return rc_;   \
  } while (0)

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
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaGetLastError();
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
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaGetLastError();
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
                           output_input, s);
  if (rt == 4)
    return launch_stack<4>(x0, sw, n_mid, scratch, out, M, F, h_max,
                           output_input, s);
  if (rt == 2)
    return launch_stack<2>(x0, sw, n_mid, scratch, out, M, F, h_max,
                           output_input, s);
  return launch_stack<1>(x0, sw, n_mid, scratch, out, M, F, h_max,
                         output_input, s);
}

// Floats of part-sum scratch that cin_flat_bwd_f32 and
// cin_stack_sum_bwd_f32 need for one weight gradient of n = K * F * H
// values over M rows.
long long cin_dw_scratch(int M, long long n) { return dw_splits(M) * n; }

// The backward of cin_flat_f32: x0 (M, F), prev (M, H), W (K, F, H),
// g (M, K) -> dx0 (M, F), dprev (M, H), dW (K, F, H).  scratch holds
// K * F * H + cin_dw_scratch(M, K * F * H) floats.
int cin_flat_bwd_f32(const float* x0, const float* prev, const float* W,
                     const float* g, float* scratch, float* dx0,
                     float* dprev, float* dW, int M, int F, int H, int K,
                     int device, void* stream) {
  CIN_TRY(cudaSetDevice(device));
  cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w_khf = scratch;
  float* part = scratch + (size_t)K * F * H;
  CIN_TRY(to_khf(W, K, F, H, w_khf, s));
  CIN_TRY(layer(g, K, prev, H, w_khf, F, dx0, M, 0, nullptr, device, s));
  CIN_TRY(layer(g, K, x0, F, W, H, dprev, M, 0, nullptr, device, s));
  return weight_grad(g, K, x0, F, prev, H, M, part, dW, s);
}

// Floats of scratch cin_stack_sum_bwd_f32 needs for these layers.
long long cin_stack_bwd_scratch(const int* ks, int n_layers, int M, int F) {
  const int n_mid = n_layers - 1;
  long long total = 0, hid = 0, h_max = 0, dw_max = 0;
  int h = F;
  for (int l = 0; l < n_mid; ++l) {
    total += 2LL * ks[l] * F * h;            // (F, H, K) and (K, H, F)
    hid += ks[l];
    h_max = ks[l] > h_max ? ks[l] : h_max;
    const long long n = (long long)ks[l] * F * h;
    dw_max = n > dw_max ? n : dw_max;
    h = ks[l];
  }
  total += 2LL * F * h;                      // Wc and its transpose
  dw_max = (long long)F * h > dw_max ? (long long)F * h : dw_max;
  return total + (long long)M * (hid + 2 * h_max) + dw_splits(M) * dw_max;
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
  CIN_TRY(cudaSetDevice(device));
  cudaGetLastError();
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
  CIN_TRY(weight_grad(x0, F, g, 1, h_last, hl, M, part, dwc, s));
  if (n_mid == 0)                            // h_last is x0 itself
    return layer(g, 1, x0, F, wc, F, dx0, M, 1, nullptr, device, s);
  int cur = 0;
  CIN_TRY(layer(g, 1, x0, F, wc, hl, dh_buf[cur], M, 0, g, device, s));
  for (int l = n_mid - 1; l >= 0; --l) {
    const float* dh = dh_buf[cur];
    const float* prev = l ? hid[l - 1] : x0;
    CIN_TRY(layer(dh, ks[l], prev, hin[l], w_khf[l], F, dx0, M, 1, nullptr,
                  device, s));
    CIN_TRY(weight_grad(dh, ks[l], x0, F, prev, hin[l], M, part, dws[l], s));
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
