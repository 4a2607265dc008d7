// CIN (xDeepFM) kernels for Hopper (sm_90a), f32 in and out.
//
// Replaces four Pallas TPU kernels of rec_now_tpu/ops/pallas/cin_kernel.py:
//   * cin_flat_f32      <- _cin_flat_fwd_impl / _cin_tile_kernel
//       one CIN layer  out[m, k] = sum_{f,h} W[k,f,h] * x0[m,f] * prev[m,h]
//       on the tensor cores in split TF32: layer() routes by shape, to
//       cin_layer_tc_kernel (wgmma fed by TMA, W folded and split once a
//       call, layer 1 on its symmetric pairs; see "The forward layer on
//       Hopper's warpgroup MMA") or to cin_layer_mma_kernel (mma.sync:
//       fewer than 8 h or 32 channels, one field, accumulate or add_row,
//       and the callers without scratch: the stack's and the backward's).
//   * cin_stack_sum_f32 <- _cin_stack_fwd_impl / _stack_fwd_kernel
//       the whole stack plus channel sum
//       out[m] = [sum_f x0[m,f]] + sum_{i<n} sum_k h_i[m,k]
//                + sum_f x0[m,f] * sum_h Wc[f,h] * h_{n-1}[m,h]
//       with the last layer collapsed, Wc = sum_k W_n[k] (exact, see
//       cin_kernel.py:307-316); one block keeps the stack on chip, layer 1
//       on the tensor cores over its symmetric pairs (cin_stack_tc_kernel,
//       see "The stack forward" below).
//   * cin_flat_bwd_f32      <- _cin_flat_bwd / _cin_bwd_tile_kernel
//       dx0 and dprev through A = g W in one row kernel
//       (cin_bwd_rows_kernel), dW in one weight-gradient kernel over the
//       flattened (f, h) axis (cin_wgrad_kernel); see "Backward" below.
//   * cin_stack_sum_bwd_f32 <- _cin_stack_bwd / _stack_bwd_kernel
//       the hidden layers recomputed once by cin_layer_mma_kernel, each
//       layer's input gradients through the row kernel and its weight
//       gradient through cin_wgrad_kernel.
//
// Taken from the math, not from the TPU blocks: the TPU kernel turns the
// broadcast of x0 over channels and the reduction over fields into 0/1
// matmuls (R, SEL) to avoid lane shuffles.  Here x0[m, f] is a plain
// shared-memory read, and no (M, F, K) or (M, F, H) intermediate ever
// leaves the SM.
//
// What bounds them: at config 3 (M = 8192*16 rows, F = 26, Ks = (64, 64))
// every kernel here does hundreds of operations per byte it must move, so
// each is bound by arithmetic.
//   * The forward layer is a GEMM over the flattened (f, h) axis with a
//     cheap A operand, x0[m,f] * prev[m,h], so it runs on the tensor cores
//     in split TF32: three TF32 products per multiply-add at 495 TFLOP/s
//     have 2.5x the 67 TFLOP/s of f32 FMA.  Config 3's two layers are
//     33.8 GFLOP of least work: 0.205 ms at the split-TF32 rate, 0.509 at
//     the f32 rate; xDeepFM's three at B = 8,192 1.61e12 flops, 3.3 ms.
//     Only wgmma reaches the tensor cores' full rate on Hopper, so B2's
//     shapes run on cin_layer_tc_kernel; mma.sync (tc_core) stays for the
//     stack kernel and the shapes layer() does not route to wgmma.
//   * The stack forward runs the mma.sync core (tc_core), a block keeping all
//     layers of its rows on chip, layer 1 over the F(F+1)/2 pairs f <= h
//     with W folded once a call: 44 k-steps at F = 26 where the (f, h)
//     path takes 104.
//   * The row kernel and the weight-gradient kernel of the backwards are
//     f32 FMA-bound: register tiles fed from shared memory, as an SGEMM
//     micro-kernel does.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "mma_sync.cuh"
#include "runtime.cuh"
#include "wgmma.cuh"

// Floats of partial sums that one weight gradient of K x N values over M
// rows needs (cin_flat_bwd_f32's scratch, with N = F * H), or -1 when
// the device cannot be read.
extern "C" long long cin_dw_scratch(int M, int K, int N, int device);

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 64;

size_t align4(size_t n) { return (n + 3) & ~(size_t)3; }

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

// wc[f, h] = sum_k W[k, f, h]: the channel-collapsed last layer of F x H;
// also its transpose wct[h, f] where wct is given.
__global__ void collapse_kernel(const float* __restrict__ W, int K, int F,
                                int H, float* __restrict__ wc,
                                float* __restrict__ wct) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int FH = F * H;
  if (idx >= FH) return;
  float s = 0.f;
  for (int k = 0; k < K; ++k) s += W[(size_t)k * FH + idx];
  wc[idx] = s;
  if (wct) wct[(idx % H) * F + idx / H] = s;
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

// ---------------------------------------------------------------------------
// The forward layer on mma.sync (cin_layer_mma_kernel: what layer() runs
// for the shapes and callers it does not route to cin_layer_tc_kernel,
// below: every layer() call of the backward and of the stack forward's
// layer-by-layer path; its loop, tc_core, also runs the stack forward's
// layers).  Bound by operations: three TF32 products per
// multiply-add on the tensor cores.  The layer is a skinny GEMM,
//     out[m, k] = sum_n a[m, n] W[k, n],  a[m, f*H + h] = x0[m,f] prev[m,h],
// M rows x K channels over the flattened (f, h) axis (676 or 1,664 deep at
// config 3), whose A operand is cheap to form on the fly.  A block owns
// BM = 64 * MT rows and all channels in passes of 64: it stages its x0
// (BM x F) and prev (BM x H) tiles once, as stored, and streams W as
// stored, (K, F*H), one field (and up to 64 h) at a time through a
// 3-stage cp.async ring: for channel k the h of one field are contiguous,
// which is the `col` B operand of mma.sync m16n8k8, so W is never
// re-laid out.  Each 8-deep k-step takes 8 h of one field: a thread forms
// its A fragment in registers as x0[row, f] * prev[row, h], splits it and
// the W fragment into TF32 hi + lo (split_tf32), and runs lo*hi + hi*lo +
// hi*hi into a fresh register quad that is then added to the running f32
// sum (the tensor cores truncate each accumulation; see
// csrc/multi_dense.cu).  8 warps: 4 along the rows (16 * MT each) x 2
// along a pass's 64 channels (32 each); a warp whose channels all lie past
// K skips its products.  Rows of x0, prev and W in shared memory are
// padded to a multiple of 8 plus 4 floats, so the fragment reads of a warp
// hit 32 distinct banks; an H that is not a multiple of 8 (26 at layer 1)
// is zero-filled up to the next one (32: 81% of the lanes busy).  Copies
// are 16 bytes where a row's width is a multiple of 4 floats and the
// pointer is 16-byte aligned, 8 bytes where it is even (layer 1's 26),
// else 4; each thread steps through its copies without a division.
constexpr int TC_KC = 64;                   // channels per pass
constexpr int TC_HC = 64;                   // h per W stage
constexpr int TC_STAGES = 3;
constexpr int TC_LDW = TC_HC + 4;           // W stage row stride
constexpr int TC_WSTAGE = TC_KC * TC_LDW;   // floats per W stage

__host__ __device__ constexpr int tc_ld(int n) { return (n + 7) / 8 * 8 + 4; }

size_t tc_smem(int bm, int F, int H) {
  return ((size_t)TC_STAGES * TC_WSTAGE +
          (size_t)bm * (tc_ld(F) + tc_ld(H))) * sizeof(float);
}

// Floats a copy can take from rows `ld` floats apart that start at `p`:
// 4, 2 or 1.  layer()'s slices of such rows start and end on multiples
// of 4 floats (but for the rows' own end), so they take the same.
int copy_floats(const float* p, int ld) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (ld % 4 == 0 && a % 16 == 0) return 4;
  if (ld % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

// Copies a rows x cols block of a row-major source (row r at
// src + r * src_ld) to dst + r * dst_ld, v floats (4, 2 or 1, dividing
// cols, cols_ok and src_ld) a copy; rows from rows_ok and columns from
// cols_ok on read as zero.
__device__ __forceinline__ void stage_block(float* dst, int dst_ld,
                                            const float* src, size_t src_ld,
                                            int rows, int rows_ok, int cols,
                                            int cols_ok, int v) {
  const int qn = cols / v;                   // copies a row
  int r = threadIdx.x / qn, q = threadIdx.x - r * qn;
  const int dr = kThreads / qn, dq = kThreads - dr * qn;
  while (r < rows) {
    const int c = q * v;
    const bool ok = r < rows_ok && c < cols_ok;
    const float* s = ok ? src + r * src_ld + c : src;
    if (v == 4)
      cp_async16(dst + r * dst_ld + c, s, ok);
    else if (v == 2)
      cp_async8(dst + r * dst_ld + c, s, ok);
    else
      cp_async4(dst + r * dst_ld + c, s, ok);
    r += dr;
    q += dq;
    if (q >= qn) {
      q -= qn;
      ++r;
    }
  }
}

// The core's A operands.  Each tells tc_core how many W stages one
// 64-channel pass takes (stages), copies stage s of channels k0.. into a
// ring slot (stage), and forms a thread's A fragments for a k-step (at,
// once a stage, then frag): hi and lo of rows g and g + 8 of each of the
// warp's MT 16-row blocks, at columns t and t + 4 of the 8-deep k-step.

// a[m, f*H + h] = x0[m,f] prev[m,h] over F fields and H h, both tiles in
// shared memory (rows ldx, ldp apart, prev zero-filled past H to the next
// multiple of 8); W[k,f,h] at W + k * ldwk + f * ldwf + h, one field and up
// to 64 h a stage, copied vw floats at a time.
template <int MT>
struct FieldsA {
  const float* x0s;
  int ldx;
  const float* prevs;
  int ldp, F, H, nh;   // nh: W stages a field
  const float* W;
  size_t ldwk;
  int ldwf, vw;

  struct At {
    float xa[MT][2];
    const float* pp;
    int nks;
  };
  __device__ int stages() const { return F * nh; }
  __device__ void stage(float* dst, int k0, int K, int s) const {
    const int f = s / nh, h0 = (s - f * nh) * TC_HC;
    const int hw = min(TC_HC, H - h0);
    stage_block(dst, TC_LDW, W + k0 * ldwk + (size_t)f * ldwf + h0, ldwk,
                TC_KC, K - k0, (hw + 7) & ~7, hw, vw);
  }
  __device__ At at(int s, int rb, int g, int t) const {
    At a;
    const int f = s / nh, h0 = (s - f * nh) * TC_HC;
    a.nks = (min(TC_HC, H - h0) + 7) / 8;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      a.xa[i][0] = x0s[(rb + i * 16 + g) * ldx + f];
      a.xa[i][1] = x0s[(rb + i * 16 + g + 8) * ldx + f];
    }
    a.pp = prevs + (rb + g) * ldp + h0 + t;
    return a;
  }
  __device__ void frag(const At& a, int ks, uint32_t (&ah)[MT][4],
                       uint32_t (&al)[MT][4]) const {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* p = a.pp + i * 16 * ldp + ks * 8;
      split_tf32(a.xa[i][0] * p[0], ah[i][0], al[i][0]);            // row g, h t
      split_tf32(a.xa[i][1] * p[8 * ldp], ah[i][1], al[i][1]);      // g + 8
      split_tf32(a.xa[i][0] * p[4], ah[i][2], al[i][2]);            // h t + 4
      split_tf32(a.xa[i][1] * p[8 * ldp + 4], ah[i][3], al[i][3]);
    }
  }
};

// a[m, p] = x0[m, f_p] x0[m, h_p] over the symmetric pairs f_p <= h_p of a
// layer whose prev is x0 (the stack's layer 1): tab[p] = f_p | h_p << 16
// in shared memory, P8 pairs padded with (0, 0) to a multiple of 8; the
// folded weight Ws (K, P8) (W[k,f,h] + W[k,h,f], the diagonal once, 0 on
// the padding), 64 pairs a stage.
template <int MT>
struct PairsA {
  const float* x0s;
  int ldx;
  const int* tab;
  int P8;
  const float* Ws;
  int vw;

  struct At {
    const int* tp;
    const float* r;
    int nks;
  };
  __device__ int stages() const { return (P8 + TC_HC - 1) / TC_HC; }
  __device__ void stage(float* dst, int k0, int K, int s) const {
    const int pw = min(TC_HC, P8 - s * TC_HC);
    stage_block(dst, TC_LDW, Ws + (size_t)k0 * P8 + s * TC_HC, P8, TC_KC,
                K - k0, pw, pw, vw);
  }
  __device__ At at(int s, int rb, int g, int t) const {
    return At{tab + s * TC_HC + t, x0s + (rb + g) * ldx,
              min(TC_HC, P8 - s * TC_HC) / 8};
  }
  __device__ void frag(const At& a, int ks, uint32_t (&ah)[MT][4],
                       uint32_t (&al)[MT][4]) const {
    const int e0 = a.tp[ks * 8], e1 = a.tp[ks * 8 + 4];   // pairs t, t + 4
    const int f0 = e0 & 0xffff, h0 = e0 >> 16;
    const int f1 = e1 & 0xffff, h1 = e1 >> 16;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* r = a.r + i * 16 * ldx;   // row g
      const float* q = r + 8 * ldx;          // row g + 8
      split_tf32(r[f0] * r[h0], ah[i][0], al[i][0]);
      split_tf32(q[f0] * q[h0], ah[i][1], al[i][1]);
      split_tf32(r[f1] * r[h1], ah[i][2], al[i][2]);
      split_tf32(q[f1] * q[h1], ah[i][3], al[i][3]);
    }
  }
};

// The core of every forward layer on the tensor cores: the block's BM =
// 64 * MT rows times K channels, out[m, k] = sum_n a[m, n] W[k, n], in
// passes of 64 channels, each pass streaming all of A's W stages through
// the 3-stage cp.async ring `wring`.  Copies the caller issued before the
// call join the first stage's group, so its tiles have landed by the first
// product.  At each pass's end, epi(k0, acc, rb, g, t, wn) takes the
// thread's sums: acc[i][j] holds rows rb + i * 16 + g (c0, c1) and + 8
// (c2, c3) at channels k0 + wn * 32 + j * 8 + 2t (+1).  Returns with no
// copy in flight; the caller syncs before it reuses the ring.
template <int MT, class A, class Epi>
__device__ __forceinline__ void tc_core(const A& a, int K, float* wring,
                                        Epi&& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;            // mma group, thread
  const int wm = warp & 3, wn = warp >> 2;
  const int S = a.stages();
  const int nsteps = (K + TC_KC - 1) / TC_KC * S;
  int ik0 = 0, is = 0;                              // next stage to copy
  auto issue = [&](int slot) {
    a.stage(wring + slot * TC_WSTAGE, ik0, K, is);
    if (++is == S) {
      is = 0;
      ik0 += TC_KC;
    }
  };
  issue(0);
  cp_async_commit();                 // group 0: the caller's tiles, stage 0
  if (nsteps > 1) issue(1);
  cp_async_commit();

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int rb = wm * 16 * MT;       // the warp's first row in the tile
  int k0 = 0, s = 0;
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<1>();              // stage `step` has landed
    __syncthreads();                 // ... for all; stage step - 1 is done
    if (step + 2 < nsteps) issue((step + 2) % TC_STAGES);
    cp_async_commit();

    if (k0 + wn * 32 < K) {
      const auto at = a.at(s, rb, g, t);
      const float* wp = wring + (step % TC_STAGES) * TC_WSTAGE +
                        (wn * 32 + g) * TC_LDW + t;
#pragma unroll 2
      for (int ks = 0; ks < at.nks; ++ks) {
        uint32_t ah[MT][4], al[MT][4];
        a.frag(at, ks, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bh[2], bl[2];
          const float* w = wp + j * 8 * TC_LDW + ks * 8;
          split_tf32(w[0], bh[0], bl[0]);                   // k-step col t
          split_tf32(w[4], bh[1], bl[1]);                   // t + 4
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            float part[4];           // this k-step's 8 terms, 3 products
            mma_tf32_new(part, al[i], bh);
            mma_tf32(part, ah[i], bl);
            mma_tf32(part, ah[i], bh);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] += part[q];
          }
        }
      }
    }

    if (s == S - 1) {                // the pass's last stage
      epi(k0, acc, rb, g, t, wn);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    }
    if (++s == S) {
      s = 0;
      k0 += TC_KC;
    }
  }
  cp_async_wait<0>();
}

// out[m, k] (=, or += with accumulate) sum_{f,h} W[k,f,h] x0[m,f] prev[m,h]
// (+ add_row[m] when add_row is given) over F fields and H h: x0 rows
// ldx apart, prev rows ldp apart, W[k,f,h] at W + k * ldwk + f * ldp + h
// (as stored, unless layer() hands in a slice); vx, vp, vw: floats a copy
// of x0, prev, W (copy_floats).
template <int MT>
__global__ void __launch_bounds__(kThreads, 2)
cin_layer_mma_kernel(const float* __restrict__ x0, int ldx,
                     const float* __restrict__ prev, int ldp,
                     const float* __restrict__ W, size_t ldwk,
                     float* __restrict__ out, int M, int F, int H, int K,
                     int accumulate, const float* __restrict__ add_row,
                     int vx, int vp, int vw) {
  constexpr int BM = 64 * MT;
  extern __shared__ float4 smem4[];
  const int LDX = tc_ld(F), LDP = tc_ld(H);
  float* wring = reinterpret_cast<float*>(smem4);   // [stage][k][h]
  float* x0s = wring + TC_STAGES * TC_WSTAGE;       // [row][f]
  float* prevs = x0s + BM * LDX;                    // [row][h]
  const int m0 = blockIdx.x * BM;

  // the x0 and prev tiles, rows past M and h past H zero
  stage_block(x0s, LDX, x0 + (size_t)m0 * ldx, ldx, BM, M - m0,
              (F + vx - 1) / vx * vx, F, vx);
  stage_block(prevs, LDP, prev + (size_t)m0 * ldp, ldp, BM, M - m0,
              (H + 7) & ~7, H, vp);
  const FieldsA<MT> a{x0s, LDX, prevs, LDP, F, H, (H + TC_HC - 1) / TC_HC,
                      W, ldwk, ldp, vw};
  tc_core<MT>(a, K, wring, [&](int k0, const float (&acc)[MT][4][4], int rb,
                               int g, int t, int wn) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + rb + i * 16 + g + half * 8;
        if (m >= M) continue;
        const float base = add_row ? add_row[m] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = k0 + wn * 32 + j * 8 + 2 * t + e;
            if (k >= K) continue;
            float* o = out + (size_t)m * K + k;
            *o = (accumulate ? *o : 0.f) + (acc[i][j][2 * half + e] + base);
          }
      }
  });
}

// Launches cin_layer_mma_kernel on x0 (M, F) rows ldx apart, prev (M, H)
// rows ldp apart and a (K, F, H) block of a weight whose fields are ldp
// apart and channels ldwk apart.
template <int MT>
int launch_mma(const float* x0, int ldx, const float* prev, int ldp,
               const float* W, size_t ldwk, float* out, int M, int F, int H,
               int K, int accumulate, const float* add_row, int device,
               cudaStream_t s) {
  static std::atomic<bool> done[kMaxDevices];
  CUDA_TRY(allow_smem((const void*)cin_layer_mma_kernel<MT>,
                      optin_smem(device), device, done));
  const int grid = (M + 64 * MT - 1) / (64 * MT);
  cin_layer_mma_kernel<MT><<<grid, kThreads, tc_smem(64 * MT, F, H), s>>>(
      x0, ldx, prev, ldp, W, ldwk, out, M, F, H, K, accumulate, add_row,
      copy_floats(x0, ldx), copy_floats(prev, ldp), copy_floats(W, ldp));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The forward layer on Hopper's warpgroup MMA (cin_layer_tc_kernel: B2's
// kernel, what cin_flat_f32 launches wherever layer() routes a shape here).
// Bound by operations: split TF32's three products a multiply-add at
// 495 TFLOP/s.  The layer is the GEMM
//     out[m, k] = sum_n a[m, n] B[k, n]
// over a reduction axis whose A operand is formed on chip:
//   * fields (prev is not x0): n = (hb, f, hh), a = x0[m,f] prev[m,8hb+hh],
//     B = W[k, f, 8hb+hh], zero past H; the h of one 8-wide block are a
//     k-step, the fields run inside each block, so a thread keeps its four
//     prev values of a block in registers for F k-steps and reads one x0
//     pair from shared memory a k-step, and no prev tile is staged;
//   * pairs (prev is x0, H = F): n = p over the F(F+1)/2 pairs f <= h
//     (pair_of, the stack kernel's order), a = x0[m,f_p] x0[m,h_p],
//     B = W[k,f,h] + W[k,h,f] (the diagonal once): about half the k-steps.
// One cooperative launch, three phases:
//   1. Every block writes a share of B, split into TF32 hi and lo planes,
//      into the caller's scratch as planes[plane][j / 4][k][j % 4][8] (j
//      the k-step), zero past J and K: W is folded and split once a
//      call, inside the launch.  A grid barrier follows.
//   2. Persistent blocks of 384 threads walk units (128-row tile, channel
//      tile of N, reduction split q of S).  Warpgroup 2's first thread
//      streams the units' stages (4 k-steps of both planes, 2 * N * 128
//      bytes) with one TMA each into a ring of up to 8 stages, on full /
//      empty mbarriers: rows of 128 bytes in SWIZZLE_128B, the K-major B
//      that wgmma takes for .tf32 (32-byte rows in SWIZZLE_32B fed the
//      same products 30% slower).  Warpgroups 0 and 1 (64 rows each, 240
//      registers after setmaxnreg) form a stage's four A fragments in
//      registers, split them into hi and lo, and issue wgmma m64nNk8 three
//      times a k-step, lo*hi + hi*lo + hi*hi, from registers against the
//      landed planes: a chain of 12 on a zeroed accumulator.  The tensor
//      cores truncate as they accumulate, so each chain is then added to
//      a total in f32 registers: at xDeepFM's layer 2 (M = 81,920)
//      against a float64 plain, chains of 1, 4, 16 and 64 k-steps and one
//      chain of the whole reduction land 1.6e-6, 8.1e-7, 9.9e-7, 3.4e-6
//      and 6.2e-5 of max|plain| away (H100; one k-step a chain adds 975
//      roundings to the total), the mma.sync kernel 1.2e-6.  The two
//      warpgroups issue their chains in turns.  No wgmma sits on a path
//      the compiler cannot prove uniform (it serializes them then): the
//      waits loop inside asm, lane 0 arrives by predicate, the role comes
//      through a shuffle.
//   3. S == 1: the totals go to out.  S > 1: each split writes its
//      partial tile to scratch; the split that finishes a tile last (an
//      integer counter, zeroed in phase 1) adds the S partials in split
//      order and writes out, so repeats are bit-equal.
// S and the grid come from M, N and the SM count: the S (1-4) with the
// fewest rounds of units per split, the smaller on a tie.  At M = 10,240
// (80 tiles) S = 3 gives 240 units for 132 SMs in two rounds, where one
// split leaves 52 SMs idle; at M = 81,920, S = 1.  N is the smallest of
// 64, 128 and 200 that holds K, or its share of K in passes of at most
// 200 (the chain and the total take N registers a thread).
constexpr int WG_THREADS = 384;   // consumer warpgroups 0, 1; producer 2
constexpr int WG_ROWS = 128;      // a tile's rows, 64 a consumer warpgroup
constexpr int WG_KS = 4;          // k-steps (8 columns each) a stage
constexpr int WG_MAX_STAGES = 8;
constexpr int WG_MAX_N = 200;     // channels a pass
constexpr int WG_MAX_SPLIT = 4;

// Pairs f <= h of F fields, padded to a multiple of 8.
__host__ __device__ constexpr long long pairs8(long long F) {
  return (F * (F + 1) / 2 + 7) / 8 * 8;
}

// Pair p < F(F+1)/2 in f-major order as f | h << 16, f <= h: f's pairs
// start at f F - f (f - 1) / 2, found by a root and its rounding.
__device__ __forceinline__ int pair_of(int p, int F) {
  const float b = 2.f * F + 1.f;
  int f = (int)((b - sqrtf(b * b - 8.f * p)) * 0.5f);
  f = max(0, min(F - 1, f));
  while (f > 0 && f * F - f * (f - 1) / 2 > p) --f;
  while (f + 1 < F && (f + 1) * F - (f + 1) * f / 2 <= p) ++f;
  return f | (f + p - (f * F - f * (f - 1) / 2)) << 16;
}

// v floats (4 or 1) at p, past L1 (other SMs wrote them), as a float4
// whose rest is zero.
__device__ __forceinline__ float4 ld_cg(const float* p, int v) {
  return v == 4 ? __ldcg(reinterpret_cast<const float4*>(p))
                : make_float4(__ldcg(p), 0.f, 0.f, 0.f);
}

// Arguments of cin_layer_tc_kernel (see wg_plan).
struct WgArgs {
  const float* x0;
  const float* prev;
  const float* W;
  float* out;
  float* planes;       // 2 * JB * Kp * 32 floats
  float* part;         // S * M * K floats where S > 1
  unsigned* counters;  // tiles * NT where S > 1
  int M, F, H, K;
  int pairs, P;        // the pairs path; its F(F+1)/2
  int J, JB;           // k-steps of the whole reduction; blocks of 4
  int Kp;              // the planes' rows: NT * N, zero past K
  int NT, S, tiles, units, stages;
};

template <int N>
__global__ void __launch_bounds__(WG_THREADS, 1)
cin_layer_tc_kernel(const WgArgs a, const __grid_constant__ CUtensorMap map) {
  constexpr int R = N / 2;                     // accumulators a thread
  constexpr int STAGE = 2 * WG_KS * N * 32;    // bytes: hi, then lo
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* x0s = reinterpret_cast<float*>(base + a.stages * STAGE);
  int* tab = reinterpret_cast<int*>(x0s + 2 * 64 * a.F);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      tab + ((a.pairs ? a.J * 8 : 0) + 1) / 2 * 2);
  uint64_t* empty = full + a.stages;
  int* last = reinterpret_cast<int*>(empty + a.stages);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);       // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (a.pairs)
    for (int p = tid; p < a.J * 8; p += WG_THREADS)
      tab[p] = p < a.P ? pair_of(p, a.F) : 0;
  __syncthreads();

  // phase 1: B in TF32 hi and lo, planes[plane][j / 4][k][j % 4][8]
  {
    const int n = a.JB * a.Kp * 32;
    const int F = a.F, H = a.H, K = a.K;
    for (int e = blockIdx.x * WG_THREADS + tid; e < n;
         e += gridDim.x * WG_THREADS) {
      const int hh = e & 7, r = e >> 5;
      const int jb = r / a.Kp, k = r - jb * a.Kp, j = 4 * jb + (e >> 3 & 3);
      float v = 0.f;
      if (k < K && j < a.J) {
        if (a.pairs) {
          const int p = 8 * j + hh;
          if (p < a.P) {
            const int fh = tab[p], f = fh & 0xffff, h = fh >> 16;
            const float* w = a.W + (size_t)k * F * F;
            v = f == h ? __ldg(w + f * F + f)
                       : __ldg(w + f * F + h) + __ldg(w + h * F + f);
          }
        } else {
          const int hb = j / F, f = j - hb * F, h = 8 * hb + hh;
          if (h < H) v = __ldg(a.W + ((size_t)k * F + f) * H + h);
        }
      }
      uint32_t hi, lo;
      split_tf32(v, hi, lo);
      a.planes[e] = __uint_as_float(hi);
      a.planes[n + e] = __uint_as_float(lo);
    }
    if (a.S > 1)
      for (int i = blockIdx.x * WG_THREADS + tid; i < a.tiles * a.NT;
           i += gridDim.x * WG_THREADS)
        a.counters[i] = 0;
    asm volatile("fence.proxy.async.global;" ::: "memory");
  }
  cooperative_groups::this_grid().sync();

  // the warpgroup, read through a shuffle so that the compiler knows it
  // is the same across a warp: a wgmma on a path it cannot prove uniform
  // is serialized
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {                   // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 256) {
      asm volatile("fence.proxy.async.global;" ::: "memory");
      int slot = 0;
      uint32_t ph = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        const int q = u % a.S, nt = (u / a.S) % a.NT;
        const int jb1 = a.JB * (q + 1) / a.S;
        for (int jb = a.JB * q / a.S; jb < jb1; ++jb) {
          mbar_wait(empty + slot, ph ^ 1);
          mbar_expect(full + slot, STAGE);
          tma_load4(base + slot * STAGE, &map, full + slot, 0, nt * N, jb, 0);
          if (++slot == a.stages) {
            slot = 0;
            ph ^= 1;
          }
        }
      }
    }
    __syncwarp();
    return;
  }

  // consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = role, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = ((tid >> 5) & 3) * 16 + g, r1 = r0 + 8;  // rows in the 64
  const int F = a.F, H = a.H, K = a.K, M = a.M;
  float* xs = x0s + wg * 64 * F;                           // [f][64]
  float acc[R], tot[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  int slot = 0;
  uint32_t ph = 0;
  // The warpgroups issue their chains in turns (barriers 5 and 6), so
  // that one's wait, sums and next A overlap the other's products; else
  // both wait on the same stages and leave the tensor cores idle together.
  if (wg == 1) named_arrive(5, 256);
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const int q = u % a.S, nt = (u / a.S) % a.NT, tile = u / a.S / a.NT;
    const int j0 = WG_KS * (a.JB * q / a.S);             // a stage's start
    const int j1 = min(a.J, WG_KS * (a.JB * (q + 1) / a.S));
    const int m0 = tile * WG_ROWS + wg * 64, n0 = nt * N;

    named_sync(1 + wg, 128);         // the warpgroup is done with xs
    for (int i0 = 0; i0 < 64 * F; i0 += 8 * 128) {  // the same trips for all
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {  // 8 loads in flight, then the stores
        const int i = min(i0 + e * 128 + (tid & 127), 64 * F - 1);
        const int r = i / F;
        v[e] = __ldg(a.x0 + (size_t)min(m0 + r, M - 1) * F + (i - r * F));
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = i0 + e * 128 + (tid & 127), r = i / F;
        if (i < 64 * F) xs[(i - r * F) * 64 + r] = m0 + r < M ? v[e] : 0.f;
      }
    }
    named_sync(1 + wg, 128);
#pragma unroll
    for (int i = 0; i < R; ++i) tot[i] = 0.f;

    // the next k-step to form; fields: its block hb, field f, and the
    // thread's prev at (rows r0, r1) x (h t, t + 4) of block hb
    int hb = a.pairs ? 0 : j0 / F, f = a.pairs ? 0 : j0 - hb * F;
    float pv[4] = {0.f, 0.f, 0.f, 0.f};
    auto load_prev = [&]() {
      const int h0 = 8 * hb + t;
#pragma unroll
      for (int i = 0; i < 4; ++i) {     // a clamped read, then a select
        const int m = m0 + (i & 1 ? r1 : r0), h = h0 + (i & 2 ? 4 : 0);
        const float v = __ldg(a.prev + (size_t)min(m, M - 1) * H +
                              min(h, H - 1));
        pv[i] = m < M && h < H ? v : 0.f;
      }
    };
    if (!a.pairs) load_prev();
    // A of k-step j: hi and lo of a at (r0, t) (r1, t) (r0, t+4) (r1, t+4)
    auto form = [&](int j, bool live, uint32_t (&ah)[4], uint32_t (&al)[4]) {
      float v[4];
      if (a.pairs) {
        const int e0 = tab[8 * j + t], e1 = tab[8 * j + t + 4];
        const float* p0 = xs + (e0 & 0xffff) * 64;
        const float* q0 = xs + (e0 >> 16) * 64;
        const float* p1 = xs + (e1 & 0xffff) * 64;
        const float* q1 = xs + (e1 >> 16) * 64;
        v[0] = p0[r0] * q0[r0];
        v[1] = p0[r1] * q0[r1];
        v[2] = p1[r0] * q1[r0];
        v[3] = p1[r1] * q1[r1];
      } else {
        const float x_0 = xs[f * 64 + r0], x_1 = xs[f * 64 + r1];
        v[0] = x_0 * pv[0];
        v[1] = x_1 * pv[1];
        v[2] = x_0 * pv[2];
        v[3] = x_1 * pv[3];
        if (++f == F) {
          f = 0;
          ++hb;
          if (j + 1 < j1) load_prev();
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(live ? v[i] : 0.f, ah[i], al[i]);
    };

    // A stage is a chain: its k-steps' A fragments are formed, its 3 * 4
    // products issued back to back on a zeroed accumulator, and once they
    // are done the chain joins tot in f32 and the stage is released.
    // The last stage may hold fewer than 4 k-steps: the rest take a zero
    // A (no branch around a wgmma: the compiler would serialize them),
    // against the planes' zeros past J.
    uint32_t ah[WG_KS][4], al[WG_KS][4];
    for (int c0 = j0; c0 < j1; c0 += WG_KS) {
#pragma unroll
      for (int i = 0; i < WG_KS; ++i) {
        const bool live = c0 + i < j1;
        form(live ? c0 + i : c0, live, ah[i], al[i]);
      }
      mbar_wait(full + slot, ph);
      __syncwarp();
      const uint32_t hi = smem_u32(base + slot * STAGE);
      named_sync(5 + wg, 256);       // the other warpgroup's chain is issued
      fence_regs(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int i = 0; i < WG_KS; ++i) {
        const uint64_t dh = desc_sw128(hi + i * 32);
        const uint64_t dl = desc_sw128(hi + N * 128 + i * 32);
        wgmma_tf32(acc, al[i], dh, i);
        wgmma_tf32(acc, ah[i], dl, 1);
        wgmma_tf32(acc, ah[i], dh, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      named_arrive(5 + (wg ^ 1), 256);  // its turn
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_regs(acc);
      mbar_arrive_lane0(empty + slot, lane);
      if (++slot == a.stages) {
        slot = 0;
        ph ^= 1;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) tot[i] += acc[i];
    }

    // the totals: d[4c + 2 half + e] at row (half ? r1 : r0), column
    // n0 + 8c + 2t + e
    float* dst = a.S > 1 ? a.part + (size_t)q * M * K : a.out;
    const bool pair_store = (K & 1) == 0;
#pragma unroll
    for (int c = 0; c < R / 4; ++c) {
      const int col = n0 + 8 * c + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + (half ? r1 : r0);
        const bool in = col < K && m < M;
        float* o = dst + (size_t)min(m, M - 1) * K + min(col, K - 1);
        const float x = tot[4 * c + 2 * half], y = tot[4 * c + 2 * half + 1];
        if (pair_store) {
          if (in) *reinterpret_cast<float2*>(o) = make_float2(x, y);
        } else {
          if (in) o[0] = x;
          if (in && col + 1 < K) o[1] = y;
        }
      }
    }
    if (a.S > 1) {                   // the last split of the tile adds up
      __threadfence();
      named_sync(3, 256);
      if (tid == 0)
        *last = atomicAdd(a.counters + tile * a.NT + nt, 1u) ==
                (unsigned)(a.S - 1);
      named_sync(3, 256);
      if (__shfl_sync(0xffffffffu, *last, 0)) {
        __threadfence();
        // 8 sums in flight a thread; float4 where the rows allow it
        const int mt = tile * WG_ROWS, v = K % 4 ? 1 : 4;
        const int rows = min(WG_ROWS, M - mt), cols = min(N, K - n0) / v;
        const size_t split = (size_t)M * K;
        for (int i0 = 0; i0 < rows * cols; i0 += 8 * 256) {
          float4 sum[8];
          size_t o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int i = min(i0 + e * 256 + tid, rows * cols - 1);
            const int r = i / cols;
            o[e] = (size_t)(mt + r) * K + n0 + (i - r * cols) * v;
            sum[e] = ld_cg(a.part + o[e], v);
          }
          for (int s2 = 1; s2 < a.S; ++s2)
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float4 t4 = ld_cg(a.part + s2 * split + o[e], v);
              sum[e].x += t4.x;
              sum[e].y += t4.y;
              sum[e].z += t4.z;
              sum[e].w += t4.w;
            }
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (i0 + e * 256 + tid >= rows * cols) continue;
            if (v == 4)
              *reinterpret_cast<float4*>(a.out + o[e]) = sum[e];
            else
              a.out[o[e]] = sum[e].x;
          }
        }
      }
    }
  }
  if (wg == 0) named_sync(5, 256);   // warpgroup 1's last turn
}

// Blocks of cin_layer_tc_kernel<N> that can be resident at once (the
// cooperative launch's largest grid), 0 where the device cannot launch
// it cooperatively.
template <int N>
int wg_resident(int device) {
  static std::atomic<int> slots[kMaxDevices];
  static std::atomic<bool> done[kMaxDevices];
  return coop_resident((const void*)cin_layer_tc_kernel<N>, WG_THREADS,
                       device, slots, done);
}

int wg_resident_n(int n, int device) {
  return n == 64    ? wg_resident<64>(device)
         : n == 128 ? wg_resident<128>(device)
                    : wg_resident<200>(device);
}

// How cin_layer_tc_kernel runs a layer of these shapes; N == 0 where the
// layer goes to cin_layer_mma_kernel instead: fewer than 8 h (8 fields on
// the pairs path), one field, fewer than 32 channels or 4 k-steps, tiles
// past the shared memory, no cooperative launch.
struct WgPlan {
  int N = 0;           // channels a pass: 64, 128 or 200
  int NT = 0, S = 0;   // channel passes; splits of the reduction
  int J = 0, JB = 0, Kp = 0, P = 0;  // k-steps, their blocks, the planes'
                                     // rows; pairs (the pairs path)
  int tiles = 0, units = 0, grid = 0, stages = 0;
  size_t smem = 0;
  long long planes = 0, part = 0, counters = 0;   // floats of scratch
};

WgPlan wg_plan(int M, int F, int H, int K, bool pairs, int device) {
  WgPlan p;
  if (M <= 0 || F < 2 || F > 0xffff || (pairs ? F : H) < 8 || K < 32)
    return p;
  const int nt = (K + WG_MAX_N - 1) / WG_MAX_N, per = (K + nt - 1) / nt;
  const int N = per <= 64 ? 64 : per <= 128 ? 128 : 200;
  const long long J = pairs ? pairs8(F) / 8 : (long long)(H + 7) / 8 * F;
  const long long JB = (J + WG_KS - 1) / WG_KS, Kp = (long long)nt * N;
  if (J < WG_KS || JB * Kp * 64 >= (1LL << 31)) return p;
  const size_t cap = optin_smem(device);
  const size_t stage = (size_t)2 * WG_KS * N * 32;
  // alignment, x0 tiles, the pair table, the mbarriers, the flag
  const size_t fixed = 1024 + (size_t)512 * F +
                       (pairs ? (size_t)(J * 8 + 1) / 2 * 8 : 0) +
                       16 * WG_MAX_STAGES + 8;
  if (cap == 0 || fixed + 2 * stage > cap) return p;
  const int resident = wg_resident_n(N, device);
  if (resident == 0) return p;
  const int tiles = (M + WG_ROWS - 1) / WG_ROWS;
  const long long T = (long long)tiles * nt;
  // the split with the fewest rounds of units per split, the smaller on
  // a tie: rounds(S) / S < rounds(best) / best
  int S = 1;
  long long rounds = (T + resident - 1) / resident;
  for (int s = 2; s <= WG_MAX_SPLIT && JB >= s; ++s) {
    const long long r = (T * s + resident - 1) / resident;
    if (r * S < rounds * s) {
      S = s;
      rounds = r;
    }
  }
  p.N = N;
  p.NT = nt;
  p.S = S;
  p.J = (int)J;
  p.JB = (int)JB;
  p.Kp = (int)Kp;
  p.P = pairs ? F * (F + 1) / 2 : 0;
  p.tiles = tiles;
  p.units = (int)(T * S);
  p.grid = p.units < resident ? p.units : resident;
  p.stages = (int)((cap - fixed) / stage);
  if (p.stages > WG_MAX_STAGES) p.stages = WG_MAX_STAGES;
  p.smem = fixed + p.stages * stage;
  p.planes = 2 * JB * Kp * 32;
  p.part = S > 1 ? (long long)S * M * K : 0;
  p.counters = S > 1 ? T : 0;
  return p;
}

long long wg_scratch(const WgPlan& p) {
  return p.N ? (long long)(align4(p.planes) + align4(p.part) +
                           align4(p.counters))
             : 0;
}

// One layer on cin_layer_tc_kernel by plan p; scratch holds
// wg_scratch(p) floats.
template <int N>
int launch_wg(const WgPlan& p, const float* x0, const float* prev,
              const float* W, float* out, int M, int F, int H, int K,
              float* scratch, cudaStream_t s) {
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  // a box is a stage: 4 k-steps of N channels, both planes
  CUtensorMap map;
  if (encode_planes(encode, &map, scratch, p.Kp, p.JB, N) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  float* part = scratch + align4(p.planes);
  WgArgs a{x0, prev, W, out, scratch, part,
           reinterpret_cast<unsigned*>(part + align4(p.part)),
           M, F, H, K, p.P > 0, p.P, p.J, p.JB, p.Kp, p.NT, p.S, p.tiles,
           p.units, p.stages};
  return launch_cooperative(cin_layer_tc_kernel<N>, p.grid, WG_THREADS,
                            p.smem, s, a, map);
}

constexpr int TC_SLICE = 256;   // fields or h per launch of a wide layer

// Kernel paths of layer(), as cin_flat_f32 reports them.
enum LayerPath { kPathMma = 1, kPathWgmma = 2 };

// One layer, W (K, F, H) as stored.  With the caller's scratch (and
// neither accumulate nor add_row), a shape that wg_plan takes runs on
// cin_layer_tc_kernel, its layer 1 (prev is x0) on the pairs; every
// other call on cin_layer_mma_kernel: 128-row blocks where their tiles
// fit the opt-in shared memory, else 64, and a layer whose x0 and prev
// tiles do not fit 64 rows (F + H past ~690 on an H100) as launches over
// TC_SLICE x TC_SLICE blocks of (f, h), in a fixed order, each adding
// into out: the block's pointers are offsets into the tensors as stored
// (slices of 256 keep them on the copies' grid).  *path, where given,
// says which kernel ran.
int layer(const float* x0, int F, const float* prev, int H, const float* W,
          int K, float* out, int M, int accumulate, const float* add_row,
          int device, cudaStream_t s, float* scratch = nullptr,
          int* path = nullptr) {
  if (M == 0 || K == 0) return cudaSuccess;
  if (F < 1 || H < 1) return cudaErrorInvalidValue;
  if (scratch && !accumulate && !add_row) {
    const WgPlan p = wg_plan(M, F, H, K, prev == x0 && H == F, device);
    if (p.N) {
      if (path) *path = kPathWgmma;
      if (p.N == 64)
        return launch_wg<64>(p, x0, prev, W, out, M, F, H, K, scratch, s);
      if (p.N == 128)
        return launch_wg<128>(p, x0, prev, W, out, M, F, H, K, scratch, s);
      return launch_wg<200>(p, x0, prev, W, out, M, F, H, K, scratch, s);
    }
  }
  if (path) *path = kPathMma;
  const size_t cap = optin_smem(device);
  const size_t fh = (size_t)F * H;
  if (tc_smem(128, F, H) <= cap)
    return launch_mma<2>(x0, F, prev, H, W, fh, out, M, F, H, K, accumulate,
                         add_row, device, s);
  if (tc_smem(64, F, H) <= cap)
    return launch_mma<1>(x0, F, prev, H, W, fh, out, M, F, H, K, accumulate,
                         add_row, device, s);
  if (tc_smem(64, TC_SLICE, TC_SLICE) > cap) return cudaErrorInvalidValue;
  for (int f0 = 0; f0 < F; f0 += TC_SLICE)
    for (int h0 = 0; h0 < H; h0 += TC_SLICE) {
      const bool first = f0 == 0 && h0 == 0;
      CUDA_TRY(launch_mma<1>(x0 + f0, F, prev + h0, H,
                             W + (size_t)f0 * H + h0, fh, out, M,
                             F - f0 < TC_SLICE ? F - f0 : TC_SLICE,
                             H - h0 < TC_SLICE ? H - h0 : TC_SLICE, K,
                             first ? accumulate : 1,
                             first ? add_row : nullptr, device, s));
    }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The stack forward (cin_stack_sum_f32; replaces _cin_stack_fwd_impl,
// cin_kernel.py:493),
//   out[m] = [sum_f x0[m,f]] + sum_{i<n} sum_k h_i[m,k]
//            + sum_f x0[m,f] sum_h Wc[f,h] h_{n-1}[m,h],
// runs in two launches.  stack_prep_kernel folds layer 1's weight onto its
// symmetric pairs and collapses the last layer, once a call; then
// cin_stack_tc_kernel gives each block BM rows and keeps the whole stack
// on chip: the x0 tile is staged once; layer 1, whose prev is x0, runs on
// the tensor cores over the F(F+1)/2 pairs f <= h (PairsA: 351 at F = 26,
// padded to 352, 44 k-steps where the (f, h) path takes 104); each later
// layer runs the same core over (f, h) with prev the previous hidden tile
// (FieldsA); each hidden tile goes to shared memory (two, in turns) and
// its channel sums to a per-row sum on the way; the collapsed last layer
// and the sums are f32 dot products, F x H_{n-1} a row, a warp four rows
// at a time.  Bound by operations: at
// config 3 (M = 131,072, F = 26, Ks = (64, 64)) layer 1's 5.9 GFLOP in
// split TF32 (0.036 ms at 495 TFLOP/s x 1/3) and the collapse's 0.44
// GFLOP at the f32 rate (0.007 ms).  BM is 128 where the tiles fit the
// opt-in shared memory (config 3: 107 KB, two blocks an SM; 64 rows, the
// same two blocks an SM, stream W twice as often a row and measured
// slower), else 64; a stack whose tiles do not fit 64 rows (at F = 26, two
// hidden layers past ~320 channels or one past ~650) runs as layer-by-layer launches of the
// forward layer (layer(): hidden layers to scratch, their channel sums by
// row_sums_kernel) and the collapsed layer as one more layer of one
// channel, adding the sums.  Each path sums in a fixed order.

// One launch a call: the folded layer-1 weight ws (K1, P8), ws[k, p] =
// W1[k,f,h] + W1[k,h,f] (f < h) or W1[k,f,f], 0 past the F(F+1)/2 pairs,
// and its pair table tab[p] = f | h << 16 in f-major order, where the stack
// has hidden layers (K1 > 0); and the collapsed last layer wc (F, Hl) =
// sum_k Wn[k].
__global__ void stack_prep_kernel(const float* __restrict__ W1, int K1,
                                  int F, int P8, float* __restrict__ ws,
                                  int* __restrict__ tab,
                                  const float* __restrict__ Wn, int Kn,
                                  int Hl, float* __restrict__ wc) {
  const size_t n1 = (size_t)K1 * P8;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n1) {
    const int k = (int)(idx / P8), p = (int)(idx - (size_t)k * P8);
    float v = 0.f;
    int e = 0;
    if (p < F * (F + 1) / 2) {
      e = pair_of(p, F);
      const int f = e & 0xffff, h = e >> 16;
      const float* w = W1 + (size_t)k * F * F;
      v = f == h ? w[f * F + f] : w[f * F + h] + w[h * F + f];
    }
    ws[idx] = v;
    if (k == 0) tab[p] = e;
    return;
  }
  const size_t j = idx - n1;
  const size_t fh = (size_t)F * Hl;
  if (j >= fh) return;
  float s = 0.f;
  for (int k = 0; k < Kn; ++k) s += Wn[k * fh + j];
  wc[j] = s;
}

// The layers past the first, as stored.
struct StackLayers {
  const float* w[kMaxLayers];
  int k[kMaxLayers];   // every layer's channels, the first's too
  int v[kMaxLayers];   // floats a copy of w[l] (copy_floats)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t stack_tc_smem(int bm, int F, int h_max, int n_mid, long long p8) {
  const int nb = n_mid > 1 ? 2 : n_mid;
  return ((size_t)TC_STAGES * TC_WSTAGE +
          (size_t)bm * (tc_ld(F) + nb * tc_ld(h_max) + 1) +
          (n_mid ? (size_t)p8 : 0)) * sizeof(float);
}

// x0 (M, F) rows, vx floats a copy; ws, tab, P8, vws: layer 1 folded
// (stack_prep_kernel); sl: the later layers; wc (F, H_{n-1}).
template <int MT>
__global__ void __launch_bounds__(kThreads, 2)
cin_stack_tc_kernel(const float* __restrict__ x0, int M, int F, int vx,
                    int n_mid, const float* __restrict__ ws,
                    const int* __restrict__ tab, int P8, int vws,
                    StackLayers sl, int h_max, const float* __restrict__ wc,
                    int output_input, float* __restrict__ out) {
  constexpr int BM = 64 * MT;
  extern __shared__ float4 smem4[];
  const int LDX = tc_ld(F), LDH = tc_ld(h_max);
  float* wring = reinterpret_cast<float*>(smem4);   // W ring, then Wc
  float* x0s = wring + TC_STAGES * TC_WSTAGE;       // [row][f]
  float* hid0 = x0s + BM * LDX;                     // [row][k], in turns
  float* hid1 = hid0 + BM * LDH;
  float* rsum = x0s + BM * (LDX + (n_mid > 1 ? 2 : n_mid) * LDH);
  int* tabs = reinterpret_cast<int*>(rsum + BM);    // [pair]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * BM;

  // the x0 tile (rows past M zero) and the pair table
  stage_block(x0s, LDX, x0 + (size_t)m0 * F, F, BM, M - m0,
              (F + vx - 1) / vx * vx, F, vx);
  if (n_mid)
    stage_block(reinterpret_cast<float*>(tabs), P8,
                reinterpret_cast<const float*>(tab), P8, 1, 1, P8, P8, 4);
  const float* prev = x0s;
  int H = F, ldp = LDX;
  for (int l = 0; l < n_mid; ++l) {
    float* next = (l & 1) ? hid1 : hid0;
    const int K = sl.k[l], K8 = (K + 7) & ~7;
    // the pass's sums into the tile; zero from K to K8, the next layer's
    // prev padding
    auto epi = [&](int k0, const float (&acc)[MT][4][4], int rb, int g,
                   int t, int wn) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float* row = next + (rb + i * 16 + g + half * 8) * LDH;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = k0 + wn * 32 + j * 8 + 2 * t + e;
              if (k < K8) row[k] = acc[i][j][2 * half + e];
            }
        }
    };
    if (l == 0)
      tc_core<MT>(PairsA<MT>{x0s, LDX, tabs, P8, ws, vws}, K, wring, epi);
    else
      tc_core<MT>(FieldsA<MT>{x0s, LDX, prev, ldp, F, H,
                              (H + TC_HC - 1) / TC_HC, sl.w[l],
                              (size_t)F * H, H, sl.v[l]},
                  K, wring, epi);
    __syncthreads();                 // the tile is whole, the ring free
    for (int r = warp; r < BM; r += kWarps) {    // its channel sums
      float v = 0.f;
      for (int k = lane; k < K; k += 32) v += next[r * LDH + k];
      v = warp_sum(v);
      if (lane == 0) rsum[r] = (l ? rsum[r] : 0.f) + v;
    }
    prev = next;
    H = K;
    ldp = LDH;
  }
  cp_async_commit();                 // without hidden layers: the x0 tile
  cp_async_wait<0>();
  // Wc into the free ring where it fits, else read where it is
  const int fh = F * H;
  const float* wcs = wc;
  if (fh <= TC_STAGES * TC_WSTAGE) {
    for (int i = threadIdx.x; i < fh; i += kThreads) wring[i] = __ldg(wc + i);
    wcs = wring;
  }
  __syncthreads();

  // the collapsed last layer and the sums, a warp four rows at a time:
  // lanes over h, u[h] = sum_f x0[f] Wc[f,h], z = sum_h prev[h] u[h]
  for (int r0 = warp * 4; r0 < BM; r0 += kWarps * 4) {
    float z[4] = {0.f, 0.f, 0.f, 0.f};
    for (int h = lane; h < H; h += 32) {
      float u[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int f = 0; f < F; ++f) {
        const float w = wcs[f * H + h];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          u[q] = fmaf(x0s[(r0 + q) * LDX + f], w, u[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        z[q] = fmaf(prev[(r0 + q) * ldp + h], u[q], z[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float sx = 0.f;
      if (output_input)
        for (int f = lane; f < F; f += 32) sx += x0s[(r0 + q) * LDX + f];
      sx = warp_sum(sx);
      const float zq = warp_sum(z[q]);
      const int m = m0 + r0 + q;
      if (lane == 0 && m < M)
        out[m] = sx + (n_mid ? rsum[r0 + q] : 0.f) + zq;
    }
  }
}

// rs[m] = (first ? (output_input ? sum_f x0[m,f] : 0) : rs[m])
//         + sum_k h[m,k]: the layer-by-layer path's running sums.
__global__ void row_sums_kernel(const float* __restrict__ h, int K,
                                const float* __restrict__ x0, int F,
                                int first, int output_input,
                                float* __restrict__ rs, int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float s = 0.f;
  if (!first)
    s = rs[m];
  else if (output_input)
    for (int f = 0; f < F; ++f) s += x0[(size_t)m * F + f];
  for (int k = 0; k < K; ++k) s += h[(size_t)m * K + k];
  rs[m] = s;
}

// Rows a block of cin_stack_tc_kernel takes: 128 where the tiles fit the
// opt-in shared memory, else 64; or `want` (64 or 128) where the caller
// asks for it.  0: layer-by-layer launches (want -1, or tiles too large
// for 64 rows).  -1: `want` cannot be had or the device cannot be read.
int stack_rows(int F, int h_max, int n_mid, int want, int device) {
  if (want == -1) return 0;
  if (want != 0 && want != 64 && want != 128) return -1;
  const size_t cap = optin_smem(device);
  if (cap == 0) return -1;
  for (int bm = 128; bm >= 64; bm /= 2)
    if ((want == 0 || want == bm) &&
        stack_tc_smem(bm, F, h_max, n_mid, pairs8(F)) <= cap)
      return bm;
  return want == 0 ? 0 : -1;
}

// cin_stack_sum_f32's scratch, each part on a 16-byte boundary: Wc; for
// the one-kernel path the folded layer 1 and its pair table; for the
// layer-by-layer path the hidden layers (two, in turns) and the sums.
struct StackFwdScratch {
  float* wc;
  float* ws;
  int* tab;
  float* hid[2];
  float* rs;
};

// Carves `base` into sc (with base nullptr, counts alone) for rows-per-
// block bm (stack_rows) and returns the floats it takes.
long long carve_stack_fwd(float* base, const int* ks, int n_layers, int M,
                          int F, int bm, StackFwdScratch* sc) {
  const int n_mid = n_layers - 1;
  size_t off = 0;
  auto take = [&](size_t n) {
    float* p = base ? base + off : nullptr;
    off += align4(n);
    return p;
  };
  int h_max = 0;
  for (int l = 0; l < n_mid; ++l) h_max = ks[l] > h_max ? ks[l] : h_max;
  *sc = StackFwdScratch{};
  sc->wc = take((size_t)F * (n_mid ? ks[n_mid - 1] : F));
  if (bm > 0 && n_mid) {
    sc->ws = take((size_t)ks[0] * pairs8(F));
    sc->tab = reinterpret_cast<int*>(take(pairs8(F)));
  } else if (bm == 0) {
    for (int b = 0; b < (n_mid > 1 ? 2 : n_mid); ++b)
      sc->hid[b] = take((size_t)M * h_max);
    sc->rs = take(M);
  }
  return (long long)off;
}

template <int MT>
int launch_stack_tc(const float* x0, int M, int F, int n_mid,
                    const StackFwdScratch& sc, const StackLayers& sl,
                    int h_max, int output_input, float* out, int device,
                    cudaStream_t s) {
  static std::atomic<bool> done[kMaxDevices];
  CUDA_TRY(allow_smem((const void*)cin_stack_tc_kernel<MT>,
                      optin_smem(device), device, done));
  const int p8 = (int)pairs8(F);
  const int grid = (M + 64 * MT - 1) / (64 * MT);
  cin_stack_tc_kernel<MT><<<grid, kThreads,
                            stack_tc_smem(64 * MT, F, h_max, n_mid, p8), s>>>(
      x0, M, F, copy_floats(x0, F), n_mid, sc.ws, sc.tab, p8,
      copy_floats(sc.ws, p8), sl, h_max, sc.wc, output_input, out);
  return cudaGetLastError();
}

// The layer-by-layer path: each hidden layer by layer() into scratch and
// its channel sums by row_sums_kernel, then the collapsed last layer as a
// layer of one channel with Wc as its weight (1, F, H_{n-1}), adding the
// sums.
int stack_by_layers(const float* x0, const float* const* weights,
                    const int* ks, int n_mid, const StackFwdScratch& sc,
                    float* out, int M, int F, int output_input, int device,
                    cudaStream_t s) {
  const unsigned rows = (M + 255) / 256;
  if (n_mid == 0) {
    row_sums_kernel<<<rows, 256, 0, s>>>(nullptr, 0, x0, F, 1, output_input,
                                         sc.rs, M);
    CUDA_TRY(cudaGetLastError());
  }
  const float* prev = x0;
  int H = F;
  for (int l = 0; l < n_mid; ++l) {
    float* next = sc.hid[l & 1];
    CUDA_TRY(layer(x0, F, prev, H, weights[l], ks[l], next, M, 0, nullptr,
                   device, s));
    row_sums_kernel<<<rows, 256, 0, s>>>(next, ks[l], x0, F, l == 0,
                                         output_input, sc.rs, M);
    CUDA_TRY(cudaGetLastError());
    prev = next;
    H = ks[l];
  }
  return layer(x0, F, prev, H, sc.wc, 1, out, M, 0, sc.rs, device, s);
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
// memory, as an SGEMM micro-kernel does.  cin_stack_sum_bwd_f32 runs each
// non-last layer's backward through the same two kernels, the row
// kernel's epilogue accumulating into dx0 (RowsEpilogue).
// ---------------------------------------------------------------------------

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
                    int M, int F, int H, int K, int vec, int accumulate,
                    const float* __restrict__ add_row, int prev_is_x0) {
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
              *d = (h0 || accumulate ? *d : 0.f) + part[i];
            }
          }
        }
      }
      __syncthreads();   // buffer step & 1 is refilled next step
    }

    // dprev (+ add_row), or, where prev is x0, dx0 += dprev: the block's
    // own rows, after the barrier that ends the loop's dx0 writes
    float* dst = prev_is_x0 ? dx0 : dprev;
    if (FPC == 1) {      // the thread's block is the pass's dprev there
      const bool v4 = H % 4 == 0 && cg * RB_CT + 3 < hw &&
                      reinterpret_cast<uintptr_t>(dst) % 16 == 0;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int m = m0 + rg * RT + i;
        if (m >= M) continue;
        const float base = add_row ? add_row[m] : 0.f;
        float* d = dst + (size_t)m * H + h0 + cg * RB_CT;
        if (v4) {
          float4 v = make_float4(dp[i][0] + base, dp[i][1] + base,
                                 dp[i][2] + base, dp[i][3] + base);
          if (prev_is_x0) {
            const float4 o = *reinterpret_cast<const float4*>(d);
            v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
          }
          *reinterpret_cast<float4*>(d) = v;
        } else {
#pragma unroll
          for (int j = 0; j < RB_CT; ++j)
            if (cg * RB_CT + j < hw)
              d[j] = (prev_is_x0 ? d[j] : 0.f) + (dp[i][j] + base);
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
      if (m0 + m < M) {
        float* d = dst + (size_t)(m0 + m) * H + h0 + h;
        *d = (prev_is_x0 ? *d : 0.f) +
             (dps[h * LD + m] + (add_row ? add_row[m0 + m] : 0.f));
      }
    }
    __syncthreads();   // wbuf is staged again by the next pass
  }
}

// How the row kernel's epilogue writes (cin_flat_bwd_f32 takes the
// defaults; cin_stack_sum_bwd_f32 the rest):
//   accumulate  dx0 += its part (later layers add to what the collapsed
//               layer and the layers above wrote);
//   add_row     dprev[m, :] += add_row[m] (g from the channel sum);
//   prev_is_x0  dprev is x0's gradient too: dx0 += dprev, dprev unused.
struct RowsEpilogue {
  int accumulate = 0;
  const float* add_row = nullptr;
  int prev_is_x0 = 0;
};

template <int RT>
int launch_rows(const float* x0, const float* prev, const float* W,
                const float* g, float* dx0, float* dprev, int M, int F,
                int H, int K, int vec, const RowsEpilogue& ep, int device,
                cudaStream_t s) {
  static std::atomic<bool> done[kMaxDevices];
  CUDA_TRY(allow_smem((const void*)cin_bwd_rows_kernel<RT>,
                      optin_smem(device), device, done));
  const int grid = (M + 16 * RT - 1) / (16 * RT);
  cin_bwd_rows_kernel<RT><<<grid, kThreads, rows_smem(RT, F, H, K), s>>>(
      x0, prev, W, g, dx0, dprev, M, F, H, K, vec, ep.accumulate,
      ep.add_row, ep.prev_is_x0);
  return cudaGetLastError();
}

// dx0 (M, F) and dprev (M, H) of one layer for g (M, K), written as `ep`
// says.
int bwd_rows(const float* x0, const float* prev, const float* W,
             const float* g, float* dx0, float* dprev, int M, int F, int H,
             int K, const RowsEpilogue& ep, int device, cudaStream_t s) {
  if (M == 0) return cudaSuccess;
  const int rt = pick_rt(device, [&](int r) {
    return rows_smem(r, F, H, K); });
  if (rt == 0) return cudaErrorInvalidValue;
  const int vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
  if (rt == 8)
    return launch_rows<8>(x0, prev, W, g, dx0, dprev, M, F, H, K, vec, ep,
                          device, s);
  if (rt == 4)
    return launch_rows<4>(x0, prev, W, g, dx0, dprev, M, F, H, K, vec, ep,
                          device, s);
  if (rt == 2)
    return launch_rows<2>(x0, prev, W, g, dx0, dprev, M, F, H, K, vec, ep,
                          device, s);
  return launch_rows<1>(x0, prev, W, g, dx0, dprev, M, F, H, K, vec, ep,
                        device, s);
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
  CUDA_TRY(cudaGetLastError());
  const size_t want = (n + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  reduce_kernel<<<blocks, 256, 0, s>>>(part, splits, n, out);
  return cudaGetLastError();
}

// cin_stack_sum_bwd_f32's scratch, carved in this order, each part
// starting on a 16-byte boundary: Wc and its transpose, the hidden
// layers (M x K_l each), two hidden-gradient buffers (M x max K_l), the
// weight gradients' partial sums.
struct StackBwdScratch {
  float* wc;
  float* wct;
  float* hid[kMaxLayers];
  float* dh[2];
  float* part;
};

// Carves `base` into sc (with base nullptr, counts alone) and returns
// the floats it takes, or -1 when the device cannot be read.
long long carve_stack_bwd(float* base, const int* ks, int n_layers, int M,
                          int F, int device, StackBwdScratch* sc) {
  const int n_mid = n_layers - 1;
  size_t off = 0;
  auto take = [&](size_t n) {
    float* p = base ? base + off : nullptr;
    off += align4(n);
    return p;
  };
  int h = F;
  // the collapsed layer's weight gradient: K' = F, N = H_{n-1}
  long long dw_max =
      cin_dw_scratch(M, F, n_mid ? ks[n_mid - 1] : F, device);
  if (dw_max < 0) return -1;
  long long h_max = 0;
  for (int l = 0; l < n_mid; ++l) {
    const long long n = cin_dw_scratch(M, ks[l], F * h, device);
    if (n < 0) return -1;
    dw_max = n > dw_max ? n : dw_max;
    h_max = ks[l] > h_max ? ks[l] : h_max;
    h = ks[l];
  }
  sc->wc = take((size_t)F * h);
  sc->wct = take((size_t)F * h);
  for (int l = 0; l < n_mid; ++l) sc->hid[l] = take((size_t)M * ks[l]);
  sc->dh[0] = take((size_t)M * h_max);
  sc->dh[1] = take((size_t)M * h_max);
  sc->part = take((size_t)dw_max);
  return (long long)off;
}

}  // namespace

extern "C" {

// Floats of scratch cin_flat_f32 takes for these shapes (same: prev is
// x0), 0 where the layer runs on cin_layer_mma_kernel, which needs none.
long long cin_flat_scratch(int M, int F, int H, int K, int same,
                           int device) {
  return wg_scratch(wg_plan(M, F, H, K, same && H == F, device));
}

// x0 (M, F), prev (M, H), W (K, F, H) -> out (M, K); all f32, contiguous;
// scratch holds cin_flat_scratch(M, F, H, K, prev == x0, device) floats
// (nullptr where that is 0).  *path: 1 where cin_layer_mma_kernel ran, 2
// where cin_layer_tc_kernel did.  Returns a cudaError_t (0 on success).
int cin_flat_f32(const float* x0, const float* prev, const float* W,
                 float* out, int M, int F, int H, int K, float* scratch,
                 int* path, int device, void* stream) {
  CUDA_TRY(use_device(device));
  return layer(x0, F, prev, H, W, K, out, M, 0, nullptr, device,
               static_cast<cudaStream_t>(stream), scratch, path);
}

// Floats of scratch cin_stack_sum_f32 needs for these layers and rows
// per block `bm` (0: the largest whose tiles fit, 64 or 128, -1: layer by
// layer), or -1 when that cannot be had or the device cannot be read.
long long cin_stack_fwd_scratch(const int* ks, int n_layers, int M, int F,
                                int bm, int device) {
  if (n_layers < 1 || n_layers - 1 > kMaxLayers) return -1;
  int h_max = 0;
  for (int l = 0; l < n_layers - 1; ++l) h_max = ks[l] > h_max ? ks[l] : h_max;
  const int rows = stack_rows(F, h_max, n_layers - 1, bm, device);
  if (rows < 0) return -1;
  StackFwdScratch sc;
  return carve_stack_fwd(nullptr, ks, n_layers, M, F, rows, &sc);
}

// x0 (M, F); weights[i] (ks[i], F, H_{i-1}) with H_0 = F, i < n_layers;
// out (M,).  scratch holds cin_stack_fwd_scratch(ks, n_layers, M, F, bm,
// device) floats; bm as there.  Returns a cudaError_t (0 on success).
int cin_stack_sum_f32(const float* x0, const float* const* weights,
                      const int* ks, int n_layers, float* scratch, float* out,
                      int M, int F, int output_input, int bm, int device,
                      void* stream) {
  if (n_layers < 1 || n_layers - 1 > kMaxLayers) return cudaErrorInvalidValue;
  CUDA_TRY(use_device(device));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_mid = n_layers - 1;
  StackLayers sl = {};
  int h_max = 0, h = F;
  for (int l = 0; l < n_mid; ++l) {
    h_max = ks[l] > h_max ? ks[l] : h_max;
    sl.w[l] = weights[l];
    sl.k[l] = ks[l];
    sl.v[l] = copy_floats(weights[l], h);
    h = ks[l];
  }
  const int rows = stack_rows(F, h_max, n_mid, bm, device);
  if (rows < 0) return cudaErrorInvalidValue;
  StackFwdScratch sc;
  carve_stack_fwd(scratch, ks, n_layers, M, F, rows, &sc);
  if (M == 0) return cudaSuccess;
  // Wc, and layer 1 folded where one kernel runs the stack
  const int k1 = rows && n_mid ? ks[0] : 0;
  const size_t n = (size_t)k1 * pairs8(F) + (size_t)F * h;
  stack_prep_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      weights[0], k1, F, (int)pairs8(F), sc.ws, sc.tab, weights[n_mid],
      ks[n_mid], h, sc.wc);
  CUDA_TRY(cudaGetLastError());
  if (rows == 128)
    return launch_stack_tc<2>(x0, M, F, n_mid, sc, sl, h_max, output_input,
                              out, device, s);
  if (rows == 64)
    return launch_stack_tc<1>(x0, M, F, n_mid, sc, sl, h_max, output_input,
                              out, device, s);
  return stack_by_layers(x0, weights, ks, n_mid, sc, out, M, F, output_input,
                         device, s);
}

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
  CUDA_TRY(use_device(device));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUDA_TRY(bwd_rows(x0, prev, W, g, dx0, dprev, M, F, H, K, RowsEpilogue(),
                    device, s));
  return weight_grad(g, K, x0, F, prev, H, M, scratch, dW, device, s);
}

// Floats of scratch cin_stack_sum_bwd_f32 needs for these layers, or -1
// when the device cannot be read.
long long cin_stack_bwd_scratch(const int* ks, int n_layers, int M, int F,
                                int device) {
  if (n_layers < 1 || n_layers - 1 > kMaxLayers) return -1;
  StackBwdScratch sc;
  return carve_stack_bwd(nullptr, ks, n_layers, M, F, device, &sc);
}

// The backward of cin_stack_sum_f32 (replaces _cin_stack_bwd,
// cin_kernel.py:519-568): x0 (M, F), the layers' weights, g (M,) ->
// dx0 (M, F), dws[l] (K_l, F, H_{l-1}) for the non-last layers and
// dwc (F, H_{n-1}), the gradient every channel of the last layer shares.
// The hidden layers are recomputed into scratch (M x K_l each), once.
// Then, from the top: the collapsed last layer writes dx0 and the
// gradient into h_{n-1} (g from the channel sum included); each layer
// below takes its weight gradient from cin_wgrad_kernel and its input
// gradients from one row-kernel launch, which adds into dx0 and writes
// the next hidden gradient (+ g) or, at layer 1, where prev is x0, adds
// both input gradients into dx0.
int cin_stack_sum_bwd_f32(const float* x0, const float* g,
                          const float* const* weights, const int* ks,
                          int n_layers, float* scratch, float* dx0,
                          float* const* dws, float* dwc, int M, int F,
                          int output_input, int device, void* stream) {
  if (n_layers < 1 || n_layers - 1 > kMaxLayers) return cudaErrorInvalidValue;
  CUDA_TRY(use_device(device));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_mid = n_layers - 1;
  int hin[kMaxLayers + 1];
  hin[0] = F;
  for (int l = 0; l < n_mid; ++l) hin[l + 1] = ks[l];
  const int hl = hin[n_mid];
  StackBwdScratch sc;
  if (carve_stack_bwd(scratch, ks, n_layers, M, F, device, &sc) < 0)
    return cudaErrorInvalidValue;

  collapse_kernel<<<(F * hl + 255) / 256, 256, 0, s>>>(
      weights[n_mid], ks[n_mid], F, hl, sc.wc, sc.wct);
  CUDA_TRY(cudaGetLastError());
  for (int l = 0; l < n_mid; ++l)            // the hidden layers, once
    CUDA_TRY(layer(x0, F, l ? sc.hid[l - 1] : x0, hin[l], weights[l], ks[l],
                   sc.hid[l], M, 0, nullptr, device, s));
  const float* h_last = n_mid ? sc.hid[n_mid - 1] : x0;

  // the collapsed last layer, out += sum_f x0[f] sum_h Wc[f,h] h_last[h],
  // as layers of one field g: dx0 = g (h_last Wc^T) (+ g) with Wc as
  // (F, 1, H_{n-1}); dWc = (g x0)^T h_last
  CUDA_TRY(layer(g, 1, h_last, hl, sc.wc, F, dx0, M, 0,
                 output_input ? g : nullptr, device, s));
  CUDA_TRY(weight_grad(x0, F, g, 1, h_last, hl, M, sc.part, dwc, device, s));
  if (n_mid == 0)                            // h_last is x0 itself
    return layer(g, 1, x0, F, sc.wct, F, dx0, M, 1, nullptr, device, s);
  int cur = 0;                               // dh_{n-1} = g (x0 Wc) + g
  CUDA_TRY(layer(g, 1, x0, F, sc.wct, hl, sc.dh[cur], M, 0, g, device, s));
  for (int l = n_mid - 1; l >= 0; --l) {
    const float* dh = sc.dh[cur];
    const float* prev = l ? sc.hid[l - 1] : x0;
    CUDA_TRY(weight_grad(dh, ks[l], x0, F, prev, hin[l], M, sc.part, dws[l],
                         device, s));
    RowsEpilogue ep;
    ep.accumulate = 1;
    if (l == 0) {
      ep.prev_is_x0 = 1;
      CUDA_TRY(bwd_rows(x0, x0, weights[0], dh, dx0, nullptr, M, F, F, ks[0],
                        ep, device, s));
    } else {                                 // + g: h_l's channel sum
      ep.add_row = g;
      CUDA_TRY(bwd_rows(x0, prev, weights[l], dh, dx0, sc.dh[1 - cur], M, F,
                        hin[l], ks[l], ep, device, s));
      cur = 1 - cur;
    }
  }
  return cudaSuccess;
}

}  // extern "C"
