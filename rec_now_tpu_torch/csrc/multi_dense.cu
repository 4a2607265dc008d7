// Batched multi-expert dense for Hopper (sm_90a), f32 in and out.
//
// Replaces multi_dense_pallas (rec_now_tpu/ops/pallas/multi_dense_kernel.py,
// pallas_call at :75): N same-shape Dense layers in one launch,
//     out[n, b, u] = act( sum_d x[n', b, d] * W[n, d, u] + bias[n, u] )
// with n' = n for a per-expert (N, B, D) input and n' = 0 for a shared
// (1, B, D) one, act = ReLU or none, fused into the epilogue.  Taken from
// the math, not from the TPU blocks: the TPU broadcasts a shared input to
// (N, B, D) and pads B to its row tile (:62-73); here any B, D, U and N is
// masked at its edge, with no padding or broadcast copy.  One launch per
// call, one of four kernels: multi_dense_f32 runs (a), (b) or (d) by shape
// and by whether the caller hands it scratch (ops/multi_dense_kernel.py's
// takes_wgmma_bank decides), multi_dense_wg_f32 runs (c), one weight as
// nn.Linear stores it, where linear_wg takes the call (DNNTower's layers
// when no gradient is recorded), and cross_wg_f32 runs (c) twice for one
// layer of DCN-V2's low-rank cross (its cross_wg, LowRankCrossLayer's
// layers when no gradient is recorded).  The expert banks' two
// tensor-core designs, (a) and (d), share the kernel name multi_dense_tc:
// each launch of either is counted multi_dense.tc, those of (d) also
// multi_dense.tc_wgmma.
//
// (a) multi_dense_tc<BN, WARPS_M, MIN_BLOCKS>, the split-TF32 mma.sync
//     tile: every bank call that neither (b) nor (d) takes (a per-expert
//     input, D % 4 != 0 as config 4's MMoE bank at D = 429, x off the
//     16-byte grid, a shallow or small call).
//     A shared input is one (B, D) x (D, N*U) product: virtual column c is
//     expert c / U, unit c % U; a per-expert input is N products of
//     (B, D) x (D, U) (grid.z).  A block owns a 128-row x BN-column tile
//     and walks D in 32-deep chunks through a 3-stage ring of
//     shared memory filled by cp.async, so the next chunks' copies overlap
//     this chunk's products.  x rows of D = 429 floats start 4-byte but not
//     16-byte aligned (and TMA needs 16-byte global strides, so it cannot
//     read x there): x is copied 4 bytes a thread when D % 4 != 0 or the
//     pointer is misaligned, 16 bytes (cp.async.cg) otherwise; W the same by
//     U.  The ragged edge is zero-filled through cp.async's src-size 0.
//     Rows are padded (x: 32 + 4 floats, W: BN + 8) so the m16n8k8 fragment
//     reads hit 32 distinct banks.  The column tiles of one row tile are
//     neighbours in launch order (blockIdx.x), so a shared x tile is read
//     again from L2, not HBM.  Bias, ReLU and the (N, B, U) store are fused
//     in the epilogue.  Tiles: BN = 256 for a shared input whose N*U is a
//     multiple of 256 with U a multiple of 128 (config 4's MMoE layer 0:
//     8 warps of 64 x 64, one block an SM, so each split operand feeds
//     three products per k-step where 64 x 32 warps give two), BN = 128
//     where U is a multiple of 128 (8 warps of 64 x 32), else BN = 64 (8
//     warps of 32 x 32), two blocks an SM.
//     Products run on the tensor cores (mma.sync m16n8k8 TF32) in split
//     TF32 ("3xTF32"): each operand v = hi + lo with hi = rna_tf32(v) and
//     lo = rna_tf32(v - hi), and each 8-deep k-step takes lo*hi + hi*lo +
//     hi*hi, the small terms first, into a fresh register quad that is then
//     added to the running f32 sum.  One TF32 pass keeps 11 bits of each
//     operand: on config 4's banks it lands ~3e-4 of max|out| from f64,
//     three times the 1e-4 that the port holds every kernel to, and Adam
//     normalises each gradient element, so that error would show at lr
//     scale; split TF32 lands ~5e-7 away, as plain f32 does.  The fresh
//     quad matters as much: the tensor cores truncate each accumulation to
//     f32, so chaining every k-step on one accumulator would lose up to an
//     ulp of the running sum per product, an error that grows with D; a
//     k-step's sum is small, and the running sum's adds round to nearest.
//     Bound: operations.  Three tensor-core products per multiply-add at
//     495 TFLOP/s (TF32, dense): config 4's (1, 8192, 429) x (4, 429, 128)
//     bank is 3.6 GFLOP, 0.022 ms; its bytes (x, W, out) 0.009 ms.
//
// (b) multi_dense_gate, a shared input with N*U <= 16 (config 4's gate bank
//     (1, B, 429) x (2, 429, 4)): bound by bytes, 14 MB of x for 56 MFLOP.
//     x is read once, row-major and coalesced, for all N experts: a warp
//     takes 32 / NUP rows (NUP = N*U rounded up to 4, 8 or 16), its lanes
//     stride over D, and each lane keeps the rows' NUP sums over its slice
//     of D in registers.  W (N*D*U floats, 13.7 KB for the gate bank) is
//     staged in shared memory once per block.  A warp-shuffle fold leaves
//     lane l with the full sum of output l (row l / NUP, column l % NUP).
//     Plain f32 FMAs: the pass is bound by bytes, not arithmetic.
//
// (c) linear_wg_kernel, (B, D) x (U, D)^T: wgmma fed by TMA, the weight
//     split once a call inside the launch, bias and ReLU in the epilogue;
//     see "one weight as nn.Linear stores it" below.  Two compile-time
//     variants serve the low-rank cross: a weight stored (D, U), and the
//     epilogue x0 * (acc + bias) + x_l; see "the low-rank cross" below.
//
// (d) multi_dense_tc<N>, a shared-input bank on (c)'s body (lw_body, mode
//     kBank): one (B, D) x (D, N * U) product, virtual unit c expert c /
//     U, unit c % U as in (a).  Phase 1 reads W in its (N, D, U) storage
//     through kInOut's 32 x 32 transposing tiles, each lane at its own
//     unit's expert; the epilogue adds the (N, 1, U) bias, applies ReLU
//     and writes (N, B, U) at expert column / U, with no copy after.  A
//     pass is the widest of 200, 128 or 64 units that divides U (no pass
//     straddles two experts), else lw_plan's choice.  TMA reads x, so
//     D % 4 == 0 and x 16-byte aligned; the caller hands the planes'
//     scratch (multi_dense_bank_scratch) only where takes_wgmma_bank
//     takes the call: those, a shared input with N * U > 16, D >= 192 and
//     B * N * U >= 2^14 (shallower banks lose to (a) at some size: the
//     split and the grid barrier cost ~1 us more than (a)'s launch).
//     Bound as (a); the PLE cell's (1, 8,192, 2,176) x (4, 2,176, 512)
//     bank is 0.44 ms.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"
#include "runtime.cuh"
#include "wgmma.cuh"

namespace {

// ---- (a) tensor-core tile ----
constexpr int kThreads = 256;          // 8 warps
constexpr int kBM = 128;               // rows of a block tile
constexpr int kBK = 32;                // depth of a staged chunk of D
constexpr int kStages = 3;             // cp.async ring depth
constexpr int kXS = kBK + 4;           // x row stride in shared memory

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32_rna(float v, uint32_t& hi,
                                               uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

template <int BN>
constexpr int tc_smem_bytes() {
  return kStages * (kBM * kXS + kBK * (BN + 8)) * 4;
}

// x: (B, D) rows of expert blockIdx.z (x_stride_n apart; 0 when shared);
// virtual column c in [0, ncols) is expert blockIdx.z + c / U, unit c % U.
// vx / vw: 16-byte copies of x / W; vec2: float2 stores (U even).
template <int BN, int WARPS_M, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
multi_dense_tc(const float* __restrict__ x, long long x_stride_n,
               const float* __restrict__ w, const float* __restrict__ bias,
               float* __restrict__ out, int B, int D, int U, int ncols,
               int relu, int vx, int vw, int vec2) {
  constexpr int WARPS_N = kThreads / 32 / WARPS_M;
  constexpr int WM = kBM / WARPS_M, WN = BN / WARPS_N;    // warp tile
  constexpr int MT = WM / 16, NT = WN / 8;                // mma tiles
  constexpr int WS = BN + 8;                              // W row stride
  constexpr int X_STAGE = kBM * kXS, W_STAGE = kBK * WS;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [kStages][kBM][kXS]
  float* ws = smem + kStages * X_STAGE;      // [kStages][kBK][WS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * BN;
  const int b0 = blockIdx.y * kBM;
  const int n0 = blockIdx.z;
  const float* xn = x + n0 * x_stride_n;
  const long long DU = (long long)D * U;
  const int nk = (D + kBK - 1) / kBK;

  // this thread's W column (4-byte copies) or column quad (16-byte)
  constexpr int QR = BN / 4;
  const int wc = vw ? col0 + (tid % QR) * 4 : col0 + tid % BN;
  const bool wc_ok = wc < ncols;
  const long long wc_off =
      wc_ok ? (n0 + wc / U) * DU + wc % U : 0;

  // rolled loops with running pointers: unrolled, the copies' addresses
  // would be hoisted out of the D loop and spill
  auto load = [&](int stage, int k0) {
    float* xd = xs + stage * X_STAGE;
    if (vx) {                  // kBM rows x kBK / 4 quads
      constexpr int QX = kBK / 4, RS = kThreads / QX;
      const int c = (tid % QX) * 4, d = k0 + c;
      int r = tid / QX;
      const float* src = xn + (long long)(b0 + r) * D + d;
#pragma unroll 1
      for (; r < kBM; r += RS, src += (long long)RS * D) {
        const bool ok = b0 + r < B && d < D;
        cp_async16(xd + r * kXS + c, ok ? src : xn, ok);
      }
    } else {                   // kBM rows x kBK floats
      constexpr int RS = kThreads / kBK;
      const int c = tid % kBK, d = k0 + c;
      int r = tid / kBK;
      const float* src = xn + (long long)(b0 + r) * D + d;
#pragma unroll 1
      for (; r < kBM; r += RS, src += (long long)RS * D) {
        const bool ok = b0 + r < B && d < D;
        cp_async4(xd + r * kXS + c, ok ? src : xn, ok);
      }
    }
    float* wd = ws + stage * W_STAGE;
    const int c = vw ? (tid % QR) * 4 : tid % BN;
    const int RS = vw ? kThreads / QR : kThreads / BN;
    int r = vw ? tid / QR : tid / BN;
    const float* src = w + wc_off + (long long)(k0 + r) * U;
#pragma unroll 1
    for (; r < kBK; r += RS, src += (long long)RS * U) {
      const bool ok = wc_ok && k0 + r < D;
      if (vw)                  // kBK rows x BN / 4 quads
        cp_async16(wd + r * WS + c, ok ? src : w, ok);
      else                     // kBK rows x BN floats
        cp_async4(wd + r * WS + c, ok ? src : w, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s * kBK);
    cp_async_commit();
  }

  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane >> 2, t = lane & 3;     // mma group, thread in group
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();    // chunk kc has landed
    __syncthreads();                 // ... for all; chunk kc - 1 is done
    const int next = kc + kStages - 1;
    if (next < nk) load(next % kStages, next * kBK);
    cp_async_commit();

    const float* xa = xs + (kc % kStages) * X_STAGE + (wm * WM + g) * kXS + t;
    const float* wb = ws + (kc % kStages) * W_STAGE + t * WS + wn * WN + g;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        split_tf32_rna(wb[kk * WS + j * 8], bh[j][0], bl[j][0]);       // k = t
        split_tf32_rna(wb[(kk + 4) * WS + j * 8], bh[j][1], bl[j][1]); // t + 4
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* p = xa + i * 16 * kXS + kk;
        uint32_t ah[4], al[4];
        split_tf32_rna(p[0], ah[0], al[0]);             // row g, col t
        split_tf32_rna(p[8 * kXS], ah[1], al[1]);       // row g + 8
        split_tf32_rna(p[4], ah[2], al[2]);             // col t + 4
        split_tf32_rna(p[8 * kXS + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float part[4];               // this k-step's 8 terms, 3 products
          mma_tf32_new(part, al, bh[j]);
          mma_tf32(part, ah, bl[j]);
          mma_tf32(part, ah, bh[j]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += part[q];
        }
      }
    }
  }

  // epilogue: c0, c1 at (row g, columns 2t, 2t + 1), c2, c3 at row g + 8
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = col0 + wn * WN + j * 8 + 2 * t;
    long long base[2];
    float bv[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ok[h] = c + h < ncols;
      const int e = n0 + (c + h) / U, u = (c + h) % U;
      base[h] = (long long)e * B * U + u;
      bv[h] = (bias && ok[h]) ? __ldg(bias + (long long)e * U + u) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int b = b0 + wm * WM + i * 16 + g + half * 8;
        if (b >= B) continue;
        float v0 = acc[i][j][2 * half] + bv[0];
        float v1 = acc[i][j][2 * half + 1] + bv[1];
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const long long row = (long long)b * U;
        if (vec2 && ok[1]) {
          *reinterpret_cast<float2*>(out + base[0] + row) =
              make_float2(v0, v1);
        } else {
          if (ok[0]) out[base[0] + row] = v0;
          if (ok[1]) out[base[1] + row] = v1;
        }
      }
    }
  }
}

// ---- (b) the gate bank: one pass over x ----
constexpr int kGateMaxSmem = 48 * 1024;
constexpr int kUnroll = 4;             // D-steps of 32 loaded ahead

// lanes hold v[0..N) each; after fold<32>, ..., fold<2> lane l holds the
// sum over the warp of value l
template <int N>
__device__ __forceinline__ void fold(float (&v)[32], int lane) {
  constexpr int H = N / 2;
  const bool up = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// x (B, D) shared by N experts of U units, NU = N * U <= NUP columns
template <int NUP>
__global__ void __launch_bounds__(kThreads)
multi_dense_gate(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int B, int D, int U, int NU, int relu) {
  constexpr int R = 32 / NUP;            // rows a warp takes at once
  extern __shared__ __align__(16) float wsm[];   // [D][NUP], zero padded
  const long long DU = (long long)D * U;
  for (int i = threadIdx.x; i < D * NUP; i += kThreads) wsm[i] = 0.f;
  __syncthreads();
  for (long long i = threadIdx.x; i < (long long)NU * D; i += kThreads) {
    const int e = (int)(i / DU);         // W read in its own order
    const int rem = (int)(i - e * DU), d = rem / U;
    wsm[d * NUP + e * U + (rem - d * U)] = __ldg(w + i);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kThreads / 32);
  for (int task = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       (long long)task * R < B; task += warps) {
    const int row0 = task * R;
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = 0.f;
    for (int d0 = 0; d0 < D; d0 += 32 * kUnroll) {
      float xv[kUnroll][R];
#pragma unroll
      for (int s = 0; s < kUnroll; ++s) {
        const int d = d0 + s * 32 + lane;
#pragma unroll
        for (int r = 0; r < R; ++r)
          xv[s][r] = (d < D && row0 + r < B)
                         ? __ldg(x + (long long)(row0 + r) * D + d) : 0.f;
      }
#pragma unroll
      for (int s = 0; s < kUnroll; ++s) {
        const int d = d0 + s * 32 + lane;
        if (d >= D) break;
        const float4* wv = reinterpret_cast<const float4*>(wsm + d * NUP);
#pragma unroll
        for (int q = 0; q < NUP / 4; ++q) {
          const float4 wq = wv[q];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float* a = v + r * NUP + 4 * q;
            a[0] = fmaf(xv[s][r], wq.x, a[0]);
            a[1] = fmaf(xv[s][r], wq.y, a[1]);
            a[2] = fmaf(xv[s][r], wq.z, a[2]);
            a[3] = fmaf(xv[s][r], wq.w, a[3]);
          }
        }
      }
    }
    fold<32>(v, lane);
    fold<16>(v, lane);
    fold<8>(v, lane);
    fold<4>(v, lane);
    fold<2>(v, lane);
    const int b = row0 + lane / NUP, j = lane % NUP;
    if (j < NU && b < B) {
      float o = v[0] + (bias ? __ldg(bias + j) : 0.f);   // bias (N, 1, U)
      if (relu) o = fmaxf(o, 0.f);
      out[(long long)(j / U) * B * U + (long long)b * U + j % U] = o;
    }
  }
}

// ---- (c) one weight as nn.Linear stores it, on wgmma ----
// out (B, U) = act(x (B, D) W^T + bias), W (U, D) row-major: nn.Linear's
// (out, in) storage, which is K-major, as TF32 wgmma takes its B operand.
// The structure of csrc/cin.cu's cin_layer_tc_kernel, one cooperative
// launch in two phases:
//   1. Every block writes a share of W, split into TF32 hi and lo planes,
//      into the caller's scratch as planes[plane][d / 32][u][d % 32], zero
//      past D and past the padded units Kp: the split is made once a call,
//      inside the launch, so it never goes stale.  A grid barrier follows.
//   2. Persistent blocks of 384 threads walk units (128-row tile, column
//      pass of N units); the grid is every block that can be resident, so
//      all SMs share phase 1, and blocks past the units stop after it.
//      Warpgroup 2's first thread streams a unit's stages with two TMA
//      copies each into a ring of up to 8 stages on full / empty mbarriers: the x box (128 rows x 32 floats, zero past
//      B and D) and the planes' box (N rows of 32 floats, hi then lo),
//      128-byte rows in SWIZZLE_128B.  Warpgroups 0 and 1 (64 rows each)
//      read their A fragments of the stage's 4 k-steps from the x box,
//      split them into hi and lo in registers and run wgmma m64nNk8 three
//      times a k-step, lo*hi + hi*lo + hi*hi, against the landed planes: a
//      chain of 12 on a zeroed accumulator, added to an f32 total once it
//      is done (the tensor cores truncate as they accumulate; chains of 4
//      k-steps are B2's choice, csrc/cin.cu).  The two warpgroups run
//      their chains in turns.  The epilogue adds the bias, applies the
//      ReLU (NaN stays NaN, as torch.relu) and writes (B, U) once.
// TMA needs x's rows on the 16-byte grid: D % 4 == 0 and x 16-byte
// aligned (ops/multi_dense_kernel.py's wgmma_plan decides; DNNTower runs
// xDeepFM's 390-wide rows on nn.Linear).  Bound: operations, three TF32
// products a multiply-add at 495 TFLOP/s; DLRM-DCNv2's over arch at
// B = 8,192 is 85.9 GFLOP, 0.52 ms.  N, the units a pass, is 64, 128 or 200, the one
// with the least nt * (N + 32) for nt = ceil(U / N) passes (a pass costs
// about 32 units of work besides its width): 128 at U = 1,024, 512 and
// 256, 200 at 400.  The chain and the total take N registers a thread.
constexpr int LW_THREADS = 384;      // consumer warpgroups 0, 1; producer 2
constexpr int LW_ROWS = 128;         // a tile's rows, 64 a consumer warpgroup
constexpr int LW_KS = 4;             // k-steps of 8 a stage: 128-byte rows
constexpr int LW_XSTAGE = LW_ROWS * 128;    // bytes of x a stage
constexpr int LW_MAX_STAGES = 8;

// ---- the low-rank cross: (c) in two compile-time variants ----
// DCN-V2's x_{l+1} = x0 * ((x_l V) W + b) + x_l (layers/
// low_rank_cross_layer.py) is two launches of linear_wg_kernel: u = x_l V
// (B, D) x (D, r), then (B, r) x (r, D) with the epilogue.  V (D, r) and W
// (r, D) are stored (in, out), N-major, and TF32 wgmma takes only a K-major
// B operand, so phase 1 transposes as it splits: each warp moves 32 x 32
// tiles (32 k of 32 units) through a padded tile of its own in the stage
// memory, which TMA fills only after the grid barrier, reading 128-byte
// rows of W and writing 128-byte rows of the planes, whose layout, box and
// everything after the barrier stay as they are.  The cross epilogue reads
// x0 and x_l at the output's positions (float2 where U is even, as the
// stores), four column pairs' loads ahead of their stores, and writes
// x0 * (acc + b) + x_l once, fused into one rounding; NaN propagates as
// through torch.addcmul.  Layer 0 passes x0 as x_l.
// Bound: operations, 2 * B * D * r multiply-adds a layer in three TF32
// products at 495 TFLOP/s: DLRM-DCNv2's 3,456 x 512 at B = 8,192 is 174
// GFLOP in three layers, 1.05 ms.
enum LwMode {
  kOutIn,     // W (U, D), nn.Linear's storage; bias and ReLU
  kInOut,     // W (D, U); bias and ReLU
  kCross,     // W (D, U); out = x0 * (acc + bias) + xl
  kBank,      // an expert bank's W (N, D, ue), U = N * ue; bias and ReLU
};
constexpr int LW_WARPS = LW_THREADS / 32;
constexpr int LW_TILE = 32 * 33;     // a warp's transposing tile, padded
static_assert(LW_WARPS * LW_TILE * 4 <= 2 * (LW_XSTAGE + 2 * 64 * 128),
              "the transposing tiles fit two stages of the narrowest pass");

struct LwArgs {
  const float* w;
  const float* bias;   // (U) or null
  float* out;
  float* planes;       // 2 * JB * Kp * 32 floats
  int M, D, U, relu;
  int JB, Kp;          // k-blocks of 32 floats; the planes' rows
  int NT, units, stages;
  const float* x0;     // kCross: (M, U), read at the output's positions
  const float* xl;
  int ue;              // kBank: an expert's units
};

// x0 and x_l at row m, columns col and col + 1 (0 past M and U): a float2
// where U is even
__device__ __forceinline__ float2 cross_load(const float* p, int m, int col,
                                             int M, int U, bool pairs) {
  if (m >= M || col >= U) return make_float2(0.f, 0.f);
  p += (size_t)m * U + col;
  if (pairs) return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(__ldg(p), col + 1 < U ? __ldg(p + 1) : 0.f);
}

// kCross's epilogue, out = x0 * (tot + bias) + xl at a consumer thread's
// positions (rows m0, m0 + 8; columns n0 + 8c + 2t, + 1): each group of
// kCrossGroup column pairs loads all of its x0, x_l and bias before its
// first store, so that the loads overlap (one load after another's store
// would wait for it: out is not known to differ from x0 or x_l).
constexpr int kCrossGroup = 4;

template <int R>
__device__ __forceinline__ void cross_epilogue(const LwArgs& a,
                                               const float (&tot)[R], int m0,
                                               int n0, int t, bool pairs) {
  constexpr int C = R / 4, G = kCrossGroup;
#pragma unroll
  for (int c0 = 0; c0 < C; c0 += G) {
    float2 p[G][2], q[G][2], b[G];
#pragma unroll
    for (int j = 0; j < G && c0 + j < C; ++j) {
      const int col = n0 + 8 * (c0 + j) + 2 * t;
      b[j] = make_float2(a.bias && col < a.U ? __ldg(a.bias + col) : 0.f,
                         a.bias && col + 1 < a.U ? __ldg(a.bias + col + 1)
                                                 : 0.f);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        p[j][half] = cross_load(a.x0, m0 + 8 * half, col, a.M, a.U, pairs);
        q[j][half] = cross_load(a.xl, m0 + 8 * half, col, a.M, a.U, pairs);
      }
    }
#pragma unroll
    for (int j = 0; j < G && c0 + j < C; ++j) {
      const int c = c0 + j, col = n0 + 8 * c + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + 8 * half;
        if (m >= a.M || col >= a.U) continue;
        const float x = fmaf(p[j][half].x, tot[4 * c + 2 * half] + b[j].x,
                             q[j][half].x);
        const float y = fmaf(p[j][half].y,
                             tot[4 * c + 2 * half + 1] + b[j].y,
                             q[j][half].y);
        float* o = a.out + (size_t)m * a.U + col;
        if (pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(x, y);
        } else {
          o[0] = x;
          if (col + 1 < a.U) o[1] = y;
        }
      }
    }
  }
}

// kBank's epilogue at a consumer thread's positions (rows m0, m0 + 8;
// columns n0 + 8c + 2t, + 1): column col of the N * ue units is expert
// col / ue, unit col % ue, written into out (N, M, ue); the bias (N, 1,
// ue) is read at col.  A float2 store where ue is even (col is even, so
// col + 1 is the same expert's next unit).
template <int R>
__device__ __forceinline__ void bank_epilogue(const LwArgs& a,
                                              const float (&tot)[R], int m0,
                                              int n0, int t) {
  const bool pairs = (a.ue & 1) == 0;
  const size_t plane = (size_t)a.M * a.ue;       // an expert's outputs
#pragma unroll
  for (int c = 0; c < R / 4; ++c) {
    const int col = n0 + 8 * c + 2 * t;
    const float b0 = a.bias && col < a.U ? __ldg(a.bias + col) : 0.f;
    const float b1 = a.bias && col + 1 < a.U ? __ldg(a.bias + col + 1) : 0.f;
    const int e0 = col / a.ue, e1 = (col + 1) / a.ue;
    float* o0 = a.out + e0 * plane + (col - e0 * a.ue);
    float* o1 = a.out + e1 * plane + (col + 1 - e1 * a.ue);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + 8 * half;
      float x = tot[4 * c + 2 * half] + b0;
      float y = tot[4 * c + 2 * half + 1] + b1;
      if (a.relu) {
        x = x < 0.f ? 0.f : x;
        y = y < 0.f ? 0.f : y;
      }
      if (m < a.M && col < a.U) {
        const size_t row = (size_t)m * a.ue;
        if (pairs) {
          *reinterpret_cast<float2*>(o0 + row) = make_float2(x, y);
        } else {
          o0[row] = x;
          if (col + 1 < a.U) o1[row] = y;
        }
      }
    }
  }
}

// The body of linear_wg_kernel and of the banks' multi_dense_tc<N>, one
// cooperative launch (see "one weight as nn.Linear stores it" above).
template <int N, int MODE>
__device__ __forceinline__ void lw_body(const LwArgs& a,
                                        const CUtensorMap* xmap,
                                        const CUtensorMap* wmap) {
  constexpr int R = N / 2;                        // accumulators a thread
  constexpr int STAGE = LW_XSTAGE + 2 * N * 128;  // bytes: x, W hi, W lo
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + a.stages * STAGE);
  uint64_t* empty = full + a.stages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);       // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // phase 1: W in TF32 hi and lo, planes[plane][jb][u][32]
  if constexpr (MODE == kOutIn) {
    const int n = a.JB * a.Kp * 32;
    for (int e = blockIdx.x * LW_THREADS + tid; e < n;
         e += gridDim.x * LW_THREADS) {
      const int r = e >> 5, jb = r / a.Kp, u = r - jb * a.Kp;
      const int d = 32 * jb + (e & 31);
      const float v =
          u < a.U && d < a.D ? __ldg(a.w + (size_t)u * a.D + d) : 0.f;
      uint32_t hi, lo;
      split_tf32(v, hi, lo);
      a.planes[e] = __uint_as_float(hi);
      a.planes[n + e] = __uint_as_float(lo);
    }
    asm volatile("fence.proxy.async.global;" ::: "memory");
  } else {          // W (D, U), or a bank's (N, D, ue): 32 x 32 tiles a warp
    const int n = a.JB * a.Kp * 32, lane = tid & 31;
    const int ut = (a.Kp + 31) >> 5;                  // unit tiles a k-block
    float* tile = reinterpret_cast<float*>(base) + (tid >> 5) * LW_TILE;
    for (int t = blockIdx.x * LW_WARPS + (tid >> 5); t < a.JB * ut;
         t += gridDim.x * LW_WARPS) {
      const int jb = t / ut, u0 = (t - jb * ut) * 32, u = u0 + lane;
      if constexpr (MODE == kBank) {  // unit u: expert u / ue's u % ue
        const int e = u / a.ue;
        const float* wu = a.w + (size_t)e * a.D * a.ue + (u - e * a.ue);
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int d = 32 * jb + k;
          tile[k * 33 + lane] =
              u < a.U && d < a.D ? __ldg(wu + (size_t)d * a.ue) : 0.f;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 32; ++k) {  // row d of W, units u0 .. u0 + 31
          const int d = 32 * jb + k;
          tile[k * 33 + lane] =
              u < a.U && d < a.D ? __ldg(a.w + (size_t)d * a.U + u) : 0.f;
        }
      }
      __syncwarp();
      const int rows = a.Kp - u0 < 32 ? a.Kp - u0 : 32;
      float* p = a.planes + (jb * a.Kp + u0) * 32 + lane;
      for (int i = 0; i < rows; ++i) {   // unit u0 + i, k = lane
        uint32_t hi, lo;
        split_tf32(tile[lane * 33 + i], hi, lo);
        p[32 * i] = __uint_as_float(hi);
        p[n + 32 * i] = __uint_as_float(lo);
      }
      __syncwarp();
    }
    // the planes are read by TMA, the tiles' memory written by it next
    asm volatile("fence.proxy.async.global;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  cooperative_groups::this_grid().sync();

  // the warpgroup, through a shuffle so that the compiler knows it is the
  // same across a warp (a wgmma on a path it cannot prove uniform is
  // serialized)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {                   // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 256) {
      asm volatile("fence.proxy.async.global;" ::: "memory");
      int slot = 0;
      uint32_t ph = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        const int nt = u % a.NT, tile = u / a.NT;
        for (int jb = 0; jb < a.JB; ++jb) {
          unsigned char* st = base + slot * STAGE;
          mbar_wait(empty + slot, ph ^ 1);
          mbar_expect(full + slot, STAGE);
          tma_load2(st, xmap, full + slot, 32 * jb, LW_ROWS * tile);
          tma_load4(st + LW_XSTAGE, wmap, full + slot, 0, nt * N, jb, 0);
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
  const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + g;   // its rows: r0, r0 + 8
  // A at (r0, t) (r0 + 8, t) (r0, t + 4) (r0 + 8, t + 4) of k-step i: in
  // SWIZZLE_128B the 16-byte chunk c of row r lies at chunk c ^ (r & 7),
  // and r0 & 7 == g; a warp's reads hit 32 distinct banks
  const int xa = r0 * 32 + t;
  float acc[R], tot[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  int slot = 0;
  uint32_t ph = 0;
  // The warpgroups run their chains in turns (barriers 5 and 6), so
  // that one's wait, A fragments and sums overlap the other's products.
  if (wg == 1) named_arrive(5, 256);
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const int nt = u % a.NT, tile = u / a.NT;
#pragma unroll
    for (int i = 0; i < R; ++i) tot[i] = 0.f;
    for (int jb = 0; jb < a.JB; ++jb) {
      mbar_wait(full + slot, ph);
      const float* xs = reinterpret_cast<const float*>(base + slot * STAGE);
      uint32_t ah[LW_KS][4], al[LW_KS][4];
#pragma unroll
      for (int i = 0; i < LW_KS; ++i) {
        const int c0 = ((2 * i) ^ g) * 4, c1 = ((2 * i + 1) ^ g) * 4;
        split_tf32(xs[xa + c0], ah[i][0], al[i][0]);
        split_tf32(xs[xa + 256 + c0], ah[i][1], al[i][1]);
        split_tf32(xs[xa + c1], ah[i][2], al[i][2]);
        split_tf32(xs[xa + 256 + c1], ah[i][3], al[i][3]);
      }
      const uint32_t hi = smem_u32(base + slot * STAGE + LW_XSTAGE);
      named_sync(5 + wg, 256);       // the other warpgroup's chain is queued
      fence_regs(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int i = 0; i < LW_KS; ++i) {
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

    // epilogue: d[4c + 2 half + e] at row r0 + 8 half, column
    // n0 + 8c + 2t + e
    const int m0 = tile * LW_ROWS + r0, n0 = nt * N;
    const bool pair_store = (a.U & 1) == 0;
    if constexpr (MODE == kCross) {
      // the chain's registers are free until the next unit's first
      // k-step, which overwrites them (scale_d 0)
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = 0.f;
      cross_epilogue<R>(a, tot, m0, n0, t, pair_store);
    } else if constexpr (MODE == kBank) {
      bank_epilogue<R>(a, tot, m0, n0, t);
    } else {
#pragma unroll
      for (int c = 0; c < R / 4; ++c) {
        const int col = n0 + 8 * c + 2 * t;
        const float b0 = a.bias && col < a.U ? __ldg(a.bias + col) : 0.f;
        const float b1 =
            a.bias && col + 1 < a.U ? __ldg(a.bias + col + 1) : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + 8 * half;
          float x = tot[4 * c + 2 * half] + b0;
          float y = tot[4 * c + 2 * half + 1] + b1;
          if (a.relu) {
            x = x < 0.f ? 0.f : x;
            y = y < 0.f ? 0.f : y;
          }
          if (m < a.M && col < a.U) {
            float* o = a.out + (size_t)m * a.U + col;
            if (pair_store) {
              *reinterpret_cast<float2*>(o) = make_float2(x, y);
            } else {
              o[0] = x;
              if (col + 1 < a.U) o[1] = y;
            }
          }
        }
      }
    }
  }
  if (wg == 0) named_sync(5, 256);   // warpgroup 1's last turn
}

template <int N, int MODE = kOutIn>
__global__ void __launch_bounds__(LW_THREADS, 1)
linear_wg_kernel(const LwArgs a, const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap) {
  lw_body<N, MODE>(a, &xmap, &wmap);
}

// (d) the expert banks on wgmma: a shared-input bank as one (M, D) x (D,
// N * ue) product on lw_body.  It carries (a)'s name as an overload, so
// that a device trace books both designs as the banks' one kernel.
template <int N>
__global__ void __launch_bounds__(LW_THREADS, 1)
multi_dense_tc(const LwArgs a, const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap) {
  lw_body<N, kBank>(a, &xmap, &wmap);
}

using LwKernel = void (*)(LwArgs, CUtensorMap, CUtensorMap);

template <int N, int MODE>
LwKernel lw_kernel() {
  if constexpr (MODE == kBank)
    return multi_dense_tc<N>;
  else
    return linear_wg_kernel<N, MODE>;
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <int BN, int WARPS_M, int MIN_BLOCKS = 2>
cudaError_t launch_tc(const float* x, long long x_stride_n, int nz,
                      const float* w, const float* bias, float* out, int B,
                      int D, int U, int ncols, int relu, int device,
                      cudaStream_t s) {
  constexpr int smem = tc_smem_bytes<BN>();
  static std::atomic<bool> done[kMaxDevices];
  CUDA_TRY(allow_smem((const void*)multi_dense_tc<BN, WARPS_M, MIN_BLOCKS>,
                      smem, device, done));
  const dim3 grid((ncols + BN - 1) / BN, (B + kBM - 1) / kBM, nz);
  const int vx = D % 4 == 0 && aligned(x, 16);
  const int vw = U % 4 == 0 && aligned(w, 16);
  const int vec2 = U % 2 == 0 && aligned(out, 8);
  multi_dense_tc<BN, WARPS_M, MIN_BLOCKS><<<grid, kThreads, smem, s>>>(
      x, x_stride_n, w, bias, out, B, D, U, ncols, relu, vx, vw, vec2);
  return cudaGetLastError();
}

template <int NUP>
cudaError_t launch_gate(const float* x, const float* w, const float* bias,
                        float* out, int N, int B, int D, int U, int relu,
                        int device, cudaStream_t s) {
  constexpr int R = 32 / NUP;
  const long long tasks = (B + R - 1) / R;
  const long long want = (tasks + kThreads / 32 - 1) / (kThreads / 32);
  const int sms = sm_count(device);
  const long long cap = 2LL * (sms > 0 ? sms : 1);  // W staged once a block
  const int blocks = (int)(want < cap ? want : cap);
  multi_dense_gate<NUP><<<blocks, kThreads, D * NUP * 4, s>>>(
      x, w, bias, out, B, D, U, N * U, relu);
  return cudaGetLastError();
}

// Blocks of lw_kernel<N, MODE> that can be resident at once (the
// cooperative launch's largest grid), 0 where the device cannot launch
// it cooperatively.
template <int N, int MODE>
int lw_resident(int device) {
  static std::atomic<int> slots[kMaxDevices];
  static std::atomic<bool> done[kMaxDevices];
  return coop_resident((const void*)lw_kernel<N, MODE>(), LW_THREADS,
                       device, slots, done);
}

// How lw_kernel<N, MODE> runs a (M, D) x (U, D)^T call at a pass width
// `width` (64, 128 or 200), or, where `width` is 0, at the one with the
// least nt * (N + 32); N == 0 where it cannot: D % 4 != 0, planes past
// 2^31 floats, or a device without the shared memory or the cooperative
// launch.
struct LwPlan {
  int N = 0;                          // units a pass: 64, 128 or 200
  int NT = 0, JB = 0, Kp = 0;         // passes; k-blocks; planes' rows
  int units = 0, grid = 0, stages = 0;
  size_t smem = 0;
  long long planes = 0;               // floats of scratch
};

constexpr int kWidths[3] = {64, 128, 200};

template <int MODE = kOutIn>
LwPlan lw_plan(int M, int D, int U, int device, int width = 0) {
  LwPlan p;
  if (M < 1 || D < 1 || U < 1 || D % 4) return p;
  int N = 0;
  long long nt = 0, cost = 0;
  for (const int n : kWidths) {
    const long long k = (U + n - 1) / n;
    if (width ? n == width : !N || k * (n + 32) < cost) {
      N = n;
      nt = k;
      cost = k * (n + 32);
    }
  }
  if (!N) return p;
  const long long JB = (D + 31) / 32, Kp = nt * N;
  const long long units = (M + LW_ROWS - 1LL) / LW_ROWS * nt;
  if (2 * JB * Kp * 32 >= (1LL << 31) || units >= (1LL << 31)) return p;
  const size_t cap = optin_smem(device);
  const size_t stage = LW_XSTAGE + (size_t)2 * N * 128;
  const size_t fixed = 1024 + 16 * LW_MAX_STAGES;   // alignment, mbarriers
  if (fixed + 2 * stage > cap) return p;
  const int resident = N == 64    ? lw_resident<64, MODE>(device)
                       : N == 128 ? lw_resident<128, MODE>(device)
                                  : lw_resident<200, MODE>(device);
  if (!resident) return p;
  p.N = N;
  p.NT = (int)nt;
  p.JB = (int)JB;
  p.Kp = (int)Kp;
  p.units = (int)units;
  p.grid = resident;    // every SM splits a share of W; units below it idle
  p.stages = (int)((cap - fixed) / stage);
  if (p.stages > LW_MAX_STAGES) p.stages = LW_MAX_STAGES;
  p.smem = fixed + p.stages * stage;
  p.planes = 2 * JB * Kp * 32;
  return p;
}

template <int N, int MODE>
int launch_lw(const LwPlan& p, const float* x, const float* w,
              const float* bias, float* out, int M, int D, int U, int relu,
              float* scratch, cudaStream_t s, const float* x0,
              const float* xl, int ue) {
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint32_t unit[2] = {1, 1};
  // x (M, D): a box is 128 rows of 32 floats; of the planes, N units of
  // one k-block
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)M};
  const cuuint64_t xstrides[1] = {(cuuint64_t)D * 4};
  const cuuint32_t xbox[2] = {32, LW_ROWS};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(x), xdims, xstrides, xbox, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode_planes(encode, &wmap, scratch, p.Kp, p.JB, N) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const LwArgs a{w, bias, out, scratch, M, D, U, relu, p.JB,
                 p.Kp, p.NT, p.units, p.stages, x0, xl, ue};
  return launch_cooperative(lw_kernel<N, MODE>(), p.grid, LW_THREADS,
                            p.smem, s, a, xmap, wmap);
}

// launch_lw at the plan's pass width; x0 and xl only for kCross, ue only
// for kBank
template <int MODE>
int run_lw(const LwPlan& p, const float* x, const float* w,
           const float* bias, float* out, int M, int D, int U, int relu,
           float* scratch, cudaStream_t s, const float* x0 = nullptr,
           const float* xl = nullptr, int ue = 0) {
  if (p.N == 64)
    return launch_lw<64, MODE>(p, x, w, bias, out, M, D, U, relu, scratch,
                               s, x0, xl, ue);
  if (p.N == 128)
    return launch_lw<128, MODE>(p, x, w, bias, out, M, D, U, relu, scratch,
                                s, x0, xl, ue);
  if (p.N == 200)
    return launch_lw<200, MODE>(p, x, w, bias, out, M, D, U, relu, scratch,
                                s, x0, xl, ue);
  return cudaErrorNotSupported;
}

// How multi_dense_tc<N> runs a shared-input bank, (M, D) x (N * U): at
// the widest pass of 200, 128 or 64 units that divides U, so that no pass
// straddles two experts and none is padded, else as lw_plan would choose
// (lw_plan's nt * (N + 32) picks 200 for the PLE cell's 2,048 units: 11
// passes, 704 units, 5.3 waves of 132; 128 gives 1,024 units, 7.8 waves)
LwPlan bank_plan(int M, int D, int N, int U, int device) {
  if ((long long)N * U >= (1LL << 31)) return LwPlan();
  int width = 0;
  for (const int n : kWidths)
    if (U % n == 0) width = n;
  return lw_plan<kBank>(M, D, N * U, device, width);
}

}  // namespace

extern "C" {

// The gate kernel's padded column count (4, 8 or 16) where it takes the
// call -- a shared input with N * U <= 16 whose W fits its 48 KB of shared
// memory -- else 0 (the split-TF32 tile).
int multi_dense_gate_columns(int nx, int N, int D, int U) {
  const long long nu = (long long)N * U;
  if (nx != 1 || nu > 16) return 0;
  const int nup = nu <= 4 ? 4 : nu <= 8 ? 8 : 16;
  return (long long)D * nup * 4 <= kGateMaxSmem ? nup : 0;
}

// Floats of scratch that multi_dense_f32 takes to run a shared-input
// (1, B, D) x (N, D, U) bank on wgmma (d): the split planes of W; 0 where
// the device cannot run it.
long long multi_dense_bank_scratch(int N, int B, int D, int U, int device) {
  if (N < 1 || device < 0 || device >= kMaxDevices ||
      use_device(device) != cudaSuccess)
    return 0;
  return bank_plan(B, D, N, U, device).planes;
}

// x (NX, B, D) with NX = 1 (shared) or N, w (N, D, U), bias (N, U) or
// null, out (N, B, U); all f32, contiguous.  relu = 1 fuses ReLU.  With
// scratch, 16-byte aligned and of multi_dense_bank_scratch(N, B, D, U)
// floats, a shared input whose rows TMA reads (D % 4 == 0, x 16-byte
// aligned) runs on wgmma (d); without, the gate kernel (b) takes a shared
// input with N * U <= 16 and the split-TF32 tile (a) every other call.
// Returns a cudaError_t, cudaErrorNotSupported where the device cannot
// run (d).
int multi_dense_f32(const float* x, int nx, const float* w, const float* bias,
                    float* out, int N, int B, int D, int U, int relu,
                    float* scratch, int device, void* stream) {
  if (N < 1 || B < 1 || D < 1 || U < 1 || (nx != 1 && nx != N) ||
      device < 0 || device >= kMaxDevices || (B + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  CUDA_TRY(use_device(device));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch) {
    if (nx != 1 || D % 4 || !aligned(x, 16) || !aligned(scratch, 16))
      return cudaErrorInvalidValue;
    const LwPlan p = bank_plan(B, D, N, U, device);
    if (!p.N) return cudaErrorNotSupported;
    return run_lw<kBank>(p, x, w, bias, out, B, D, N * U, relu, scratch, s,
                         nullptr, nullptr, U);
  }
  const int nup = multi_dense_gate_columns(nx, N, D, U);
  if (nup == 4)
    return launch_gate<4>(x, w, bias, out, N, B, D, U, relu, device, s);
  if (nup == 8)
    return launch_gate<8>(x, w, bias, out, N, B, D, U, relu, device, s);
  if (nup == 16)
    return launch_gate<16>(x, w, bias, out, N, B, D, U, relu, device, s);
  // a shared input is one (B, D) x (D, N * U) product; a per-expert input
  // N products of (B, D) x (D, U)
  const bool shared = nx == 1;
  const int ncols = shared ? N * U : U;
  const int nz = shared ? 1 : N;
  const long long stride = shared ? 0 : (long long)B * D;
  if (shared && U % 128 == 0 && ncols % 256 == 0)
    return launch_tc<256, 2, 1>(x, stride, nz, w, bias, out, B, D, U, ncols,
                                relu, device, s);
  if (U % 128 == 0)
    return launch_tc<128, 2>(x, stride, nz, w, bias, out, B, D, U, ncols,
                             relu, device, s);
  return launch_tc<64, 4>(x, stride, nz, w, bias, out, B, D, U, ncols, relu,
                          device, s);
}

// Floats of scratch that multi_dense_wg_f32 takes for a (B, D) x (U, D)^T
// call, 0 where linear_wg_kernel cannot run it on `device`.
long long multi_dense_wg_scratch(int B, int D, int U, int device) {
  if (device < 0 || device >= kMaxDevices || use_device(device) != cudaSuccess)
    return 0;
  return lw_plan(B, D, U, device).planes;
}

// out (B, U) = act(x (B, D) W^T + bias) on linear_wg_kernel: W (U, D) as
// nn.Linear stores it, bias (U) or null, relu = 1 fuses ReLU; x's rows on
// the 16-byte grid (D % 4 == 0, x 16-byte aligned); scratch holds
// multi_dense_wg_scratch(B, D, U) floats.  All f32, contiguous.  Returns a
// cudaError_t, cudaErrorNotSupported where the device cannot run it.
int multi_dense_wg_f32(const float* x, const float* w, const float* bias,
                       float* out, int B, int D, int U, int relu,
                       float* scratch, int device, void* stream) {
  if (B < 1 || D < 1 || U < 1 || D % 4 || !aligned(x, 16) || !scratch ||
      device < 0 || device >= kMaxDevices)
    return cudaErrorInvalidValue;
  CUDA_TRY(use_device(device));
  return run_lw<kOutIn>(lw_plan(B, D, U, device), x, w, bias, out, B, D, U,
                        relu, scratch, static_cast<cudaStream_t>(stream));
}

// Floats of scratch that cross_wg_f32 takes for x (B, D) at rank R besides
// u's B * R: the larger of its two products' weight planes; 0 where
// linear_wg_kernel cannot run both on `device`.
long long cross_wg_scratch(int B, int D, int R, int device) {
  if (device < 0 || device >= kMaxDevices || use_device(device) != cudaSuccess)
    return 0;
  const long long p1 = lw_plan<kInOut>(B, D, R, device).planes;
  const long long p2 = lw_plan<kCross>(B, R, D, device).planes;
  return p1 && p2 ? (p1 > p2 ? p1 : p2) : 0;
}

// One layer of DCN-V2's low-rank cross, out (B, D) = x0 * ((x V) W + bias)
// + x, as two launches of linear_wg_kernel on one stream: u = x V into the
// scratch past the planes, then u W with the cross epilogue.  x and x0
// (B, D) 16-byte aligned, v (D, R) and w (R, D) in their (in, out)
// storage, bias (D) or null, D % 4 == 0 and R % 4 == 0 (TMA reads x's and
// u's rows); scratch, 16-byte aligned, holds cross_wg_scratch(B, D, R) +
// B * R floats, its planes shared by the two launches in turn.  All f32,
// contiguous; out may be x (the epilogue reads each element of x before
// the same thread writes that element of out), and x0 only where x is.
// Returns a cudaError_t, cudaErrorNotSupported where the device cannot
// run it.
int cross_wg_f32(const float* x, const float* x0, const float* v,
                 const float* w, const float* bias, float* out, int B, int D,
                 int R, float* scratch, int device, void* stream) {
  if (B < 1 || D < 1 || R < 1 || D % 4 || R % 4 || !aligned(x, 16) ||
      !aligned(x0, 16) || !scratch || !aligned(scratch, 16) || device < 0 ||
      device >= kMaxDevices)
    return cudaErrorInvalidValue;
  CUDA_TRY(use_device(device));
  const LwPlan p1 = lw_plan<kInOut>(B, D, R, device);
  const LwPlan p2 = lw_plan<kCross>(B, R, D, device);
  if (!p1.N || !p2.N) return cudaErrorNotSupported;
  float* u = scratch + (p1.planes > p2.planes ? p1.planes : p2.planes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUDA_TRY(run_lw<kInOut>(p1, x, v, nullptr, u, B, D, R, 0, scratch, s));
  return run_lw<kCross>(p2, u, w, bias, out, B, R, D, 0, scratch, s, x0, x);
}

}  // extern "C"
