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
// call, one of two kernels chosen by shape:
//
// (a) multi_dense_tc, the expert banks (every call that (b) does not take).
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- (a) tensor-core tile ----
constexpr int kThreads = 256;          // 8 warps
constexpr int kBM = 128;               // rows of a block tile
constexpr int kBK = 32;                // depth of a staged chunk of D
constexpr int kStages = 3;             // cp.async ring depth
constexpr int kXS = kBK + 4;           // x row stride in shared memory
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b, the same with a zero accumulator
__device__ __forceinline__ void mma_tf32_new(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// copy 4 (16) bytes to shared memory, or zeros when !full
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
        split_tf32(wb[kk * WS + j * 8], bh[j][0], bl[j][0]);         // k = t
        split_tf32(wb[(kk + 4) * WS + j * 8], bh[j][1], bl[j][1]);   // t + 4
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* p = xa + i * 16 * kXS + kk;
        uint32_t ah[4], al[4];
        split_tf32(p[0], ah[0], al[0]);                 // row g, col t
        split_tf32(p[8 * kXS], ah[1], al[1]);           // row g + 8
        split_tf32(p[4], ah[2], al[2]);                 // col t + 4
        split_tf32(p[8 * kXS + 4], ah[3], al[3]);
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

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <int BN, int WARPS_M, int MIN_BLOCKS = 2>
cudaError_t launch_tc(const float* x, long long x_stride_n, int nz,
                      const float* w, const float* bias, float* out, int B,
                      int D, int U, int ncols, int relu, int device,
                      cudaStream_t s) {
  constexpr int smem = tc_smem_bytes<BN>();
  // above 48 KB: the kernel's dynamic shared memory limit, raised once
  // per device and process
  static bool raised[kMaxDevices] = {};
  if (!raised[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        multi_dense_tc<BN, WARPS_M, MIN_BLOCKS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    raised[device] = true;
  }
  const dim3 grid((ncols + BN - 1) / BN, (B + kBM - 1) / kBM, nz);
  const int vx = D % 4 == 0 && aligned(x, 16);
  const int vw = U % 4 == 0 && aligned(w, 16);
  const int vec2 = U % 2 == 0 && aligned(out, 8);
  multi_dense_tc<BN, WARPS_M, MIN_BLOCKS><<<grid, kThreads, smem, s>>>(
      x, x_stride_n, w, bias, out, B, D, U, ncols, relu, vx, vw, vec2);
  return cudaGetLastError();
}

int sm_count(int device) {
  static int count[kMaxDevices] = {};
  if (!count[device] &&
      cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    count[device] = 0;
  return count[device] > 0 ? count[device] : 1;
}

template <int NUP>
cudaError_t launch_gate(const float* x, const float* w, const float* bias,
                        float* out, int N, int B, int D, int U, int relu,
                        int device, cudaStream_t s) {
  constexpr int R = 32 / NUP;
  const long long tasks = (B + R - 1) / R;
  const long long want = (tasks + kThreads / 32 - 1) / (kThreads / 32);
  const long long cap = 2LL * sm_count(device);    // W staged once a block
  const int blocks = (int)(want < cap ? want : cap);
  multi_dense_gate<NUP><<<blocks, kThreads, D * NUP * 4, s>>>(
      x, w, bias, out, B, D, U, N * U, relu);
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

// The gate kernel's padded column count (4, 8 or 16) where it takes the
// call -- a shared input with N * U <= 16 whose W fits its 48 KB of shared
// memory -- else 0 (the split-TF32 tile).
int multi_dense_gate_columns(int nx, int N, int D, int U) {
  const long long nu = (long long)N * U;
  if (nx != 1 || nu > 16) return 0;
  const int nup = nu <= 4 ? 4 : nu <= 8 ? 8 : 16;
  return (long long)D * nup * 4 <= kGateMaxSmem ? nup : 0;
}

// x (NX, B, D) with NX = 1 (shared) or N, w (N, D, U), bias (N, U) or
// null, out (N, B, U); all f32, contiguous.  relu = 1 fuses ReLU.
// Returns a cudaError_t.
int multi_dense_f32(const float* x, int nx, const float* w, const float* bias,
                    float* out, int N, int B, int D, int U, int relu,
                    int device, void* stream) {
  if (N < 1 || B < 1 || D < 1 || U < 1 || (nx != 1 && nx != N) ||
      device < 0 || device >= kMaxDevices || (B + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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

}  // extern "C"
