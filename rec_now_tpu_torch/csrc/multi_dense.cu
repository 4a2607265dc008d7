// Batched multi-expert dense for Hopper (sm_90a), f32.
//
// Replaces multi_dense_pallas (rec_now_tpu/ops/pallas/multi_dense_kernel.py,
// pallas_call at :75): N same-shape Dense layers in one launch,
//     out[n, b, u] = act( sum_d x[n', b, d] * W[n, d, u] + bias[n, u] )
// with n' = n for a per-expert (N, B, D) input and n' = 0 for a shared
// (1, B, D) one, act = ReLU or none, fused into the epilogue.
//
// Taken from the math, not from the TPU blocks: the TPU broadcasts a
// shared input to (N, B, D) and pads B to its row tile (:62-73).  Here a
// shared input is read in place by every expert's blocks (the N reads
// hit L2), and any B, D and U is masked at its edge: no padding, no
// broadcast copy.  The product is an SGEMM-style tile: a block owns BM
// rows x BN units of one expert, stages x (transposed) and W in BK-deep
// shared-memory chunks, and each thread keeps a TM x TN tile of sums in
// registers.  BN follows U (the gate bank has U = 4, the expert banks
// 64 and 128), so a 4-wide output is not padded to 64.
//
// What bounds it: at config 4 (B = 8,192) the expert layer
// (1, B, 429) x (4, 429, 128) is 3.6 of the forward's 5.0 GFLOP, f32
// outside the tensor cores (67 TFLOP/s: ~0.075 ms for all six launches);
// the gate bank (U = 4) moves 14 MB of x for 56 MFLOP, bytes.  This first
// kernel uses the SIMT f32 pipes with 1 x 4 to 8 x 4 register tiles;
// tensor cores (TF32 wgmma) would change the numerics and are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 16;       // depth of a staged chunk of D

// TN must be a multiple of 4 (float4 reads of ws); BM + kPad keeps the
// rows of xs 16-byte aligned for BM a multiple of 4.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
multi_dense_kernel(const float* __restrict__ x, long long x_stride_n,
                   const float* __restrict__ w, const float* __restrict__ bias,
                   float* __restrict__ out, int B, int D, int U, int relu) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kPad = 4;     // keeps float4 alignment, spreads the banks
  __shared__ __align__(16) float xs[kBK][BM + kPad];
  __shared__ __align__(16) float ws[kBK][BN];

  const int n = blockIdx.z;
  const int b0 = blockIdx.x * BM;
  const int u0 = blockIdx.y * BN;
  const int tx = threadIdx.x % (BN / TN);   // unit group
  const int ty = threadIdx.x / (BN / TN);   // row group
  const float* xn = x + n * x_stride_n;
  const float* wn = w + (long long)n * D * U;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
    // x chunk: BM rows x kBK of D, neighbouring threads on neighbouring d
    for (int e = threadIdx.x; e < BM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int b = b0 + r, d = k0 + c;
      xs[c][r] = (b < B && d < D) ? xn[(long long)b * D + d] : 0.f;
    }
    // W chunk: kBK of D x BN units, neighbouring threads on neighbouring u
    for (int e = threadIdx.x; e < kBK * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int d = k0 + r, u = u0 + c;
      ws[r][c] = (d < D && u < U) ? wn[(long long)d * U + u] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[TM], bv[TN];
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(&xs[k][ty * TM + i]);
          a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[k][ty * TM + i];
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&ws[k][tx * TN + j]);
        bv[j] = v.x; bv[j + 1] = v.y; bv[j + 2] = v.z; bv[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* on = out + (long long)n * B * U;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int u = u0 + tx * TN + j;
    if (u >= U) continue;
    const float bj = bias ? bias[(long long)n * U + u] : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int b = b0 + ty * TM + i;
      if (b >= B) continue;
      float v = acc[i][j] + bj;
      if (relu) v = fmaxf(v, 0.f);
      on[(long long)b * U + u] = v;
    }
  }
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch(const float* x, long long x_stride_n, const float* w,
                   const float* bias, float* out, int N, int B, int D, int U,
                   int relu, cudaStream_t s) {
  const dim3 grid((B + BM - 1) / BM, (U + BN - 1) / BN, N);
  multi_dense_kernel<BM, BN, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, s>>>(
      x, x_stride_n, w, bias, out, B, D, U, relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (NX, B, D) with NX = 1 (shared) or N, w (N, D, U), bias (N, U) or
// null, out (N, B, U); all f32, contiguous.  relu = 1 fuses ReLU.
// Returns a cudaError_t.
int multi_dense_f32(const float* x, int nx, const float* w, const float* bias,
                    float* out, int N, int B, int D, int U, int relu,
                    int device, void* stream) {
  if (N < 1 || B < 1 || D < 1 || U < 1 || (nx != 1 && nx != N))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long stride = nx == 1 ? 0 : (long long)B * D;
  if (U <= 4)   // the gate bank: 128 threads of 1 row x 4 units
    return launch<128, 4, 1, 4>(x, stride, w, bias, out, N, B, D, U, relu, s);
  // the expert banks (any U > 4, masked at the edge): 256 threads of
  // 8 rows x 4 units, 64 units a block
  return launch<128, 64, 8, 4>(x, stride, w, bias, out, N, B, D, U, relu, s);
}

}  // extern "C"
