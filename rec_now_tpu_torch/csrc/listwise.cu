// In-batch listwise softmax cross-entropy for Hopper (sm_90a), f32.
//
// Replaces _lw_fused_impl (rec_now_tpu/ops/pallas/listwise_kernel.py,
// pallas_call at :99).  Every sample i anchors the row of its group g_i
// (members j with g_j == g_i); the row is valid when i is the group's
// first occurrence and the group holds a label > th and a label < th.
// With p_j = lab_j / sum_{members} lab and the softmax over the members'
// logits (non-members are masked at -1e9 in the reference and vanish),
// one launch gives
//     loss  = sum_{valid rows} ( logsumexp_{members} x - sum_j p_j x_j )
//     count = number of valid rows
//     dx_j  = sum_i valid_i (softmax_ij - p_ij)
// so the backward only scales dx.
//
// Taken from the math, not from the TPU blocks: the TPU sweeps (TILE, B)
// anchor blocks in VMEM and adds each block's column sums into dx over
// its sequential grid (:96).  Only a group's first member is a valid
// anchor, so sample j's gradient comes from exactly one row, its own
// group's: dx_j = valid(g_j) (exp(x_j - m_g) / s_g - lab_j / L_g).  So
// each thread OWNS one sample and sweeps the batch once for its group's
// statistics -- max and exp-sum (an online softmax), label sum, sum of
// lab * x, has-positive, has-negative and its first member -- and no
// block reduces another's columns.  The columns are split over
// gridDim.y slices to fill the card; lw_finalize_kernel (one block) merges
// each sample's slices in a fixed order (the exp-sums rescaled to the
// common max), writes dx, and sums the first members' loss (in double)
// and the count.  Any B: no padding, no sentinel group; a batch without
// a valid group gives loss 0, count 0 and dx 0.
//
// What bounds it: B^2 group tests (67.1M at B = 8,192) and, per member
// pair, an exp and a few adds; O(B) bytes.  Operations.
#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;        // columns staged in shared memory
constexpr int kMaxSplits = 16;

// Per (slice, sample) partials, each a (splits, B) plane of the scratch.
struct Partials {
  float* m;       // max member logit in the slice (-inf: no member)
  float* s;       // sum of exp(x - m) over the slice's members
  float* lsum;    // sum of member labels
  float* lx;      // sum of member label * logit
  int* first;     // first member's index in the slice (B: none)
  int* flags;     // bit 0: a label > th, bit 1: a label < th
};

__device__ __forceinline__ Partials partials(void* scratch, int splits,
                                             int B) {
  const size_t plane = (size_t)splits * B;
  float* f = static_cast<float*>(scratch);
  int* i = reinterpret_cast<int*>(f + 4 * plane);
  return {f, f + plane, f + 2 * plane, f + 3 * plane, i, i + plane};
}

__global__ void __launch_bounds__(kThreads)
lw_sweep_kernel(const float* __restrict__ x, const float* __restrict__ lab,
                const int* __restrict__ grp, int B, float th, int cols_per,
                void* scratch, int splits) {
  __shared__ float xs[kTile];
  __shared__ float ls[kTile];
  __shared__ int gs[kTile];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = t < B;
  const int gt = live ? grp[t] : 0;
  const int c_begin = blockIdx.y * cols_per;
  const int c_end = min(B, c_begin + cols_per);
  float m = -CUDART_INF_F, s = 0.f, lsum = 0.f, lx = 0.f;
  int first = B, flags = 0;
  for (int c0 = c_begin; c0 < c_end; c0 += kTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int u = c0 + i;
      const bool in = u < c_end;
      xs[i] = in ? x[u] : 0.f;
      ls[i] = in ? lab[u] : 0.f;
      gs[i] = in ? grp[u] : 0;
    }
    __syncthreads();
    if (!live) continue;
    const int n = min(kTile, c_end - c0);
    for (int i = 0; i < n; ++i) {
      if (gs[i] != gt) continue;
      const float xu = xs[i], lu = ls[i];
      if (xu > m) {                 // online softmax: rescale to the new max
        s = s * expf(m - xu) + 1.f;
        m = xu;
      } else {
        s += expf(xu - m);
      }
      lsum += lu;
      lx = fmaf(lu, xu, lx);
      flags |= (lu > th ? 1 : 0) | (lu < th ? 2 : 0);
      first = min(first, c0 + i);
    }
  }
  if (!live) return;
  const Partials p = partials(scratch, splits, B);
  const size_t o = (size_t)blockIdx.y * B + t;
  p.m[o] = m;
  p.s[o] = s;
  p.lsum[o] = lsum;
  p.lx[o] = lx;
  p.first[o] = first;
  p.flags[o] = flags;
}

// dx[t] from t's merged group statistics; out[0] = loss sum, out[1] =
// valid-row count.
__global__ void __launch_bounds__(1024)
lw_finalize_kernel(const float* __restrict__ x, const float* __restrict__ lab,
                   int B, void* scratch, int splits, float* __restrict__ dx,
                   float* __restrict__ out) {
  __shared__ double sl[1024];
  __shared__ int sc[1024];
  const Partials p = partials(scratch, splits, B);
  double loss = 0.0;
  int cnt = 0;
  for (int t = threadIdx.x; t < B; t += blockDim.x) {
    float m = -CUDART_INF_F, lsum = 0.f, lx = 0.f;
    int first = B, flags = 0;
    for (int k = 0; k < splits; ++k) {
      const size_t o = (size_t)k * B + t;
      m = fmaxf(m, p.m[o]);
      lsum += p.lsum[o];
      lx += p.lx[o];
      first = min(first, p.first[o]);
      flags |= p.flags[o];
    }
    float s = 0.f;
    for (int k = 0; k < splits; ++k) {
      const size_t o = (size_t)k * B + t;
      if (p.s[o] > 0.f) s += p.s[o] * expf(p.m[o] - m);
    }
    float d = 0.f;
    if (flags == 3) {               // the group has a positive and a negative
      const float den = lsum == 0.f ? 1.f : lsum;   // as the reference
      d = expf(x[t] - m) / s - lab[t] / den;
      if (first == t) {             // t anchors its group's row
        loss += (double)(m + logf(s) - lx / den);
        ++cnt;
      }
    }
    dx[t] = d;
  }
  sl[threadIdx.x] = loss;
  sc[threadIdx.x] = cnt;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half /= 2) {
    if ((int)threadIdx.x < half) {
      sl[threadIdx.x] += sl[threadIdx.x + half];
      sc[threadIdx.x] += sc[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = (float)sl[0];
    out[1] = (float)sc[0];
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Column slices of the sweep for a batch of B (>= 1).
int listwise_splits(int B) {
  const int s = (B + kTile - 1) / kTile;
  return s < kMaxSplits ? s : kMaxSplits;
}

// logits, labels (B,) f32, groups (B,) int32 -> out[0] loss sum, out[1]
// valid-row count, dx (B,).  scratch holds 6 * splits * B 4-byte words,
// splits = listwise_splits(B).  Returns a cudaError_t.
int listwise_f32(const float* logits, const float* labels, const int* groups,
                 int B, float th, void* scratch, float* out, float* dx,
                 int device, void* stream) {
  if (B < 1) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = listwise_splits(B);
  const int row_blocks = (B + kThreads - 1) / kThreads;
  const int cols_per = (B + splits - 1) / splits;
  lw_sweep_kernel<<<dim3(row_blocks, splits), kThreads, 0, s>>>(
      logits, labels, groups, B, th, cols_per, scratch, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  lw_finalize_kernel<<<1, 1024, 0, s>>>(logits, labels, B, scratch, splits,
                                        dx, out);
  return cudaGetLastError();
}

}  // extern "C"
