// In-batch listwise softmax cross-entropy for Hopper (sm_90a), f32.
//
// Replaces _lw_fused_impl (rec_now_tpu/ops/pallas/listwise_kernel.py,
// pallas_call at :99).  Every sample i anchors the row of its group g_i
// (members j with g_j == g_i); the row is valid when i is the group's
// first occurrence and the group holds a label > th and a label < th.
// As the reference tests "> th" on the row's labels with the non-members'
// set to 0, a threshold below 0 counts a non-member as a label above it:
// every group of a batch that holds two groups has one then.
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
// group's: dx_j = valid(g_j) (exp(x_j - m_g) / s_g - lab_j / den_g), with
// m_g the group's max logit, s_g = sum exp(x - m_g) over its members, L_g
// their label sum and den_g = L_g (1 where L_g == 0, as the reference).
// The loss is per group: m_g + log s_g - sum lab x / den_g over the valid
// groups.  So the function is per group, and the kernel sorts by group.
//
// B <= kSortMax (every batch the port's cells take): lw_sort_kernel, one
// block, one launch.
//   1. group_sort.cuh's stable radix sort of (group, index) over the
//      batch's key range (no extra key bits): a segment's first position
//      is its group's first occurrence, the reference's anchor;
//   2. each thread holds 8 sorted positions, their x and labels read from
//      global memory by sorted index; two segmented scans over the block
//      (block_seg_scan, head flags from adjacent keys): the max logit,
//      then (sum exp(x - m_g), L_g, sum lab x, has-positive |
//      has-negative).  A segment's last position holds its totals; its
//      thread writes m_g, s_g and den_g (0: not valid) a segment into the
//      sort's freed shared memory and adds the group's loss term;
//   3. dx written back to the original index; the loss summed in double
//      and the count as an integer, each in a fixed order.
// Work: the sort's passes (1 to 8, by the range of the ids) and a few
// operations a sample; no serial loop over a segment, so the zipf head
// (2,082 members of a B = 8,192 batch) costs what any 2,082 samples do.
//
// Past kSortMax: lw_sweep_kernel, each thread owning one sample and
// sweeping the batch once for its group's statistics -- max and exp-sum
// (an online softmax), label sum, sum of lab * x, has-positive,
// has-negative and its first member -- the columns split over gridDim.y
// slices to fill the card; lw_finalize_kernel (one block) merges each
// sample's slices in a fixed order (the exp-sums rescaled to the common
// max), writes dx, and sums the first members' loss (in double) and the
// count.  B^2 group tests (67.1M at B = 8,192).
//
// Any B >= 1: no padding, no sentinel group; a batch without a valid
// group gives loss 0, count 0 and dx 0.  Repeats are bit-equal on both
// paths.
//
// What bounds it: operations (the sort's compares, a few a sample, or the
// sweep's B^2 tests); O(B) bytes.  In practice the sort's block-wide
// barriers, on one SM.
#include <cuda_runtime.h>

#include <math_constants.h>

#include "group_sort.cuh"
#include "runtime.cuh"

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
  const int other_above = 0.f > th ? 1 : 0;   // a non-member's 0 > th
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
      if (gs[i] != gt) {
        flags |= other_above;
        continue;
      }
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

// ---- B <= kSortMax: one block -------------------------------------------

// The segmented max of the logits.
struct MaxOp {
  __device__ static float op(float a, float b) { return fmaxf(a, b); }
  __device__ static float up(float a, int o) {
    return __shfl_up_sync(0xffffffffu, a, o);
  }
};

// A group's sums: of exp(x - m_g), of the labels, of label * logit, and
// bit 0 a label > th, bit 1 a label < th.
struct Sums {
  float s, l, lx;
  int flags;
};

struct SumOp {
  __device__ static Sums op(const Sums& a, const Sums& b) {
    return {a.s + b.s, a.l + b.l, a.lx + b.lx, a.flags | b.flags};
  }
  __device__ static Sums up(const Sums& a, int o) {
    return {__shfl_up_sync(0xffffffffu, a.s, o),
            __shfl_up_sync(0xffffffffu, a.l, o),
            __shfl_up_sync(0xffffffffu, a.lx, o),
            __shfl_up_sync(0xffffffffu, a.flags, o)};
  }
};

// out[0] = loss sum, out[1] = valid-group count, dx (B,); B <= kSortMax.
__global__ void __launch_bounds__(kSortThreads)
lw_sort_kernel(const float* __restrict__ x, const float* __restrict__ lab,
               const int* __restrict__ grp, int B, float th,
               float* __restrict__ dx, float* __restrict__ out) {
  extern __shared__ int sm[];
  unsigned* keys = reinterpret_cast<unsigned*>(sm);    // [spad(kSortMax)]
  int* vals = sm + spad(kSortMax);                      // [spad(kSortMax)]
  int* cnt = vals + spad(kSortMax);                     // [pad(kCounters)]
  __shared__ unsigned wsum[32], wlo[32], whi[32];
  __shared__ float wmax[32];
  __shared__ Sums wsums[32];
  __shared__ int wf[2][32];
  __shared__ double wloss[32];
  __shared__ int wcnt[32];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  // this thread's sorted positions and their segments; from here the
  // keys' and counters' space is free
  const Segments sg = sort_groups(grp, B, keys, vals, cnt, wsum, wlo, whi);
  const int p0 = t * kSortPer;
  float* seg_m = reinterpret_cast<float*>(keys);        // [segments]
  float* seg_s = reinterpret_cast<float*>(cnt);         // [segments]
  float* seg_den = seg_s + kSortMax;          // [segments], 0: invalid

  // the logits by sorted index (each scan holds only its own values in
  // registers: x and the labels are read again below)
  float m[kSortPer];
#pragma unroll
  for (int j = 0; j < kSortPer; ++j)
    m[j] = p0 + j < B ? x[vals[spad(p0 + j)]] : 0.f;
  block_seg_scan<MaxOp>(m, sg.heads, wmax, wf[0]);
#pragma unroll
  for (int j = 0; j < kSortPer; ++j)
    if (sg.lasts >> j & 1u) seg_m[sg.of(j)] = m[j];
  __syncthreads();

  // a non-member's 0 > th: the batch holds another group (its sorted
  // ends differ) and th < 0
  const int other_above =
      0.f > th && grp[vals[spad(0)]] != grp[vals[spad(B - 1)]] ? 1 : 0;
  Sums v[kSortPer];
#pragma unroll
  for (int j = 0; j < kSortPer; ++j) {
    v[j] = {0.f, 0.f, 0.f, 0};
    if (p0 + j < B) {
      const int i = vals[spad(p0 + j)];
      const float xi = x[i], li = lab[i];
      v[j] = {expf(xi - seg_m[sg.of(j)]), li, li * xi,
              (li > th ? 1 : 0) | (li < th ? 2 : 0) | other_above};
    }
  }
  block_seg_scan<SumOp>(v, sg.heads, wsums, wf[1]);
  double loss = 0.0;
  int count = 0;
#pragma unroll
  for (int j = 0; j < kSortPer; ++j) {
    if (!(sg.lasts >> j & 1u)) continue;
    const int g = sg.of(j);
    const bool valid = v[j].flags == 3;
    const float den = v[j].l == 0.f ? 1.f : v[j].l;   // as the reference
    seg_s[g] = v[j].s;
    seg_den[g] = valid ? den : 0.f;
    if (valid) {
      const float mg = seg_m[g];
      loss += (double)(mg + logf(v[j].s) - v[j].lx / den);
      ++count;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSortPer; ++j) {
    const int s = p0 + j;
    if (s >= B) continue;
    const int i = vals[spad(s)], g = sg.of(j);
    const float den = seg_den[g];
    dx[i] = den != 0.f ? expf(x[i] - seg_m[g]) / seg_s[g] - lab[i] / den
                       : 0.f;
  }
  // the loss and count over the block, in a fixed order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    loss += __shfl_down_sync(0xffffffffu, loss, o);
    count += __shfl_down_sync(0xffffffffu, count, o);
  }
  if (lane == 0) {
    wloss[w] = loss;
    wcnt[w] = count;
  }
  __syncthreads();
  if (t == 0) {
    double l = 0.0;
    int c = 0;
    for (int i = 0; i < kSortThreads / 32; ++i) {
      l += wloss[i];
      c += wcnt[i];
    }
    out[0] = (float)l;
    out[1] = (float)c;
  }
}

// The paths of listwise_f32: 0 the sort where B <= kSortMax, else the
// sweep; 1 the sort (B <= kSortMax only); 2 the sweep.
enum { kAuto = 0, kSort = 1, kSweep = 2 };

// Column slices of the sweep for a batch of B (>= 1).
int listwise_splits(int B) {
  const int s = (B + kTile - 1) / kTile;
  return s < kMaxSplits ? s : kMaxSplits;
}

bool takes_sort(int B, int path) {
  return path == kSort || (path == kAuto && B <= kSortMax);
}

}  // namespace

extern "C" {

// 4-byte words of scratch listwise_f32 needs for a batch of B (>= 1) on
// `path`: none on the sort.
long long listwise_scratch_words(int B, int path) {
  return takes_sort(B, path) ? 0 : 6LL * listwise_splits(B) * B;
}

// logits, labels (B,) f32, groups (B,) int32 -> out[0] loss sum, out[1]
// valid-row count, dx (B,); `path` as above; scratch holds
// listwise_scratch_words(B, path) words.  Returns a cudaError_t.
int listwise_f32(const float* logits, const float* labels, const int* groups,
                 int B, float th, int path, void* scratch, float* out,
                 float* dx, int device, void* stream) {
  if (B < 1 || path < kAuto || path > kSweep ||
      (path == kSort && B > kSortMax))
    return cudaErrorInvalidValue;
  CUDA_TRY(use_device(device));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (takes_sort(B, path)) {
    static std::atomic<bool> smem_set[kMaxDevices];
    CUDA_TRY(allow_smem((const void*)lw_sort_kernel, (int)sort_smem(), device,
                        smem_set));
    lw_sort_kernel<<<1, kSortThreads, sort_smem(), s>>>(
        logits, labels, groups, B, th, dx, out);
    return cudaGetLastError();
  }
  const int splits = listwise_splits(B);
  const int row_blocks = (B + kThreads - 1) / kThreads;
  const int cols_per = (B + splits - 1) / splits;
  lw_sweep_kernel<<<dim3(row_blocks, splits), kThreads, 0, s>>>(
      logits, labels, groups, B, th, cols_per, scratch, splits);
  CUDA_TRY(cudaGetLastError());
  lw_finalize_kernel<<<1, 1024, 0, s>>>(logits, labels, B, scratch, splits,
                                        dx, out);
  return cudaGetLastError();
}

}  // extern "C"
