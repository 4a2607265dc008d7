// In-batch pairwise BPR loss and its counting kernels for Hopper (sm_90a),
// f32.
//
// Replaces, from rec_now_tpu/ops/pallas/pairwise_kernel.py:
//   B3  _pair_loss_fused_impl     (pallas_call at :357)  pair_loss_f32
//   B7a pair_row_counts           (pallas_call at :170)  row_counts_f32
//   B7b same_group_matvec         (pallas_call at :190)  group_matvec_f32
//   B7c group_pair_counts_binary  (pallas_call at :227)  binary_counts_f32
// with every option of the JAX kernel path.  A pair (i, j) is valid when
// (pair_valid below, the one definition all four kernels use):
//   - every one of the NG group conditions holds: g_k[i] == g_k[j];
//   - i != j and label_i > label_j (any float labels);
//   - with a sample mask, mask > 0.5 on both sides (a 0/1 mask);
//   - with the wrong-order filter, x_i < x_j.
// Then:
//   B7a  out[i] = #{j : (i, j) valid}
//   B7b  out[i] = sum_k [g_i == g_k] vec[k]              (one group vector)
//   B7c  out[i] = pos(g_i) (tot(g_i) - pos(g_i))         (one group; binary
//        labels and a 0/1 mask: tot counts the group's unmasked members,
//        pos those with label > 0.5)
//   B3   loss   = sum_{valid (i,j)} w_i softplus(-(x_i - x_j) factor)
//        n_pair = number of valid pairs
//        dx_t   = sum_{j: (t,j) valid} -w_t factor sigmoid(-(x_t - x_j) f)
//               + sum_{i: (i,t) valid}  w_i factor sigmoid(-(x_i - x_t) f)
//        with w_i = row_w[i] (1 without row weights) times, when power != 0,
//        the occurrence weight B7c[i]^power (0 where B7c[i] == 0); the
//        in-kernel occurrence weight needs NG == 1 and no wrong-order filter,
//        as JAX's does (:298-300); the host checks.
//
// Taken from the math, not from the TPU blocks: the TPU sweeps (TILE, B) row
// blocks in VMEM and accumulates column sums over its sequential grid.
// Blocks here run in parallel, so no block reduces over another's rows: each
// thread OWNS one sample t and sweeps the columns u, staged through shared
// memory in tiles of kTile; for the loss it adds both t's row terms (t
// positive) and t's column terms (t negative), so a pair's terms are
// computed twice, once by each owner, and no dx needs a cross-block sum.  The
// columns are split over gridDim.y slices so that B = 8,192 fills the 132
// SMs (32 row blocks x 8 slices); every per-slice partial is merged by one
// finalize pass in a fixed slice order, so results do not depend on
// scheduling.  Counts are accumulated in integers (B7a, B7c, n_pair) and
// B7b's sums in double, then written as f32, as the JAX outputs are: with
// graded labels a group's pair count can pass 2^24.  Any B >= 1: no padding
// to a tile, no sentinel group.
//
// What bounds them: B^2 pair tests (67.1M at B = 8,192) of a few integer and
// float operations each, and for the loss transcendentals for the valid
// pairs only; O(B) bytes.  Operations.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;        // columns staged in shared memory
constexpr int kMaxSplits = 16;
constexpr int kMaxGroups = 4;      // AND-combined group conditions

__device__ __forceinline__ float softplus(float z) {
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
}

__device__ __forceinline__ float sigmoid(float z) {
  if (z >= 0.f) return 1.f / (1.f + expf(-z));
  const float e = expf(z);
  return e / (1.f + e);
}

// One sample as a pair's side sees it.
struct Side {
  int idx;
  float x, lab, m;
  int g[kMaxGroups];
};

// Columns of one tile, in shared memory.
struct Tile {
  float x[kTile], lab[kTile], m[kTile], w[kTile];
  int g[kMaxGroups][kTile];
};

__device__ __forceinline__ bool same_groups(const Side& a, const Tile& c,
                                            int i, int ng) {
#pragma unroll
  for (int k = 0; k < kMaxGroups; ++k)
    if (k < ng && a.g[k] != c.g[k][i]) return false;
  return true;
}

// The order, mask and wrong-order conditions of pair (a, b), a the
// positive side.
__device__ __forceinline__ bool ordered_valid(int ai, float ax, float al,
                                              float am, int bi, float bx,
                                              float bl, float bm,
                                              bool wrong_order) {
  return ai != bi && al > bl && am > 0.5f && bm > 0.5f &&
         (!wrong_order || ax < bx);
}

// Is (a, column u = c0 + i) a valid pair, a the positive side.
__device__ __forceinline__ bool pair_valid(const Side& a, const Tile& c,
                                           int i, int u, int ng,
                                           bool wrong_order) {
  return same_groups(a, c, i, ng) &&
         ordered_valid(a.idx, a.x, a.lab, a.m, u, c.x[i], c.lab[i], c.m[i],
                       wrong_order);
}

// Inputs as the kernels take them; x, lab, mask, w may be null (x and lab
// unused; mask all 1; w all 1).
struct Inputs {
  const float* x;
  const float* lab;
  const int* grp;      // (ng, B)
  int ng;
  const float* mask;
  const float* w;
  int B;
};

__device__ __forceinline__ Side load_side(const Inputs& in, int t) {
  Side s;
  const bool live = t < in.B;
  s.idx = t;
  s.x = live && in.x ? in.x[t] : 0.f;
  s.lab = live && in.lab ? in.lab[t] : 0.f;
  s.m = !live ? 0.f : in.mask ? in.mask[t] : 1.f;
#pragma unroll
  for (int k = 0; k < kMaxGroups; ++k)
    s.g[k] = live && k < in.ng ? in.grp[(size_t)k * in.B + t] : 0;
  return s;
}

// Stage columns [c0, min(c0 + kTile, c_end)) into shared memory.
__device__ __forceinline__ void stage(Tile& c, const Inputs& in, int c0,
                                      int c_end) {
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const int u = c0 + i;
    const bool ok = u < c_end;
    c.x[i] = ok && in.x ? in.x[u] : 0.f;
    c.lab[i] = ok && in.lab ? in.lab[u] : 0.f;
    c.m[i] = !ok ? 0.f : in.mask ? in.mask[u] : 1.f;
    c.w[i] = !ok ? 0.f : in.w ? in.w[u] : 1.f;
#pragma unroll
    for (int k = 0; k < kMaxGroups; ++k)
      if (k < in.ng) c.g[k][i] = ok ? in.grp[(size_t)k * in.B + u] : 0;
  }
}

// ---- the sweeps: partials of row t over the column slice blockIdx.y ------

// B7a: valid pairs anchored at t.
__global__ void __launch_bounds__(kThreads)
row_count_sweep(Inputs in, bool wrong_order, int cols_per,
                int* __restrict__ part) {
  __shared__ Tile c;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const Side a = load_side(in, t);
  const int c_begin = blockIdx.y * cols_per;
  const int c_end = min(in.B, c_begin + cols_per);
  int cnt = 0;
  for (int c0 = c_begin; c0 < c_end; c0 += kTile) {
    __syncthreads();
    stage(c, in, c0, c_end);
    __syncthreads();
    const int n = min(kTile, c_end - c0);
    for (int i = 0; i < n; ++i)
      cnt += pair_valid(a, c, i, c0 + i, in.ng, wrong_order);
  }
  if (t < in.B) part[(size_t)blockIdx.y * in.B + t] = cnt;
}

// B7b: sum of vec (passed as in.w) over t's group (in.grp, ng == 1).
__global__ void __launch_bounds__(kThreads)
matvec_sweep(Inputs in, int cols_per, double* __restrict__ part) {
  __shared__ Tile c;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const Side a = load_side(in, t);
  const int c_begin = blockIdx.y * cols_per;
  const int c_end = min(in.B, c_begin + cols_per);
  double sum = 0.0;
  for (int c0 = c_begin; c0 < c_end; c0 += kTile) {
    __syncthreads();
    stage(c, in, c0, c_end);
    __syncthreads();
    const int n = min(kTile, c_end - c0);
    for (int i = 0; i < n; ++i)
      if (same_groups(a, c, i, 1)) sum += (double)c.w[i];
  }
  if (t < in.B) part[(size_t)blockIdx.y * in.B + t] = sum;
}

// B7c and B3's occurrence weight: the unmasked members of t's group (tot)
// and those with label > 0.5 (pos), over the main group.
__global__ void __launch_bounds__(kThreads)
binary_count_sweep(Inputs in, int cols_per, int2* __restrict__ part) {
  __shared__ Tile c;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const Side a = load_side(in, t);
  const int c_begin = blockIdx.y * cols_per;
  const int c_end = min(in.B, c_begin + cols_per);
  int pos = 0, tot = 0;
  for (int c0 = c_begin; c0 < c_end; c0 += kTile) {
    __syncthreads();
    stage(c, in, c0, c_end);
    __syncthreads();
    const int n = min(kTile, c_end - c0);
    for (int i = 0; i < n; ++i) {
      if (!same_groups(a, c, i, 1) || !(c.m[i] > 0.5f)) continue;
      ++tot;
      pos += c.lab[i] > 0.5f;
    }
  }
  if (t < in.B) part[(size_t)blockIdx.y * in.B + t] = make_int2(pos, tot);
}

// B3: t's row and column terms.
__global__ void __launch_bounds__(kThreads)
pair_sweep(Inputs in, float factor, bool wrong_order, int cols_per,
           float* __restrict__ part_loss, int* __restrict__ part_cnt,
           float* __restrict__ part_dx) {
  __shared__ Tile c;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const Side a = load_side(in, t);
  const float wt = t < in.B ? (in.w ? in.w[t] : 1.f) : 0.f;
  const int c_begin = blockIdx.y * cols_per;
  const int c_end = min(in.B, c_begin + cols_per);
  float loss = 0.f, dx = 0.f;
  int cnt = 0;
  for (int c0 = c_begin; c0 < c_end; c0 += kTile) {
    __syncthreads();
    stage(c, in, c0, c_end);
    __syncthreads();
    if (t >= in.B) continue;
    const int n = min(kTile, c_end - c0);
    for (int i = 0; i < n; ++i) {
      if (!same_groups(a, c, i, in.ng)) continue;
      const int u = c0 + i;
      if (ordered_valid(t, a.x, a.lab, a.m, u, c.x[i], c.lab[i], c.m[i],
                        wrong_order)) {        // (t, u): t's row terms
        const float d = (a.x - c.x[i]) * factor;
        loss += wt * softplus(-d);
        dx -= wt * factor * sigmoid(-d);
        ++cnt;
      } else if (ordered_valid(u, c.x[i], c.lab[i], c.m[i], t, a.x, a.lab,
                               a.m, wrong_order)) {  // (u, t): column terms
        const float d = (c.x[i] - a.x) * factor;
        dx += c.w[i] * factor * sigmoid(-d);
      }
    }
  }
  if (t >= in.B) return;
  const size_t o = (size_t)blockIdx.y * in.B + t;
  part_loss[o] = loss;
  part_cnt[o] = cnt;
  part_dx[o] = dx;
}

// ---- the merges, one pass each, slices in order ---------------------------

enum Merge { kRowCounts, kMatvec, kBinaryCounts, kWeights };

// out[t] from the slices' partials.  kWeights: out[t] = row_w[t] (1 if
// null) * (gpc > 0 ? gpc^power : 0) with gpc = pos (tot - pos).
__global__ void __launch_bounds__(kThreads)
merge_rows(int mode, const void* __restrict__ part, int B, int splits,
           const float* __restrict__ row_w, float power,
           float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B) return;
  if (mode == kRowCounts) {
    long long n = 0;
    for (int s = 0; s < splits; ++s)
      n += static_cast<const int*>(part)[(size_t)s * B + t];
    out[t] = (float)n;
  } else if (mode == kMatvec) {
    double sum = 0.0;
    for (int s = 0; s < splits; ++s)
      sum += static_cast<const double*>(part)[(size_t)s * B + t];
    out[t] = (float)sum;
  } else {
    long long pos = 0, tot = 0;
    for (int s = 0; s < splits; ++s) {
      const int2 p = static_cast<const int2*>(part)[(size_t)s * B + t];
      pos += p.x;
      tot += p.y;
    }
    const float gpc = (float)(pos * (tot - pos));
    if (mode == kBinaryCounts) {
      out[t] = gpc;
    } else {
      const float w = row_w ? row_w[t] : 1.f;
      out[t] = gpc > 0.f ? w * powf(gpc, power) : 0.f;
    }
  }
}

// B3: dx[t] = sum_s part_dx[s][t]; out[0] = sum loss (in double),
// out[1] = n_pair (in 64-bit integers).
__global__ void __launch_bounds__(1024)
merge_loss(const float* __restrict__ part_loss,
           const int* __restrict__ part_cnt,
           const float* __restrict__ part_dx, int B, int splits,
           float* __restrict__ dx, float* __restrict__ out) {
  __shared__ double sl[1024];
  __shared__ long long sc[1024];
  double loss = 0.0;
  long long cnt = 0;
  for (int t = threadIdx.x; t < B; t += blockDim.x) {
    float d = 0.f;
    for (int s = 0; s < splits; ++s) {
      const size_t o = (size_t)s * B + t;
      d += part_dx[o];
      loss += part_loss[o];
      cnt += part_cnt[o];
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

int splits_for(int B) {
  const int s = (B + kTile - 1) / kTile;
  return s < kMaxSplits ? s : kMaxSplits;
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

struct Launch {
  dim3 sweep;
  int rows, splits, cols_per;
  cudaStream_t stream;
};

cudaError_t begin(int B, int ng, int device, void* stream, Launch* l) {
  if (B < 1 || ng < 1 || ng > kMaxGroups) return cudaErrorInvalidValue;
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  l->rows = (B + kThreads - 1) / kThreads;
  l->splits = splits_for(B);
  l->cols_per = (B + l->splits - 1) / l->splits;
  l->sweep = dim3(l->rows, l->splits);
  l->stream = static_cast<cudaStream_t>(stream);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Most group conditions a call may AND.
int pair_max_groups() { return kMaxGroups; }

// 4-byte words of scratch each entry point needs for a batch of B (>= 1),
// from an allocation aligned to 8 bytes:
// kind 0 pair_loss_f32, 1 row_counts_f32, 2 group_matvec_f32,
// 3 binary_counts_f32.
long long pair_scratch_words(int kind, int B) {
  const long long sb = (long long)splits_for(B) * B;
  switch (kind) {
    case 0: return 2 * sb + B + 3 * sb;  // (pos, tot), w, loss, dx, cnt
    case 1: return sb;
    case 2: return 2 * sb;               // doubles
    default: return 2 * sb;              // int2
  }
}

// B3.  logits, labels (B,) f32, groups (ng, B) int32; row_w and mask (B,)
// f32 or null; power != 0 needs ng == 1 and !wrong_order.  -> out[0] loss
// sum, out[1] pair count, dx (B,).  Returns a cudaError_t.
int pair_loss_f32(const float* logits, const float* labels,
                  const int* groups, int ng, const float* row_w,
                  const float* mask, int B, float factor, float power,
                  int wrong_order, void* scratch, float* out, float* dx,
                  int device, void* stream) {
  if (power != 0.f && (ng != 1 || wrong_order)) return cudaErrorInvalidValue;
  Launch l;
  cudaError_t e = begin(B, ng, device, stream, &l);
  if (e != cudaSuccess) return e;
  const size_t sb = (size_t)l.splits * B;
  int2* counts = static_cast<int2*>(scratch);       // 8-byte aligned first
  float* w = reinterpret_cast<float*>(counts + sb);
  float* part_loss = w + B;
  float* part_dx = part_loss + sb;
  int* part_cnt = reinterpret_cast<int*>(part_dx + sb);
  const float* weights = row_w;
  if (power != 0.f) {
    const Inputs occ{nullptr, labels, groups, 1, mask, nullptr, B};
    binary_count_sweep<<<l.sweep, kThreads, 0, l.stream>>>(occ, l.cols_per,
                                                           counts);
    merge_rows<<<l.rows, kThreads, 0, l.stream>>>(kWeights, counts, B,
                                                  l.splits, row_w, power, w);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    weights = w;
  }
  const Inputs in{logits, labels, groups, ng, mask, weights, B};
  pair_sweep<<<l.sweep, kThreads, 0, l.stream>>>(
      in, factor, wrong_order != 0, l.cols_per, part_loss, part_cnt,
      part_dx);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  merge_loss<<<1, 1024, 0, l.stream>>>(part_loss, part_cnt, part_dx, B,
                                        l.splits, dx, out);
  return cudaGetLastError();
}

// B7a.  logits (B,) f32 (read only with wrong_order), labels (B,) f32,
// groups (ng, B) int32, mask (B,) f32 or null -> out (B,) f32.
int row_counts_f32(const float* logits, const float* labels,
                   const int* groups, int ng, const float* mask, int B,
                   int wrong_order, void* scratch, float* out, int device,
                   void* stream) {
  Launch l;
  cudaError_t e = begin(B, ng, device, stream, &l);
  if (e != cudaSuccess) return e;
  const Inputs in{logits, labels, groups, ng, mask, nullptr, B};
  int* part = static_cast<int*>(scratch);
  row_count_sweep<<<l.sweep, kThreads, 0, l.stream>>>(in, wrong_order != 0,
                                                      l.cols_per, part);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  merge_rows<<<l.rows, kThreads, 0, l.stream>>>(kRowCounts, part, B,
                                                l.splits, nullptr, 0.f, out);
  return cudaGetLastError();
}

// B7b.  groups (B,) int32, vec (B,) f32 -> out (B,) f32.
int group_matvec_f32(const int* groups, const float* vec, int B,
                     void* scratch, float* out, int device, void* stream) {
  Launch l;
  cudaError_t e = begin(B, 1, device, stream, &l);
  if (e != cudaSuccess) return e;
  const Inputs in{nullptr, nullptr, groups, 1, nullptr, vec, B};
  double* part = static_cast<double*>(scratch);
  matvec_sweep<<<l.sweep, kThreads, 0, l.stream>>>(in, l.cols_per, part);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  merge_rows<<<l.rows, kThreads, 0, l.stream>>>(kMatvec, part, B, l.splits,
                                                nullptr, 0.f, out);
  return cudaGetLastError();
}

// B7c.  groups (B,) int32, labels (B,) f32, mask (B,) f32 or null -> out
// (B,) f32.
int binary_counts_f32(const int* groups, const float* labels,
                      const float* mask, int B, void* scratch, float* out,
                      int device, void* stream) {
  Launch l;
  cudaError_t e = begin(B, 1, device, stream, &l);
  if (e != cudaSuccess) return e;
  const Inputs in{nullptr, labels, groups, 1, mask, nullptr, B};
  int2* part = static_cast<int2*>(scratch);
  binary_count_sweep<<<l.sweep, kThreads, 0, l.stream>>>(in, l.cols_per,
                                                         part);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  merge_rows<<<l.rows, kThreads, 0, l.stream>>>(kBinaryCounts, part, B,
                                                l.splits, nullptr, 0.f, out);
  return cudaGetLastError();
}

}  // extern "C"
