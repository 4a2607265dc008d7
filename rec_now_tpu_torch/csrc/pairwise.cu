// In-batch pairwise BPR loss and its counting kernels for Hopper (sm_90a),
// f32.
//
// Replaces, from rec_now_tpu/ops/pallas/pairwise_kernel.py:
//   B3  _pair_loss_fused_impl     (pallas_call at :357)  pair_loss_f32
//   B7a pair_row_counts           (pallas_call at :170)  row_counts_f32
//   B7b same_group_matvec         (pallas_call at :190)  group_matvec_f32,
//                                 and folded into pair_loss_general_f32
//   B7c group_pair_counts_binary  (pallas_call at :227)  binary_counts_f32
// with every option of the JAX kernel path.  pair_loss_general_f32 is the
// general occurrence-weighted loss of pairwise_loss_pallas (:451-461):
// B7a's counts, B7b's sums over the main group, the weights and B3 in one
// call.  A pair (i, j) is valid when
// (pair_valid below, the one definition B3 and B7a use):
//   - every one of the NG group conditions holds: g_k[i] == g_k[j];
//   - i != j and label_i > label_j (any float labels);
//   - with a sample mask, mask > 0.5 on both sides (a 0/1 mask);
//   - with the wrong-order filter, x_i < x_j.
// Then:
//   B7a  out[i] = #{j : (i, j) valid}
//   B7b  out[i] = sum_k [g_i == g_k] vec[k]              (one group vector)
//   B7c  out[i] = pos(g_i) (tot(g_i) - pos(g_i))         (one group), the
//        sums the TPU kernel takes (:220-225): pos = sum of mask * label and
//        tot = sum of mask (the member count without a mask) over the
//        group; on binary labels and a 0/1 mask, the group's pair count
//   B3   loss   = sum_{valid (i,j)} w_i softplus(-(x_i - x_j) factor)
//        n_pair = number of valid pairs
//        dx_t   = sum_{j: (t,j) valid} -w_t factor sigmoid(-(x_t - x_j) f)
//               + sum_{i: (i,t) valid}  w_i factor sigmoid(-(x_i - x_t) f)
//        with w_i = row_w[i] (1 without row weights) times, when power != 0,
//        the occurrence weight gpc_i^power (0 where gpc_i == 0), gpc_i =
//        pos (tot - pos) counted over members with mask > 0.5 (tot) and
//        label > 0.5 (pos): B7c where the labels are binary and the mask
//        0/1; the in-kernel occurrence weight needs NG == 1 and no
//        wrong-order filter, as JAX's does (:298-300); the host checks.
//
// At B <= 8,192 (every batch the port's cells take) B3, B7a and the
// general loss sort the batch by its first group condition and sweep
// inside each group only, and B7c sorts and sums each group in one block
// (see "By segments" below); past that, the O(B^2) sweeps here.  B7b sums
// each group through a hash of its ids at any B (see "B7b" below), alone
// and inside the general loss past kSortMax.
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
// scheduling.  Counts are accumulated in integers (B7a, n_pair, B3's
// occurrence weight, the general loss's group totals) and B7b's and B7c's
// sums in double, then written as f32, as the JAX outputs are: with graded
// labels a group's pair count can pass 2^24.  Any B >= 1: no padding to a
// tile, no sentinel group.
//
// What bounds them: B^2 pair tests (67.1M at B = 8,192) of a few integer and
// float operations each, and for the loss transcendentals for the valid
// pairs only; O(B) bytes.  Operations.
#include <cuda_runtime.h>

#include <atomic>

#include "group_sort.cuh"

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

// B3's occurrence weight: the unmasked members of t's group (tot) and those
// with label > 0.5 (pos), over the main group.
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

// B7c: sum of mask * label (pos) and of mask (tot) over t's group, in
// double.
__global__ void __launch_bounds__(kThreads)
binary_sum_sweep(Inputs in, int cols_per, double2* __restrict__ part) {
  __shared__ Tile c;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const Side a = load_side(in, t);
  const int c_begin = blockIdx.y * cols_per;
  const int c_end = min(in.B, c_begin + cols_per);
  double pos = 0.0, tot = 0.0;
  for (int c0 = c_begin; c0 < c_end; c0 += kTile) {
    __syncthreads();
    stage(c, in, c0, c_end);
    __syncthreads();
    const int n = min(kTile, c_end - c0);
    for (int i = 0; i < n; ++i) {
      if (!same_groups(a, c, i, 1)) continue;
      pos += (double)(c.m[i] * c.lab[i]);
      tot += (double)c.m[i];
    }
  }
  if (t < in.B) part[(size_t)blockIdx.y * in.B + t] = make_double2(pos, tot);
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

enum Merge { kRowCounts, kBinarySums, kWeights };

// out[t] from the slices' partials.  kBinarySums: out[t] = pos (tot - pos)
// in double; kWeights: out[t] = row_w[t] (1 if null) * (gpc > 0 ? gpc^power
// : 0) with gpc = pos (tot - pos).
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
  } else if (mode == kBinarySums) {
    double pos = 0.0, tot = 0.0;
    for (int s = 0; s < splits; ++s) {
      const double2 p = static_cast<const double2*>(part)[(size_t)s * B + t];
      pos += p.x;
      tot += p.y;
    }
    out[t] = (float)(pos * (tot - pos));
  } else {
    long long pos = 0, tot = 0;
    for (int s = 0; s < splits; ++s) {
      const int2 p = static_cast<const int2*>(part)[(size_t)s * B + t];
      pos += p.x;
      tot += p.y;
    }
    const float gpc = (float)(pos * (tot - pos));
    const float w = row_w ? row_w[t] : 1.f;
    out[t] = gpc > 0.f ? w * powf(gpc, power) : 0.f;
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

// ---- By segments: a sort by the main group, then work inside each group
// ---------------------------------------------------------------------------
//
// A pair can only be valid inside one group of the first condition, so for
// B <= kSortMax the loss takes three launches and no (i, j) sweep:
//   1. sort_segments_kernel (one block, all in shared memory): the stable
//      LSD radix sort of group_sort.cuh on (g0[i], label_i > 0.5, i) --
//      the key's sign bit flipped so that negative ids order first, less
//      its minimum, the label test as its lowest bit (the sort's one extra
//      bit), 4 bits a pass and only as many as the batch's range needs (1
//      for one group, 4 for 5,000 ids; ids spread past 2^31 give the label
//      test a pass of its own, 9 in all);
//      ties keep index order, and within a group the negatives come
//      first, so that a warp of the sweep mostly takes one branch.  Each
//      sample's mask and label tests travel with its index, so one scan
//      of adjacent-difference flags finds the segments and, beside them,
//      each segment's tot (unmasked members) and pos (those with label >
//      0.5): the occurrence weight needs no sweep and is taken once a
//      segment.  The block writes the order (index and segment), the
//      segments' starts and weights, and the sweep's items: each kRows
//      sorted rows times the columns their segments span, in slices of
//      kCols.  It leaves the samples' values where they are: one block's
//      stores to L2 bounded it when it wrote them in sorted order;
//   2. segment_sweep: a fixed grid takes the items in turn; each thread
//      owns one sorted row t and tests only the columns of its own segment
//      in the item's slice, staged through shared memory, as pair_sweep
//      does (row terms when t is the positive side, column terms when it
//      is the negative); conditions 2..NG, the mask, the labels and the
//      wrong-order filter per pair.  A large group's columns are split
//      over many items (the zipf head of a B = 8,192 batch, 2,082 members,
//      over hundreds), so it does not serialise a few SMs;
//   3. merge_segments (a block a row block): each row's item partials in
//      slice order, dx written back to the original index, the loss in
//      double and the count in 64-bit integers summed in a fixed order per
//      block, and the blocks' sums in block order by the last block to
//      finish: repeats are bit-equal, whichever block took which item.
//      (Merging in the sweep, by the block that finished a row block's
//      last item, was slower: a fence a thread for every item.)
// Work: the sort's passes over B keys and sum over groups of n^2 tests
// (5.6M on a B = 8,192 SyntheticCriteo batch where the sweeps tested 67.1M
// twice); one group of all B does the B^2 tests, all singletons B.
//
// B7a takes the same two first launches, the sweep counting only t's row
// side (segment_sweep<true>: no transcendental, no column term), and needs
// no third: the sort zeroes out and each thread adds its item's count to
// out[its index] with one f32 atomic where the count is not 0.  Every
// partial sum is an integer below 2^24 (a row has fewer than B pairs), so
// each add is exact and the result does not depend on their order: repeats
// are bit-equal.
//
// B7c is one launch of one block (binary_sort_kernel): group_sort.cuh's
// sort of (g0[i], i), segment heads from adjacent keys, one segmented scan
// of (mask * label, mask) in double, each group's pos (tot - pos) taken at
// its segment's last position and written to every member's index.  Sums of
// 0/1 values in double are exact integers, so on binary labels and a 0/1
// mask it is bit-equal to the integer counts of the sweep it replaced.
//
// The general loss (pair_loss_general_f32), where JAX runs B7a, B7b, the
// weights and B3 (pairwise_kernel.py:451-461), takes B3's launches with
// B7a's count sweep between the sort and B3's sweep: four launches on one
// sort by the main group.  B7b sums B7a's counts over the main group, and
// the main group's segments are the sort's, so the count sweep also adds
// each row's count into its segment's total (segcnt, zeroed by the sort):
// the lanes of a warp that share a segment (adjacent sorted rows) sum
// theirs first with shuffles, then one integer atomicAdd a segment and
// warp.  A total is at most B (B - 1) / 2 < 2^26, exact in any order, and
// rounded to f32 once, as B7b's double sums are.  B3's sweep then takes
// each sample's weight from its segment's total, gpc > 0 ? gpc^power : 0,
// where it reads the sample (sample_at): no (B,) weight vector, no fifth
// launch.
//
// Past kSortMax, the O(B^2) sweeps above run instead; the general loss
// composes B7a's sweep, B7b's hash (its read taking the weights) and B3's
// sweep.
//
// B7b (group_matvec_f32) is a hash: an open-addressing table of 2^bits
// >= 2B slots over the whole grid, zeroed by one memset; hash_insert_kernel
// claims each id's slot with atomicCAS (linear probing; id 0, the empty
// key, has a slot of its own past the table) and adds vec in double with
// atomicAdd; hash_read_kernel writes each row its slot's sum.  Work: B slot
// claims and adds where an O(B^2) sweep tests B^2 pairs; a zipf head's
// adds (2,082 members at B = 8,192) meet in one slot.  Doubles added in no
// fixed order: exact, so bit-equal on repeats, for integer vec (counts,
// B7b's one caller's input in JAX and the general loss's), within an ulp
// of the f32 result otherwise.  On the device at B = 8,192 it took 0.0081
// ms against the O(B^2) sweep's 0.0241 and a one-block sort's 0.0279
// (PERF.md section 6, row 7); both were dropped.
//
// The sort's flags, beside the index in a value: the mask test, mask and
// label tests, the label test alone (the sort's extra key bit), then the
// segment
constexpr int kMaskBit = 1 << 13, kPosBit = 1 << 14, kLabBit = 1 << 15;
constexpr int kSegShift = 16;
constexpr int kRows = 256;    // sorted rows an item (the sweep's threads)
constexpr int kCols = 32;     // columns an item

// The sort's extra key bit: the label test.
struct LabelBit {
  __device__ unsigned operator()(int v) const {
    return v & kLabBit ? 1u : 0u;
  }
};

// The sort's result, for the sweep and the merge: what one block writes
// is kept small (its stores to L2 bound it), and the sweep's many blocks
// gather each sample's values themselves.
struct Sorted {
  int* order;          // sorted position s: index | segment << kSegShift
  int* start;          // segment id's first position (nseg + 1, B last)
  float* segw;         // its occurrence weight, -1 without pairs
  int* items;          // row block rb's items start at items[rb] (33)
  double* loss;        // the merge's per-block sums (32 each) and the
  long long* cnt;      // count of blocks done
  unsigned* done;
  float* counts;       // B7a's output, zeroed by the sort (null for B3)
  int* segcnt;         // the general loss's valid pairs a segment, zeroed
                       // by the sort, summed by the count sweep (null for
  float power;         // B3 and B7a), and their weight's power
};

// One sample's values as the sweep takes them: sorted position s.
struct Sample {
  int idx, seg, lo, hi;   // its index, its segment id and [lo, hi)
  float x, lab, m, w;
};

// The occurrence weight of a segment whose valid pairs the general loss
// counted (-1: none), gpc rounded to f32 once.
__device__ __forceinline__ float general_weight(int gpc, float power) {
  return gpc > 0 ? powf((float)gpc, power) : -1.f;
}

__device__ __forceinline__ Sample sample_at(const Inputs& in,
                                            const Sorted& so, bool occ,
                                            int s) {
  const int v = so.order[s];
  const int i = v & ((1 << kSegShift) - 1), id = v >> kSegShift;
  Sample a;
  a.idx = i;
  a.seg = id;
  a.lo = so.start[id];
  a.hi = so.start[id + 1];
  a.x = in.x[i];
  a.lab = in.lab[i];
  a.m = in.mask ? in.mask[i] : 1.f;
  a.w = in.w ? in.w[i] : 1.f;
  if (occ) {
    const float sw = so.segcnt ? general_weight(so.segcnt[id], so.power)
                               : so.segw[id];
    a.w = sw < 0.f ? 0.f : a.w * sw;
  }
  return a;
}

// Adds each lane's n to segcnt[seg] (seg -1: none).  A warp's rows are
// sorted, so the lanes of one segment are adjacent: each lane sums those
// from it to its segment's end (shuffles down, step o adding lane + o's
// sum where it is of the same segment), and the segment's first lane adds
// the total with one atomic.  Every lane of the warp calls it.
__device__ __forceinline__ void add_to_segments(int* segcnt, int seg,
                                                int n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_down_sync(0xffffffffu, n, o);
    const int s = __shfl_down_sync(0xffffffffu, seg, o);
    if (lane + o < 32 && s == seg) n += v;
  }
  const int prev = __shfl_up_sync(0xffffffffu, seg, 1);
  if (seg >= 0 && n && (lane == 0 || prev != seg)) atomicAdd(segcnt + seg, n);
}

// Steps 1 (see above): thread t holds sorted positions [t kSortPer,
// (t + 1) kSortPer) in each pass and in the segment scan.
__global__ void __launch_bounds__(kSortThreads)
sort_segments_kernel(Inputs in, float power, Sorted so) {
  extern __shared__ int sm[];
  unsigned* keys = reinterpret_cast<unsigned*>(sm);    // [spad(kSortMax)]
  int* vals = sm + spad(kSortMax);                      // [spad(kSortMax)]
  int* cnt = vals + spad(kSortMax);                     // [pad(kCounters)]
  __shared__ unsigned wsum[32];
  __shared__ unsigned long long wsum64[32];
  __shared__ unsigned wlo[32], whi[32];
  const int B = in.B, t = threadIdx.x;
  const float* __restrict__ lab = in.lab;
  const float* __restrict__ mask = in.mask;
  const int* __restrict__ g0 = in.grp;
  unsigned lo = 0xffffffffu, hi = 0u;
#pragma unroll 4
  for (int i = t; i < B; i += kSortThreads) {
    const unsigned k = static_cast<unsigned>(g0[i]) ^ 0x80000000u;
    const bool mok = mask ? mask[i] > 0.5f : true, pos = lab[i] > 0.5f;
    keys[spad(i)] = k;
    vals[spad(i)] = i | (mok ? kMaskBit : 0) | (mok && pos ? kPosBit : 0) |
                    (pos ? kLabBit : 0);
    lo = min(lo, k);
    hi = max(hi, k);
  }
  if (t == 0) *so.done = 0u;
  if (so.counts)
    for (int i = t; i < B; i += kSortThreads) so.counts[i] = 0.f;
  if (so.segcnt)
    for (int i = t; i < B; i += kSortThreads) so.segcnt[i] = 0;
  block_min_max(lo, hi, wlo, whi);
  // the label test as the key's lowest bit where the range leaves one;
  // either way within a group the negatives come before the positives, so
  // that a warp of the sweep mostly takes one branch
  const int shift = sort_by_group<1>(keys, vals, cnt, wsum, B, lo, hi,
                                     LabelBit());
  const int p0 = t * kSortPer;

  // segments: starts, and the unmasked members and positives before each
  // position, packed 20 bits each (B <= 2^13) into one scan
  int* start = cnt;                       // [B + 1], then tot before it
  int* ntot = cnt + kSortMax + 1;         // [B + 1]
  int* npos = reinterpret_cast<int*>(keys);   // [B + 1], once keys are read
  unsigned long long mine = 0;
  int bits[kSortPer];
#pragma unroll
  for (int j = 0; j < kSortPer; ++j) {
    const int s = p0 + j;
    bits[j] = 0;
    if (s < B) {
      const int v = vals[spad(s)];
      const int st = segment_head(keys, s, shift);
      bits[j] = st | (v & kMaskBit ? 2 : 0) | (v & kPosBit ? 4 : 0);
      mine += (unsigned long long)(bits[j] & 1) |
              (unsigned long long)(bits[j] >> 1 & 1) << 20 |
              (unsigned long long)(bits[j] >> 2 & 1) << 40;
    }
  }
  unsigned long long total;
  unsigned long long before = block_excl_scan(mine, wsum64, total);
  // (the scan's barriers: every key has been read)
  constexpr unsigned long long kField = (1ull << 20) - 1;
#pragma unroll
  for (int j = 0; j < kSortPer; ++j) {
    const int s = p0 + j;
    if (s < B) {
      const int id = (int)(before & kField) + (bits[j] & 1) - 1;
      vals[spad(s)] |= id << kSegShift;
      if (bits[j] & 1) {
        start[id] = s;
        ntot[id] = (int)(before >> 20 & kField);
        npos[id] = (int)(before >> 40 & kField);
      }
      before += (unsigned long long)(bits[j] & 1) |
                (unsigned long long)(bits[j] >> 1 & 1) << 20 |
                (unsigned long long)(bits[j] >> 2 & 1) << 40;
    }
  }
  if (t == 0) {
    const int nseg = (int)(total & kField);
    start[nseg] = B;
    ntot[nseg] = (int)(total >> 20 & kField);
    npos[nseg] = (int)(total >> 40 & kField);
  }
  __syncthreads();                   // the segments' table is whole
  // each segment's occurrence weight, pos (tot - pos) to the power, once,
  // over ntot's space (-1: no pairs)
  float* segw = reinterpret_cast<float*>(ntot);
  if (power != 0.f) {
    const int nseg = (int)(total & kField);
    float wv[kSortPer];
#pragma unroll
    for (int j = 0; j < kSortPer; ++j) {
      const int id = t + j * kSortThreads;
      wv[j] = -1.f;
      if (id < nseg) {
        const long long tot = ntot[id + 1] - ntot[id];
        const long long pos = npos[id + 1] - npos[id];
        const float gpc = (float)(pos * (tot - pos));
        if (gpc > 0.f) wv[j] = powf(gpc, power);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSortPer; ++j)
      if (t + j * kSortThreads < nseg) segw[t + j * kSortThreads] = wv[j];
    __syncthreads();
  }

  // the order (index and segment), the segments' starts and weights
  const int nseg = (int)(total & kField);
#pragma unroll 4
  for (int s = t; s < B; s += kSortThreads)
    so.order[s] = vals[spad(s)] & ~(kMaskBit | kPosBit | kLabBit);
  for (int id = t; id <= nseg; id += kSortThreads) so.start[id] = start[id];
  if (power != 0.f)
    for (int id = t; id < nseg; id += kSortThreads) so.segw[id] = segw[id];
  // row block rb's columns [lo of its first row, hi of its last) in
  // slices of kCols, from the table in shared memory
  const int nrb = (B + kRows - 1) / kRows;   // <= 32: one warp
  if (t < 32) {
    int n = 0;
    if (t < nrb) {
      const int r0 = t * kRows, r1 = min(B, r0 + kRows) - 1;
      // the segments of r0 and r1: the last start at or before each
      int a = 0, b = 0;
      for (int step = kSortMax; step > 0; step >>= 1) {
        if (a + step <= (int)(total & kField) && start[a + step] <= r0)
          a += step;
        if (b + step <= (int)(total & kField) && start[b + step] <= r1)
          b += step;
      }
      n = (start[b + 1] - start[a] + kCols - 1) / kCols;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, n, o);
      if (t >= o) n += v;
    }
    if (t == 0) so.items[0] = 0;
    if (t < nrb) so.items[t + 1] = n;
  }
}

// The row block holding `item`, given the row blocks' item starts.
__device__ __forceinline__ int row_block_of(const int* items, int item) {
  int rb = 0;
  while (items[rb + 1] <= item) ++rb;
  return rb;
}

// Step 2: each item's rows' row and column terms over its slice; kCount
// (B7a): the rows' valid pairs only, added into so.counts and, for the
// general loss, into so.segcnt (either may be null).
template <bool kCount>
__global__ void __launch_bounds__(kRows)
segment_sweep(Inputs in, Sorted so, bool occ, float factor,
              bool wrong_order, float* __restrict__ part_loss,
              int* __restrict__ part_cnt, float* __restrict__ part_dx) {
  const int B = in.B, ng = in.ng;
  __shared__ float cx[kCols], cl[kCols], cm[kCols], cw[kCols];
  __shared__ int cg[kMaxGroups - 1][kCols];
  const int nrb = (B + kRows - 1) / kRows;
  const int n_items = so.items[nrb];
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int rb = row_block_of(so.items, item);
    const int r0 = rb * kRows, r1 = min(B, r0 + kRows);
    const int seg0 = so.order[r0] >> kSegShift;
    const int seg1 = so.order[r1 - 1] >> kSegShift;
    const int c0 = so.start[seg0] + (item - so.items[rb]) * kCols;
    const int c1 = min(so.start[seg1 + 1], c0 + kCols);
    __syncthreads();                 // the last item's columns are read
    if (threadIdx.x < kCols && c0 + (int)threadIdx.x < c1) {
      const Sample c = sample_at(in, so, occ, c0 + threadIdx.x);
      cx[threadIdx.x] = c.x;
      cl[threadIdx.x] = c.lab;
      cm[threadIdx.x] = c.m;
      cw[threadIdx.x] = c.w;
      for (int k = 1; k < ng; ++k)
        cg[k - 1][threadIdx.x] = in.grp[(size_t)k * B + c.idx];
    }
    __syncthreads();
    const int t = r0 + threadIdx.x;
    float loss = 0.f, dr = 0.f;
    int cnt = 0, seg = -1;
    if (t < r1) {
      const Sample a = sample_at(in, so, occ, t);
      const float ax = a.x, al = a.lab, am = a.m, wt = a.w;
      int ag[kMaxGroups - 1];
#pragma unroll
      for (int k = 0; k < kMaxGroups - 1; ++k)
        ag[k] = k + 1 < ng ? in.grp[(size_t)(k + 1) * B + a.idx] : 0;
      const int hi = min(a.hi, c1);
      for (int v = max(a.lo, c0); v < hi; ++v) {
        const int i = v - c0;
        bool same = true;
#pragma unroll
        for (int k = 0; k < kMaxGroups - 1; ++k)
          if (k + 1 < ng && ag[k] != cg[k][i]) same = false;
        if (!same) continue;
        if (ordered_valid(t, ax, al, am, v, cx[i], cl[i], cm[i],
                          wrong_order)) {       // (t, v): t's row terms
          if constexpr (!kCount) {
            const float d = (ax - cx[i]) * factor;
            loss += wt * softplus(-d);
            dr -= wt * factor * sigmoid(-d);
          }
          ++cnt;
        } else if constexpr (!kCount) {
          if (ordered_valid(v, cx[i], cl[i], cm[i], t, ax, al, am,
                            wrong_order)) {     // (v, t): column terms
            const float d = (cx[i] - ax) * factor;
            dr += cw[i] * factor * sigmoid(-d);
          }
        }
      }
      if constexpr (kCount) {
        if (cnt && so.counts) atomicAdd(so.counts + a.idx, (float)cnt);
        seg = a.seg;
      }
    }
    if constexpr (kCount)
      if (so.segcnt) add_to_segments(so.segcnt, seg, cnt);
    if constexpr (!kCount) {
      const size_t o = (size_t)item * kRows + threadIdx.x;
      part_loss[o] = loss;
      part_cnt[o] = cnt;
      part_dx[o] = dr;
    }
  }
}

// Step 3, a block a row block: dx[perm[t]] = the sum of row t's item
// partials in slice order; the block's loss (in double) and count (in
// 64-bit integers) in a fixed tree; the last block to finish adds the
// blocks' sums in block order into out[0] (loss) and out[1] (count).
__global__ void __launch_bounds__(kRows)
merge_segments(Sorted so, int B, const float* __restrict__ part_loss,
               const int* __restrict__ part_cnt,
               const float* __restrict__ part_dx, float* __restrict__ dx,
               float* __restrict__ out) {
  __shared__ double sl[kRows];
  __shared__ long long sc[kRows];
  __shared__ bool last;
  const int rb = blockIdx.x, t = rb * kRows + threadIdx.x;
  double loss = 0.0;
  long long cnt = 0;
  if (t < B) {
    float d = 0.f;
#pragma unroll 4
    for (int it = so.items[rb]; it < so.items[rb + 1]; ++it) {
      const size_t o = (size_t)it * kRows + threadIdx.x;
      d += part_dx[o];
      loss += part_loss[o];
      cnt += part_cnt[o];
    }
    dx[so.order[t] & ((1 << kSegShift) - 1)] = d;
  }
  sl[threadIdx.x] = loss;
  sc[threadIdx.x] = cnt;
  __syncthreads();
  for (int half = kRows / 2; half > 0; half /= 2) {
    if ((int)threadIdx.x < half) {
      sl[threadIdx.x] += sl[threadIdx.x + half];
      sc[threadIdx.x] += sc[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    so.loss[rb] = sl[0];
    so.cnt[rb] = sc[0];
    __threadfence();                 // the sums before the count
    last = atomicAdd(so.done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    double l = 0.0;
    long long c = 0;
    for (int b = 0; b < (int)gridDim.x; ++b) {
      l += __ldcg(so.loss + b);
      c += __ldcg(so.cnt + b);
    }
    out[0] = (float)l;
    out[1] = (float)c;
  }
}

// B7c's sums over a group, in double.
struct PosTot {
  double pos, tot;
};

struct PosTotOp {
  __device__ static PosTot op(const PosTot& a, const PosTot& b) {
    return {a.pos + b.pos, a.tot + b.tot};
  }
  __device__ static PosTot up(const PosTot& a, int o) {
    return {__shfl_up_sync(0xffffffffu, a.pos, o),
            __shfl_up_sync(0xffffffffu, a.tot, o)};
  }
};

// B7c at B <= kSortMax (see "By segments" above): thread t holds sorted
// positions [t kSortPer, (t + 1) kSortPer) after the sort.
__global__ void __launch_bounds__(kSortThreads)
binary_sort_kernel(const int* __restrict__ grp, const float* __restrict__ lab,
                   const float* __restrict__ mask, int B,
                   float* __restrict__ out) {
  extern __shared__ int sm[];
  unsigned* keys = reinterpret_cast<unsigned*>(sm);    // [spad(kSortMax)]
  int* vals = sm + spad(kSortMax);                      // [spad(kSortMax)]
  int* cnt = vals + spad(kSortMax);                     // [pad(kCounters)]
  __shared__ unsigned wsum[32], wlo[32], whi[32];
  __shared__ PosTot wsums[32];
  __shared__ int wf[32];
  // from here the keys' space is free
  const Segments sg = sort_groups(grp, B, keys, vals, cnt, wsum, wlo, whi);
  const int p0 = threadIdx.x * kSortPer;
  PosTot v[kSortPer];
#pragma unroll
  for (int j = 0; j < kSortPer; ++j) {
    v[j] = {0.0, 0.0};
    if (p0 + j < B) {
      const int i = vals[spad(p0 + j)];
      const float m = mask ? mask[i] : 1.f;
      v[j] = {(double)(m * lab[i]), (double)m};
    }
  }
  block_seg_scan<PosTotOp>(v, sg.heads, wsums, wf);
  float* seg_gpc = reinterpret_cast<float*>(keys);      // [segments]
#pragma unroll
  for (int j = 0; j < kSortPer; ++j)
    if (sg.lasts >> j & 1u)
      seg_gpc[sg.of(j)] = (float)(v[j].pos * (v[j].tot - v[j].pos));
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSortPer; ++j)
    if (p0 + j < B) out[vals[spad(p0 + j)]] = seg_gpc[sg.of(j)];
}

// B7b's table (see "B7b" above), carved from scratch by group_sums.
constexpr int kHashEmpty = 0;     // an empty slot's key; id 0's slot is
                                  // the one past the table
struct HashTable {
  double* sums;                   // [2^bits + 1]
  int* keys;                      // [2^bits]
  int* slot;                      // [B] each row's slot
  int bits;
};

__global__ void __launch_bounds__(kThreads)
hash_insert_kernel(const int* __restrict__ grp, const float* __restrict__ vec,
                   int B, HashTable h) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int id = grp[i];
  unsigned s = 1u << h.bits;
  if (id != kHashEmpty) {
    // Fibonacci hashing: the product's top bits
    s = ((unsigned)id * 0x9E3779B1u) >> (32 - h.bits);
    for (;;) {
      // a key, once set, never changes: a plain read from L2 settles most
      // probes, a CAS only the empty ones
      int k = __ldcg(h.keys + s);
      if (k == kHashEmpty) k = atomicCAS(h.keys + s, kHashEmpty, id);
      if (k == kHashEmpty || k == id) break;
      s = (s + 1u) & ((1u << h.bits) - 1u);
    }
  }
  h.slot[i] = (int)s;
  atomicAdd(h.sums + s, (double)vec[i]);
}

// out[i] = gpc, row i's slot's sum rounded to f32 once, or with `weights`
// the general loss's gpc > 0 ? gpc^power : 0.
__global__ void __launch_bounds__(kThreads)
hash_read_kernel(HashTable h, int B, bool weights, float power,
                 float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const float gpc = (float)h.sums[h.slot[i]];
  out[i] = !weights ? gpc : gpc > 0.f ? powf(gpc, power) : 0.f;
}

// The table's bits for a batch of B: the least with 2^bits >= 2B.
int hash_bits(int B) {
  int bits = 1;
  while ((1LL << bits) < 2LL * B) ++bits;
  return bits;
}

// 4-byte words of the hash path's scratch.
long long hash_words(int B) {
  const long long cap = 1LL << hash_bits(B);
  return 2 * (cap + 1) + cap + B;
}

// B7b's three operations on scratch (8-byte aligned, hash_words(B) words:
// sums first, then keys, then the rows' slots): the memset of sums and
// keys, the insert, the read (as hash_read_kernel's weights and power).
cudaError_t group_sums(const int* groups, const float* vec, int B,
                       void* scratch, bool weights, float power, int rows,
                       cudaStream_t s, float* out) {
  HashTable h;
  h.bits = hash_bits(B);
  const size_t cap = (size_t)1 << h.bits;
  h.sums = static_cast<double*>(scratch);
  h.keys = reinterpret_cast<int*>(h.sums + cap + 1);
  h.slot = h.keys + cap;
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0, (cap + 1) * sizeof(double) + cap * sizeof(int), s);
  if (e != cudaSuccess) return e;
  hash_insert_kernel<<<rows, kThreads, 0, s>>>(groups, vec, B, h);
  hash_read_kernel<<<rows, kThreads, 0, s>>>(h, B, weights, power, out);
  return cudaGetLastError();
}

// Items of the sweep at most: each row block's columns span at most B.
long long max_items(int B) {
  return (long long)((B + kRows - 1) / kRows) * ((B + kCols - 1) / kCols);
}

// 4-byte words of Sorted and, for the loss (B3 and the general loss), the
// sweep's partials, and for the general loss the segments' totals, for a
// batch of B, from an allocation aligned to 8 bytes.
long long sorted_words(int B, bool partials, bool general) {
  return 2 * 32 + 2 * 32 + 2 + 3LL * B + 1 + 34 +
         (partials ? 3 * max_items(B) * kRows : 0) + (general ? B : 0);
}

// Carves scratch (8-byte aligned) into so and, where part_loss is not null,
// the partials; the 8-byte parts first, the segments' totals (so->segcnt,
// null unless `general`) last.
void carve_sorted(void* scratch, int B, Sorted* so, float** part_loss,
                  int** part_cnt, float** part_dx, bool general) {
  int* p = static_cast<int*>(scratch);
  auto take = [&](long long n) {
    int* q = p;
    p += n;
    return q;
  };
  so->loss = reinterpret_cast<double*>(take(2 * 32));
  so->cnt = reinterpret_cast<long long*>(take(2 * 32));
  so->done = reinterpret_cast<unsigned*>(take(2));
  so->order = take(B);
  so->start = take(B + 1);
  so->segw = reinterpret_cast<float*>(take(B));
  so->items = take(34);
  so->counts = nullptr;
  so->power = 0.f;
  if (part_loss) {
    *part_loss = reinterpret_cast<float*>(take(max_items(B) * kRows));
    *part_cnt = take(max_items(B) * kRows);
    *part_dx = reinterpret_cast<float*>(take(max_items(B) * kRows));
  }
  so->segcnt = general ? take(B) : nullptr;
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

// The device's SM count, read once per device (0 when it cannot be read).
int sm_count(int device) {
  static std::atomic<int> slots[kMaxDevices];
  const bool cached = device >= 0 && device < kMaxDevices;
  int v = cached ? slots[device].load(std::memory_order_relaxed) : 0;
  if (v > 0) return v;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  if (cached) slots[device].store(v, std::memory_order_relaxed);
  return v;
}

// Step 1 for B3 and B7a; *grid: the sweep's, a fixed grid of a few blocks
// an SM that takes the items in turn.
cudaError_t sort_segments(const Inputs& in, float power, const Sorted& so,
                          int device, cudaStream_t s, int* grid) {
  const int sms = sm_count(device);
  if (sms == 0) return cudaErrorInvalidValue;
  static std::atomic<bool> smem_set[kMaxDevices];
  const cudaError_t e =
      allow_sort_smem((const void*)sort_segments_kernel, device, smem_set);
  if (e != cudaSuccess) return e;
  sort_segments_kernel<<<1, kSortThreads, sort_smem(), s>>>(in, power, so);
  const long long most = max_items(in.B);
  *grid = (int)(most < 8LL * sms ? most : 8LL * sms);
  return cudaSuccess;
}

// B3 on a batch of B <= kSortMax: the three launches described above.
cudaError_t pair_loss_sorted(const Inputs& in, float factor, float power,
                             bool wrong_order, void* scratch, float* out,
                             float* dx, int device, cudaStream_t s) {
  const int B = in.B;
  Sorted so;
  float *part_loss, *part_dx;
  int* part_cnt;
  carve_sorted(scratch, B, &so, &part_loss, &part_cnt, &part_dx, false);
  int grid;
  const cudaError_t e = sort_segments(in, power, so, device, s, &grid);
  if (e != cudaSuccess) return e;
  segment_sweep<false><<<grid, kRows, 0, s>>>(in, so, power != 0.f, factor,
                                              wrong_order, part_loss,
                                              part_cnt, part_dx);
  merge_segments<<<(B + kRows - 1) / kRows, kRows, 0, s>>>(
      so, B, part_loss, part_cnt, part_dx, dx, out);
  return cudaGetLastError();
}

// B7a on a batch of B <= kSortMax: the sort and the count sweep into out.
cudaError_t row_counts_sorted(const Inputs& in, bool wrong_order,
                              void* scratch, float* out, int device,
                              cudaStream_t s) {
  Sorted so;
  carve_sorted(scratch, in.B, &so, nullptr, nullptr, nullptr, false);
  so.counts = out;
  int grid;
  const cudaError_t e = sort_segments(in, 0.f, so, device, s, &grid);
  if (e != cudaSuccess) return e;
  segment_sweep<true><<<grid, kRows, 0, s>>>(in, so, false, 1.f, wrong_order,
                                             nullptr, nullptr, nullptr);
  return cudaGetLastError();
}

// The general loss on a batch of B <= kSortMax: the sort, B7a's count
// sweep adding into the segments' totals, B3's sweep weighting each sample
// by its segment's total, B3's merge.
cudaError_t pair_loss_general_sorted(const Inputs& in, float factor,
                                     float power, bool wrong_order,
                                     void* scratch, float* out, float* dx,
                                     int device, cudaStream_t s) {
  const int B = in.B;
  Sorted so;
  float *part_loss, *part_dx;
  int* part_cnt;
  carve_sorted(scratch, B, &so, &part_loss, &part_cnt, &part_dx, true);
  so.power = power;
  int grid;
  const cudaError_t e = sort_segments(in, 0.f, so, device, s, &grid);
  if (e != cudaSuccess) return e;
  segment_sweep<true><<<grid, kRows, 0, s>>>(in, so, false, 1.f, wrong_order,
                                             nullptr, nullptr, nullptr);
  segment_sweep<false><<<grid, kRows, 0, s>>>(in, so, true, factor,
                                              wrong_order, part_loss,
                                              part_cnt, part_dx);
  merge_segments<<<(B + kRows - 1) / kRows, kRows, 0, s>>>(
      so, B, part_loss, part_cnt, part_dx, dx, out);
  return cudaGetLastError();
}

// The paths of row_counts_f32, binary_counts_f32 and
// pair_loss_general_f32: 0 auto (the sort where B <= kSortMax, else the
// sweep); 1 the sort (B <= kSortMax only); 2 the sweep (the general loss:
// the composition past kSortMax).
enum { kAuto = 0, kSort = 1, kSweep = 2 };

bool takes_sort(int B, int path) {
  return path == kSort || (path == kAuto && B <= kSortMax);
}

bool bad_path(int B, int path) {
  return path < kAuto || path > kSweep || (path == kSort && B > kSortMax);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Most group conditions a call may AND.
int pair_max_groups() { return kMaxGroups; }

// 4-byte words of scratch each entry point needs for a batch of B (>= 1)
// on `path` (pair_loss_f32 and group_matvec_f32 take any), from an
// allocation aligned to 8 bytes (-1: no such path): kind 0 pair_loss_f32,
// 1 row_counts_f32, 2 group_matvec_f32, 3 binary_counts_f32 (none on the
// sort), 4 pair_loss_general_f32.
long long pair_scratch_words(int kind, int B, int path) {
  const long long sb = (long long)splits_for(B) * B;
  if (kind != 0 && kind != 2 && bad_path(B, path)) return -1;
  switch (kind) {
    case 0:                              // sorted, or (pos, tot), w,
      return B <= kSortMax ? sorted_words(B, true, false)
                           : 2 * sb + B + 3 * sb;  // loss, dx, cnt
    case 1: return takes_sort(B, path) ? sorted_words(B, false, false) : sb;
    case 2: return hash_words(B);
    case 3: return takes_sort(B, path) ? 0 : 4 * sb;   // double2
    default:                             // the table, rows' counts, counts,
      return takes_sort(B, path) ? sorted_words(B, true, true)
                                 : hash_words(B) + 4 * sb + 2 * B;
  }                                      // w, loss, dx, cnt
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
  if (B <= kSortMax)
    return pair_loss_sorted(
        Inputs{logits, labels, groups, ng, mask, row_w, B}, factor, power,
        wrong_order != 0, scratch, out, dx, device, l.stream);
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
// groups (ng, B) int32, mask (B,) f32 or null -> out (B,) f32; `path` as
// above.
int row_counts_f32(const float* logits, const float* labels,
                   const int* groups, int ng, const float* mask, int B,
                   int wrong_order, int path, void* scratch, float* out,
                   int device, void* stream) {
  if (bad_path(B, path)) return cudaErrorInvalidValue;
  Launch l;
  cudaError_t e = begin(B, ng, device, stream, &l);
  if (e != cudaSuccess) return e;
  const Inputs in{logits, labels, groups, ng, mask, nullptr, B};
  if (takes_sort(B, path))
    return row_counts_sorted(in, wrong_order != 0, scratch, out, device,
                             l.stream);
  int* part = static_cast<int*>(scratch);
  row_count_sweep<<<l.sweep, kThreads, 0, l.stream>>>(in, wrong_order != 0,
                                                      l.cols_per, part);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  merge_rows<<<l.rows, kThreads, 0, l.stream>>>(kRowCounts, part, B,
                                                l.splits, nullptr, 0.f, out);
  return cudaGetLastError();
}

// The general occurrence-weighted loss.  logits, labels (B,) f32, groups
// (ng, B) int32, mask (B,) f32 or null; each row weighted by gpc^power (0
// where gpc == 0), gpc the valid pairs of the rows of its main group (B7a
// then B7b) -> out[0] loss sum, out[1] pair count, dx (B,); `path` as
// above.  Returns a cudaError_t.
int pair_loss_general_f32(const float* logits, const float* labels,
                          const int* groups, int ng, const float* mask, int B,
                          float factor, float power, int wrong_order,
                          int path, void* scratch, float* out, float* dx,
                          int device, void* stream) {
  if (bad_path(B, path)) return cudaErrorInvalidValue;
  Launch l;
  cudaError_t e = begin(B, ng, device, stream, &l);
  if (e != cudaSuccess) return e;
  const bool wrong = wrong_order != 0;
  const Inputs in{logits, labels, groups, ng, mask, nullptr, B};
  if (takes_sort(B, path))
    return pair_loss_general_sorted(in, factor, power, wrong, scratch, out,
                                    dx, device, l.stream);
  const size_t sb = (size_t)l.splits * B;
  int* part_rows = static_cast<int*>(scratch) + hash_words(B);  // the table
  float* counts = reinterpret_cast<float*>(part_rows + sb);     // first
  float* w = counts + B;
  float* part_loss = w + B;
  float* part_dx = part_loss + sb;
  int* part_cnt = reinterpret_cast<int*>(part_dx + sb);
  row_count_sweep<<<l.sweep, kThreads, 0, l.stream>>>(in, wrong, l.cols_per,
                                                      part_rows);
  merge_rows<<<l.rows, kThreads, 0, l.stream>>>(kRowCounts, part_rows, B,
                                                l.splits, nullptr, 0.f,
                                                counts);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  e = group_sums(groups, counts, B, scratch, true, power, l.rows, l.stream,
                 w);
  if (e != cudaSuccess) return e;
  const Inputs lw{logits, labels, groups, ng, mask, w, B};
  pair_sweep<<<l.sweep, kThreads, 0, l.stream>>>(lw, factor, wrong,
                                                 l.cols_per, part_loss,
                                                 part_cnt, part_dx);
  merge_loss<<<1, 1024, 0, l.stream>>>(part_loss, part_cnt, part_dx, B,
                                        l.splits, dx, out);
  return cudaGetLastError();
}

// B7b.  groups (B,) int32, vec (B,) f32 -> out (B,) f32.
int group_matvec_f32(const int* groups, const float* vec, int B,
                     void* scratch, float* out, int device, void* stream) {
  Launch l;
  const cudaError_t e = begin(B, 1, device, stream, &l);
  if (e != cudaSuccess) return e;
  return group_sums(groups, vec, B, scratch, false, 0.f, l.rows, l.stream,
                    out);
}

// B7c.  groups (B,) int32, labels (B,) f32, mask (B,) f32 or null -> out
// (B,) f32; `path` as above.
int binary_counts_f32(const int* groups, const float* labels,
                      const float* mask, int B, int path, void* scratch,
                      float* out, int device, void* stream) {
  if (bad_path(B, path)) return cudaErrorInvalidValue;
  Launch l;
  cudaError_t e = begin(B, 1, device, stream, &l);
  if (e != cudaSuccess) return e;
  if (takes_sort(B, path)) {
    static std::atomic<bool> smem_set[kMaxDevices];
    e = allow_sort_smem((const void*)binary_sort_kernel, device, smem_set);
    if (e != cudaSuccess) return e;
    binary_sort_kernel<<<1, kSortThreads, sort_smem(), l.stream>>>(
        groups, labels, mask, B, out);
    return cudaGetLastError();
  }
  const Inputs in{nullptr, labels, groups, 1, mask, nullptr, B};
  double2* part = static_cast<double2*>(scratch);
  binary_sum_sweep<<<l.sweep, kThreads, 0, l.stream>>>(in, l.cols_per, part);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  merge_rows<<<l.rows, kThreads, 0, l.stream>>>(kBinarySums, part, B,
                                                l.splits, nullptr, 0.f, out);
  return cudaGetLastError();
}

}  // extern "C"
