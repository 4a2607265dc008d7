// A batch sorted by group in one block, for Hopper (sm_90a): the stable LSD
// radix sort and the block scans that the in-batch losses share
// (pairwise.cu's B3 pair_loss_f32, B7a row_counts_f32 and B7c
// binary_counts_f32, and listwise.cu's B6 listwise_f32, each at B <=
// kSortMax).
//
// One block of kSortThreads threads holds the batch's keys and values in
// shared memory (sort_smem() bytes of dynamic shared memory, past the 48 KB
// default: runtime.cuh's allow_smem once per device and kernel).  The
// caller writes keys[spad(i)] = group_i ^ 0x80000000 (the sign bit
// flipped, so that negative ids order first) and vals[spad(i)] = a value
// holding i, each thread for i = t, t + kSortThreads, ...; block_min_max
// gives the keys' range, and sort_by_group sorts (group, extra bits, i):
//   - keys less their minimum, so that the passes cover the batch's range
//     only: 4 bits a pass, 1 pass for 16 ids, 8 for ids at both ends of the
//     int32 range (the span is computed in unsigned 32 bits);
//   - kExtra bits taken from each value (B3: the label test, so that within
//     a group the negatives come first; B6: none) as the key's lowest bits
//     where the range leaves room for them, else as a pass of their own
//     before the group's passes;
//   - each pass stable (counts per (digit, thread), one block scan in
//     (digit, thread) order, then a scatter in position order), so ties keep
//     index order and a segment's first position is its group's first
//     occurrence in the batch.
// After the sort thread t holds sorted positions [t kSortPer, (t + 1)
// kSortPer): segment_head tells where a group starts, block_excl_scan
// numbers the segments, and block_seg_scan runs a segmented scan of any
// per-position value over the block.  sort_groups does all but the scan
// for a kernel that sorts by group alone (B6, B7c).  Each pass and scan is a fixed
// sequence of operations whatever the scheduling, so repeats are
// bit-equal.
//
// What bounds it: a few block-wide barriers a pass (latency, one SM); the
// passes' reads and writes of 8 bytes a sample in shared memory.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kSortThreads = 1024;
constexpr int kSortPer = 8;                             // keys a thread
constexpr int kSortMax = kSortThreads * kSortPer;       // 8,192 (13 bits)
constexpr int kDigits = 16;                             // 4 bits a pass
constexpr int kCounters = kDigits * kSortThreads;

// Counter e of the sort, one word of padding every 32: the scan's reads
// (16 consecutive counters a thread) hit 32 distinct banks.
__host__ __device__ constexpr int pad(int e) { return e + (e >> 5); }

// Key or value at position p, one word of padding every 8: a thread's 8
// consecutive positions, read by a warp at once, hit 32 distinct banks.
__host__ __device__ constexpr int spad(int p) { return p + (p >> 3); }

// keys [spad(kSortMax)], values [spad(kSortMax)], then the counters
// [pad(kCounters)]; after the sort a kernel may reuse the keys' and the
// counters' space.
size_t sort_smem() {
  return (2 * (size_t)spad(kSortMax) + pad(kCounters)) * sizeof(int);
}

// The exclusive prefix sum of v over a block of kSortThreads threads, and
// the block's total; wsum: 32 words of shared memory, which the caller
// writes again only after another barrier.
template <class T>
__device__ T block_excl_scan(T v, T* wsum, T& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) wsum[w] = inc;
  __syncthreads();
  if (w == 0) {
    T s = wsum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T n = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += n;
    }
    wsum[lane] = s;
  }
  __syncthreads();
  total = wsum[31];
  return (w ? wsum[w - 1] : T(0)) + inc - v;
}

// Every thread's lo and hi become the block's smallest lo and largest hi;
// wlo, whi: 32 words each of shared memory.
__device__ void block_min_max(unsigned& lo, unsigned& hi, unsigned* wlo,
                              unsigned* whi) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    wlo[w] = lo;
    whi[w] = hi;
  }
  __syncthreads();
  lo = wlo[0];
  hi = whi[0];
  for (int i = 1; i < 32; ++i) {
    lo = min(lo, wlo[i]);
    hi = max(hi, whi[i]);
  }
}

// The extra key bits of a sort without any.
struct NoExtra {
  __device__ unsigned operator()(int) const { return 0u; }
};

// Sorts the batch's B <= kSortMax (key, value) pairs by (key, extra(value),
// position) as the header's comment says; lo and hi: the keys' range from
// block_min_max.  Returns the shift that drops the extra bits from a sorted
// key (kExtra where they were folded into it, else 0): segment_head's.
// Ends on a barrier.
template <int kExtra, class Extra>
__device__ int sort_by_group(unsigned* keys, int* vals, int* cnt,
                             unsigned* wsum, int B, unsigned lo, unsigned hi,
                             Extra extra) {
  static_assert(kExtra >= 0 && kExtra <= 4, "the extra bits take one pass");
  const int t = threadIdx.x;
  const unsigned range = hi - lo;
  // the extra bits fit below the range (range < 2^(32 - kExtra))
  const bool fold = (range >> (31 - kExtra) >> 1) == 0u;
#pragma unroll 4
  for (int i = t; i < B; i += kSortThreads) {
    const unsigned k = keys[spad(i)] - lo;
    keys[spad(i)] = fold ? k << kExtra | extra(vals[spad(i)]) : k;
  }
  __syncthreads();
  const unsigned span =
      fold ? range << kExtra | ((1u << kExtra) - 1u) : range;
  const int passes = span ? (32 - __clz(span) + 3) / 4 : 0;
  const int p0 = t * kSortPer;
  auto digit = [&](unsigned k, int v, int pass) {
    return pass < 0 ? (int)extra(v) : (int)(k >> (4 * pass)) & 15;
  };
  for (int pass = fold ? 0 : -1; pass < passes; ++pass) {
    unsigned kk[kSortPer];
    int vv[kSortPer];
#pragma unroll
    for (int d = 0; d < kDigits; ++d) cnt[pad(d * kSortThreads + t)] = 0;
#pragma unroll
    for (int j = 0; j < kSortPer; ++j) {
      kk[j] = 0u;
      vv[j] = 0;
      if (p0 + j < B) {
        kk[j] = keys[spad(p0 + j)];
        vv[j] = vals[spad(p0 + j)];
        ++cnt[pad(digit(kk[j], vv[j], pass) * kSortThreads + t)];
      }
    }
    __syncthreads();
    // exclusive scan in (digit, thread) order: thread u takes counters
    // [16u, 16u + 16), all of one digit
    int c[16], run = 0;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      c[q] = run;
      run += cnt[pad(16 * t + q)];
    }
    unsigned total;
    const int base = (int)block_excl_scan<unsigned>(run, wsum, total);
#pragma unroll
    for (int q = 0; q < 16; ++q) cnt[pad(16 * t + q)] = base + c[q];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSortPer; ++j) {
      if (p0 + j < B) {
        const int pos =
            cnt[pad(digit(kk[j], vv[j], pass) * kSortThreads + t)]++;
        keys[spad(pos)] = kk[j];
        vals[spad(pos)] = vv[j];
      }
    }
    __syncthreads();
  }
  return fold ? kExtra : 0;
}

// Does sorted position s (0 < s < B, or 0) start a segment (a group)?
__device__ __forceinline__ bool segment_head(const unsigned* keys, int s,
                                             int shift) {
  return s == 0 || ((keys[spad(s)] ^ keys[spad(s - 1)]) >> shift) != 0u;
}

// Thread t's sorted positions [t kSortPer, (t + 1) kSortPer) after
// sort_groups: bit j of heads set where position j starts a segment (and
// at every position past the batch, a segment of its own that adds to
// none), of lasts where it ends one; `before` the segments that start
// before the thread's first position.
struct Segments {
  unsigned heads, lasts, before;
  // the segment id of the thread's position j
  __device__ int of(int j) const {
    return (int)before + __popc(heads & ((2u << j) - 1u)) - 1;
  }
};

// The opening of a one-block kernel by group: keys[spad(i)] = grp[i] ^
// 0x80000000 and vals[spad(i)] = i for the batch's B <= kSortMax samples,
// sorted by (group, i) (no extra key bits), and the thread's segments.
// wsum, wlo, whi: 32 words of shared memory each.  Ends on a barrier after
// which no key is read again: the keys' and the counters' space is free.
__device__ Segments sort_groups(const int* __restrict__ grp, int B,
                                unsigned* keys, int* vals, int* cnt,
                                unsigned* wsum, unsigned* wlo,
                                unsigned* whi) {
  const int t = threadIdx.x;
  unsigned lo = 0xffffffffu, hi = 0u;
#pragma unroll 4
  for (int i = t; i < B; i += kSortThreads) {
    const unsigned k = static_cast<unsigned>(grp[i]) ^ 0x80000000u;
    keys[spad(i)] = k;
    vals[spad(i)] = i;
    lo = min(lo, k);
    hi = max(hi, k);
  }
  block_min_max(lo, hi, wlo, whi);
  const int shift = sort_by_group<0>(keys, vals, cnt, wsum, B, lo, hi,
                                     NoExtra());
  const int p0 = t * kSortPer;
  Segments sg{0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kSortPer; ++j) {
    const int s = p0 + j;
    if (s < B) {
      if (segment_head(keys, s, shift)) sg.heads |= 1u << j;
      if (s + 1 == B || segment_head(keys, s + 1, shift)) sg.lasts |= 1u << j;
    } else {
      sg.heads |= 1u << j;
    }
  }
  unsigned nseg;
  sg.before = block_excl_scan<unsigned>(__popc(sg.heads), wsum, nseg);
  return sg;
}

// An inclusive segmented scan over the block's sorted positions.  Thread t
// holds positions [t kSortPer, (t + 1) kSortPer) in v, bit j of `heads` set
// where position j starts a segment (and at every position past the batch);
// on return v[j] combines, by Op::op(earlier, later), the values from its
// segment's head through j, so a segment's last position holds its total.
// Op also gives Op::up(a, o), a's value o lanes down the warp
// (__shfl_up_sync of each field).  wval, wflag: 32 entries of shared memory
// each, written again by the caller only after another barrier.
template <class Op, class T>
__device__ void block_seg_scan(T (&v)[kSortPer], unsigned heads, T* wval,
                               int* wflag) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int j = 1; j < kSortPer; ++j)
    if (!(heads >> j & 1u)) v[j] = Op::op(v[j - 1], v[j]);
  // the thread's (has a head, value after its last head) across the warp
  T agg = v[kSortPer - 1];
  int f = heads != 0u;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T n = Op::up(agg, o);
    const int nf = __shfl_up_sync(0xffffffffu, f, o);
    if (lane >= o) {
      if (!f) agg = Op::op(n, agg);
      f |= nf;
    }
  }
  if (lane == 31) {
    wval[w] = agg;
    wflag[w] = f;
  }
  __syncthreads();
  if (w == 0) {
    T s = wval[lane];
    int sf = wflag[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T n = Op::up(s, o);
      const int nf = __shfl_up_sync(0xffffffffu, sf, o);
      if (lane >= o) {
        if (!sf) s = Op::op(n, s);
        sf |= nf;
      }
    }
    wval[lane] = s;
    wflag[lane] = sf;
  }
  __syncthreads();
  // what the positions before this thread add to its first segment: the
  // previous lane's value, after the earlier warps' where it has no head
  T carry = Op::up(agg, 1);
  const int cf = __shfl_up_sync(0xffffffffu, f, 1);
  if (w > 0 && (lane == 0 || !cf))
    carry = lane == 0 ? wval[w - 1] : Op::op(wval[w - 1], carry);
  if (heads & 1u) return;              // position 0 of the batch among them
#pragma unroll
  for (int j = 0; j < kSortPer; ++j) {
    if (heads >> j & 1u) break;
    v[j] = Op::op(carry, v[j]);
  }
}

}  // namespace
