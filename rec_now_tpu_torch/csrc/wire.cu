// The compressed wire's host pack (training/wire.py), in C++ on the host.
//
// The same bytes as WireFormat.pack_window's numpy code, the copy of
// rec_now_tpu/training/wire.py (:326-469) in its ``packed`` id mode:
//   * ids: each (row, field) id cast to uint32 and OR-ed into the row's
//     uint32 words at bit i * bits (a field that crosses a word boundary
//     spills its high bits into the next word);
//   * u8 dense: per (window step, batch shard, feature) lo = min, hi = max
//     over the shard's rows, step = (hi - lo) / 255 and
//     q = rint((x - lo) / (step > 0 ? step : 1)), all in f32;
//   * group ids: each batch's ids replaced by their rank among the batch's
//     sorted distinct ids (np.unique's inverse), uint16;
//   * flags: (label > 0) | (cvr > 0) << 1 | uint8(domain) << 2, with
//     uint8(domain) < 64;
//   * hot8 ids (the ``hot8`` id mode, wire.py:262-304): each id's byte
//     code from the (F, rows) inverse map of the current table (255 =
//     escape), and each batch shard's escaped ids, in the shard's
//     (rows, F) row-major order, as little-endian 3-byte triples padded
//     with zeros to the cap.  A shard with more escapes than the cap is
//     reported, not encoded: learning and relearning the table stay in
//     Python, which calls again after a relearn.
//
// Why C++: a prefetch thread packs window k + 1 while the loop thread
// dispatches window k's steps, and a pack of some hundred numpy calls hands
// the interpreter lock back and forth with that thread at every call.
// ctypes releases the lock for the whole of each call below.
//
// Host code only (no kernel); built by nvcc with the package's CUDA
// sources.  f32 arithmetic is IEEE single on x86-64 SSE and the compiler
// may neither reassociate nor turn the division into a reciprocal without
// fast-math flags, so the quantized bytes equal numpy's.
#include <stdint.h>

#include <algorithm>
#include <utility>
#include <vector>

namespace {

enum : int {
  kOk = 0, kBadArgs = 1, kDomainTooLarge = 2, kEscOverflow = 3,
  kIdOutOfRange = 4
};

// As numpy: the id's uint32 shifted to its offset within its word (bits
// shifted past bit 31 are lost), and a field that crosses a word boundary
// also OR-ed into the next word from its bit 32 - shift up.
template <typename T>
void pack_ids_rows(const T* ids, long long n, int f, int bits, int w,
                   uint32_t* out) {
  std::vector<int> word(f), shift(f), cross(f);
  for (int i = 0; i < f; ++i) {
    word[i] = (i * bits) >> 5;
    shift[i] = (i * bits) & 31;
    cross[i] = shift[i] + bits > 32;
  }
  for (long long r = 0; r < n; ++r) {
    const T* row = ids + r * f;
    uint32_t* o = out + r * w;
    std::fill(o, o + w, 0u);
    for (int i = 0; i < f; ++i) {
      const uint32_t v = static_cast<uint32_t>(row[i]);
      o[word[i]] |= v << shift[i];
      if (cross[i]) o[word[i] + 1] |= v >> (32 - shift[i]);
    }
  }
}

// rank = the index of each id among the row's sorted distinct ids
template <typename T>
void remap_rows(const T* g, long long s, long long b, uint16_t* out) {
  std::vector<T> u(b);
  for (long long r = 0; r < s; ++r) {
    const T* row = g + r * b;
    std::copy(row, row + b, u.begin());
    std::sort(u.begin(), u.end());
    const auto end = std::unique(u.begin(), u.end());
    for (long long i = 0; i < b; ++i)
      out[r * b + i] = static_cast<uint16_t>(
          std::lower_bound(u.begin(), end, row[i]) - u.begin());
  }
}

template <typename T>
int flags_rows(const float* labels, const float* cvr, const T* domain,
               long long n, uint8_t* out) {
  for (long long i = 0; i < n; ++i) {
    const uint8_t d = static_cast<uint8_t>(domain[i]);
    if (d >= 64) return kDomainTooLarge;
    out[i] = static_cast<uint8_t>((labels[i] > 0.0f ? 1 : 0) |
                                  (cvr[i] > 0.0f ? 2 : 0) | (d << 2));
  }
  return kOk;
}

// s window steps of b rows, each in ``shards`` shards of c = b / shards
// rows; every shard's escapes go to its own cap-triple slot of esc
template <typename T>
int encode_hot_rows(const T* ids, long long s, long long b, int f,
                    int shards, long long cap, const uint8_t* inv,
                    long long rows, uint8_t* codes, uint8_t* esc) {
  const long long c = b / shards;
  for (long long k = 0; k < s * shards; ++k) {
    const T* x = ids + k * c * f;
    uint8_t* ck = codes + k * c * f;
    uint8_t* ek = esc + k * cap * 3;
    std::fill(ek, ek + cap * 3, uint8_t{0});
    long long n = 0;
    for (long long r = 0; r < c; ++r)
      for (int j = 0; j < f; ++j) {
        const long long v = static_cast<long long>(x[r * f + j]);
        if (v < 0 || v >= rows) return kIdOutOfRange;
        const uint8_t code = inv[j * rows + v];
        ck[r * f + j] = code;
        if (code != 255) continue;
        if (n == cap) return kEscOverflow;
        uint8_t* t = ek + 3 * n++;
        t[0] = static_cast<uint8_t>(v & 0xFF);
        t[1] = static_cast<uint8_t>((v >> 8) & 0xFF);
        t[2] = static_cast<uint8_t>((v >> 16) & 0xFF);
      }
  }
  return kOk;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  switch (code) {
    case kOk: return "no error";
    case kBadArgs: return "bad arguments";
    case kDomainTooLarge: return "a domain index >= 64";
    case kEscOverflow: return "a shard's hot8 escapes overflow the cap";
    case kIdOutOfRange: return "a hot8 id outside [0, rows)";
    default: return "unknown error";
  }
}

// ids (n, f) int32 (ids64 = 0) or int64 (ids64 = 1), contiguous; out (n, w)
// uint32 with w = ceil(f * bits / 32); 1 <= bits <= 32.
int wire_pack_ids(const void* ids, int ids64, long long n, int f, int bits,
                  uint32_t* out) {
  if (n < 0 || f < 1 || bits < 1 || bits > 32) return kBadArgs;
  const int w = static_cast<int>((static_cast<long long>(f) * bits + 31) / 32);
  if (ids64)
    pack_ids_rows(static_cast<const int64_t*>(ids), n, f, bits, w, out);
  else
    pack_ids_rows(static_cast<const int32_t*>(ids), n, f, bits, w, out);
  return kOk;
}

// dense (s, b, nf) f32, contiguous, each step's b rows in ``shards``
// contiguous chunks; q (s, b, nf) uint8; scale (s, shards, 2, nf) f32 as
// (lo, step).  b % shards == 0.
int wire_pack_dense_u8(const float* dense, long long s, long long b, int nf,
                       int shards, uint8_t* q, float* scale) {
  if (s < 0 || b < 1 || nf < 0 || shards < 1 || b % shards) return kBadArgs;
  const long long c = b / shards;
  std::vector<float> lo(nf), hi(nf), den(nf);
  for (long long k = 0; k < s * shards; ++k) {
    const float* x = dense + k * c * nf;
    uint8_t* qk = q + k * c * nf;
    for (int j = 0; j < nf; ++j) lo[j] = hi[j] = x[j];
    for (long long r = 1; r < c; ++r)
      for (int j = 0; j < nf; ++j) {
        const float v = x[r * nf + j];
        if (v < lo[j]) lo[j] = v;
        if (v > hi[j]) hi[j] = v;
      }
    float* sk = scale + k * 2 * nf;
    for (int j = 0; j < nf; ++j) {
      const float step = (hi[j] - lo[j]) / 255.0f;
      den[j] = step > 0.0f ? step : 1.0f;
      sk[j] = lo[j];
      sk[nf + j] = step;
    }
    // round half to even as np.rint: for 0 <= v < 2^23, v + 2^23 rounds
    // v's fraction away in the default rounding mode (a libm call per
    // value otherwise, where the target lacks SSE4.1's roundss)
    for (long long r = 0; r < c; ++r)
      for (int j = 0; j < nf; ++j) {
        const float v = (x[r * nf + j] - lo[j]) / den[j];
        qk[r * nf + j] = static_cast<uint8_t>((v + 8388608.0f) - 8388608.0f);
      }
  }
  return kOk;
}

// groups (s, b) int32 (g64 = 0) or int64 (g64 = 1), contiguous -> out (s, b)
// uint16 ranks; b <= 65535.
int wire_remap_groups(const void* groups, int g64, long long s, long long b,
                      uint16_t* out) {
  if (s < 0 || b < 0 || b > 0xFFFF) return kBadArgs;
  if (g64)
    remap_rows(static_cast<const int64_t*>(groups), s, b, out);
  else
    remap_rows(static_cast<const int32_t*>(groups), s, b, out);
  return kOk;
}

// labels, cvr (n,) f32; domain (n,) int32 (d64 = 0) or int64 (d64 = 1);
// out (n,) uint8.  Returns kDomainTooLarge if a uint8(domain) is >= 64.
int wire_pack_flags(const float* labels, const float* cvr, const void* domain,
                    int d64, long long n, uint8_t* out) {
  if (n < 0) return kBadArgs;
  if (d64)
    return flags_rows(labels, cvr, static_cast<const int64_t*>(domain), n,
                      out);
  return flags_rows(labels, cvr, static_cast<const int32_t*>(domain), n, out);
}

// hot8: ids (s, b, f) int32 (ids64 = 0) or int64 (ids64 = 1), contiguous;
// inv (f, rows) uint8 codes; codes out (s, b, f) uint8; esc out (s, shards,
// cap * 3) uint8.  b % shards == 0.  Returns kEscOverflow when a shard has
// more than cap escapes and kIdOutOfRange for an id outside [0, rows): the
// outputs are then incomplete.
int wire_encode_hot(const void* ids, int ids64, long long s, long long b,
                    int f, int shards, long long cap, const uint8_t* inv,
                    long long rows, uint8_t* codes, uint8_t* esc) {
  if (s < 0 || b < 1 || f < 1 || shards < 1 || b % shards || cap < 1 ||
      rows < 1)
    return kBadArgs;
  if (ids64)
    return encode_hot_rows(static_cast<const int64_t*>(ids), s, b, f, shards,
                           cap, inv, rows, codes, esc);
  return encode_hot_rows(static_cast<const int32_t*>(ids), s, b, f, shards,
                         cap, inv, rows, codes, esc);
}

}  // extern "C"
