// Native Criteo-TSV parser: the host-side ingestion of the training CLI.
//
// A copy of rec_now_tpu/io/native/criteo_parser.cpp with the same C ABI
// (rn_parse_criteo, rn_fnv1a_mod), built by rec_now_tpu_torch/io/build.py
// with g++ at first use and loaded with ctypes.  It splits a buffer over
// threads and fills preallocated numpy buffers, where the Python plain
// version parses one line at a time on one thread.
//
// Input format (Criteo Kaggle/Terabyte TSV):
//   label \t I1..I13 (decimal ints, may be empty) \t C1..C26 (hex
//   tokens, may be empty) \n
//
// Semantics (mirrored by the pure-Python plain version in
// rec_now_tpu_torch/io/criteo.py; the tests hold ids, labels and groups
// equal and dense within 1e-6 relative):
//   * dense:  missing -> 0.0; v <= 0 -> 0.0; else log1p(v), float32.
//   * sparse: FNV-1a 64-bit over the raw token bytes, mod
//     rows_per_field; missing token -> row 0.
//   * group id: FNV-1a of the group_field-th categorical token mod
//     num_groups (the in-batch pairwise/listwise losses group by it);
//     group_field < 0 -> 0.
//
// Threading: two passes.  Pass 1 splits the buffer into num_threads
// byte ranges aligned to line boundaries and counts rows per range;
// pass 2 parses each range in parallel, writing at exclusive-prefix-sum
// row offsets.  No locks, no allocation in the parse loop.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 1469598103934665603ull;
constexpr uint64_t kFnvPrime = 1099511628211ull;

inline uint64_t fnv1a(const char* s, const char* end) {
  uint64_t h = kFnvOffset;
  for (; s < end; ++s) {
    h ^= static_cast<uint64_t>(static_cast<unsigned char>(*s));
    h *= kFnvPrime;
  }
  return h;
}

// Parse a (possibly signed) decimal int between s and end; empty -> no
// value.  Criteo dense fields are plain ints; anything malformed is
// treated as missing.
inline bool parse_int(const char* s, const char* end, long* out) {
  if (s >= end) return false;
  bool neg = false;
  if (*s == '-') { neg = true; ++s; }
  if (s >= end) return false;
  long v = 0;
  for (; s < end; ++s) {
    if (*s < '0' || *s > '9') return false;
    v = v * 10 + (*s - '0');
  }
  *out = neg ? -v : v;
  return true;
}

struct Range {
  const char* begin;
  const char* end;
  int64_t rows;       // newline count in [begin, end)
  int64_t row_start;  // exclusive prefix sum of rows
};

// One thread's parse of its line range, writing rows
// [row_start, row_start + rows).
void parse_range(const Range& r, int32_t num_dense, int32_t num_sparse,
                 int64_t rows_per_field, int32_t group_field,
                 int64_t num_groups, int64_t max_rows, float* dense,
                 int32_t* ids, float* labels, int32_t* group_ids) {
  const char* p = r.begin;
  int64_t row = r.row_start;
  while (p < r.end && row < max_rows) {
    const char* line_end =
        static_cast<const char*>(memchr(p, '\n', r.end - p));
    if (line_end == nullptr) break;  // incomplete tail line: skip
    float* drow = dense + row * num_dense;
    int32_t* irow = ids + row * num_sparse;

    // field 0: label
    const char* tok = p;
    const char* tab =
        static_cast<const char*>(memchr(tok, '\t', line_end - tok));
    const char* tok_end = tab ? tab : line_end;
    long lab = 0;
    parse_int(tok, tok_end, &lab);
    labels[row] = lab ? 1.0f : 0.0f;
    tok = tok_end < line_end ? tok_end + 1 : line_end;

    // dense fields
    for (int32_t d = 0; d < num_dense; ++d) {
      tab = static_cast<const char*>(memchr(tok, '\t', line_end - tok));
      tok_end = tab ? tab : line_end;
      long v = 0;
      float x = 0.0f;
      if (parse_int(tok, tok_end, &v) && v > 0) {
        x = log1pf(static_cast<float>(v));
      }
      drow[d] = x;
      tok = tok_end < line_end ? tok_end + 1 : line_end;
    }

    // categorical fields
    for (int32_t c = 0; c < num_sparse; ++c) {
      tab = static_cast<const char*>(memchr(tok, '\t', line_end - tok));
      tok_end = tab ? tab : line_end;
      int32_t id = 0;
      if (tok < tok_end) {
        id = static_cast<int32_t>(
            fnv1a(tok, tok_end) %
            static_cast<uint64_t>(rows_per_field));
      }
      irow[c] = id;
      if (c == group_field) {
        group_ids[row] =
            tok < tok_end
                ? static_cast<int32_t>(
                      fnv1a(tok, tok_end) %
                      static_cast<uint64_t>(num_groups))
                : 0;
      }
      tok = tok_end < line_end ? tok_end + 1 : line_end;
    }
    if (group_field < 0) group_ids[row] = 0;
    ++row;
    p = line_end + 1;
  }
}

}  // namespace

extern "C" {

// Returns the number of complete rows parsed from buf[0..len), or a
// negative error code.  Caller owns all buffers; dense is
// (max_rows, num_dense) float32, ids (max_rows, num_sparse) int32,
// labels/group_ids (max_rows,).  A trailing line without '\n' is NOT
// consumed (the Python wrapper carries it into the next chunk).
int64_t rn_parse_criteo(const char* buf, int64_t len, int32_t num_dense,
                        int32_t num_sparse, int64_t rows_per_field,
                        int32_t group_field, int64_t num_groups,
                        int32_t num_threads, int64_t max_rows,
                        float* dense, int32_t* ids, float* labels,
                        int32_t* group_ids) {
  if (len <= 0) return 0;
  if (rows_per_field <= 0 || num_groups <= 0) return -1;
  if (num_threads < 1) num_threads = 1;
  if (num_threads > 64) num_threads = 64;

  // pass 1: line-aligned ranges + row counts
  std::vector<Range> ranges;
  ranges.reserve(num_threads);
  const char* cur = buf;
  const char* bend = buf + len;
  for (int32_t t = 0; t < num_threads; ++t) {
    const char* stop =
        (t == num_threads - 1) ? bend : buf + len * (t + 1) / num_threads;
    if (stop < cur) stop = cur;
    // advance stop to just past the next newline so ranges hold whole
    // lines
    const char* nl = stop < bend
        ? static_cast<const char*>(memchr(stop, '\n', bend - stop))
        : nullptr;
    const char* rend = nl ? nl + 1 : bend;
    if (t == num_threads - 1) rend = bend;
    if (rend > cur) ranges.push_back({cur, rend, 0, 0});
    cur = rend;
  }
  std::vector<std::thread> workers;
  for (auto& r : ranges) {
    workers.emplace_back([&r]() {
      int64_t n = 0;
      const char* p = r.begin;
      while (p < r.end) {
        const char* nl =
            static_cast<const char*>(memchr(p, '\n', r.end - p));
        if (!nl) break;
        ++n;
        p = nl + 1;
      }
      r.rows = n;
    });
  }
  for (auto& w : workers) w.join();
  workers.clear();

  int64_t total = 0;
  for (auto& r : ranges) {
    r.row_start = total;
    total += r.rows;
  }
  if (total > max_rows) total = max_rows;

  // pass 2: parse
  for (auto& r : ranges) {
    if (r.row_start >= max_rows) break;
    workers.emplace_back([&, max_rows]() {
      parse_range(r, num_dense, num_sparse, rows_per_field, group_field,
                  num_groups, max_rows, dense, ids, labels, group_ids);
    });
  }
  for (auto& w : workers) w.join();
  return total;
}

// FNV-1a 64 of one token, mod `mod`: exposed so that tests can hold the
// Python hash against the parser's.
int64_t rn_fnv1a_mod(const char* s, int64_t len, int64_t mod) {
  if (mod <= 0) return -1;
  return static_cast<int64_t>(fnv1a(s, s + len) %
                              static_cast<uint64_t>(mod));
}

}  // extern "C"
