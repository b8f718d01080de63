// Multi-threaded chunk parsers for libsvm / csv / libfm -> CSR buffers.
//
// TPU-native rebuild of the reference parse hot path (src/data/
// text_parser.h:110-146 chunk-splitting across threads + libsvm_parser.h /
// csv_parser.h / libfm_parser.h ParseBlock scanners): a chunk of text is
// split at line boundaries into nthread ranges, each range parsed into
// per-thread CSR vectors, then the results are merged into one contiguous
// malloc'd block handed to Python over a C ABI (ctypes — no pybind11 in
// this image).
//
// Semantics intentionally identical to the Python engine in
// dmlc_tpu/data/parsers.py (which mirrors the reference):
//   libsvm: label[:weight] [qid:N] idx[:val]... , '#' comments, BOM skip,
//           indexing_mode {-1,0,1} with the sklearn heuristic per chunk.
//   csv:    single-char delimiter, dense cells; ragged rows -> error.
//   libfm:  label field:idx:val triples; heuristic needs BOTH mins > 0.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "api.h"
#include "buffer_pool.h"
#include "parse_internal.h"
#include "strtonum.h"

namespace dmlc_tpu {

struct CsrPart {
  std::vector<int64_t> row_nnz;
  std::vector<float> label;
  std::vector<float> weight;   // empty or per-row
  std::vector<int64_t> qid;    // empty or per-row
  std::vector<uint64_t> index;
  std::vector<uint64_t> field;  // libfm only
  std::vector<float> value;    // empty (all-binary) or per-entry
  uint64_t min_index = UINT64_MAX;
  uint64_t min_field = UINT64_MAX;
  std::string error;
};

// Clamp the thread count so small chunks don't pay thread spawn overhead
// (parse_internal.h: one thread per 512 KB, at least one).
static int clamp_threads(int nthread, size_t len) {
  return parse_threads(nthread, len);
}

// Split [begin, end) into n ranges at line boundaries.
static std::vector<std::pair<const char*, const char*>> split_lines(
    const char* begin, const char* end, int n) {
  std::vector<std::pair<const char*, const char*>> out;
  size_t total = static_cast<size_t>(end - begin);
  size_t step = total / static_cast<size_t>(n) + 1;
  const char* cur = begin;
  for (int i = 0; i < n && cur < end; ++i) {
    const char* stop = cur + step;
    if (stop >= end) {
      stop = end;
    } else {
      while (stop < end && *stop != '\n' && *stop != '\r') ++stop;
      while (stop < end && (*stop == '\n' || *stop == '\r')) ++stop;
    }
    out.emplace_back(cur, stop);
    cur = stop;
  }
  if (cur < end && !out.empty()) out.back().second = end;
  return out;
}

static inline const char* line_end(const char* p, const char* end) {
  while (p != end && *p != '\n' && *p != '\r') ++p;
  return p;
}

// SIMD line scan: memchr for '\n' (and '\r' only when the range has any —
// one flag check instead of a scalar byte loop re-touching every line).
// The scalar pre-scan was ~1 cyc/byte, a full second pass over the chunk.
static inline const char* line_end_fast(const char* p, const char* end,
                                        bool has_cr) {
  const char* nl =
      static_cast<const char*>(memchr(p, '\n', static_cast<size_t>(end - p)));
  const char* stop = nl ? nl : end;
  if (has_cr) {
    const char* cr = static_cast<const char*>(
        memchr(p, '\r', static_cast<size_t>(stop - p)));
    if (cr) return cr;
  }
  return stop;
}

// ---------------- libsvm ----------------

// Count bytes equal to `c` in [p, end) via SIMD memchr hops — ~0.1 cyc/byte,
// repaid many times over by reserving the output vectors (push_back growth
// re-copies multi-MB index/value arrays several times otherwise).
static inline size_t count_byte(const char* p, const char* end, char c) {
  size_t n = 0;
  while ((p = static_cast<const char*>(memchr(p, c, end - p))) != nullptr) {
    ++n;
    ++p;
  }
  return n;
}

static void parse_libsvm_range(const char* begin, const char* end, CsrPart* out) {
  const bool has_cr =
      memchr(begin, '\r', static_cast<size_t>(end - begin)) != nullptr;
  const char* p = begin;
  {
    size_t rows = count_byte(begin, end, '\n') + 1;
    size_t entries = count_byte(begin, end, ':');  // upper bound (+weights/qids)
    out->row_nnz.reserve(rows);
    out->label.reserve(rows);
    out->index.reserve(entries);
    out->value.reserve(entries);
  }
  while (p < end) {
    const char* lend = line_end_fast(p, end, has_cr);
    const char* q = p;
    // strip comment
    const char* hash = static_cast<const char*>(memchr(q, '#', lend - q));
    const char* effective_end = hash ? hash : lend;
    double label;
    const char* after;
    if (!parse_value(q, effective_end, &after, &label)) {
      p = lend;
      while (p < end && (*p == '\n' || *p == '\r')) ++p;
      continue;  // blank/comment-only line
    }
    q = after;
    bool has_weight = false;
    double weight = 1.0;
    if (q != effective_end && *q == ':') {
      ++q;
      if (!parse_value(q, effective_end, &after, &weight)) {
        out->error = "libsvm: bad label:weight";
        return;
      }
      q = after;
      has_weight = true;
    }
    out->label.push_back(static_cast<float>(label));
    if (has_weight) {
      if (out->weight.size() != out->label.size() - 1) {
        out->error = "libsvm: label:weight must be set on every row or none";
        return;
      }
      out->weight.push_back(static_cast<float>(weight));
    } else if (!out->weight.empty()) {
      out->error = "libsvm: label:weight must be set on every row or none";
      return;
    }
    // qid
    while (q != effective_end && is_space(*q)) ++q;
    if (effective_end - q >= 4 && memcmp(q, "qid:", 4) == 0) {
      uint64_t qid;
      if (!parse_uint(q + 4, effective_end, &after, &qid)) {
        out->error = "libsvm: bad qid";
        return;
      }
      if (out->qid.size() != out->label.size() - 1) {
        out->error = "libsvm: qid must appear on every row or none";
        return;
      }
      out->qid.push_back(static_cast<int64_t>(qid));
      q = after;
    } else if (!out->qid.empty()) {
      out->error = "libsvm: qid must appear on every row or none";
      return;
    }
    // features
    int64_t nnz = 0;
    while (true) {
      uint64_t idx;
      if (!parse_uint(q, effective_end, &after, &idx)) break;
      q = after;
      out->index.push_back(idx);
      if (idx < out->min_index) out->min_index = idx;
      ++nnz;
      if (q != effective_end && *q == ':') {
        double v;
        ++q;
        if (!parse_value(q, effective_end, &after, &v)) {
          out->error = "libsvm: bad idx:value";
          return;
        }
        q = after;
        // lazily promote to valued mode: backfill 1.0 for prior binary entries
        if (out->value.size() + 1 < out->index.size()) {
          out->value.resize(out->index.size() - 1, 1.0f);
        }
        out->value.push_back(static_cast<float>(v));
      } else if (!out->value.empty()) {
        out->value.push_back(1.0f);
      }
    }
    // anything left that is not whitespace is malformed — error rather than
    // silently truncating the row (the fallback engine errors too)
    while (q != effective_end && is_space(*q)) ++q;
    if (q != effective_end) {
      out->error = "libsvm: malformed feature token";
      return;
    }
    out->row_nnz.push_back(nnz);
    p = lend;
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
  }
  // if any entry anywhere had a value, sizes must match
  if (!out->value.empty() && out->value.size() != out->index.size()) {
    out->value.resize(out->index.size(), 1.0f);
  }
}

// ---------------- libfm ----------------

static void parse_libfm_range(const char* begin, const char* end, CsrPart* out) {
  const bool has_cr =
      memchr(begin, '\r', static_cast<size_t>(end - begin)) != nullptr;
  const char* p = begin;
  {
    size_t rows = count_byte(begin, end, '\n') + 1;
    size_t entries = count_byte(begin, end, ':') / 2 + 1;  // two ':' per triple
    out->row_nnz.reserve(rows);
    out->label.reserve(rows);
    out->field.reserve(entries);
    out->index.reserve(entries);
    out->value.reserve(entries);
  }
  while (p < end) {
    const char* lend = line_end_fast(p, end, has_cr);
    const char* q = p;
    const char* hash = static_cast<const char*>(memchr(q, '#', lend - q));
    const char* effective_end = hash ? hash : lend;
    double label;
    const char* after;
    if (!parse_value(q, effective_end, &after, &label)) {
      p = lend;
      while (p < end && (*p == '\n' || *p == '\r')) ++p;
      continue;
    }
    q = after;
    out->label.push_back(static_cast<float>(label));
    int64_t nnz = 0;
    while (true) {
      uint64_t fld, idx;
      double v;
      if (!parse_uint(q, effective_end, &after, &fld)) break;
      q = after;
      if (q == effective_end || *q != ':' ||
          !parse_uint(q + 1, effective_end, &after, &idx)) {
        out->error = "libfm: features must be field:index:value triples";
        return;
      }
      q = after;
      if (q == effective_end || *q != ':' ||
          !parse_value(q + 1, effective_end, &after, &v)) {
        out->error = "libfm: features must be field:index:value triples";
        return;
      }
      q = after;
      out->field.push_back(fld);
      out->index.push_back(idx);
      out->value.push_back(static_cast<float>(v));
      if (idx < out->min_index) out->min_index = idx;
      if (fld < out->min_field) out->min_field = fld;
      ++nnz;
    }
    while (q != effective_end && is_space(*q)) ++q;
    if (q != effective_end) {
      out->error = "libfm: malformed feature token";
      return;
    }
    out->row_nnz.push_back(nnz);
    p = lend;
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
  }
}

// ---------------- libsvm -> dense ----------------
//
// TPU-first fast path: parse straight into the row-major [n, num_col] device
// layout, skipping CSR index/offset materialization (for HIGGS-shaped data
// the uint64 index array alone is 2x the bytes of the values). Rows are
// buffered with stride num_col+1 so the 1-based->0-based indexing decision
// (which needs the global min index, libsvm_parser.h:159-168) reduces to a
// column offset chosen at merge time. DensePart lives in parse_internal.h
// so the streaming reader can consume parts without the merge copy.

// Dense scanner. PRECONDITION: every line in [begin, end) is
// EOL-terminated IN-BUFFER (the last byte of the range is '\n' or '\r').
// That sentinel removes every per-iteration bounds check from the token
// loops and the per-line memchr line-end pre-scan — digit/space runs stop
// at the EOL byte naturally. Callers guarantee the invariant by splitting
// off a possibly-unterminated tail line (parse_libsvm_dense_chunk).
static void parse_libsvm_dense_range(const char* begin, const char* end,
                                            int64_t num_col, DensePart* out) {
  const char* p = begin;
  const size_t stride = static_cast<size_t>(num_col) + 1;
  {
    size_t rows = count_byte(begin, end, '\n') + 1;
    // cap the up-front reservation (64 MB of floats): mostly-blank input
    // with a huge num_col must not turn a hint into a multi-GB allocation
    size_t cap = (size_t(1) << 24) / stride + 1;
    out->x.reserve((rows < cap ? rows : cap) * stride);
    out->label.reserve(rows);
  }
  uint64_t min_index = out->min_index;
  while (p < end) {
    if (*p == '\n' || *p == '\r') { ++p; continue; }
    const char* q = p;
    double label;
    const char* after;
    if (!parse_value_hot(q, end, &after, &label)) {
      // blank, comment-only, or garbage line: skip to EOL (parity with the
      // CSR scanner's failed-label skip)
      while (*q != '\n' && *q != '\r') ++q;
      p = q;
      continue;
    }
    q = after;
    bool has_weight = false;
    double weight = 1.0;
    if (*q == ':') {
      ++q;
      if (!parse_value_hot(q, end, &after, &weight)) {
        out->error = "libsvm: bad label:weight";
        return;
      }
      q = after;
      has_weight = true;
    }
    out->label.push_back(static_cast<float>(label));
    if (has_weight) {
      if (out->weight.size() != out->label.size() - 1) {
        out->error = "libsvm: label:weight must be set on every row or none";
        return;
      }
      out->weight.push_back(static_cast<float>(weight));
    } else if (!out->weight.empty()) {
      out->error = "libsvm: label:weight must be set on every row or none";
      return;
    }
    while (is_space(*q)) ++q;
    if (end - q >= 4 && memcmp(q, "qid:", 4) == 0) {
      // qid has no dense analog; signal the caller to use the CSR path
      out->error = "libsvm-dense: qid not supported";
      out->needs_csr = true;
      return;
    }
    size_t base = out->x.size();
    out->x.resize(base + stride, 0.0f);
    float* xrow = out->x.data() + base;
    while (true) {
      // inline unsigned-int parse: digits only; the EOL sentinel stops
      // the run (SWAR digit counting measured slower here: 1-2 digit
      // indices are cheaper in the scalar loop than the classify+ctz chain)
      unsigned c = static_cast<unsigned char>(*q) - '0';
      if (c > 9) break;
      uint64_t idx = c;
      ++q;
      while ((c = static_cast<unsigned char>(*q) - '0') <= 9) {
        idx = idx * 10 + c;
        ++q;
      }
      if (idx < min_index) min_index = idx;
      double v = 1.0;
      if (*q == ':') {
        ++q;
        if (!parse_value_hot(q, end, &after, &v)) {
          out->error = "libsvm: bad idx:value";
          out->min_index = min_index;
          return;
        }
        q = after;
      }
      if (idx < stride) xrow[idx] = static_cast<float>(v);
      while (is_space(*q)) ++q;
    }
    while (is_space(*q)) ++q;
    if (*q != '\n' && *q != '\r') {
      if (*q == '#') {  // trailing comment is fine; garbage is not
        while (*q != '\n' && *q != '\r') ++q;
      } else {
        out->error = "libsvm: malformed feature token";
        out->min_index = min_index;
        return;
      }
    }
    p = q;
  }
  out->min_index = min_index;
}

// ---------------- csv ----------------

struct CsvPart {
  std::vector<float> cells;
  int64_t ncol = -1;
  int64_t nrow = 0;
  std::string error;
};

static void parse_csv_range(const char* begin, const char* end, char delim,
                            CsvPart* out) {
  const bool has_cr =
      memchr(begin, '\r', static_cast<size_t>(end - begin)) != nullptr;
  const char* p = begin;
  while (p < end) {
    const char* lend = line_end_fast(p, end, has_cr);
    if (lend == p) {
      ++p;
      continue;
    }
    int64_t cols = 0;
    const char* q = p;
    while (true) {
      // leading space that is not itself the delimiter (tab can be one)
      while (q != lend && is_space(*q) && *q != delim) ++q;
      double v = 0.0;
      const char* after;
      if (q == lend || *q == delim) {
        out->error = "csv: empty cell in row";
        return;
      }
      if (!parse_value(q, lend, &after, &v)) {
        out->error = "csv: unparseable cell in row";
        return;
      }
      q = after;
      out->cells.push_back(static_cast<float>(v));
      ++cols;
      while (q != lend && is_space(*q) && *q != delim) ++q;
      if (q == lend) break;
      if (*q == delim) { ++q; continue; }
      out->error = "csv: unexpected character in row";
      return;
    }
    if (out->ncol < 0) {
      out->ncol = cols;
    } else if (cols != out->ncol) {
      out->error = "csv: ragged rows in chunk";
      return;
    }
    ++out->nrow;
    p = lend;
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
  }
}

// Run a range-parser body capturing any exception (bad_alloc on degenerate
// input) into the part's error field — an exception escaping a worker thread
// or the extern "C" boundary would std::terminate the embedding Python
// process.
template <typename Body>
static void guard_into(std::string* err, Body body) {
  try {
    body();
  } catch (const std::exception& ex) {
    *err = std::string("parse failed: ") + ex.what();
  } catch (...) {
    *err = "parse failed: unknown error";
  }
}
static void parse_libsvm_range_guarded(const char* b, const char* e,
                                       CsrPart* out) {
  guard_into(&out->error, [&] { parse_libsvm_range(b, e, out); });
}
static void parse_libfm_range_guarded(const char* b, const char* e,
                                      CsrPart* out) {
  guard_into(&out->error, [&] { parse_libfm_range(b, e, out); });
}
static void parse_libsvm_dense_range_guarded(const char* b, const char* e,
                                             int64_t num_col, DensePart* out) {
  guard_into(&out->error, [&] { parse_libsvm_dense_range(b, e, num_col, out); });
}
static void parse_csv_range_guarded(const char* b, const char* e, char delim,
                                    CsvPart* out) {
  guard_into(&out->error, [&] { parse_csv_range(b, e, delim, out); });
}

static const char* skip_bom(const char* data, const char** end) {
  if (*end - data >= 3 && memcmp(data, "\xef\xbb\xbf", 3) == 0) return data + 3;
  return data;
}

void parse_libsvm_dense_chunk(const char* data, int64_t len, int nthread,
                              int64_t num_col, std::vector<DensePart>* parts) {
  const char* end = data + len;
  data = skip_bom(data, &end);
  // The dense scanner requires every line EOL-terminated in-buffer: split
  // off an unterminated final line and parse it from a '\n'-padded copy.
  const char* bulk_end = end;
  while (bulk_end > data && bulk_end[-1] != '\n' && bulk_end[-1] != '\r')
    --bulk_end;
  std::string tail_buf;
  if (bulk_end != end) {
    tail_buf.assign(bulk_end, end);
    tail_buf.push_back('\n');
  }
  if (nthread < 1) nthread = 1;
  nthread = clamp_threads(nthread, static_cast<size_t>(bulk_end - data));
  auto ranges = split_lines(data, bulk_end, nthread);
  parts->resize(ranges.size() + (tail_buf.empty() ? 0 : 1));
  std::vector<std::thread> threads;
  for (size_t i = 1; i < ranges.size(); ++i) {
    threads.emplace_back(parse_libsvm_dense_range_guarded, ranges[i].first,
                         ranges[i].second, num_col, &(*parts)[i]);
  }
  if (!tail_buf.empty()) {
    parse_libsvm_dense_range_guarded(tail_buf.data(),
                                     tail_buf.data() + tail_buf.size(),
                                     num_col, &parts->back());
  }
  if (!ranges.empty())
    parse_libsvm_dense_range_guarded(ranges[0].first, ranges[0].second,
                                     num_col, &(*parts)[0]);
  for (auto& t : threads) t.join();
}

}  // namespace dmlc_tpu

// ---------------- C ABI ----------------

using namespace dmlc_tpu;

extern "C" {

static char* dup_error(const std::string& s) {
  char* e = static_cast<char*>(malloc(s.size() + 1));
  if (e) memcpy(e, s.c_str(), s.size() + 1);
  return e;  // null only under OOM; callers treat a null error as set-failed
}

static CsrBlockResult* merge_parts(std::vector<CsrPart>& parts, int indexing_mode,
                                   bool heuristic_needs_field) {
  auto* res = static_cast<CsrBlockResult*>(calloc(1, sizeof(CsrBlockResult)));
  for (auto& part : parts) {
    if (!part.error.empty()) {
      res->error = dup_error(part.error);
      return res;
    }
  }
  int64_t n = 0, nnz = 0;
  bool any_weight = false, any_qid = false, any_value = false, any_field = false;
  uint64_t min_index = UINT64_MAX, min_field = UINT64_MAX;
  for (auto& part : parts) {
    n += static_cast<int64_t>(part.label.size());
    nnz += static_cast<int64_t>(part.index.size());
    any_weight |= !part.weight.empty();
    any_qid |= !part.qid.empty();
    any_value |= !part.value.empty();
    any_field |= !part.field.empty();
    if (part.min_index < min_index) min_index = part.min_index;
    if (part.min_field < min_field) min_field = part.min_field;
  }
  // all-or-none consistency across thread ranges. The format name follows
  // heuristic_needs_field (true == libfm; today the libfm scanner emits no
  // weights/qids, so these fire only for libsvm — the parameterization
  // keeps the message right if libfm weight syntax is ever wired up)
  const char* fmt = heuristic_needs_field ? "libfm" : "libsvm";
  for (auto& part : parts) {
    if (!part.label.empty()) {
      if (any_weight && part.weight.size() != part.label.size()) {
        res->error = dup_error(std::string(fmt) +
            ": label:weight must be set on every row or none");
        return res;
      }
      if (any_qid && part.qid.size() != part.label.size()) {
        res->error = dup_error(std::string(fmt) +
            ": qid must appear on every row or none");
        return res;
      }
    }
    if (any_value && !part.index.empty() && part.value.empty()) {
      part.value.resize(part.index.size(), 1.0f);
    }
  }
  res->n_rows = n;
  res->nnz = nnz;
  res->offset = static_cast<int64_t*>(malloc((n + 1) * sizeof(int64_t)));
  res->label = static_cast<float*>(malloc(n * sizeof(float)));
  if (any_weight) res->weight = static_cast<float*>(malloc(n * sizeof(float)));
  if (any_qid) res->qid = static_cast<int64_t*>(malloc(n * sizeof(int64_t)));
  res->index = static_cast<uint64_t*>(malloc(nnz * sizeof(uint64_t)));
  if (any_field) res->field = static_cast<uint64_t*>(malloc(nnz * sizeof(uint64_t)));
  if (any_value) res->value = static_cast<float*>(malloc(nnz * sizeof(float)));
  // a failed allocation must come back as an error result, not a segfault
  // in the embedding Python process
  if (!res->offset || !res->label || (any_weight && !res->weight) ||
      (any_qid && !res->qid) || !res->index || (any_field && !res->field) ||
      (any_value && !res->value)) {
    free(res->offset); free(res->label); free(res->weight); free(res->qid);
    free(res->index); free(res->field); free(res->value);
    memset(res, 0, sizeof(*res));
    res->error = dup_error("parse: out of memory merging chunk");
    return res;
  }
  int64_t row = 0, ent = 0;
  res->offset[0] = 0;
  for (auto& part : parts) {
    size_t pn = part.label.size();
    if (pn) {
      memcpy(res->label + row, part.label.data(), pn * sizeof(float));
      if (any_weight) memcpy(res->weight + row, part.weight.data(), pn * sizeof(float));
      if (any_qid) memcpy(res->qid + row, part.qid.data(), pn * sizeof(int64_t));
      for (size_t i = 0; i < pn; ++i) {
        res->offset[row + 1 + static_cast<int64_t>(i)] =
            res->offset[row + static_cast<int64_t>(i)] + part.row_nnz[i];
      }
      row += static_cast<int64_t>(pn);
    }
    size_t pe = part.index.size();
    if (pe) {
      memcpy(res->index + ent, part.index.data(), pe * sizeof(uint64_t));
      if (any_field) memcpy(res->field + ent, part.field.data(), pe * sizeof(uint64_t));
      if (any_value) memcpy(res->value + ent, part.value.data(), pe * sizeof(float));
      ent += static_cast<int64_t>(pe);
    }
  }
  // indexing mode conversion (libsvm_parser.h:159-168 / libfm_parser.h:130-143)
  bool convert = indexing_mode > 0;
  if (indexing_mode < 0 && nnz > 0 && min_index > 0) {
    convert = !heuristic_needs_field || min_field > 0;
  }
  if (convert) {
    for (int64_t i = 0; i < nnz; ++i) res->index[i] -= 1;
    if (res->field && heuristic_needs_field) {
      for (int64_t i = 0; i < nnz; ++i) res->field[i] -= 1;
    }
  }
  return res;
}

CsrBlockResult* dmlc_parse_libsvm(const char* data, int64_t len, int nthread,
                                  int indexing_mode) {
  const char* end = data + len;
  data = skip_bom(data, &end);
  if (nthread < 1) nthread = 1;
  nthread = clamp_threads(nthread, static_cast<size_t>(end - data));
  auto ranges = split_lines(data, end, nthread);
  std::vector<CsrPart> parts(ranges.size());
  std::vector<std::thread> threads;
  for (size_t i = 1; i < ranges.size(); ++i) {
    threads.emplace_back(parse_libsvm_range_guarded, ranges[i].first,
                         ranges[i].second, &parts[i]);
  }
  if (!ranges.empty())
    parse_libsvm_range_guarded(ranges[0].first, ranges[0].second, &parts[0]);
  for (auto& t : threads) t.join();
  return merge_parts(parts, indexing_mode, false);
}

CsrBlockResult* dmlc_parse_libfm(const char* data, int64_t len, int nthread,
                                 int indexing_mode) {
  const char* end = data + len;
  data = skip_bom(data, &end);
  if (nthread < 1) nthread = 1;
  nthread = clamp_threads(nthread, static_cast<size_t>(end - data));
  auto ranges = split_lines(data, end, nthread);
  std::vector<CsrPart> parts(ranges.size());
  std::vector<std::thread> threads;
  for (size_t i = 1; i < ranges.size(); ++i) {
    threads.emplace_back(parse_libfm_range_guarded, ranges[i].first,
                         ranges[i].second, &parts[i]);
  }
  if (!ranges.empty())
    parse_libfm_range_guarded(ranges[0].first, ranges[0].second, &parts[0]);
  for (auto& t : threads) t.join();
  return merge_parts(parts, indexing_mode, true);
}

// ---------------- text -> COO (device-ready sparse batch) ----------------
//
// TPU-first path for high-dim sparse corpora (KDD2012 libfm -> BCOO,
// BASELINE config #4): assemble the exact arrays jax.experimental.sparse
// wants — int32 (row, col) coordinate pairs, f32 values (or elided when all
// ones), f32 label/weight — in ONE fused pass over the per-thread parse
// parts, with bucketed shape padding. Replaces the numpy coordinate
// assembly (ops/sparse.py block_to_bcoo_host) that serialized with parsing
// on one-core hosts; here it runs at C++ speed with no temporaries.

static int64_t round_up_bucket(int64_t v, int64_t bucket) {
  if (bucket <= 0) return v;
  int64_t base = v > 1 ? v : 1;  // never a zero-size dim (matches Python)
  return (base + bucket - 1) / bucket * bucket;
}

static CooResult* merge_parts_coo(std::vector<CsrPart>& parts,
                                  int indexing_mode, bool heuristic_needs_field,
                                  int64_t num_col, int64_t row_bucket,
                                  int64_t nnz_bucket, bool elide_unit,
                                  bool csr_wire) {
  auto* res = static_cast<CooResult*>(calloc(1, sizeof(CooResult)));
  if (!res) return nullptr;
  for (auto& part : parts) {
    if (!part.error.empty()) {
      res->error = dup_error(part.error);
      return res;
    }
  }
  int64_t n = 0, nnz = 0;
  bool any_weight = false, any_value = false;
  uint64_t min_index = UINT64_MAX, min_field = UINT64_MAX;
  for (auto& part : parts) {
    n += static_cast<int64_t>(part.label.size());
    nnz += static_cast<int64_t>(part.index.size());
    any_weight |= !part.weight.empty();
    any_value |= !part.value.empty();
    if (part.min_index < min_index) min_index = part.min_index;
    if (part.min_field < min_field) min_field = part.min_field;
  }
  for (auto& part : parts) {
    if (any_weight && !part.label.empty() &&
        part.weight.size() != part.label.size()) {
      // format name follows heuristic_needs_field (true == libfm), same
      // rationale as merge_parts above
      res->error = dup_error(
          std::string(heuristic_needs_field ? "libfm" : "libsvm") +
          ": label:weight must be set on every row or none");
      return res;
    }
  }
  res->n_rows = n;
  res->nnz = nnz;
  if (n == 0) return res;  // blank chunk: dropped by the produce loop
  const int64_t rows_out = round_up_bucket(n, row_bucket);
  const int64_t nnz_out =
      nnz_bucket > 0 ? round_up_bucket(nnz, nnz_bucket) : nnz;
  res->rows_padded = rows_out;
  res->nnz_padded = nnz_out;
  // unit-value elision: all-binary input (no explicit values) or every
  // explicit value == 1.0f — the consumer synthesizes ones on device
  bool elide = elide_unit;
  if (elide && any_value) {
    for (auto& part : parts) {
      for (float v : part.value) {
        if (v != 1.0f) { elide = false; break; }
      }
      if (!elide) break;
    }
  }
  res->values_elided = elide ? 1 : 0;
  // malloc(0) may legally return NULL — label-only chunks (nnz == 0 with
  // buckets disabled) must not read as out-of-memory
  const size_t nnz_alloc = nnz_out > 0 ? static_cast<size_t>(nnz_out) : 1;
  res->csr_wire = csr_wire ? 1 : 0;
  // bucket-padded sizes repeat across chunks, so these buffers recycle
  // through the size-keyed pool (buffer_pool.h) instead of paying
  // glibc's mmap round trip per batch
  res->coords = static_cast<int32_t*>(
      dmlc_pool_alloc((csr_wire ? 1 : 2) * nnz_alloc * sizeof(int32_t)));
  if (csr_wire)
    res->row_ptr = static_cast<int32_t*>(
        dmlc_pool_alloc((rows_out + 1) * sizeof(int32_t)));
  if (!elide)
    res->values =
        static_cast<float*>(dmlc_pool_alloc(nnz_alloc * sizeof(float)));
  res->label = static_cast<float*>(dmlc_pool_alloc(rows_out * sizeof(float)));
  res->weight = static_cast<float*>(dmlc_pool_alloc(rows_out * sizeof(float)));
  if (!res->coords || (csr_wire && !res->row_ptr) ||
      (!elide && !res->values) || !res->label || !res->weight) {
    dmlc_pool_free(res->coords); dmlc_pool_free(res->row_ptr);
    dmlc_pool_free(res->values);
    dmlc_pool_free(res->label); dmlc_pool_free(res->weight);
    res->coords = nullptr; res->row_ptr = nullptr; res->values = nullptr;
    res->label = nullptr; res->weight = nullptr;
    res->error = dup_error("parse: out of memory building coo chunk");
    return res;
  }
  // indexing conversion heuristic, same decision as merge_parts
  // (libsvm_parser.h:159-168 / libfm_parser.h:130-143)
  bool convert = indexing_mode > 0;
  if (indexing_mode < 0 && nnz > 0 && min_index > 0) {
    convert = !heuristic_needs_field || min_field > 0;
  }
  const uint64_t off = convert ? 1 : 0;
  // column OOB sentinel: entries past the declared width clamp to num_col
  // (masked by every BCOO op) — also keeps int32 from overflowing on
  // out-of-spec indices
  const uint64_t col_max = static_cast<uint64_t>(num_col);
  int64_t row = 0, ent = 0;
  for (auto& part : parts) {
    const size_t pn = part.label.size();
    if (pn) {
      memcpy(res->label + row, part.label.data(), pn * sizeof(float));
      if (any_weight) {
        memcpy(res->weight + row, part.weight.data(), pn * sizeof(float));
      } else {
        for (size_t i = 0; i < pn; ++i) res->weight[row + i] = 1.0f;
      }
    }
    if (csr_wire) {
      // CSR wire: cumulative row_ptr instead of per-entry row ids —
      // O(rows) writes instead of O(nnz), and half the coordinate bytes
      // on the wire; the consumer rebuilds row ids on device
      for (size_t i = 0; i < pn; ++i) {
        res->row_ptr[row + static_cast<int64_t>(i)] =
            static_cast<int32_t>(ent);
        ent += part.row_nnz[i];
      }
    } else {
      for (size_t i = 0; i < pn; ++i) {
        const int64_t rn = part.row_nnz[i];
        const int32_t r32 =
            static_cast<int32_t>(row + static_cast<int64_t>(i));
        for (int64_t k = 0; k < rn; ++k) {
          res->coords[2 * ent] = r32;
          ++ent;
        }
      }
    }
    row += static_cast<int64_t>(pn);
  }
  if (csr_wire) {
    // rows [n, rows_out] (pad rows + the end sentinel) all start at nnz:
    // the device-side prefix-sum rebuild then maps every pad entry past
    // nnz to the OOB row rows_out, which every BCOO op masks
    for (int64_t i = n; i <= rows_out; ++i)
      res->row_ptr[i] = static_cast<int32_t>(nnz);
  }
  const int64_t cstride = csr_wire ? 1 : 2;
  const int64_t coff = csr_wire ? 0 : 1;
  // column pass: sequential over each part's index array (better locality
  // than interleaving with the row fill above)
  ent = 0;
  for (auto& part : parts) {
    const size_t pe = part.index.size();
    for (size_t i = 0; i < pe; ++i) {
      uint64_t c = part.index[i] - off;
      res->coords[cstride * ent + coff] =
          c > col_max ? static_cast<int32_t>(col_max)
                      : static_cast<int32_t>(c);
      ++ent;
    }
    if (!elide) {
      if (part.value.empty()) {  // all-binary part: implicit ones
        const size_t base = ent - pe;
        for (size_t i = 0; i < pe; ++i) res->values[base + i] = 1.0f;
      } else {
        memcpy(res->values + (ent - pe), part.value.data(),
               pe * sizeof(float));
      }
    }
  }
  // padding: OOB coords (rows_out, num_col), zero values/label/weight;
  // csr_wire pads cols only — the pad rows fall out of the row_ptr
  // sentinel fill above
  for (int64_t i = nnz; i < nnz_out; ++i) {
    if (csr_wire) {
      res->coords[i] = static_cast<int32_t>(col_max);
    } else {
      res->coords[2 * i] = static_cast<int32_t>(rows_out);
      res->coords[2 * i + 1] = static_cast<int32_t>(col_max);
    }
  }
  if (!elide && nnz_out > nnz) {
    memset(res->values + nnz, 0, (nnz_out - nnz) * sizeof(float));
  }
  if (rows_out > n) {
    memset(res->label + n, 0, (rows_out - n) * sizeof(float));
    memset(res->weight + n, 0, (rows_out - n) * sizeof(float));
  }
  return res;
}

CooResult* dmlc_parse_coo(const char* data, int64_t len, int nthread,
                          int indexing_mode, int fmt, int64_t num_col,
                          int64_t row_bucket, int64_t nnz_bucket,
                          int32_t elide_unit, int32_t csr_wire) {
  const char* end = data + len;
  data = skip_bom(data, &end);
  if (nthread < 1) nthread = 1;
  nthread = clamp_threads(nthread, static_cast<size_t>(end - data));
  auto ranges = split_lines(data, end, nthread);
  std::vector<CsrPart> parts(ranges.size());
  std::vector<std::thread> threads;
  const bool libfm = fmt == 3;
  auto range_fn =
      libfm ? parse_libfm_range_guarded : parse_libsvm_range_guarded;
  for (size_t i = 1; i < ranges.size(); ++i) {
    threads.emplace_back(range_fn, ranges[i].first, ranges[i].second,
                         &parts[i]);
  }
  if (!ranges.empty())
    range_fn(ranges[0].first, ranges[0].second, &parts[0]);
  for (auto& t : threads) t.join();
  return merge_parts_coo(parts, indexing_mode, libfm, num_col, row_bucket,
                         nnz_bucket, elide_unit != 0, csr_wire != 0);
}

void dmlc_free_coo(CooResult* r) {
  if (!r) return;
  dmlc_pool_free(r->coords); dmlc_pool_free(r->row_ptr);
  dmlc_pool_free(r->values);
  dmlc_pool_free(r->label); dmlc_pool_free(r->weight);
  free(r->error);
  free(r);
}

DenseResult* dmlc_parse_libsvm_dense(const char* data, int64_t len, int nthread,
                                     int64_t num_col, int indexing_mode) {
  std::vector<DensePart> parts;
  parse_libsvm_dense_chunk(data, len, nthread, num_col, &parts);

  auto* res = static_cast<DenseResult*>(calloc(1, sizeof(DenseResult)));
  if (!res) return nullptr;
  res->n_cols = num_col;
  int64_t n = 0;
  bool any_weight = false;
  uint64_t min_index = UINT64_MAX;
  for (auto& part : parts) {
    if (!part.error.empty()) {
      res->error = dup_error(part.error);
      res->needs_csr = part.needs_csr ? 1 : 0;
      return res;
    }
    n += static_cast<int64_t>(part.label.size());
    any_weight |= !part.weight.empty();
    if (part.min_index < min_index) min_index = part.min_index;
  }
  for (auto& part : parts) {
    if (any_weight && !part.label.empty() &&
        part.weight.size() != part.label.size()) {
      res->error = dup_error("libsvm: label:weight must be set on every row or none");
      return res;
    }
  }
  // 1-based -> 0-based conversion becomes a column offset into the
  // stride-(num_col+1) part buffers (libsvm_parser.h:159-168 heuristic)
  bool convert = indexing_mode > 0 ||
      (indexing_mode < 0 && min_index != UINT64_MAX && min_index > 0);
  const size_t off = convert ? 1 : 0;
  const size_t stride = static_cast<size_t>(num_col) + 1;
  res->n_rows = n;
  res->x = static_cast<float*>(
      dmlc_pool_alloc(static_cast<size_t>(n) * num_col * sizeof(float)));
  res->label = static_cast<float*>(dmlc_pool_alloc(n * sizeof(float)));
  if (any_weight)
    res->weight = static_cast<float*>(dmlc_pool_alloc(n * sizeof(float)));
  if (!res->x || !res->label || (any_weight && !res->weight)) {
    dmlc_pool_free(res->x); dmlc_pool_free(res->label);
    dmlc_pool_free(res->weight);
    memset(res, 0, sizeof(*res));
    res->n_cols = num_col;
    res->error = dup_error("parse: out of memory merging chunk");
    return res;
  }
  int64_t row = 0;
  for (auto& part : parts) {
    size_t pn = part.label.size();
    if (!pn) continue;
    memcpy(res->label + row, part.label.data(), pn * sizeof(float));
    if (any_weight) memcpy(res->weight + row, part.weight.data(), pn * sizeof(float));
    for (size_t i = 0; i < pn; ++i) {
      memcpy(res->x + (row + static_cast<int64_t>(i)) * num_col,
             part.x.data() + i * stride + off, num_col * sizeof(float));
    }
    row += static_cast<int64_t>(pn);
  }
  return res;
}

void dmlc_free_dense(DenseResult* r) {
  if (!r) return;
  dmlc_pool_free(r->x); dmlc_pool_free(r->label); dmlc_pool_free(r->weight);
  free(r->error);
  free(r);
}

CsvResult* dmlc_parse_csv(const char* data, int64_t len, int nthread, char delim) {
  const char* end = data + len;
  data = skip_bom(data, &end);
  if (nthread < 1) nthread = 1;
  nthread = clamp_threads(nthread, static_cast<size_t>(end - data));
  auto ranges = split_lines(data, end, nthread);
  std::vector<CsvPart> parts(ranges.size());
  std::vector<std::thread> threads;
  for (size_t i = 1; i < ranges.size(); ++i) {
    threads.emplace_back(parse_csv_range_guarded, ranges[i].first,
                         ranges[i].second, delim, &parts[i]);
  }
  if (!ranges.empty())
    parse_csv_range_guarded(ranges[0].first, ranges[0].second, delim,
                            &parts[0]);
  for (auto& t : threads) t.join();
  auto* res = static_cast<CsvResult*>(calloc(1, sizeof(CsvResult)));
  int64_t ncol = -1, nrow = 0, ncell = 0;
  for (auto& part : parts) {
    if (!part.error.empty()) {
      res->error = dup_error(part.error);
      return res;
    }
    if (part.nrow == 0) continue;
    if (ncol < 0) ncol = part.ncol;
    if (part.ncol != ncol) {
      res->error = dup_error("csv: ragged rows in chunk");
      return res;
    }
    nrow += part.nrow;
    ncell += static_cast<int64_t>(part.cells.size());
  }
  res->n_rows = nrow;
  res->n_cols = ncol < 0 ? 0 : ncol;
  res->cells = static_cast<float*>(malloc(ncell * sizeof(float)));
  if (!res->cells && ncell > 0) {
    memset(res, 0, sizeof(*res));
    res->error = dup_error("parse: out of memory merging chunk");
    return res;
  }
  int64_t at = 0;
  for (auto& part : parts) {
    if (part.cells.empty()) continue;
    memcpy(res->cells + at, part.cells.data(), part.cells.size() * sizeof(float));
    at += static_cast<int64_t>(part.cells.size());
  }
  return res;
}

void dmlc_free_block(CsrBlockResult* r) {
  if (!r) return;
  free(r->offset); free(r->label); free(r->weight); free(r->qid);
  free(r->index); free(r->field); free(r->value); free(r->error);
  free(r);
}

void dmlc_free_csv(CsvResult* r) {
  if (!r) return;
  free(r->cells); free(r->error);
  free(r);
}

static CsvSplitResult* csv_split_error(CsvSplitResult* res, const char* msg) {
  free(res->values); free(res->label); free(res->weight);
  res->values = res->label = res->weight = nullptr;
  res->n_rows = res->n_feat_cols = 0;
  res->error = dup_error(msg);
  return res;
}

CsvSplitResult* dmlc_parse_csv_split(const char* data, int64_t len, int nthread,
                                     char delim, int32_t label_col,
                                     int32_t weight_col) {
  // scan phase identical to dmlc_parse_csv (shared per-range scanner); the
  // split happens in the merge pass, which already touches every cell once
  const char* end = data + len;
  data = skip_bom(data, &end);
  if (nthread < 1) nthread = 1;
  nthread = clamp_threads(nthread, static_cast<size_t>(end - data));
  auto ranges = split_lines(data, end, nthread);
  std::vector<CsvPart> parts(ranges.size());
  std::vector<std::thread> threads;
  for (size_t i = 1; i < ranges.size(); ++i) {
    threads.emplace_back(parse_csv_range_guarded, ranges[i].first,
                         ranges[i].second, delim, &parts[i]);
  }
  if (!ranges.empty())
    parse_csv_range_guarded(ranges[0].first, ranges[0].second, delim,
                            &parts[0]);
  for (auto& t : threads) t.join();
  auto* res = static_cast<CsvSplitResult*>(calloc(1, sizeof(CsvSplitResult)));
  if (!res) return nullptr;
  int64_t ncol = -1, nrow = 0;
  for (auto& part : parts) {
    if (!part.error.empty()) return csv_split_error(res, part.error.c_str());
    if (part.nrow == 0) continue;
    if (ncol < 0) ncol = part.ncol;
    if (part.ncol != ncol)
      return csv_split_error(res, "csv: ragged rows in chunk");
    nrow += part.nrow;
  }
  if (nrow == 0 || ncol <= 0) return res;  // blank chunk
  if (label_col >= ncol || weight_col >= ncol)
    return csv_split_error(res, "csv: label/weight column out of range");
  if (label_col >= 0 && label_col == weight_col)
    // the Python layer validates this too, but the C ABI must be safe on
    // its own: equal columns would decrement k twice while the run
    // builder skips the column once — an out-of-bounds write per row
    return csv_split_error(res, "csv: label_column must differ from weight_column");
  const int lc = label_col, wc = weight_col;
  const int64_t k = ncol - (lc >= 0 ? 1 : 0) - (wc >= 0 ? 1 : 0);
  res->n_rows = nrow;
  res->n_feat_cols = k;
  res->values = static_cast<float*>(malloc(nrow * k * sizeof(float)));
  res->label = lc >= 0 ? static_cast<float*>(malloc(nrow * sizeof(float)))
                       : nullptr;
  res->weight = wc >= 0 ? static_cast<float*>(malloc(nrow * sizeof(float)))
                        : nullptr;
  if ((k > 0 && !res->values) || (lc >= 0 && !res->label) ||
      (wc >= 0 && !res->weight))
    return csv_split_error(res, "parse: out of memory merging chunk");
  // feature columns form <=3 contiguous runs around the label/weight
  // columns; copy run-wise per row (memcpy for all but one-or-two cells)
  int64_t runs[3][2];
  int nruns = 0;
  int64_t at = 0;
  while (at < ncol) {
    if (at == lc || at == wc) { ++at; continue; }
    int64_t hi = at;
    while (hi < ncol && hi != lc && hi != wc) ++hi;
    runs[nruns][0] = at;
    runs[nruns][1] = hi - at;
    ++nruns;
    at = hi;
  }
  int64_t row = 0;
  for (auto& part : parts) {
    const float* cells = part.cells.data();
    for (int64_t i = 0; i < part.nrow; ++i, ++row) {
      const float* src = cells + i * ncol;
      float* dst = res->values + row * k;
      for (int rix = 0; rix < nruns; ++rix) {
        memcpy(dst, src + runs[rix][0],
               static_cast<size_t>(runs[rix][1]) * sizeof(float));
        dst += runs[rix][1];
      }
      if (lc >= 0) res->label[row] = src[lc];
      if (wc >= 0) res->weight[row] = src[wc];
    }
  }
  return res;
}

void dmlc_free_csv_split(CsvSplitResult* r) {
  if (!r) return;
  free(r->values); free(r->label); free(r->weight); free(r->error);
  free(r);
}

int dmlc_native_abi_version() { return 16; }

}  // extern "C"
