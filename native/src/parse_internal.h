// Internal interface between parse.cc and reader.cc (same .so) — lets the
// streaming reader consume per-thread DensePart buffers directly, skipping
// the merged DenseResult copy that the C ABI entry points produce for
// one-shot Python callers.
#ifndef DMLC_TPU_NATIVE_PARSE_INTERNAL_H_
#define DMLC_TPU_NATIVE_PARSE_INTERNAL_H_

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

namespace dmlc_tpu {

// The threads a text scanner fans a chunk of `len` bytes out to: one per
// 512 KB, at least one, at most `nthread`, so small chunks don't pay the
// thread spawn.
inline int parse_threads(int nthread, size_t len) {
  int by_size = static_cast<int>(len / (512 * 1024)) + 1;
  if (nthread < 1) nthread = 1;
  return nthread < by_size ? nthread : by_size;
}

// One thread-range of the dense libsvm scanner. Rows are buffered with
// stride num_col + 1 so the 1-based -> 0-based indexing decision (which
// needs the chunk-global min index, libsvm_parser.h:159-168) reduces to a
// column offset chosen after all ranges finish.
struct DensePart {
  std::vector<float> x;       // [nrow, num_col + 1] row-major
  std::vector<float> label;
  std::vector<float> weight;  // empty or per-row
  uint64_t min_index = UINT64_MAX;
  std::string error;
  bool needs_csr = false;  // data the dense layout can't express (qid rows)
};

// Parse a chunk into per-thread parts (bulk/tail split so every scanner
// range is EOL-terminated in-buffer, thread fan-out, BOM skip). Fills
// `parts`; any per-range error is left in that part's `error`.
void parse_libsvm_dense_chunk(const char* data, int64_t len, int nthread,
                              int64_t num_col, std::vector<DensePart>* parts);

}  // namespace dmlc_tpu

#endif  // DMLC_TPU_NATIVE_PARSE_INTERNAL_H_
