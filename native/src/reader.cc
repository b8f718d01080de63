// Native streaming reader: byte-range partitioned file reading + record
// boundary chunking + threaded parse, all off the Python thread.
//
// TPU-native rebuild of the reference read pipeline (src/io/
// input_split_base.cc + line_split.cc + threaded_input_split.h): one
// producer thread loads record-aligned chunks of this partition and parses
// each with the multi-threaded scanners in parse.cc, pushing parsed blocks
// into a bounded queue. The Python consumer pulls fully-parsed blocks with a
// single GIL-releasing ctypes call — so on a TPU-VM host the whole
// read+scan+parse path runs concurrently with JAX dispatch and host->HBM
// transfers.
//
// Partition invariants mirror the Python engine (dmlc_tpu/io/input_split.py)
// and therefore the reference:
//   - partition k of n owns bytes [k*step, (k+1)*step), step = ceil(total/n)
//     over the concatenation of all files (ResetPartition,
//     input_split_base.cc:30-64);
//   - both ends advance to the next record head unless they sit exactly on a
//     file boundary;
//   - '\n' is injected at text-file joins (input_split_base.cc:196-199,
//     PR#385) and when the final record lacks a newline
//     (input_split_base.cc:235-242, PR#452).

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <random>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "api.h"
#include "buffer_pool.h"

using dmlc_tpu::dmlc_pool_alloc;
using dmlc_tpu::dmlc_pool_free;
#include "parse_internal.h"

namespace {

constexpr int kFmtLibsvm = 0;
constexpr int kFmtLibsvmDense = 1;
constexpr int kFmtCsv = 2;
constexpr int kFmtLibfm = 3;
constexpr int kFmtRecordIO = 4;
constexpr int kFmtRecordIOChunk = 5;  // raw framed chunks, one per result
constexpr int kFmtLibsvmCoo = 6;      // device-ready COO (CooResult)
constexpr int kFmtLibfmCoo = 7;
constexpr int kFmtCsvSplit = 8;       // csv with label/weight split out
                                      // (CsvSplitResult) — auto-promoted
                                      // from kFmtCsv when label/weight
                                      // columns are configured and no
                                      // dense repack is requested

inline bool is_recordio_fmt(int format) {
  return format == kFmtRecordIO || format == kFmtRecordIOChunk;
}

void free_result(int format, void* res) {
  if (!res) return;
  switch (format) {
    case kFmtLibsvm:
    case kFmtLibfm:
      dmlc_free_block(static_cast<CsrBlockResult*>(res));
      break;
    case kFmtLibsvmDense:
      dmlc_free_dense(static_cast<DenseResult*>(res));
      break;
    case kFmtCsv:
      dmlc_free_csv(static_cast<CsvResult*>(res));
      break;
    case kFmtCsvSplit:
      dmlc_free_csv_split(static_cast<CsvSplitResult*>(res));
      break;
    case kFmtRecordIO:
    case kFmtRecordIOChunk:
      dmlc_free_records(static_cast<RecordBatchResult*>(res));
      break;
    case kFmtLibsvmCoo:
    case kFmtLibfmCoo:
      dmlc_free_coo(static_cast<CooResult*>(res));
      break;
  }
}

int64_t result_rows(int format, void* res) {
  switch (format) {
    case kFmtLibsvm:
    case kFmtLibfm:
      return static_cast<CsrBlockResult*>(res)->n_rows;
    case kFmtLibsvmDense:
      return static_cast<DenseResult*>(res)->n_rows;
    case kFmtCsv:
      return static_cast<CsvResult*>(res)->n_rows;
    case kFmtCsvSplit:
      return static_cast<CsvSplitResult*>(res)->n_rows;
    case kFmtRecordIO:
    case kFmtRecordIOChunk:
      return static_cast<RecordBatchResult*>(res)->n_records;
    case kFmtLibsvmCoo:
    case kFmtLibfmCoo:
      return static_cast<CooResult*>(res)->n_rows;
  }
  return 0;
}

const char* result_error(int format, void* res) {
  switch (format) {
    case kFmtLibsvm:
    case kFmtLibfm:
      return static_cast<CsrBlockResult*>(res)->error;
    case kFmtLibsvmDense:
      return static_cast<DenseResult*>(res)->error;
    case kFmtCsv:
      return static_cast<CsvResult*>(res)->error;
    case kFmtCsvSplit:
      return static_cast<CsvSplitResult*>(res)->error;
    case kFmtRecordIO:
    case kFmtRecordIOChunk:
      return static_cast<RecordBatchResult*>(res)->error;
    case kFmtLibsvmCoo:
    case kFmtLibfmCoo:
      return static_cast<CooResult*>(res)->error;
  }
  return nullptr;
}

inline bool is_eol(char c) { return c == '\n' || c == '\r'; }

// f32 -> bf16 with round-to-nearest-even (the TPU-native ingest format:
// half the host->HBM bytes; the MXU's preferred operand width)
inline uint16_t f32_to_bf16(float f) {
  uint32_t bits;
  memcpy(&bits, &f, 4);
  if ((bits & 0x7fffffffu) > 0x7f800000u) {
    // NaN: the rounding add below could carry a low-mantissa-only payload
    // into the exponent and emit Inf — quiet it instead (sign + high
    // mantissa kept, quiet bit set), matching ml_dtypes' cast
    return static_cast<uint16_t>((bits >> 16) | 0x0040u);
  }
  bits += 0x7fffu + ((bits >> 16) & 1u);
  return static_cast<uint16_t>(bits >> 16);
}

inline void convert_row_bf16(uint16_t* dst, const float* src, size_t n) {
  for (size_t i = 0; i < n; ++i) dst[i] = f32_to_bf16(src[i]);
}

// ---------------- recordio framing helpers ----------------

constexpr uint32_t kRecMagic = 0xced7230a;

inline uint32_t load_u32(const char* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

// Offset of the LAST record head (aligned magic cell whose lrec has cflag
// 0|1) in [d, d+size), or 0 if none — find_last_record_begin semantics
// (recordio_split.cc FindLastRecordBegin / io/recordio.py find_record_heads).
int64_t find_last_record_head(const char* d, int64_t size) {
  for (int64_t i = ((size >> 2) << 2) - 8; i >= 0; i -= 4) {
    if (load_u32(d + i) == kRecMagic &&
        ((load_u32(d + i + 4) >> 29) & 7) <= 1) {
      return i;
    }
  }
  return 0;
}

class LineReader {
 public:
  LineReader(std::vector<std::string> paths, std::vector<int64_t> sizes,
             int64_t part_index, int64_t num_parts, int format,
             int64_t num_col, int indexing_mode, char delim, int nthread,
             int64_t chunk_bytes, int queue_depth, int64_t batch_rows,
             int32_t label_col, int32_t weight_col, bool out_bf16 = false,
             int64_t row_bucket = 0, int64_t nnz_bucket = 0,
             bool elide_unit = false, bool csr_wire = false,
             bool pack_aux = false)
      : paths_(std::move(paths)),
        format_(format),
        num_col_(num_col),
        indexing_mode_(indexing_mode),
        delim_(delim),
        nthread_(nthread < 1 ? 1 : nthread),
        chunk_bytes_(chunk_bytes < 4096 ? 4096 : chunk_bytes),
        queue_depth_(queue_depth < 1 ? 1 : queue_depth),
        batch_rows_(batch_rows > 0 ? batch_rows : 0),
        label_col_(label_col),
        weight_col_(weight_col),
        out_bf16_(out_bf16 && batch_rows > 0),
        row_bucket_(row_bucket > 0 ? row_bucket : 0),
        nnz_bucket_(nnz_bucket > 0 ? nnz_bucket : 0),
        elide_unit_(elide_unit),
        csr_wire_(csr_wire),
        pack_aux_(pack_aux && batch_rows > 0) {
    file_offset_.push_back(0);
    for (size_t i = 0; i < sizes.size(); ++i) {
      if (is_recordio_fmt(format_) && sizes[i] % 4 != 0) {
        error_ = "recordio: file " + paths_[i] + " does not align by 4 bytes";
      }
      file_offset_.push_back(file_offset_.back() + sizes[i]);
    }
    if (error_.empty()) reset_partition(part_index, num_parts);
    if (error_.empty()) try_mmap();
    if (error_.empty()) {
      start();
    } else {
      // never started: mark done so next() returns null (consumer then
      // surfaces error()) instead of waiting on a producer that isn't there
      produce_done_ = true;
    }
  }

  // Push-mode constructor: bytes arrive via push() instead of local files.
  LineReader(int format, int64_t num_col, int indexing_mode, char delim,
             int nthread, int64_t chunk_bytes, int queue_depth,
             int64_t batch_rows, int32_t label_col, int32_t weight_col,
             bool out_bf16 = false, int64_t row_bucket = 0,
             int64_t nnz_bucket = 0, bool elide_unit = false,
             bool csr_wire = false, bool pack_aux = false)
      : format_(format),
        num_col_(num_col),
        indexing_mode_(indexing_mode),
        delim_(delim),
        nthread_(nthread < 1 ? 1 : nthread),
        chunk_bytes_(chunk_bytes < 4096 ? 4096 : chunk_bytes),
        queue_depth_(queue_depth < 1 ? 1 : queue_depth),
        batch_rows_(batch_rows > 0 ? batch_rows : 0),
        label_col_(label_col),
        weight_col_(weight_col),
        out_bf16_(out_bf16 && batch_rows > 0),
        row_bucket_(row_bucket > 0 ? row_bucket : 0),
        nnz_bucket_(nnz_bucket > 0 ? nnz_bucket : 0),
        elide_unit_(elide_unit),
        csr_wire_(csr_wire),
        pack_aux_(pack_aux && batch_rows > 0),
        push_mode_(true) {
    file_offset_.push_back(0);
    start();
  }

  // Feed bytes into the pipeline; blocks while the byte queue is full
  // (backpressure against a fast remote stream). -1 = stopped/failed.
  int32_t push(const char* data, int64_t len) {
    if (len <= 0) return 0;
    std::unique_lock<std::mutex> lk(mu_);
    cv_feed_space_.wait(lk, [&] {
      return feed_bytes_ < kFeedCap || stop_ || produce_done_ || feed_abort_;
    });
    if (stop_ || produce_done_ || feed_done_ || feed_abort_) return -1;
    feed_q_.emplace_back(data, static_cast<size_t>(len));
    feed_bytes_ += static_cast<size_t>(len);
    cv_feed_data_.notify_all();
    return 0;
  }

  void finish() {
    std::lock_guard<std::mutex> lk(mu_);
    feed_done_ = true;
    cv_feed_data_.notify_all();
  }

  // Record a feed-side failure (e.g. a remote read error in the feeding
  // thread) and end the stream: already-parsed blocks still drain, then
  // next() returns NULL with the error set — never a silent truncation.
  void fail_feed(const char* msg) {
    set_error(msg && *msg ? msg : "feed failed");
    finish();
  }

  // Unblock and fail any pusher and let the producer drain to EOF — the
  // caller MUST abort + join its feed thread before before_first()/destroy
  // (a pusher blocked inside a freed reader would be use-after-free).
  void abort_feed() {
    std::lock_guard<std::mutex> lk(mu_);
    feed_abort_ = true;
    cv_feed_space_.notify_all();
    cv_feed_data_.notify_all();
  }

  ~LineReader() {
    stop_and_join();
    close_fp();
    if (map_base_) {
      munmap(const_cast<char*>(map_base_), map_len_);
      map_base_ = nullptr;
    }
    if (cur_) {
      dmlc_free_dense(cur_);
      cur_ = nullptr;
    }
  }

  void* next(int32_t* fmt_out) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_pop_.wait(lk, [&] { return !queue_.empty() || produce_done_; });
    if (queue_.empty()) return nullptr;
    auto item = queue_.front();
    queue_.pop_front();
    cv_push_.notify_one();
    if (fmt_out) *fmt_out = item.first;
    return item.second;
  }

  void before_first() {
    stop_and_join();
    offset_curr_ = offset_begin_;
    view_cur_ = view_begin_;
    overflow_.clear();
    close_fp();
    feed_q_.clear();
    feed_off_ = 0;
    feed_bytes_ = 0;
    feed_done_ = false;
    feed_abort_ = false;
    if (cur_) {
      dmlc_free_dense(cur_);
      cur_ = nullptr;
    }
    cur_rows_ = 0;
    cur_has_weight_ = false;
    if (error_.empty()) {
      start();
    } else {
      // sticky error: stay stopped but unblock any next() caller
      std::lock_guard<std::mutex> lk(mu_);
      produce_done_ = true;
      cv_pop_.notify_all();
    }
  }

  int64_t bytes_read() const { return bytes_read_.load(std::memory_order_relaxed); }

  // The parse's busy thread-nanoseconds since construction: each chunk's
  // steady_clock time times the threads it fanned out to, those that finish
  // first counted up to the join. before_first keeps counting, as
  // bytes_read does.
  int64_t parse_busy_ns() const {
    return parse_busy_ns_.load(std::memory_order_relaxed);
  }

  const char* error() const {
    // set_error is set-once, so the pointer stays stable after return
    std::lock_guard<std::mutex> lk(err_mu_);
    return error_.empty() ? nullptr : error_.c_str();
  }

 private:
  bool is_text() const { return !is_recordio_fmt(format_); }

  // ---------------- partitioning (create-time, mirrors ResetPartition) ----
  void reset_partition(int64_t part_index, int64_t num_parts) {
    int64_t ntotal = file_offset_.back();
    int64_t nstep = (ntotal + num_parts - 1) / num_parts;
    const int64_t align = is_text() ? 1 : 4;
    nstep = ((nstep + align - 1) / align) * align;
    offset_begin_ = std::min(nstep * part_index, ntotal);
    offset_end_ = std::min(nstep * (part_index + 1), ntotal);
    offset_curr_ = offset_begin_;
    if (offset_begin_ >= offset_end_) return;
    size_t fbegin = file_of(offset_begin_);
    size_t fend = file_of(offset_end_);
    if (offset_end_ != file_offset_[fend]) {
      offset_end_ += seek_record_begin(fend, offset_end_ - file_offset_[fend]);
      if (!error_.empty()) return;
    }
    if (offset_begin_ != file_offset_[fbegin]) {
      offset_begin_ +=
          seek_record_begin(fbegin, offset_begin_ - file_offset_[fbegin]);
      if (!error_.empty()) return;
    }
    offset_curr_ = offset_begin_;
  }

  // index of the file containing global offset `off` (last i with
  // file_offset_[i] <= off), like bisect_right(...) - 1
  size_t file_of(int64_t off) const {
    size_t lo = 0, hi = file_offset_.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (file_offset_[mid] <= off) lo = mid + 1; else hi = mid;
    }
    return lo - 1;
  }

  // Bytes from (file fidx, local offset) to the next record head. Text:
  // scan to the first EOL then past the EOL run (line_split.cc:9-26).
  // RecordIO: scan 4-byte cells for magic + cflag 0|1 (recordio_split.cc:
  // 9-25). Both mirror the Python engine exactly.
  int64_t seek_record_begin(size_t fidx, int64_t local_off) {
    FILE* f = fopen(paths_[fidx].c_str(), "rb");
    if (!f) {
      error_ = "cannot open " + paths_[fidx];
      return 0;
    }
    if (fseeko(f, static_cast<off_t>(local_off), SEEK_SET) != 0) {
      error_ = "seek failed in " + paths_[fidx];
      fclose(f);
      return 0;
    }
    int64_t nstep = 0;
    if (!is_text()) {
      char cell[4];
      while (fread(cell, 1, 4, f) == 4) {
        nstep += 4;
        if (load_u32(cell) == kRecMagic) {
          char lrec[4];
          if (fread(lrec, 1, 4, f) != 4) {
            error_ = "invalid recordio format in " + paths_[fidx];
            break;
          }
          nstep += 4;
          if (((load_u32(lrec) >> 29) & 7) <= 1) {
            fclose(f);
            return nstep - 8;
          }
        }
      }
      fclose(f);
      return nstep;  // EOF: no further head in this file
    }
    char buf[512];
    bool in_run = false;
    while (true) {
      size_t r = fread(buf, 1, sizeof(buf), f);
      if (r == 0) break;
      for (size_t i = 0; i < r; ++i) {
        if (!in_run) {
          ++nstep;
          if (is_eol(buf[i])) in_run = true;
        } else {
          if (is_eol(buf[i])) {
            ++nstep;
          } else {
            fclose(f);
            return nstep;
          }
        }
      }
    }
    fclose(f);
    return nstep;
  }

  // ---------------- reading (producer thread) ----------------

  void close_fp() {
    if (fp_) {
      fclose(fp_);
      fp_ = nullptr;
    }
  }

  bool open_file(size_t fidx, int64_t local_off) {
    close_fp();
    fp_ = fopen(paths_[fidx].c_str(), "rb");
    if (!fp_) {
      set_error("cannot open " + paths_[fidx]);
      return false;
    }
    if (local_off && fseeko(fp_, static_cast<off_t>(local_off), SEEK_SET) != 0) {
      set_error("seek failed in " + paths_[fidx]);
      return false;
    }
    file_ptr_ = fidx;
    return true;
  }

  // Read up to `size` payload bytes across file joins, injecting '\n' at
  // joins (Read, input_split_base.cc:177-219). Appends to `out`.
  bool read_bytes(int64_t size, std::string* out) {
    size = std::min(size, offset_end_ - offset_curr_);
    if (size <= 0) return true;
    if (!fp_) {
      size_t fidx = file_of(offset_curr_);
      if (!open_file(fidx, offset_curr_ - file_offset_[fidx])) return false;
    }
    int64_t nleft = size;
    size_t base = out->size();
    out->resize(base + static_cast<size_t>(size));
    char* dst = &(*out)[base];
    while (nleft > 0) {
      size_t got = fread(dst, 1, static_cast<size_t>(nleft), fp_);
      if (got > 0) {
        dst += got;
        nleft -= static_cast<int64_t>(got);
        offset_curr_ += static_cast<int64_t>(got);
        bytes_read_.fetch_add(static_cast<int64_t>(got),
                              std::memory_order_relaxed);
        continue;
      }
      if (ferror(fp_)) {
        set_error("read failed in " + paths_[file_ptr_]);
        return false;
      }
      // file exhausted: newline injection at text-file joins (PR#385);
      // binary formats concatenate files without synthetic bytes
      if (is_text()) {
        *dst++ = '\n';
        nleft -= 1;
        bytes_read_.fetch_add(1, std::memory_order_relaxed);
      }
      if (offset_curr_ != file_offset_[file_ptr_ + 1]) {
        set_error("file offset not calculated correctly");
        return false;
      }
      if (file_ptr_ + 1 >= paths_.size()) break;
      if (!open_file(file_ptr_ + 1, 0)) return false;
    }
    out->resize(static_cast<size_t>(dst - out->data()));
    return true;
  }

  // Pull up to `size` bytes from the push queue into `out`; blocks until
  // enough data, finish(), or stop. A short fill means end of feed.
  bool read_bytes_push(int64_t size, std::string* out) {
    int64_t got = 0;
    while (got < size) {
      std::unique_lock<std::mutex> lk(mu_);
      cv_feed_data_.wait(lk, [&] {
        return !feed_q_.empty() || feed_done_ || feed_abort_ || stop_;
      });
      if (stop_) return false;
      if (feed_q_.empty()) break;  // feed finished/aborted: EOF
      std::string& front = feed_q_.front();
      int64_t avail = static_cast<int64_t>(front.size() - feed_off_);
      int64_t take = std::min(size - got, avail);
      out->append(front, feed_off_, static_cast<size_t>(take));
      feed_off_ += static_cast<size_t>(take);
      feed_bytes_ -= static_cast<size_t>(take);
      got += take;
      if (feed_off_ == front.size()) {
        feed_q_.pop_front();
        feed_off_ = 0;
      }
      cv_feed_space_.notify_all();
    }
    bytes_read_.fetch_add(got, std::memory_order_relaxed);
    return true;
  }

  // One chunk of whole records into `chunk`; false at EOF/error
  // (ReadChunk + Chunk::Load grow loop, input_split_base.cc:221-277).
  bool load_chunk(std::string* chunk) {
    int64_t size = chunk_bytes_;
    while (true) {
      if (static_cast<int64_t>(overflow_.size()) >= size) {
        size *= 2;
        continue;
      }
      size_t olen = overflow_.size();
      chunk->assign(overflow_);
      overflow_.clear();
      bool ok = push_mode_
          ? read_bytes_push(size - static_cast<int64_t>(olen), chunk)
          : read_bytes(size - static_cast<int64_t>(olen), chunk);
      if (!ok) return false;
      if (chunk->empty()) return false;  // EOF
      if (!is_text()) {
        if (static_cast<int64_t>(chunk->size()) != size) {
          return true;  // EOF tail: binary records are exactly complete
        }
        // cut at the LAST record head so the chunk ends on whole records
        int64_t cut = find_last_record_head(
            chunk->data(), static_cast<int64_t>(chunk->size()));
        if (cut == 0) {
          overflow_.swap(*chunk);
          size *= 2;
          continue;
        }
        overflow_.assign(*chunk, static_cast<size_t>(cut), chunk->npos);
        chunk->resize(static_cast<size_t>(cut));
        return true;
      }
      if (chunk->size() == olen) {
        // final record of the partition lacked a newline (PR#452)
        chunk->push_back('\n');
      }
      // cut after the last EOL (find_last_record_begin, line_split.cc:27-34)
      size_t cut = chunk->size();
      while (cut > 0 && !is_eol((*chunk)[cut - 1])) --cut;
      if (cut == 0) {
        overflow_.swap(*chunk);
        size *= 2;
        continue;
      }
      overflow_.assign(*chunk, cut, chunk->npos);
      chunk->resize(cut);
      return true;
    }
  }

  void* parse_chunk(const std::string& chunk) {
    return parse_chunk(chunk.data(), static_cast<int64_t>(chunk.size()));
  }

  void* parse_chunk(const char* data, int64_t len) {
    auto t0 = std::chrono::steady_clock::now();
    void* res = parse_chunk_untimed(data, len);
    note_parse(t0, is_text() ? dmlc_tpu::parse_threads(
                                   nthread_, static_cast<size_t>(len))
                             : 1);
    return res;
  }

  void note_parse(std::chrono::steady_clock::time_point t0, int threads) {
    int64_t ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                     std::chrono::steady_clock::now() - t0).count();
    parse_busy_ns_.fetch_add(ns * threads, std::memory_order_relaxed);
  }

  void* parse_chunk_untimed(const char* data, int64_t len) {
    switch (format_) {
      case kFmtLibsvm:
        return dmlc_parse_libsvm(data, len, nthread_, indexing_mode_);
      case kFmtLibsvmDense:
        return dmlc_parse_libsvm_dense(data, len, nthread_, num_col_,
                                       indexing_mode_);
      case kFmtCsv:
        return dmlc_parse_csv(data, len, nthread_, delim_);
      case kFmtCsvSplit:
        return dmlc_parse_csv_split(data, len, nthread_, delim_, label_col_,
                                    weight_col_);
      case kFmtLibfm:
        return dmlc_parse_libfm(data, len, nthread_, indexing_mode_);
      case kFmtLibsvmCoo:
      case kFmtLibfmCoo: {
        void* r = dmlc_parse_coo(data, len, nthread_, indexing_mode_,
                                 format_ == kFmtLibfmCoo ? 3 : 0, num_col_,
                                 row_bucket_, nnz_bucket_,
                                 elide_unit_ ? 1 : 0, csr_wire_ ? 1 : 0);
        if (!r) set_error("coo: out of memory");
        return r;
      }
      case kFmtRecordIO: {
        void* r = dmlc_recordio_extract(data, len);
        if (!r) set_error("recordio: out of memory");
        return r;
      }
      case kFmtRecordIOChunk: {
        // raw record-aligned chunk as a single-record batch (NextChunk
        // consumers re-frame it with RecordIOChunkReader themselves)
        auto* r = static_cast<RecordBatchResult*>(
            calloc(1, sizeof(RecordBatchResult)));
        char* d = r ? static_cast<char*>(malloc(len ? static_cast<size_t>(len) : 1))
                    : nullptr;
        auto* offs = r ? static_cast<int64_t*>(malloc(2 * sizeof(int64_t)))
                       : nullptr;
        if (!r || !d || !offs) {
          free(d);
          free(offs);
          free(r);
          set_error("recordio: out of memory");
          return nullptr;
        }
        memcpy(d, data, static_cast<size_t>(len));
        r->n_records = 1;
        r->data_len = len;
        r->data = d;
        r->offsets = offs;
        r->offsets[0] = 0;
        r->offsets[1] = r->data_len;
        return r;
      }
    }
    set_error("unknown format");
    return nullptr;
  }

  // ---------------- mmap fast path ----------------
  //
  // When the whole partition lies inside ONE local file (the common case:
  // a single big corpus, any partition not crossing a file join), chunking
  // reduces to pointer arithmetic over a read-only mapping: no fread copy,
  // no chunk-buffer assembly — the scanners read the page cache directly.
  // Chunk boundary rules are identical to the buffered path (cut after the
  // last EOL / at the last record head; EOF tail taken whole; the scanners
  // handle a final line without a trailing newline).

  void try_mmap() {
    if (push_mode_ || offset_begin_ >= offset_end_) return;
    const char* env = getenv("DMLC_TPU_NO_MMAP");
    if (env && *env && strcmp(env, "0") != 0) return;
    size_t f = file_of(offset_begin_);
    if (offset_end_ > file_offset_[f + 1]) return;  // crosses a file join
    int fd = ::open(paths_[f].c_str(), O_RDONLY);
    if (fd < 0) return;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size <= 0) {
      ::close(fd);
      return;
    }
    void* base = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                      MAP_PRIVATE, fd, 0);
    ::close(fd);
    if (base == MAP_FAILED) return;
    map_base_ = static_cast<const char*>(base);
    map_len_ = static_cast<size_t>(st.st_size);
    madvise(base, map_len_, MADV_SEQUENTIAL);
    view_begin_ = offset_begin_ - file_offset_[f];
    view_end_ = std::min<int64_t>(offset_end_ - file_offset_[f],
                                  static_cast<int64_t>(map_len_));
    view_cur_ = view_begin_;
  }

  // Next record-aligned window of the mapping; false at partition end.
  bool next_view(const char** p, int64_t* n) {
    if (view_cur_ >= view_end_) return false;
    int64_t size = chunk_bytes_;
    const char* b = map_base_ + view_cur_;
    const int64_t remain = view_end_ - view_cur_;
    while (true) {
      if (size >= remain) {  // EOF tail: records are exactly complete
        *p = b;
        *n = remain;
        view_cur_ = view_end_;
        bytes_read_.fetch_add(remain, std::memory_order_relaxed);
        return true;
      }
      int64_t cut;
      if (is_text()) {
        cut = size;
        while (cut > 0 && !is_eol(b[cut - 1])) --cut;
      } else {
        cut = find_last_record_head(b, size);
      }
      if (cut == 0) {
        size *= 2;  // a single record larger than the window
        continue;
      }
      *p = b;
      *n = cut;
      view_cur_ += cut;
      bytes_read_.fetch_add(cut, std::memory_order_relaxed);
      return true;
    }
  }

  void produce_loop() {
    if (map_base_) {
      produce_loop_mmap();
      return;
    }
    std::string chunk;
    while (!stop_requested()) {
      chunk.clear();
      if (!load_chunk(&chunk)) break;  // EOF or IOerror
      if (format_ == kFmtLibsvmDense && batch_rows_ > 0) {
        // zero-merge path: per-thread part buffers are copied ONCE, straight
        // into exact [batch_rows_, num_col_] output blocks
        int r = process_dense_chunk(chunk);
        if (r == kChunkFatal) {
          mark_done();  // OOM (error set) or stop: never leave next() hanging
          return;
        }
        if (r == kChunkErrorPushed) break;
        continue;
      }
      void* res = parse_chunk(chunk);
      if (!res) break;
      if (format_ == kFmtLibsvmDense) {
        if (static_cast<DenseResult*>(res)->needs_csr) {
          // data the dense scanner can't express (qid rows): permanently
          // downgrade to the CSR path and re-parse this chunk
          free_result(format_, res);
          format_ = kFmtLibsvm;
          res = parse_chunk(chunk);
          if (!res) break;
        }
      }
      if (result_rows(format_, res) == 0 && !result_error(format_, res)) {
        free_result(format_, res);  // blank/comment-only chunk
        continue;
      }
      bool had_error = result_error(format_, res) != nullptr;
      if (!had_error && format_ == kFmtCsv && batch_rows_ > 0 &&
          num_col_ > 0) {
        // csv -> dense straight into the output batch
        DenseResult* cfg_err = nullptr;
        if (!accumulate_csv(static_cast<CsvResult*>(res), &cfg_err)) {
          mark_done();
          return;
        }
        if (cfg_err) {  // config error (label_col out of range)
          push_error_after_flush(kFmtLibsvmDense, cfg_err);
          break;
        }
        continue;
      }
      if (had_error && batch_rows_ > 0) {
        // deliver rows accumulated from earlier clean chunks BEFORE the
        // error block, preserving non-batch-mode ordering
        if (!push_error_after_flush(format_, res)) return;
        break;
      }
      if (!push_result(format_, res)) return;
      if (had_error) break;  // parse error rides the queued result
    }
    if (batch_rows_ > 0) flush_partial();
    mark_done();
  }

  // Same control flow as produce_loop, over zero-copy views of the mapping.
  void produce_loop_mmap() {
    const char* data;
    int64_t len;
    while (!stop_requested()) {
      if (!next_view(&data, &len)) break;  // partition exhausted
      if (format_ == kFmtLibsvmDense && batch_rows_ > 0) {
        int r = process_dense_chunk(data, len);
        if (r == kChunkFatal) {
          mark_done();
          return;
        }
        if (r == kChunkErrorPushed) break;
        continue;
      }
      void* res = parse_chunk(data, len);
      if (!res) break;
      if (format_ == kFmtLibsvmDense &&
          static_cast<DenseResult*>(res)->needs_csr) {
        free_result(format_, res);
        format_ = kFmtLibsvm;
        res = parse_chunk(data, len);
        if (!res) break;
      }
      if (result_rows(format_, res) == 0 && !result_error(format_, res)) {
        free_result(format_, res);
        continue;
      }
      bool had_error = result_error(format_, res) != nullptr;
      if (!had_error && format_ == kFmtCsv && batch_rows_ > 0 &&
          num_col_ > 0) {
        DenseResult* cfg_err = nullptr;
        if (!accumulate_csv(static_cast<CsvResult*>(res), &cfg_err)) {
          mark_done();
          return;
        }
        if (cfg_err) {
          push_error_after_flush(kFmtLibsvmDense, cfg_err);
          break;
        }
        continue;
      }
      if (had_error && batch_rows_ > 0) {
        if (!push_error_after_flush(format_, res)) return;
        break;
      }
      if (!push_result(format_, res)) return;
      if (had_error) break;
    }
    if (batch_rows_ > 0) flush_partial();
    mark_done();
  }

  enum { kChunkOk = 0, kChunkFatal = 1, kChunkErrorPushed = 2 };

  // Parse one chunk through the internal DensePart API and append the rows
  // directly to the in-progress output batch. Mirrors the merge semantics
  // of dmlc_parse_libsvm_dense (first erroring part wins, all-or-none
  // weights, per-chunk indexing heuristic) without materializing the merged
  // intermediate.
  int process_dense_chunk(const std::string& chunk) {
    return process_dense_chunk(chunk.data(), static_cast<int64_t>(chunk.size()));
  }

  int process_dense_chunk(const char* cdata, int64_t clen) {
    std::vector<dmlc_tpu::DensePart> parts;
    auto t0 = std::chrono::steady_clock::now();
    dmlc_tpu::parse_libsvm_dense_chunk(cdata, clen, nthread_, num_col_,
                                       &parts);
    note_parse(t0,
               dmlc_tpu::parse_threads(nthread_, static_cast<size_t>(clen)));
    for (auto& part : parts) {
      if (part.error.empty()) continue;
      if (part.needs_csr) {
        // qid rows: flush, permanently downgrade to CSR, re-parse the chunk
        if (!flush_partial()) return kChunkFatal;
        format_ = kFmtLibsvm;
        void* res = parse_chunk(cdata, clen);
        if (!res) return kChunkFatal;
        if (result_rows(format_, res) == 0 && !result_error(format_, res)) {
          free_result(format_, res);
          return kChunkOk;
        }
        bool had_error = result_error(format_, res) != nullptr;
        if (!push_result(format_, res)) return kChunkFatal;
        return had_error ? kChunkErrorPushed : kChunkOk;
      }
      DenseResult* err = make_error_dense(part.error);
      if (!err) {
        set_error("reader: out of memory reporting parse error");
        return kChunkFatal;
      }
      if (!push_error_after_flush(kFmtLibsvmDense, err)) return kChunkFatal;
      return kChunkErrorPushed;
    }
    int64_t n = 0;
    bool any_weight = false;
    uint64_t min_index = UINT64_MAX;
    for (auto& part : parts) {
      n += static_cast<int64_t>(part.label.size());
      any_weight |= !part.weight.empty();
      if (part.min_index < min_index) min_index = part.min_index;
    }
    if (n == 0) return kChunkOk;  // blank/comment-only chunk
    for (auto& part : parts) {
      if (any_weight && !part.label.empty() &&
          part.weight.size() != part.label.size()) {
        DenseResult* err = make_error_dense(
            "libsvm: label:weight must be set on every row or none");
        if (!err) {
          set_error("reader: out of memory reporting parse error");
          return kChunkFatal;
        }
        if (!push_error_after_flush(kFmtLibsvmDense, err)) return kChunkFatal;
        return kChunkErrorPushed;
      }
    }
    // per-chunk 1-based -> 0-based heuristic -> column offset into the
    // stride-(num_col_+1) part buffers (libsvm_parser.h:159-168)
    bool convert = indexing_mode_ > 0 ||
        (indexing_mode_ < 0 && min_index != UINT64_MAX && min_index > 0);
    const size_t off = convert ? 1 : 0;
    for (auto& part : parts) {
      if (part.label.empty()) continue;
      if (!append_rows(part.x.data(), off, part.label.data(),
                       part.weight.empty() ? nullptr : part.weight.data(),
                       part.label.size())) {
        return kChunkFatal;
      }
    }
    return kChunkOk;
  }

  // Mark the pipeline finished so a blocked next() always wakes — every
  // early exit from produce_loop must go through here (or push_result's
  // stop path, which does the same).
  void mark_done() {
    std::lock_guard<std::mutex> lk(mu_);
    produce_done_ = true;
    cv_pop_.notify_all();
    cv_feed_space_.notify_all();  // unblock a pusher: the stream is over
  }

  // Blocking push honoring queue depth; false = stop requested.
  bool push_result(int fmt, void* res) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_push_.wait(lk, [&] {
        return static_cast<int>(queue_.size()) < queue_depth_ || stop_;
      });
      if (stop_) {
        free_result(fmt, res);
        // a consumer may be blocked in next(): mark done so it wakes
        produce_done_ = true;
        cv_pop_.notify_all();
        return false;
      }
      queue_.emplace_back(fmt, res);
    }
    cv_pop_.notify_one();
    return true;
  }

  // Deliver rows accumulated from earlier clean chunks, THEN the error
  // result — the ordering contract shared by every error path in batch
  // mode. false = stop/OOM (err_res freed, pipeline marked done).
  bool push_error_after_flush(int fmt, void* err_res) {
    if (!flush_partial()) {
      free_result(fmt, err_res);
      mark_done();
      return false;
    }
    return push_result(fmt, err_res);
  }

  // A calloc'd DenseResult carrying only an error message; null on OOM.
  DenseResult* make_error_dense(const std::string& msg) {
    auto* out = static_cast<DenseResult*>(calloc(1, sizeof(DenseResult)));
    if (!out) return nullptr;
    out->n_cols = num_col_;
    out->error = strdup(msg.c_str());
    if (!out->error) {
      free(out);
      return nullptr;
    }
    return out;
  }

  // A fresh full-size output batch; null on OOM.
  DenseResult* alloc_batch() {
    auto* out = static_cast<DenseResult*>(calloc(1, sizeof(DenseResult)));
    if (!out) return nullptr;
    out->n_cols = num_col_;
    out->x_bf16 = out_bf16_ ? 1 : 0;
    out->packed_aux = pack_aux_ ? 1 : 0;
    // packed mode: label/weight live in two trailing x columns (ONE
    // device_put per batch downstream; see api.h DenseResult docs)
    const size_t xcols =
        static_cast<size_t>(num_col_) + (pack_aux_ ? 2 : 0);
    // pooled: every batch of an epoch has the same buffer sizes, so the
    // freed x of batch i becomes the x of batch i+k without touching
    // glibc's mmap path (buffer_pool.h)
    out->x = static_cast<float*>(
        dmlc_pool_alloc(static_cast<size_t>(batch_rows_) * xcols *
                        (out_bf16_ ? sizeof(uint16_t) : sizeof(float))));
    bool ok = out->x != nullptr;
    if (ok && !pack_aux_) {
      out->label = static_cast<float*>(
          dmlc_pool_alloc(static_cast<size_t>(batch_rows_) * sizeof(float)));
      ok = out->label != nullptr;
      if (ok && cur_has_weight_) {
        out->weight = static_cast<float*>(
            dmlc_pool_alloc(static_cast<size_t>(batch_rows_) * sizeof(float)));
        ok = out->weight != nullptr;
      }
    }
    if (!ok) {
      dmlc_free_dense(out);
      return nullptr;
    }
    return out;
  }

  // Lazily allocate + backfill the weight column of the in-progress batch
  // when the pipeline first sees weighted rows (earlier rows get 1.0,
  // matching the old accumulator's backfill). false on OOM.
  bool promote_weight() {
    cur_has_weight_ = true;
    if (pack_aux_) return true;  // weight column always exists when packed
    if (cur_ && !cur_->weight) {
      cur_->weight = static_cast<float*>(
          dmlc_pool_alloc(static_cast<size_t>(batch_rows_) * sizeof(float)));
      if (!cur_->weight) return false;
      for (int64_t i = 0; i < cur_rows_; ++i) cur_->weight[i] = 1.0f;
    }
    return true;
  }

  // Emit the in-progress batch as-is (short final block). false = stop/OOM.
  bool flush_partial() {
    if (!cur_) return true;
    if (cur_rows_ == 0) {
      dmlc_free_dense(cur_);
      cur_ = nullptr;
      return true;
    }
    cur_->n_rows = cur_rows_;
    DenseResult* out = cur_;
    cur_ = nullptr;
    cur_rows_ = 0;
    return push_result(kFmtLibsvmDense, out);
  }

  // Copy n rows from a stride-(num_col_+1) part buffer (column offset `off`
  // applying the indexing decision) straight into output batches, emitting
  // each one as it fills. weight may be null (rows weigh 1.0 if the batch
  // has a weight column). false = stop/OOM.
  bool append_rows(const float* x, size_t off, const float* label,
                   const float* weight, size_t n) {
    const size_t ncol = static_cast<size_t>(num_col_);
    const size_t stride = ncol + 1;
    size_t done = 0;
    while (done < n) {
      if (!cur_) {
        cur_ = alloc_batch();
        if (!cur_) {
          set_error("reader: out of memory repacking batch");
          return false;
        }
      }
      if (weight && !cur_has_weight_ && !promote_weight()) {
        set_error("reader: out of memory repacking batch");
        return false;
      }
      size_t space = static_cast<size_t>(batch_rows_ - cur_rows_);
      size_t take = n - done < space ? n - done : space;
      const float* src = x + done * stride + off;
      const size_t ocol = ncol + (pack_aux_ ? 2 : 0);
      if (out_bf16_) {
        // the single repack pass doubles as the f32->bf16 conversion
        uint16_t* dst16 = reinterpret_cast<uint16_t*>(cur_->x) +
                          static_cast<size_t>(cur_rows_) * ocol;
        for (size_t i = 0; i < take; ++i) {
          convert_row_bf16(dst16 + i * ocol, src + i * stride, ncol);
          if (pack_aux_) {
            dst16[i * ocol + ncol] = f32_to_bf16(label[done + i]);
            dst16[i * ocol + ncol + 1] =
                f32_to_bf16(weight ? weight[done + i] : 1.0f);
          }
        }
      } else {
        float* dst = cur_->x + static_cast<size_t>(cur_rows_) * ocol;
        for (size_t i = 0; i < take; ++i) {
          memcpy(dst + i * ocol, src + i * stride, ncol * sizeof(float));
          if (pack_aux_) {
            dst[i * ocol + ncol] = label[done + i];
            dst[i * ocol + ncol + 1] = weight ? weight[done + i] : 1.0f;
          }
        }
      }
      if (!pack_aux_) {
        memcpy(cur_->label + cur_rows_, label + done, take * sizeof(float));
        if (cur_has_weight_) {
          if (weight) {
            memcpy(cur_->weight + cur_rows_, weight + done,
                   take * sizeof(float));
          } else {
            for (size_t i = 0; i < take; ++i)
              cur_->weight[cur_rows_ + i] = 1.0f;
          }
        }
      }
      cur_rows_ += static_cast<int64_t>(take);
      done += take;
      if (cur_rows_ == batch_rows_) {
        cur_->n_rows = batch_rows_;
        DenseResult* out = cur_;
        cur_ = nullptr;
        cur_rows_ = 0;
        if (!push_result(kFmtLibsvmDense, out)) return false;  // stop
      }
    }
    return true;
  }

  // Append CSV cells straight into the output batch (one copy: cells ->
  // batch), splitting label/weight columns and padding/truncating features
  // to num_col_ (csv_cells_to_dense semantics). Consumes `res`. A config
  // error comes back via *err_out (a dense error result) with true
  // returned; false = stop/OOM.
  bool accumulate_csv(CsvResult* res, DenseResult** err_out) {
    *err_out = nullptr;
    const int64_t n = res->n_rows;
    const int64_t ncol = res->n_cols;
    if (label_col_ >= ncol || weight_col_ >= ncol) {
      DenseResult* out = make_error_dense("csv: label/weight column out of range");
      dmlc_free_csv(res);
      if (!out) {
        set_error("reader: out of memory converting csv");
        return false;
      }
      *err_out = out;
      return true;
    }
    const bool has_w = weight_col_ >= 0;
    int64_t done = 0;
    while (done < n) {
      if (!cur_) {
        cur_ = alloc_batch();
        if (!cur_) {
          dmlc_free_csv(res);
          set_error("reader: out of memory repacking batch");
          return false;
        }
      }
      if (has_w && !cur_has_weight_ && !promote_weight()) {
        dmlc_free_csv(res);
        set_error("reader: out of memory repacking batch");
        return false;
      }
      int64_t space = batch_rows_ - cur_rows_;
      int64_t take = n - done < space ? n - done : space;
      const int64_t ocol = num_col_ + (pack_aux_ ? 2 : 0);
      for (int64_t r = 0; r < take; ++r) {
        const float* row = res->cells + (done + r) * ncol;
        const float lab = label_col_ >= 0 ? row[label_col_] : 0.0f;
        const float wgt = has_w ? row[weight_col_] : 1.0f;
        if (!pack_aux_) {
          cur_->label[cur_rows_ + r] = lab;
          if (cur_has_weight_) cur_->weight[cur_rows_ + r] = wgt;
        }
        int64_t k = 0;
        if (out_bf16_) {
          uint16_t* dst16 = reinterpret_cast<uint16_t*>(cur_->x) +
                            static_cast<size_t>(cur_rows_ + r) * ocol;
          for (int64_t c = 0; c < ncol && k < num_col_; ++c) {
            if (c == label_col_ || c == weight_col_) continue;
            dst16[k++] = f32_to_bf16(row[c]);
          }
          while (k < num_col_) dst16[k++] = 0;  // bf16 zero is all-zero bits
          if (pack_aux_) {
            dst16[num_col_] = f32_to_bf16(lab);
            dst16[num_col_ + 1] = f32_to_bf16(wgt);
          }
        } else {
          float* dst = cur_->x + static_cast<size_t>(cur_rows_ + r) * ocol;
          for (int64_t c = 0; c < ncol && k < num_col_; ++c) {
            if (c == label_col_ || c == weight_col_) continue;
            dst[k++] = row[c];
          }
          while (k < num_col_) dst[k++] = 0.0f;  // x is malloc'd, not zeroed
          if (pack_aux_) {
            dst[num_col_] = lab;
            dst[num_col_ + 1] = wgt;
          }
        }
      }
      cur_rows_ += take;
      done += take;
      if (cur_rows_ == batch_rows_) {
        cur_->n_rows = batch_rows_;
        DenseResult* out = cur_;
        cur_ = nullptr;
        cur_rows_ = 0;
        if (!push_result(kFmtLibsvmDense, out)) {
          dmlc_free_csv(res);
          return false;
        }
      }
    }
    dmlc_free_csv(res);
    return true;
  }

  // ---------------- lifecycle ----------------

  void start() {
    stop_ = false;
    produce_done_ = false;
    // guard the whole producer: an escaping exception (e.g. bad_alloc while
    // regrowing chunk buffers for a pathological record) would
    // std::terminate the embedding Python process
    producer_ = std::thread([this] {
      try {
        produce_loop();
      } catch (const std::exception& ex) {
        set_error(std::string("reader failed: ") + ex.what());
        mark_done();
      } catch (...) {
        set_error("reader failed: unknown error");
        mark_done();
      }
    });
  }

  void stop_and_join() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
      cv_push_.notify_all();
      cv_feed_data_.notify_all();
      cv_feed_space_.notify_all();
    }
    if (producer_.joinable()) producer_.join();
    for (auto& item : queue_) free_result(item.first, item.second);
    queue_.clear();
    stop_ = false;
    produce_done_ = false;
  }

  bool stop_requested() {
    std::lock_guard<std::mutex> lk(mu_);
    return stop_;
  }

  void set_error(std::string msg) {
    std::lock_guard<std::mutex> lk(err_mu_);
    if (error_.empty()) error_ = std::move(msg);
  }

  std::vector<std::string> paths_;
  std::vector<int64_t> file_offset_;
  int format_;
  int64_t num_col_;
  int indexing_mode_;
  char delim_;
  int nthread_;
  int64_t chunk_bytes_;
  int queue_depth_;

  int64_t offset_begin_ = 0, offset_end_ = 0, offset_curr_ = 0;
  size_t file_ptr_ = 0;
  FILE* fp_ = nullptr;
  std::string overflow_;

  // dense batch repack (batch_rows_ > 0): rows fill `cur_` (a full-size
  // malloc'd output block) until it can be emitted — the single copy runs
  // off-GIL in this producer thread, replacing the consumer-side
  // np.concatenate per batch
  int64_t batch_rows_ = 0;
  int32_t label_col_ = -1;   // csv->dense: label/weight column extraction
  int32_t weight_col_ = -1;  // (csv_parser.h label_column/weight_column)
  bool out_bf16_ = false;    // emit x as bfloat16 (batch repack mode only)
  // COO formats: shape quantization buckets + unit-value elision
  int64_t row_bucket_ = 0;
  int64_t nnz_bucket_ = 0;
  bool elide_unit_ = false;
  bool csr_wire_ = false;
  bool pack_aux_ = false;
  DenseResult* cur_ = nullptr;  // in-progress output batch (producer-owned)
  int64_t cur_rows_ = 0;
  bool cur_has_weight_ = false;

  // mmap fast path (single-file partitions)
  const char* map_base_ = nullptr;
  size_t map_len_ = 0;
  int64_t view_begin_ = 0, view_cur_ = 0, view_end_ = 0;

  // push-mode feed queue (remote streams pushed from Python)
  bool push_mode_ = false;
  static constexpr size_t kFeedCap = 32 << 20;  // backpressure bound
  std::deque<std::string> feed_q_;
  size_t feed_off_ = 0;    // consumed prefix of feed_q_.front()
  size_t feed_bytes_ = 0;  // unconsumed bytes across the queue
  bool feed_done_ = false;
  bool feed_abort_ = false;

  std::thread producer_;
  std::mutex mu_;
  std::condition_variable cv_push_, cv_pop_;
  std::condition_variable cv_feed_data_, cv_feed_space_;
  std::deque<std::pair<int, void*>> queue_;
  bool stop_ = false;
  bool produce_done_ = false;
  std::atomic<int64_t> bytes_read_{0};
  std::atomic<int64_t> parse_busy_ns_{0};
  mutable std::mutex err_mu_;
  std::string error_;
};

// ---------------- indexed recordio reader ----------------
//
// Record-count partitioning over an external index, batched contiguous
// reads, and per-epoch shuffled per-record seeks — the native rebuild of
// the reference's IndexedRecordIOSplitter (indexed_recordio_split.cc:
// 12-41 ResetPartition by record count, 159-212 NextBatchEx batched /
// shuffled reads, 221-233 per-epoch reshuffle in BeforeFirst). Results are
// RecordBatchResult batches (payloads extracted + multi-part reassembled
// by dmlc_recordio_extract), matching the Python engine row-for-row for
// sequential access; shuffled order is produced by mt19937 and therefore
// deterministic per (seed, epoch) but intentionally NOT identical to the
// Python engine's random.Random order.

class IndexedReader {
 public:
  IndexedReader(std::vector<std::string> paths, std::vector<int64_t> sizes,
                std::vector<int64_t> index_offsets, int64_t part_index,
                int64_t num_parts, int64_t batch_records, bool shuffle,
                uint64_t seed, int queue_depth)
      : paths_(std::move(paths)),
        index_(std::move(index_offsets)),
        batch_records_(batch_records < 1 ? 256 : batch_records),
        shuffle_(shuffle),
        rng_(seed),
        queue_depth_(queue_depth < 1 ? 1 : queue_depth) {
    file_offset_.push_back(0);
    for (size_t i = 0; i < sizes.size(); ++i) {
      if (sizes[i] % 4 != 0) {
        error_ = "recordio: file " + paths_[i] + " does not align by 4 bytes";
      }
      file_offset_.push_back(file_offset_.back() + sizes[i]);
    }
    if (index_.empty()) error_ = "indexed recordio: empty index";
    std::sort(index_.begin(), index_.end());
    if (error_.empty()) reset_partition(part_index, num_parts);
    if (error_.empty()) {
      draw_epoch();
      start();
    } else {
      produce_done_ = true;
    }
  }

  ~IndexedReader() {
    stop_and_join();
    close_fp();
  }

  RecordBatchResult* next() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_pop_.wait(lk, [&] { return !queue_.empty() || produce_done_; });
    if (queue_.empty()) return nullptr;
    RecordBatchResult* item = queue_.front();
    queue_.pop_front();
    cv_push_.notify_one();
    return item;
  }

  // Epoch reset: a NEW permutation is drawn each epoch (BeforeFirst,
  // indexed_recordio_split.cc:221-233) — rng_ keeps advancing, so the
  // epoch sequence is deterministic for a given seed.
  void before_first() {
    stop_and_join();
    close_fp();
    if (error_.empty()) {
      draw_epoch();
      start();
    } else {
      std::lock_guard<std::mutex> lk(mu_);
      produce_done_ = true;
      cv_pop_.notify_all();
    }
  }

  // Native resume: land in epoch `epochs` (counting before_first calls)
  // positioned at record `records` of the partition. The permutation is a
  // pure function of (seed, epoch), so replay = drawing the missing epoch
  // permutations (O(n) shuffles, no I/O) and starting the producer at the
  // record cursor — no bytes of the prefix are read.
  void skip(int64_t epochs, int64_t records) {
    stop_and_join();
    close_fp();
    if (!error_.empty()) {
      std::lock_guard<std::mutex> lk(mu_);
      produce_done_ = true;
      cv_pop_.notify_all();
      return;
    }
    if (epochs_drawn_ > epochs + 1) {
      // rng cannot rewind: resuming an earlier epoch needs a fresh reader
      set_error("indexed reader: cannot skip backwards");
      std::lock_guard<std::mutex> lk(mu_);
      produce_done_ = true;
      cv_pop_.notify_all();
      return;
    }
    while (epochs_drawn_ < epochs + 1) draw_epoch();
    start_record_ = std::max<int64_t>(0, records);
    start();
  }

  int64_t bytes_read() const {
    return bytes_read_.load(std::memory_order_relaxed);
  }

  const char* error() const {
    std::lock_guard<std::mutex> lk(err_mu_);
    return error_.empty() ? nullptr : error_.c_str();
  }

 private:
  int64_t ntotal() const { return static_cast<int64_t>(index_.size()); }

  int64_t record_size(int64_t i) const {
    int64_t end = (i + 1 < ntotal()) ? index_[i + 1] : file_offset_.back();
    return end - index_[i];
  }

  // Partition by record count (indexed_recordio_split.cc:12-41; identical
  // to the Python engine's IndexedRecordIOSplitter.reset_partition).
  void reset_partition(int64_t part_index, int64_t num_parts) {
    int64_t n = ntotal();
    int64_t nstep = (n + num_parts - 1) / num_parts;
    if (part_index * nstep >= n) {
      index_begin_ = index_end_ = 0;
      offset_end_ = 0;
      return;
    }
    index_begin_ = part_index * nstep;
    if ((part_index + 1) * nstep < n) {
      index_end_ = (part_index + 1) * nstep;
      offset_end_ = index_[index_end_];
    } else {
      index_end_ = n;
      offset_end_ = file_offset_.back();
    }
  }

  size_t file_of(int64_t off) const {
    size_t lo = 0, hi = file_offset_.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (file_offset_[mid] <= off) lo = mid + 1; else hi = mid;
    }
    return lo - 1;
  }

  void close_fp() {
    if (fp_) {
      fclose(fp_);
      fp_ = nullptr;
    }
  }

  // Append the absolute span [offset, offset+size) to `out`, crossing file
  // joins (binary: no synthetic bytes). Reuses the open FILE* when the
  // span continues where the last read ended — contiguous batches pay one
  // seek, shuffled access seeks per record as the reference does.
  bool read_span(int64_t offset, int64_t size, std::string* out) {
    while (size > 0) {
      size_t f = file_of(offset);
      int64_t local = offset - file_offset_[f];
      int64_t avail = file_offset_[f + 1] - offset;
      int64_t take = std::min(size, avail);
      if (!fp_ || fp_file_ != f) {
        close_fp();
        fp_ = fopen(paths_[f].c_str(), "rb");
        if (!fp_) {
          set_error("cannot open " + paths_[f]);
          return false;
        }
        fp_file_ = f;
        fp_pos_ = 0;
      }
      if (fp_pos_ != local) {
        if (fseeko(fp_, static_cast<off_t>(local), SEEK_SET) != 0) {
          set_error("seek failed in " + paths_[f]);
          return false;
        }
        fp_pos_ = local;
      }
      size_t base = out->size();
      out->resize(base + static_cast<size_t>(take));
      if (fread(&(*out)[base], 1, static_cast<size_t>(take), fp_) !=
          static_cast<size_t>(take)) {
        set_error("read failed in " + paths_[f]);
        return false;
      }
      fp_pos_ += take;
      offset += take;
      size -= take;
      bytes_read_.fetch_add(take, std::memory_order_relaxed);
    }
    return true;
  }

  // Draw the next epoch's permutation (shuffle only); rng_ advances once
  // per epoch so the sequence is deterministic per seed.
  void draw_epoch() {
    ++epochs_drawn_;
    if (!shuffle_) return;
    perm_.resize(static_cast<size_t>(index_end_ - index_begin_));
    for (size_t i = 0; i < perm_.size(); ++i) {
      perm_[i] = index_begin_ + static_cast<int64_t>(i);
    }
    std::shuffle(perm_.begin(), perm_.end(), rng_);
  }

  void produce_loop() {
    int64_t cur = index_begin_ + start_record_;
    size_t pcur = static_cast<size_t>(start_record_);
    start_record_ = 0;  // one-shot: consumed by this producer run
    std::string buf;
    while (!stop_requested()) {
      buf.clear();
      if (shuffle_) {
        if (pcur >= perm_.size()) break;
        size_t take = std::min<size_t>(
            static_cast<size_t>(batch_records_), perm_.size() - pcur);
        for (size_t i = 0; i < take; ++i) {
          int64_t rec = perm_[pcur + i];
          if (!read_span(index_[rec], record_size(rec), &buf)) {
            mark_done();
            return;
          }
        }
        pcur += take;
      } else {
        if (cur >= index_end_) break;
        int64_t last = std::min(cur + batch_records_, index_end_);
        int64_t begin_off = index_[cur];
        int64_t end_off =
            (last < ntotal()) ? index_[last] : file_offset_.back();
        if (last == index_end_) end_off = offset_end_;
        if (!read_span(begin_off, end_off - begin_off, &buf)) {
          mark_done();
          return;
        }
        cur = last;
      }
      if (buf.empty()) break;
      RecordBatchResult* res = dmlc_recordio_extract(
          buf.data(), static_cast<int64_t>(buf.size()));
      if (!res) {
        set_error("indexed recordio: out of memory");
        break;
      }
      bool had_error = res->error != nullptr;
      if (!push_result(res)) return;
      if (had_error) break;
    }
    mark_done();
  }

  void mark_done() {
    std::lock_guard<std::mutex> lk(mu_);
    produce_done_ = true;
    cv_pop_.notify_all();
  }

  bool push_result(RecordBatchResult* res) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_push_.wait(lk, [&] {
        return static_cast<int>(queue_.size()) < queue_depth_ || stop_;
      });
      if (stop_) {
        dmlc_free_records(res);
        produce_done_ = true;
        cv_pop_.notify_all();
        return false;
      }
      queue_.push_back(res);
    }
    cv_pop_.notify_one();
    return true;
  }

  void start() {
    stop_ = false;
    produce_done_ = false;
    producer_ = std::thread([this] {
      try {
        produce_loop();
      } catch (const std::exception& ex) {
        set_error(std::string("indexed reader failed: ") + ex.what());
        mark_done();
      } catch (...) {
        set_error("indexed reader failed: unknown error");
        mark_done();
      }
    });
  }

  void stop_and_join() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
      cv_push_.notify_all();
    }
    if (producer_.joinable()) producer_.join();
    for (auto* item : queue_) dmlc_free_records(item);
    queue_.clear();
    stop_ = false;
    produce_done_ = false;
  }

  bool stop_requested() {
    std::lock_guard<std::mutex> lk(mu_);
    return stop_;
  }

  void set_error(std::string msg) {
    std::lock_guard<std::mutex> lk(err_mu_);
    if (error_.empty()) error_ = std::move(msg);
  }

  std::vector<std::string> paths_;
  std::vector<int64_t> file_offset_;
  std::vector<int64_t> index_;  // sorted record start offsets (global)
  int64_t batch_records_;
  bool shuffle_;
  std::mt19937_64 rng_;
  int queue_depth_;

  std::vector<int64_t> perm_;   // current epoch's permutation (shuffle)
  int64_t epochs_drawn_ = 0;    // permutations drawn so far (epoch + 1)
  int64_t start_record_ = 0;    // resume cursor for the next producer run
  int64_t index_begin_ = 0, index_end_ = 0, offset_end_ = 0;
  FILE* fp_ = nullptr;
  size_t fp_file_ = 0;
  int64_t fp_pos_ = 0;

  std::thread producer_;
  std::mutex mu_;
  std::condition_variable cv_push_, cv_pop_;
  std::deque<RecordBatchResult*> queue_;
  bool stop_ = false;
  bool produce_done_ = false;
  std::atomic<int64_t> bytes_read_{0};
  mutable std::mutex err_mu_;
  std::string error_;
};

}  // namespace

extern "C" {

void* dmlc_reader_create(const char** paths, const int64_t* sizes,
                         int32_t nfiles, int64_t part_index, int64_t num_parts,
                         int32_t format, int64_t num_col, int32_t indexing_mode,
                         char delim, int32_t nthread, int64_t chunk_bytes,
                         int32_t queue_depth, int64_t batch_rows,
                         int32_t label_col, int32_t weight_col,
                         int32_t out_bf16, int64_t row_bucket,
                         int64_t nnz_bucket, int32_t elide_unit,
                         int32_t csr_wire, int32_t pack_aux) {
  try {
    std::vector<std::string> p(paths, paths + nfiles);
    std::vector<int64_t> s(sizes, sizes + nfiles);
    return new LineReader(std::move(p), std::move(s), part_index, num_parts,
                          format, num_col, indexing_mode, delim, nthread,
                          chunk_bytes, queue_depth, batch_rows, label_col,
                          weight_col, out_bf16 != 0, row_bucket, nnz_bucket,
                          elide_unit != 0, csr_wire != 0, pack_aux != 0);
  } catch (...) {
    // alloc/thread-spawn failure must not cross the extern "C" boundary
    // (std::terminate); null tells the caller creation failed
    return nullptr;
  }
}

void* dmlc_reader_next(void* handle, int32_t* fmt_out) {
  return static_cast<LineReader*>(handle)->next(fmt_out);
}

void dmlc_reader_before_first(void* handle) {
  static_cast<LineReader*>(handle)->before_first();
}

int64_t dmlc_reader_bytes_read(void* handle) {
  return static_cast<LineReader*>(handle)->bytes_read();
}

int64_t dmlc_reader_parse_busy_ns(void* handle) {
  return static_cast<LineReader*>(handle)->parse_busy_ns();
}

const char* dmlc_reader_error(void* handle) {
  return static_cast<LineReader*>(handle)->error();
}

void dmlc_reader_destroy(void* handle) {
  delete static_cast<LineReader*>(handle);
}

void* dmlc_feeder_create(int32_t format, int64_t num_col,
                         int32_t indexing_mode, char delim, int32_t nthread,
                         int64_t chunk_bytes, int32_t queue_depth,
                         int64_t batch_rows, int32_t label_col,
                         int32_t weight_col, int32_t out_bf16,
                         int64_t row_bucket, int64_t nnz_bucket,
                         int32_t elide_unit, int32_t csr_wire,
                         int32_t pack_aux) {
  try {
    return new LineReader(format, num_col, indexing_mode, delim, nthread,
                          chunk_bytes, queue_depth, batch_rows, label_col,
                          weight_col, out_bf16 != 0, row_bucket, nnz_bucket,
                          elide_unit != 0, csr_wire != 0, pack_aux != 0);
  } catch (...) {
    return nullptr;
  }
}

int32_t dmlc_feeder_push(void* handle, const char* data, int64_t len) {
  return static_cast<LineReader*>(handle)->push(data, len);
}

void dmlc_feeder_abort(void* handle) {
  static_cast<LineReader*>(handle)->abort_feed();
}

void dmlc_feeder_fail(void* handle, const char* msg) {
  static_cast<LineReader*>(handle)->fail_feed(msg);
}

void dmlc_feeder_finish(void* handle) {
  static_cast<LineReader*>(handle)->finish();
}

void* dmlc_feeder_next(void* handle, int32_t* fmt_out) {
  return static_cast<LineReader*>(handle)->next(fmt_out);
}

void dmlc_feeder_before_first(void* handle) {
  static_cast<LineReader*>(handle)->before_first();
}

int64_t dmlc_feeder_bytes_read(void* handle) {
  return static_cast<LineReader*>(handle)->bytes_read();
}

int64_t dmlc_feeder_parse_busy_ns(void* handle) {
  return static_cast<LineReader*>(handle)->parse_busy_ns();
}

const char* dmlc_feeder_error(void* handle) {
  return static_cast<LineReader*>(handle)->error();
}

void dmlc_feeder_destroy(void* handle) {
  delete static_cast<LineReader*>(handle);
}

void* dmlc_indexed_reader_create(const char** paths, const int64_t* sizes,
                                 int32_t nfiles, const int64_t* index_offsets,
                                 int64_t n_index, int64_t part_index,
                                 int64_t num_parts, int64_t batch_records,
                                 int32_t shuffle, uint64_t seed,
                                 int32_t queue_depth) {
  try {
    std::vector<std::string> p(paths, paths + nfiles);
    std::vector<int64_t> s(sizes, sizes + nfiles);
    std::vector<int64_t> idx(index_offsets, index_offsets + n_index);
    return new IndexedReader(std::move(p), std::move(s), std::move(idx),
                             part_index, num_parts, batch_records,
                             shuffle != 0, seed, queue_depth);
  } catch (...) {
    return nullptr;
  }
}

void* dmlc_indexed_reader_next(void* handle) {
  return static_cast<IndexedReader*>(handle)->next();
}

void dmlc_indexed_reader_before_first(void* handle) {
  static_cast<IndexedReader*>(handle)->before_first();
}

void dmlc_indexed_reader_skip(void* handle, int64_t epochs, int64_t records) {
  static_cast<IndexedReader*>(handle)->skip(epochs, records);
}

int64_t dmlc_indexed_reader_bytes_read(void* handle) {
  return static_cast<IndexedReader*>(handle)->bytes_read();
}

const char* dmlc_indexed_reader_error(void* handle) {
  return static_cast<IndexedReader*>(handle)->error();
}

void dmlc_indexed_reader_destroy(void* handle) {
  delete static_cast<IndexedReader*>(handle);
}

}  // extern "C"
