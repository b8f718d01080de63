// Span widening for Hopper (sm_90a): a raw little-endian u8 container
// segment of rows * cols words becomes a fresh contiguous [rows, cols]
// float32 (itemsize 4) or bfloat16 (itemsize 2) tensor.
//
// Replaces the TPU kernel widen_span_pallas (dmlc_tpu/ops/device_decode.py,
// bodies _widen4_kernel / _widen2_kernel). That kernel took the segment as
// byte planes peeled outside the kernel and rebuilt each word with
// shift/or, only because Mosaic's cross-width bitcast moves the sublane
// dimension. This card is little-endian and byte-addressed: the segment's
// bytes already are the words, so the kernel reads them directly.
//
// What bounds it: bytes. Each word is read once and written once, with no
// arithmetic. Design: a grid-stride loop over 16-byte vectors (one uint4
// load and store per step; neighbouring threads on neighbouring vectors, so
// every warp moves 512 contiguous bytes) when the segment and the output
// both start 16-byte aligned, then a scalar loop over the last words. A
// segment whose start is not 16-byte aligned takes the scalar loop
// throughout: each word is assembled from its bytes with shift/or (the
// start may not even be word-aligned) and stored as one aligned word.
// Snapshot segments start 64-byte aligned within their batch's span and the
// span comes from the caching allocator (256-byte aligned), so the main
// path takes the vector loop.
//
// Host interface: plain C, loaded with ctypes. The launch goes on the
// caller's stream, does not synchronise and allocates nothing; the return
// value is cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks per SM, then stride

template <typename Word>
__device__ __forceinline__ Word load_le(const uint8_t* p) {
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < static_cast<int>(sizeof(Word)); ++b) {
    w |= static_cast<uint32_t>(p[b]) << (8 * b);
  }
  return static_cast<Word>(w);
}

template <typename Word>
__global__ void __launch_bounds__(kThreads)
widen_span_kernel(const uint8_t* __restrict__ seg, Word* __restrict__ out,
                  int64_t num_words, bool vector) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t first_scalar = 0;
  if (vector) {
    constexpr int64_t kWordsPerVec = 16 / sizeof(Word);
    const int64_t num_vec = num_words / kWordsPerVec;
    const uint4* src = reinterpret_cast<const uint4*>(seg);
    uint4* dst = reinterpret_cast<uint4*>(out);
    for (int64_t i = tid; i < num_vec; i += stride) {
      dst[i] = __ldg(src + i);
    }
    first_scalar = num_vec * kWordsPerVec;
  }
  for (int64_t i = first_scalar + tid; i < num_words; i += stride) {
    out[i] = load_le<Word>(seg + i * static_cast<int64_t>(sizeof(Word)));
  }
}

template <typename Word>
cudaError_t launch(const uint8_t* seg, void* out, int64_t num_words,
                   cudaStream_t stream) {
  const bool vector =
      ((reinterpret_cast<uintptr_t>(seg) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t per_thread = vector ? 16 / static_cast<int64_t>(sizeof(Word)) : 1;
  const int64_t work = (num_words + per_thread - 1) / per_thread;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  widen_span_kernel<Word><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      seg, static_cast<Word*>(out), num_words, vector);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dmlc_widen_span(const uint8_t* seg, void* out, int64_t rows,
                               int64_t cols, int itemsize, cudaStream_t stream) {
  if (rows < 0 || cols < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t num_words = rows * cols;
  if (num_words == 0) return static_cast<int>(cudaSuccess);
  if (itemsize == 4) return static_cast<int>(launch<uint32_t>(seg, out, num_words, stream));
  if (itemsize == 2) return static_cast<int>(launch<uint16_t>(seg, out, num_words, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}
