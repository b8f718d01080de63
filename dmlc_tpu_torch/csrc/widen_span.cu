// Span decode for Hopper (sm_90a): one launch turns one warm batch's raw
// little-endian container span into its typed outputs.
//
// Replaces the TPU kernel widen_span_pallas (dmlc_tpu/ops/device_decode.py,
// bodies _widen4_kernel / _widen2_kernel), and with it what the JAX
// package's decode_span compiles around that kernel into one XLA program a
// layout: the dequant_q8 multiply and the widen_f32 of bf16 aux columns.
// The TPU kernel took each segment as byte planes peeled outside the kernel
// and rebuilt each word with shift/or, only because Mosaic's cross-width
// bitcast moves the sublane dimension. This card is little-endian and
// byte-addressed: a segment's bytes already are its words.
//
// The host (dmlc_tpu_torch/ops/device_decode.py, DecodePlan) builds, once
// per (kind, layout, num_col), a table of at most kMaxOps entries and the
// byte offsets of the outputs inside one output allocation, each a multiple
// of 16. Segments that need no work (int32 indices, 1-D f32 label and
// weight columns) are views of the span and have no entry. An entry is:
//
//   COPY4, COPY2  an f32 or bf16 [rows, cols] slab, copied;
//   DEQUANT_Q8    an int8 [rows, cols] slab times the per-column f32 scale
//                 row at span + extra: __int2float_rn(q) * scale[c], one
//                 IEEE multiply, the bits of q.to(float32) * scale;
//   BF16_AUX      a packed bf16 [rows, cols] slab copied, and in the same
//                 pass its columns cols - 2 and cols - 1 (label, weight)
//                 widened into the f32 [2, rows] output at out + extra: the
//                 bf16 bits in the high half of the f32 word, exact.
//
// Work split: a thread takes one 16-byte output vector, a block kThreads of
// them. Each entry's first block is the prefix of the earlier entries'
// block counts, and a block finds its entry by scanning those prefixes.
// The table goes in by value as a __grid_constant__ kernel parameter, so
// nothing is copied to the card per batch.
//
// Loads: a vector whose source starts 16-byte aligned is one 16-byte load;
// any other (a span that does not start aligned, a segment's last partial
// vector) is assembled from its bytes, little-endian. Outputs start 16-byte
// aligned, so every full vector is one 16-byte store. Snapshot segments
// start 64-byte aligned within their batch's span, and the span comes from
// the caching allocator, so the main path loads whole vectors.
//
// What bounds it: bytes, and at the main path's sizes the launch itself
// (ELL values 8192 x 28 f32: 1.8 MB read and written, 0.55 us at 3.35 TB/s,
// against a launch floor near 2.5 us). So no TMA and no wgmma: the design's
// aim is one launch a batch, where the port issued one a float segment
// plus torch's cast and multiply, and a host path that builds the launch
// once a layout and not once a batch.
//
// Host interface: plain C, loaded with ctypes. The launch goes on the
// caller's stream, does not synchronise and allocates nothing; the return
// value is cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>

extern "C" {

// one entry of the table; ops/device_decode.py mirrors both structures
struct DmlcDecodeOp {
  int32_t op;
  int32_t reserved;
  int64_t src;          // byte offset of the segment in the span
  int64_t dst;          // byte offset of the output in out, a multiple of 16
  int64_t rows;
  int64_t cols;
  int64_t extra;        // DEQUANT_Q8: the scale row's byte offset in the span;
                        // BF16_AUX: the f32 [2, rows] output's in out
  int64_t first_block;  // the blocks of the entries before this one
};

struct DmlcDecodeTable {
  int32_t count;
  int32_t reserved;
  int64_t blocks;  // the grid: every entry's blocks
  DmlcDecodeOp ops[8];
};

}  // extern "C"

static_assert(sizeof(DmlcDecodeOp) == 56, "ops/device_decode.py mirrors this layout");
static_assert(sizeof(DmlcDecodeTable) == 464, "ops/device_decode.py mirrors this layout");

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOps = 8;
enum : int32_t { kCopy4 = 1, kCopy2 = 2, kDequantQ8 = 3, kBf16Aux = 4 };

// the n <= 16 bytes at p as four little-endian words, zero past n
__device__ __forceinline__ uint4 load_vec(const uint8_t* p, int n) {
  if (n == 16 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (b < n) w[b >> 2] |= static_cast<uint32_t>(__ldg(p + b)) << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// p is 16-byte aligned: a full vector is one store, a partial one bytes
__device__ __forceinline__ void store_vec(uint8_t* p, uint4 v, int n) {
  if (n == 16) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (b < n) p[b] = static_cast<uint8_t>(w[b >> 2] >> (8 * (b & 3)));
  }
}

__device__ __forceinline__ float load_f32(const uint8_t* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 3) == 0) return __ldg(reinterpret_cast<const float*>(p));
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) w |= static_cast<uint32_t>(__ldg(p + b)) << (8 * b);
  return __uint_as_float(w);
}

// COPY4 / COPY2: output vector v of an nbytes slab
__device__ __forceinline__ void copy_vec(const uint8_t* src, uint8_t* dst, int64_t nbytes,
                                         int64_t v) {
  const int64_t off = v * 16;
  const int n = static_cast<int>(nbytes - off < 16 ? nbytes - off : 16);
  store_vec(dst + off, load_vec(src + off, n), n);
}

// DEQUANT_Q8: output floats [4v, 4v + 4) of an [elems / cols, cols] slab;
// the scale row is read through the read-only path and L1
__device__ __forceinline__ void dequant_vec(const uint8_t* q, const uint8_t* scale, float* out,
                                            int64_t elems, uint32_t cols, int64_t v) {
  const int64_t e0 = v * 4;
  const int m = static_cast<int>(elems - e0 < 4 ? elems - e0 : 4);
  uint32_t bytes = 0;
  if (m == 4 && (reinterpret_cast<uintptr_t>(q + e0) & 3) == 0) {
    bytes = __ldg(reinterpret_cast<const uint32_t*>(q + e0));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < m) bytes |= static_cast<uint32_t>(__ldg(q + e0 + j)) << (8 * j);
    }
  }
  uint32_t c = static_cast<uint32_t>(e0) % cols;  // the plan keeps elems below 2^31
  float r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // byte j, sign-extended: the int8 value
    const int qj = static_cast<int>(bytes << (24 - 8 * j)) >> 24;
    r[j] = __fmul_rn(__int2float_rn(qj), load_f32(scale + 4 * static_cast<int64_t>(c)));
    if (++c == cols) c = 0;
  }
  if (m == 4) {
    *reinterpret_cast<float4*>(out + e0) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < m) out[e0 + j] = r[j];
    }
  }
}

// BF16_AUX: output vector v of a bf16 [rows, cols] slab, and the label and
// weight halfwords among its eight widened into aux [2, rows]
__device__ __forceinline__ void bf16_aux_vec(const uint8_t* src, uint8_t* dst, float* aux,
                                             int64_t rows, uint32_t cols, int64_t v) {
  const int64_t nbytes = rows * cols * 2;
  const int64_t off = v * 16;
  const int n = static_cast<int>(nbytes - off < 16 ? nbytes - off : 16);
  const uint4 vec = load_vec(src + off, n);
  store_vec(dst + off, vec, n);
  const uint32_t w[4] = {vec.x, vec.y, vec.z, vec.w};
  const uint32_t e0 = static_cast<uint32_t>(v * 8);
  uint32_t r = e0 / cols;
  uint32_t c = e0 - r * cols;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (2 * j < n && c + 2 >= cols) {
      const uint32_t bits = (w[j >> 1] >> (16 * (j & 1))) << 16;
      aux[static_cast<int64_t>(c + 2 - cols) * rows + r] = __uint_as_float(bits);
    }
    if (++c == cols) {
      c = 0;
      ++r;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
decode_span_kernel(const uint8_t* __restrict__ span, uint8_t* __restrict__ out,
                   const __grid_constant__ DmlcDecodeTable table) {
  const int64_t block = blockIdx.x;
  int e = 0;
#pragma unroll 1
  while (e + 1 < table.count && block >= table.ops[e + 1].first_block) ++e;
  const DmlcDecodeOp& op = table.ops[e];
  const int64_t v = (block - op.first_block) * kThreads + threadIdx.x;
  const int64_t elems = op.rows * op.cols;
  switch (op.op) {
    case kCopy4:
    case kCopy2: {
      const int64_t nbytes = elems * (op.op == kCopy4 ? 4 : 2);
      if (v * 16 < nbytes) copy_vec(span + op.src, out + op.dst, nbytes, v);
      break;
    }
    case kDequantQ8:
      if (v * 4 < elems) {
        dequant_vec(span + op.src, span + op.extra, reinterpret_cast<float*>(out + op.dst),
                    elems, static_cast<uint32_t>(op.cols), v);
      }
      break;
    case kBf16Aux:
      if (v * 8 < elems) {
        bf16_aux_vec(span + op.src, out + op.dst, reinterpret_cast<float*>(out + op.extra),
                     op.rows, static_cast<uint32_t>(op.cols), v);
      }
      break;
    default:
      break;
  }
}

}  // namespace

extern "C" int dmlc_decode_span(const uint8_t* span, void* out, const DmlcDecodeTable* table,
                                cudaStream_t stream) {
  if (table == nullptr || table->count < 1 || table->count > kMaxOps || table->blocks < 1 ||
      table->blocks > 0x7fffffffLL || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  decode_span_kernel<<<static_cast<unsigned int>(table->blocks), kThreads, 0, stream>>>(
      span, static_cast<uint8_t*>(out), *table);
  return static_cast<int>(cudaGetLastError());
}
