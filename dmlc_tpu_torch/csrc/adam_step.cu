// Adam's update for Hopper (sm_90a) in one pass over every leaf of a
// parameter list:
//
//   m = m*b1 + g*(1 - b1)
//   v = v*b2 + (g*g)*(1 - b2)
//   d = sqrt(v) / sqrt(1 - b2^t) + eps
//   p = p - (m / d) * (lr / (1 - b1^t))
//
// for float32 p, g, m and v of one length each, in place. No TPU kernel is
// replaced: the JAX package leaves optax.adam's update to XLA. It takes the
// place of torch.optim.Adam's default foreach update on the card, which
// makes seven passes (lerp, mul, addcmul, sqrt into a full-size temporary,
// div, add, addcdiv): about 72 bytes a parameter and one more tensor of
// the parameters' size.
//
// What bounds it: bytes. Each element is read once from p, g, m and v and
// written once to p, m and v, 28 bytes a parameter, against 13
// floating-point operations: at the card's 3.35 TB/s the least time for
// P parameters is 28 P / 3.35e12 s (4.11 ms for the KDD12 FM's 492 M).
// So the design moves one pass's bytes and keeps every intermediate in
// registers:
//
// - each thread holds kUnrollFull float4s of each of the four streams in
//   flight (16-byte loads, neighbouring threads on neighbouring
//   addresses), then writes its p, m and v back;
// - loads and stores carry streaming hints (__ldcs / __stcs): a step moves
//   gigabytes, which never fit the 50 MB L2;
// - one launch covers up to kMaxLeaves leaves: a block finds its leaf by
//   the first block each leaf owns, passed by value with the leaves'
//   pointers and lengths. A leaf whose four pointers are not all 16-byte
//   aligned goes a float a thread; the n % 4 floats after a leaf's last
//   float4 (a 0-d leaf's one) are taken by its first block.
//
// Reading the gradient only where it can be non-zero. An FM step's
// gradient is +0.0 on every row its batch did not hit (the row scatter
// writes +0.0 there), and a Criteo batch hits 0.17% of the table's rows.
// Adam with g = +0.0 is still a full update (m and v decay, p moves), so a
// leaf may come with a mask, one bit a row of `width` floats, of the rows
// whose gradient may be non-zero: a float4 (or a float) loads g only if a
// row it covers is marked and takes +0.0 otherwise, which gives the same
// bits as reading the +0.0. That drops the gradient read, 24 bytes a
// parameter instead of 28, plus the mask's one bit a row. The masked path
// is its own instantiation (adam_step_kernel<true>), taken when any leaf
// of the launch has a mask, so the full path's code stays as it was; a
// leaf without a mask in a masked launch is a block-uniform branch.
// dmlc_adam_mark_rows builds a mask from a step's ids: one memset of the
// words, then one atomicOr a id (integer atomics: the same words in any
// order).
//
// Every operation is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn), so no multiply-add is contracted and the result
// has fixed bits: those of the same formula in separate float32 PyTorch
// operations (ops/adam.py adam_step_ordered_plain_), bit for bit.
//
// Host interface: plain C, loaded with ctypes. The launch goes on the
// caller's stream, does not synchronise and allocates nothing. The bias
// corrections come from the caller, computed on the host from its step
// counts. The return value is cudaGetLastError() after the launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// float4s of each stream a thread holds in flight: 4 on the full path (80
// registers, 3 blocks an SM); 2 on the masked one, whose mask words take
// registers of their own (at 4: 104 registers, 2 blocks an SM, 86-87% of
// the 24-byte bound on an H100; at 2: 64 registers, 4 blocks, 88.6-88.7%)
constexpr int kUnrollFull = 4;
constexpr int kUnrollMasked = 2;
constexpr int kMaxLeaves = 8;

// a block's float4s, or its floats in a leaf that is not 16-byte aligned
constexpr int64_t block_units(bool masked) {
  return int64_t{kThreads} * (masked ? kUnrollMasked : kUnrollFull);
}

}  // namespace

// One leaf, as the caller passes it (mirrored by ctypes in ops/_build.py).
struct DmlcAdamLeaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  int64_t n;
  float bias2_sqrt;  // sqrt(1 - b2^t)
  float step_size;   // lr / (1 - b1^t)
  // one bit a row (row r: bit r % 32 of word r / 32) of the rows whose
  // gradient may be non-zero; g is +0.0 on every other row and is not read
  // there. Null: every row is read.
  const uint32_t* mask;
  int64_t width;  // floats in a row; n is a multiple of it
};

namespace {

struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  int64_t n;
  int64_t block0;  // the leaf's first block; INT64_MAX for an unused slot
  float bias2_sqrt;
  float step_size;
  int vec;  // all four pointers 16-byte aligned
  const uint32_t* mask;
  int64_t width;
  int shift;  // log2(width) for a width that is a power of two, else -1
};

struct Args {
  Leaf leaf[kMaxLeaves];
  float b1, c1, b2, c2, eps;  // c1 = 1 - b1, c2 = 1 - b2
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v, float b1,
                                       float c1, float b2, float c2, float eps,
                                       float bias2_sqrt, float step_size) {
  m = __fadd_rn(__fmul_rn(m, b1), __fmul_rn(g, c1));
  v = __fadd_rn(__fmul_rn(v, b2), __fmul_rn(__fmul_rn(g, g), c2));
  const float d = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), bias2_sqrt), eps);
  p = __fsub_rn(p, __fmul_rn(__fdiv_rn(m, d), step_size));
}

// Whether a row in [r0, r1] is marked (r1 - r0 < 4, so the rows lie in
// one word or two), from the word that holds r0 and, where r1 lies in the
// next word, that word.
__device__ __forceinline__ bool any_marked(uint32_t lo, uint32_t hi, int64_t r0, int64_t r1) {
  if ((r0 >> 5) == (r1 >> 5)) return ((lo >> (r0 & 31)) & ((2u << (r1 - r0)) - 1u)) != 0;
  return (lo >> (r0 & 31)) != 0 || (hi & ((2u << (r1 & 31)) - 1u)) != 0;
}

__device__ __forceinline__ bool any_marked(const uint32_t* __restrict__ mask, int64_t r0,
                                           int64_t r1) {
  const uint32_t lo = __ldg(mask + (r0 >> 5));
  return any_marked(lo, (r1 >> 5) != (r0 >> 5) ? __ldg(mask + (r1 >> 5)) : 0u, r0, r1);
}

__device__ __forceinline__ int64_t row_of(int64_t j, int64_t width, int shift) {
  return shift >= 0 ? j >> shift : j / width;
}

template <bool kMasked>
__global__ void __launch_bounds__(kThreads) adam_step_kernel(const Args a) {
  constexpr int kUnroll = kMasked ? kUnrollMasked : kUnrollFull;
  constexpr int64_t kBlockUnits = int64_t{kThreads} * kUnroll;  // block_units(kMasked)
  // the leaf this block belongs to, read with constant indices only
  Leaf f = a.leaf[0];
#pragma unroll
  for (int i = 1; i < kMaxLeaves; ++i) {
    if (static_cast<int64_t>(blockIdx.x) >= a.leaf[i].block0) f = a.leaf[i];
  }
  float* __restrict__ p = f.p;
  const float* __restrict__ g = f.g;
  float* __restrict__ m = f.m;
  float* __restrict__ v = f.v;
  const int64_t b = static_cast<int64_t>(blockIdx.x) - f.block0;
  const float b1 = a.b1, c1 = a.c1, b2 = a.b2, c2 = a.c2, eps = a.eps;
  const float s2 = f.bias2_sqrt, step = f.step_size;
  // whether floats [lo, hi] of the leaf need their gradient loaded: always
  // on the full path; on the masked one where a row they cover is marked
  const uint32_t* __restrict__ mask = kMasked ? f.mask : nullptr;
  const auto read_g = [&](int64_t lo, int64_t hi) {
    return !kMasked || mask == nullptr ||
           any_marked(mask, row_of(lo, f.width, f.shift), row_of(hi, f.width, f.shift));
  };
  if (f.vec) {
    const int64_t nv = f.n >> 2;
    float4* __restrict__ p4 = reinterpret_cast<float4*>(p);
    const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g);
    float4* __restrict__ m4 = reinterpret_cast<float4*>(m);
    float4* __restrict__ v4 = reinterpret_cast<float4*>(v);
    const int64_t first = b * kBlockUnits + threadIdx.x;
    float4 rp[kUnroll], rg[kUnroll], rm[kUnroll], rv[kUnroll];
    // masked: the mask words of each float4's rows are loaded first, and g
    // (where a row is marked) after p, m and v, so that the wait for the
    // words overlaps the streams' loads instead of holding them back
    const bool masked = kMasked && mask != nullptr;
    uint32_t lo[kUnroll], hi[kUnroll];
    if (masked) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t i = first + int64_t{k} * kThreads;
        if (i < nv) {
          const int64_t r0 = row_of(i << 2, f.width, f.shift);
          const int64_t r1 = row_of((i << 2) + 3, f.width, f.shift);
          lo[k] = __ldg(mask + (r0 >> 5));
          hi[k] = (r1 >> 5) != (r0 >> 5) ? __ldg(mask + (r1 >> 5)) : 0u;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = first + int64_t{k} * kThreads;
      if (i < nv) {
        rp[k] = __ldcs(p4 + i);
        if (!masked) rg[k] = __ldcs(g4 + i);
        rm[k] = __ldcs(m4 + i);
        rv[k] = __ldcs(v4 + i);
      }
    }
    if (masked) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t i = first + int64_t{k} * kThreads;
        if (i < nv) {
          const int64_t r0 = row_of(i << 2, f.width, f.shift);
          const int64_t r1 = row_of((i << 2) + 3, f.width, f.shift);
          rg[k] = any_marked(lo[k], hi[k], r0, r1) ? __ldcs(g4 + i)
                                                   : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = first + int64_t{k} * kThreads;
      if (i < nv) {
        update(rp[k].x, rg[k].x, rm[k].x, rv[k].x, b1, c1, b2, c2, eps, s2, step);
        update(rp[k].y, rg[k].y, rm[k].y, rv[k].y, b1, c1, b2, c2, eps, s2, step);
        update(rp[k].z, rg[k].z, rm[k].z, rv[k].z, b1, c1, b2, c2, eps, s2, step);
        update(rp[k].w, rg[k].w, rm[k].w, rv[k].w, b1, c1, b2, c2, eps, s2, step);
        __stcs(p4 + i, rp[k]);
        __stcs(m4 + i, rm[k]);
        __stcs(v4 + i, rv[k]);
      }
    }
    // the floats after the last float4
    if (b == 0 && threadIdx.x < (f.n & 3)) {
      const int64_t i = (nv << 2) + threadIdx.x;
      float pi = __ldcs(p + i), mi = __ldcs(m + i), vi = __ldcs(v + i);
      update(pi, read_g(i, i) ? __ldcs(g + i) : 0.f, mi, vi, b1, c1, b2, c2, eps, s2, step);
      __stcs(p + i, pi);
      __stcs(m + i, mi);
      __stcs(v + i, vi);
    }
    return;
  }
  const int64_t first = b * kBlockUnits + threadIdx.x;
  float rp[kUnroll], rg[kUnroll], rm[kUnroll], rv[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t i = first + int64_t{k} * kThreads;
    if (i < f.n) {
      rp[k] = __ldcs(p + i);
      rg[k] = read_g(i, i) ? __ldcs(g + i) : 0.f;
      rm[k] = __ldcs(m + i);
      rv[k] = __ldcs(v + i);
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t i = first + int64_t{k} * kThreads;
    if (i < f.n) {
      update(rp[k], rg[k], rm[k], rv[k], b1, c1, b2, c2, eps, s2, step);
      __stcs(p + i, rp[k]);
      __stcs(m + i, rm[k]);
      __stcs(v + i, rv[k]);
    }
  }
}

// mask[r / 32] |= 1 << (r % 32) for each id r in [0, rows)
template <typename Id>
__global__ void __launch_bounds__(kThreads)
    mark_rows_kernel(const Id* __restrict__ ids, int64_t n, int64_t rows, uint32_t* mask) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t r = static_cast<int64_t>(ids[i]);
  if (r < 0 || r >= rows) return;
  const uint32_t bit = 1u << (r & 31);
  // a read from L2 first: a row that thousands of ids name (a field of a
  // few values) is set by the first of them, and the rest skip the atomic
  // instead of queueing on one word
  if ((__ldcg(mask + (r >> 5)) & bit) == 0) atomicOr(mask + (r >> 5), bit);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

int log2_exact(int64_t x) {
  int s = 0;
  while ((int64_t{1} << s) < x) ++s;
  return (int64_t{1} << s) == x ? s : -1;
}

}  // namespace

extern "C" int dmlc_adam_max_leaves() { return kMaxLeaves; }

// One launch for leaves[0..count): each leaf's n > 0 floats updated in
// place on `stream`; the masked instantiation when a leaf has a mask.
extern "C" int dmlc_adam_step_f32(const DmlcAdamLeaf* leaves, int count, float beta1,
                                  float one_minus_beta1, float beta2, float one_minus_beta2,
                                  float eps, void* stream) {
  if (count < 1 || count > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.b1 = beta1;
  a.c1 = one_minus_beta1;
  a.b2 = beta2;
  a.c2 = one_minus_beta2;
  a.eps = eps;
  bool masked = false;
  for (int i = 0; i < count; ++i) masked = masked || leaves[i].mask != nullptr;
  const int64_t units_a_block = block_units(masked);
  int64_t blocks = 0;
  for (int i = 0; i < kMaxLeaves; ++i) {
    Leaf& f = a.leaf[i];
    if (i >= count) {
      f = a.leaf[0];
      f.block0 = INT64_MAX;
      continue;
    }
    const DmlcAdamLeaf& in = leaves[i];
    if (in.n < 1 || (in.mask != nullptr && (in.width < 1 || in.n % in.width != 0))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    f.p = in.p;
    f.g = in.g;
    f.m = in.m;
    f.v = in.v;
    f.n = in.n;
    f.bias2_sqrt = in.bias2_sqrt;
    f.step_size = in.step_size;
    f.vec = aligned16(in.p) && aligned16(in.g) && aligned16(in.m) && aligned16(in.v);
    f.mask = in.mask;
    f.width = in.mask != nullptr ? in.width : 1;
    f.shift = log2_exact(f.width);
    const int64_t units = f.vec ? (in.n >> 2) : in.n;
    f.block0 = blocks;
    blocks += units > 0 ? (units + units_a_block - 1) / units_a_block : 1;
  }
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (masked) {
    adam_step_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  } else {
    adam_step_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The mask of the rows in [0, rows) that ids[0..n) name (int32 ids when
// id_bytes is 4, int64 when 8; ids outside [0, rows) mark nothing) into
// mask[0 .. ceil(rows / 32)), which is zeroed first, on `stream`.
extern "C" int dmlc_adam_mark_rows(const void* ids, int64_t n, int id_bytes, int64_t rows,
                                   uint32_t* mask, void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (n < 0 || rows < 1 || (id_bytes != 4 && id_bytes != 8) || blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(mask, 0, ((rows + 31) / 32) * sizeof(uint32_t), s);
  if (rc != cudaSuccess || n == 0) return static_cast<int>(rc);
  if (id_bytes == 4) {
    mark_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int32_t*>(ids), n, rows, mask);
  } else {
    mark_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int64_t*>(ids), n, rows, mask);
  }
  return static_cast<int>(cudaGetLastError());
}
