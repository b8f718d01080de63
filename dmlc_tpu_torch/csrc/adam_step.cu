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
// - each thread holds kUnroll float4s of each of the four streams in
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
constexpr int kUnroll = 4;  // float4s of each stream a thread holds in flight
// a block's float4s, or its floats in a leaf that is not 16-byte aligned
constexpr int64_t kBlockUnits = int64_t{kThreads} * kUnroll;
constexpr int kMaxLeaves = 8;

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

__global__ void __launch_bounds__(kThreads) adam_step_kernel(const Args a) {
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
  if (f.vec) {
    const int64_t nv = f.n >> 2;
    float4* __restrict__ p4 = reinterpret_cast<float4*>(p);
    const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g);
    float4* __restrict__ m4 = reinterpret_cast<float4*>(m);
    float4* __restrict__ v4 = reinterpret_cast<float4*>(v);
    const int64_t first = b * kBlockUnits + threadIdx.x;
    float4 rp[kUnroll], rg[kUnroll], rm[kUnroll], rv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = first + int64_t{k} * kThreads;
      if (i < nv) {
        rp[k] = __ldcs(p4 + i);
        rg[k] = __ldcs(g4 + i);
        rm[k] = __ldcs(m4 + i);
        rv[k] = __ldcs(v4 + i);
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
      update(pi, __ldcs(g + i), mi, vi, b1, c1, b2, c2, eps, s2, step);
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
      rg[k] = __ldcs(g + i);
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

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

extern "C" int dmlc_adam_max_leaves() { return kMaxLeaves; }

// One launch for leaves[0..count): each leaf's n > 0 floats updated in
// place on `stream`.
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
  int64_t blocks = 0;
  for (int i = 0; i < kMaxLeaves; ++i) {
    Leaf& f = a.leaf[i];
    if (i >= count) {
      f = a.leaf[0];
      f.block0 = INT64_MAX;
      continue;
    }
    const DmlcAdamLeaf& in = leaves[i];
    if (in.n < 1) return static_cast<int>(cudaErrorInvalidValue);
    f.p = in.p;
    f.g = in.g;
    f.m = in.m;
    f.v = in.v;
    f.n = in.n;
    f.bias2_sqrt = in.bias2_sqrt;
    f.step_size = in.step_size;
    f.vec = aligned16(in.p) && aligned16(in.g) && aligned16(in.m) && aligned16(in.v);
    const int64_t units = f.vec ? (in.n >> 2) : in.n;
    f.block0 = blocks;
    blocks += units > 0 ? (units + kBlockUnits - 1) / kBlockUnits : 1;
  }
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  adam_step_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
