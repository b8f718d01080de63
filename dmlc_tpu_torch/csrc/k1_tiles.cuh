// Shared by the K1 kernels (ell_matvec.cu, ell_matvec_dw.cu): mbarriers,
// one-dimensional bulk copies (cp.async.bulk) into shared memory, the copy
// of one row tile of an ELL batch, the order in which a lane walks its
// part of a row, and the SM count (row_scatter.cu takes that too).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dmlc_k1 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n\t.reg .pred p;\n\t"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
               "selp.u32 %0, 1, 0, p;\n\t}\n"
               : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// Lane 0: copy tile `tile` (rows tile_rows * tile ...) into a stage
// ([tile_rows * K] idx words, then as many val words) and arm the stage's
// barrier with the bytes in flight.
__device__ __forceinline__ void issue_tile(unsigned char* stage, int64_t tile_words,
                                           uint64_t* bar, const int32_t* idx,
                                           const float* val, int64_t num_rows,
                                           int num_k, int tile_rows, int64_t tile) {
  const int64_t row0 = tile * tile_rows;
  const int64_t rows = min(static_cast<int64_t>(tile_rows), num_rows - row0);
  const uint32_t bytes = static_cast<uint32_t>(rows * num_k * 4);
  const uint32_t bulk = bytes & ~15u;
  int32_t* dst_idx = reinterpret_cast<int32_t*>(stage);
  float* dst_val = reinterpret_cast<float*>(stage + tile_words * 4);
  const int32_t* src_idx = idx + row0 * num_k;
  const float* src_val = val + row0 * num_k;
  for (uint32_t k = bulk / 4; k < bytes / 4; ++k) {
    dst_idx[k] = src_idx[k];
    dst_val[k] = src_val[k];
  }
  // order the warp's earlier generic-proxy reads of the stage before the
  // async-proxy writes below
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (bulk == 0) {
    mbar_arrive(bar);
    return;
  }
  mbar_arrive_expect_tx(bar, 2 * bulk);
  bulk_copy_g2s(dst_idx, src_idx, bulk, bar);
  bulk_copy_g2s(dst_val, src_val, bulk, bar);
}

template <bool kGlobal, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// The group (see for_row_groups) at which a lane alone on its row starts,
// wrapping around: spreads a warp's lanes over the shared-memory banks
// where the row stride alone would not (ell_matvec.cu's header). A function
// of K and the lane alone.
__device__ __forceinline__ int first_group(int num_k, int lane) {
  const int n = (num_k & 3) == 0 ? num_k >> 2 : num_k;
  return (n & 1) == 0 ? lane % n : 0;
}

// f(idx, val) for one lane's slots of a row, in a fixed order: groups
// first, first + 2^step_shift, ..., wrapping around once `wrap` is set (a
// lane alone on its row), else stopping at the row's end. A group is 4
// slots when K % 4 == 0 (one 16-byte vector with kVec, else four words in
// the same order), else one slot. Shifts, not divisions: the lanes a row
// are a power of two, and this runs before a lane's first load.
template <bool kGlobal, bool kVec, typename F>
__device__ __forceinline__ void for_row_groups(const int32_t* row_idx, const float* row_val,
                                               int num_k, int first, int step_shift,
                                               bool wrap, F&& f) {
  const bool quad = (num_k & 3) == 0;
  const int n = quad ? num_k >> 2 : num_k;
  const int step = 1 << step_shift;
  const int count = wrap ? n : (n - first + step - 1) >> step_shift;
  int v = first;
  for (int s = 0; s < count; ++s) {
    if (quad) {
      int4 i4;
      float4 f4;
      if constexpr (kVec) {
        i4 = load<kGlobal>(reinterpret_cast<const int4*>(row_idx) + v);
        f4 = load<kGlobal>(reinterpret_cast<const float4*>(row_val) + v);
      } else {
        const int32_t* pi = row_idx + 4 * v;
        const float* pv = row_val + 4 * v;
        i4 = make_int4(load<kGlobal>(pi), load<kGlobal>(pi + 1), load<kGlobal>(pi + 2),
                       load<kGlobal>(pi + 3));
        f4 = make_float4(load<kGlobal>(pv), load<kGlobal>(pv + 1), load<kGlobal>(pv + 2),
                         load<kGlobal>(pv + 3));
      }
      f(i4.x, f4.x);
      f(i4.y, f4.y);
      f(i4.z, f4.z);
      f(i4.w, f4.w);
    } else {
      f(load<kGlobal>(row_idx + v), load<kGlobal>(row_val + v));
    }
    v += step;
    if (v >= n) v -= n;
  }
}

inline int sm_count(int dev) {
  static int cached[64] = {0};
  if (dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0) {
      n = 132;
    }
    cached[dev] = n;
  }
  return cached[dev];
}

}  // namespace dmlc_k1
