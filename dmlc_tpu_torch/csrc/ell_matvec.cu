// ELL sparse x dense matvec for Hopper (sm_90a):
//
//   out[b] = sum_k w[idx[b, k]] * val[b, k]
//
// Replaces the TPU kernel ell_matvec_pallas (dmlc_tpu/ops/pallas_sparse.py,
// kernel body _ell_kernel). That kernel builds a one-hot [D, bb] slab in
// VMEM and contracts it on the MXU only because Mosaic cannot gather; this
// card can, so the kernel is a direct gather: O(B*K) work instead of
// O(B*K*D), with no bound on the table width D.
//
// What bounds it: bytes. Each slot reads 4 B of idx and 4 B of val and one
// 4 B word of w, and does one fused multiply-add, far below the card's
// operations-per-byte balance. Design: one warp per row; the lanes stride
// over k, so the row-major idx/val loads of a warp are contiguous; each lane
// gathers w[idx] through the read-only cache path and L2 (w stays resident
// in the 50 MB L2 for every table this repository trains), accumulates in
// fp32, and a warp-shuffle reduction leaves the sum in lane 0, which writes
// out[b]. Any B and any K; no tile or band constraints.
//
// An index outside [0, W) contributes nothing (the plain version raises on
// it): the kernel never reads outside the table.
//
// Host interface: plain C, loaded with ctypes. The launch goes on the
// caller's stream, does not synchronise and allocates nothing; the return
// value is cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_matvec_kernel(const float* __restrict__ w,
                  const int32_t* __restrict__ idx,
                  const float* __restrict__ val,
                  float* __restrict__ out,
                  int64_t num_rows, int64_t num_k, int64_t table_size) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  // the whole warp shares one row, so it leaves together and the full-mask
  // shuffles below see all 32 lanes
  if (row >= num_rows) return;
  const int32_t* row_idx = idx + row * num_k;
  const float* row_val = val + row * num_k;
  float acc = 0.0f;
  for (int64_t k = lane; k < num_k; k += 32) {
    // unsigned compare: a negative index wraps high and is skipped too
    const uint64_t i = static_cast<uint32_t>(__ldg(row_idx + k));
    const float v = __ldg(row_val + k);
    if (i < static_cast<uint64_t>(table_size)) {
      acc = fmaf(__ldg(w + i), v, acc);
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, offset);
  }
  if (lane == 0) out[row] = acc;
}

}  // namespace

extern "C" int dmlc_ell_matvec_f32(const float* w, const int32_t* idx,
                                   const float* val, float* out,
                                   int64_t num_rows, int64_t num_k,
                                   int64_t table_size, cudaStream_t stream) {
  if (num_rows <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  ell_matvec_kernel<<<static_cast<unsigned int>(blocks), kWarpsPerBlock * 32, 0,
                      stream>>>(w, idx, val, out, num_rows, num_k, table_size);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dmlc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
