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
// What bounds it: bytes. Each slot reads 4 B of idx and 4 B of val, gathers
// one 4 B word of w and does one multiply-add: about 0.25 FLOP a byte, some
// 80x below where the fp32 units would be the limit, and a gather-FMA has
// no dense product for the tensor cores to take. So no tensor cores; the
// design only moves bytes well:
//
// - Rows packed across the lanes. L lanes share a row and a warp's tile is
//   one pass of its lanes, 32 / L consecutive rows; each lane takes every
//   L-th group of its row (a 16-byte vector when K % 4 == 0, else a word)
//   and a fixed shuffle tree over the L lanes sums the parts. With L = 1
//   (K <= 32 on the persistent route) lane r sums row r alone, with no
//   shuffles. No lane idles while its warp has rows. Sums are fp32.
// - w in shared memory. A table of at most kTableSmemBytes (4096 words:
//   the TPU band's 2049) is staged in shared memory once per block, by one
//   cp.async.bulk when w starts 16-byte aligned (else with coalesced
//   loads), and every gather reads it there. A wider table (a hashed
//   2^20-word one) is gathered through the read-only path and L2, where it
//   stays resident; so is, on the one-pass route, a table of at most
//   kTableL1Bytes (the main path's 29 words), which L1 keeps after the
//   first gathers: staging it only added a round trip.
// - Two routes, by batch size alone (PERF.md quotes the sweep of routes,
//   L and table places that set the rule):
//   - One pass (B <= kOnePassMaxRows, the main path's 8192 rows): every
//     warp takes exactly one tile, L = 8 (fewer when a row has fewer
//     groups), rows read straight from device memory, each L-lane group
//     over one row's contiguous bytes. At these sizes the kernel sits near
//     the launch floor, and the shortest chain of dependent steps wins.
//   - Persistent, asynchronous and double-buffered (B > kOnePassMaxRows:
//     58.7 MB at 262,144 x 28; no batch of the main path is that large,
//     and at that size the sweep found it 1.4% behind the one-pass
//     route). A few blocks per SM (the SM count is read from
//     the device), each warp walking tiles warp, warp + all warps, ... A
//     tile's idx and val rows are contiguous, so lane 0 brings each into
//     the warp's own shared memory with one cp.async.bulk apiece,
//     completing on the stage's mbarrier, and issues tile i + 1's copies
//     before it waits for tile i: the copy overlaps the sums. Tiles start
//     (32 / L) * K * 4 bytes apart, a multiple of 16 (staging asks for
//     it), so every tile starts 16-byte aligned when idx and val do; the
//     last tile's size may not be a multiple of 16 bytes, and its last
//     words (at most three an array) are copied by lane 0 with plain loads
//     before it arrives on the barrier. Where idx or val does not start
//     16-byte aligned, or K > kMaxStagedK, the warps read their tiles
//     straight from device memory.
// - No bank conflicts on the row stride. With L = 1, lane r's row starts
//   r * K words into the staged tile; read in k order, K = 28 would put 4
//   lanes on one bank. A 16-byte vector read serves 8 lanes a pass, and 8
//   rows of 7 vectors fall in 8 distinct bank groups. Where K's stride does
//   collide (an even number of groups), lane r starts its row at group r
//   and wraps around, which spreads the lanes.
//
// The order of each row's sum depends only on K, L and the lane, so a
// given shape gives the same bits on every run. An index outside [0, W)
// contributes nothing (the plain version raises on it): the kernel never
// reads outside the table.
//
// Host interface: plain C, loaded with ctypes. The launch goes on the
// caller's stream, does not synchronise and allocates nothing; the return
// value is cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "k1_tiles.cuh"

namespace {

using namespace dmlc_k1;

constexpr int kMaxWarps = 4;                    // warps a block
constexpr int64_t kMaxStagedK = 64;             // two stages of 32 rows: 32 KB a warp
constexpr int64_t kTableSmemBytes = 16 * 1024;  // w staged up to 4096 words
constexpr int64_t kTableL1Bytes = 1024;         // one pass: smaller tables stay in L1
constexpr int64_t kOnePassMaxRows = 65536;      // the one-pass route's batches
constexpr int64_t kSmemPerSm = 200 * 1024;      // for the blocks an SM can hold
constexpr int64_t kMaxBlocksPerSm = 8;

template <bool kTableSmem>
__device__ __forceinline__ float gather(const float* table, uint32_t i) {
  return kTableSmem ? table[i] : __ldg(table + i);
}

template <bool kTableSmem>
__device__ __forceinline__ void fma_slot(float& acc, const float* table, uint32_t table_size,
                                         int32_t i, float v) {
  // unsigned compare: a negative index wraps high and is skipped too
  const uint32_t u = static_cast<uint32_t>(i);
  if (u < table_size) acc = fmaf(gather<kTableSmem>(table, u), v, acc);
}

// Lanes that share a row (a power of two), from the route sweep PERF.md
// quotes. One pass: enough lanes for a row's groups (see for_row_groups), at
// most 8. Persistent: 1 up to K = 32 (lane r sums row r alone); wider rows
// K / 8 rounded up. At most 32 either way.
int lanes_per_row(int64_t num_k, bool one_pass) {
  const int64_t groups = num_k % 4 == 0 ? num_k / 4 : num_k;
  if (num_k <= 64 && one_pass) {
    int lanes = 1;
    while (lanes < 8 && lanes < groups) lanes <<= 1;
    return lanes;
  }
  if (num_k <= 32) return 1;
  int lanes = 2;
  while (lanes < 32 && lanes * 8 < num_k) lanes <<= 1;
  return lanes;
}

// One lane's part of a row (see for_row_groups), summed in fp32.
template <bool kGlobal, bool kTableSmem, bool kVec>
__device__ __forceinline__ float row_part(const int32_t* row_idx, const float* row_val,
                                          const float* table, uint32_t table_size,
                                          int num_k, int first, int step_shift, bool wrap) {
  float acc = 0.0f;
  for_row_groups<kGlobal, kVec>(row_idx, row_val, num_k, first, step_shift, wrap,
                                [&](int32_t i, float v) {
                                  fma_slot<kTableSmem>(acc, table, table_size, i, v);
                                });
  return acc;
}

// The warp's sums for a tile of `rows` (<= 32 >> lane_shift) rows at
// tile_idx / tile_val ([rows, K] each), written to out[0 .. rows):
// 2^lane_shift lanes a row, their parts summed by a fixed shuffle tree.
template <bool kGlobal, bool kTableSmem, bool kVec>
__device__ __forceinline__ void tile_sums(const int32_t* tile_idx, const float* tile_val,
                                          const float* table, uint32_t table_size,
                                          float* out, int64_t rows, int num_k, int lane,
                                          int lane_shift) {
  const int lanes = 1 << lane_shift;
  const int r = lane >> lane_shift;
  const int sub = lane & (lanes - 1);
  float acc = 0.0f;
  if (r < rows) {
    const bool alone = lane_shift == 0;
    acc = row_part<kGlobal, kTableSmem, kVec>(tile_idx + r * num_k, tile_val + r * num_k,
                                              table, table_size, num_k,
                                              alone ? first_group(num_k, lane) : sub,
                                              lane_shift, alone);
  }
  for (int off = 1; off < lanes; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0 && r < rows) out[r] = acc;
}

template <bool kStaged, bool kTableSmem, bool kVec>
__global__ void __launch_bounds__(kMaxWarps * 32)
ell_matvec_kernel(const float* __restrict__ w, const int32_t* __restrict__ idx,
                  const float* __restrict__ val, float* __restrict__ out,
                  int64_t num_rows, int num_k, uint32_t table_size, int lane_shift,
                  int64_t num_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kMaxWarps][2];
  __shared__ __align__(8) uint64_t table_bar;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int tile_rows = 32 >> lane_shift;  // one pass of the warp's lanes
  const int64_t tile_words = static_cast<int64_t>(tile_rows) * num_k;
  const int64_t stage_bytes = 2 * tile_words * 4;
  unsigned char* stages = smem + warp * 2 * stage_bytes;
  float* s_table = reinterpret_cast<float*>(smem + (kStaged ? warps * 2 * stage_bytes : 0));
  const int64_t all_warps = static_cast<int64_t>(gridDim.x) * warps;
  int64_t tile = static_cast<int64_t>(blockIdx.x) * warps + warp;
  const bool table_bulk = kTableSmem && (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  if (kStaged && lane == 0) {
    mbar_init(&bars[warp][0], 1);
    mbar_init(&bars[warp][1], 1);
  }
  if (table_bulk && tid == 0) mbar_init(&table_bar, 1);
  if ((kStaged && lane == 0) || (table_bulk && tid == 0)) {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (kStaged && lane == 0 && tile < num_tiles) {
    issue_tile(stages, tile_words, &bars[warp][0], idx, val, num_rows, num_k, tile_rows, tile);
  }
  if (kTableSmem) {
    if (table_bulk) {
      if (tid == 0) {
        const uint32_t bytes = table_size * 4;
        const uint32_t bulk = bytes & ~15u;
        for (uint32_t i = bulk / 4; i < table_size; ++i) s_table[i] = w[i];
        if (bulk == 0) {
          mbar_arrive(&table_bar);
        } else {
          mbar_arrive_expect_tx(&table_bar, bulk);
          bulk_copy_g2s(s_table, w, bulk, &table_bar);
        }
      }
    } else {
      for (uint32_t i = tid; i < table_size; i += blockDim.x) s_table[i] = __ldg(w + i);
    }
  }
  __syncthreads();
  if (table_bulk) {
    while (!mbar_try_wait(&table_bar, 0)) {
    }
  }
  const float* table = kTableSmem ? s_table : w;

  uint32_t phase = 0;  // bit s: the parity stage s waits for next
  for (int it = 0; tile < num_tiles; tile += all_warps, ++it) {
    const int stage = it & 1;
    const int64_t row0 = tile * tile_rows;
    const int64_t rows = min(static_cast<int64_t>(tile_rows), num_rows - row0);
    if (kStaged) {
      const int64_t next = tile + all_warps;
      // the other stage was last read in the previous iteration, which
      // ended in __syncwarp
      if (lane == 0 && next < num_tiles) {
        issue_tile(stages + (stage ^ 1) * stage_bytes, tile_words, &bars[warp][stage ^ 1],
                   idx, val, num_rows, num_k, tile_rows, next);
      }
      while (!mbar_try_wait(&bars[warp][stage], (phase >> stage) & 1u)) {
      }
      phase ^= 1u << stage;
      tile_sums<false, kTableSmem, kVec>(
          reinterpret_cast<const int32_t*>(stages + stage * stage_bytes),
          reinterpret_cast<const float*>(stages + stage * stage_bytes + tile_words * 4),
          table, table_size, out + row0, rows, num_k, lane, lane_shift);
      __syncwarp();
    } else {
      tile_sums<true, kTableSmem, kVec>(idx + row0 * num_k, val + row0 * num_k, table,
                                        table_size, out + row0, rows, num_k, lane,
                                        lane_shift);
    }
  }
}

using Kernel = void (*)(const float*, const int32_t*, const float*, float*, int64_t, int,
                        uint32_t, int, int64_t);

// Launch one instantiation, raising its dynamic shared memory limit once
// per device when it needs more than the default 48 KB.
cudaError_t launch(Kernel kernel, int variant, int dev, unsigned int grid, int threads,
                   size_t smem, cudaStream_t stream, const float* w, const int32_t* idx,
                   const float* val, float* out, int64_t num_rows, int num_k,
                   uint32_t table_size, int lane_shift, int64_t num_tiles) {
  static size_t granted[8][64] = {};
  if (smem > 48 * 1024 && dev >= 0 && dev < 64 && granted[variant][dev] < smem) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
    granted[variant][dev] = smem;
  }
  kernel<<<grid, threads, smem, stream>>>(w, idx, val, out, num_rows, num_k, table_size,
                                          lane_shift, num_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dmlc_ell_matvec_f32(const float* w, const int32_t* idx,
                                   const float* val, float* out,
                                   int64_t num_rows, int64_t num_k,
                                   int64_t table_size, cudaStream_t stream) {
  if (num_rows <= 0) return static_cast<int>(cudaSuccess);
  if (num_k < 0 || num_k > 0x7fffffffLL / 32 || table_size < 0 ||
      table_size > 0xffffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_k == 0 || table_size == 0) {
    return static_cast<int>(cudaMemsetAsync(out, 0, num_rows * sizeof(float), stream));
  }
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int sms = sm_count(dev);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(val)) & 15) == 0;
  const bool one_pass = num_rows <= kOnePassMaxRows;
  const bool vec = num_k % 4 == 0 && aligned;
  // a table of a few hundred words stays in L1 once gathered: staging it
  // would only add a round trip before the first gather
  const bool table_smem = table_size * 4 <= kTableSmemBytes &&
                          (!one_pass || table_size * 4 > kTableL1Bytes);
  const int lanes = lanes_per_row(num_k, one_pass);
  const int tile_rows = 32 / lanes;
  const int64_t num_tiles = (num_rows + tile_rows - 1) / tile_rows;
  // bulk copies need 16-byte starts and sizes: aligned arrays, and tiles
  // of a multiple of 4 words
  const bool staged =
      !one_pass && aligned && num_k <= kMaxStagedK && (tile_rows * num_k) % 4 == 0;
  // 4 warps a block once the tiles fill the card, else 2 (more SMs)
  const int warps = num_tiles >= 4LL * sms ? 4 : 2;
  const size_t table_bytes = table_smem ? (table_size * 4 + 15) / 16 * 16 : 0;  // 16-B aligned
  const size_t smem = (staged ? warps * 4 * tile_rows * num_k * 4 : 0) + table_bytes;
  int64_t grid = (num_tiles + warps - 1) / warps;  // one pass: a tile a warp
  if (!one_pass) {
    int64_t per_sm = smem > 0 ? kSmemPerSm / static_cast<int64_t>(smem) : kMaxBlocksPerSm;
    per_sm = per_sm < 1 ? 1 : (per_sm > kMaxBlocksPerSm ? kMaxBlocksPerSm : per_sm);
    if (grid > sms * per_sm) grid = sms * per_sm;
  }
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned int g = static_cast<unsigned int>(grid);
  const int t = warps * 32;
  const int k = static_cast<int>(num_k);
  const uint32_t ws = static_cast<uint32_t>(table_size);
  const int variant = (staged ? 4 : 0) + (table_smem ? 2 : 0) + (vec ? 1 : 0);
  static const Kernel kernels[8] = {
      ell_matvec_kernel<false, false, false>, ell_matvec_kernel<false, false, true>,
      ell_matvec_kernel<false, true, false>,  ell_matvec_kernel<false, true, true>,
      ell_matvec_kernel<true, false, false>,  ell_matvec_kernel<true, false, true>,
      ell_matvec_kernel<true, true, false>,   ell_matvec_kernel<true, true, true>};
  rc = launch(kernels[variant], variant, dev, g, t, smem, stream, w, idx, val, out, num_rows,
              k, ws, __builtin_ctz(static_cast<unsigned>(lanes)), num_tiles);
  return static_cast<int>(rc);
}

extern "C" const char* dmlc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
