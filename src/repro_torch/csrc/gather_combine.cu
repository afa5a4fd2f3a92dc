// Eq.-(5) encode: out[l, n, q] = sum_j w[l, j] * grads[l, subsets[l, n, j], q].
//
// Replaces: src/repro/kernels/coded_combine.py::gather_combine_pallas_lanes
// (_gather_combine_kernel), the TPU kernel that gathers every device's d
// subset rows of a (N, q_block) VMEM tile and weight-combines them.
//
// Bound on Hopper: bytes. The least traffic is one read of the (L, N, Q)
// gradient stack and one write of the (L, N, Q) output; each output element
// costs d products and d - 1 adds.
//
// Design (tile path): a block owns one lane and a tile of C consecutive
// columns over all N rows (kernels/tiles.py picks C from the lanes, N, Q and
// d, and the wrapper passes it in). It copies the lane's (N, C) tile of the
// stack into shared memory once (cp.async, 16 bytes a copy where the rows
// are 16-byte aligned), with the lane's (N, d) subset ids and d weights, so
// the stack is read from device memory once, not d times. Each thread then
// writes its share of the (N, C) outputs, four columns at a time where the
// rows are aligned, reading the d gathered rows from shared memory. The
// lanes and tiles run on one flat grid, so one launch covers any lane
// count. The sum over j runs j = 0, 1, ... with explicit round-to-nearest
// multiply and add (no FMA contraction), which is exactly the plain PyTorch
// version's arithmetic (kernels/ref.py::gather_combine_ref).
//
// Large-N path (C = 0: not even a 32-column tile fits in 227 KB): one block
// per (lane, device) row and 1,024 coordinates, each gathered row read from
// device memory; the same arithmetic, so the same bits.
//
// A row whose subset ids fall outside [0, N) reads nothing and is written
// as NaN: the host never reads the ids back, and no load leaves the stack.
// All offsets into the stack are 64-bit: N * Q exceeds 2^31 at LM width.
#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

using repro_tile::Cursor;

constexpr int kThreads = 256;
constexpr int kItems = 4;  // large-N path: coordinates per thread
constexpr int64_t kSmemMax = 232448;
constexpr int64_t kDefaultSmem = 48 * 1024;

// Whether a row's d subset ids all lie in [0, n).
__device__ __forceinline__ bool ids_in_range(const int32_t* ids, int d, int n) {
  bool ok = true;
  for (int j = 0; j < d; ++j) ok &= ids[j] >= 0 && ids[j] < n;
  return ok;
}

// The sum over the d subsets of row `ids` at tile column `c`, j = 0, 1, ...
__device__ __forceinline__ float combine(const float* tile, int cols, const int32_t* ids,
                                         const float* w, int d, int c) {
  float acc = __fmul_rn(w[0], tile[ids[0] * cols + c]);
  for (int j = 1; j < d; ++j) acc = __fadd_rn(acc, __fmul_rn(w[j], tile[ids[j] * cols + c]));
  return acc;
}

__device__ __forceinline__ float4 combine4(const float* tile, int cols, const int32_t* ids,
                                           const float* w, int d, int c) {
  const float4 x = *reinterpret_cast<const float4*>(tile + ids[0] * cols + c);
  float4 acc = make_float4(__fmul_rn(w[0], x.x), __fmul_rn(w[0], x.y), __fmul_rn(w[0], x.z),
                           __fmul_rn(w[0], x.w));
  for (int j = 1; j < d; ++j) {
    const float4 y = *reinterpret_cast<const float4*>(tile + ids[j] * cols + c);
    acc.x = __fadd_rn(acc.x, __fmul_rn(w[j], y.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(w[j], y.y));
    acc.z = __fadd_rn(acc.z, __fmul_rn(w[j], y.z));
    acc.w = __fadd_rn(acc.w, __fmul_rn(w[j], y.w));
  }
  return acc;
}

// Shared memory: the (n, cols) tile, the (n, d) ids, the d weights.
__global__ void __launch_bounds__(kThreads)
    gather_tile_kernel(const float* __restrict__ grads, const int32_t* __restrict__ subsets,
                       const float* __restrict__ weights, float* __restrict__ out, int n, int d,
                       int64_t q, int cols, int64_t tiles, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tile = reinterpret_cast<float*>(smem_raw);
  int32_t* s_idx = reinterpret_cast<int32_t*>(tile + n * cols);
  float* s_w = reinterpret_cast<float*>(s_idx + n * d);

  const int64_t lane = static_cast<int64_t>(blockIdx.x) / tiles;
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) % tiles) * cols;
  const int width = static_cast<int>(q - c0 < cols ? q - c0 : cols);
  repro_tile::stage_tile(tile, cols, grads + lane * n * q, n, q, c0, width, vec);

  // the ids and weights come in beside the tile, every copy in flight at once
  const int32_t* ids = subsets + lane * n * d;
  for (int e = threadIdx.x; e < n * d; e += blockDim.x) repro_tile::cp_async4(s_idx + e, ids + e);
  for (int j = threadIdx.x; j < d; j += blockDim.x) repro_tile::cp_async4(s_w + j, weights + lane * d + j);
  repro_tile::cp_async_wait_all();
  __syncthreads();

  float* dst = out + lane * n * q + c0;
  if (vec) {
    for (Cursor k(width / 4); k.row < n; k.next()) {
      const int32_t* row_ids = s_idx + k.row * d;
      const int c = 4 * k.col;
      const float4 v = ids_in_range(row_ids, d, n) ? combine4(tile, cols, row_ids, s_w, d, c)
                                                   : make_float4(NAN, NAN, NAN, NAN);
      *reinterpret_cast<float4*>(dst + k.row * q + c) = v;
    }
  } else {
    for (Cursor k(width); k.row < n; k.next()) {
      const int32_t* row_ids = s_idx + k.row * d;
      dst[k.row * q + k.col] = ids_in_range(row_ids, d, n) ? combine(tile, cols, row_ids, s_w, d, k.col) : NAN;
    }
  }
}

// Large-N path: block b is (lane, device) row b / col_blocks and
// coordinates [(b % col_blocks) * 1024, + 1024); four coordinates a thread,
// 256 apart, so the four loads of one step are in flight together.
__global__ void gather_rows_kernel(const float* __restrict__ grads, const int32_t* __restrict__ subsets,
                                   const float* __restrict__ weights, float* __restrict__ out, int n, int d,
                                   int64_t q, int64_t col_blocks) {
  extern __shared__ unsigned char smem_raw[];
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem_raw);
  float* s_w = reinterpret_cast<float*>(smem_raw + sizeof(int32_t) * d);

  const int64_t row = static_cast<int64_t>(blockIdx.x) / col_blocks;  // lane * n + device
  const int64_t lane = row / n;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    s_idx[j] = subsets[row * d + j];
    s_w[j] = weights[lane * d + j];
  }
  __syncthreads();

  const int64_t first = (static_cast<int64_t>(blockIdx.x) % col_blocks) * kThreads * kItems + threadIdx.x;
  bool bad = false;
  for (int j = 0; j < d; ++j) bad |= s_idx[j] < 0 || s_idx[j] >= n;
  if (bad) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t col = first + k * kThreads;
      if (col < q) out[row * q + col] = NAN;
    }
    return;
  }
  const float* lane_grads = grads + lane * static_cast<int64_t>(n) * q;
  float acc[kItems];
  const float* src = lane_grads + static_cast<int64_t>(s_idx[0]) * q;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t col = first + k * kThreads;
    acc[k] = col < q ? __fmul_rn(s_w[0], src[col]) : 0.f;
  }
  for (int j = 1; j < d; ++j) {
    src = lane_grads + static_cast<int64_t>(s_idx[j]) * q;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t col = first + k * kThreads;
      if (col < q) acc[k] = __fadd_rn(acc[k], __fmul_rn(s_w[j], src[col]));
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t col = first + k * kThreads;
    if (col < q) out[row * q + col] = acc[k];
  }
}

}  // namespace

// cols: the tile width from kernels/tiles.py (kernels/coded_combine.py::
// gather_tile), or 0 for the large-N path.
extern "C" int repro_gather_combine(const void* grads, const void* subsets, const void* weights, void* out,
                                    int lanes, int n, int d, int64_t q, int cols, void* stream) {
  if (lanes <= 0 || n <= 0 || d <= 0 || q <= 0 || cols < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grads);
  const int32_t* ids = static_cast<const int32_t*>(subsets);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  if (cols == 0) {
    const int64_t per_block = static_cast<int64_t>(kThreads) * kItems;
    const int64_t col_blocks = (q + per_block - 1) / per_block;
    const int64_t blocks = static_cast<int64_t>(lanes) * n * col_blocks;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(d) * (sizeof(int32_t) + sizeof(float));
    if (static_cast<int64_t>(smem) > kDefaultSmem) return static_cast<int>(cudaErrorInvalidValue);
    gather_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(g, ids, w, o, n, d, q, col_blocks);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t tiles = (q + cols - 1) / cols;
  const int64_t blocks = static_cast<int64_t>(lanes) * tiles;
  const int64_t smem = 4 * (static_cast<int64_t>(n) * cols + static_cast<int64_t>(n) * d + d);
  if (blocks > INT_MAX || smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = q % 4 == 0 && cols % 4 == 0 && repro_tile::aligned16(grads) && repro_tile::aligned16(out);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(gather_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gather_tile_kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem), s>>>(
      g, ids, w, o, n, d, q, cols, tiles, vec);
  return static_cast<int>(cudaGetLastError());
}
