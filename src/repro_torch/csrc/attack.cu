// Byzantine attack construction: the Byzantine rows of an (L, N, Q) stack
// become coeff * m (sign-flip), mu - z * sqrt(var + 1e-12) (ALIE) or
// -eps * mu (IPM), where mu and var are the honest rows' mean and variance
// over N for each coordinate.
//
// Replaces: src/repro/kernels/attacks.py::attack_pallas_lanes
// (_sign_flip_kernel, _alie_kernel, _ipm_kernel; the TPU version computes
// the honest statistics outside the kernel in _stat_operands).
//
// Bound on Hopper: bytes. The least traffic is one read of the stack and
// one write of the output (out of place).
//
// Sign-flip: a flat elementwise pass over each lane's N * Q values, 16
// bytes a load and a store where the rows are 16-byte aligned.
//
// ALIE and IPM: a block owns one lane and a tile of C consecutive columns
// over all N rows (kernels/tiles.py picks C; the wrapper passes it in). It
// copies the lane's (N, C) tile into shared memory once (cp.async, 16 bytes
// a copy where the rows are aligned), computes the statistics from there,
// and writes the rows: honest rows copied from shared memory, Byzantine rows
// the adversary's vector. One read and one write of the stack. The
// statistics are fused in: the TPU version kept them outside only because
// of an artifact of its CPU interpret mode.
//
// Order: the honest count, the honest sum and (ALIE) the sum of squared
// deviations are numerics.tree_sum's tree over N: the N terms padded with
// zeros to the next power of two P, at each level the upper half added onto
// the lower half. The adds with the padding zeros are made, so a -0.0 term
// becomes +0.0 as in the plain version. For N > 16 (the paper's N=100) the
// tree runs across the block's threads, one level at a time in shared
// memory; for N <= 16 (the wide round's N=8) each thread adds its column's
// P terms in registers, the tree unrolled for each P, with no level to
// store and no barrier between levels. The terms are m * hw and
// (dev * dev) * hw (hw = 1 - mask), the divisor h = max(count, 1), and every
// operation is rounded on its own (no contraction), so the kernel equals
// kernels/ref.py::attack_ref bit for bit. The output is a new tensor; the
// input is never written.
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

using repro_tile::Cursor;

constexpr int kThreads = 256;
constexpr int kChunkVecs = 4;  // sign-flip: float4 (or single values) a thread a block
constexpr int64_t kChunk = static_cast<int64_t>(kThreads) * kChunkVecs * 4;  // values of a lane a block
constexpr int64_t kSmemMax = 232448;
constexpr int64_t kDefaultSmem = 48 * 1024;

enum Mode { kSignFlip = 0, kAlie = 1, kIpm = 2 };
constexpr int kRegMaxN = 16;  // up to this N the trees run in registers

__device__ __forceinline__ float flip(float coeff, float x) { return __fmul_rn(coeff, x); }
__device__ __forceinline__ float4 flip(float coeff, float4 x) {
  return make_float4(__fmul_rn(coeff, x.x), __fmul_rn(coeff, x.y), __fmul_rn(coeff, x.z), __fmul_rn(coeff, x.w));
}

// numerics.tree_sum of v[0..n) (P = the next power of two >= n, v[i] = 0
// for i >= n), in registers: level 1 adds v[i + P/2] (+0.0 past n) onto
// v[i], each later level the upper half onto the lower; P = 1: v[0] itself.
template <int P>
__device__ __forceinline__ float tree_registers(const float (&v)[P]) {
  if constexpr (P == 1) {
    return v[0];
  } else {
    float a[P / 2];
#pragma unroll
    for (int i = 0; i < P / 2; ++i) a[i] = __fadd_rn(v[i], v[i + P / 2]);
#pragma unroll
    for (int h = P / 4; h >= 1; h /= 2) {
#pragma unroll
      for (int i = 0; i < h; ++i) a[i] = __fadd_rn(a[i], a[i + h]);
    }
    return a[0];
  }
}

// Block (x, lane) flips the Byzantine rows' values among the lane's values
// [x * kChunk, (x + 1) * kChunk): each thread loads its kChunkVecs float4
// (or 4 x kChunkVecs single values), kThreads apart, all at once, then
// stores them. Its values rise, so its row only moves forward.
template <bool Vec>
__global__ void __launch_bounds__(kThreads)
    sign_flip_kernel(const float* __restrict__ msgs, const float* __restrict__ mask, float* __restrict__ out, int n,
                     int64_t q, float coeff) {
  using T = typename std::conditional<Vec, float4, float>::type;
  constexpr int kWidth = Vec ? 4 : 1;
  constexpr int kSteps = Vec ? kChunkVecs : 4 * kChunkVecs;
  const int64_t lane = blockIdx.y;
  const int64_t len = static_cast<int64_t>(n) * q;
  const T* m = reinterpret_cast<const T*>(msgs + lane * len);
  T* o = reinterpret_cast<T*>(out + lane * len);
  const float* mk = mask + lane * n;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kChunk + static_cast<int64_t>(threadIdx.x) * kWidth;
  T x[kSteps];
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int64_t f = first + static_cast<int64_t>(k) * kThreads * kWidth;
    if (f < len) x[k] = m[f / kWidth];
  }
  if (first >= len) return;
  int64_t row = first / q;
  int64_t row_end = (row + 1) * q;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int64_t f = first + static_cast<int64_t>(k) * kThreads * kWidth;
    if (f >= len) break;
    while (f >= row_end) {
      ++row;
      row_end += q;
    }
    if (mk[row] > 0.f) x[k] = flip(coeff, x[k]);
    o[f / kWidth] = x[k];
  }
}

// h = max(count, 1), as torch.clamp_min takes it: a NaN count stays NaN.
__device__ __forceinline__ float honest_divisor(float count) { return isnan(count) ? count : fmaxf(count, 1.f); }

// A column's adversarial value from its honest mean mu and (ALIE) its honest
// sum of squared deviations sq: mu - z * sqrt(sq / h + 1e-12), or -eps * mu.
__device__ __forceinline__ float adversary(int mode, float param, float mu, float sq, float h) {
  if (mode == kAlie) return __fsub_rn(mu, __fmul_rn(param, __fsqrt_rn(__fadd_rn(__fdiv_rn(sq, h), 1e-12f))));
  return __fmul_rn(-param, mu);
}

// acc[0 * cols + c] = numerics.tree_sum over i < n of leaf(i, c), for every
// c < cols, one level at a time: level 1 adds leaf(i + half) (or +0.0 past
// n) onto leaf(i) for i < half = P / 2, each later level the upper half of
// acc onto its lower half (n > kRegMaxN, so half >= 16).
template <typename Leaf>
__device__ __forceinline__ void tree_columns(float* acc, int cols, int n, int half, Leaf leaf) {
  for (Cursor k(cols); k.row < half; k.next()) {
    const int i = k.row;
    acc[i * cols + k.col] = __fadd_rn(leaf(i, k.col), i + half < n ? leaf(i + half, k.col) : 0.f);
  }
  __syncthreads();
  for (int h = half / 2; h >= 1; h /= 2) {
    for (Cursor k(cols); k.row < h; k.next()) {
      float* a = acc + k.row * cols + k.col;
      *a = __fadd_rn(*a, a[h * cols]);
    }
    __syncthreads();
  }
}

// The statistic of each of the tile's `width` columns through the
// shared-memory tree (tree_columns); ends with a barrier.
__device__ __forceinline__ void stats_shared(const float* tile, float* stat, float* acc, const float* hw, int n,
                                             int half, int cols, int width, int mode, float param) {
  // the honest sum of each column (m * hw) and, in column `width`, the honest count (hw)
  tree_columns(acc, width + 1, n, half, [&](int i, int c) {
    return c < width ? __fmul_rn(tile[i * cols + c], hw[i]) : hw[i];
  });
  const float h = honest_divisor(acc[width]);
  for (int c = threadIdx.x; c < width; c += blockDim.x) stat[c] = __fdiv_rn(acc[c], h);
  __syncthreads();

  if (mode == kAlie) {
    tree_columns(acc, width, n, half, [&](int i, int c) {
      const float dev = __fsub_rn(tile[i * cols + c], stat[c]);
      return __fmul_rn(__fmul_rn(dev, dev), hw[i]);
    });
  }
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    stat[c] = adversary(mode, param, stat[c], mode == kAlie ? acc[c] : 0.f, h);
  }
  __syncthreads();
}

// Shared memory: the (n, cols) tile, the (cols) statistic (the honest mean,
// then the adversary's vector), the n honest weights and, for the
// shared-memory tree (P = 0), its half x (width + 1) levels (column `width`:
// the honest count). P > 0: n <= P <= kRegMaxN, the trees in registers.
template <int P>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const float* __restrict__ msgs, const float* __restrict__ mask, float* __restrict__ out, int n,
                 int half, int64_t q, int cols, int mode, float param, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tile = reinterpret_cast<float*>(smem_raw);
  float* stat = tile + n * cols;
  float* hw = stat + cols;
  float* acc = hw + n;

  const int64_t lane = blockIdx.y;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * cols;
  const int width = static_cast<int>(q - c0 < cols ? q - c0 : cols);
  repro_tile::stage_tile(tile, cols, msgs + lane * n * q, n, q, c0, width, vec);
  const float* mk = mask + lane * n;
  for (int r = threadIdx.x; r < n; r += blockDim.x) hw[r] = __fsub_rn(1.f, mk[r]);
  repro_tile::cp_async_wait_all();
  __syncthreads();

  if constexpr (P > 0) {
    float v[P];
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = i < n ? hw[i] : 0.f;
    const float h = honest_divisor(tree_registers<P>(v));
    for (int c = threadIdx.x; c < width; c += blockDim.x) {
#pragma unroll
      for (int i = 0; i < P; ++i) v[i] = i < n ? __fmul_rn(tile[i * cols + c], hw[i]) : 0.f;
      const float mu = __fdiv_rn(tree_registers<P>(v), h);
      float sq = 0.f;
      if (mode == kAlie) {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const float dev = i < n ? __fsub_rn(tile[i * cols + c], mu) : 0.f;
          v[i] = i < n ? __fmul_rn(__fmul_rn(dev, dev), hw[i]) : 0.f;
        }
        sq = tree_registers<P>(v);
      }
      stat[c] = adversary(mode, param, mu, sq, h);
    }
    __syncthreads();
  } else {
    stats_shared(tile, stat, acc, hw, n, half, cols, width, mode, param);
  }

  float* dst = out + lane * n * q + c0;
  if (vec) {
    for (Cursor k(width / 4); k.row < n; k.next()) {
      const int c = 4 * k.col;
      const float* src = mk[k.row] > 0.f ? stat + c : tile + k.row * cols + c;
      *reinterpret_cast<float4*>(dst + k.row * q + c) = *reinterpret_cast<const float4*>(src);
    }
  } else {
    for (Cursor k(width); k.row < n; k.next()) {
      dst[k.row * q + k.col] = mk[k.row] > 0.f ? stat[k.col] : tile[k.row * cols + k.col];
    }
  }
}

}  // namespace

// cols: the ALIE/IPM tile width from kernels/tiles.py (kernels/attacks.py::
// attack_tile); sign-flip reads none.
extern "C" int repro_attack(const void* msgs, const void* mask, void* out, int lanes, int n, int64_t q, int mode,
                            float param, int cols, void* stream) {
  if (lanes <= 0 || lanes > 65535 || n <= 0 || q <= 0 || mode < kSignFlip || mode > kIpm ||
      (mode != kSignFlip && cols <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(msgs);
  const float* mk = static_cast<const float*>(mask);
  float* o = static_cast<float*>(out);
  const bool aligned = q % 4 == 0 && repro_tile::aligned16(msgs) && repro_tile::aligned16(out);
  if (mode == kSignFlip) {
    const int64_t blocks = (static_cast<int64_t>(n) * q + kChunk - 1) / kChunk;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(lanes));
    if (aligned) {
      sign_flip_kernel<true><<<grid, kThreads, 0, s>>>(m, mk, o, n, q, param);
    } else {
      sign_flip_kernel<false><<<grid, kThreads, 0, s>>>(m, mk, o, n, q, param);
    }
    return static_cast<int>(cudaGetLastError());
  }
  int p = 1;
  while (p < n) p <<= 1;
  const int half = p / 2;
  // the shared-memory tree's levels, none for the register trees
  const int64_t rows = n <= kRegMaxN ? 0 : half;
  const int64_t tiles = (q + cols - 1) / cols;
  const int64_t smem = 4 * (static_cast<int64_t>(n) * cols + cols + n + rows * (cols + 1));
  if (tiles > INT_MAX || smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(lanes));
  const bool vec = aligned && cols % 4 == 0;
  switch (n <= kRegMaxN ? p : 0) {
#define REPRO_ATTACK_STATS(P)                                                                                  \
  case P:                                                                                                      \
    if (smem > kDefaultSmem) {                                                                                 \
      const cudaError_t err = cudaFuncSetAttribute(stats_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                                   static_cast<int>(smem));                                    \
      if (err != cudaSuccess) return static_cast<int>(err);                                                    \
    }                                                                                                          \
    stats_kernel<P><<<grid, kThreads, static_cast<size_t>(smem), s>>>(m, mk, o, n, half, q, cols, mode, param, vec); \
    break;
    REPRO_ATTACK_STATS(0) REPRO_ATTACK_STATS(1) REPRO_ATTACK_STATS(2) REPRO_ATTACK_STATS(4) REPRO_ATTACK_STATS(8)
    REPRO_ATTACK_STATS(16)
#undef REPRO_ATTACK_STATS
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
