// Gram matrix and row norms for NNM distances: for each lane,
// gram = X X^T (N, N) and sq = row-wise sum of squares (N,), in fp32.
//
// Replaces: src/repro/kernels/nnm_dist.py::gram_pallas_lanes (_gram_kernel),
// the TPU kernel that accumulates X X^T and the row norms over a sequential
// grid of q tiles into one output block.
//
// Bound on Hopper: bytes at small N (one read of the (L, N, Q) stack; the
// outputs are tiny), fp32 operations (2 N^2 Q) once N is large.
//
// Design: Hopper blocks run in no order, so nothing carries over between
// them. The Q axis is cut into chunks, one block per (chunk, lane); every
// block writes the upper triangle of its partial Gram (N (N + 1) / 2 sums)
// to scratch, and a second kernel adds the partials of each lane in a fixed
// order (no atomics: the same bits on every run, so NNM's neighbour choice
// cannot change between runs). The chunking depends on N and Q alone, so a
// lane of a batched call gives the bits of the single call. G[j][i] is
// written from the same register as G[i][j], and the row norm is the
// Gram's diagonal, so the distance of a row to itself is exactly 0. All
// products are fp32 FMA: no TF32 and no tensor cores, whose rounding flips
// NNM's neighbour choice.
//   * N <= 12 (the wide round's N = 8), register-tiled: no shared-memory
//     staging of X. A thread owns groups of 4 consecutive columns and loads
//     one float4 per row (coalesced across the warp), two groups in flight
//     at N <= 8 (256 bytes a thread), and accumulates the N (N + 1) / 2
//     upper-triangle products in registers, column by column. The block's
//     sums go through a warp-shuffle tree, then across warps in warp order
//     through shared memory. At N = 8 that is 36 FMA per column against
//     32 bytes of HBM: the kernel stays bound by bytes.
//   * larger N (the trainer's N = 100): the block stages tiles of X in
//     shared memory (rows padded by one word so the rows of one tile fall in
//     different banks) and each thread owns up to 64 (i, j) pair sums.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;         // columns a register-path thread owns in one group
constexpr int kRegMaxN = 12;    // register path up to this N
constexpr int kMaxPairs = 64;   // shared-memory path: N * N <= kThreads * kMaxPairs

__host__ __device__ constexpr int tri(int n) { return n * (n + 1) / 2; }
__host__ __device__ constexpr int reg_groups(int n) { return n <= 8 ? 2 : 1; }
__host__ __device__ constexpr int reg_step(int n) { return kThreads * kVec * reg_groups(n); }

// N rows x 4 columns starting at `col`; columns at or past `end` read 0.
template <int N>
__device__ __forceinline__ void load_group(const float* __restrict__ m, int64_t q, int64_t col,
                                           int64_t end, bool vec, float (&x)[N][kVec]) {
  if (vec && col + kVec <= end) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(m + static_cast<int64_t>(i) * q + col));
      x[i][0] = v.x;
      x[i][1] = v.y;
      x[i][2] = v.z;
      x[i][3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        x[i][e] = col + e < end ? m[static_cast<int64_t>(i) * q + col + e] : 0.f;
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
gram_reg_kernel(const float* __restrict__ msgs, float* __restrict__ partial, int64_t q,
                int64_t chunk_len, int chunks, bool vec) {
  constexpr int kTri = tri(N);
  constexpr int kGroups = reg_groups(N);
  __shared__ float warp_sums[kWarps][kTri];
  const int64_t lane = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * chunk_len;
  const int64_t q1 = q0 + chunk_len < q ? q0 + chunk_len : q;
  const float* m = msgs + lane * N * q;

  float acc[kTri];
#pragma unroll
  for (int p = 0; p < kTri; ++p) acc[p] = 0.f;

  for (int64_t base = q0; base < q1; base += reg_step(N)) {
    float x[kGroups][N][kVec];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      load_group<N>(m, q, base + static_cast<int64_t>(g * kThreads + threadIdx.x) * kVec, q1, vec, x[g]);
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        int p = 0;
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
          for (int j = i; j < N; ++j) {
            acc[p] = fmaf(x[g][i][e], x[g][j][e], acc[p]);
            ++p;
          }
        }
      }
    }
  }

  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int p = 0; p < kTri; ++p) {
    float v = acc[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    if (threadIdx.x % 32 == 0) warp_sums[warp][p] = v;
  }
  __syncthreads();
  if (threadIdx.x < kTri) {
    float s = warp_sums[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, warp_sums[w][threadIdx.x]);
    partial[(lane * chunks + blockIdx.x) * kTri + threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
gram_smem_kernel(const float* __restrict__ msgs, float* __restrict__ partial,
                 int n, int64_t q, int64_t chunk_len, int chunks, int tile) {
  extern __shared__ float smem[];  // tile [n][tile + 1]
  const int stride = tile + 1;
  const int64_t lane = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * chunk_len;
  const int64_t q1 = q0 + chunk_len < q ? q0 + chunk_len : q;
  const int pairs = n * n;
  const float* m = msgs + lane * static_cast<int64_t>(n) * q;

  float acc[kMaxPairs];
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) acc[k] = 0.f;

  for (int64_t base = q0; base < q1; base += tile) {
    const int len = static_cast<int>(q1 - base < tile ? q1 - base : tile);
    for (int e = threadIdx.x; e < n * tile; e += kThreads) {
      const int i = e / tile;
      const int c = e % tile;
      smem[i * stride + c] = c < len ? m[static_cast<int64_t>(i) * q + base + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k) {
      const int p = threadIdx.x + k * kThreads;
      if (p < pairs) {
        const float* a = smem + (p / n) * stride;
        const float* b = smem + (p % n) * stride;
        float s = acc[k];
        for (int c = 0; c < len; ++c) s = fmaf(a[c], b[c], s);
        acc[k] = s;
      }
    }
    __syncthreads();
  }

  float* out = partial + (lane * chunks + blockIdx.x) * static_cast<int64_t>(tri(n));
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int p = threadIdx.x + k * kThreads;
    const int i = p / n;
    const int j = p % n;
    if (p < pairs && i <= j) out[i * n - i * (i - 1) / 2 + (j - i)] = acc[k];
  }
}

// One warp per upper-triangle entry: lane w adds the partials of chunks
// w, w + 32, ... in order, then a shuffle tree; G[i][j], G[j][i] and, on
// the diagonal, sq[i] are written from the one sum.
__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ gram, float* __restrict__ sq,
                                   int lanes, int n, int chunks) {
  const int t_count = tri(n);
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int w = threadIdx.x % 32;
  if (warp >= static_cast<int64_t>(lanes) * t_count) return;
  const int64_t lane = warp / t_count;
  const int t = static_cast<int>(warp % t_count);
  const float* p = partial + lane * chunks * static_cast<int64_t>(t_count) + t;
  float s = 0.f;
#pragma unroll 8
  for (int c = w; c < chunks; c += 32) s = __fadd_rn(s, p[static_cast<int64_t>(c) * t_count]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  if (w != 0) return;
  int i = 0;
  int first = 0;  // tri index of (i, i)
  while (t >= first + (n - i)) {
    first += n - i;
    ++i;
  }
  const int j = i + (t - first);
  float* g = gram + lane * n * n;
  g[i * n + j] = s;
  g[j * n + i] = s;
  if (i == j) sq[lane * n + i] = s;
}

template <int N>
cudaError_t launch_reg(const float* msgs, float* partial, int lanes, int64_t q, int64_t chunk_len,
                       int chunks, bool vec, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(lanes));
  gram_reg_kernel<N><<<grid, kThreads, 0, s>>>(msgs, partial, q, chunk_len, chunks, vec);
  return cudaGetLastError();
}

}  // namespace

// tile: the register path's step (reg_step(n) columns) for n <= 12, else
// the shared-memory tile width.
extern "C" int repro_gram(const void* msgs, void* partial, void* gram, void* sq,
                          int lanes, int n, int64_t q, int64_t chunk_len, int chunks,
                          int tile, void* stream) {
  if (lanes <= 0 || n <= 0 || q <= 0 || tile <= 0 || chunk_len <= 0 || chunk_len % tile != 0 ||
      chunks <= 0 || n * n > kThreads * kMaxPairs || (chunks - 1) * chunk_len >= q ||
      (n <= kRegMaxN && tile != reg_step(n))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(msgs);
  float* part = static_cast<float*>(partial);
  const bool vec = q % kVec == 0 && reinterpret_cast<uintptr_t>(msgs) % 16 == 0;
  cudaError_t err = cudaSuccess;
  switch (n) {
#define REPRO_GRAM_REG(N) \
  case N:                 \
    err = launch_reg<N>(x, part, lanes, q, chunk_len, chunks, vec, s); \
    break;
    REPRO_GRAM_REG(1) REPRO_GRAM_REG(2) REPRO_GRAM_REG(3) REPRO_GRAM_REG(4)
    REPRO_GRAM_REG(5) REPRO_GRAM_REG(6) REPRO_GRAM_REG(7) REPRO_GRAM_REG(8)
    REPRO_GRAM_REG(9) REPRO_GRAM_REG(10) REPRO_GRAM_REG(11) REPRO_GRAM_REG(12)
#undef REPRO_GRAM_REG
    default: {
      const size_t smem = static_cast<size_t>(n) * (tile + 1) * sizeof(float);
      if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
      const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(lanes));
      gram_smem_kernel<<<grid, kThreads, smem, s>>>(x, part, n, q, chunk_len, chunks, tile);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t threads = static_cast<int64_t>(lanes) * tri(n) * 32;
  const int block = 256;
  gram_reduce_kernel<<<static_cast<unsigned>((threads + block - 1) / block), block, 0, s>>>(
      part, static_cast<float*>(gram), static_cast<float*>(sq), lanes, n, chunks);
  return static_cast<int>(cudaGetLastError());
}
