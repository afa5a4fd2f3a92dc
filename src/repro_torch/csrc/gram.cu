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
// them. The Q axis is cut into chunks, one block per (chunk, lane); a block
// walks its chunk in tiles staged in shared memory (rows padded by one word
// so the rows of one tile fall in different banks). Each thread owns (i, j)
// pair sums in registers, accumulated with fp32 FMA (no TF32, no tensor
// cores):
//   * N * N <= 256 (the wide round's N = 8): one pair per thread, and the
//     256 / (N * N) groups of threads take interleaved columns of the tile,
//     so every thread works; at the chunk's end the groups' sums are added
//     in group order through shared memory. Few registers, so many blocks
//     share an SM.
//   * larger N (the trainer's N = 100): up to 64 pairs per thread.
// Every block writes its partial (N, N) Gram to a scratch buffer; a second
// kernel adds the partials of each lane in chunk order. No atomics: the
// result is the same on every run, so NNM's neighbour choice cannot change
// between runs. The chunking depends on N and Q alone, so a lane of a
// batched call gives the same bits as the single call. G[i][j] and G[j][i]
// run the same FMA sequence, and the row norm is the Gram's diagonal, so
// the distance of a row to itself is exactly 0.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPairs = 64;  // pairs per thread: N * N <= kThreads * kMaxPairs

template <int kPairsPerThread>
__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const float* __restrict__ msgs, float* __restrict__ partial,
                    int n, int64_t q, int64_t chunk_len, int chunks, int tile) {
  extern __shared__ float smem[];  // tile [n][tile + 1]; reused for the group sums
  const int stride = tile + 1;
  const int64_t lane = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * chunk_len;
  const int64_t q1 = q0 + chunk_len < q ? q0 + chunk_len : q;
  const int pairs = n * n;
  // one pair per thread: groups of `pairs` threads split the tile's columns
  const int groups = kPairsPerThread == 1 ? kThreads / pairs : 1;
  const int group = kPairsPerThread == 1 ? threadIdx.x / pairs : 0;
  const int p0 = kPairsPerThread == 1 ? threadIdx.x % pairs : threadIdx.x;
  const bool active = group < groups;
  const float* m = msgs + lane * static_cast<int64_t>(n) * q;

  float acc[kPairsPerThread];
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) acc[k] = 0.f;

  for (int64_t base = q0; base < q1; base += tile) {
    const int len = static_cast<int>(q1 - base < tile ? q1 - base : tile);
    for (int e = threadIdx.x; e < n * tile; e += kThreads) {
      const int i = e / tile;
      const int c = e % tile;
      smem[i * stride + c] = c < len ? m[static_cast<int64_t>(i) * q + base + c] : 0.f;
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int k = 0; k < kPairsPerThread; ++k) {
        const int p = p0 + k * kThreads;
        if (p < pairs) {
          const float* a = smem + (p / n) * stride;
          const float* b = smem + (p % n) * stride;
          float s = acc[k];
          for (int c = group; c < len; c += groups) s = fmaf(a[c], b[c], s);
          acc[k] = s;
        }
      }
    }
    __syncthreads();
  }

  float* out = partial + (lane * chunks + blockIdx.x) * static_cast<int64_t>(pairs + n);
  if (kPairsPerThread == 1) {
    if (active) smem[group * pairs + p0] = acc[0];
    __syncthreads();
    if (threadIdx.x < pairs) {
      float s = smem[threadIdx.x];
      for (int g = 1; g < groups; ++g) s = __fadd_rn(s, smem[g * pairs + threadIdx.x]);
      out[threadIdx.x] = s;
      if (threadIdx.x % (n + 1) == 0) out[pairs + threadIdx.x / (n + 1)] = s;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPairsPerThread; ++k) {
      const int p = p0 + k * kThreads;
      if (p < pairs) {
        out[p] = acc[k];
        if (p % (n + 1) == 0) out[pairs + p / (n + 1)] = acc[k];
      }
    }
  }
}

__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ gram, float* __restrict__ sq,
                                   int lanes, int n, int chunks) {
  const int64_t per_lane = static_cast<int64_t>(n) * n + n;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= lanes * per_lane) return;
  const int64_t lane = e / per_lane;
  const int64_t r = e % per_lane;
  const float* p = partial + lane * chunks * per_lane + r;
  float s = p[0];
  for (int c = 1; c < chunks; ++c) s = __fadd_rn(s, p[c * per_lane]);
  const int64_t nn = static_cast<int64_t>(n) * n;
  if (r < nn) {
    gram[lane * nn + r] = s;
  } else {
    sq[lane * n + (r - nn)] = s;
  }
}

}  // namespace

extern "C" int repro_gram(const void* msgs, void* partial, void* gram, void* sq,
                          int lanes, int n, int64_t q, int64_t chunk_len, int chunks,
                          int tile, void* stream) {
  if (lanes <= 0 || n <= 0 || q <= 0 || tile <= 0 || chunk_len <= 0 || chunk_len % tile != 0 ||
      chunks <= 0 || n * n > kThreads * kMaxPairs || (chunks - 1) * chunk_len >= q) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t tile_floats = static_cast<size_t>(n) * (tile + 1);
  const size_t smem = (tile_floats > kThreads ? tile_floats : kThreads) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(lanes));
  if (n * n <= kThreads) {
    gram_partial_kernel<1><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(msgs), static_cast<float*>(partial), n, q, chunk_len, chunks, tile);
  } else {
    gram_partial_kernel<kMaxPairs><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(msgs), static_cast<float*>(partial), n, q, chunk_len, chunks, tile);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(lanes) * (static_cast<int64_t>(n) * n + n);
  const int threads = 256;
  gram_reduce_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(gram), static_cast<float*>(sq),
      lanes, n, chunks);
  return static_cast<int>(cudaGetLastError());
}
