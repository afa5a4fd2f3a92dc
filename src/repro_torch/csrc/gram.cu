// Gram matrix and row norms for NNM distances: for each lane,
// gram = X X^T (N, N) and sq = row-wise sum of squares (N,), in fp32.
//
// Replaces: src/repro/kernels/nnm_dist.py::gram_pallas_lanes (_gram_kernel),
// the TPU kernel that accumulates X X^T and the row norms over a sequential
// grid of q tiles into one output block.
//
// Bound on Hopper: bytes at the wide round's N = 8 (one read of the
// (L, N, Q) stack; the outputs are tiny) and at the paper's N = 100,
// Q = 100, where the (N, N) output weighs as much as the input and the
// N (N + 1) Q operations of the N (N + 1) / 2 pair sums that symmetry
// leaves come close (1.5e-5 against 2.4e-5 ms a lane); operations past
// N = 80 once Q is much larger than N.
//
// Hopper blocks run in no order, so nothing carries over between them. No
// atomics: the same bits on every run, so NNM's neighbour choice cannot
// change between runs. G[j][i] is written from the same register as
// G[i][j], and the row norm is the Gram's diagonal, so the distance of a
// row to itself is exactly 0. All products are fp32 FMA: no TF32 and no
// tensor cores, whose rounding flips NNM's neighbour choice.
//   * N <= 12 (the wide round's N = 8), register-tiled: no shared-memory
//     staging of X. A thread owns groups of 4 consecutive columns and loads
//     one float4 per row (coalesced across the warp), two groups in flight
//     at N <= 8 (256 bytes a thread), and accumulates the N (N + 1) / 2
//     upper-triangle products in registers, column by column. The block's
//     sums go through a warp-shuffle tree, then across warps in warp order
//     through shared memory. At N = 8 that is 36 FMA per column against
//     32 bytes of HBM: the kernel stays bound by bytes. Each block sums
//     one chunk of Q into scratch; a second kernel adds the chunks of each
//     lane in a fixed order, a warp an entry.
//   * 13 <= N <= 128 (the paper's N = 100): register-blocked tiles of the
//     upper triangle. Row tile a holds rows a, a + K, a + 2K, a + 3K
//     (K = ceil(N / 4) tiles, rows past N read 0), so the tile pairs a <= b
//     cover every pair i <= j once, and a thread owns one tile pair: 16 sums
//     in registers. A block stages its lane's (N, W) panel of columns in
//     shared memory once (cp.async, 16 bytes a copy where the rows are
//     aligned; the row stride an odd number of float4s, so 8 consecutive
//     rows fall in 8 different bank groups) and each thread reads, four
//     columns at a time, one float4 of each of its 8 rows and issues 64
//     independent FMAs: 8 FMA a shared load, where one chain a pair took
//     two loads a term. That ratio is the SM's: its shared memory delivers
//     128 bytes a cycle, 8 float4s for its 128 FMA a cycle, so shared-memory
//     bandwidth and latency bound the tiles; larger tiles hold more sums
//     than leave several blocks an SM. Where a lane's Q is one chunk the
//     kernel writes gram and sq itself, one launch; else each block writes
//     its chunk's triangle to scratch and a second kernel adds the chunks,
//     one thread an entry.
//
// Order over Q (13 <= N): Q is cut into chunks (kernels/nnm_dist.py's
// gram_chunking, a function of N and Q alone) and each chunk into segments
// of 32 columns. A segment's sum is one FMA chain from 0 over its columns
// in order (past Q's last multiple of 4, zeros); a chunk's sum adds its
// non-empty segments' sums left to right; the second pass adds the chunks'
// sums left to right. The plan (nnm_dist.gram_plan) may give a segment its own
// thread, the partial sums then added through shared memory in the same
// order, so the bits do not depend on the lane count or on how the triangle
// is cut into blocks: a lane of a batched call is the single call, bit for
// bit. It is not gram_ref's tree: the two agree to fp32 rounding.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;         // columns a register-path thread owns in one group
constexpr int kRegMaxN = 12;    // register path up to this N
constexpr int kMaxN = 128;      // the tile path up to this N
constexpr int kTile = 4;        // rows of a row tile: a thread owns 4 x 4 pair sums
constexpr int kSeg = 32;        // columns of a segment: one FMA chain
constexpr int kTileThreads = 512;
constexpr int64_t kSmemMax = 232448;
constexpr int64_t kDefaultSmem = 48 * 1024;

__host__ __device__ constexpr int tri(int n) { return n * (n + 1) / 2; }
__host__ __device__ constexpr int tile_count(int n) { return (n + kTile - 1) / kTile; }
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

// acc[r][s] += x[a + r tiles][col] * x[b + s tiles][col] for the columns
// [c0, c1) of the panel (a multiple of 4 apart): four columns a step, the
// rows of tile a and then each row of tile b one float4 from shared
// memory, each sum's FMAs in column order.
__device__ __forceinline__ void chain(const float* panel, int stride, int a, int b, int tiles, int c0, int c1,
                                      float (&acc)[kTile][kTile]) {
  for (int c = c0; c < c1; c += 4) {
    float4 xa[kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r) xa[r] = *reinterpret_cast<const float4*>(panel + (a + r * tiles) * stride + c);
#pragma unroll
    for (int s = 0; s < kTile; ++s) {
      const float4 xb = *reinterpret_cast<const float4*>(panel + (b + s * tiles) * stride + c);
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        acc[r][s] = fmaf(xa[r].x, xb.x, acc[r][s]);
        acc[r][s] = fmaf(xa[r].y, xb.y, acc[r][s]);
        acc[r][s] = fmaf(xa[r].z, xb.z, acc[r][s]);
        acc[r][s] = fmaf(xa[r].w, xb.w, acc[r][s]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kTile][kTile]) {
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
#pragma unroll
    for (int s = 0; s < kTile; ++s) acc[r][s] = 0.f;
  }
}

// One block per (lane, chunk, group of tile pairs), blockIdx.x flat in that
// order; a thread owns tile pair p in a segment slot. kSplit: slot s sums
// segment s of the chunk (one staged panel), else slot 0 sums every segment
// in turn.
template <bool kSplit>
__global__ void __launch_bounds__(kTileThreads)
gram_tile_kernel(const float* __restrict__ msgs, float* __restrict__ partial, float* __restrict__ gram,
                 float* __restrict__ sq, int n, int64_t q, int64_t chunk_len, int chunks, int width, int stride,
                 int pairs, int split, bool vec) {
  extern __shared__ float4 smem4[];
  float* panel = reinterpret_cast<float*>(smem4);
  const int tiles = tile_count(n);
  const int rows = kTile * tiles;
  const int all_pairs = tri(tiles);
  const int pair_blocks = (all_pairs + pairs - 1) / pairs;
  int64_t blk = blockIdx.x;
  const int pb = static_cast<int>(blk % pair_blocks);
  blk /= pair_blocks;
  const int chunk = static_cast<int>(blk % chunks);
  const int64_t lane = blk / chunks;
  const int slot = threadIdx.x / pairs;
  const int p = pb * pairs + static_cast<int>(threadIdx.x) % pairs;
  const bool active = slot < split && p < all_pairs;
  int ta = 0, tb = 0;  // the tile pair of p, row-major over a <= b
  if (active) {
    int rest = p;
    while (rest >= tiles - ta) {
      rest -= tiles - ta;
      ++ta;
    }
    tb = ta + rest;
  }
  const float* m = msgs + lane * n * q;
  const int64_t c_begin = static_cast<int64_t>(chunk) * chunk_len;
  const int64_t c_end = c_begin + chunk_len < q ? c_begin + chunk_len : q;

  float total[kTile][kTile];
  zero(total);
  bool first = true;
  for (int64_t base = c_begin; base < c_end; base += width) {
    const int valid = static_cast<int>(c_end - base < width ? c_end - base : width);
    const int valid4 = (valid + 3) & ~3;
    repro_tile::stage_tile(panel, stride, m, n, q, base, valid, vec);
    // zeros past Q's last column (to a multiple of 4) and in the rows past N
    if (valid4 > valid) {
      for (int e = threadIdx.x; e < n * (valid4 - valid); e += blockDim.x) {
        panel[e / (valid4 - valid) * stride + valid + e % (valid4 - valid)] = 0.f;
      }
    }
    for (int e = threadIdx.x; e < (rows - n) * valid4; e += blockDim.x) {
      panel[(n + e / valid4) * stride + e % valid4] = 0.f;
    }
    repro_tile::cp_async_wait_all();
    __syncthreads();
    if (active) {
      if constexpr (kSplit) {
        if (slot * kSeg < valid) {
          chain(panel, stride, ta, tb, tiles, slot * kSeg, min(slot * kSeg + kSeg, valid4), total);
        }
      } else {
        for (int c0 = 0; c0 < valid; c0 += kSeg) {
          float part[kTile][kTile];
          zero(part);
          chain(panel, stride, ta, tb, tiles, c0, min(c0 + kSeg, valid4), part);
#pragma unroll
          for (int r = 0; r < kTile; ++r) {
#pragma unroll
            for (int s = 0; s < kTile; ++s) total[r][s] = first ? part[r][s] : __fadd_rn(total[r][s], part[r][s]);
          }
          first = false;
        }
      }
    }
    __syncthreads();  // the panel is read: the next one (or the slots' sums) may overwrite it
  }
  if constexpr (kSplit) {
    // slot s > 0 hands its segment's sums to slot 0, which adds the chunk's
    // non-empty segments left to right: the serial order's bits
    const int valid = static_cast<int>(c_end - c_begin);
    float* slots = panel;  // [slot - 1][16][pairs]
    const int pl = static_cast<int>(threadIdx.x) % pairs;
    if (active && slot > 0 && slot * kSeg < valid) {
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
#pragma unroll
        for (int s = 0; s < kTile; ++s) slots[((slot - 1) * kTile * kTile + r * kTile + s) * pairs + pl] = total[r][s];
      }
    }
    __syncthreads();
    if (!active || slot > 0) return;
    for (int k = 1; k < split && k * kSeg < valid; ++k) {
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
#pragma unroll
        for (int s = 0; s < kTile; ++s) {
          total[r][s] = __fadd_rn(total[r][s], slots[((k - 1) * kTile * kTile + r * kTile + s) * pairs + pl]);
        }
      }
    }
  }
  float* g = gram + lane * n * n;
  if (!active) return;
  const int t_count = tri(n);
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
#pragma unroll
    for (int s = 0; s < kTile; ++s) {
      const int i = ta + r * tiles;
      const int j = tb + s * tiles;
      if (i >= n || j >= n || (ta == tb && r > s)) continue;
      const float v = total[r][s];
      if (chunks == 1) {
        g[i * n + j] = v;
        g[j * n + i] = v;
        if (i == j) sq[lane * n + i] = v;
      } else {
        const int lo = i < j ? i : j;
        const int hi = i < j ? j : i;
        partial[(lane * chunks + chunk) * t_count + lo * n - lo * (lo - 1) / 2 + (hi - lo)] = v;
      }
    }
  }
}

// The chunks' triangles of each lane added left to right, one thread an
// (i, j) entry of the (N, N) grid (the lower triangle idle): G[i][j],
// G[j][i] and, on the diagonal, sq[i] from the one sum.
__global__ void gram_sum_kernel(const float* __restrict__ partial, float* __restrict__ gram,
                                float* __restrict__ sq, int64_t lanes, int n, int chunks) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= lanes * n * n) return;
  const int64_t lane = e / (n * n);
  const int i = static_cast<int>(e / n % n);
  const int j = static_cast<int>(e % n);
  if (j < i) return;
  const int t_count = tri(n);
  const float* p = partial + lane * chunks * static_cast<int64_t>(t_count) + (i * n - i * (i - 1) / 2 + (j - i));
  float s = p[0];
  for (int c = 1; c < chunks; ++c) s = __fadd_rn(s, p[static_cast<int64_t>(c) * t_count]);
  float* g = gram + lane * n * n;
  g[i * n + j] = s;
  g[j * n + i] = s;
  if (i == j) sq[lane * n + i] = s;
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

// The register path (n <= 12): width = reg_step(n) columns a step,
// stride = pairs = split = 1, a partial triangle per (lane, chunk) and the
// warp-per-entry pass. The tile path (13 <= n <= 128, nnm_dist.gram_plan):
// chunks of chunk_len columns (a multiple of 32), panels of width columns
// (a multiple of 32 dividing chunk_len) at row stride `stride` floats,
// `pairs` tile pairs a block, `split` segment slots (1, or chunk_len / 32
// with width == chunk_len); `partial` (lanes x chunks triangles) is read
// only where chunks > 1.
extern "C" int repro_gram(const void* msgs, void* partial, void* gram, void* sq, int lanes, int n, int64_t q,
                          int64_t chunk_len, int chunks, int width, int stride, int pairs, int split,
                          void* stream) {
  if (lanes <= 0 || n <= 0 || n > kMaxN || q <= 0 || chunk_len <= 0 || chunks <= 0 ||
      (chunks - 1) * chunk_len >= q || static_cast<int64_t>(chunks) * chunk_len < q) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(msgs);
  float* part = static_cast<float*>(partial);
  float* g = static_cast<float*>(gram);
  float* norms = static_cast<float*>(sq);
  if (n <= kRegMaxN) {
    if (lanes > 65535 || width != reg_step(n) || chunk_len % width != 0 || pairs != 1 || split != 1 ||
        stride != 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
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
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t threads = static_cast<int64_t>(lanes) * tri(n) * 32;
    const int block = 256;
    gram_reduce_kernel<<<static_cast<unsigned>((threads + block - 1) / block), block, 0, s>>>(
        part, g, norms, lanes, n, chunks);
    return static_cast<int>(cudaGetLastError());
  }
  const int all_pairs = tri(tile_count(n));
  const int64_t cols = q < width ? (q + 3) / 4 * 4 : width;
  if (chunk_len % kSeg != 0 || width <= 0 || width % kSeg != 0 || chunk_len % width != 0 ||
      stride < cols || stride % 4 != 0 || pairs <= 0 || split <= 0 ||
      static_cast<int64_t>(pairs) * split > kTileThreads ||
      (split != 1 && (split != chunk_len / kSeg || width != chunk_len))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t panel = static_cast<int64_t>(kTile) * tile_count(n) * stride;
  const int64_t slots = static_cast<int64_t>(split - 1) * kTile * kTile * pairs;  // the segment slots' sums
  const int64_t smem = 4 * (panel > slots ? panel : slots);
  const int64_t blocks = static_cast<int64_t>(lanes) * chunks * ((all_pairs + pairs - 1) / pairs);
  if (smem > kSmemMax || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (pairs * split + 31) / 32 * 32;
  const bool vec = q % 4 == 0 && repro_tile::aligned16(msgs);
  cudaError_t set = cudaSuccess;
#define REPRO_GRAM_TILE(SPLIT)                                                                                  \
  if (smem > kDefaultSmem) {                                                                                    \
    set = cudaFuncSetAttribute(gram_tile_kernel<SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,             \
                               static_cast<int>(smem));                                                         \
  }                                                                                                             \
  if (set != cudaSuccess) return static_cast<int>(set);                                                         \
  gram_tile_kernel<SPLIT><<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem), s>>>(             \
      x, part, g, norms, n, q, chunk_len, chunks, width, stride, pairs, split, vec);
  if (split > 1) {
    REPRO_GRAM_TILE(true)
  } else {
    REPRO_GRAM_TILE(false)
  }
#undef REPRO_GRAM_TILE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const int64_t entries = static_cast<int64_t>(lanes) * n * n;
  const int block = 256;
  if ((entries + block - 1) / block > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  gram_sum_kernel<<<static_cast<unsigned>((entries + block - 1) / block), block, 0, s>>>(part, g, norms, lanes, n,
                                                                                         chunks);
  return static_cast<int>(cudaGetLastError());
}
