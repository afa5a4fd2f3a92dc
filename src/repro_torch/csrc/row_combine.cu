// Weighted row-combine: out[l, q] = sum_r w[l, r] * x[l, r, q].
// (L, R, Q) rows and (L, R) weights -> (L, Q).
//
// Replaces two TPU kernels of src/repro/kernels/coded_combine.py that compute
// this one contraction:
//   * masked_combine_pallas_lanes (_masked_combine_kernel): the K-of-N
//     erasure decode's sum over the surviving offset class, R = N devices;
//   * coded_combine_pallas_lanes (_combine_kernel): the eq.-(5) combine of a
//     device's stacked subset gradients, R = d.
//
// Bound on Hopper: bytes. Each output coordinate reads R inputs once and
// writes one value; the R products and R - 1 adds are far below the rate.
//
// Order: numerics.tree_sum's tree over the R products w[r] * x[r][q], each
// rounded on its own, padded with +0.0 to the next power of two P, at each
// level the upper half added onto the lower half, every add rounded on its
// own (no FMA contraction). That is the plain PyTorch version's arithmetic
// term for term, so the two agree bit for bit; a row of weight 0.0 gives
// 0 * x (0 * inf is NaN, as there), and an add with a padding zero turns a
// -0.0 into +0.0, as there.
//
// Design: the products stay in registers. The R rows are dealt to G groups
// of threads (G a power of two <= P, from kernels/coded_combine.py's
// row_plan): group g holds rows g, g + G, g + 2G, ... (P / G of them, +0.0
// past R), so the tree's first log2(P / G) levels, whose pairs (r, r + h)
// have h >= G, fall inside a group and run in registers. The last log2 G
// levels cross the groups in the tree's order (group g adds group g + h's
// sum, h = G / 2, ..., 1) through shared memory, one barrier a level. The
// bits do not depend on G. A warp's threads take consecutive columns, so
// every row load is coalesced: 16 bytes a thread where Q is a multiple of
// 4, the rows are 16-byte aligned and the lanes' columns fill the card,
// else 4 (a few lanes' columns spread over four times the threads). A
// thread's loads are all issued before the first product, P / G (at most
// 16) rows in flight. Below 16 rows (the wide round's R = 8,
// coded_combine's R = 2) G = 1: a thread adds its column's whole tree, with
// plain cached loads; where the rows are dealt to groups (the paper's sums
// over N = 100) the loads are marked evict-first (each value is read once),
// which timed faster there on the card and slower on the wide streams. The
// grid is flat over (lane, column) for any lane count. All offsets are
// 64-bit: R * Q exceeds 2^31 at LM width.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kMaxRows = 256;
constexpr int kMaxLocal = 16;   // rows a thread holds
constexpr int kMaxGroups = 16;  // blocks of at most 16 x 32 threads
constexpr int kBlockColumns = 128;

// Column threads of a block: 128 threads at G = 1, 2; a warp a group past that.
__host__ __device__ constexpr int block_columns(int groups) {
  return kBlockColumns / groups > 32 ? kBlockColumns / groups : 32;
}

// kStream: an evict-first (streaming) load, else a plain cached one
template <int V, bool kStream>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4 t = kStream ? __ldcs(p4) : __ldg(p4);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = kStream ? __ldcs(p) : __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// The tree's levels h = H, H / 2, ..., 1 over a thread's rows: v[k] += v[k + h].
template <int H, int LOCAL, int V>
__device__ __forceinline__ void fold(float (&v)[LOCAL][V]) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int k = 0; k < H; ++k) {
#pragma unroll
      for (int e = 0; e < V; ++e) v[k][e] = __fadd_rn(v[k][e], v[k + H][e]);
    }
    fold<H / 2, LOCAL, V>(v);
  }
}

// LOCAL = P / G rows a thread, V consecutive columns a thread; kStream
// where G > 1.
template <int LOCAL, int V, bool kStream>
__global__ void __launch_bounds__(kMaxGroups * 32)
row_combine_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out, int r,
                   int64_t q, int64_t items, int groups) {
  extern __shared__ float sums[];  // [G][block columns * V]
  const int cols = block_columns(groups);
  const int g = threadIdx.x / cols;
  const int c = threadIdx.x % cols;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * cols + c;  // V columns of one lane
  const bool active = item < items;
  const int64_t per_lane = q / V;
  int64_t lane = 0;
  if (active) lane = items <= INT_MAX ? static_cast<int>(item) / static_cast<int>(per_lane) : item / per_lane;
  const int64_t col = active ? (item - lane * per_lane) * V : 0;
  const float* xl = x + lane * r * q + col;

  float v[LOCAL][V];
#pragma unroll
  for (int k = 0; k < LOCAL; ++k) {
    const int row = g + k * groups;
    if (active && row < r) {
      load<V, kStream>(xl + row * q, v[k]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[k][e] = 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < LOCAL; ++k) {
    const int row = g + k * groups;
    if (active && row < r) {
      const float wk = __ldg(w + lane * r + row);
#pragma unroll
      for (int e = 0; e < V; ++e) v[k][e] = __fmul_rn(wk, v[k][e]);
    }
  }
  // the tree's levels h = P / 2, ..., G: row g + k G meets row g + (k + h / G) G
  fold<LOCAL / 2, LOCAL, V>(v);
  // levels h = G / 2, ..., 1: group g < h adds group g + h's sum
  if (groups > 1) {
    float* mine = sums + (g * cols + c) * V;
    store<V>(mine, v[0]);
    __syncthreads();
    for (int h = groups / 2; h >= 1; h >>= 1) {
      if (g < h) {
        const float* other = sums + ((g + h) * cols + c) * V;
#pragma unroll
        for (int e = 0; e < V; ++e) v[0][e] = __fadd_rn(v[0][e], other[e]);
        store<V>(mine, v[0]);
      }
      __syncthreads();
    }
  }
  if (active && g == 0) store<V>(out + lane * q + col, v[0]);
}

template <int LOCAL, int V>
cudaError_t launch(const float* x, const float* w, float* out, int r, int64_t q, int64_t items, int groups,
                   cudaStream_t s) {
  const int cols = block_columns(groups);
  const int64_t blocks = (items + cols - 1) / cols;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (groups > 1) {
    row_combine_kernel<LOCAL, V, true><<<grid, groups * cols, sizeof(float) * groups * cols * V, s>>>(
        x, w, out, r, q, items, groups);
  } else {
    row_combine_kernel<LOCAL, V, false><<<grid, cols, 0, s>>>(x, w, out, r, q, items, groups);
  }
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_local(const float* x, const float* w, float* out, int r, int64_t q, int64_t items, int groups,
                         int local, cudaStream_t s) {
  switch (local) {
    case 1: return launch<1, V>(x, w, out, r, q, items, groups, s);
    case 2: return launch<2, V>(x, w, out, r, q, items, groups, s);
    case 4: return launch<4, V>(x, w, out, r, q, items, groups, s);
    case 8: return launch<8, V>(x, w, out, r, q, items, groups, s);
    case 16: return launch<16, V>(x, w, out, r, q, items, groups, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// groups: G, a power of two with P / 16 <= G <= min(P, 16) (P the next
// power of two >= r); vec: 16-byte loads (q a multiple of 4, x and out
// 16-byte aligned), else 4-byte.
extern "C" int repro_row_combine(const void* x, const void* w, void* out, int lanes, int r, int64_t q, int groups,
                                 int vec, void* stream) {
  if (lanes <= 0 || r <= 0 || r > kMaxRows || q <= 0 || groups <= 0 || groups > kMaxGroups ||
      (groups & (groups - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int p = 1;
  while (p < r) p <<= 1;
  const int local = p / groups;
  if (groups > p || local > kMaxLocal ||
      (vec && (q % 4 != 0 || !repro_tile::aligned16(x) || !repro_tile::aligned16(out)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xs = static_cast<const float*>(x);
  const float* ws = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t items = static_cast<int64_t>(lanes) * (vec ? q / 4 : q);
  const cudaError_t err = vec ? launch_local<4>(xs, ws, o, r, q, items, groups, local, s)
                              : launch_local<1>(xs, ws, o, r, q, items, groups, local, s);
  return static_cast<int>(err);
}
