// QSGD stochastic quantization per block of `chunk` coordinates:
// scale = max |g| over the block, y = g / scale * levels, y rounds up where
// u < y - floor(y), out = yq / levels * scale (0 where scale is 0).
// (rows, Q) g and u -> (rows, Q) dequantized output.
//
// Replaces: src/repro/kernels/quantize.py::stochastic_quantize_pallas_lanes
// (_quant_kernel), the TPU kernel that quantizes one (1, q_block) VMEM tile
// per grid step, the quantization block being the tile.
//
// Bound on Hopper: bytes. Each coordinate reads g and u once and writes its
// output once (12 bytes); the arithmetic is a handful of operations.
//
// Design: the (row, block) pairs are one flat 64-bit range, so any row
// count is one launch. Two layouts, chosen by the wrapper
// (kernels/quantize.py::quant_plan: a warp a block where blocks of up to
// kWarpMaxChunk coordinates are many, the thread block otherwise;
// scripts/torch_quant_layouts.py times both on either side of the rule):
//   * warp: a block of at most kWarpMaxChunk coordinates is one warp's.
//     Each thread loads its coordinates of g and u into registers at once
//     (16-byte loads where the row and the chunk are multiples of 4 and the
//     pointers 16-byte aligned, else 4-byte ones), the max-abs comes from
//     shuffles alone (no shared memory, no barrier), and the thread
//     quantizes from its registers. kWarpsPerCta blocks share a CTA.
//   * block: a CTA of up to 256 threads a block for longer chunks, each
//     thread's first kItems coordinates in registers and a warp-shuffle and
//     shared-memory max (a block longer than kItems * blockDim reads its
//     remaining coordinates twice, the second time from L1/L2).
// g, u and out are each touched once: streaming loads and stores
// (evict-first). A row's last block is ragged when chunk does not divide
// Q: it is masked to the row's own coordinates, never padded, so no
// coordinate of the next row enters its scale. The divisions and products
// are IEEE round-to-nearest (__fdiv_rn, __fmul_rn, no FMA contraction), the
// plain PyTorch version's arithmetic, so the two agree bitwise. A NaN in the
// block makes the scale NaN, as torch.amax does (max is exact, so its order
// does not matter), and the block's output 0. All offsets are 64-bit:
// rows * Q exceeds 2^31 at LM width.
#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;    // block layout
constexpr int kItems = 4;           // coordinates a block-layout thread keeps in registers
constexpr int kWarpMaxChunk = 512;  // warp layout: the longest block (4 16-byte loads a thread)
constexpr int kWarpsPerCta = 4;

// max of |values| that propagates NaN, as torch.amax does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

__device__ __forceinline__ float quantize_one(float g, float u, float safe, float levels,
                                              bool positive) {
  const float y = __fmul_rn(__fdiv_rn(g, safe), levels);
  const float lo = floorf(y);
  const float yq = __fadd_rn(lo, u < __fsub_rn(y, lo) ? 1.f : 0.f);
  return positive ? __fmul_rn(__fdiv_rn(yq, levels), safe) : 0.f;
}

__device__ __forceinline__ float4 quantize_four(float4 g, float4 u, float safe, float levels,
                                                bool positive) {
  return make_float4(quantize_one(g.x, u.x, safe, levels, positive), quantize_one(g.y, u.y, safe, levels, positive),
                     quantize_one(g.z, u.z, safe, levels, positive), quantize_one(g.w, u.w, safe, levels, positive));
}

// The first coordinate and the length of flat block `b`: row b / per_row,
// its (b % per_row)-th block of chunk coordinates, ragged at the row's end
// (32-bit division where the counts allow it).
__device__ __forceinline__ int64_t block_span(int64_t b, int64_t per_row, int64_t q, int64_t chunk,
                                             int64_t& len) {
  const int64_t row = (b >> 32) == 0 && (per_row >> 32) == 0
                          ? static_cast<int64_t>(static_cast<uint32_t>(b) / static_cast<uint32_t>(per_row))
                          : b / per_row;
  const int64_t begin = (b - row * per_row) * chunk;
  len = (q - begin < chunk) ? q - begin : chunk;
  return row * q + begin;
}

// One warp a block of at most kWarpMaxChunk coordinates, VEC 16-byte loads
// a thread (kVec) or 4 * VEC 4-byte ones; each thread's loads are at fixed
// offsets from its first coordinate.
template <int VEC, bool kVec>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
quantize_warp_kernel(const float* __restrict__ g, const float* __restrict__ u, float* __restrict__ out,
                     int64_t blocks, int64_t per_row, int64_t q, int64_t chunk, float levels) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerCta;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5); b < blocks;
       b += stride) {
    int64_t len64;
    const int64_t off = block_span(b, per_row, q, chunk, len64);
    const int len = static_cast<int>(len64);
    if constexpr (kVec) {
      const float4* g4 = reinterpret_cast<const float4*>(g + off) + lane;
      const float4* u4 = reinterpret_cast<const float4*>(u + off) + lane;
      const int rem = (len >> 2) - lane;  // this thread's 16-byte words: those k with 32 k < rem
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 gv[VEC], uv[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        gv[k] = 32 * k < rem ? __ldcs(g4 + 32 * k) : zero;
        uv[k] = 32 * k < rem ? __ldcs(u4 + 32 * k) : zero;
      }
      float m = 0.f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        m = nan_max(m, fabsf(gv[k].x));
        m = nan_max(m, fabsf(gv[k].y));
        m = nan_max(m, fabsf(gv[k].z));
        m = nan_max(m, fabsf(gv[k].w));
      }
      const float scale = warp_max(m);
      const bool positive = scale > 0.f;  // false for a NaN scale, as in torch.where
      const float safe = positive ? scale : 1.f;
      float4* o4 = reinterpret_cast<float4*>(out + off) + lane;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if (32 * k < rem) __stcs(o4 + 32 * k, quantize_four(gv[k], uv[k], safe, levels, positive));
      }
    } else {
      const float* gs = g + off + lane;
      const float* us = u + off + lane;
      const int rem = len - lane;
      float gv[4 * VEC], uv[4 * VEC];
      float m = 0.f;
#pragma unroll
      for (int k = 0; k < 4 * VEC; ++k) {
        gv[k] = 32 * k < rem ? __ldcs(gs + 32 * k) : 0.f;
        uv[k] = 32 * k < rem ? __ldcs(us + 32 * k) : 0.f;
        m = nan_max(m, fabsf(gv[k]));
      }
      const float scale = warp_max(m);
      const bool positive = scale > 0.f;
      const float safe = positive ? scale : 1.f;
      float* os = out + off + lane;
#pragma unroll
      for (int k = 0; k < 4 * VEC; ++k) {
        if (32 * k < rem) __stcs(os + 32 * k, quantize_one(gv[k], uv[k], safe, levels, positive));
      }
    }
  }
}

// One CTA a block: blockIdx.x is the flat block.
__global__ void quantize_block_kernel(const float* __restrict__ g, const float* __restrict__ u,
                                      float* __restrict__ out, int64_t per_row, int64_t q, int64_t chunk,
                                      float levels) {
  __shared__ float warp_maxes[kMaxThreads / 32];
  int64_t len;
  const int64_t off = block_span(blockIdx.x, per_row, q, chunk, len);
  const float* gb = g + off;
  const float* ub = u + off;
  float* ob = out + off;
  const int64_t stride = blockDim.x;
  const int64_t cached = kItems * stride;

  float gv[kItems], uv[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = threadIdx.x + k * stride;
    gv[k] = i < len ? __ldcs(gb + i) : 0.f;
    uv[k] = i < len ? __ldcs(ub + i) : 0.f;
  }
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < kItems; ++k) m = nan_max(m, fabsf(gv[k]));
  for (int64_t i = threadIdx.x + cached; i < len; i += stride) m = nan_max(m, fabsf(gb[i]));
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) warp_maxes[threadIdx.x >> 5] = m;
  __syncthreads();
  float scale = warp_maxes[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) scale = nan_max(scale, warp_maxes[w]);

  const bool positive = scale > 0.f;  // false for a NaN scale, as in torch.where
  const float safe = positive ? scale : 1.f;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = threadIdx.x + k * stride;
    if (i < len) __stcs(ob + i, quantize_one(gv[k], uv[k], safe, levels, positive));
  }
  for (int64_t i = threadIdx.x + cached; i < len; i += stride) {
    __stcs(ob + i, quantize_one(__ldcs(gb + i), __ldcs(ub + i), safe, levels, positive));
  }
}

template <int VEC, bool kVec>
void launch_warp(const float* g, const float* u, float* out, int64_t blocks, int64_t per_row, int64_t q,
                 int64_t chunk, float levels, cudaStream_t s) {
  const int64_t ctas = (blocks + kWarpsPerCta - 1) / kWarpsPerCta;
  quantize_warp_kernel<VEC, kVec><<<static_cast<unsigned>(ctas < INT_MAX ? ctas : INT_MAX), kWarpsPerCta * 32, 0,
                                    s>>>(g, u, out, blocks, per_row, q, chunk, levels);
}

// The warp layout with VEC 16-byte loads a thread: the fewest that hold a chunk.
template <bool kVec>
void launch_warp_vec(const float* g, const float* u, float* out, int64_t blocks, int64_t per_row, int64_t q,
                     int64_t chunk, float levels, cudaStream_t s) {
  if (chunk <= 128) {
    launch_warp<1, kVec>(g, u, out, blocks, per_row, q, chunk, levels, s);
  } else if (chunk <= 256) {
    launch_warp<2, kVec>(g, u, out, blocks, per_row, q, chunk, levels, s);
  } else {
    launch_warp<kWarpMaxChunk / 128, kVec>(g, u, out, blocks, per_row, q, chunk, levels, s);
  }
}

}  // namespace

// warp: 1 for the warp layout (chunk <= kWarpMaxChunk), 0 for the block layout.
extern "C" int repro_quantize(const void* g, const void* u, void* out, int64_t rows, int64_t q,
                              int64_t chunk, int levels, int warp, void* stream) {
  if (rows <= 0 || q <= 0 || chunk <= 0 || levels <= 0 || (warp && chunk > kWarpMaxChunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t per_row = (q + chunk - 1) / chunk;
  if (per_row > LLONG_MAX / rows) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = rows * per_row;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const float* up = static_cast<const float*>(u);
  float* op = static_cast<float*>(out);
  const float lv = static_cast<float>(levels);
  if (warp) {
    const bool vec = q % 4 == 0 && chunk % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(u) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (vec) {
      launch_warp_vec<true>(gp, up, op, blocks, per_row, q, chunk, lv, s);
    } else {
      launch_warp_vec<false>(gp, up, op, blocks, per_row, q, chunk, lv, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // a warp per 32 coordinates of the block, at most kMaxThreads threads
  const int64_t warps = (chunk + 31) / 32;
  const int threads = static_cast<int>(warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads);
  quantize_block_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(gp, up, op, per_row, q, chunk, lv);
  return static_cast<int>(cudaGetLastError());
}
