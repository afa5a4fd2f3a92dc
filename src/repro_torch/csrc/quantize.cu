// QSGD stochastic quantization per block of `chunk` coordinates:
// scale = max |g| over the block, y = g / scale * levels, y rounds up where
// u < y - floor(y), out = yq / levels * scale (0 where scale is 0).
// (L, Q) g and u -> (L, Q) dequantized output.
//
// Replaces: src/repro/kernels/quantize.py::stochastic_quantize_pallas_lanes
// (_quant_kernel), the TPU kernel that quantizes one (1, q_block) VMEM tile
// per grid step, the quantization block being the tile.
//
// Bound on Hopper: bytes. Each coordinate reads g and u once and writes its
// output once (12 bytes); the arithmetic is a handful of operations.
//
// Design: one thread block per (lane, quantization block), at most 256
// threads. Each thread loads its first kItems coordinates of g and of u into
// registers at once (up to 1024 coordinates a block: the default chunk is
// held whole, and eight loads a thread are in flight), takes the max-abs (a
// warp-shuffle and shared-memory reduction; max is exact, so its order does
// not matter), then quantizes from the registers. A block longer than
// kItems * blockDim reads its remaining coordinates twice, the second time
// from L1/L2. A row's last block is ragged when chunk does not
// divide Q: it is masked to the row's own coordinates, never padded, so no
// coordinate of the next row enters its scale. The divisions and products
// are IEEE round-to-nearest (__fdiv_rn, __fmul_rn, no FMA contraction), the
// plain PyTorch version's arithmetic, so the two agree bitwise. A NaN in the
// block makes the scale NaN, as torch.amax does, and the block's output 0.
// All offsets are 64-bit: L * Q exceeds 2^31 at LM width.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kItems = 4;  // coordinates a thread keeps in registers

// max of |values| that propagates NaN, as torch.amax does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float quantize_one(float g, float u, float safe, float levels,
                                              bool positive) {
  const float y = __fmul_rn(__fdiv_rn(g, safe), levels);
  const float lo = floorf(y);
  const float yq = __fadd_rn(lo, u < __fsub_rn(y, lo) ? 1.f : 0.f);
  return positive ? __fmul_rn(__fdiv_rn(yq, levels), safe) : 0.f;
}

__global__ void quantize_kernel(const float* __restrict__ g, const float* __restrict__ u,
                                float* __restrict__ out, int64_t q, int64_t chunk,
                                float levels) {
  __shared__ float warp_max[kMaxThreads / 32];
  const int64_t lane = blockIdx.y;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t len = (q - begin < chunk) ? q - begin : chunk;  // ragged last block
  const float* gb = g + lane * q + begin;
  const float* ub = u + lane * q + begin;
  float* ob = out + lane * q + begin;
  const int64_t stride = blockDim.x;
  const int64_t cached = kItems * stride;

  float gv[kItems], uv[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = threadIdx.x + k * stride;
    gv[k] = i < len ? gb[i] : 0.f;
    uv[k] = i < len ? ub[i] : 0.f;
  }
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < kItems; ++k) m = nan_max(m, fabsf(gv[k]));
  for (int64_t i = threadIdx.x + cached; i < len; i += stride) m = nan_max(m, fabsf(gb[i]));
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  float scale = warp_max[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) scale = nan_max(scale, warp_max[w]);

  const bool positive = scale > 0.f;  // false for a NaN scale, as in torch.where
  const float safe = positive ? scale : 1.f;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = threadIdx.x + k * stride;
    if (i < len) ob[i] = quantize_one(gv[k], uv[k], safe, levels, positive);
  }
  for (int64_t i = threadIdx.x + cached; i < len; i += stride) {
    ob[i] = quantize_one(gb[i], ub[i], safe, levels, positive);
  }
}

}  // namespace

extern "C" int repro_quantize(const void* g, const void* u, void* out, int lanes, int64_t q,
                              int64_t chunk, int levels, void* stream) {
  if (lanes <= 0 || lanes > 65535 || q <= 0 || chunk <= 0 || levels <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (q + chunk - 1) / chunk;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // a warp per 32 coordinates of the block, at most kMaxThreads threads
  const int64_t warps = (chunk + 31) / 32;
  const int threads = static_cast<int>(warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(lanes));
  quantize_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(u), static_cast<float*>(out), q,
      chunk, static_cast<float>(levels));
  return static_cast<int>(cudaGetLastError());
}
