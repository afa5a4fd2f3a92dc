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
// Design: one thread per (lane, coordinate). The thread forms the R
// products w[r] * x[r][q] (R independent, coalesced loads in flight) and
// stages them in dynamic shared memory laid out [r][thread], zero-padded to
// the next power of two P >= R; it then adds them as the same fixed binary
// tree as numerics.tree_sum (at each level the lower half plus the upper
// half, element by element), with round-to-nearest multiplies and adds and
// no FMA contraction. That is the plain PyTorch version's arithmetic term
// for term, so the two agree bitwise; a row of weight 0.0 contributes
// 0 * x, as there. The weights of the block's lane are staged in shared
// memory once. All offsets are 64-bit: R * Q exceeds 2^31 at LM width.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRows = 256;  // P * kThreads * 4 bytes = 128 KB at most
constexpr size_t kDefaultSmem = 48 * 1024;

__global__ void row_combine_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                   float* __restrict__ out, int r, int p, int64_t q) {
  extern __shared__ float smem[];
  float* s_w = smem;                // [r]
  float* terms = smem + kMaxRows;   // [p][kThreads]
  const int t = threadIdx.x;
  const int64_t lane = blockIdx.y;
  for (int j = t; j < r; j += kThreads) s_w[j] = w[lane * r + j];
  __syncthreads();

  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + t;
  if (col >= q) return;  // every thread owns its own column: no later barrier
  const float* xl = x + lane * static_cast<int64_t>(r) * q + col;
  float* v = terms + t;  // v[i * kThreads] is term i of this column
  for (int i = 0; i < r; ++i) v[i * kThreads] = __fmul_rn(s_w[i], xl[static_cast<int64_t>(i) * q]);
  for (int i = r; i < p; ++i) v[i * kThreads] = 0.f;
  for (int len = p; len > 1; len >>= 1) {
    const int h = len >> 1;
    for (int i = 0; i < h; ++i) v[i * kThreads] = __fadd_rn(v[i * kThreads], v[(i + h) * kThreads]);
  }
  out[lane * q + col] = v[0];
}

}  // namespace

extern "C" int repro_row_combine(const void* x, const void* w, void* out, int lanes, int r,
                                 int64_t q, void* stream) {
  if (lanes <= 0 || lanes > 65535 || r <= 0 || r > kMaxRows || q <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int p = 1;
  while (p < r) p <<= 1;
  const size_t smem = (static_cast<size_t>(kMaxRows) + static_cast<size_t>(p) * kThreads) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        row_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((q + kThreads - 1) / kThreads), static_cast<unsigned>(lanes));
  row_combine_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), r, p, q);
  return static_cast<int>(cudaGetLastError());
}
