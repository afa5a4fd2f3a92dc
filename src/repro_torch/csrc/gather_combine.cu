// Eq.-(5) encode: out[l, n, q] = sum_j w[l, j] * grads[l, subsets[l, n, j], q].
//
// Replaces: src/repro/kernels/coded_combine.py::gather_combine_pallas_lanes
// (_gather_combine_kernel), the TPU kernel that gathers every device's d
// subset rows of a (N, q_block) VMEM tile and weight-combines them.
//
// Bound on Hopper: bytes. Each output element costs d fp32 loads and one
// store; the least traffic is one read of the (L, N, Q) gradient stack and
// one write of the (L, N, Q) output. The d reads of one subset row by
// different devices hit L2 at best.
//
// Design: one thread per (lane, device) row and coordinate, four
// coordinates a thread (256 apart, so the four loads of one step are
// independent and in flight together). blockIdx.y is the (lane, device)
// row, so a block loads that row's d subset ids and the lane's d weights
// into shared memory once; consecutive threads read consecutive
// coordinates of each gathered row (coalesced). The sum over j
// runs in a fixed order with explicit round-to-nearest multiply and add
// (no FMA contraction), which is exactly the plain PyTorch version's
// arithmetic. All offsets are 64-bit: N * Q exceeds 2^31 at LM width.
// A row whose subset ids fall outside [0, N) reads nothing and is written
// as NaN: the host never reads the ids back, and no load leaves the stack.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // coordinates per thread

__global__ void gather_combine_kernel(const float* __restrict__ grads,
                                      const int32_t* __restrict__ subsets,
                                      const float* __restrict__ weights,
                                      float* __restrict__ out, int n, int d,
                                      int64_t q) {
  extern __shared__ unsigned char smem_raw[];
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem_raw);
  float* s_w = reinterpret_cast<float*>(smem_raw + sizeof(int32_t) * d);

  const int64_t row = blockIdx.y;  // lane * n + device
  const int64_t lane = row / n;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    s_idx[j] = subsets[row * d + j];
    s_w[j] = weights[lane * d + j];
  }
  __syncthreads();

  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads * kItems + threadIdx.x;
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

extern "C" int repro_gather_combine(const void* grads, const void* subsets,
                                    const void* weights, void* out, int lanes,
                                    int n, int d, int64_t q, void* stream) {
  if (lanes <= 0 || n <= 0 || d <= 0 || q <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_block = static_cast<int64_t>(kThreads) * kItems;
  const dim3 grid(static_cast<unsigned>((q + per_block - 1) / per_block),
                  static_cast<unsigned>(lanes * n));
  const size_t smem = static_cast<size_t>(d) * (sizeof(int32_t) + sizeof(float));
  gather_combine_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grads), static_cast<const int32_t*>(subsets),
      static_cast<const float*>(weights), static_cast<float*>(out), n, d, q);
  return static_cast<int>(cudaGetLastError());
}
