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
// Design: one thread owns one coordinate of one lane and walks the N rows
// in a fixed order: the honest sum first, then (ALIE) the squared
// deviations in a second pass, then the output rows. The statistics are
// fused in: the TPU version kept them outside only because of an artifact
// of its CPU interpret mode. Consecutive threads touch consecutive
// coordinates of each row, so every row access is coalesced; the second
// and third passes re-read the block's rows from L2. The arithmetic uses
// explicit round-to-nearest operations, so no multiply-add is contracted.
// The output is a new tensor; the input is never written.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum Mode { kSignFlip = 0, kAlie = 1, kIpm = 2 };

__global__ void attack_kernel(const float* __restrict__ msgs,
                              const float* __restrict__ mask,
                              float* __restrict__ out, int n, int64_t q,
                              int mode, float param) {
  const int64_t lane = blockIdx.y;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= q) return;
  const float* m = msgs + lane * static_cast<int64_t>(n) * q + col;
  float* o = out + lane * static_cast<int64_t>(n) * q + col;
  const float* mk = mask + lane * n;

  if (mode == kSignFlip) {
    for (int i = 0; i < n; ++i) {
      const float x = m[static_cast<int64_t>(i) * q];
      o[static_cast<int64_t>(i) * q] = mk[i] > 0.f ? __fmul_rn(param, x) : x;
    }
    return;
  }

  float count = 0.f;
  float sum = 0.f;
  for (int i = 0; i < n; ++i) {
    const float hw = __fsub_rn(1.f, mk[i]);
    count = __fadd_rn(count, hw);
    sum = __fadd_rn(sum, __fmul_rn(m[static_cast<int64_t>(i) * q], hw));
  }
  const float h = fmaxf(count, 1.f);
  const float mu = __fdiv_rn(sum, h);

  float adv;
  if (mode == kAlie) {
    float ss = 0.f;
    for (int i = 0; i < n; ++i) {
      const float hw = __fsub_rn(1.f, mk[i]);
      const float dev = __fsub_rn(m[static_cast<int64_t>(i) * q], mu);
      ss = __fadd_rn(ss, __fmul_rn(__fmul_rn(dev, dev), hw));
    }
    const float var = __fdiv_rn(ss, h);
    adv = __fsub_rn(mu, __fmul_rn(param, __fsqrt_rn(__fadd_rn(var, 1e-12f))));
  } else {
    adv = __fmul_rn(-param, mu);
  }
  for (int i = 0; i < n; ++i) {
    const int64_t off = static_cast<int64_t>(i) * q;
    o[off] = mk[i] > 0.f ? adv : m[off];
  }
}

}  // namespace

extern "C" int repro_attack(const void* msgs, const void* mask, void* out,
                            int lanes, int n, int64_t q, int mode, float param,
                            void* stream) {
  if (lanes <= 0 || n <= 0 || q <= 0 || mode < kSignFlip || mode > kIpm) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((q + kThreads - 1) / kThreads),
                  static_cast<unsigned>(lanes));
  attack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(msgs), static_cast<const float*>(mask),
      static_cast<float*>(out), n, q, mode, param);
  return static_cast<int>(cudaGetLastError());
}
