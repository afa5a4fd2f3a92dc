// Coordinate-wise trimmed mean: for every coordinate, sort the N values,
// drop `trim` at each end and average the rest. (L, N, Q) -> (L, Q).
//
// Replaces: src/repro/kernels/cwtm.py::cwtm_pallas_lanes (_cwtm_kernel,
// _sort_rows), the TPU kernel that sorts an (N, q_block) VMEM tile with an
// odd-even transposition network and takes a fixed-tree mean.
//
// Bound on Hopper: bytes (one read of the stack, one write of the (L, Q)
// result) as long as N is small; the sort's N^2 / 2 compare-exchanges per
// coordinate run from shared memory and are the limit at N near 100.
//
// Design: one thread per coordinate. The block stages its 128 columns in
// dynamic shared memory laid out [n][thread], so the N values of one column
// sit one row apart and neighbouring threads hit neighbouring banks. Each
// thread sorts its own column with the same branch-free odd-even
// transposition network as the TPU kernel, then sums the kept rows
// [trim, N - trim) as the same fixed binary tree as numerics.tree_sum
// (zero-padded to a power of two) and multiplies by 1 / (N - 2 trim): the
// plain PyTorch version's arithmetic, term for term. At N = 100 the block
// needs 51.2 KB, above the 48 KB default, so the launch raises the
// kernel's dynamic shared memory limit first.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr size_t kMaxSmem = 232448;  // H100: 227 KB per block

__global__ void cwtm_kernel(const float* __restrict__ msgs, float* __restrict__ out,
                            int n, int64_t q, int trim, float inv_k) {
  extern __shared__ float col_vals[];  // [n][kThreads]
  const int t = threadIdx.x;
  const int64_t lane = blockIdx.y;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + t;
  if (col >= q) return;  // every thread owns its own column: no block barrier
  const float* m = msgs + lane * static_cast<int64_t>(n) * q + col;
  float* v = col_vals + t;  // v[i * kThreads] is row i of this column
  for (int i = 0; i < n; ++i) v[i * kThreads] = m[static_cast<int64_t>(i) * q];

  for (int phase = 0; phase < n; ++phase) {
    for (int i = phase & 1; i + 1 < n; i += 2) {
      const float a = v[i * kThreads];
      const float b = v[(i + 1) * kThreads];
      v[i * kThreads] = fminf(a, b);
      v[(i + 1) * kThreads] = fmaxf(a, b);
    }
  }

  // fixed-tree sum of the kept rows, in place
  float* kept = v + trim * kThreads;
  int valid = n - 2 * trim;
  int len = 1;
  while (len < valid) len <<= 1;
  while (len > 1) {
    const int h = len >> 1;
    for (int i = 0; i < h; ++i) {
      const float hi = (i + h < valid) ? kept[(i + h) * kThreads] : 0.f;
      kept[i * kThreads] = __fadd_rn(kept[i * kThreads], hi);
    }
    valid = h;
    len = h;
  }
  out[lane * q + col] = __fmul_rn(kept[0], inv_k);
}

}  // namespace

extern "C" int repro_cwtm(const void* msgs, void* out, int lanes, int n, int64_t q,
                          int trim, float inv_k, void* stream) {
  if (lanes <= 0 || n <= 0 || q <= 0 || trim < 0 || 2 * trim >= n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(n) * kThreads * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cwtm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((q + kThreads - 1) / kThreads),
                  static_cast<unsigned>(lanes));
  cwtm_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(msgs), static_cast<float*>(out), n, q, trim, inv_k);
  return static_cast<int>(cudaGetLastError());
}
