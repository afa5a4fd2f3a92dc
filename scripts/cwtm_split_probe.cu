// CWTM-NNM at 13 <= N <= 128 split in two kernels: a mix kernel writes the
// mixed (L, N, Q) stack, then src/repro_torch/csrc/cwtm.cu's sort-only
// kernel reads it. This is the design that cwtm.cu's one-kernel mix and
// sort (cwtm_mix_net_kernel) is timed against. Built only by
// scripts/torch_mix_plans.py, beside a copy of cwtm.cu and tile.cuh, and
// used by nothing else.
//
// A mix block takes one lane and a tile of `cols` columns, stages it and
// the table, builds the row masks and mixes as cwtm_mix_net_kernel does
// (mix_stage, mix_items), with up to 1,024 threads, into the stack; the
// sort then runs a thread a column over lanes x Q (cwtm_net_kernel).
#include "cwtm.cu"

namespace {

constexpr int kSplitMaxThreads = 1024;

__global__ void __launch_bounds__(kSplitMaxThreads)
cwtm_split_mix_kernel(const float* __restrict__ msgs, const int* __restrict__ nbr, int k, float inv_mix,
                      float* __restrict__ mixed, int n, int64_t q, int cols, int tiles) {
  extern __shared__ float4 tile[];
  const int rows = (n + kMixStep - 1) / kMixStep * kMixStep;
  const int stride = cols >> 2;
  unsigned* masks = reinterpret_cast<unsigned*>(tile + rows * stride);
  int* tab = reinterpret_cast<int*>(masks + kMixWords * rows);
  const int64_t lane = blockIdx.x / tiles;
  const int64_t c0 = (blockIdx.x - lane * tiles) * static_cast<int64_t>(cols);
  const int width = static_cast<int>(q - c0 < cols ? q - c0 : cols);
  const int bad = mix_stage(tile, masks, tab, msgs, nbr, k, n, q, lane, c0, cols, width, rows, true);
  mix_items(tile, masks, rows, stride, n, width, bad, inv_mix, mixed + lane * n * q + c0, q);
}

template <int P>
cudaError_t launch_split(const float* msgs, const int* nbr, int k, float inv_mix, float* mixed, float* out,
                         int lanes, int n, int64_t q, int trim, float inv_k, int cols, int threads, cudaStream_t s) {
  const int64_t tiles = (q + cols - 1) / cols;
  if (tiles > INT_MAX / lanes) return cudaErrorInvalidValue;
  const int rows = (n + kMixStep - 1) / kMixStep * kMixStep;
  const size_t smem = (static_cast<size_t>(rows) * (cols + kMixWords) + static_cast<size_t>(n) * k) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(cwtm_split_mix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cwtm_split_mix_kernel<<<static_cast<unsigned>(lanes * tiles), threads, smem, s>>>(msgs, nbr, k, inv_mix, mixed,
                                                                                    n, q, cols, static_cast<int>(tiles));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_net<P>(mixed, out, lanes, n, q, trim, inv_k, s);
}

}  // namespace

// As repro_cwtm with a table at 13 <= n <= 128, split: `mixed` a (lanes, n,
// q) scratch stack, `cols` columns and `threads` threads a mix block. The
// 16-byte stores of the mix want q % 4 == 0 and 16-byte aligned stacks.
extern "C" int repro_cwtm_split(const void* msgs, const void* nbr, int k, float inv_mix, void* mixed, void* out,
                                int lanes, int n, int64_t q, int trim, float inv_k, int cols, int threads,
                                void* stream) {
  if (lanes <= 0 || n <= kRegMaxN || n > kNetMaxN || q <= 0 || q % 4 != 0 || trim < 0 || 2 * trim >= n ||
      nbr == nullptr || k <= 0 || k > n || cols < 4 || cols > kMixMaxCols || cols % 4 != 0 || threads < 32 ||
      threads > kSplitMaxThreads || threads % 32 != 0 || !repro_tile::aligned16(msgs) || !repro_tile::aligned16(mixed)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* x = static_cast<const float*>(msgs);
  const int* nb = static_cast<const int*>(nbr);
  float* y = static_cast<float*>(mixed);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n <= 16) {
    err = launch_split<16>(x, nb, k, inv_mix, y, o, lanes, n, q, trim, inv_k, cols, threads, s);
  } else if (n <= 32) {
    err = launch_split<32>(x, nb, k, inv_mix, y, o, lanes, n, q, trim, inv_k, cols, threads, s);
  } else if (n <= 64) {
    err = launch_split<64>(x, nb, k, inv_mix, y, o, lanes, n, q, trim, inv_k, cols, threads, s);
  } else {
    err = launch_split<128>(x, nb, k, inv_mix, y, o, lanes, n, q, trim, inv_k, cols, threads, s);
  }
  return static_cast<int>(err);
}
