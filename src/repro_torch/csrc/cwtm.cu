// Coordinate-wise trimmed mean: for every coordinate, sort the N values,
// drop `trim` at each end and average the rest. (L, N, Q) -> (L, Q). With
// a neighbour table, the NNM mix comes first, inside the same pass: each
// value becomes the mean of its row's selected neighbours, and the trimmed
// mean is taken over the mixed values.
//
// Replaces: src/repro/kernels/cwtm.py::cwtm_pallas_lanes (_cwtm_kernel,
// _sort_rows), the TPU kernel that sorts an (N, q_block) VMEM tile with an
// odd-even transposition network and takes a fixed-tree mean. The NNM mix
// is not a TPU kernel (the reference computes it in XLA, outside Pallas);
// folded in here, the mixed (L, N, Q) stack is never written nor read back.
//
// Bound on Hopper: bytes (one read of the stack, one write of the (L, Q)
// result) as long as N is small; the sort's N^2 / 2 compare-exchanges per
// coordinate run from shared memory and are the limit at N near 100.
//
// Arithmetic, term for term that of the plain versions (kernels/ref.py):
//   mix   y_n = (sum over the ids j of row n of the table, in table order,
//         which is ascending, of x_j) * (1 / k), the sum started from -0.0
//         (the identity of IEEE addition, so it equals the sum started from
//         the first term);
//   sort  the same branch-free odd-even transposition network as the TPU
//         kernel;
//   mean  the kept rows [trim, N - trim) as the fixed binary tree of
//         numerics.tree_sum (zero-padded to a power of two), times
//         1 / (N - 2 trim).
// A table whose ids are not strictly ascending in [0, N) turns its whole
// lane into NaN (the wrapper reads nothing back from the card).
//
// Design:
//   * N <= 12 (the wide round's N = 8): registers. A thread owns 4
//     consecutive columns and loads one float4 per row; the block turns the
//     lane's table into one N-bit mask per row in shared memory first, so
//     the mix is N predicated adds per mixed value, with register indices
//     fixed at compile time. The sort and the kept-row tree are unrolled
//     for each N and each trim.
//   * any N up to 256 (the trainer's N = 100): one thread per column, its
//     values staged in dynamic shared memory laid out [n][thread] so that
//     neighbouring threads hit neighbouring banks; the mixed values take a
//     second [n][thread] region. At N = 100 the mixed launch needs 102.4 KB,
//     above the 48 KB default, so the launch raises the kernel's dynamic
//     shared memory limit first.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;       // shared-memory path
constexpr int kRegThreads = 256;    // register path
constexpr int kCols = 4;            // columns a register-path thread owns
constexpr int kRegMaxN = 12;
constexpr size_t kMaxSmem = 232448;  // H100: 227 KB per block

__host__ __device__ constexpr int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// The fixed tree over the kept rows [T, N - T) of each column, times inv_k.
template <int N, int T>
__device__ __forceinline__ void kept_tree(const float (&v)[N][kCols], float inv_k, float (&r)[kCols]) {
  constexpr int kValid = N - 2 * T;
  constexpr int kLen = pow2_ceil(kValid);
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    float t[kLen];
#pragma unroll
    for (int i = 0; i < kLen; ++i) t[i] = i < kValid ? v[i < kValid ? T + i : 0][c] : 0.f;
#pragma unroll
    for (int h = kLen / 2; h >= 1; h /= 2) {
#pragma unroll
      for (int i = 0; i < h; ++i) t[i] = __fadd_rn(t[i], t[i + h]);
    }
    r[c] = __fmul_rn(t[0], inv_k);
  }
}

template <int N, int T = 0>
__device__ __forceinline__ void trimmed_mean(const float (&v)[N][kCols], int trim, float inv_k,
                                             float (&r)[kCols]) {
  if constexpr (2 * T < N) {
    if (trim == T) {
      kept_tree<N, T>(v, inv_k, r);
    } else {
      trimmed_mean<N, T + 1>(v, trim, inv_k, r);
    }
  }
}

// Checks the lane's (n, k) table; with `masks`, thread r < n also writes
// row r's ids as a bit mask. Every thread of the block must call it.
// Returns true (to every thread) if any id is out of range or out of order.
__device__ __forceinline__ bool read_table(const int* __restrict__ nb, int n, int k,
                                           unsigned* __restrict__ masks) {
  int bad = 0;
  for (int e = threadIdx.x; e < n * k; e += blockDim.x) {
    const int id = nb[e];
    if (id < 0 || id >= n || (e % k != 0 && id <= nb[e - 1])) bad = 1;
  }
  if (masks != nullptr && threadIdx.x < n) {
    unsigned bits = 0u;
    for (int m = 0; m < k; ++m) {
      const int id = nb[threadIdx.x * k + m];
      if (id >= 0 && id < n) bits |= 1u << id;
    }
    masks[threadIdx.x] = bits;
  }
  return __syncthreads_or(bad) != 0;
}

template <int N>
__global__ void __launch_bounds__(kRegThreads)
cwtm_reg_kernel(const float* __restrict__ msgs, const int* __restrict__ nbr, int k, float inv_mix,
                float* __restrict__ out, int64_t q, int trim, float inv_k, bool vec) {
  __shared__ unsigned masks[N];
  const int64_t lane = blockIdx.y;
  const bool mixing = nbr != nullptr;
  const bool bad = mixing && read_table(nbr + lane * N * k, N, k, masks);
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * kRegThreads + threadIdx.x) * kCols;
  if (c0 >= q) return;
  const float* m = msgs + lane * N * q + c0;
  const bool full = vec && c0 + kCols <= q;

  float x[N][kCols];
  if (full) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(m + static_cast<int64_t>(i) * q));
      x[i][0] = v.x;
      x[i][1] = v.y;
      x[i][2] = v.z;
      x[i][3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) x[i][c] = c0 + c < q ? m[static_cast<int64_t>(i) * q + c] : 0.f;
    }
  }

  if (mixing) {
    float y[N][kCols];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const unsigned sel = masks[r];
#pragma unroll
      for (int c = 0; c < kCols; ++c) y[r][c] = -0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (sel & (1u << j)) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) y[r][c] = __fadd_rn(y[r][c], x[j][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < N; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) x[r][c] = __fmul_rn(y[r][c], inv_mix);
    }
  }

#pragma unroll
  for (int phase = 0; phase < N; ++phase) {
#pragma unroll
    for (int i = phase & 1; i + 1 < N; i += 2) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float a = x[i][c];
        const float b = x[i + 1][c];
        x[i][c] = fminf(a, b);
        x[i + 1][c] = fmaxf(a, b);
      }
    }
  }

  float r[kCols];
  trimmed_mean<N>(x, trim, inv_k, r);
  if (bad) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) r[c] = __int_as_float(0x7fc00000);
  }
  float* o = out + lane * q + c0;
  if (full) {
    *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c0 + c < q) o[c] = r[c];
    }
  }
}

__global__ void cwtm_smem_kernel(const float* __restrict__ msgs, const int* __restrict__ nbr, int k,
                                 float inv_mix, float* __restrict__ out, int n, int64_t q, int trim,
                                 float inv_k) {
  extern __shared__ float col_vals[];  // [n][kThreads], then the mixed [n][kThreads]
  const int t = threadIdx.x;
  const int64_t lane = blockIdx.y;
  const int* nb = nbr == nullptr ? nullptr : nbr + lane * n * k;
  const bool bad = nb != nullptr && read_table(nb, n, k, nullptr);
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + t;
  if (col >= q) return;  // every thread owns its own column: no block barrier below
  const float* m = msgs + lane * static_cast<int64_t>(n) * q + col;
  float* v = col_vals + t;  // v[i * kThreads] is row i of this column
  for (int i = 0; i < n; ++i) v[i * kThreads] = m[static_cast<int64_t>(i) * q];

  if (nb != nullptr) {
    float* y = v + n * kThreads;
    for (int r = 0; r < n; ++r) {
      float acc = -0.f;
      if (!bad) {
        for (int j = 0; j < k; ++j) acc = __fadd_rn(acc, v[nb[r * k + j] * kThreads]);
      }
      y[r * kThreads] = __fmul_rn(acc, inv_mix);
    }
    v = y;
  }

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
  int len = pow2_ceil(valid);
  while (len > 1) {
    const int h = len >> 1;
    for (int i = 0; i < h; ++i) {
      const float hi = (i + h < valid) ? kept[(i + h) * kThreads] : 0.f;
      kept[i * kThreads] = __fadd_rn(kept[i * kThreads], hi);
    }
    valid = h;
    len = h;
  }
  out[lane * q + col] = bad ? __int_as_float(0x7fc00000) : __fmul_rn(kept[0], inv_k);
}

template <int N>
cudaError_t launch_reg(const float* msgs, const int* nbr, int k, float inv_mix, float* out, int lanes,
                       int64_t q, int trim, float inv_k, bool vec, cudaStream_t s) {
  const int64_t per_block = static_cast<int64_t>(kRegThreads) * kCols;
  const dim3 grid(static_cast<unsigned>((q + per_block - 1) / per_block), static_cast<unsigned>(lanes));
  cwtm_reg_kernel<N><<<grid, kRegThreads, 0, s>>>(msgs, nbr, k, inv_mix, out, q, trim, inv_k, vec);
  return cudaGetLastError();
}

}  // namespace

// nbr: null (no mix) or the (lanes, n, k) int32 neighbour table, its rows
// strictly ascending; inv_mix = 1 / k.
extern "C" int repro_cwtm(const void* msgs, const void* nbr, int k, float inv_mix, void* out,
                          int lanes, int n, int64_t q, int trim, float inv_k, void* stream) {
  if (lanes <= 0 || n <= 0 || q <= 0 || trim < 0 || 2 * trim >= n ||
      (nbr != nullptr && (k <= 0 || k > n))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(msgs);
  const int* nb = static_cast<const int*>(nbr);
  float* o = static_cast<float*>(out);
  const bool vec = q % kCols == 0 && reinterpret_cast<uintptr_t>(msgs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (n <= kRegMaxN && n >= 2) {
    cudaError_t err = cudaSuccess;
    switch (n) {
#define REPRO_CWTM_REG(N) \
  case N:                 \
    err = launch_reg<N>(x, nb, k, inv_mix, o, lanes, q, trim, inv_k, vec, s); \
    break;
      REPRO_CWTM_REG(2) REPRO_CWTM_REG(3) REPRO_CWTM_REG(4) REPRO_CWTM_REG(5)
      REPRO_CWTM_REG(6) REPRO_CWTM_REG(7) REPRO_CWTM_REG(8) REPRO_CWTM_REG(9)
      REPRO_CWTM_REG(10) REPRO_CWTM_REG(11) REPRO_CWTM_REG(12)
#undef REPRO_CWTM_REG
    }
    return static_cast<int>(err);
  }
  const size_t smem = static_cast<size_t>(nb == nullptr ? 1 : 2) * n * kThreads * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cwtm_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((q + kThreads - 1) / kThreads), static_cast<unsigned>(lanes));
  cwtm_smem_kernel<<<grid, kThreads, smem, s>>>(x, nb, k, inv_mix, o, n, q, trim, inv_k);
  return static_cast<int>(cudaGetLastError());
}
