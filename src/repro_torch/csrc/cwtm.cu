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
// result) at small N; the sort's compare-exchanges, integer min and max at
// half the fp32 rate, at N near 100; the mix's N k adds when it is on.
//
// Order: values sort as jnp.sort and kernels/ref.py sort them, every NaN
// last, whatever its sign. Each float becomes an ordered signed 32-bit key
// (its bits, the lower 31 flipped if it is negative: a map that is its own
// inverse; every NaN one key, 0x7FFFFFFE, above +inf's), and the network
// orders keys with integer min and max, so a NaN is neither lost nor
// doubled. -0 sorts before +0, which compare equal and sum alike.
//
// Arithmetic, term for term that of the plain versions (kernels/ref.py):
//   mix   y_n = (sum over the ids j of row n of the table, in table order,
//         which is ascending, of x_j) * (1 / k), the sum started from -0.0
//         (the identity of IEEE addition, so it equals the sum started from
//         the first term);
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
//     fixed at compile time. An odd-even transposition network over the
//     keys and the kept-row tree are unrolled for each N and each trim.
//   * 13 <= N <= 128 (Section VII's N = 100, DRACO-d41's groups): one
//     thread a column, its N keys in registers, padded to P = 16, 32, 64 or
//     128 slots with a key above NaN's; Batcher's odd-even merge network on
//     P slots (1,471 compare-exchanges at P = 128, kernels/cwtm.py::network
//     lists them) unrolled at compile time; the kept slots shifted to the
//     front by trim's bits (log2(P) - 1 fixed shifts, each taken or not) and
//     summed as the tree whose levels are taken while they fit the kept
//     count. Columns run over lanes x Q as one range, so a lane of Q = 100
//     leaves no block idle.
//     With the mix, cwtm_mix_net_kernel<P>: a block takes one lane and a
//     tile of C columns (kernels/cwtm.py::mix_plan). It stages the lane's
//     (N, C) originals in shared memory and turns the lane's table into
//     N-bit row masks there (ids in ascending order are the set bits in
//     ascending order, so no id is loaded a term); a thread's item is 4
//     rows x 4 columns and, for each j, it loads x_j's 4 columns once (16
//     bytes) and adds them into each of its rows whose mask holds j, a
//     predicated add. The mixed (N, C) tile goes to shared memory (over the
//     staged table, read by then); after one barrier a thread a column
//     reads its N mixed keys and runs the network and the kept-row tree
//     above. The rows of the mix are spread over the block's threads and
//     the columns over blocks, so at 1 lane the lane's tiles run on as many
//     SMs. scripts/torch_mix_plans.py times it against the split design (a
//     mix kernel writing the mixed (L, N, Q) stack, then the sort-only
//     kernel; scripts/cwtm_split_probe.cu).
//   * 129 <= N <= 256: the same compare-exchanges on 256 slots, level by
//     level in loops, with the keys in shared memory, [slot][thread], 64
//     threads a block; with the mix, its N originals staged in shared
//     memory and k table ids loaded a mixed value.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kRegThreads = 256;    // register path
constexpr int kCols = 4;            // columns a register-path thread owns
constexpr int kRegMaxN = 12;
constexpr int kNetThreads = 128;    // register network
constexpr int kNetMaxN = 128;
constexpr int kMixRows = 4;         // mix kernel: rows a thread's item holds
constexpr int kMixStep = 8;         // ids a step of the mix loop: staged rows are padded to a multiple
constexpr int kMixWords = kNetMaxN / 32;  // mask words a row
constexpr int kMixMaxCols = 128;
constexpr int kMixMaxThreads = 256;  // a thread holds the network's registers too (191 at P = 128)
constexpr int kWideP = 256;         // shared-memory network: slots
constexpr int kWideThreads = 64;
constexpr int32_t kNanKey = 0x7FFFFFFE;  // every NaN: above +inf's 0x7F800000, itself a NaN's bits
constexpr int32_t kPadKey = 0x7FFFFFFF;  // a padding slot: above every value
constexpr int kNaNBits = 0x7fc00000;  // what a lane with a bad table comes out as

__host__ __device__ constexpr int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// The lower 31 bits flipped where the sign bit is set.
__device__ __forceinline__ int32_t flip(int32_t b) { return b ^ ((b >> 31) & 0x7FFFFFFF); }

__device__ __forceinline__ int32_t float_key(float f) { return isnan(f) ? kNanKey : flip(__float_as_int(f)); }

__device__ __forceinline__ float key_float(int32_t k) { return __int_as_float(flip(k)); }

__device__ __forceinline__ void order_keys(int32_t& a, int32_t& b) {
  const int32_t lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// The fixed tree over the kept rows [T, N - T) of each column of sorted
// keys, times inv_k.
template <int N, int T>
__device__ __forceinline__ void kept_tree(const int32_t (&v)[N][kCols], float inv_k, float (&r)[kCols]) {
  constexpr int kValid = N - 2 * T;
  constexpr int kLen = pow2_ceil(kValid);
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    float t[kLen];
#pragma unroll
    for (int i = 0; i < kLen; ++i) t[i] = i < kValid ? key_float(v[i < kValid ? T + i : 0][c]) : 0.f;
#pragma unroll
    for (int h = kLen / 2; h >= 1; h /= 2) {
#pragma unroll
      for (int i = 0; i < h; ++i) t[i] = __fadd_rn(t[i], t[i + h]);
    }
    r[c] = __fmul_rn(t[0], inv_k);
  }
}

template <int N, int T = 0>
__device__ __forceinline__ void trimmed_mean(const int32_t (&v)[N][kCols], int trim, float inv_k,
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

  int32_t v[N][kCols];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[i][c] = float_key(x[i][c]);
  }
#pragma unroll
  for (int phase = 0; phase < N; ++phase) {
#pragma unroll
    for (int i = phase & 1; i + 1 < N; i += 2) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) order_keys(v[i][c], v[i + 1][c]);
    }
  }

  float r[kCols];
  trimmed_mean<N>(v, trim, inv_k, r);
  if (bad) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) r[c] = __int_as_float(kNaNBits);
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

// The lanes a block of `threads` columns from column `first` touches, of
// `total` = lanes x q columns.
__device__ __forceinline__ int lanes_touched(int64_t first, int threads, int64_t total, int64_t q) {
  const int64_t last = (first + threads < total ? first + threads : total) - 1;
  return static_cast<int>(last / q - first / q) + 1;
}

// Sets bad[l] to 1, else 0, for each lane lane_lo + l (l < span) whose
// (n, k) table has an id out of range or out of order. Every thread of the
// block must call it.
__device__ void check_tables(const int* __restrict__ nbr, int n, int k, int64_t lane_lo, int span,
                             int* __restrict__ bad) {
  for (int l = threadIdx.x; l < span; l += blockDim.x) bad[l] = 0;
  __syncthreads();
  const int per = n * k;
  const int* nb = nbr + lane_lo * per;
  for (int e = threadIdx.x; e < span * per; e += blockDim.x) {
    const int id = nb[e];
    if (id < 0 || id >= n || (e % k != 0 && id <= nb[e - 1])) bad[e / per] = 1;
  }
  __syncthreads();
}

// Batcher's odd-even merge of the slots Lo, Lo + R, Lo + 2R, ... up to Hi
// (inclusive): the two interleaved halves merged, then neighbours ordered.
template <int Lo, int Hi, int R, int P>
__device__ __forceinline__ void odd_even_merge(int32_t (&v)[P]) {
  constexpr int kStep = 2 * R;
  if constexpr (kStep < Hi - Lo) {
    odd_even_merge<Lo, Hi, kStep>(v);
    odd_even_merge<Lo + R, Hi, kStep>(v);
#pragma unroll
    for (int i = Lo + R; i < Hi - R; i += kStep) order_keys(v[i], v[i + R]);
  } else {
    order_keys(v[Lo], v[Lo + R]);
  }
}

// Batcher's odd-even merge sort of the slots [Lo, Hi], expanded at compile
// time so that every register index is fixed (loops over shifted induction
// variables are left rolled, and the array then lives in local memory);
// kernels/cwtm.py::network lists its compare-exchanges in this order.
template <int Lo, int Hi, int P>
__device__ __forceinline__ void odd_even_merge_sort(int32_t (&v)[P]) {
  if constexpr (Hi - Lo >= 1) {
    constexpr int kMid = Lo + (Hi - Lo) / 2;
    odd_even_merge_sort<Lo, kMid>(v);
    odd_even_merge_sort<kMid + 1, Hi>(v);
    odd_even_merge<Lo, Hi, 1>(v);
  }
}

// Slot i takes slot i + trim, one power of two of trim (S and up) at a time.
template <int P, int S = 1>
__device__ __forceinline__ void shift_down(int32_t (&v)[P], int trim) {
  if constexpr (S < P / 2) {  // 2 trim < n <= P: trim < P / 2
    if (trim & S) {
#pragma unroll
      for (int i = 0; i < P - S; ++i) v[i] = v[i + S];
    }
    shift_down<P, 2 * S>(v, trim);
  }
}

// The levels of the fixed tree of half-width H and below that fit a tree
// of len leaves (a power of two).
template <int P, int H = P / 2>
__device__ __forceinline__ void tree_levels(float (&t)[P], int len) {
  if constexpr (H >= 1) {
    if (H < len) {
#pragma unroll
      for (int i = 0; i < H; ++i) t[i] = __fadd_rn(t[i], t[i + H]);
    }
    tree_levels<P, H / 2>(t, len);
  }
}

// The fixed tree over the kept slots [trim, n - trim), times inv_k.
template <int P>
__device__ __forceinline__ float kept_mean(int32_t (&v)[P], int n, int trim, float inv_k) {
  shift_down<P>(v, trim);
  const int valid = n - 2 * trim;
  float t[P];
#pragma unroll
  for (int i = 0; i < P; ++i) t[i] = i < valid ? key_float(v[i]) : 0.f;
  tree_levels<P>(t, pow2_ceil(valid));
  return __fmul_rn(t[0], inv_k);
}

// The barrier after the loads keeps all N of them in flight at once: left
// free, the compiler sinks each load to its first compare-exchange, and the
// network then waits on one load after another (twice the time at N = 100).
template <int P>
__global__ void __launch_bounds__(kNetThreads)
cwtm_net_kernel(const float* __restrict__ msgs, float* __restrict__ out, int64_t total, int n, int64_t q,
                int trim, float inv_k) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kNetThreads + threadIdx.x;
  const bool live = c < total;
  const int64_t lane = live ? c / q : 0;
  const float* m = msgs + lane * n * q + (live ? c - lane * q : 0);
  int32_t v[P];
#pragma unroll
  for (int i = 0; i < P; ++i) v[i] = live && i < n ? float_key(__ldg(m + i * q)) : kPadKey;
  __syncthreads();
  if (!live) return;
  odd_even_merge_sort<0, P - 1>(v);
  out[c] = kept_mean<P>(v, n, trim, inv_k);
}

// The NNM mix of the 13 <= N <= 128 path, in two steps a block calls in
// turn (cwtm_mix_net_kernel; scripts/cwtm_split_probe.cu calls them too).
// mix_stage stages columns [c0, c0 + width) of lane `lane`'s originals as
// [row][cols / 4] float4s in `tile` (rows padded to a multiple of kMixStep;
// a warp reads consecutive 16-byte words of one row), the lane's table in
// `tab` (both by asynchronous copies), and the masks built from it as
// [word][row] in `masks`. It returns, to every thread, whether an id is out
// of range or order. Every thread of the block must call it.
__device__ __forceinline__ int mix_stage(float4* tile, unsigned* masks, int* tab, const float* msgs,
                                         const int* nbr, int k, int n, int64_t q, int64_t lane, int64_t c0,
                                         int cols, int width, int rows, bool vec) {
  // stage the originals and the table: asynchronous copies, all in flight together
  repro_tile::stage_tile(reinterpret_cast<float*>(tile), cols, msgs + lane * n * q, n, q, c0, width, vec);
  const int* nb = nbr + lane * n * k;
  const int entries = n * k;
  if ((entries & 3) == 0 && repro_tile::aligned16(nb)) {
    for (int i = threadIdx.x; i < entries >> 2; i += blockDim.x) repro_tile::cp_async16(tab + 4 * i, nb + 4 * i);
  } else {
    for (int i = threadIdx.x; i < entries; i += blockDim.x) repro_tile::cp_async4(tab + i, nb + i);
  }
  repro_tile::cp_async_wait_all();
  __syncthreads();
  // the table to masks, a warp a row: 32 ids at a time, each id's bit ORed
  // into its word across the warp; each id is checked against the one
  // before it in its row. Rows past n get empty masks.
  const int me = threadIdx.x & 31;
  int bad = 0;
  for (int row = threadIdx.x >> 5; row < rows; row += blockDim.x >> 5) {
    unsigned word[kMixWords] = {0u, 0u, 0u, 0u};
    for (int e0 = 0; row < n && e0 < k; e0 += 32) {  // the same trips for the whole warp
      const int e = e0 + me;
      const int id = e < k ? tab[row * k + e] : -1;
      const int prev = e < k && e > 0 ? tab[row * k + e - 1] : -1;
      if (e < k && (id < 0 || id >= n || id <= prev)) bad = 1;
      const unsigned bit = id >= 0 && id < n ? 1u << (id & 31) : 0u;
#pragma unroll
      for (int w = 0; w < kMixWords; ++w) word[w] |= __reduce_or_sync(0xffffffffu, (id >> 5) == w ? bit : 0u);
    }
    if (me == 0) {
#pragma unroll
      for (int w = 0; w < kMixWords; ++w) masks[w * rows + row] = word[w];
    }
  }
  return __syncthreads_or(bad);
}

// mix_items: a thread's item is rows r0..r0+3 of one 4-column group of the
// staged tile; each mixed value is one chain of adds over the ascending ids
// of its row, from -0.0, then times inv_mix (NaN for a bad table, so its
// trimmed means come out NaN). Mixed row r goes to y + r * ystride, 16
// bytes a group (y and ystride 16-byte aligned; a ragged tile's last group
// writes past `width`, inside the row's stride).
__device__ __forceinline__ void mix_items(const float4* tile, const unsigned* masks, int rows, int stride,
                                          int n, int width, int bad, float inv_mix, float* y, int64_t ystride) {
  const int groups = (width + 3) >> 2;
  const int items = (n + kMixRows - 1) / kMixRows * groups;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int r0 = item / groups * kMixRows, g = item % groups;
    float4 acc[kMixRows];
#pragma unroll
    for (int s = 0; s < kMixRows; ++s) acc[s] = make_float4(-0.f, -0.f, -0.f, -0.f);
    for (int w = 0; 32 * w < n; ++w) {
      unsigned sel[kMixRows];
#pragma unroll
      for (int s = 0; s < kMixRows; ++s) sel[s] = masks[w * rows + r0 + s];
      const float4* xw = tile + 32 * w * stride + g;
      const int span = n - 32 * w < 32 ? n - 32 * w : 32;
      for (int b0 = 0; b0 < span; b0 += kMixStep) {  // rows up to `rows` are staged: b0 + 7 reads no further
#pragma unroll
        for (int b = 0; b < kMixStep; ++b) {
          const float4 x = xw[(b0 + b) * stride];
#pragma unroll
          for (int s = 0; s < kMixRows; ++s) {
            if (sel[s] & (1u << b)) {
              acc[s].x = __fadd_rn(acc[s].x, x.x);
              acc[s].y = __fadd_rn(acc[s].y, x.y);
              acc[s].z = __fadd_rn(acc[s].z, x.z);
              acc[s].w = __fadd_rn(acc[s].w, x.w);
            }
          }
        }
#pragma unroll
        for (int s = 0; s < kMixRows; ++s) sel[s] >>= kMixStep;
      }
    }
#pragma unroll
    for (int s = 0; s < kMixRows; ++s) {
      const int r = r0 + s;
      if (r >= n) break;
      const float4 v = bad ? make_float4(__int_as_float(kNaNBits), __int_as_float(kNaNBits),
                                         __int_as_float(kNaNBits), __int_as_float(kNaNBits))
                           : make_float4(__fmul_rn(acc[s].x, inv_mix), __fmul_rn(acc[s].y, inv_mix),
                                         __fmul_rn(acc[s].z, inv_mix), __fmul_rn(acc[s].w, inv_mix));
      *reinterpret_cast<float4*>(y + r * ystride + 4 * g) = v;
    }
  }
}

// Block b mixes lane b / tiles over its columns [c0, c0 + cols) into a
// shared (n, cols) tile, then sorts each of them and writes its trimmed
// mean. Shared memory: the staged originals, the masks, then the table,
// which the mixed tile overwrites once the masks are built.
template <int P>
__global__ void __launch_bounds__(kMixMaxThreads)
cwtm_mix_net_kernel(const float* __restrict__ msgs, const int* __restrict__ nbr, int k, float inv_mix,
                    float* __restrict__ out, int n, int64_t q, int cols, int tiles, bool vec, int trim, float inv_k) {
  extern __shared__ float4 tile[];
  const int rows = (n + kMixStep - 1) / kMixStep * kMixStep;
  const int stride = cols >> 2;  // float4s a staged row
  unsigned* masks = reinterpret_cast<unsigned*>(tile + rows * stride);  // [kMixWords][rows]
  int* tab = reinterpret_cast<int*>(masks + kMixWords * rows);  // the lane's (n, k) table
  float* y = reinterpret_cast<float*>(tab);  // then the mixed tile, [n][cols]
  const int64_t lane = blockIdx.x / tiles;
  const int64_t c0 = (blockIdx.x - lane * tiles) * static_cast<int64_t>(cols);
  const int width = static_cast<int>(q - c0 < cols ? q - c0 : cols);
  const int bad = mix_stage(tile, masks, tab, msgs, nbr, k, n, q, lane, c0, cols, width, rows, vec);
  mix_items(tile, masks, rows, stride, n, width, bad, inv_mix, y, cols);
  __syncthreads();
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    int32_t v[P];
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = i < n ? float_key(y[i * cols + c]) : kPadKey;
    odd_even_merge_sort<0, P - 1>(v);
    out[lane * q + c0 + c] = kept_mean<P>(v, n, trim, inv_k);
  }
}

__global__ void __launch_bounds__(kWideThreads)
cwtm_wide_kernel(const float* __restrict__ msgs, const int* __restrict__ nbr, int k, float inv_mix,
                 float* __restrict__ out, int64_t total, int n, int64_t q, int trim, float inv_k) {
  // the keys, [kWideP][kWideThreads]; with the mix then the originals, [n][kWideThreads]
  extern __shared__ int32_t keys[];
  __shared__ int bad[kWideThreads];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWideThreads;
  const int64_t lane_lo = first / q;
  const bool mixing = nbr != nullptr;
  if (mixing) check_tables(nbr, n, k, lane_lo, lanes_touched(first, kWideThreads, total, q), bad);
  const int64_t c = first + threadIdx.x;
  if (c >= total) return;
  const int64_t lane = c / q;
  const float* m = msgs + lane * n * q + (c - lane * q);
  int32_t* v = keys + threadIdx.x;  // v[s * kWideThreads] is slot s of this column

  bool lane_bad = false;
  if (!mixing) {
    for (int i = 0; i < kWideP; ++i) v[i * kWideThreads] = i < n ? float_key(__ldg(m + i * q)) : kPadKey;
  } else {
    lane_bad = bad[lane - lane_lo] != 0;
    float* x = reinterpret_cast<float*>(keys + kWideP * kWideThreads) + threadIdx.x;
    for (int j = 0; j < n; ++j) x[j * kWideThreads] = __ldg(m + j * q);
    const int* nb = nbr + lane * n * k;
    for (int r = 0; r < kWideP; ++r) {
      float acc = -0.f;
      if (r < n && !lane_bad) {
        for (int j = 0; j < k; ++j) acc = __fadd_rn(acc, x[__ldg(nb + r * k + j) * kWideThreads]);
      }
      v[r * kWideThreads] = r < n ? float_key(__fmul_rn(acc, inv_mix)) : kPadKey;
    }
  }

  // odd_even_merge_sort's compare-exchanges level by level, as loops: unrolled, the 3,839 of them
  // let the compiler hold loads across the network and spill
#pragma unroll 1
  for (int p = 1, lg = 1; p < kWideP; p <<= 1, ++lg) {  // 2p = 1 << lg
#pragma unroll 1
    for (int kk = p; kk >= 1; kk >>= 1) {
#pragma unroll 1
      for (int j = kk % p; j + kk < kWideP; j += 2 * kk) {
#pragma unroll 1
        for (int i = 0; i < kk && i + j + kk < kWideP; ++i) {
          if (((i + j) >> lg) == ((i + j + kk) >> lg)) {
            int32_t a = v[(i + j) * kWideThreads];
            int32_t b = v[(i + j + kk) * kWideThreads];
            order_keys(a, b);
            v[(i + j) * kWideThreads] = a;
            v[(i + j + kk) * kWideThreads] = b;
          }
        }
      }
    }
  }

  // the kept slots as floats at the front, in place (slot i is read before it is written), then the tree
  float* f = reinterpret_cast<float*>(v);
  int valid = n - 2 * trim;
  for (int i = 0; i < valid; ++i) f[i * kWideThreads] = key_float(v[(trim + i) * kWideThreads]);
  int len = pow2_ceil(valid);
  while (len > 1) {
    const int h = len >> 1;
    for (int i = 0; i < h; ++i) {
      const float hi = (i + h < valid) ? f[(i + h) * kWideThreads] : 0.f;
      f[i * kWideThreads] = __fadd_rn(f[i * kWideThreads], hi);
    }
    valid = h;
    len = h;
  }
  out[c] = lane_bad ? __int_as_float(kNaNBits) : __fmul_rn(f[0], inv_k);
}

template <int N>
cudaError_t launch_reg(const float* msgs, const int* nbr, int k, float inv_mix, float* out, int lanes,
                       int64_t q, int trim, float inv_k, bool vec, cudaStream_t s) {
  const int64_t per_block = static_cast<int64_t>(kRegThreads) * kCols;
  const dim3 grid(static_cast<unsigned>((q + per_block - 1) / per_block), static_cast<unsigned>(lanes));
  cwtm_reg_kernel<N><<<grid, kRegThreads, 0, s>>>(msgs, nbr, k, inv_mix, out, q, trim, inv_k, vec);
  return cudaGetLastError();
}

// Launches `kernel` over lanes x q columns, `threads` a block, with `smem`
// bytes of dynamic shared memory (its limit raised past the 48 KB default).
template <typename Kernel>
cudaError_t launch_columns(Kernel kernel, int threads, size_t smem, const float* msgs, const int* nbr, int k,
                           float inv_mix, float* out, int lanes, int n, int64_t q, int trim, float inv_k,
                           cudaStream_t s) {
  const int64_t total = static_cast<int64_t>(lanes) * q;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, s>>>(msgs, nbr, k, inv_mix, out, total, n, q, trim,
                                                               inv_k);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_net(const float* msgs, float* out, int lanes, int n, int64_t q, int trim, float inv_k,
                       cudaStream_t s) {
  const int64_t total = static_cast<int64_t>(lanes) * q;
  const int64_t blocks = (total + kNetThreads - 1) / kNetThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cwtm_net_kernel<P><<<static_cast<unsigned>(blocks), kNetThreads, 0, s>>>(msgs, out, total, n, q, trim, inv_k);
  return cudaGetLastError();
}

// The mix and the sort in one launch, `cols` columns and `threads` threads a block.
template <int P>
cudaError_t launch_mix_net(const float* msgs, const int* nbr, int k, float inv_mix, float* out, int lanes, int n,
                           int64_t q, int trim, float inv_k, int cols, int threads, cudaStream_t s) {
  const int64_t tiles = (q + cols - 1) / cols;
  if (tiles > INT_MAX / lanes) return cudaErrorInvalidValue;
  const int rows = (n + kMixStep - 1) / kMixStep * kMixStep;
  const size_t table = static_cast<size_t>(n) * k, mixed = static_cast<size_t>(n) * cols;
  const size_t smem = (static_cast<size_t>(rows) * (cols + kMixWords) + (table > mixed ? table : mixed)) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(cwtm_mix_net_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const bool vec = q % 4 == 0 && reinterpret_cast<uintptr_t>(msgs) % 16 == 0;
  cwtm_mix_net_kernel<P><<<static_cast<unsigned>(lanes * tiles), threads, smem, s>>>(
      msgs, nbr, k, inv_mix, out, n, q, cols, static_cast<int>(tiles), vec, trim, inv_k);
  return cudaGetLastError();
}

}  // namespace

// nbr: null (no mix) or the (lanes, n, k) int32 neighbour table, its rows
// strictly ascending; inv_mix = 1 / k. At 13 <= n <= 128 with a table,
// `mix_cols` / `mix_threads` are the mix's plan (kernels/cwtm.py::mix_plan);
// elsewhere they are not read.
extern "C" int repro_cwtm(const void* msgs, const void* nbr, int k, float inv_mix, void* out,
                          int lanes, int n, int64_t q, int trim, float inv_k, int mix_cols, int mix_threads,
                          void* stream) {
  if (lanes <= 0 || n <= 0 || n > kWideP || q <= 0 || trim < 0 || 2 * trim >= n ||
      (nbr != nullptr && (k <= 0 || k > n))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(msgs);
  const int* nb = static_cast<const int*>(nbr);
  float* o = static_cast<float*>(out);
  if (n <= kRegMaxN && n >= 2) {
    const bool vec = q % kCols == 0 && reinterpret_cast<uintptr_t>(msgs) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
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
  if (n > kNetMaxN) {
    const size_t smem = static_cast<size_t>(kWideP + (nb == nullptr ? 0 : n)) * kWideThreads * sizeof(float);
    return static_cast<int>(
        launch_columns(cwtm_wide_kernel, kWideThreads, smem, x, nb, k, inv_mix, o, lanes, n, q, trim, inv_k, s));
  }
  if (nb != nullptr && (mix_cols < 4 || mix_cols > kMixMaxCols || mix_cols % 4 != 0 || mix_threads < 32 ||
                        mix_threads > kMixMaxThreads || mix_threads % 32 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
#define REPRO_CWTM_NET(P)                                                                                   \
  err = nb == nullptr ? launch_net<P>(x, o, lanes, n, q, trim, inv_k, s)                                    \
                      : launch_mix_net<P>(x, nb, k, inv_mix, o, lanes, n, q, trim, inv_k, mix_cols, mix_threads, s)
  if (n <= 16) {
    REPRO_CWTM_NET(16);
  } else if (n <= 32) {
    REPRO_CWTM_NET(32);
  } else if (n <= 64) {
    REPRO_CWTM_NET(64);
  } else {
    REPRO_CWTM_NET(128);
  }
#undef REPRO_CWTM_NET
  return static_cast<int>(err);
}
