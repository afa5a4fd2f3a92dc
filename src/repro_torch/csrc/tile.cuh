// A block's column tile of one lane of an (L, N, Q) fp32 stack, staged in
// shared memory: rows [0, N) x columns [c0, c0 + width), row stride `stride`
// floats in the tile. The encode (gather_combine.cu) and the attack
// (attack.cu) read the stack through it once; kernels/tiles.py picks the
// tile width.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace repro_tile {

// Walks the entries threadIdx.x, threadIdx.x + blockDim.x, ... of a
// rows x cols grid (row-major) as (row, col), with no division a step.
struct Cursor {
  int row, col, drow, dcol, cols;
  __device__ explicit Cursor(int cols_)
      : row(static_cast<int>(threadIdx.x) / cols_),
        col(static_cast<int>(threadIdx.x) % cols_),
        drow(static_cast<int>(blockDim.x) / cols_),
        dcol(static_cast<int>(blockDim.x) % cols_),
        cols(cols_) {}
  __device__ void next() {
    col += dcol;
    row += drow;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Issues the copies of the tile of `lane` (its (n, q) rows at `lane`); 16
// bytes a copy when `vec` (q, c0 and width multiples of 4, the stack
// 16-byte aligned), else 4. The caller waits (cp_async_wait_all) and syncs.
__device__ __forceinline__ void stage_tile(float* tile, int stride, const float* lane, int n, int64_t q,
                                           int64_t c0, int width, bool vec) {
  if (vec) {
    for (Cursor k(width / 4); k.row < n; k.next()) {
      cp_async16(tile + k.row * stride + 4 * k.col, lane + k.row * q + c0 + 4 * k.col);
    }
  } else {
    for (Cursor k(width); k.row < n; k.next()) {
      cp_async4(tile + k.row * stride + k.col, lane + k.row * q + c0 + k.col);
    }
  }
}

__host__ __device__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace repro_tile
