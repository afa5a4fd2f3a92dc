"""Gram matrix and row norms for NNM on the card: ``csrc/gram.cu``.

Replaces ``src/repro/kernels/nnm_dist.py::gram_pallas_lanes``. The TPU
kernel carries its (N, N) accumulator across a sequential grid of q tiles;
here each block sums one chunk of Q into the upper triangle of a partial
Gram in scratch and a second pass adds the partials in a fixed order (no
atomics, the same bits on every run). Bound by bytes at small N: up to
N = 12 a thread keeps its columns and the N (N + 1) / 2 sums in registers,
with no shared-memory staging. ``plain`` is the version the wrapper runs on
the CPU; it sums over Q as a fixed tree, the kernel in chunk order, so the
two agree to fp32 rounding.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gram_ref as plain

__all__ = ["launch", "plain", "MAX_N", "REG_MAX_N", "chunking", "tile_width"]

MAX_N = 128  # 256 threads x 64 register accumulators cover N * N pairs
REG_MAX_N = 12  # the register path of csrc/gram.cu
_THREADS, _VEC = 256, 4
_MAX_CHUNKS = 1056  # 8 blocks for each of the H100's 132 SMs


def tile_width(n: int) -> int:
    """Columns a block takes in one step: on the register path (N <= 12)
    256 threads x 4 columns x the column groups in flight (2 at N <= 8,
    else 1); on the shared-memory path a 64-column tile (N = 128 then takes
    33 KB)."""
    if n <= REG_MAX_N:
        return _THREADS * _VEC * (2 if n <= 8 else 1)
    return 64


def chunking(q: int, tile: int) -> tuple[int, int]:
    """(chunk_len, chunks) for a Q axis: at most 1056 chunks of whole
    tiles, a function of Q and the tile alone."""
    tiles = -(-q // tile)
    per_chunk = -(-tiles // min(tiles, _MAX_CHUNKS))
    chunk_len = per_chunk * tile
    return chunk_len, -(-q // chunk_len)


def launch(msgs: torch.Tensor):
    """msgs (L, N, Q) f32 contiguous on a CUDA device -> (gram (L, N, N),
    row norms (L, N))."""
    lanes, n, q = msgs.shape
    tile = tile_width(n)
    chunk_len, chunks = chunking(q, tile)
    partial = torch.empty(lanes * chunks * (n * (n + 1) // 2), dtype=torch.float32, device=msgs.device)
    gram = torch.empty((lanes, n, n), dtype=torch.float32, device=msgs.device)
    sq = torch.empty((lanes, n), dtype=torch.float32, device=msgs.device)
    err = _build.library("gram")(
        msgs.data_ptr(), partial.data_ptr(), gram.data_ptr(), sq.data_ptr(),
        lanes, n, q, chunk_len, chunks, tile, torch.cuda.current_stream(msgs.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"gram kernel launch failed: CUDA error {err}")
    return gram, sq
