"""Gram matrix and row norms for NNM on the card: ``csrc/gram.cu``.

Replaces ``src/repro/kernels/nnm_dist.py::gram_pallas_lanes``. The TPU
kernel carries its (N, N) accumulator across a sequential grid of q tiles;
here nothing carries over between blocks and no atomics are used (the same
bits on every run). Up to N = 12 a thread keeps its columns and the
N (N + 1) / 2 sums in registers, each block sums a chunk of Q into scratch
and a second pass adds the chunks. Above, a block stages its lane's columns
in shared memory once, and where Q is one chunk the kernel writes the Gram
itself in one launch. From N = 13 to 128 a thread owns a 4 x 4 tile of
the upper triangle's pair sums; ``gram_plan`` picks the chunks, the panel,
the pairs a block and the segment slots, and the CPU tests check it. ``plain`` is the
version the wrapper runs on the CPU; it sums over Q as a fixed tree, the
kernel in chunk and segment order, so the two agree to fp32 rounding.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build, tiles
from repro_torch.kernels.ref import gram_ref as plain

__all__ = ["launch", "plain", "MAX_N", "REG_MAX_N", "TILE", "SEG", "GramPlan", "gram_plan", "gram_chunking",
           "tile_pairs", "tile_rows", "chunking", "tile_width"]

MAX_N = 128  # the tile path's largest N (32 row tiles)
REG_MAX_N = 12  # the register path of csrc/gram.cu
TILE = 4  # rows of a row tile: a thread owns TILE x TILE pair sums
SEG = 32  # columns of a segment: one FMA chain (csrc/gram.cu's kSeg)
_THREADS, _VEC = 256, 4
_MAX_CHUNKS = 1056  # 8 blocks for each of the H100's 132 SMs
_TILE_THREADS = 512  # the tile kernel's largest block
_SERIAL_BLOCK = 128  # tile pairs a block where a thread sums every segment: several blocks an SM
_ONE_CHUNK = 256  # up to this Q a lane is one chunk: one launch, no scratch
_PANEL = 128  # columns a block stages at a time where Q takes several chunks
_FILL_THREADS = tiles.SMS * 128  # below this many (lane, pair) threads the segments get threads of their own
_SPLIT_BLOCK = 128  # threads a block where the segments are split


def tile_width(n: int) -> int:
    """Columns a register-path block (N <= 12) takes in one step: 256
    threads x 4 columns x the column groups in flight (2 at N <= 8, else
    1)."""
    return _THREADS * _VEC * (2 if n <= 8 else 1)


def chunking(q: int, tile: int) -> tuple[int, int]:
    """(chunk_len, chunks) of the register path: at most 1056 chunks of
    whole tiles, a function of Q and the tile alone."""
    tiles_ = -(-q // tile)
    per_chunk = -(-tiles_ // min(tiles_, _MAX_CHUNKS))
    chunk_len = per_chunk * tile
    return chunk_len, -(-q // chunk_len)


def gram_chunking(n: int, q: int) -> tuple[int, int]:
    """(chunk_len, chunks) for a Q axis, a function of N and Q alone: it
    fixes the order of the sums over Q. On the tile path (N > 12) a lane is
    one chunk up to Q = 256 (its columns rounded up to whole 32-column
    segments); past that, chunks of a multiple of 128 columns (256 at the
    least), at most 1056 of them where Q allows."""
    if n <= REG_MAX_N:
        return chunking(q, tile_width(n))
    if q <= _ONE_CHUNK:
        return -(-q // SEG) * SEG, 1
    chunk_len = max(_ONE_CHUNK, -(-(-(-q // _MAX_CHUNKS)) // _PANEL) * _PANEL)
    return chunk_len, -(-q // chunk_len)


class GramPlan(NamedTuple):
    """A launch of ``csrc/gram.cu``: ``chunk_len`` x ``chunks`` cut Q;
    ``width`` columns staged at a time at a row stride of ``stride`` floats;
    ``pairs`` tile pairs a block and ``split`` segment slots (a thread a
    (pair, slot)). On the register path width is its step and stride,
    pairs and split are 1."""

    chunk_len: int
    chunks: int
    width: int
    stride: int
    pairs: int
    split: int
    pair_blocks: int
    threads: int
    smem: int


def tile_rows(n: int, a: int) -> list[int]:
    """The rows of row tile ``a``: a, a + K, a + 2K, a + 3K for K =
    ceil(N / 4) tiles (rows past N are zeros in the panel)."""
    count = -(-n // TILE)
    return [a + r * count for r in range(TILE)]


def tile_pairs(n: int) -> list[tuple[int, int]]:
    """The tile pairs (a, b), a <= b, in the kernel's order: row-major over
    the upper triangle of the tile grid; pair p is thread p's."""
    count = -(-n // TILE)
    return [(a, b) for a in range(count) for b in range(a, count)]


def _stride(width: int, q: int) -> int:
    """Row stride of the panel in floats: its columns rounded up to 4, then
    an odd number of float4s, so that 8 consecutive rows lie in 8 different
    bank groups."""
    cols = min(width, -(-q // 4) * 4)
    stride = -(-cols // 4) * 4
    return stride + 4 if (stride // 4) % 2 == 0 else stride


def gram_plan(lanes: int, n: int, q: int) -> GramPlan:
    """The launch of the Gram kernel for ``lanes`` lanes of (N, Q).

    The order over Q comes from ``gram_chunking`` (N and Q alone); the rest
    only maps work to threads. On the tile path: one chunk with several
    segments and fewer than 16,896 (lane, tile pair) threads (the paper's
    N = 100 at one lane) gives each segment a thread of its own (``split``)
    in blocks of about 128 threads; else a thread sums every segment of its
    pair, at most 128 pairs a block (N = 100: 3 blocks a lane, each staging
    the lane's panel, so that several blocks share an SM and one stages
    while another computes), and the pairs are cut into more blocks where
    fewer than 132 blocks would run (``scripts/torch_gram_row_plans.py``
    times the alternatives)."""
    if not 1 <= n <= MAX_N or q < 1 or lanes < 1:
        raise ValueError(f"gram_plan: lanes={lanes}, n={n}, q={q}")
    chunk_len, chunks = gram_chunking(n, q)
    if n <= REG_MAX_N:
        return GramPlan(chunk_len, chunks, tile_width(n), 1, 1, 1, 1, _THREADS, 0)
    all_pairs = len(tile_pairs(n))
    segs = chunk_len // SEG
    split = segs if chunks == 1 and segs > 1 and lanes * all_pairs < _FILL_THREADS else 1
    width = chunk_len if chunks == 1 else _PANEL
    if split > 1:
        pairs = min(all_pairs, -(-max(8, _SPLIT_BLOCK // split) // 8) * 8)
    else:
        pair_blocks = -(-all_pairs // _SERIAL_BLOCK)
        if lanes * chunks * pair_blocks < tiles.SMS:
            pair_blocks = max(pair_blocks, min(-(-all_pairs // 32), -(-tiles.SMS // (lanes * chunks))))
        pairs = min(all_pairs, -(-(-(-all_pairs // pair_blocks)) // 8) * 8)
    stride = _stride(width, q)
    rows = TILE * -(-n // TILE)
    slots = (split - 1) * TILE * TILE * pairs  # the segment slots' sums, after the panel is read
    return GramPlan(chunk_len, chunks, width, stride, pairs, split, -(-all_pairs // pairs),
                    -(-pairs * split // 32) * 32, 4 * max(rows * stride, slots))


def launch(msgs: torch.Tensor):
    """msgs (L, N, Q) f32 contiguous on a CUDA device -> (gram (L, N, N),
    row norms (L, N))."""
    lanes, n, q = msgs.shape
    plan = gram_plan(lanes, n, q)
    scratch = plan.chunks > 1 or n <= REG_MAX_N
    partial = torch.empty(lanes * plan.chunks * (n * (n + 1) // 2) if scratch else 0, dtype=torch.float32,
                          device=msgs.device)
    gram = torch.empty((lanes, n, n), dtype=torch.float32, device=msgs.device)
    sq = torch.empty((lanes, n), dtype=torch.float32, device=msgs.device)
    err = _build.library("gram")(
        msgs.data_ptr(), partial.data_ptr(), gram.data_ptr(), sq.data_ptr(), lanes, n, q, plan.chunk_len,
        plan.chunks, plan.width, plan.stride, plan.pairs, plan.split,
        torch.cuda.current_stream(msgs.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"gram kernel launch failed: CUDA error {err}")
    return gram, sq
