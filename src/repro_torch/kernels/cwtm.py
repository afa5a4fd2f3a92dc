"""Coordinate-wise trimmed mean on the card, optionally after the NNM mix:
``csrc/cwtm.cu``.

Replaces ``src/repro/kernels/cwtm.py::cwtm_pallas_lanes``. Each value
becomes an ordered 32-bit key, so the kernel sorts as ``jnp.sort`` and
``cwtm_ref`` do, every NaN last. Up to N = 12 a thread sorts 4 columns in
registers with an odd-even transposition network; from 13 to 128 a thread
holds one column's keys in registers and sorts them with Batcher's
odd-even merge network on ``pow2_ceil(N)`` slots (``network``), and from
129 to 256 the same network runs on 256 slots in shared memory. The kept values are summed as
the same fixed tree as the plain version, so kernel and ``plain`` agree
bitwise. Given a neighbour table it first mixes each coordinate's values as
``nnm_mix_ref`` does, in the same kernel: the mixed stack is never stored
(from 13 to 128 a block mixes a tile of columns into shared memory, then
sorts it; ``mix_plan`` deals the tiles to blocks and threads).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import tiles as _tiles
from repro_torch.kernels.ref import cwtm_ref, nnm_mix_ref

__all__ = ["launch", "plain", "network", "mix_plan", "MixPlan", "MAX_N"]

# with or without the mix: the shared-memory network's 256 slots, 64 threads
# x 256 keys x 4 bytes a block (64 KB), and with the mix 64 KB more for the
# originals
MAX_N = 256
REG_MAX_N = 12  # csrc/cwtm.cu's kRegMaxN: the register path, mix and sort in one pass
NET_MAX_N = 128  # kNetMaxN: past it the shared-memory network
MIX_ROWS = 4  # kMixRows: rows of a mix thread's item
MIX_STEP = 8  # kMixStep: staged rows are padded to a multiple of it
MIX_WORDS = 4  # kMixWords: 32-bit mask words a row (N <= 128)
MIX_MAX_COLS = 128  # kMixMaxCols
MIX_MAX_THREADS = 256  # kMixMaxThreads: each thread also holds the sort's registers
MIX_WAVE_THREADS = 128  # a block's threads where the blocks outnumber the SMs: two blocks an SM
MIX_FILL_COLS = 16  # the narrowest tile cut to fill the SMs at few lanes


class MixPlan(NamedTuple):
    """A launch of ``csrc/cwtm.cu``'s mix-and-sort kernel: a block a (lane,
    tile of ``cols`` columns), ``tiles`` tiles a lane, ``threads`` threads
    and ``smem`` bytes of shared memory a block."""

    cols: int
    tiles: int
    threads: int
    smem: int


def mix_plan(lanes: int, n: int, q: int, k: int | None = None) -> MixPlan:
    """The mix-and-sort kernel's launch for ``lanes`` lanes of (N, Q), 13 <=
    N <= 128, and tables of ``k`` ids a row (the default, N, bounds every
    table).

    A block stages its lane's (N, C) originals (rows padded to a multiple
    of ``MIX_STEP``), the row masks and its (N, k) table, which the mixed
    (N, C) tile then overwrites, in shared memory; a thread's item is
    ``MIX_ROWS`` rows x 4 columns of the mix, then a column of the sort.
    The lanes' tiles are cut to fill the SMs: C is Q over the tiles a lane
    needs for a block an SM, rounded up to a multiple of 4 (tiles start on
    16-byte boundaries), at least ``MIX_FILL_COLS`` and at most
    ``MIX_MAX_COLS`` (the paper's Q = 100: 7 tiles of 16 columns at 1 to 4
    lanes, one tile a lane from 132 lanes). A block has
    ``MIX_MAX_THREADS`` threads where its blocks fit on the SMs at once,
    else ``MIX_WAVE_THREADS``, and never fewer than its columns. Measured
    (``scripts/torch_mix_plans.py``, H100 at 700 W): 16 columns and 256
    threads were the fastest at 1 and 4 lanes (28 columns 1-5 % slower,
    128 threads 14-15 %), one tile and 128 threads at 1,000 lanes (256
    threads 15 % slower, 2 tiles 55 %)."""
    k = n if k is None else k
    if lanes < 1 or q < 1 or not REG_MAX_N < n <= NET_MAX_N or not 1 <= k <= n:
        raise ValueError(f"mix_plan: lanes={lanes}, n={n}, q={q}, k={k}")
    cols = -(-q // -(-_tiles.SMS // lanes))
    cols = min(MIX_MAX_COLS, max(MIX_FILL_COLS, cols + (-cols) % 4))
    tiles = -(-q // cols)
    threads = MIX_MAX_THREADS if lanes * tiles <= _tiles.SMS else max(MIX_WAVE_THREADS, -(-cols // 32) * 32)
    rows = -(-n // MIX_STEP) * MIX_STEP
    return MixPlan(cols, tiles, threads, 4 * (rows * (cols + MIX_WORDS) + max(n * k, n * cols)))


@functools.cache
def network(slots: int) -> tuple[tuple[int, int], ...]:
    """The compare-exchanges of Batcher's odd-even merge sort on ``slots``
    (a power of two), in the order ``csrc/cwtm.cu``'s
    ``odd_even_merge_sort`` runs them: after pair (a, b), slot a holds the
    smaller key. 1,471 pairs on 128 slots."""

    def merge(lo: int, hi: int, r: int):
        if 2 * r < hi - lo:
            yield from merge(lo, hi, 2 * r)
            yield from merge(lo + r, hi, 2 * r)
            yield from ((i, i + r) for i in range(lo + r, hi - r, 2 * r))
        else:
            yield lo, lo + r

    def sort(lo: int, hi: int):
        if hi - lo >= 1:
            mid = lo + (hi - lo) // 2
            yield from sort(lo, mid)
            yield from sort(mid + 1, hi)
            yield from merge(lo, hi, 1)

    return tuple(sort(0, slots - 1))


def plain(msgs: torch.Tensor, trim: int, neighbours: torch.Tensor | None = None) -> torch.Tensor:
    """``cwtm_ref``, after ``nnm_mix_ref`` when a neighbour table is given."""
    return cwtm_ref(msgs if neighbours is None else nnm_mix_ref(msgs, neighbours), trim)


def launch(msgs: torch.Tensor, trim: int, neighbours: torch.Tensor | None = None,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """msgs (L, N, Q) f32 contiguous on a CUDA device, neighbours None or
    (L, N, k) int32 with strictly ascending rows -> (L, Q), written into
    ``out`` when given; one launch."""
    lanes, n, q = msgs.shape
    out = torch.empty((lanes, q), dtype=msgs.dtype, device=msgs.device) if out is None else out
    k = 0 if neighbours is None else neighbours.shape[-1]
    plan = mix_plan(lanes, n, q, k) if k and REG_MAX_N < n <= NET_MAX_N else MixPlan(0, 0, 0, 0)
    err = _build.library("cwtm")(
        msgs.data_ptr(), None if neighbours is None else neighbours.data_ptr(), k,
        1.0 / k if k else 0.0, out.data_ptr(), lanes, n, q, trim, 1.0 / (n - 2 * trim), plan.cols, plan.threads,
        torch.cuda.current_stream(msgs.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"cwtm kernel launch failed: CUDA error {err}")
    return out
