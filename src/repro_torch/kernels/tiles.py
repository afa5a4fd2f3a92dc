"""Column tiles of a lane's (N, Q) stack, staged in a block's shared memory.

The encode (``csrc/gather_combine.cu``) and the attack's ALIE and IPM
(``csrc/attack.cu``) give a block one lane and a tile of C consecutive
columns over all N rows: the block copies that (N, C) tile of the stack
into shared memory once and computes from there. ``tile_width`` picks C
from the lane count, Q and the shared-memory bytes a column and a block
take; the kernels take C as an argument (``csrc/tile.cuh``), so the plan is
tested on the CPU. Tile t covers columns ``[t C, min((t + 1) C, Q))``.
"""
from __future__ import annotations

__all__ = ["tile_width", "SMEM_MAX", "TILE_BYTES", "SMS", "FILL_COLUMNS"]

SMEM_MAX = 232_448  # bytes of shared memory a Hopper block may use (227 KB)
TILE_BYTES = 48 * 1024  # the shared memory a block aims at: four blocks an SM
SMS = 132  # the H100's streaming multiprocessors
FILL_COLUMNS = 32  # the narrowest tile cut to fill the SMs: a 128-byte row segment


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def tile_width(lanes: int, q: int, column_bytes: int, fixed_bytes: int, least: int) -> int:
    """Columns C of a tile, or 0 when ``least`` columns do not fit.

    A tile of C columns takes ``C * column_bytes + fixed_bytes`` of shared
    memory, at most ``SMEM_MAX``. Whole rows (C = Q: the lane's stack is one
    contiguous run) where they fit in ``TILE_BYTES``; else the fewest tiles
    of at most ``TILE_BYTES`` (at least ``least`` columns), balanced and
    rounded up to a multiple of 4 columns (16-byte rows). Where that gives
    fewer than ``SMS`` blocks and Q holds two ``FILL_COLUMNS`` tiles, C is
    cut to ``Q // ceil(SMS / lanes)`` rounded down to a multiple of 4, and
    to ``FILL_COLUMNS`` at the least, so that every SM gets a block where Q
    allows."""
    if lanes < 1 or q < 1 or column_bytes < 1 or least < 1:
        raise ValueError(f"tile_width: lanes={lanes}, q={q}, column_bytes={column_bytes}, least={least}")
    fit = (SMEM_MAX - fixed_bytes) // column_bytes
    if fit < least:
        return 0
    cap = min(fit, max(least, 4, (TILE_BYTES - fixed_bytes) // column_bytes))
    if cap >= 4:
        cap -= cap % 4
    tiles = _ceil_div(q, cap)
    if lanes * tiles < SMS and q >= 2 * FILL_COLUMNS:
        return min(cap, max(FILL_COLUMNS, q // _ceil_div(SMS, lanes) // 4 * 4))
    if tiles == 1:
        return q
    cols = _ceil_div(q, tiles)
    return cols + (-cols) % 4 if cap % 4 == 0 else cols
