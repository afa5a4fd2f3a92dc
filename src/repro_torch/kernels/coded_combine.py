"""The combines of the coded round on the card.

  * ``csrc/gather_combine.cu``, the eq.-(5) encode: replaces
    ``src/repro/kernels/coded_combine.py::gather_combine_pallas_lanes``.
    Bound by bytes (one read of the (L, N, Q) gradient stack, one write of
    the coded stack). A block stages a lane's (N, C) column tile in shared
    memory once (``gather_tile`` picks C) and sums each output's d gathered
    rows from there in a fixed order without FMA contraction, which is the
    plain version's arithmetic (see the source's note); where not even a
    32-column tile fits, the large-N path gathers from device memory.
  * ``csrc/row_combine.cu``, ``out[l, q] = sum_r w[l, r] x[l, r, q]``:
    replaces both ``masked_combine_pallas_lanes`` (the erasure decode's
    surviving-class sum, R = N) and ``coded_combine_pallas_lanes`` (R = d).
    Bound by bytes. The R products stay in registers, dealt to G groups of
    threads (``row_plan`` picks G): each group runs the plain version's
    fixed tree's first levels on its rows, and the last log2 G levels cross
    the groups in the tree's order, so the two agree bitwise whatever G.

``gather_plain``, ``masked_plain`` and ``coded_plain`` are the versions the
wrappers run on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, tiles
from repro_torch.kernels.ref import coded_combine_ref as coded_plain
from repro_torch.kernels.ref import gather_combine_ref as gather_plain
from repro_torch.kernels.ref import masked_combine_ref as masked_plain

__all__ = ["gather_launch", "gather_tile", "gather_plain", "rows_launch", "row_plan", "row_aligned", "masked_plain",
           "coded_plain", "MAX_ROWS", "ROW_MAX_LOCAL", "ROW_MAX_GROUPS"]

MAX_ROWS = 256  # row_combine takes at most 16 groups of 16 rows
ROW_MAX_LOCAL = 16  # rows a row_combine thread holds in registers (csrc/row_combine.cu's kMaxLocal)
ROW_MAX_GROUPS = 16  # groups of a row_combine block (kMaxGroups)
_ROW_FILL = tiles.SMS * 256  # row_combine threads that fill the card
_ROW_LOCAL = 8  # rows a thread above 16 rows, where the groups allow
_ROW_VEC_ITEMS = tiles.SMS * 32  # (lane, 4-column) threads from which row_combine loads 16 bytes


def gather_tile(lanes: int, n: int, q: int, d: int) -> int:
    """The encode kernel's tile width C (``tiles.tile_width``): a block holds
    the (N, C) tile, the lane's (N, d) ids and the d weights in shared
    memory. 0 (the large-N path) where a 32-column tile does not fit."""
    return tiles.tile_width(lanes, q, 4 * n, 4 * (n * d + d), least=tiles.FILL_COLUMNS)


def gather_launch(grads: torch.Tensor, subsets: torch.Tensor, weights: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """grads (L, N, Q) f32, subsets (L, N, d) int32, weights (L, d) f32, all
    contiguous on one CUDA device -> (L, N, Q), written into ``out`` when
    given (contiguous, of the grads' shape)."""
    lanes, n, q = grads.shape
    d = subsets.shape[-1]
    out = torch.empty_like(grads) if out is None else out
    err = _build.library("gather_combine")(
        grads.data_ptr(), subsets.data_ptr(), weights.data_ptr(), out.data_ptr(),
        lanes, n, d, q, gather_tile(lanes, n, q, d), torch.cuda.current_stream(grads.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"gather_combine kernel launch failed: CUDA error {err}")
    return out


def row_plan(lanes: int, r: int, q: int, aligned: bool) -> tuple[int, int]:
    """(G, V) for ``csrc/row_combine.cu``: V columns a thread, 4 (16-byte
    loads) where the rows are ``aligned`` and the (lane, 4-column) threads
    number at least a warp for each of the 132 SMs, else 1 (at few lanes the
    columns spread over four times the threads); G, the groups of threads
    the R rows are dealt to (a power of two): 1 up to 16 rows (P <= 16, a
    thread holds its column's whole tree); above, the fewest that leave a
    thread at most 8 rows (P / 8; 16 at P = 256: 16 rows a thread), doubled
    up to 16 while the (lane, column) threads do not fill the card (132 SMs
    x 256 threads): the paper's N = Q = 100 takes 16 groups of 8 rows at 1
    and at 1,000 lanes. 8 rows of 16 bytes a thread stay under 64
    registers (16 take over 100, fewer threads an SM)."""
    if lanes < 1 or not 1 <= r <= MAX_ROWS or q < 1:
        raise ValueError(f"row_plan: lanes={lanes}, r={r}, q={q}")
    vec = 4 if aligned and q % 4 == 0 and lanes * (q // 4) >= _ROW_VEC_ITEMS else 1
    p = 1 << (r - 1).bit_length()
    if p <= ROW_MAX_LOCAL:
        return 1, vec
    groups = min(ROW_MAX_GROUPS, p // _ROW_LOCAL)
    items = lanes * -(-q // vec)
    while groups < min(p, ROW_MAX_GROUPS) and items * groups < _ROW_FILL:
        groups *= 2
    return groups, vec


def row_aligned(x: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether row_combine may load 16 bytes at once: Q a multiple of 4 and
    x and out 16-byte aligned."""
    return x.shape[-1] % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0


def rows_launch(x: torch.Tensor, weights: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """x (L, R, Q) f32, weights (L, R) f32, contiguous on one CUDA device ->
    (L, Q), written into ``out`` when given. One launch for any L."""
    lanes, r, q = x.shape
    out = torch.empty((lanes, q), dtype=x.dtype, device=x.device) if out is None else out
    groups, vec = row_plan(lanes, r, q, row_aligned(x, out))
    err = _build.library("row_combine")(
        x.data_ptr(), weights.data_ptr(), out.data_ptr(), lanes, r, q, groups, int(vec == 4),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"row_combine kernel launch failed: CUDA error {err}")
    return out
