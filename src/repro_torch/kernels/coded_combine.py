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
    Bound by bytes; one thread per (lane, coordinate) adds its R products as
    the plain version's fixed tree, so the two agree bitwise.

``gather_plain``, ``masked_plain`` and ``coded_plain`` are the versions the
wrappers run on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, tiles
from repro_torch.kernels.ref import coded_combine_ref as coded_plain
from repro_torch.kernels.ref import gather_combine_ref as gather_plain
from repro_torch.kernels.ref import masked_combine_ref as masked_plain

__all__ = ["gather_launch", "gather_tile", "gather_plain", "rows_launch", "masked_plain", "coded_plain", "MAX_ROWS"]

MAX_ROWS = 256  # row_combine stages the R products of 128 columns in shared memory


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


def rows_launch(x: torch.Tensor, weights: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """x (L, R, Q) f32, weights (L, R) f32, contiguous on one CUDA device ->
    (L, Q), written into ``out`` when given."""
    lanes, r, q = x.shape
    out = torch.empty((lanes, q), dtype=x.dtype, device=x.device) if out is None else out
    err = _build.library("row_combine")(
        x.data_ptr(), weights.data_ptr(), out.data_ptr(), lanes, r, q,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"row_combine kernel launch failed: CUDA error {err}")
    return out
