"""Eq.-(5) encode on the card: ``csrc/gather_combine.cu``.

Replaces ``src/repro/kernels/coded_combine.py::gather_combine_pallas_lanes``.
The kernel is bound by bytes (one read of the (L, N, Q) gradient stack, one
write of the coded stack); it runs one thread per (lane, device,
coordinate) and sums the d gathered rows in a fixed order without FMA
contraction, which is the plain version's arithmetic (see the source's
note). ``plain`` is the version the wrapper runs on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gather_combine_ref as plain

__all__ = ["launch", "plain"]


def launch(grads: torch.Tensor, subsets: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """grads (L, N, Q) f32, subsets (L, N, d) int32, weights (L, d) f32, all
    contiguous on one CUDA device -> (L, N, Q)."""
    lanes, n, q = grads.shape
    d = subsets.shape[-1]
    out = torch.empty_like(grads)
    err = _build.library("gather_combine")(
        grads.data_ptr(), subsets.data_ptr(), weights.data_ptr(), out.data_ptr(),
        lanes, n, d, q, torch.cuda.current_stream(grads.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"gather_combine kernel launch failed: CUDA error {err}")
    return out
