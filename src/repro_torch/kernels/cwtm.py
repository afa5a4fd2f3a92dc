"""Coordinate-wise trimmed mean on the card: ``csrc/cwtm.cu``.

Replaces ``src/repro/kernels/cwtm.py::cwtm_pallas_lanes``. The kernel is
bound by bytes at small N and by its in-shared-memory sort at N near 100;
one thread sorts one coordinate's N values with the TPU kernel's odd-even
transposition network and sums the kept ones as the same fixed tree as the
plain version, so kernel and ``plain`` agree bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import cwtm_ref as plain

__all__ = ["launch", "plain", "MAX_N"]

# 128 threads x N x 4 bytes of shared memory per block: N = 256 takes 128 KB
MAX_N = 256


def launch(msgs: torch.Tensor, trim: int) -> torch.Tensor:
    """msgs (L, N, Q) f32 contiguous on a CUDA device -> (L, Q)."""
    lanes, n, q = msgs.shape
    out = torch.empty((lanes, q), dtype=msgs.dtype, device=msgs.device)
    inv_k = 1.0 / (n - 2 * trim)
    err = _build.library("cwtm")(
        msgs.data_ptr(), out.data_ptr(), lanes, n, q, trim, inv_k,
        torch.cuda.current_stream(msgs.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"cwtm kernel launch failed: CUDA error {err}")
    return out
