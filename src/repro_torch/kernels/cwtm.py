"""Coordinate-wise trimmed mean on the card, optionally after the NNM mix:
``csrc/cwtm.cu``.

Replaces ``src/repro/kernels/cwtm.py::cwtm_pallas_lanes``. The kernel is
bound by bytes at small N and by its in-shared-memory sort at N near 100;
it sorts each coordinate's N values with the TPU kernel's odd-even
transposition network and sums the kept ones as the same fixed tree as the
plain version, so kernel and ``plain`` agree bitwise. Given a neighbour
table it first mixes each coordinate's values as ``nnm_mix_ref`` does, in
the same pass: the server of CWTM-NNM reads the stack once and writes (Q,)
once, and the mixed stack is never stored.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import cwtm_ref, nnm_mix_ref

__all__ = ["launch", "plain", "MAX_N", "MAX_N_MIXED"]

# 128 threads x N x 4 bytes of shared memory per block: N = 256 takes 128 KB;
# the mix doubles it, and a block has at most 227 KB
MAX_N = 256
MAX_N_MIXED = 227


def plain(msgs: torch.Tensor, trim: int, neighbours: torch.Tensor | None = None) -> torch.Tensor:
    """``cwtm_ref``, after ``nnm_mix_ref`` when a neighbour table is given."""
    return cwtm_ref(msgs if neighbours is None else nnm_mix_ref(msgs, neighbours), trim)


def launch(msgs: torch.Tensor, trim: int, neighbours: torch.Tensor | None = None,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """msgs (L, N, Q) f32 contiguous on a CUDA device, neighbours None or
    (L, N, k) int32 with strictly ascending rows -> (L, Q), written into
    ``out`` when given."""
    lanes, n, q = msgs.shape
    out = torch.empty((lanes, q), dtype=msgs.dtype, device=msgs.device) if out is None else out
    k = 0 if neighbours is None else neighbours.shape[-1]
    err = _build.library("cwtm")(
        msgs.data_ptr(), None if neighbours is None else neighbours.data_ptr(), k,
        1.0 / k if k else 0.0, out.data_ptr(), lanes, n, q, trim, 1.0 / (n - 2 * trim),
        torch.cuda.current_stream(msgs.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"cwtm kernel launch failed: CUDA error {err}")
    return out
