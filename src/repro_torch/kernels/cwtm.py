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
``nnm_mix_ref`` does, in the same pass: the server of CWTM-NNM reads the
stack once and writes (Q,) once, and the mixed stack is never stored.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import cwtm_ref, nnm_mix_ref

__all__ = ["launch", "plain", "network", "MAX_N"]

# with or without the mix: the shared-memory network's 256 slots, 64 threads
# x 256 keys x 4 bytes a block (64 KB), and with the mix 64 KB more for the
# originals
MAX_N = 256


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
