"""Fixed-order reductions.

``tree_sum`` adds along one axis as a fixed binary tree of elementwise adds
(zero-padded to a power of two; the zeros are exact no-ops). Elementwise
adds give the same bits whatever leading axes a tensor carries, so a lane
of a batched call equals the single call bitwise, and the order matches the
JAX reference's ``numerics.tree_sum`` term for term.
"""
from __future__ import annotations

import torch

__all__ = ["tree_sum", "stable_norm", "stable_mean0", "stable_masked_mean0"]


def _pad_pow2(v: torch.Tensor, dim: int) -> torch.Tensor:
    n = v.shape[dim]
    p = 1 << max(0, n - 1).bit_length()  # next power of two >= n
    if p == n:
        return v
    shape = list(v.shape)
    shape[dim] = p - n
    return torch.cat([v, v.new_zeros(shape)], dim=dim)


def tree_sum(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum along ``dim`` as a fixed binary tree: at each level the lower
    half is added to the upper half, element by element."""
    dim = dim % v.ndim
    v = _pad_pow2(v, dim)
    while v.shape[dim] > 1:
        h = v.shape[dim] // 2
        v = v.narrow(dim, 0, h) + v.narrow(dim, h, h)
    return v.squeeze(dim)


def stable_norm(v: torch.Tensor) -> torch.Tensor:
    """L2 norm over the last axis with a fixed-tree accumulation."""
    v = v.to(torch.float32)
    return torch.sqrt(tree_sum(v * v, dim=-1))


def stable_mean0(m: torch.Tensor) -> torch.Tensor:
    """Mean over axis 0 (the device axis) with a fixed-tree accumulation."""
    return tree_sum(m.to(torch.float32), dim=0) * (1.0 / m.shape[0])


def stable_masked_mean0(m: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the reporting rows of axis 0 (``mask`` is ``(N,)`` 0/1)
    with a fixed-tree accumulation.

    Masked rows are exact ``0.0`` terms of the tree, and the divisor is the
    exact count ``tree_sum(mask)``. At an all-ones mask this is a true
    division ``tree_sum(m) / N``, not ``stable_mean0``'s multiply by
    ``1/N``: the two differ in the last bit where ``1/N`` is not dyadic.
    """
    m = m.to(torch.float32)
    w = mask.to(torch.float32)
    num = tree_sum(m * w[:, None] if m.ndim == 2 else m * w, dim=0)
    return num / torch.clamp_min(tree_sum(w, dim=0), 1.0)
