"""Fixed-order reductions.

``tree_sum`` adds along one axis as a fixed binary tree of elementwise adds
(zero-padded to a power of two; the zeros are exact no-ops). Elementwise
adds give the same bits whatever leading axes a tensor carries, so a lane
of a batched call equals the single call bitwise, and the order matches the
JAX reference's ``numerics.tree_sum`` term for term. ``tree_sum_`` is the
same tree computed in place in a temporary the caller owns, for stacks too
large to copy. ``nan_last`` makes every NaN positive, so that a sort puts it
last on either device.
"""
from __future__ import annotations

import torch

__all__ = ["tree_sum", "tree_sum_", "nan_last", "stable_norm", "stable_mean0", "stable_masked_mean0"]


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


def tree_sum_(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``tree_sum`` bit for bit, computed in place: ``v`` is overwritten
    and no copy of it is made. The first level adds the upper part onto the
    lower one and exact ``0.0`` to the terms that the padded tree pairs with
    a zero (so a ``-0.0`` term becomes ``+0.0`` there too); every later
    level is a power of two. Returns a new tensor, so the caller's
    temporary can be freed."""
    dim = dim % v.ndim
    n = v.shape[dim]
    while n > 1:
        h = 1 << (n - 1).bit_length() - 1  # half the next power of two >= n
        v.narrow(dim, 0, n - h).add_(v.narrow(dim, h, n - h))
        if 2 * h > n:
            v.narrow(dim, n - h, 2 * h - n).add_(0.0)
        n = h
    return v.narrow(dim, 0, 1).squeeze(dim).clone()


def nan_last(v: torch.Tensor) -> torch.Tensor:
    """``v`` with every NaN replaced by a positive NaN, for a sort that must
    put every NaN last, as ``jnp.sort`` and ``torch.sort`` on the CPU do:
    on a CUDA device ``torch.sort`` puts a NaN whose sign bit is set first
    on a long enough axis (ROADMAP C.14)."""
    return torch.where(torch.isnan(v), torch.nan, v)


def stable_norm(v: torch.Tensor) -> torch.Tensor:
    """L2 norm over the last axis with a fixed-tree accumulation."""
    v = v.to(torch.float32)
    return torch.sqrt(tree_sum(v * v, dim=-1))


def stable_mean0(m: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Mean over the device axis ``dim`` (axis 0 of an ``(N, Q)`` stack,
    ``-2`` of an ``(L, N, Q)`` one) with a fixed-tree accumulation."""
    return tree_sum(m.to(torch.float32), dim=dim) * (1.0 / m.shape[dim])


def stable_masked_mean0(m: torch.Tensor, mask: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Mean over the reporting rows of the device axis ``dim`` of ``m``,
    with a fixed-tree accumulation. ``mask`` is 0/1 over ``m``'s axes up to
    and including ``dim`` (``(N,)`` for an ``(N, Q)`` stack, ``(L, N)`` for
    ``(L, N, Q)`` at ``dim=-2``).

    Masked rows are exact ``0.0`` terms of the tree, and the divisor is the
    exact count ``tree_sum(mask)``. At an all-ones mask this is a true
    division ``tree_sum(m) / N``, not ``stable_mean0``'s multiply by
    ``1/N``: the two differ in the last bit where ``1/N`` is not dyadic.
    """
    dim = dim % m.ndim
    trailing = (1,) * (m.ndim - 1 - dim)
    m = m.to(torch.float32)
    w = mask.to(torch.float32)
    num = tree_sum(m * w.reshape(w.shape + trailing), dim=dim)
    den = torch.clamp_min(tree_sum(w, dim=-1), 1.0)
    return num / den.reshape(den.shape + trailing)
