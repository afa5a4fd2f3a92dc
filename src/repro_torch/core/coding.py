"""The round's codes: eq. (5)'s encode and the decoders.

``encode_coded_gradient`` is eq. (5) on one device's pytree of stacked
subset gradients (the round's lane-batched encode is the gather-combine
kernel, ``kernels/ops.py::gather_combine``).

``cyclic_erasure_decode`` recovers the full-participation gradient mean from
the reports of a round with erased devices: the cyclic assignment at load
``d`` tolerates ``erasure_margin(d) = d - 1`` missing reports exactly, and
degrades gracefully beyond. Its surviving-row sum runs through the
``masked_combine`` kernel. ``draco_decode`` is DRACO's majority vote over
the groups of the fractional repetition code: every group's median in one
lane-batched launch of the CWTM kernel. ``flatten_pytree`` lays a model's
parameter tree out as the one flat vector that the protocol round works on,
in the reference's leaf order.
"""
from __future__ import annotations

import math

import torch

from repro_torch import pytree
from repro_torch.core.aggregators import coordinate_median
from repro_torch.kernels import ops as kernel_ops
from repro_torch.numerics import nan_last, stable_mean0, tree_sum

__all__ = ["encode_coded_gradient", "erasure_margin", "coded_weights", "cyclic_erasure_decode", "draco_decode", "flatten_pytree",
           "unflatten_pytree", "tree_spec"]


def erasure_margin(d: int) -> int:
    """Erasures the cyclic code tolerates at load ``d``: every subset is in
    ``d`` consecutive windows, so any ``d - 1`` erasures leave at least one
    offset class whole (see ``cyclic_erasure_decode``)."""
    return d - 1


def coded_weights(d: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """The eq.-(5) encoding weights: ``1/d`` on each assigned subset."""
    return torch.full((d,), 1.0 / d, dtype=torch.float32, device=device)


def encode_coded_gradient(subset_grads):
    """eq. (5): ``g_i = (1/d) sum_k grad_k``, each leaf of the pytree
    ``subset_grads`` averaged over its leading axis of size ``d`` (the
    stacked gradients of the ``d`` subsets one device computed)."""
    return pytree.map_tree(lambda g: torch.mean(g, dim=0), subset_grads)


def cyclic_erasure_decode(messages: torch.Tensor, mask: torch.Tensor,
                          task_index: torch.Tensor, d: int) -> torch.Tensor:
    """K-of-N erasure decode of the cyclic (eq.-5) code.

    Device ``i`` holds the window of ``d`` consecutive subsets starting at
    ``task_index[i]`` (a permutation of ``0..N-1``). The devices fall into
    ``d`` offset classes by ``task_index % d``; when ``d | N`` each class's
    ``N/d`` windows are disjoint and tile the circle. ``e <= d - 1``
    erasures touch at most ``e`` classes, so one class survives whole: the
    sum of its coded vectors is ``(1/d) sum_k g_k``, and divided by the
    class size it is the full-participation mean ``(1/N) sum_k g_k``.
    Beyond the margin the best-covered class is still chosen (the first
    such class on a tie, as the reference's ``argmax``), and the decode is
    the mean over the subsets its surviving windows cover.

    Args:
      messages: ``(..., N, Q)`` transmitted vectors; erased rows are
        multiplied by exact 0.0. Leading axes are lanes.
      mask: ``(..., N)`` 0/1 float participation mask.
      task_index: ``(..., N)`` window starts of the round's assignment.
      d: the load (``N % d == 0`` for exactness).

    Returns:
      ``(..., Q)`` the decoded gradient mean.
    """
    cls = task_index.long() % d
    onehot = cls[..., None] == torch.arange(d, device=cls.device)
    mask = mask.to(torch.float32)
    class_report = tree_sum(torch.where(onehot, mask[..., None], 0.0), dim=-2)  # (..., d)
    j_star = torch.argmax(class_report, dim=-1, keepdim=True)  # the first maximum
    w = mask * (cls == j_star).to(torch.float32)
    decoded = kernel_ops.masked_combine(messages, w)
    return decoded / torch.clamp_min(tree_sum(w, dim=-1), 1.0)[..., None]


def draco_decode(messages: torch.Tensor, group_size: int, mask: torch.Tensor | None = None) -> torch.Tensor:
    """DRACO's majority-vote decode of the fractional repetition code.

    The ``N`` devices form ``N / d`` groups of ``d`` consecutive devices; the
    honest members of a group send the same vector, the mean of the group's
    ``d`` subsets. Each group's coordinate-wise median recovers it while the
    group has an honest majority, and the mean over groups is the mean over
    all ``N`` subsets.

    Unmasked, the group medians are one launch of the CWTM kernel with the
    groups of every lane as its lanes (``N = d``, trim ``(d - 1) // 2``: the middle value, or
    the mean of the middle pair at even ``d``), then a fixed-tree mean.

    With ``mask`` (``(..., N)`` 0/1, 1 = the device reported) a group's median
    runs over its reporting members: erased rows are pushed to ``+inf``,
    sorted last (before every NaN, as ``jnp.sort`` puts them), and the median is the mean of the positions ``(k - 1) // 2``
    and ``k // 2`` of the ``k`` reporting values. A full group takes the
    kernel's median, a group with no reporting member is left out (with a
    select: its median is ``inf``), and the decode is the mean over the
    surviving groups. When every group is full the result is the unmasked
    decode, bit for bit.

    Args:
      messages: ``(..., N, Q)`` transmitted vectors (erased rows already
        0.0). Leading axes are lanes.
      group_size: ``d``, devices per group; ``N % d == 0``.
      mask: optional ``(..., N)`` participation mask.

    Returns:
      ``(..., Q)`` the decoded gradient mean.
    """
    *lead, n, q = messages.shape
    lead = tuple(lead)
    if n % group_size != 0:
        raise ValueError(f"N={n} not divisible by group size d={group_size}")
    n_groups = n // group_size
    grouped = messages.reshape(lead + (n_groups, group_size, q))
    full_med = coordinate_median(grouped)  # (..., groups, Q)
    legacy = stable_mean0(full_med, dim=-2)
    if mask is None:
        return legacy
    gmask = mask.to(torch.float32).reshape(lead + (n_groups, group_size))
    k = tree_sum(gmask, dim=-1)  # reporting members per group
    ordered = torch.sort(torch.where(gmask[..., None] > 0.0, nan_last(grouped), torch.inf), dim=-2).values
    ki = torch.clamp_min(k.to(torch.int64), 1)[..., None, None].expand(lead + (n_groups, 1, q))
    lo = torch.gather(ordered, -2, (ki - 1) // 2)
    hi = torch.gather(ordered, -2, ki // 2)
    masked_med = (0.5 * (lo + hi))[..., 0, :]
    group_full = k == float(group_size)
    block_vals = torch.where(group_full[..., None], full_med, masked_med)
    alive = (k > 0.0).to(torch.float32)
    degraded = tree_sum(torch.where(alive[..., None] > 0.0, block_vals, 0.0), dim=-2) / torch.clamp_min(
        tree_sum(alive, dim=-1), 1.0)[..., None]
    all_full = tree_sum(group_full.to(torch.float32), dim=-1) == float(n_groups)
    return torch.where(all_full[..., None], legacy, degraded)


def flatten_pytree(tree) -> tuple[torch.Tensor, tuple]:
    """A tree of tensors as one 1-D vector, the leaves concatenated in
    ``jax.tree.flatten``'s order (dict keys sorted, see ``pytree``), and the
    spec ``(skeleton, shapes)`` that ``unflatten_pytree`` takes. The vector is
    the reference's ``flatten_pytree`` of the same tree, element for
    element."""
    leaves = pytree.leaves(tree)
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves]) if leaves else torch.zeros((0,))
    return flat, tree_spec(tree)


def tree_spec(tree) -> tuple:
    """``flatten_pytree``'s spec of ``tree``, without building the vector."""
    return pytree.map_tree(lambda leaf: None, tree), [tuple(leaf.shape) for leaf in pytree.leaves(tree)]


def unflatten_pytree(flat: torch.Tensor, spec: tuple):
    """The tree of ``spec`` over ``flat``: each leaf a view of its slice of
    the last axis, nothing copied. ``flat`` may carry leading axes (an
    ``(N, P)`` stack of flat vectors gives leaves of shape ``(N, *shape)``)."""
    skeleton, shapes = spec
    lead = tuple(flat.shape[:-1])
    if flat.shape[-1] != sum(math.prod(s) for s in shapes):
        raise ValueError(f"flat vector of {flat.shape[-1]} elements for a tree of "
                         f"{sum(math.prod(s) for s in shapes)}")
    views, idx = [], 0
    for shape in shapes:
        size = math.prod(shape)
        views.append(flat[..., idx:idx + size].view(lead + shape))
        idx += size
    return pytree.from_leaves(skeleton, views)
