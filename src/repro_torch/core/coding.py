"""The erasure reading of the cyclic code.

``cyclic_erasure_decode`` recovers the full-participation gradient mean from
the reports of a round with erased devices: the cyclic assignment at load
``d`` tolerates ``erasure_margin(d) = d - 1`` missing reports exactly, and
degrades gracefully beyond. Its surviving-row sum runs through the
``masked_combine`` kernel. DRACO's majority-vote decode comes with the
DRACO slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.numerics import tree_sum

__all__ = ["erasure_margin", "coded_weights", "cyclic_erasure_decode"]


def erasure_margin(d: int) -> int:
    """Erasures the cyclic code tolerates at load ``d``: every subset is in
    ``d`` consecutive windows, so any ``d - 1`` erasures leave at least one
    offset class whole (see ``cyclic_erasure_decode``)."""
    return d - 1


def coded_weights(d: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """The eq.-(5) encoding weights: ``1/d`` on each assigned subset."""
    return torch.full((d,), 1.0 / d, dtype=torch.float32, device=device)


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
      messages: ``(N, Q)`` transmitted vectors; erased rows are multiplied
        by exact 0.0.
      mask: ``(N,)`` 0/1 float participation mask.
      task_index: ``(N,)`` window starts of the round's assignment.
      d: the load (``N % d == 0`` for exactness).

    Returns:
      ``(Q,)`` the decoded gradient mean.
    """
    cls = task_index.long() % d
    onehot = cls[:, None] == torch.arange(d, device=cls.device)[None, :]
    mask = mask.to(torch.float32)
    class_report = tree_sum(torch.where(onehot, mask[:, None], 0.0), dim=0)  # (d,)
    j_star = torch.argmax(class_report)  # the first maximum
    w = mask * (cls == j_star).to(torch.float32)
    decoded = kernel_ops.masked_combine(messages, w)
    return decoded / torch.clamp_min(tree_sum(w, dim=0), 1.0)
