"""The cyclic task matrix of Section IV and the per-round task assignment.

Row ``i`` of the ``N x N`` cyclic matrix ``S_hat`` has ones in columns
``i, i+1, ..., i+d-1 (mod N)``. Each round draws two permutations: device
``i`` runs row ``task_index[i]``, and column ``k`` stands for data subset
``subset_perm[k]`` (Algorithm 1). DRACO's fractional repetition code
(``fractional_repetition``) takes one permutation instead. The draws come in
from outside (see ``byzantine.RoundRandomness``); this module only builds
from them. ``fractional_repetition_matrix``, ``column_counts``,
``is_column_balanced`` and ``assignment_deviation`` are Lemma 1's analysis
of a task matrix, in numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["cyclic_task_matrix", "fractional_repetition_matrix", "column_counts", "is_column_balanced",
           "assignment_deviation", "TaskAssignment", "assignment_from", "fractional_repetition",
           "sample_assignment"]


def cyclic_task_matrix(n: int, d: int) -> np.ndarray:
    """The paper's ``S_hat``: ``n x n`` cyclic 0/1 matrix, ``d`` ones per row."""
    if not (1 <= d <= n):
        raise ValueError(f"computational load d={d} must be in [1, {n}]")
    first = np.zeros(n, dtype=np.int32)
    first[:d] = 1
    return np.stack([np.roll(first, i) for i in range(n)], axis=0)


def fractional_repetition_matrix(n: int, d: int) -> np.ndarray:
    """DRACO's fractional repetition task matrix: ``n // d`` groups of ``d``
    devices, every device of group ``g`` computing the block of subsets
    ``[g*d, (g+1)*d)``. Needs ``d | n``. Column-balanced, so it attains the
    Lemma-1 infimum too."""
    if n % d != 0:
        raise ValueError(f"fractional repetition needs d | n, got n={n}, d={d}")
    s = np.zeros((n, n), dtype=np.int32)
    for i in range(n):
        g = i // d
        s[i, g * d: (g + 1) * d] = 1
    return s


def column_counts(s: np.ndarray) -> np.ndarray:
    return np.asarray(s).sum(axis=0)


def is_column_balanced(s: np.ndarray) -> bool:
    """True iff every column has the same number of ones (Lemma 1's optimum)."""
    counts = column_counts(s)
    return bool(np.all(counts == counts[0]))


def assignment_deviation(s: np.ndarray, h: int) -> float:
    """Lemma 1's ``E||(1/(dH)) h S - (1/N) 1||^2`` for a task matrix ``s``
    with ``d`` ones per row, from its column counts ``theta_j`` (the proof's
    eqs. 38-41); for the cyclic matrix it is ``(N-H)(N-d) / (d H (N-1) N)``."""
    s = np.asarray(s)
    n = s.shape[0]
    d = int(s[0].sum())
    theta = column_counts(s).astype(np.float64)
    # eqs. (40)-(41): 1/(d^2 H^2) [H d + H(H-1)/(N(N-1)) (sum theta_j^2 - d N)] - 1/N
    cross = float((theta**2).sum() - d * n)
    val = (h * d + h * (h - 1) / (n * (n - 1)) * cross) / (d**2 * h**2) - 1.0 / n
    return float(val)


@dataclasses.dataclass(frozen=True)
class TaskAssignment:
    """One round's assignment.

    Attributes:
      task_index: ``(..., N)`` int64, ``T_i^t``: device ``i`` runs that row.
      subset_perm: ``(..., N)`` int64, ``p^t``: column ``k`` is subset ``p[k]``.
      subsets: ``(..., N, d)`` int64, the subset ids device ``i`` computes,
        ``p[(T_i + j) mod N]`` for ``j < d``.

    Leading axes are independent lanes (scenarios of a grid).
    """

    task_index: torch.Tensor
    subset_perm: torch.Tensor
    subsets: torch.Tensor


def assignment_from(task_index: torch.Tensor, subset_perm: torch.Tensor, d: int) -> TaskAssignment:
    """The assignment that the two permutations of a round define, ``(...,
    N)`` draws of any leading lane axes."""
    n = task_index.shape[-1]
    ti = task_index.long()
    perm = subset_perm.long()
    cols = (ti[..., None] + torch.arange(d, device=ti.device)) % n  # (..., N, d)
    subsets = torch.gather(perm, -1, cols.flatten(-2)).reshape(cols.shape)
    return TaskAssignment(task_index=ti, subset_perm=perm, subsets=subsets)


def fractional_repetition(subset_perm: torch.Tensor, d: int) -> TaskAssignment:
    """DRACO's assignment: device ``i`` belongs to group ``g = i // d`` and
    computes the subsets ``perm[g*d : g*d + d]``, the same block as every
    other member of its group. ``task_index`` holds each device's group.
    ``subset_perm`` is ``(..., N)``, any leading lane axes. Needs ``d | N``."""
    n = subset_perm.shape[-1]
    if n % d != 0:
        raise ValueError(f"DRACO's fractional repetition needs d | N: N={n} d={d}")
    perm = subset_perm.long()
    groups = torch.arange(n, device=perm.device) // d
    cols = groups[:, None] * d + torch.arange(d, device=perm.device)[None, :]
    return TaskAssignment(task_index=groups.expand(perm.shape), subset_perm=perm, subsets=perm[..., cols])


def sample_assignment(generator: torch.Generator, n: int, d: int) -> TaskAssignment:
    """Draw both permutations from ``generator`` (uniform and independent,
    as in Algorithm 1) on the generator's device."""
    task_index = torch.randperm(n, generator=generator, device=generator.device)
    subset_perm = torch.randperm(n, generator=generator, device=generator.device)
    return assignment_from(task_index, subset_perm, d)
