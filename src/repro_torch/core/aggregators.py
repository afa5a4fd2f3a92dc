"""kappa-robust aggregation rules (Definition 1): ``(N, Q) -> (Q,)``.

Ported in this slice: ``mean`` (the VA baseline), ``cwtm`` (through the CWTM
kernel), ``tgn`` (Com-TGN) and NNM pre-aggregation (through the Gram
kernel), composed as ``nnm_then(rule)`` or named with a ``-nnm`` suffix.

Selections use a stable sort, so ties go to the lower index as
``jax.lax.top_k`` breaks them in the reference; ``torch.topk`` promises no
order.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from repro_torch.kernels import ops as kernel_ops

Aggregator = Callable[[torch.Tensor], torch.Tensor]

__all__ = ["mean", "cwtm", "tgn", "nnm_mix", "nnm_then", "make_aggregator", "AGGREGATORS"]

_NOT_PORTED = ("median", "geomed", "krum", "multi_krum", "mcc")


def mean(msgs: torch.Tensor) -> torch.Tensor:
    return torch.mean(msgs, dim=0)


def cwtm(msgs: torch.Tensor, trim_frac: float = 0.1) -> torch.Tensor:
    """Coordinate-wise trimmed mean: drop the ``f = int(trim_frac * N)``
    largest and smallest values per coordinate, average the rest."""
    n = msgs.shape[0]
    f = int(trim_frac * n)
    if 2 * f >= n:
        raise ValueError(f"trim_frac={trim_frac} removes all {n} messages")
    return kernel_ops.cwtm(msgs, f)


def _smallest(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` smallest entries along the last axis, ties to the
    lower index."""
    return torch.sort(values, dim=-1, stable=True).indices[..., :k]


def tgn(msgs: torch.Tensor, thresh_frac: float = 0.2, n_byz: int = 0) -> torch.Tensor:
    """Thresholding on gradient norms [19] (Com-TGN): drop the ``f`` messages
    with the largest norms, average the rest."""
    n = msgs.shape[0]
    f = min(max(int(thresh_frac * n), n_byz), n - 1)
    norms = torch.sum(msgs * msgs, dim=1)
    return torch.mean(msgs[_smallest(norms, n - f)], dim=0)


def nnm_mix(msgs: torch.Tensor, n_byz: int, d2: torch.Tensor | None = None) -> torch.Tensor:
    """Nearest-neighbour mixing [23]: each message becomes the average of its
    ``N - b`` nearest neighbours (itself included).

    The average is an (N, N) mixing matrix applied with one fp32 matrix
    product (TF32 off), so no (N, k, Q) stack of neighbour rows is built.
    """
    n = msgs.shape[0]
    k = n - n_byz
    if d2 is None:
        d2 = kernel_ops.pairwise_sqdist(msgs)
    idx = _smallest(d2, k)  # (N, k)
    mix = torch.zeros((n, n), dtype=msgs.dtype, device=msgs.device)
    mix.scatter_(1, idx, 1.0 / k)
    return torch.matmul(mix, msgs)


def nnm_then(rule: Aggregator, n_byz: int) -> Aggregator:
    """Compose NNM pre-aggregation with a base rule (e.g. CWTM-NNM)."""
    return lambda msgs: rule(nnm_mix(msgs, n_byz))


AGGREGATORS = {
    "mean": lambda **kw: mean,
    "cwtm": lambda trim_frac=0.1, **kw: partial(cwtm, trim_frac=trim_frac),
    "tgn": lambda thresh_frac=0.2, n_byz=0, **kw: partial(
        tgn, thresh_frac=thresh_frac, n_byz=n_byz or 0),
}


def make_aggregator(name: str, *, nnm: bool = False, n_byz: int = 0, **kwargs) -> Aggregator:
    """An aggregator by name, optionally after NNM (``nnm=True`` or the
    ``-nnm`` suffix, e.g. ``"cwtm-nnm"``)."""
    if name.endswith("-nnm"):
        name, nnm = name[: -len("-nnm")], True
    if name in _NOT_PORTED:
        raise NotImplementedError(f"aggregator {name!r} is not ported yet (ROADMAP A.2)")
    if name not in AGGREGATORS:
        raise KeyError(f"unknown aggregator {name!r}; have {sorted(AGGREGATORS)}")
    base = AGGREGATORS[name](n_byz=n_byz, **kwargs)
    return nnm_then(base, n_byz=n_byz) if nnm else base
