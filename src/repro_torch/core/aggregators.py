"""kappa-robust aggregation rules (Definition 1): ``(N, Q) -> (Q,)``.

Ported in this slice: ``mean`` (the VA baseline), ``cwtm`` (through the CWTM
kernel), ``tgn`` (Com-TGN) and NNM pre-aggregation (through the Gram
kernel), composed as ``nnm_then(rule)`` or named with a ``-nnm`` suffix.
CWTM-NNM is one launch of the CWTM kernel with the neighbour table as an
operand (``cwtm_nnm``): the mixed stack is never stored.

Selections use a stable sort, so ties go to the lower index as
``jax.lax.top_k`` breaks them in the reference; ``torch.topk`` promises no
order.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import nnm_mix_ref

Aggregator = Callable[[torch.Tensor], torch.Tensor]

__all__ = ["mean", "cwtm", "tgn", "nnm_neighbours", "nnm_mix", "nnm_then", "cwtm_nnm",
           "make_aggregator", "AGGREGATORS"]

_NOT_PORTED = ("median", "geomed", "krum", "multi_krum", "mcc")


def mean(msgs: torch.Tensor) -> torch.Tensor:
    return torch.mean(msgs, dim=0)


def cwtm(msgs: torch.Tensor, trim_frac: float = 0.1, neighbours: torch.Tensor | None = None) -> torch.Tensor:
    """Coordinate-wise trimmed mean: drop the ``f = int(trim_frac * N)``
    largest and smallest values per coordinate, average the rest; after the
    NNM mix of ``neighbours`` (see ``nnm_neighbours``) when given."""
    n = msgs.shape[0]
    f = int(trim_frac * n)
    if 2 * f >= n:
        raise ValueError(f"trim_frac={trim_frac} removes all {n} messages")
    return kernel_ops.cwtm(msgs, f, neighbours)


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


def nnm_neighbours(d2: torch.Tensor, n_byz: int) -> torch.Tensor:
    """NNM's selection from the (N, N) squared distances: row n holds the
    ids of its ``N - b`` nearest neighbours (itself included, ties to the
    lower index), in ascending order, as int32. Built on ``d2``'s device;
    nothing is read back."""
    idx = _smallest(d2, d2.shape[-1] - n_byz)
    return torch.sort(idx, dim=-1).values.to(torch.int32)


def nnm_mix(msgs: torch.Tensor, n_byz: int, d2: torch.Tensor | None = None) -> torch.Tensor:
    """Nearest-neighbour mixing [23]: each message becomes the average of its
    ``N - b`` nearest neighbours (itself included), summed in ascending id
    order (``ref.nnm_mix_ref``), as the CWTM kernel mixes."""
    if d2 is None:
        d2 = kernel_ops.pairwise_sqdist(msgs)
    return nnm_mix_ref(msgs, nnm_neighbours(d2, n_byz))


def nnm_then(rule: Aggregator, n_byz: int) -> Aggregator:
    """Compose NNM pre-aggregation with a base rule (e.g. TGN-NNM)."""
    return lambda msgs: rule(nnm_mix(msgs, n_byz))


def cwtm_nnm(msgs: torch.Tensor, n_byz: int, trim_frac: float = 0.1) -> torch.Tensor:
    """``cwtm(nnm_mix(msgs))`` as two kernels: the Gram distances, then one
    CWTM launch that mixes as it reads."""
    return cwtm(msgs, trim_frac, nnm_neighbours(kernel_ops.pairwise_sqdist(msgs), n_byz))


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
    if nnm and name == "cwtm":
        return partial(cwtm_nnm, n_byz=n_byz, trim_frac=kwargs.get("trim_frac", 0.1))
    base = AGGREGATORS[name](n_byz=n_byz, **kwargs)
    return nnm_then(base, n_byz=n_byz) if nnm else base
