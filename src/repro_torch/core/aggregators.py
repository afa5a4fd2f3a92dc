"""kappa-robust aggregation rules (Definition 1): ``(..., N, Q) -> (..., Q)``.

Leading axes are lanes (independent scenarios of a grid). Every sum over
the device axis N or the coordinate axis Q is ``numerics.tree_sum``'s fixed
tree, so lane ``i`` of a batched call equals the single call bit for bit.
The sums run as one launch of the row-combine kernel (``_sum_rows``,
``_sum_last``), which adds its rows as that tree, rather than one launch per
level of the tree.

The reference's nine rules: ``mean`` (the VA baseline), ``median`` and
``cwtm`` (through the CWTM kernel), ``geomed`` (Weiszfeld), ``krum`` and
``multi_krum`` (their distances through the Gram kernel), ``mcc``
(maximum correntropy, started from ``median``), ``tgn`` (Com-TGN), and NNM
pre-aggregation (through the Gram kernel), composed as ``nnm_then(rule)``
or named with a ``-nnm`` suffix. CWTM-NNM is one launch of the CWTM kernel
with the neighbour table as an operand (``cwtm_nnm``): the mixed stack is
never stored.

Three places where the port does not copy the reference (ROADMAP C.1-C.3):

  * a median is the mean of the middle pair, as ``jnp.median`` takes it
    (``torch.median`` returns the lower middle value);
  * Krum excludes each message's distance to itself with a select to
    ``+inf`` (the reference adds ``eye * inf``, whose off-diagonal
    ``0 * inf`` makes every score NaN);
  * selections use a stable sort, so ties go to the lower index as
    ``jax.lax.top_k`` breaks them in the reference; ``torch.topk``
    promises no order.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.coded_combine import MAX_ROWS
from repro_torch.kernels.ref import nnm_mix_ref
from repro_torch.numerics import nan_last, tree_sum, tree_sum_

Aggregator = Callable[[torch.Tensor], torch.Tensor]

__all__ = ["mean", "coordinate_median", "cwtm", "geometric_median", "krum_scores", "krum",
           "multi_krum", "mcc", "tgn", "nnm_neighbours", "nnm_mix", "nnm_then", "cwtm_nnm",
           "make_aggregator", "AGGREGATORS", "kappa_bound"]


def _sum_rows(x: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """``sum_r w[..., r] * x[..., r, :]`` over the rows of x (..., R, C)
    (unit weights when ``w`` is None): ``tree_sum``'s tree of the products,
    as one ``masked_combine`` launch (its kernel adds them as that tree, bit
    for bit); past the kernel's ``MAX_ROWS`` rows, ``tree_sum`` itself."""
    if x.shape[-2] > MAX_ROWS:
        return tree_sum(x if w is None else x * w[..., None], dim=-2)
    return kernel_ops.masked_combine(x.contiguous(), x.new_ones(x.shape[:-1]) if w is None else w.contiguous())


def _sum_last(v: torch.Tensor) -> torch.Tensor:
    """``tree_sum(v, dim=-1)`` of v (..., K): the K terms of every entry
    moved to the rows of one (K, M) stack and summed by one ``_sum_rows``
    launch; past ``MAX_ROWS`` terms, the tree in place (``v`` is then
    overwritten: callers hand over temporaries)."""
    k = v.shape[-1]
    if k > MAX_ROWS:
        return tree_sum_(v, dim=-1)
    return _sum_rows(v.movedim(-1, 0).reshape(1, k, -1))[0].reshape(v.shape[:-1])


def mean(msgs: torch.Tensor) -> torch.Tensor:
    return _sum_rows(msgs) * (1.0 / msgs.shape[-2])


def coordinate_median(msgs: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over the device axis of (..., N, Q), the mean
    of the middle pair at even N: the CWTM kernel at trim ``(N - 1) // 2``
    keeps one or two values and takes ``(lo + hi) * 0.5``, ``jnp.median``'s
    arithmetic, bit for bit. Leading axes are lanes of one launch."""
    return kernel_ops.cwtm(msgs, (msgs.shape[-2] - 1) // 2)


def _vector_median(v: torch.Tensor) -> torch.Tensor:
    """Median along the last axis of (..., N): sort (every NaN last), then
    the mean of the middle pair."""
    n = v.shape[-1]
    srt = torch.sort(nan_last(v), dim=-1).values
    return (srt[..., (n - 1) // 2] + srt[..., n // 2]) * 0.5


def cwtm(msgs: torch.Tensor, trim_frac: float = 0.1, neighbours: torch.Tensor | None = None) -> torch.Tensor:
    """Coordinate-wise trimmed mean: drop the ``f = int(trim_frac * N)``
    largest and smallest values per coordinate, average the rest; after the
    NNM mix of ``neighbours`` (see ``nnm_neighbours``) when given."""
    n = msgs.shape[-2]
    f = int(trim_frac * n)
    if 2 * f >= n:
        raise ValueError(f"trim_frac={trim_frac} removes all {n} messages")
    return kernel_ops.cwtm(msgs, f, neighbours)


def geometric_median(msgs: torch.Tensor, iters: int = 8, eps: float = 1e-8) -> torch.Tensor:
    """Weiszfeld iterations for the geometric median, from the mean. Each
    step holds one (..., N, Q) temporary at a time."""
    z = mean(msgs)
    for _ in range(iters):
        dist = torch.sqrt(_sum_last((msgs - z[..., None, :]).square_()) + eps)  # (..., N)
        w = 1.0 / dist
        z = _sum_rows(msgs, w) / _sum_last(w)[..., None]
    return z


def _smallest(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` smallest entries along the last axis, ties to the
    lower index, every NaN last."""
    return torch.sort(nan_last(values), dim=-1, stable=True).indices[..., :k]


def _rows(msgs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The rows ``idx`` (..., k) of msgs (..., N, Q), in that order: (..., k, Q)."""
    return torch.gather(msgs, -2, idx[..., None].expand(idx.shape + msgs.shape[-1:]))


def _mean_of_rows(msgs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The mean of the rows ``idx`` (..., k), summed as a tree in ``idx``'s
    order."""
    return _sum_rows(_rows(msgs, idx)) * (1.0 / idx.shape[-1])


def tgn(msgs: torch.Tensor, thresh_frac: float = 0.2, n_byz: int = 0) -> torch.Tensor:
    """Thresholding on gradient norms [19] (Com-TGN): drop the ``f`` messages
    with the largest norms, average the rest."""
    n = msgs.shape[-2]
    f = min(max(int(thresh_frac * n), n_byz), n - 1)
    norms = _sum_last(msgs * msgs)
    return _mean_of_rows(msgs, _smallest(norms, n - f))


def krum_scores(msgs: torch.Tensor, n_byz: int) -> torch.Tensor:
    """Krum's scores (..., N): each message's summed squared distance to its
    ``max(N - b - 2, 1)`` nearest other messages, the distances from the
    Gram kernel and its own distance selected away as ``+inf``."""
    n = msgs.shape[-2]
    k = max(n - n_byz - 2, 1)
    d2 = kernel_ops.pairwise_sqdist(msgs)
    d2 = torch.where(torch.eye(n, dtype=torch.bool, device=d2.device), torch.inf, d2)
    return _sum_last(torch.sort(nan_last(d2), dim=-1).values[..., :k])


def krum(msgs: torch.Tensor, n_byz: int | None = None) -> torch.Tensor:
    """The message of least Krum score (the first such message on a tie);
    ``b = N // 4`` when ``n_byz`` is not given."""
    b = msgs.shape[-2] // 4 if n_byz is None else n_byz
    return _rows(msgs, torch.argmin(krum_scores(msgs, b), dim=-1, keepdim=True))[..., 0, :]


def multi_krum(msgs: torch.Tensor, n_byz: int | None = None, m: int | None = None) -> torch.Tensor:
    """The mean of the ``m`` messages of least Krum score (``m = N - b``;
    ties to the lower index)."""
    n = msgs.shape[-2]
    b = n // 4 if n_byz is None else n_byz
    m = n - b if m is None else m
    return _mean_of_rows(msgs, _smallest(krum_scores(msgs, b), m))


def mcc(msgs: torch.Tensor, sigma: float = 1.0, iters: int = 4) -> torch.Tensor:
    """Maximum-correntropy aggregation [9]: a mean reweighted by
    ``exp(-||g_i - z||^2 / (2 sigma^2 s))``, the bandwidth ``s`` the median
    of the squared distances, from the coordinate-wise median."""
    z = coordinate_median(msgs)
    for _ in range(iters):
        d2 = _sum_last((msgs - z[..., None, :]).square_())  # (..., N)
        s = _vector_median(d2)[..., None] + 1e-12
        w = torch.exp(-d2 / (2.0 * sigma**2 * s))
        z = _sum_rows(msgs, w) / (_sum_last(w)[..., None] + 1e-12)
    return z


def nnm_neighbours(d2: torch.Tensor, n_byz: int) -> torch.Tensor:
    """NNM's selection from the (..., N, N) squared distances: row n holds the
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
    "median": lambda **kw: coordinate_median,
    "cwtm": lambda trim_frac=0.1, **kw: partial(cwtm, trim_frac=trim_frac),
    "geomed": lambda iters=8, **kw: partial(geometric_median, iters=iters),
    "krum": lambda n_byz=None, **kw: partial(krum, n_byz=n_byz),
    "multi_krum": lambda n_byz=None, **kw: partial(multi_krum, n_byz=n_byz),
    "mcc": lambda sigma=1.0, **kw: partial(mcc, sigma=sigma),
    "tgn": lambda thresh_frac=0.2, n_byz=0, **kw: partial(
        tgn, thresh_frac=thresh_frac, n_byz=n_byz or 0),
}


def make_aggregator(name: str, *, nnm: bool = False, n_byz: int = 0, **kwargs) -> Aggregator:
    """An aggregator by name, optionally after NNM (``nnm=True`` or the
    ``-nnm`` suffix, e.g. ``"cwtm-nnm"``)."""
    if name.endswith("-nnm"):
        name, nnm = name[: -len("-nnm")], True
    if name not in AGGREGATORS:
        raise KeyError(f"unknown aggregator {name!r}; have {sorted(AGGREGATORS)}")
    if nnm and name == "cwtm":
        return partial(cwtm_nnm, n_byz=n_byz, trim_frac=kwargs.get("trim_frac", 0.1))
    base = AGGREGATORS[name](n_byz=n_byz, **kwargs)
    return nnm_then(base, n_byz=n_byz) if nnm else base


def kappa_bound(name: str, n: int, h: int, trim_frac: float = 0.1) -> float:
    """Known robustness coefficients kappa (Definition 1) from [23] Table 1,
    with ``b = N - H`` Byzantine devices: order-correct standard bounds for
    the theory plots, ``inf`` where the rule is not kappa-robust (``mean``).
    The reference's values, number for number."""
    b = n - h
    if b == 0:
        return 0.0
    frac = b / (n - 2 * b) if n > 2 * b else float("inf")
    if name == "mean":
        return float("inf")
    if name in ("median", "geomed"):
        return 4.0 * frac**2 * (1 + frac) ** 2 if frac != float("inf") else float("inf")
    if name == "cwtm":
        return frac * (1.0 + frac)
    if name in ("krum", "multi_krum"):
        return 6.0 * (1 + frac) ** 2 if frac != float("inf") else float("inf")
    if name.endswith("-nnm"):
        base = kappa_bound(name[: -len("-nnm")], n, h, trim_frac)
        # NNM composes to kappa = O(b/n) ([23] Thm 2): 8 b/h (1 + base)
        return 8.0 * b / h * (1.0 + base) if base != float("inf") else float("inf")
    if name == "mcc":
        return frac * (1.0 + frac)  # no published tight bound; a CWTM-like proxy
    if name == "tgn":
        return frac * (1.0 + frac)
    raise KeyError(name)
