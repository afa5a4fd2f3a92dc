"""Plain PyTorch versions of the kernels of the protocol round.

They compute what the CUDA kernels compute, on any device, and are what a
wrapper in ``kernels/ops.py`` runs for a tensor on the CPU. Every function
takes extra leading lane axes. Sums over the device axis and over Q are
fixed binary trees of elementwise adds (``numerics.tree_sum``), so a lane
of a batched call equals the single call bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.numerics import nan_last, tree_sum

__all__ = [
    "gather_combine_ref",
    "attack_ref",
    "cwtm_ref",
    "nnm_mix_ref",
    "gram_ref",
    "sqdist_from_gram",
    "pairwise_sqdist_ref",
    "stochastic_quantize_ref",
    "masked_combine_ref",
    "coded_combine_ref",
]


def gather_combine_ref(
    grads: torch.Tensor, subsets: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """eq.-(5) encode. grads: (..., N, Q), subsets: (..., N, d) ids,
    weights: (d,) or (..., d) -> (..., N, Q).

    ``sum_j w_j * grads[subsets[:, j]]`` in the order j = 0, 1, ...: one
    gathered (..., N, Q) row block at a time, never an (..., N, d, Q) stack.
    """
    d = subsets.shape[-1]
    w = weights.to(torch.float32).expand(subsets.shape[:-2] + (d,))
    idx = subsets.long()
    out = None
    for j in range(d):
        rows_j = idx[..., j, None].expand(idx.shape[:-1] + grads.shape[-1:])
        term = w[..., j, None, None] * torch.gather(grads, -2, rows_j)
        out = term if out is None else out + term
    return out


def _honest_stats(msgs: torch.Tensor, mask: torch.Tensor):
    """(..., N, Q) msgs + (..., N) mask -> honest weights, count and mean."""
    honest_w = (1.0 - mask)[..., :, None]
    h = torch.clamp_min(tree_sum(1.0 - mask, dim=-1), 1.0)[..., None]
    mu = tree_sum(msgs * honest_w, dim=-2) / h
    return honest_w, h, mu


def attack_ref(msgs: torch.Tensor, mask: torch.Tensor, name: str, param: float) -> torch.Tensor:
    """Byzantine rows of msgs (..., N, Q) under mask (..., N) become the
    attack's vector: ``param * m`` (sign_flip), ``mu - param * sqrt(var +
    1e-12)`` (alie) or ``-param * mu`` (ipm)."""
    byz = mask[..., :, None] > 0
    if name == "sign_flip":
        return torch.where(byz, param * msgs, msgs)
    if name == "alie":
        honest_w, h, mu = _honest_stats(msgs, mask)
        dev = msgs - mu[..., None, :]
        var = tree_sum(dev * dev * honest_w, dim=-2) / h
        adv = mu - param * torch.sqrt(var + 1e-12)
        return torch.where(byz, adv[..., None, :], msgs)
    if name == "ipm":
        _, _, mu = _honest_stats(msgs, mask)
        return torch.where(byz, (-param * mu)[..., None, :], msgs)
    raise KeyError(f"no kernel attack {name!r}")


def cwtm_ref(msgs: torch.Tensor, trim: int) -> torch.Tensor:
    """Coordinate-wise trimmed mean. msgs: (..., N, Q) -> (..., Q).

    Every NaN sorts last, as ``jnp.sort`` and the CUDA kernel put it
    (``nan_last``: on a CUDA device ``torch.sort`` sorts a NaN whose sign
    bit is set first at N=100; the CPU's last).
    """
    n = msgs.shape[-2]
    kept = torch.sort(nan_last(msgs), dim=-2).values[..., trim : n - trim, :]
    return tree_sum(kept, dim=-2) * (1.0 / kept.shape[-2])


def nnm_mix_ref(msgs: torch.Tensor, neighbours: torch.Tensor) -> torch.Tensor:
    """NNM mix. msgs: (..., N, Q), neighbours: (..., N, k) ids in table
    order (ascending, as ``aggregators.nnm_neighbours`` builds them) ->
    (..., N, Q), row n the mean of the rows its table row names.

    ``(x_{j_0} + x_{j_1} + ...) * (1 / k)``, added in table order one
    gathered (..., N, Q) block at a time, never an (..., N, k, Q) stack: the
    CWTM kernel's mix, term for term.
    """
    k = neighbours.shape[-1]
    idx = neighbours.long()
    out = None
    for m in range(k):
        rows = torch.gather(msgs, -2, idx[..., m, None].expand(idx.shape[:-1] + msgs.shape[-1:]))
        out = rows if out is None else out + rows
    return out * (1.0 / k)


def gram_ref(msgs: torch.Tensor):
    """(..., N, Q) -> (gram (..., N, N), row norms (..., N)), fp32.

    Row i of the Gram is the tree sum over Q of ``msgs * msgs[i]``: an
    (..., N, Q) temporary per row, never an (..., N, N, Q) one.
    """
    m = msgs.to(torch.float32)
    rows = [tree_sum(m * m[..., i : i + 1, :], dim=-1) for i in range(m.shape[-2])]
    return torch.stack(rows, dim=-2), tree_sum(m * m, dim=-1)


def sqdist_from_gram(gram: torch.Tensor, sq: torch.Tensor) -> torch.Tensor:
    """``max(sq_i + sq_j - 2 G_ij, 0)``: the (..., N, N) squared distances."""
    return torch.clamp_min(sq[..., :, None] + sq[..., None, :] - 2.0 * gram, 0.0)


def pairwise_sqdist_ref(msgs: torch.Tensor) -> torch.Tensor:
    """(..., N, Q) -> (..., N, N) squared euclidean distances (fp32)."""
    return sqdist_from_gram(*gram_ref(msgs))


def stochastic_quantize_ref(g: torch.Tensor, u: torch.Tensor, levels: int, block: int) -> torch.Tensor:
    """QSGD per block of ``block`` coordinates (dequantized output).

    g, u: (..., Q) with Q % block == 0; ``u`` in [0, 1) is the rounding
    randomness. Per block: ``scale = max |g|``, ``y = g / scale * levels``,
    ``y`` rounds up with probability ``y - floor(y)``, out ``yq / levels *
    scale`` (0 where scale is 0). Both divisions are true divisions: the
    level count is a tensor on ``g``'s device, since PyTorch on a CUDA
    device multiplies by the reciprocal of a host scalar instead.
    """
    gc = g.reshape(-1, block).to(torch.float32)
    uc = u.reshape(-1, block)
    scale = gc.abs().amax(dim=1, keepdim=True)
    positive = scale > 0
    safe = torch.where(positive, scale, 1.0)
    lev = torch.tensor(float(levels), device=g.device)
    y = gc / safe * lev
    lo = torch.floor(y)
    yq = lo + (uc < (y - lo)).to(torch.float32)
    out = torch.where(positive, yq / lev * safe, 0.0)
    return out.reshape(g.shape)


def masked_combine_ref(msgs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted row-combine over the device axis (the erasure decode's
    surviving-class sum). msgs: (..., N, Q), weights: (..., N) -> (..., Q).

    ``tree_sum(msgs * w, dim=-2)``: one rounded product per row, then the
    fixed tree over rows, as the reference's XLA decode sums
    (``core/coding.py::cyclic_erasure_decode``)."""
    return tree_sum(msgs * weights.to(torch.float32)[..., None], dim=-2)


def coded_combine_ref(grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """eq.-(5) weighted combine. grads: (..., d, Q), weights: (d,) or
    (..., d) -> (..., Q); the same sum as ``masked_combine_ref``."""
    return masked_combine_ref(grads, weights.to(torch.float32).expand(grads.shape[:-1]))
