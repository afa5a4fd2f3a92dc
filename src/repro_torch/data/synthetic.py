"""Synthetic training data with controllable heterogeneity.

1. ``linear_regression_problem``: the paper's Section-VII problem. N
   subsets of one sample each; features z_k ~ N(0, 100 I); per-subset
   ground truth x_hat_k with elementwise variance ``1 + k * sigma_h``;
   labels y_k ~ N(<z_k, x_hat_k>, 1). ``sigma_h = 0`` is the IID case.
2. ``HeterogeneousLM``: the LM's tokens. Each of the N subsets draws from
   its own skewed unigram distribution (a Zipf base re-weighted by a
   per-subset gamma draw whose concentration shrinks as sigma_h grows), so
   the subsets' gradients differ as the paper's beta^2 heterogeneity bound
   models.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.numerics import tree_sum

__all__ = ["linear_regression_problem", "linreg_resid", "linreg_subset_grads", "linreg_loss",
           "HeterogeneousLM", "lm_batch_for_devices"]


def linear_regression_problem(
    generator: torch.Generator, n: int = 100, dim: int = 100, sigma_h: float = 0.3
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Z (N, dim), y (N,)) drawn from ``generator`` on its own device."""
    dev = generator.device
    z = torch.randn((n, dim), generator=generator, device=dev) * 10.0
    subset_std = torch.sqrt(1.0 + torch.arange(n, dtype=torch.float32, device=dev) * sigma_h)
    x_hat = torch.randn((n, dim), generator=generator, device=dev) * subset_std[:, None]
    y = (z * x_hat).sum(dim=1) + torch.randn((n,), generator=generator, device=dev)
    return z, y


def linreg_resid(z: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Residuals ``<z_k, x> - y_k``: (..., N) for iterates x (..., dim).

    An elementwise product and a fixed-tree sum, as in the reference, not a
    matrix-vector product."""
    return tree_sum(z * x[..., None, :], dim=-1) - y


def linreg_subset_grads(z: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """All N subset gradients of f_k(x) = 0.5 (<x, z_k> - y_k)^2 at
    iterates x (..., dim): (..., N, dim). ``(z, y)`` are one problem
    ((N, dim), (N,)) or one per lane ((..., N, dim), (..., N))."""
    return linreg_resid(z, y, x)[..., None] * z


def linreg_loss(z: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sum of the subset losses at iterates x (..., dim) -> (...); a lane
    axis of ``(z, y)`` must stand before ``x``'s other axes (``z[:, None]``
    for iterates ``(L, steps, dim)``)."""
    r = linreg_resid(z, y, x)
    return 0.5 * tree_sum(r * r, dim=-1)


@dataclasses.dataclass(frozen=True)
class HeterogeneousLM:
    """Skewed-unigram synthetic LM data.

    Subset k's unigram distribution is a shared Zipf base re-weighted by a
    per-subset Dirichlet draw (normalised gammas) of concentration ``1 /
    (sigma_h + 1e-3)``: larger sigma_h, more heterogeneous subsets. Draws
    come from a ``torch.Generator`` on its device.
    """

    vocab: int
    n_subsets: int
    sigma_h: float = 0.3
    zipf_a: float = 1.2

    def subset_logits(self, generator: torch.Generator) -> torch.Tensor:
        """(N, V) per-subset unigram logits."""
        dev = generator.device
        base = -self.zipf_a * torch.log(torch.arange(1, self.vocab + 1, dtype=torch.float32, device=dev))
        conc = 1.0 / (self.sigma_h + 1e-3)
        alpha = torch.full((self.n_subsets, self.vocab), conc, dtype=torch.float32, device=dev)
        noise = torch._standard_gamma(alpha, generator=generator) / conc
        return base[None, :] + torch.log(noise + 1e-9)

    def sample(self, generator: torch.Generator, subset_logits: torch.Tensor, per_subset: int,
               seq_len: int) -> torch.Tensor:
        """tokens (N, per_subset, seq_len) int64, subset k's rows drawn from
        ``softmax(subset_logits[k])``."""
        probs = torch.softmax(subset_logits, dim=-1)
        toks = torch.multinomial(probs, per_subset * seq_len, replacement=True, generator=generator)
        return toks.reshape(self.n_subsets, per_subset, seq_len)


def lm_batch_for_devices(generator: torch.Generator, vocab: int, n_subsets: int, per_subset: int,
                         seq_len: int, sigma_h: float = 0.3) -> dict[str, torch.Tensor]:
    """One global batch laid out by subset: ``tokens`` (N, per_subset, S) and
    their next-token ``labels``."""
    gen = HeterogeneousLM(vocab=vocab, n_subsets=n_subsets, sigma_h=sigma_h)
    toks = gen.sample(generator, gen.subset_logits(generator), per_subset, seq_len + 1)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
