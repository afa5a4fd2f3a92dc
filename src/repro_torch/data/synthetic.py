"""The paper's Section-VII linear-regression problem.

N subsets of one sample each; features z_k ~ N(0, 100 I); per-subset ground
truth x_hat_k with elementwise variance ``1 + k * sigma_h``; labels
y_k ~ N(<z_k, x_hat_k>, 1). ``sigma_h = 0`` is the IID case.
"""
from __future__ import annotations

import torch

from repro_torch.numerics import tree_sum

__all__ = ["linear_regression_problem", "linreg_resid", "linreg_subset_grads", "linreg_loss"]


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
