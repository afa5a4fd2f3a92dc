"""Minimal functional module system.

Parameters are nested dicts of tensors. Every initializer returns a pair
``(params, specs)`` with the same tree structure, where each spec leaf is a
tuple of *logical axis names* (one per tensor dim), as in the reference:

  * ``"tp"``    — tensor-parallel dim
  * ``"fsdp"``  — ZeRO/FSDP dim
  * ``None``    — replicated dim
  * ``"stack"`` — the leading period-stacking dim

The placement is explicit in the port: ``logical_to_mesh`` says, for each
leaf, which dim the sharded server of the ``"protomath"`` step cuts over
the mesh's ranks (its ``fsdp`` dim, where that divides), and nothing else;
the ``"tp"`` axis waits for ROADMAP A.9c. Random initializers draw from a
``torch.Generator``, on its device, in the order they are called.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch import pytree
from repro_torch.core.protomath import sharded_dim

__all__ = ["truncated_normal_init", "dense_param", "scale_param", "zeros_param", "split_tree", "logical_to_mesh",
           "tree_size", "tree_bytes"]

Params = Any  # nested dict of tensors
Specs = Any  # matching nested dict of tuples of logical axis names

_SQRT2 = math.sqrt(2.0)


def truncated_normal_init(generator: torch.Generator, shape, dtype: torch.dtype, scale: float) -> torch.Tensor:
    """He-style scaled truncated normal (stddev = scale / sqrt(fan_in)).

    A standard normal truncated to [-2, 2] by the inverse CDF, as
    ``jax.random.truncated_normal`` draws it: one uniform per value mapped
    through ``sqrt(2) erfinv`` between ``erf(-2/sqrt 2)`` and ``erf(2/sqrt 2)``,
    in float32, then scaled and cast to ``dtype``."""
    shape = tuple(shape)
    fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
    std = scale / math.sqrt(fan_in)
    lo, hi = math.erf(-2.0 / _SQRT2), math.erf(2.0 / _SQRT2)
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)
    z = torch.erfinv(u.mul_(hi - lo).add_(lo)).mul_(_SQRT2).clamp_(-2.0, 2.0)
    return z.mul_(std).to(dtype)


def dense_param(generator: torch.Generator, shape, axes, dtype: torch.dtype = torch.bfloat16,
                scale: float = 1.0):
    """A weight matrix with its logical-axes spec."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    return truncated_normal_init(generator, shape, dtype, scale), tuple(axes)


def scale_param(shape, axes, dtype: torch.dtype = torch.float32, value: float = 1.0, device=None):
    """Norm scales etc.: a constant, usually replicated."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    return torch.full(tuple(shape), value, dtype=dtype, device=device), tuple(axes)


def zeros_param(shape, axes, dtype: torch.dtype = torch.bfloat16, device=None):
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    return torch.zeros(tuple(shape), dtype=dtype, device=device), tuple(axes)


def split_tree(pairs: dict) -> tuple[Params, Specs]:
    """Split a nested dict of ``(param, spec)`` pairs into two parallel trees."""
    params, specs = {}, {}
    for name, val in pairs.items():
        if isinstance(val, dict):
            p, s = split_tree(val)
        else:
            p, s = val
        params[name], specs[name] = p, s
    return params, specs


def logical_to_mesh(specs: Specs, mesh, shapes: Params) -> Any:
    """For each leaf of ``specs`` (with ``shapes``' tensors beside it), the
    dim the sharded server cuts over ``mesh``'s ``world`` ranks: its
    ``fsdp`` dim where that divides by ``world``, else ``None`` (the leaf
    takes the gather server)."""
    if isinstance(specs, dict):
        return {k: logical_to_mesh(specs[k], mesh, shapes[k]) for k in specs}
    return sharded_dim(specs, tuple(shapes.shape), mesh.world)


def tree_size(params) -> int:
    """Total number of parameters."""
    return sum(leaf.numel() for leaf in pytree.leaves(params))


def tree_bytes(params) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in pytree.leaves(params))
