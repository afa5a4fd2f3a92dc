"""Minimal functional module system.

Parameters are nested dicts of tensors. Every initializer returns a pair
``(params, specs)`` with the same tree structure, where each spec leaf is a
tuple of *logical axis names* (one per tensor dim), as in the reference:

  * ``"tp"``    — tensor-parallel dim
  * ``"fsdp"``  — ZeRO/FSDP dim
  * ``None``    — replicated dim
  * ``"stack"`` — the leading period-stacking dim

``logical_to_mesh`` maps a spec tree to the reference's partition specs for
a ``launch.mesh.Mesh``: a tuple a leaf with one mesh axis (or ``None``) a
dim, ``"tp"`` on ``"model"`` and ``"fsdp"`` on ``"data"`` by
``DEFAULT_RULES``, a dim that does not divide by its axis's ranks
downgraded to replicated. Random initializers draw from a
``torch.Generator``, on its device, in the order they are called.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch import pytree

__all__ = ["DEFAULT_RULES", "truncated_normal_init", "dense_param", "scale_param", "zeros_param", "split_tree",
           "logical_to_mesh",
           "tree_size", "tree_bytes"]

Params = Any  # nested dict of tensors
Specs = Any  # matching nested dict of tuples of logical axis names

_SQRT2 = math.sqrt(2.0)

DEFAULT_RULES = {
    "tp": "model",
    "fsdp": "data",
    "stack": None,
    None: None,
}


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


def _axis_size(mesh, mesh_axis) -> int:
    if mesh_axis is None:
        return 1
    if isinstance(mesh_axis, (tuple, list)):
        return math.prod(mesh.shape[a] for a in mesh_axis)
    return mesh.shape[mesh_axis]


def logical_to_mesh(specs: Specs, mesh, rules: dict | None = None, shapes: Params | None = None) -> Any:
    """The partition spec of every leaf of ``specs`` on ``mesh``: a tuple of
    one mesh axis (a name, a tuple of names, or ``None``) a dim. Where
    ``shapes`` (a tree of tensors, ``meta`` ones too) is given, a dim that
    does not divide by its axis's ranks is replicated."""
    rules = {**DEFAULT_RULES, **(rules or {})}

    def one(spec, shaped=None):
        entries = []
        for i, ax in enumerate(spec):
            mesh_ax = rules.get(ax, None)
            if mesh_ax is not None and shaped is not None and shaped.shape[i] % _axis_size(mesh, mesh_ax) != 0:
                mesh_ax = None
            entries.append(mesh_ax)
        return tuple(entries)

    if isinstance(specs, dict):
        return {k: logical_to_mesh(specs[k], mesh, rules, None if shapes is None else shapes[k]) for k in specs}
    return one(specs, shapes)


def tree_size(params) -> int:
    """Total number of parameters."""
    return sum(leaf.numel() for leaf in pytree.leaves(params))


def tree_bytes(params) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in pytree.leaves(params))
