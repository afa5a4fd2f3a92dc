"""SGD, SGD-momentum and AdamW, with the moments' dtype configurable.

An optimizer is a pair of functions, as in the reference:

    state = opt.init(params)
    new_params, new_state = opt.update(params, grads, state, lr, weight_decay=0.0)

``params`` is a flat tensor, an ``(L, Q)`` stack of lanes, or a tree of
tensors (nested dicts and lists, walked in ``pytree``'s leaf order), and the
moments take its form. Every leaf's arithmetic is the reference's, in its
order: fp32 throughout, the result cast back to the leaf's dtype and the
moments to ``momentum_dtype``. The state's ``step`` is a 0-d int32 tensor on
the params' device, so a captured round advances it and AdamW's bias
correction reads it there. ``lr`` is a float, a 0-d float32 tensor (a
schedule's value), or for an ``(L, Q)`` stack one step size per lane ``(L,)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import pytree

__all__ = ["Optimizer", "OptState", "sgd", "sgd_momentum", "adamw", "make_optimizer"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


@dataclasses.dataclass(frozen=True)
class OptState:
    step: torch.Tensor  # 0-d int32
    mu: Any  # first moment / momentum, () for plain SGD
    nu: Any  # second moment, () for SGD and momentum


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=pytree.leaves(params)[0].device)


def _lr_for(lr, p: torch.Tensor):
    """``lr`` shaped to broadcast over ``p``: a per-lane ``(L,)`` tensor
    gets trailing unit axes."""
    if isinstance(lr, torch.Tensor) and lr.ndim:
        return lr.reshape(lr.shape + (1,) * (p.ndim - lr.ndim))
    return lr


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def sgd() -> Optimizer:
    def init(params) -> OptState:
        return OptState(step=_step0(params), mu=(), nu=())

    def update(params, grads, state: OptState, lr, weight_decay: float = 0.0):
        def upd(p, g):
            g = _f32(g) + weight_decay * _f32(p)
            return (_f32(p) - _lr_for(lr, p) * g).to(p.dtype)

        return pytree.map_tree(upd, params, grads), OptState(step=state.step + 1, mu=(), nu=())

    return Optimizer(init, update)


def _zeros_like(params, dtype: torch.dtype):
    return pytree.map_tree(lambda p: torch.zeros_like(p, dtype=dtype), params)


def _per_leaf(fn: Callable, params, *trees) -> list:
    """``fn`` over the leaves of ``params`` and of ``trees`` of its
    structure; ``fn`` returns a tuple, and each of its places becomes a tree
    of ``params``' structure."""
    outs = [fn(*args) for args in zip(*(pytree.leaves(t) for t in (params, *trees)), strict=True)]
    return [pytree.from_leaves(params, list(col)) for col in zip(*outs)]


def sgd_momentum(beta: float = 0.9, momentum_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params) -> OptState:
        return OptState(step=_step0(params), mu=_zeros_like(params, momentum_dtype), nu=())

    def update(params, grads, state: OptState, lr, weight_decay: float = 0.0):
        def upd(p, g, m):
            g = _f32(g) + weight_decay * _f32(p)
            m_new = beta * _f32(m) + g
            return (_f32(p) - _lr_for(lr, p) * m_new).to(p.dtype), m_new.to(momentum_dtype)

        new_params, new_mu = _per_leaf(upd, params, grads, state.mu)
        return new_params, OptState(step=state.step + 1, mu=new_mu, nu=())

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          momentum_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params) -> OptState:
        return OptState(step=_step0(params), mu=_zeros_like(params, momentum_dtype),
                        nu=_zeros_like(params, momentum_dtype))

    def update(params, grads, state: OptState, lr, weight_decay: float = 0.0):
        t = state.step + 1
        c1 = 1.0 - b1 ** _f32(t)
        c2 = 1.0 - b2 ** _f32(t)

        def upd(p, g, m, v):
            g = _f32(g)
            m_new = b1 * _f32(m) + (1 - b1) * g
            v_new = b2 * _f32(v) + (1 - b2) * g * g
            m_hat = m_new / c1
            v_hat = v_new / c2
            step_vec = m_hat / (torch.sqrt(v_hat) + eps) + weight_decay * _f32(p)
            return ((_f32(p) - _lr_for(lr, p) * step_vec).to(p.dtype), m_new.to(momentum_dtype),
                    v_new.to(momentum_dtype))

        new_params, new_mu, new_nu = _per_leaf(upd, params, grads, state.mu, state.nu)
        return new_params, OptState(step=t, mu=new_mu, nu=new_nu)

    return Optimizer(init, update)


def _dtype(name: str | torch.dtype) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown momentum dtype {name!r}")
    return dtype


def make_optimizer(name: str, *, momentum_dtype: str | torch.dtype = "float32", **kwargs) -> Optimizer:
    """``sgd``, ``momentum`` / ``sgd_momentum`` or ``adamw``; ``kwargs`` go
    to the constructor (``beta``; ``b1``, ``b2``, ``eps``)."""
    md = _dtype(momentum_dtype)
    if name == "sgd":
        return sgd()
    if name in ("momentum", "sgd_momentum"):
        return sgd_momentum(momentum_dtype=md, **kwargs)
    if name == "adamw":
        return adamw(momentum_dtype=md, **kwargs)
    raise KeyError(f"unknown optimizer {name!r}")
