"""Plain SGD, as a pair of functions:

    state = opt.init(params)
    new_params, new_state = opt.update(params, grads, state, lr)

Momentum and AdamW wait for the LM train path of a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

__all__ = ["Optimizer", "OptState", "sgd", "make_optimizer"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


@dataclasses.dataclass(frozen=True)
class OptState:
    step: int


def sgd() -> Optimizer:
    def init(params: torch.Tensor) -> OptState:
        return OptState(step=0)

    def update(params: torch.Tensor, grads: torch.Tensor, state: OptState, lr: float | torch.Tensor,
               weight_decay: float = 0.0):
        """``lr`` is a float, or a float32 tensor of the lanes' shape
        (``(L,)`` for ``(L, Q)`` params): one step size per lane, the same
        bits as the float."""
        if isinstance(lr, torch.Tensor):
            lr = lr.reshape(lr.shape + (1,) * (params.ndim - lr.ndim))
        g = grads.to(torch.float32) + weight_decay * params.to(torch.float32)
        new = (params.to(torch.float32) - lr * g).to(params.dtype)
        return new, OptState(step=state.step + 1)

    return Optimizer(init, update)


def make_optimizer(name: str) -> Optimizer:
    if name == "sgd":
        return sgd()
    if name in ("momentum", "sgd_momentum", "adamw"):
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (ROADMAP A.7)")
    raise KeyError(f"unknown optimizer {name!r}")
