"""Byzantine attacks: ``(msgs (..., N, Q), byz_mask (..., N), noise) ->
transmitted (..., N, Q)``; leading axes are lanes.

The paper's sign-flip (coefficient -2) and the ALIE and IPM collusion
attacks run through the attack kernel (``kernels/ops.py::attack``) on a
CUDA tensor and through its plain version on the CPU. ``none``, ``zero``,
``label_shift`` and ``gaussian`` are plain tensor code. ``gaussian`` is the
only attack that reads ``noise``: the round's ``(..., N, Q)`` standard normals
(``RoundRandomness.attack_noise``), drawn outside the round.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.attacks import KERNEL_ATTACK_PARAMS

Attack = Callable[..., torch.Tensor]

__all__ = ["Attack", "AttackSpec", "gaussian", "make_attack", "sample_byzantine_mask"]


def _zero(msgs: torch.Tensor, mask: torch.Tensor, noise=None) -> torch.Tensor:
    return torch.where(mask[..., None] > 0, torch.zeros_like(msgs), msgs)


def _label_shift(msgs: torch.Tensor, mask: torch.Tensor, noise=None) -> torch.Tensor:
    """Gradient-space proxy for label flipping: negate."""
    return torch.where(mask[..., None] > 0, -1.0 * msgs, msgs)


def gaussian(msgs: torch.Tensor, mask: torch.Tensor, noise: torch.Tensor | None = None,
             std: float = 10.0) -> torch.Tensor:
    """Byzantine rows become ``std * noise``, honest rows stay. The select
    writes one (..., N, Q) stack and scales it in place: an honest row times
    exact 1.0 keeps its bits, a Byzantine row is ``noise * std``, the
    reference's ``std * normal``."""
    if noise is None or noise.shape != msgs.shape:
        raise ValueError(f"the gaussian attack needs noise of the messages' shape {tuple(msgs.shape)}")
    byz = mask[..., None] > 0
    return torch.where(byz, noise, msgs).mul_(torch.where(byz, std, 1.0))


@dataclasses.dataclass(frozen=True)
class AttackSpec:
    name: str = "sign_flip"
    n_byz: int = 0
    fixed_identity: bool = True  # B^t fixed across rounds vs resampled per round
    coeff: float = -2.0  # sign_flip
    std: float = 10.0  # gaussian
    z: float = 1.5  # alie
    eps: float = 0.5  # ipm

    def make(self) -> Attack:
        return make_attack(self)


def make_attack(spec: AttackSpec) -> Attack:
    """The corruption map of ``spec``."""
    if spec.name in KERNEL_ATTACK_PARAMS:
        name = spec.name
        param = float(getattr(spec, KERNEL_ATTACK_PARAMS[name]))
        return lambda msgs, mask, noise=None: kernel_ops.attack(msgs, mask, name, param)
    if spec.name == "none":
        return lambda msgs, mask, noise=None: msgs
    if spec.name == "zero":
        return _zero
    if spec.name == "label_shift":
        return _label_shift
    if spec.name == "gaussian":
        return partial(gaussian, std=float(spec.std))
    raise KeyError(f"unknown attack {spec.name!r}")


def sample_byzantine_mask(
    n: int, n_byz: int, fixed: bool = True, *,
    generator: torch.Generator | None = None, device: torch.device | str = "cpu",
) -> torch.Tensor:
    """0/1 float mask of the Byzantine devices. ``fixed=True`` marks the first
    ``n_byz`` devices; otherwise a uniformly random ``n_byz``-subset drawn
    from ``generator``."""
    if n_byz == 0 or fixed:
        return (torch.arange(n, device=device) < n_byz).to(torch.float32)
    if generator is None:
        raise ValueError("a random Byzantine set needs a generator")
    perm = torch.randperm(n, generator=generator, device=generator.device)
    return (perm < n_byz).to(torch.float32)
