"""Byzantine attacks: ``(msgs (..., N, Q), byz_mask (..., N), noise) ->
transmitted (..., N, Q)``; leading axes are lanes.

The paper's sign-flip (coefficient -2) and the ALIE and IPM collusion
attacks (``sign_flip``, ``alie``, ``ipm``) run through the attack kernel
(``kernels/ops.py::attack``) on a CUDA tensor and through its plain version
on the CPU. ``none``, ``zero_attack``, ``label_shift_proxy`` and
``gaussian`` are plain tensor code. Each named attack takes its scalar
after ``noise``, as the reference's takes it after the mask. ``gaussian`` is the
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

__all__ = ["Attack", "AttackSpec", "sign_flip", "gaussian", "zero_attack", "alie", "ipm", "label_shift_proxy",
           "make_attack", "sample_byzantine_mask"]


def sign_flip(msgs: torch.Tensor, mask: torch.Tensor, noise=None, coeff: float = -2.0) -> torch.Tensor:
    """Section VII's attack: Byzantine rows are the true ones times
    ``coeff`` (-2). The attack kernel."""
    return kernel_ops.attack(msgs, mask, "sign_flip", coeff)


def zero_attack(msgs: torch.Tensor, mask: torch.Tensor, noise=None) -> torch.Tensor:
    """Byzantine rows become zero."""
    return torch.where(mask[..., None] > 0, torch.zeros_like(msgs), msgs)


def alie(msgs: torch.Tensor, mask: torch.Tensor, noise=None, z: float = 1.5) -> torch.Tensor:
    """A-Little-Is-Enough: Byzantine rows send the honest mean minus ``z``
    honest standard deviations, coordinate by coordinate. The attack kernel
    (its sums in ``tree_sum``'s order)."""
    return kernel_ops.attack(msgs, mask, "alie", z)


def ipm(msgs: torch.Tensor, mask: torch.Tensor, noise=None, eps: float = 0.5) -> torch.Tensor:
    """Inner-product manipulation: Byzantine rows send ``-eps`` times the
    honest mean. The attack kernel."""
    return kernel_ops.attack(msgs, mask, "ipm", eps)


def label_shift_proxy(msgs: torch.Tensor, mask: torch.Tensor, noise=None, scale: float = 1.0) -> torch.Tensor:
    """Gradient-space proxy for label flipping: Byzantine rows negated and
    scaled by ``scale`` (a label-flipped cross-entropy gradient points
    roughly opposite)."""
    return torch.where(mask[..., None] > 0, -scale * msgs, msgs)


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


# the named attacks of ``make_attack`` and the ``AttackSpec`` field that is
# each one's scalar (``AttackSpec`` has no ``scale``: label_shift keeps 1.0)
_NAMED = {"sign_flip": sign_flip, "alie": alie, "ipm": ipm, "gaussian": gaussian, "zero": zero_attack,
          "label_shift": label_shift_proxy}
_PARAMS = {**KERNEL_ATTACK_PARAMS, "gaussian": "std"}


def make_attack(spec: AttackSpec) -> Attack:
    """The corruption map ``(msgs, mask, noise=None) -> transmitted`` of
    ``spec``: its named attack at the spec's scalar."""
    if spec.name == "none":
        return lambda msgs, mask, noise=None: msgs
    if spec.name not in _NAMED:
        raise KeyError(f"unknown attack {spec.name!r}")
    param = _PARAMS.get(spec.name)
    fn = _NAMED[spec.name]
    return fn if param is None else partial(fn, **{param: float(getattr(spec, param))})


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
