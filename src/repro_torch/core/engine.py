"""The multi-round trainer: protocol rounds plus optimizer steps.

``run_trajectory`` runs ``steps`` rounds as a Python loop. Each round
computes every subset gradient at the iterate, runs ``protocol_round`` with
that round's ``RoundRandomness`` and takes an optimizer step. The round
keeps its raw vectors (aggregate, honest subset mean, new iterate), and the
per-round metrics are computed from the stacked vectors after the loop with
fixed-tree reductions, as the reference's ``_finalize_metrics`` does.

Under an active participation schedule the loop also carries the schedule
state (the previous mask, which ``"markov"`` evolves), draws each round's
mask from the round's ``part_u``, ``t`` and that state, and records the
round's reporting count as the metric ``n_report``.

A trajectory captured as one CUDA graph (the reference's ``scan`` mode)
comes in a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.byzantine import (
    ProtocolConfig,
    RoundRandomness,
    make_attack_fn,
    make_server_fn,
    protocol_round,
    sample_round_randomness,
)
from repro_torch.core.participation import init_participation_state, sample_participation
from repro_torch.device import resolve_device
from repro_torch.numerics import stable_mean0, stable_norm, tree_sum
from repro_torch.optim import OptState, make_optimizer

__all__ = ["TrajectoryResult", "RandomnessProvider", "run_trajectory"]

RandomnessProvider = Callable[[int], RoundRandomness]


@dataclasses.dataclass(frozen=True)
class TrajectoryResult:
    """Output of ``run_trajectory``.

    Attributes:
      x: final iterate ``(Q,)``.
      opt_state: the optimizer state after the last step.
      metrics: per-round ``(steps,)`` tensors: ``agg_dist`` (||aggregate -
        honest subset mean||), ``grad_norm``, ``loss`` when a ``loss_fn`` was
        given, ``sol_err`` (||x_t - x*||) when ``x_star`` was, and
        ``n_report`` (reporting devices) under active participation.
      participation_state: the schedule state after the last round (the last
        mask), ``None`` at full participation.
    """

    x: torch.Tensor
    opt_state: OptState
    metrics: dict[str, torch.Tensor]
    participation_state: torch.Tensor | None = None


def _finalize_metrics(raw: dict[str, torch.Tensor], loss_fn, x_star) -> dict[str, torch.Tensor]:
    """Per-round metrics from the stacked ``(steps, Q)`` raw vectors."""
    metrics = {
        "agg_dist": stable_norm(raw["g"] - raw["gmean"]),
        "grad_norm": stable_norm(raw["g"]),
    }
    if loss_fn is not None:
        metrics["loss"] = loss_fn(raw["x"])
    if x_star is not None:
        metrics["sol_err"] = stable_norm(raw["x"] - x_star)
    if "n_report" in raw:
        metrics["n_report"] = raw["n_report"]
    return metrics


def run_trajectory(
    cfg: ProtocolConfig,
    x0: torch.Tensor,
    subset_grad_fn: Callable[..., torch.Tensor],
    *,
    steps: int,
    lr: float,
    randomness: RandomnessProvider | torch.Generator | None = None,
    optimizer: str = "sgd",
    grad_scale: float = 1.0,
    loss_fn: Callable[..., torch.Tensor] | None = None,
    x_star: torch.Tensor | None = None,
    data: Any = None,
    opt_state: OptState | None = None,
    participation_state: torch.Tensor | None = None,
    device: torch.device | str | None = None,
) -> TrajectoryResult:
    """Run ``steps`` protocol rounds from ``x0``.

    Args:
      cfg: protocol configuration.
      x0: initial iterate ``(Q,)``; moved to ``device``.
      subset_grad_fn: ``x -> (N, Q)`` subset gradients, or ``(data, x) ->
        (N, Q)`` when ``data`` is given.
      steps: number of rounds.
      lr: step size.
      randomness: a ``torch.Generator`` on ``device`` that draws every
        round (seeded 0 when not given), or a provider ``t ->
        RoundRandomness`` for rounds ``t = 0 .. steps-1``, whose records are
        checked with ``RoundRandomness.validate`` as they come in.
      optimizer: a ``repro_torch.optim.make_optimizer`` name.
      grad_scale: multiplies the aggregate before the optimizer step (the
        paper's eq.-(7) sum-loss needs ``N x`` the mean-gradient estimate).
      loss_fn / x_star: optional metric hooks; ``loss_fn`` maps stacked
        iterates ``(steps, Q)`` (and ``data`` first, when given) to
        ``(steps,)``.
      data: problem tensors handed to ``subset_grad_fn`` and ``loss_fn``.
      opt_state: optimizer state to resume from.
      participation_state: schedule state to resume from (the previous
        ``(N,)`` mask); all ones when not given.
      device: where the rounds run; ``cuda`` when not given (no CUDA then
        raises).
    """
    dev = resolve_device(device)
    opt = make_optimizer(optimizer)
    x = x0.to(dev)
    state = opt.init(x) if opt_state is None else opt_state
    q = x.shape[-1]
    if randomness is None:
        randomness = torch.Generator(device=dev).manual_seed(0)
    gen, provider = (randomness, None) if isinstance(randomness, torch.Generator) else (None, randomness)

    def draw(t: int) -> RoundRandomness:
        if gen is not None:  # drawn in round order, so rounds are asked for in order
            return sample_round_randomness(cfg, q, gen)
        rand = provider(t)
        rand.validate(cfg.n_devices, q)
        return rand

    grads_of = (lambda x: subset_grad_fn(data, x)) if data is not None else subset_grad_fn
    attack_fn = make_attack_fn(cfg)
    server_fn = make_server_fn(cfg)
    p_spec = cfg.participation
    p_state = None
    if p_spec.active:
        p_state = (init_participation_state(p_spec, cfg.n_devices, device=dev)
                   if participation_state is None else participation_state.to(dev))
    raw: dict[str, list[torch.Tensor]] = {"g": [], "gmean": [], "x": []}
    if p_spec.active:
        raw["n_report"] = []
    for t in range(steps):
        grads = grads_of(x)
        rand = draw(t).to(dev)
        pm = None
        if p_spec.active:
            pm, p_state = sample_participation(p_spec, rand.part_u, t, cfg.n_devices, p_state)
            raw["n_report"].append(tree_sum(pm, dim=0))
        g = protocol_round(cfg, grads, rand, device=dev, attack_fn=attack_fn,
                           server_fn=server_fn, participation_mask=pm)
        x, state = opt.update(x, grad_scale * g, state, lr)
        raw["g"].append(g)
        raw["gmean"].append(stable_mean0(grads))
        raw["x"].append(x)
    stacked = {k: torch.stack(v) for k, v in raw.items()}
    bound_loss = None
    if loss_fn is not None:
        bound_loss = (lambda xs: loss_fn(data, xs)) if data is not None else loss_fn
    return TrajectoryResult(x=x, opt_state=state, participation_state=p_state,
                            metrics=_finalize_metrics(stacked, bound_loss, x_star))
