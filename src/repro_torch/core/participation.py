"""Partial participation: which devices report in a round.

With computational load ``d`` the cyclic code recovers the full gradient
mean from any ``K`` of ``N`` coded reports while the erasures stay within
the margin ``d - 1`` (``coding.cyclic_erasure_decode``). This module is the
fault model: a per-round 0/1 mask over the ``N`` devices, from a schedule.

Schedules (``ParticipationSpec.name``):

  * ``"full"``        every device reports; the round takes its unmasked
                      path.
  * ``"iid"``         each device drops with probability ``rate`` each
                      round (``rate=0.0`` gives all-ones masks through the
                      masked path).
  * ``"onoff"``       the last ``n_drop`` devices report only in the first
                      ``round(duty * period)`` rounds of each
                      ``period``-round window, phase-shifted per device.
  * ``"adversarial"`` the same rows ``[offset, offset + n_drop)`` are
                      erased every round (callers set ``offset = n_byz``,
                      so the Byzantine block keeps reporting).
  * ``"markov"``      sticky dropout: a reporting device fails with
                      probability ``p_drop``, a failed one recovers with
                      probability ``p_recover``; the state is the previous
                      mask.
  * ``"external"``    the caller supplies the mask each round;
                      ``sample_participation`` refuses it.

Every schedule keeps at least one device reporting: a draw that erases all
rows turns the last device back on.

The random schedules take their ``(N,)`` uniforms as an input (``u``): the
trainer draws them from its generator, and a test replays the reference's,
``uniform(fold_in(round_key, PARTICIPATION_KEY_SALT), (N,))``.

The mask erases the transmitted vectors: after the attack, before the
server. Erased rows are exact 0.0 in the fixed-tree sums.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.coding import erasure_margin
from repro_torch.numerics import tree_sum

__all__ = [
    "ParticipationSpec",
    "SCHEDULES",
    "sample_participation",
    "init_participation_state",
    "mask_stats",
    "PARTICIPATION_KEY_SALT",
]

# The reference folds this salt into its round key for the participation
# draw, out of band of the round key's four-way split. The port takes the
# draw as an input; the salt is kept for the tests that replay it.
PARTICIPATION_KEY_SALT = 0x5A17

SCHEDULES = ("full", "iid", "onoff", "adversarial", "markov", "external")


@dataclasses.dataclass(frozen=True)
class ParticipationSpec:
    """The participation fault model of a protocol condition.

    Attributes:
      name: schedule family (see the module docstring).
      rate: ``"iid"`` per-round drop probability.
      n_drop: erased / straggler device count (``"onoff"``, ``"adversarial"``).
      period / duty: the ``"onoff"`` duty cycle.
      offset: first erased row of ``"adversarial"``.
      p_drop / p_recover: the ``"markov"`` transition probabilities.
    """

    name: str = "full"
    rate: float = 0.0
    n_drop: int = 0
    period: int = 4
    duty: float = 0.5
    offset: int = 0
    p_drop: float = 0.1
    p_recover: float = 0.5

    def __post_init__(self):
        if self.name not in SCHEDULES:
            raise ValueError(f"unknown participation schedule {self.name!r}; have {SCHEDULES}")
        if not 0.0 <= self.rate < 1.0:
            raise ValueError(f"rate must be in [0, 1), got {self.rate}")
        if self.n_drop < 0 or self.offset < 0:
            raise ValueError(f"n_drop/offset must be >= 0, got {self}")
        if self.period < 1 or not 0.0 < self.duty <= 1.0:
            raise ValueError(f"bad duty cycle period={self.period} duty={self.duty}")

    @property
    def active(self) -> bool:
        """Whether the round takes the masked path: every schedule but
        ``"full"`` (``"iid"`` at rate 0 on purpose)."""
        return self.name != "full"


def init_participation_state(spec: ParticipationSpec, n: int,
                             device: torch.device | str = "cpu",
                             lanes: int | None = None) -> torch.Tensor:
    """The schedule state before round 0: the previous mask, all ones;
    ``(N,)``, or ``(lanes, N)``, one state per lane of a grid."""
    del spec
    shape = (n,) if lanes is None else (lanes, n)
    return torch.ones(shape, dtype=torch.float32, device=device)


def _ensure_one_reporter(mask: torch.Tensor) -> torch.Tensor:
    """The last device back on in each lane of (..., N) whose draw erased
    every row (a select on the exact count, no arithmetic on the mask)."""
    n = mask.shape[-1]
    fallback = (torch.arange(n, device=mask.device) == n - 1).to(torch.float32)
    return torch.where(tree_sum(mask, dim=-1)[..., None] == 0.0, fallback, mask)


def sample_participation(
    spec: ParticipationSpec,
    u: torch.Tensor | None,
    t: int | torch.Tensor,
    n: int,
    state: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The round-``t`` mask of ``spec``, float32 0/1 of the state's shape
    (1 = the device reports), and the new state.

    ``state`` is the previous mask, ``(N,)`` or ``(..., N)`` with one state
    per lane; only ``"markov"`` evolves it. ``u`` is the round's uniforms in
    [0, 1), of the state's shape; ``"iid"`` and ``"markov"`` read it, the
    other schedules do not (it may be ``None`` there). ``t`` is the round
    index, an int or a 0-d int64 tensor on the state's device (the step
    counter of a captured trajectory, never read back), shared by every
    lane; ``"onoff"`` reads it.
    """
    dev = state.device
    if state.shape[-1] != n:
        raise ValueError(f"participation state {tuple(state.shape)} is not over {n} devices")
    if spec.name == "full":
        return torch.ones(state.shape, dtype=torch.float32, device=dev), state
    if spec.name in ("iid", "markov") and (u is None or u.shape != state.shape):
        raise ValueError(f"schedule {spec.name!r} needs uniforms of the state's shape {tuple(state.shape)}")
    if spec.name == "iid":
        return _ensure_one_reporter((u >= spec.rate).to(torch.float32)), state
    idx = torch.arange(n, device=dev)
    if spec.name == "onoff":
        n_straggle = min(spec.n_drop, n)
        duty_rounds = max(1, int(round(spec.duty * spec.period)))
        straggler = idx >= n - n_straggle
        # phase-shifted per device, so stragglers do not blink in lockstep
        on = ~straggler | ((t + idx) % spec.period < duty_rounds)
        return _ensure_one_reporter(on.to(torch.float32)).expand(state.shape), state
    if spec.name == "adversarial":
        erased = (idx >= spec.offset) & (idx < spec.offset + spec.n_drop)
        return _ensure_one_reporter((~erased).to(torch.float32)).expand(state.shape), state
    if spec.name == "markov":
        mask = torch.where(state > 0.0, u >= spec.p_drop, u < spec.p_recover).to(torch.float32)
        mask = _ensure_one_reporter(mask)
        return mask, mask
    raise ValueError(
        f"participation schedule {spec.name!r} cannot be sampled: the mask is "
        "supplied by the caller (pass participation_mask= to protocol_round)"
    )


def mask_stats(mask_hist, d: int) -> dict:
    """Counters of an observed round-major history of 0/1 masks against the
    code's margin ``erasure_margin(d)``: rounds, the margin, the worst
    erasure count, the rounds within the margin (where the decode is exact)
    and the full rounds."""
    margin = erasure_margin(d)
    erasures = [int(len(m)) - int(sum(int(v) for v in m)) for m in mask_hist]
    return {
        "rounds": len(erasures),
        "margin": margin,
        "max_erasures": max(erasures, default=0),
        "within_margin_rounds": sum(1 for e in erasures if e <= margin),
        "full_rounds": sum(1 for e in erasures if e == 0),
    }
