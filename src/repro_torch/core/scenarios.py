"""The paper's Section-VII conditions and the function that runs one.

  * ``Scenario`` — one declarative row; ``.protocol()`` lowers it to a
    ``ProtocolConfig``.
  * ``PAPER_FIG4/5/6`` — the named curves of Figs. 4-6.
  * ``section7_grid`` — the paper's comparison grid: method x attack x
    aggregator x compressor x heterogeneity, with the combinations the paper
    rules out dropped.
  * ``participation_sweep`` — the partial-participation rows: schedule x
    aggregator x attack over the cyclic code.
  * ``run_scenario`` — a scenario on the linear-regression problem.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.attacks import AttackSpec
from repro_torch.core.byzantine import ProtocolConfig
from repro_torch.core.coding import erasure_margin
from repro_torch.core.compression import spec_from
from repro_torch.core.participation import ParticipationSpec
from repro_torch.core.engine import RandomnessProvider, TrajectoryResult, run_trajectory
from repro_torch.data.synthetic import linear_regression_problem, linreg_loss, linreg_subset_grads
from repro_torch.device import resolve_device

__all__ = ["Scenario", "scenario_name", "section7_grid", "PAPER_FIG4", "PAPER_FIG5", "PAPER_FIG6",
           "participation_sweep", "run_scenario"]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One experimental condition."""

    name: str
    method: str = "lad"  # lad | plain | draco
    d: int = 1
    aggregator: str = "cwtm"
    attack: str = "sign_flip"
    n_byz: int = 20
    compressor: str = "none"  # none | rand_sparse | rand_sparse_shared | quant | top_k, or "quant:4"
    q_hat_frac: float = 0.3
    quant_levels: int = 16
    sigma_h: float = 0.3
    trim_frac: float = 0.1
    n_devices: int = 100
    lr: float = 1e-6
    # participation schedule (core/participation.py): full | iid | onoff | adversarial | markov
    participation: str = "full"
    p_rate: float = 0.0  # iid per-round drop probability
    p_drop_n: int = 0  # erased / straggler device count (onoff, adversarial)
    p_period: int = 4  # onoff duty-cycle window (rounds)
    p_duty: float = 0.5  # onoff fraction of the window a straggler reports

    def protocol(self) -> ProtocolConfig:
        return ProtocolConfig(
            n_devices=self.n_devices,
            d=self.d,
            method=self.method,
            aggregator=self.aggregator,
            trim_frac=self.trim_frac,
            n_byz=self.n_byz,
            attack=AttackSpec(self.attack, n_byz=self.n_byz),
            compression=spec_from(
                self.compressor, q_hat_frac=self.q_hat_frac, levels=self.quant_levels
            ),
            participation=ParticipationSpec(
                self.participation,
                rate=self.p_rate,
                n_drop=self.p_drop_n,
                period=self.p_period,
                duty=self.p_duty,
                # worst-case erasure hits honest rows: the Byzantine block
                # (rows [0, n_byz) under fixed identities) keeps reporting
                offset=self.n_byz if self.participation == "adversarial" else 0,
            ),
        )


def scenario_name(
    method: str, d: int, aggregator: str, attack: str, compressor: str, sigma_h: float
) -> str:
    comp = "" if compressor == "none" else f"/{compressor}"
    return f"{method}-d{d}/{aggregator}/{attack}{comp}/s{sigma_h:g}"


def section7_grid(
    methods: Sequence[tuple[str, int]] = (("plain", 1), ("lad", 10), ("draco", 4)),
    attacks: Sequence[str] = ("sign_flip", "alie", "ipm"),
    aggregators: Sequence[str] = ("cwtm",),
    compressors: Sequence[str] = ("none", "rand_sparse"),
    sigma_levels: Sequence[float] = (0.3,),
    n_devices: int = 100,
    n_byz: int = 20,
    lr: float = 1e-6,
) -> list[Scenario]:
    """The paper's Section-VII comparison grid as a flat list of rows.

    DRACO is incompatible with compression (Section VII.B), so its rows
    appear only with ``compressor="none"``; its ``N`` is rounded down to a
    multiple of ``d`` (fractional repetition needs ``d | N``), and its
    aggregator axis collapses to one row named ``"vote"`` (the decode is
    the server). The defaults give 15 rows."""
    rows = []
    seen = set()
    for method, d in methods:
        for attack in attacks:
            for agg in aggregators:
                for comp in compressors:
                    if method == "draco" and comp != "none":
                        continue
                    for sigma in sigma_levels:
                        draco = method == "draco"
                        name = scenario_name(method, d, "vote" if draco else agg, attack, comp, sigma)
                        if name in seen:
                            continue
                        seen.add(name)
                        rows.append(Scenario(
                            name=name, method=method, d=d, aggregator="mean" if draco else agg,
                            attack=attack, n_byz=n_byz, compressor=comp, sigma_h=sigma,
                            n_devices=n_devices - n_devices % d if draco else n_devices, lr=lr,
                        ))
    return rows


def _fig4(label: str, method: str, d: int, agg: str, **kw) -> Scenario:
    return Scenario(name=label, method=method, d=d, aggregator=agg,
                    attack="sign_flip", n_byz=20, sigma_h=0.3, lr=1e-6, **kw)


# Fig. 4: training loss under sign-flip(-2), H=80, sigma_H=0.3.
PAPER_FIG4 = {
    "VA": _fig4("VA", "plain", 1, "mean"),
    "CWTM": _fig4("CWTM", "plain", 1, "cwtm"),
    "CWTM-NNM": _fig4("CWTM-NNM", "plain", 1, "cwtm-nnm"),
    "LAD-CWTM-d5": _fig4("LAD-CWTM-d5", "lad", 5, "cwtm"),
    "LAD-CWTM-d10": _fig4("LAD-CWTM-d10", "lad", 10, "cwtm"),
    "LAD-CWTM-d20": _fig4("LAD-CWTM-d20", "lad", 20, "cwtm"),
    "LAD-CWTM-NNM-d10": _fig4("LAD-CWTM-NNM-d10", "lad", 10, "cwtm-nnm"),
    # N=82: two groups of 41, cut from the shared N=100 problem
    "DRACO-d41": _fig4("DRACO-d41", "draco", 41, "mean", n_devices=82),
}

# Fig. 5: heterogeneity sweep — the LAD advantage grows with sigma_H.
PAPER_FIG5 = {
    f"{label}-s{sigma:g}": Scenario(
        name=f"{label}-s{sigma:g}", method=method, d=d, aggregator="cwtm",
        attack="sign_flip", n_byz=20, sigma_h=sigma, lr=1e-6,
    )
    for sigma in (0.0, 0.1)
    for label, method, d in (("CWTM", "plain", 1), ("LAD-CWTM-d10", "lad", 10))
}


def _fig6(label: str, method: str, d: int, agg: str) -> Scenario:
    return Scenario(name=label, method=method, d=d, aggregator=agg,
                    attack="sign_flip", n_byz=30, compressor="rand_sparse",
                    q_hat_frac=0.3, sigma_h=0.3, lr=3e-7)


# Fig. 6: compressed communication — random sparsification Q_hat=30, H=70, d=3.
PAPER_FIG6 = {
    "Com-VA": _fig6("Com-VA", "plain", 1, "mean"),
    "Com-CWTM": _fig6("Com-CWTM", "plain", 1, "cwtm"),
    "Com-CWTM-NNM": _fig6("Com-CWTM-NNM", "plain", 1, "cwtm-nnm"),
    "Com-TGN": _fig6("Com-TGN", "plain", 1, "tgn"),
    "Com-LAD-CWTM": _fig6("Com-LAD-CWTM", "lad", 3, "cwtm"),
    "Com-LAD-CWTM-NNM": _fig6("Com-LAD-CWTM-NNM", "lad", 3, "cwtm-nnm"),
}


def participation_sweep(
    *,
    method: str = "lad",
    d: int = 4,
    n_devices: int = 16,
    n_byz: int = 0,
    schedules: Sequence[str] = ("iid", "onoff", "adversarial"),
    aggregators: Sequence[str] = ("decode", "mean"),
    attacks: Sequence[str] = ("sign_flip",),
    rate: float = 0.25,
    n_drop: int | None = None,
    period: int = 4,
    duty: float = 0.5,
    base_lr: float = 1e-5,
) -> list[Scenario]:
    """The partial-participation rows: schedule x aggregator x attack over
    the cyclic code at margin ``erasure_margin(d) = d - 1``.

    ``n_drop`` (erased / straggler devices of the deterministic schedules)
    defaults to the whole margin, the worst erasure the code still decodes
    exactly. The default aggregators are the contrast: ``"decode"`` (the
    K-of-N erasure decode) against ``"mean"`` (erased rows imputed, the code
    unused)."""
    if method == "draco":
        raise ValueError("participation_sweep targets the cyclic code; DRACO has its own masked decoder")
    if n_devices % d != 0:
        raise ValueError(
            f"participation rows need d | N (the erasure decode's offset classes must tile "
            f"the subset circle): N={n_devices} d={d}"
        )
    drop = erasure_margin(d) if n_drop is None else n_drop
    rows = []
    for sched in schedules:
        if sched not in ("iid", "onoff", "adversarial", "markov"):
            raise ValueError(
                f"unknown participation schedule {sched!r} for a sweep row "
                "('full' rows are the plain figures; 'external' masks come from the caller)"
            )
        for agg in aggregators:
            for i_a, attack in enumerate(attacks):
                rows.append(Scenario(
                    name=f"part/{sched}/{agg}/{attack}", method=method, d=d, aggregator=agg,
                    attack=attack, n_byz=n_byz, n_devices=n_devices,
                    lr=base_lr * (1.0 + 0.1 * i_a), participation=sched, p_rate=rate,
                    p_drop_n=drop, p_period=period, p_duty=duty,
                ))
    return rows


def _subset_grads(data, x):
    z, y = data
    return linreg_subset_grads(z, y, x)


def _loss(data, xs):
    z, y = data
    return linreg_loss(z, y, xs)


def run_scenario(
    scn: Scenario,
    steps: int,
    *,
    seed: int = 0,
    problem: tuple[torch.Tensor, torch.Tensor] | None = None,
    dim: int = 100,
    randomness: RandomnessProvider | None = None,
    device: torch.device | str | None = None,
    mode: str = "loop",
) -> TrajectoryResult:
    """Run one scenario on the Section-VII linear-regression problem.

    One ``torch.Generator`` on the run's device, seeded with ``seed``, draws
    the problem (unless ``problem`` shares one ``(Z, y)`` across scenarios;
    it is cut to ``scn.n_devices`` subsets) and then each round's
    randomness (unless ``randomness`` provides it; its records are checked
    as they come in, see ``run_trajectory``). ``mode`` is
    ``run_trajectory``'s: ``"loop"`` or ``"graph"`` (one captured round
    replayed, CUDA only).
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = scn.n_devices
    if problem is None:
        z, y = linear_regression_problem(gen, n=n, dim=dim, sigma_h=scn.sigma_h)
    else:
        z, y = problem
        if z.shape[0] < n:
            raise ValueError(
                f"shared problem has {z.shape[0]} subsets < n_devices={n} of scenario {scn.name!r}"
            )
        z, y = z[:n].to(dev), y[:n].to(dev)
    cfg = scn.protocol()
    return run_trajectory(
        cfg,
        torch.zeros(z.shape[1], dtype=torch.float32, device=dev),
        _subset_grads,
        steps=steps,
        lr=scn.lr,
        randomness=randomness if randomness is not None else gen,
        # the aggregate estimates (1/N) grad F; eq. (7) steps on F
        grad_scale=float(n),
        loss_fn=_loss,
        data=(z, y),
        device=dev,
        mode=mode,
    )
