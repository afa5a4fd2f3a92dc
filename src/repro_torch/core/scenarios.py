"""The paper's Section-VII conditions and the function that runs one.

  * ``Scenario`` — one declarative row; ``.protocol()`` lowers it to a
    ``ProtocolConfig``.
  * ``PAPER_FIG4/5/6`` — the named curves of Figs. 4-6.
  * ``section7_grid`` — the paper's comparison grid: method x attack x
    aggregator x compressor x heterogeneity, with the combinations the paper
    rules out dropped.
  * ``participation_sweep`` — the partial-participation rows: schedule x
    aggregator x attack over the cyclic code.
  * ``synthetic_sweep`` — one bucket of any number of rows (the scaling
    studies' 1000-lane sweeps).
  * ``run_scenario`` — a scenario on the linear-regression problem.
  * ``run_grid`` — many scenarios at once: rows that share their static
    structure run as the lanes of one batched round (``engine.run_grid``),
    one compile bucket at a time; ``grid_finals`` sums a sweep up.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.core.attacks import AttackSpec
from repro_torch.core import engine as engine_lib
from repro_torch.core.byzantine import ProtocolConfig, draw_signature
from repro_torch.core.coding import erasure_margin
from repro_torch.core.compression import spec_from
from repro_torch.core.participation import ParticipationSpec
from repro_torch.core.engine import RandomnessProvider, TrajectoryResult
from repro_torch.data.synthetic import linear_regression_problem, linreg_loss, linreg_subset_grads
from repro_torch.device import resolve_device

__all__ = ["Scenario", "scenario_name", "section7_grid", "PAPER_FIG4", "PAPER_FIG5", "PAPER_FIG6",
           "participation_sweep", "synthetic_sweep", "run_scenario", "run_grid", "grid_finals"]


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


def synthetic_sweep(
    n_rows: int,
    *,
    method: str = "lad",
    d: int = 4,
    aggregator: str = "cwtm",
    n_devices: int = 16,
    n_byz: int = 3,
    attacks: Sequence[str] = ("sign_flip", "alie", "ipm"),
    compressor: str = "none",
    base_lr: float = 1e-5,
) -> list[Scenario]:
    """One compile bucket of ``n_rows`` rows, the workload of the scaling
    studies (1000-row sweeps): every row shares the static protocol
    structure and varies along the per-lane axes only, the attack (cycled),
    the step size and the data's heterogeneity (both swept densely), so
    every lane is a distinct trajectory."""
    if n_rows < 1:
        raise ValueError(f"n_rows must be >= 1, got {n_rows}")
    rows = []
    for i in range(n_rows):
        frac = i / max(1, n_rows - 1)
        attack = attacks[i % len(attacks)]
        rows.append(Scenario(
            name=f"syn{i:05d}/{attack}", method=method, d=d, aggregator=aggregator, attack=attack,
            n_byz=n_byz, compressor=compressor, sigma_h=round(0.05 + 0.45 * frac, 6),
            n_devices=n_devices, lr=base_lr * (0.5 + frac),
        ))
    return rows


def _lane_setup(scn: Scenario, *, seed: int, problem, dim: int,
                device: torch.device) -> tuple[torch.Generator, tuple[torch.Tensor, torch.Tensor]]:
    """A scenario's generator (on ``device``, seeded ``seed``) and the
    ``(Z, y)`` it trains on: drawn from that generator at the scenario's
    heterogeneity, or the shared ``problem`` cut to ``scn.n_devices``
    subsets. ``run_scenario`` and every lane of ``run_grid`` start here, so
    the two cannot drift apart; the rounds draw on from the generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = scn.n_devices
    if problem is None:
        return gen, linear_regression_problem(gen, n=n, dim=dim, sigma_h=scn.sigma_h)
    z, y = problem
    if z.shape[0] < n:
        raise ValueError(
            f"shared problem has {z.shape[0]} subsets < n_devices={n} of scenario {scn.name!r}"
        )
    return gen, (z[:n].to(device), y[:n].to(device))


def _subset_grads(data, x):
    z, y = data
    return linreg_subset_grads(z, y, x)


def _loss(data, xs):
    """Losses of iterates (rounds, Q) on one problem, or (lanes, rounds, Q)
    on a shared problem or one problem per lane."""
    z, y = data
    if z.ndim == 3:
        z, y = z[:, None], y[:, None]
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
    gen, (z, y) = _lane_setup(scn, seed=seed, problem=problem, dim=dim, device=dev)
    return engine_lib.run_trajectory(
        scn.protocol(),
        torch.zeros(z.shape[1], dtype=torch.float32, device=dev),
        _subset_grads,
        steps=steps,
        lr=scn.lr,
        randomness=randomness if randomness is not None else gen,
        # the aggregate estimates (1/N) grad F; eq. (7) steps on F
        grad_scale=float(scn.n_devices),
        loss_fn=_loss,
        data=(z, y),
        device=dev,
        mode=mode,
    )


def _bucket_signature(scn: Scenario, exact: bool = True) -> tuple:
    """Everything that fixes a round's static structure: rows that agree on
    it run as lanes of one batched round. The attack, the step size and the
    heterogeneity stay per lane; with ``exact=False`` the aggregator too (a
    bucket then holds several servers, each on its run of lanes, and every
    lane stays bitwise equal to its standalone run). ``exact=True`` keeps
    one aggregator a bucket, as the reference does."""
    return (
        scn.method,
        scn.d,
        scn.n_devices,
        scn.n_byz,
        scn.trim_frac,
        scn.compressor,
        scn.q_hat_frac,
        scn.quant_levels,
        # an active schedule adds a state to the round and changes the server
        scn.participation,
        scn.p_rate,
        scn.p_drop_n,
        scn.p_period,
        scn.p_duty,
    ) + ((scn.aggregator,) if exact else ())


def _run_bucket(group: list[Scenario], steps: int, *, seed: int, problem, dim: int, device: torch.device,
                mode: str, max_lanes_per_device, randomness) -> dict[str, TrajectoryResult]:
    """One compile bucket as one ``engine.run_grid`` call.

    Every lane's problem and generator come from ``_lane_setup``, as
    ``run_scenario``'s do. Lanes that draw alike (``draw_signature``) read
    one draw group, drawn from its first lane's generator (every lane's
    generator is seeded alike and has drawn alike); a lane that
    ``randomness`` gives a provider draws from it alone."""
    setups = [_lane_setup(s, seed=seed, problem=problem, dim=dim, device=device) for s in group]
    cfgs = [s.protocol() for s in group]
    groups: dict[object, int] = {}
    sources = []
    draw_ids = []
    for lane, (scn, cfg) in enumerate(zip(group, cfgs)):
        provider = None if randomness is None else randomness(scn)
        key = ("lane", lane) if provider is not None else draw_signature(cfg)
        if key not in groups:
            groups[key] = len(sources)
            sources.append(provider if provider is not None else setups[lane][0])
        draw_ids.append(groups[key])
    if problem is not None:
        data, batched = setups[0][1], False
    else:
        data, batched = tuple(torch.stack(parts) for parts in zip(*(p for _, p in setups))), True
    res = engine_lib.run_grid(
        cfgs, torch.zeros(data[0].shape[-1], dtype=torch.float32, device=device), _subset_grads,
        steps=steps, lr=[s.lr for s in group], randomness=sources, draw_ids=draw_ids, data=data,
        data_batched=batched, grad_scale=float(group[0].n_devices), loss_fn=_loss,
        max_lanes_per_device=max_lanes_per_device, device=device, mode=mode)
    return {s.name: res.lane(i) for i, s in enumerate(group)}


def run_grid(
    scenarios: Sequence[Scenario],
    steps: int,
    *,
    seed: int = 0,
    problem: tuple[torch.Tensor, torch.Tensor] | None = None,
    dim: int = 100,
    mode: str = "graph",
    exact: bool = True,
    max_lanes_per_device: int | str | None = None,
    randomness: Callable[[Scenario], RandomnessProvider | None] | None = None,
    device: torch.device | str | None = None,
) -> dict[str, TrajectoryResult]:
    """Run many scenarios; returns ``{name: TrajectoryResult}`` in input
    order (``grid_finals`` sums it up).

    The rows are grouped into compile buckets by static structure
    (method, d, N, Byzantine count, trim, compressor, participation, and
    with ``exact=True`` the aggregator), and each bucket's rows run as the
    lanes of one batched round (``engine.run_grid``): each kernel one launch
    over the bucket's lanes, each attack and server one call over its run of
    lanes. ``mode`` is how a bucket's rounds run: ``"graph"`` (the default:
    one round captured as a CUDA graph and replayed, CUDA only) or
    ``"loop"``. ``section7_grid()``'s 15 rows run as 5 buckets. Every lane
    equals ``run_scenario`` of its row with the same seed bit for bit, with
    ``exact`` either way; ``run_scenario`` row by row is the reference a
    grid is held to.

    ``max_lanes_per_device`` streams a bucket through equal chunks of that
    many lanes (bitwise equal to unchunked); ``"auto"`` waits for the
    lane-capacity tuner (ROADMAP A.11) and raises.

    ``randomness`` maps a row to its round provider (replaying another
    trainer's draws), or to ``None`` for the row's own seeded generator,
    which every row draws from by default, as ``run_scenario`` does.
    """
    scns = list(scenarios)
    dev = resolve_device(device)
    if not scns:
        raise ValueError("run_grid needs at least one scenario")
    buckets: dict[tuple, list[Scenario]] = {}
    for s in scns:
        buckets.setdefault(_bucket_signature(s, exact=exact), []).append(s)
    out: dict[str, TrajectoryResult] = {}
    for group in buckets.values():
        out.update(_run_bucket(group, steps, seed=seed, problem=problem, dim=dim, device=dev,
                               mode=mode, max_lanes_per_device=max_lanes_per_device,
                               randomness=randomness))
    return {s.name: out[s.name] for s in scns}


def grid_finals(results: dict[str, TrajectoryResult]) -> dict[str, dict[str, float]]:
    """``{name: {final_loss, final_agg_dist}}`` of a ``run_grid`` result,
    the summary row of the benchmark scripts."""
    return {
        name: {"final_loss": float(res.metrics["loss"][-1]),
               "final_agg_dist": float(res.metrics["agg_dist"][-1])}
        for name, res in results.items()
    }
