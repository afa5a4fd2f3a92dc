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
  * ``lm_sweep`` / ``run_lm_scenario`` / ``run_lm_grid`` — the same matrix
    at LM scale: the iterate is a transformer's flattened fp32 parameter
    vector (``lm_arch`` by default), each subset's gradient its full-model
    gradient on the subset's tokens.
  * ``fleet_chaos_cases`` / ``fleet_comlad_cases`` — the fleet's fault
    schedules and uplink compressors, as plain-data rows
    (``launch/fleet.py``).
  * ``ZOO_FAMILIES`` / ``zoo_arch`` / ``zoo_sweep`` / ``run_zoo_sweep`` —
    the LM matrix over the model zoo: dense, Jamba's Mamba-MoE hybrid,
    RWKV-6, MoE, sliding-window, cross-attention and the whisper
    encoder-decoder, each at the ``lm_arch`` scale.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Sequence

import torch

from repro_torch import models, pytree
from repro_torch.core.attacks import AttackSpec
from repro_torch.core import engine as engine_lib
from repro_torch.core.byzantine import ProtocolConfig, draw_signature
from repro_torch.core.coding import erasure_margin, flatten_pytree, unflatten_pytree
from repro_torch.core.compression import spec_from
from repro_torch.core.participation import ParticipationSpec
from repro_torch.core.engine import RandomnessProvider, TrajectoryResult
from repro_torch.data.synthetic import (
    linear_regression_problem,
    linreg_loss,
    linreg_subset_grads,
    lm_batch_for_devices,
)
from repro_torch.device import resolve_device

__all__ = ["Scenario", "scenario_name", "section7_grid", "PAPER_FIG4", "PAPER_FIG5", "PAPER_FIG6",
           "participation_sweep", "synthetic_sweep", "run_scenario", "least_squares", "run_grid", "grid_finals",
           "grid_launch_list",
           "lm_arch", "lm_sweep", "run_lm_scenario", "run_lm_grid", "ZOO_FAMILIES", "zoo_arch", "zoo_sweep",
           "run_zoo_sweep", "fleet_chaos_cases", "fleet_comlad_cases"]


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
    with_sol_err: bool = False,
) -> TrajectoryResult:
    """Run one scenario on the Section-VII linear-regression problem.

    One ``torch.Generator`` on the run's device, seeded with ``seed``, draws
    the problem (unless ``problem`` shares one ``(Z, y)`` across scenarios;
    it is cut to ``scn.n_devices`` subsets) and then each round's
    randomness (unless ``randomness`` provides it; its records are checked
    as they come in, see ``run_trajectory``). ``mode`` is
    ``run_trajectory``'s: ``"loop"`` or ``"graph"`` (one captured round
    replayed, CUDA only). ``with_sol_err`` adds the metric ``sol_err``,
    ``||x_t - x*||`` to the least-squares solution of ``(Z, y)``
    (``least_squares``).
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
        x_star=least_squares(z, y) if with_sol_err else None,
        data=(z, y),
        device=dev,
        mode=mode,
    )


def least_squares(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The minimum-norm least-squares solution ``x*`` of ``Z x = y``, as
    float32 on ``z``'s device.

    Solved in float64 on the CPU, where ``torch.linalg.lstsq`` factors with
    LAPACK's ``gelsy`` (a complete orthogonal factorization: the
    minimum-norm solution, of the wide ``(82, 100)`` system of the
    DRACO-d41 rows too). On CUDA, ``lstsq`` takes only a tall ``Z`` of full
    rank. The reference solves in float32 (``jnp.linalg.lstsq``, an SVD),
    so the two ``x*`` differ by the float32 solve's error."""
    sol = torch.linalg.lstsq(z.detach().cpu().double(), y.detach().cpu().double()[:, None])
    return sol.solution[:, 0].to(torch.float32).to(z.device)


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


@dataclasses.dataclass(frozen=True)
class _BucketProblem:
    """What one compile bucket trains on, so that the linear-regression grid
    and the LM grid share ``_run_bucket``: the engine's gradient and loss
    hooks, the initial iterate, the data (one per lane when
    ``data_batched``) and the aggregate's scale."""

    subset_grad_fn: Callable
    loss_fn: Callable
    x0: torch.Tensor
    data: Any
    data_batched: bool
    grad_scale: float


def _bucket_sources(group: list[Scenario], gens: list[torch.Generator], randomness) -> tuple[list, list, list]:
    """(the lanes' configurations, the draw groups' sources, each lane's
    draw group) of a bucket; see ``_run_bucket``."""
    cfgs = [s.protocol() for s in group]
    groups: dict[object, int] = {}
    sources = []
    draw_ids = []
    for lane, (scn, cfg) in enumerate(zip(group, cfgs)):
        provider = None if randomness is None else randomness(scn)
        key = ("lane", lane) if provider is not None else draw_signature(cfg)
        if key not in groups:
            groups[key] = len(sources)
            sources.append(provider if provider is not None else gens[lane])
        draw_ids.append(groups[key])
    return cfgs, sources, draw_ids


def _run_bucket(group: list[Scenario], steps: int, prob: _BucketProblem, gens: list[torch.Generator], *,
                device: torch.device, mode: str, max_lanes_per_device, randomness, shard: str = "none",
                data_group: Any = None) -> dict[str, TrajectoryResult]:
    """One compile bucket as one ``engine.run_grid`` call.

    ``gens[i]`` is lane ``i``'s generator, seeded and advanced as its
    standalone run's. Lanes that draw alike (``draw_signature``) read one
    draw group, drawn from its first lane's generator (every lane's
    generator is seeded alike and has drawn alike); a lane that
    ``randomness`` gives a provider draws from it alone."""
    cfgs, sources, draw_ids = _bucket_sources(group, gens, randomness)
    res = engine_lib.run_grid(
        cfgs, prob.x0, prob.subset_grad_fn, steps=steps, lr=[s.lr for s in group], randomness=sources,
        draw_ids=draw_ids, data=prob.data, data_batched=prob.data_batched, grad_scale=prob.grad_scale,
        loss_fn=prob.loss_fn, shard=shard, group=data_group, max_lanes_per_device=max_lanes_per_device,
        device=device, mode=mode)
    return {s.name: res.lane(i) for i, s in enumerate(group)}


def _linreg_bucket(group: list[Scenario], *, seed: int, problem, dim: int,
                   device: torch.device) -> tuple[_BucketProblem, list[torch.Generator]]:
    """The linear-regression problem of one bucket and its lanes'
    generators, each lane set up by ``_lane_setup`` as ``run_scenario``'s."""
    setups = [_lane_setup(s, seed=seed, problem=problem, dim=dim, device=device) for s in group]
    if problem is not None:
        data, batched = setups[0][1], False
    else:
        data, batched = tuple(torch.stack(parts) for parts in zip(*(p for _, p in setups))), True
    x0 = torch.zeros(data[0].shape[-1], dtype=torch.float32, device=device)
    # the aggregate estimates (1/N) grad F; eq. (7) steps on F
    prob = _BucketProblem(_subset_grads, _loss, x0, data, batched, float(group[0].n_devices))
    return prob, [gen for gen, _ in setups]


def run_grid(
    scenarios: Sequence[Scenario],
    steps: int,
    *,
    seed: int = 0,
    problem: tuple[torch.Tensor, torch.Tensor] | None = None,
    dim: int = 100,
    mode: str = "graph",
    exact: bool = True,
    shard: str = "none",
    group: Any = None,
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
    many lanes (bitwise equal to unchunked); ``"auto"`` lets the
    lane-capacity tuner pick it per bucket (``engine.run_grid``: the
    store's capacity, else probes of one chunk, then stored), with the same
    bits as any capacity. ``shard``
    (``"shard_map"`` or ``"pmap"``) spreads each bucket's lanes over the
    ranks of the data ``group`` (``engine.run_grid``): every rank makes the
    same call and returns every row, each bit for bit its unsharded run.

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
    for bucket in buckets.values():
        prob, gens = _linreg_bucket(bucket, seed=seed, problem=problem, dim=dim, device=dev)
        out.update(_run_bucket(bucket, steps, prob, gens, device=dev, mode=mode, shard=shard, data_group=group,
                               max_lanes_per_device=max_lanes_per_device, randomness=randomness))
    return {s.name: out[s.name] for s in scns}


def grid_launch_list(
    scenarios: Sequence[Scenario],
    steps: int,
    *,
    seed: int = 0,
    problem: tuple[torch.Tensor, torch.Tensor] | None = None,
    dim: int = 100,
    mode: str = "graph",
    exact: bool = True,
    shard: str = "none",
    group: Any = None,
    max_lanes_per_device: int | str | None = None,
    device: torch.device | str | None = None,
) -> dict[str, list[dict]]:
    """The kernel launches of one captured round of the chunk a
    same-arguments ``run_grid`` call runs, per kernel, each with its bytes
    and fp32 operations: the scenario-level face of
    ``engine.grid_launch_list``, the counterpart of the reference's
    ``grid_compiled_hlo`` (``launch.roofline.analyze_launches`` reads it).

    The rows must form ONE compile bucket (e.g. a ``synthetic_sweep``): a
    sweep of several buckets has one round per bucket and no single round
    to list."""
    scns = list(scenarios)
    buckets: dict[tuple, list[Scenario]] = {}
    for s in scns:
        buckets.setdefault(_bucket_signature(s, exact=exact), []).append(s)
    if len(buckets) != 1:
        raise ValueError(f"grid_launch_list needs a single compile bucket, got {len(buckets)}: list each "
                         "bucket's rows separately")
    (rows,) = buckets.values()
    dev = resolve_device(device)
    prob, gens = _linreg_bucket(rows, seed=seed, problem=problem, dim=dim, device=dev)
    cfgs, sources, draw_ids = _bucket_sources(rows, gens, None)
    return engine_lib.grid_launch_list(
        cfgs, prob.x0, prob.subset_grad_fn, steps=steps, lr=[s.lr for s in rows], randomness=sources,
        draw_ids=draw_ids, data=prob.data, data_batched=prob.data_batched, grad_scale=prob.grad_scale,
        loss_fn=prob.loss_fn, shard=shard, group=group, max_lanes_per_device=max_lanes_per_device,
        device=dev, mode=mode)


def grid_finals(results: dict[str, TrajectoryResult]) -> dict[str, dict[str, float]]:
    """``{name: {final_loss, final_agg_dist}}`` of a ``run_grid`` result,
    the summary row of the benchmark scripts."""
    return {
        name: {"final_loss": float(res.metrics["loss"][-1]),
               "final_agg_dist": float(res.metrics["agg_dist"][-1])}
        for name, res in results.items()
    }


def fleet_chaos_cases(procs: int = 3, steps: int = 8) -> list[dict]:
    """The fleet's chaos-conformance row-family: one seeded fault schedule
    per failure mode of the self-healing transport (``launch/chaos.py``).

    Declarative plain-data rows (no launch import: the registry stays
    engine-side): each case is ``{"name", "chaos", "within_margin"}`` where
    ``chaos`` is a ``launch.chaos.parse_chaos`` schedule dict.  Every
    default case keeps per-round erasures within ``erasure_margin(d)`` for
    the bench's N=6 / d=3 / 2-rows-per-block geometry — one faulted worker
    block is exactly the margin — so the K-of-N decode keeps recovering the
    full gradient and the final loss must sit inside the erasure-decode
    envelope (``benchmarks/fleet_bench.py`` asserts it).

    ``partition_rejoin`` pads every round with a small honest ``delay`` on
    worker 1 so the round cadence is slow enough for worker ``procs-1``'s
    0.5 s partition to heal while training is still running — the rejoin
    path is the subject under test, not a race.
    """
    if procs < 3:
        raise ValueError(f"chaos cases need >= 2 workers (procs >= 3), got {procs}")
    w1, w2 = 1, procs - 1
    return [
        {"name": "healthy", "within_margin": True,
         "chaos": {"seed": 0, "faults": []}},
        {"name": "dup", "within_margin": True,
         "chaos": {"seed": 1, "faults": [
             {"op": "dup", "proc": w1, "rounds": [1, 2, 3]}]}},
        {"name": "corrupt", "within_margin": True,
         "chaos": {"seed": 2, "faults": [
             {"op": "corrupt", "proc": w2, "rounds": [2, 3]}]}},
        {"name": "drop", "within_margin": True,
         "chaos": {"seed": 3, "faults": [
             {"op": "drop", "proc": w2, "rounds": [2]}]}},
        {"name": "delay", "within_margin": True,
         "chaos": {"seed": 4, "faults": [
             {"op": "delay", "proc": w1, "rounds": [1, 2], "arg": 0.2}]}},
        {"name": "partition_rejoin", "within_margin": True,
         "chaos": {"seed": 5, "faults": [
             {"op": "delay", "proc": w1, "rounds": list(range(steps)), "arg": 0.25},
             {"op": "partition", "proc": w2, "rounds": [2], "arg": 0.5}]}},
    ]


def fleet_comlad_cases(procs: int = 3, steps: int = 8) -> list[dict]:
    """The fleet's Com-LAD-over-the-wire row family: one case per uplink
    compression spec, measured on the real TCP data plane.

    Declarative plain-data rows (no launch import): each case is
    ``{"name", "compress", "min_ratio", "within_envelope"}``.  ``compress``
    is the registry spelling (``CompressionSpec.parse``); ``min_ratio`` is
    the minimum measured uplink bytes/round reduction vs the identity case
    that ``benchmarks/fleet_bench.py`` enforces; ``within_envelope`` asserts
    the final loss lands within the erasure-decode envelope of the identity
    fleet — claimed only for identity and quant (the sparse family at 25%
    keep has 4x-scaled unbiased variance, and top_k is biased, so their
    trajectories legitimately drift beyond float noise).  The headline
    row is ``quant4`` — the paper's 4-level QSGD at >= 4x fewer uplink
    bytes/round.  ``quant4_chaos_byz`` additionally runs the compressed
    uplink under ``byz_payload`` + ``corrupt`` chaos faults: both must land
    as tallied per-round erasures of the compressed frames, never a crash.
    """
    if procs < 3:
        raise ValueError(f"comlad cases need >= 2 workers (procs >= 3), got {procs}")
    w1, w2 = 1, procs - 1
    return [
        {"name": "identity", "compress": "identity",
         "min_ratio": 1.0, "within_envelope": True, "chaos": None},
        {"name": "quant4", "compress": "quant:4",
         "min_ratio": 4.0, "within_envelope": True, "chaos": None},
        {"name": "quant8", "compress": "quant:8",
         "min_ratio": 3.0, "within_envelope": True, "chaos": None},
        {"name": "randk16", "compress": "randk:16",
         "min_ratio": 1.5, "within_envelope": False, "chaos": None},
        {"name": "randk_shared16", "compress": "randk_shared:16",
         "min_ratio": 1.5, "within_envelope": False, "chaos": None},
        {"name": "topk16", "compress": "topk:16",
         "min_ratio": 1.5, "within_envelope": False, "chaos": None},
        {"name": "quant4_chaos_byz", "compress": "quant:4",
         "min_ratio": 0.0, "within_envelope": False,
         "chaos": {"seed": 6, "faults": [
             {"op": "byz_payload", "proc": w1, "rounds": [2, 3]},
             {"op": "corrupt", "proc": w2, "rounds": [3]}]}},
    ]


# --------------------------------------------------------------------------
# The LM scale: the same matrix, each lane training a transformer.
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def lm_arch():
    """The small transformer of the LM sweeps: smollm-360m's family (3:1
    GQA, tied embeddings) cut to 1 layer, d_model=32, vocab=64, as the
    reference's ``lm_arch``. Cached, so every caller shares one config
    (and with it ``_lm_fns``'s cached problem)."""
    from repro_torch.configs.archs import ARCHS, reduced

    return reduced(ARCHS["smollm-360m"]).scaled(
        n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64, vocab=64,
    )


class _LMFns(NamedTuple):
    x0: torch.Tensor
    spec: tuple
    subset_grad_fn: Callable
    loss_fn: Callable


_DATA_KEYS = ("tokens", "labels", "frontend")  # an LM problem's leaves, in order


@functools.lru_cache(maxsize=16)
def _lm_fns(arch) -> _LMFns:
    """(x0, spec, subset_grad_fn, loss_fn) of the LM problem of ``arch``.

    ``x0`` is the model's flattened parameter vector, initialised from a
    CPU generator seeded 0 (the same on every device) in the arch's dtype
    and widened to float32, as the reference's ``_lm_fns`` does from
    ``PRNGKey(0)``; it lies on the CPU. ``spec`` is its
    ``flatten_pytree`` spec. The cache pins ``x0`` and the closures of up to
    16 archs, as the reference's does: the whole ``ZOO_FAMILIES`` zoo and
    the LM sweeps' arch at once, so a ``run_zoo_sweep`` builds each x0
    once. ``_lm_fns.cache_clear()`` releases them.

    ``data`` is the problem ``(tokens, labels)``, ``(N, rows, S)`` each,
    and for the vlm and audio families a third leaf, the frontend
    embeddings ``(N, rows, n_frontend_tokens, d_frontend)``.

    ``subset_grad_fn(data, x)``: ``x`` ``(l, P)`` iterates of ``l`` lanes;
    returns the ``(l, N, P)`` stack of every subset's gradient
    at every lane's iterate (``(N, P)`` for one ``(P,)`` iterate). Each lane is its own step: its iterate copied
    (so its views start where a one-lane run's do), the gradients of all N
    subsets from one ``torch.func.vmap`` of the loss's gradient, taken
    through the per-period form of the tree (``unstack_periods``), and each
    leaf written straight into its slice of the lane's rows of the stack.
    A lane thus sees exactly the shapes of a one-lane run, whatever the
    lane count, and its bits do not depend on it. The gradient is the
    loss's ``torch.func.vjp`` pulled back without building a graph of the
    backward (``create_graph=False``): ``torch.func.grad`` builds one, which
    keeps every layer's backward intermediates alive until the call
    returns (whisper-small's 1500-frame encoder at 8 subsets did not fit an
    80 GB card that way).

    ``loss_fn(data, xs)``: the mean next-token loss over all subsets' rows
    at each iterate of ``xs`` ``(..., P)``, one forward pass an iterate.
    """
    params0, _ = models.init(torch.Generator().manual_seed(0), arch)
    x0, spec = flatten_pytree(pytree.map_tree(lambda a: a.to(torch.float32), params0))
    del params0
    unstack = models.transformer.unstack_periods
    n_leaves = 3 if arch.family in models.transformer.FRONTEND_FAMILIES else 2

    def subset_grad(params, *data):
        loss, pullback = torch.func.vjp(
            lambda p: models.loss_fn(p, None, arch, dict(zip(_DATA_KEYS, data)))[0], params)
        return pullback(torch.ones_like(loss), retain_graph=False, create_graph=False)[0]

    per_subset = torch.func.vmap(subset_grad, in_dims=(None,) + (0,) * n_leaves)

    def lm_subset_grads(data, x):
        if x.ndim == 1:  # one iterate (P,): the (N, P) stack
            return lm_subset_grads(data, x[None])[0]
        out = x.new_empty((x.shape[0], data[0].shape[0], x.shape[-1]))
        for i in range(x.shape[0]):
            grads = per_subset(unstack(unflatten_pytree(x[i].clone(), spec)), *data)
            rows = unstack(unflatten_pytree(out[i], spec), lead=1)
            for g, dst in zip(pytree.leaves(grads), pytree.leaves(rows)):
                dst.copy_(g)
            del grads
        return out

    def lm_loss(data, xs):
        batch = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in zip(_DATA_KEYS, data)}
        flat = xs.reshape(-1, xs.shape[-1])
        with torch.no_grad():
            losses = [models.loss_fn(unflatten_pytree(flat[j].clone(), spec), None, arch, batch)[0]
                      for j in range(flat.shape[0])]
        return torch.stack(losses).reshape(xs.shape[:-1])

    return _LMFns(x0, spec, lm_subset_grads, lm_loss)


def _lm_problem(arch, *, seed: int, n_subsets: int, sigma_h: float, per_subset: int, seq_len: int,
                device: torch.device) -> tuple[torch.Tensor, ...]:
    """The heterogeneous-LM ``(tokens, labels)`` of one run, ``(N,
    per_subset, seq_len)`` each, drawn from a CPU generator seeded ``seed``
    (the same data on every device) and moved to ``device``; for the vlm
    and audio families a third leaf, the stub frontend embeddings ``(N,
    per_subset, n_frontend_tokens, d_frontend)``, standard normals drawn
    next from the same generator."""
    gen = torch.Generator().manual_seed(seed)
    batch = lm_batch_for_devices(gen, arch.vocab, n_subsets=n_subsets, per_subset=per_subset, seq_len=seq_len,
                                 sigma_h=sigma_h)
    data = (batch["tokens"], batch["labels"])
    if arch.family in models.transformer.FRONTEND_FAMILIES:
        enc = arch.encoder
        data += (torch.randn((n_subsets, per_subset, enc.n_frontend_tokens, enc.d_frontend), generator=gen),)
    return tuple(t.contiguous().to(device) for t in data)


def lm_sweep(
    methods: Sequence[tuple[str, int]] = (("lad", 2), ("plain", 1)),
    attacks: Sequence[str] = ("sign_flip", "alie", "ipm"),
    aggregators: Sequence[str] = ("cwtm",),
    compressors: Sequence[str] = ("none", "rand_sparse"),
    *,
    n_devices: int = 10,
    n_byz: int = 2,
    sigma_h: float = 0.5,
    q_hat_frac: float = 0.5,
    trim_frac: float = 0.2,
    lr: float = 3e-3,
) -> list[Scenario]:
    """The LM-scale matrix: method x attack x aggregator x compressor, with
    ``section7_grid``'s pruning (DRACO rows drop compression and round N
    down to a multiple of d). Every row shares ``sigma_h``: ``run_lm_grid``
    trains a bucket on one shared problem. The default 12 rows fall into 4
    buckets (method x compressor; the attacks are per lane)."""
    rows = []
    seen = set()
    for method, d in methods:
        for attack in attacks:
            for agg in aggregators:
                for comp in compressors:
                    if method == "draco" and comp != "none":
                        continue
                    draco = method == "draco"
                    name = "lm/" + scenario_name(method, d, "vote" if draco else agg, attack, comp, sigma_h)
                    if name in seen:
                        continue
                    seen.add(name)
                    rows.append(Scenario(
                        name=name, method=method, d=d, aggregator="mean" if draco else agg, attack=attack,
                        n_byz=n_byz, compressor=comp, q_hat_frac=q_hat_frac, sigma_h=sigma_h,
                        trim_frac=trim_frac, n_devices=n_devices - n_devices % d if draco else n_devices, lr=lr,
                    ))
    return rows


def run_lm_scenario(
    scn: Scenario,
    steps: int,
    *,
    arch=None,
    seed: int = 0,
    per_subset: int = 2,
    seq_len: int = 16,
    params=None,
    batch: dict[str, torch.Tensor] | None = None,
    randomness: RandomnessProvider | None = None,
    device: torch.device | str | None = None,
    mode: str = "loop",
    stage_hook: Callable[[str], None] | None = None,
) -> TrajectoryResult:
    """One LM-scale scenario: the transformer ``arch`` (``lm_arch()`` when
    not given) trained from its flattened parameters through the protocol
    round, ``grad_scale`` 1 (the loss is a mean), the mean loss over every
    subset's rows as the metric ``loss``.

    ``params`` (a parameter tree, widened to float32) replaces the seeded
    initial parameters, and ``batch`` (``tokens`` and ``labels``, ``(N,
    rows, S)``, and for the vlm and audio families ``frontend``, ``(N,
    rows, n_frontend_tokens, d_frontend)``) the seeded heterogeneous-LM
    data; the rounds draw from a
    generator on the run's device seeded ``seed``, unless ``randomness``
    provides them. ``mode`` and ``stage_hook`` are ``run_trajectory``'s.
    ``run_lm_grid``'s lanes equal this run of their rows bit for bit.
    """
    dev = resolve_device(device)
    arch = arch if arch is not None else lm_arch()
    x0, spec, lm_subset_grads, lm_loss = _lm_fns(arch)
    if params is not None:
        x0, given = flatten_pytree(pytree.map_tree(lambda a: a.to(torch.float32), params))
        if given != spec:
            raise ValueError(f"params are not {arch.name}'s tree of leaves: {given[1]} against {spec[1]}")
    if batch is None:
        data = _lm_problem(arch, seed=seed, n_subsets=scn.n_devices, sigma_h=scn.sigma_h,
                           per_subset=per_subset, seq_len=seq_len, device=dev)
    else:
        keys = _DATA_KEYS[:3 if arch.family in models.transformer.FRONTEND_FAMILIES else 2]
        if any(k not in batch for k in keys):
            raise ValueError(f"{arch.name} ({arch.family}) trains on a batch of {keys}, not {tuple(batch)}")
        data = tuple(batch[k].to(dev) for k in keys)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return engine_lib.run_trajectory(
        scn.protocol(), x0.to(dev), lm_subset_grads, steps=steps, lr=scn.lr,
        randomness=randomness if randomness is not None else gen, grad_scale=1.0, loss_fn=lm_loss,
        data=data, device=dev, mode=mode, stage_hook=stage_hook)


def run_lm_grid(
    scenarios: Sequence[Scenario],
    steps: int,
    *,
    arch=None,
    seed: int = 0,
    per_subset: int = 2,
    seq_len: int = 16,
    mode: str = "graph",
    exact: bool = True,
    shard: str = "none",
    group: Any = None,
    max_lanes_per_device: int | str | None = None,
    device: torch.device | str | None = None,
) -> dict[str, TrajectoryResult]:
    """Sweep LM-scale scenarios: the buckets of ``run_grid`` (same
    signature, ``exact`` and chunking, ``"auto"`` included), every bucket's lanes training the
    transformer on one shared problem (``data_batched=False``) through
    ``engine.run_grid``. ``mode`` is how a bucket's rounds run, as in
    ``run_grid``: ``"graph"`` (one captured round replayed, CUDA only) or
    ``"loop"``; row by row is ``run_lm_scenario``.

    Every lane equals ``run_lm_scenario`` of its row with the same seed bit
    for bit. All rows must share ``sigma_h`` (a bucket shares one data
    tensor). ``shard`` and ``group`` spread each bucket's lanes over the
    ranks, as in ``run_grid``.
    """
    scns = list(scenarios)
    if not scns:
        raise ValueError("run_lm_grid needs at least one scenario")
    sigmas = {s.sigma_h for s in scns}
    if len(sigmas) != 1:
        raise ValueError(
            f"run_lm_grid rows must share sigma_h (got {sorted(sigmas)}): the LM sweep trains on one "
            "shared problem per bucket, so data heterogeneity cannot vary per lane")
    dev = resolve_device(device)
    arch = arch if arch is not None else lm_arch()
    x0, _, lm_subset_grads, lm_loss = _lm_fns(arch)
    buckets: dict[tuple, list[Scenario]] = {}
    for s in scns:
        buckets.setdefault(_bucket_signature(s, exact=exact), []).append(s)
    out: dict[str, TrajectoryResult] = {}
    for bucket in buckets.values():
        data = _lm_problem(arch, seed=seed, n_subsets=bucket[0].n_devices, sigma_h=bucket[0].sigma_h,
                           per_subset=per_subset, seq_len=seq_len, device=dev)
        prob = _BucketProblem(lm_subset_grads, lm_loss, x0.to(dev), data, False, 1.0)
        gens = [torch.Generator(device=dev).manual_seed(seed) for _ in bucket]
        out.update(_run_bucket(bucket, steps, prob, gens, device=dev, mode=mode, shard=shard, data_group=group,
                               max_lanes_per_device=max_lanes_per_device, randomness=None))
    return {s.name: out[s.name] for s in scns}


# --------------------------------------------------------------------------
# The architecture zoo: the LM sweep over an architecture axis.
# --------------------------------------------------------------------------

ZOO_FAMILIES = ("transformer", "jamba", "rwkv", "moe", "swa", "cross", "audio")


@functools.lru_cache(maxsize=None)
def zoo_arch(family: str):
    """The small ``ArchConfig`` of one zoo family, the reference's
    ``zoo_arch``: each family's structure at the ``lm_arch`` scale
    (d_model 32, vocab 64). jamba keeps its 8-block 1:7 attention:mamba
    period with MoE on the even blocks, rwkv its token-shift FFN, cross and
    audio their frontends (audio with a 1-layer encoder), swa a sliding
    window of 6. Cached, so each family has one config (and one
    ``_lm_fns`` problem)."""
    from repro_torch.configs.archs import ARCHS, reduced
    from repro_torch.configs.base import BlockSpec, EncoderConfig, MambaConfig, RWKVConfig

    if family == "transformer":
        return lm_arch()
    tiny = dict(d_model=32, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64, vocab=64)
    if family == "swa":
        return lm_arch().scaled(name="zoo-swa", period=(BlockSpec(sliding_window=6),))
    if family == "jamba":
        base = reduced(ARCHS["jamba-1.5-large-398b"])
        return base.scaled(name="zoo-jamba", n_layers=8, **tiny, moe=dataclasses.replace(base.moe, d_ff_expert=32),
                           mamba=MambaConfig(d_state=4, d_conv=4, expand=2))
    if family == "rwkv":
        return reduced(ARCHS["rwkv6-1.6b"]).scaled(name="zoo-rwkv", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                                                  head_dim=16, d_ff=64, vocab=64,
                                                  rwkv=RWKVConfig(head_dim=16, decay_lora=8))
    if family == "moe":
        base = reduced(ARCHS["granite-moe-3b-a800m"])
        return base.scaled(name="zoo-moe", n_layers=1, **tiny, moe=dataclasses.replace(base.moe, d_ff_expert=32))
    if family == "cross":
        return reduced(ARCHS["llama-3.2-vision-90b"]).scaled(
            name="zoo-cross", n_layers=5, **tiny,
            encoder=EncoderConfig(n_frontend_tokens=8, d_frontend=16, n_encoder_layers=0))
    if family == "audio":
        return reduced(ARCHS["whisper-small"]).scaled(
            name="zoo-audio", n_layers=2, **tiny,
            encoder=EncoderConfig(n_frontend_tokens=8, d_frontend=16, n_encoder_layers=1))
    raise ValueError(f"unknown zoo family {family!r} (have {ZOO_FAMILIES})")


# The lru caches pin the LM problems' x0 and closures, and the configs they
# key on, for the process: engine.clear_program_caches() releases them with
# the train step's programs.
for _cache in (lm_arch, _lm_fns, zoo_arch):
    engine_lib.register_program_cache(f"scenarios.{_cache.__name__.lstrip('_')}", _cache.cache_clear,
                                      lambda c=_cache: c.cache_info().currsize)
del _cache


def zoo_sweep(
    families: Sequence[str] = ZOO_FAMILIES,
    methods: Sequence[tuple[str, int]] = (("lad", 2), ("plain", 1)),
    attacks: Sequence[str] = ("sign_flip",),
    aggregators: Sequence[str] = ("cwtm",),
    compressors: Sequence[str] = ("none",),
    *,
    n_devices: int = 8,
    n_byz: int = 2,
    sigma_h: float = 0.5,
    **kw,
) -> dict[str, list[Scenario]]:
    """``lm_sweep``'s rows for every family, named ``zoo/<family>/...``:
    ``{family: rows}``, one list a family (a bucket cannot mix
    architectures: P differs). ``kw`` goes to ``lm_sweep``."""
    out: dict[str, list[Scenario]] = {}
    for fam in families:
        zoo_arch(fam)  # an unknown family raises here
        rows = lm_sweep(methods, attacks, aggregators, compressors, n_devices=n_devices, n_byz=n_byz,
                        sigma_h=sigma_h, **kw)
        out[fam] = [dataclasses.replace(s, name=f"zoo/{fam}/" + s.name[len("lm/"):]) for s in rows]
    return out


def run_zoo_sweep(
    steps: int,
    *,
    families: Sequence[str] = ZOO_FAMILIES,
    sweep: dict[str, list[Scenario]] | None = None,
    seed: int = 0,
    per_subset: int = 2,
    seq_len: int = 16,
    mode: str = "graph",
    **grid_kw,
) -> dict[str, dict[str, TrajectoryResult]]:
    """Train the zoo under attack: one ``run_lm_grid`` a family on its
    ``zoo_arch``, ``{family: {row name: result}}``. Every lane equals
    ``run_lm_scenario(row, ..., arch=zoo_arch(family))`` bit for bit.
    ``grid_kw`` (``device``, ``exact``, ``max_lanes_per_device``, ``"auto"``
    included) goes to ``run_lm_grid``."""
    sweep = sweep if sweep is not None else zoo_sweep(families)
    return {fam: run_lm_grid(rows, steps, arch=zoo_arch(fam), seed=seed, per_subset=per_subset, seq_len=seq_len,
                             mode=mode, **grid_kw)
            for fam, rows in sweep.items()}
