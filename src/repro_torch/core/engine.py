"""The multi-round trainer: protocol rounds plus optimizer steps, over a
leading lane axis of independent scenarios.

``run_trajectory`` runs ``steps`` rounds of one scenario. Each round
computes every subset gradient at the iterate, runs ``protocol_round`` with
that round's ``RoundRandomness`` and takes an optimizer step (any
``optim.make_optimizer`` name, at a fixed step size or a schedule's value
for the round). The round keeps its raw vectors (aggregate, honest subset
mean, new iterate), and the per-round metrics are computed from the stacked
vectors after the last round with fixed-tree reductions, as the reference's
``_finalize_metrics`` does; ``with_metrics=False`` keeps none of them.

``run_grid`` runs many scenarios that share their static structure as the
lanes of one batched round: every stack is ``(L, N, Q)``, each kernel one
launch over all lanes. The lanes may differ in attack, aggregator, step
size, problem data and randomness. They are sorted by (server, attack)
once, so each server runs once on its contiguous slice of lanes and each
attack on its slice within that (``byzantine.LaneBranch``), and the
results are put back in input order.
Lanes whose configurations draw the same records from the same seed share
one draw group: its records are drawn once and read by each of its lanes.
``run_trajectory`` is the grid's one-lane case: both run ``_run_lanes``.
Every reduction in a round is a fixed tree or a kernel, so a lane's bits do
not depend on how many lanes ride beside it. That is also what lets
``run_grid(shard=...)`` spread the lanes over the ranks of a
``torch.distributed`` data group (the reference's ``shard_map``/``pmap``
over its devices): each rank runs its contiguous share of every chunk and
the results are gathered in rank order, so every rank returns the whole
grid, each lane bit for bit its unsharded value.

Under an active participation schedule a round also carries the schedule
state (the previous mask, which ``"markov"`` evolves), draws its mask from
the round's ``part_u``, ``t`` and that state, and records its reporting
count as the metric ``n_report``.

Two modes run the same rounds:

  * ``"loop"``: a Python loop over the rounds;
  * ``"graph"`` (the reference's ``scan``; CUDA only): every round's
    randomness is drawn up front in round order and stacked on the card,
    one round is captured as a CUDA graph and replayed ``steps`` times. A
    round counter on the card, advanced inside the graph, selects the
    round's records and the rows of the preallocated ``(steps, ...)``
    output buffers, and is the schedule's input; the optimizer's step and
    moments are buffers the round overwrites. Graph mode equals loop mode
    bit for bit.
"""
from __future__ import annotations

import dataclasses
import gc
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.core.byzantine import (
    LaneBranch,
    ProtocolConfig,
    RoundRandomness,
    draw_signature,
    make_attack_fn,
    make_server_fn,
    protocol_round,
    sample_round_randomness,
)
from repro_torch.core.participation import init_participation_state, sample_participation
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import tuner
from repro_torch.numerics import stable_mean0, stable_norm, tree_sum
from repro_torch.optim import OptState, make_optimizer
from repro_torch.timing import block_time

__all__ = ["TrajectoryResult", "GraphStats", "GridStats", "RandomnessProvider", "run_trajectory",
           "run_grid", "grid_launch_list", "protocol_rounds", "pad_lanes", "padded_lane_count",
           "last_grid_chunk_info",
           "draw_rounds", "stack_rounds", "select_round", "SHARD_MODES", "engine_ranks", "gather_ranks",
           "register_program_cache", "program_cache_sizes", "clear_program_caches"]

RandomnessProvider = Callable[[int], RoundRandomness]

# elements of the (lanes, rounds, N, Q) temporary a linear-regression loss
# makes; the metrics take the rounds in slices of at most this size
_LOSS_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """What a ``mode="graph"`` trajectory captured and replayed.

    The kernel wrappers count their launches in Python, so the launch
    counts (``kernels.ops.launch_counts``) see each kernel of the captured
    round once; its ``replays`` launches on the card run no Python.

    Attributes:
      replays: replays of the captured round (``steps``).
      captured_launches: per kernel counter, the launches recorded into the
        captured round; the card ran each ``replays`` times.
      replay_start / replay_end: CUDA events recorded around the replays.
      captured_work: every launch of the captured round with its bytes and
        fp32 operations (``kernels.ops.record_launches``).
    """

    replays: int
    captured_launches: dict[str, int]
    replay_start: torch.cuda.Event
    replay_end: torch.cuda.Event
    captured_work: tuple[dict, ...] = ()

    def replay_ms(self) -> float:
        """Milliseconds from the first replay's start to the last one's end
        (waits for the last replay)."""
        self.replay_end.synchronize()
        return self.replay_start.elapsed_time(self.replay_end)


@dataclasses.dataclass(frozen=True)
class GridStats:
    """How ``run_grid`` ran its lanes.

    Attributes:
      lanes: lanes of the call.
      draw_groups: lanes that draw alike share a group, drawn once.
      chunk: lanes of each chunk (the last one padded to it).
      chunks: chunks run one after another.
      branches: attack and server runs of lanes, over all chunks.
      graphs: each chunk's ``GraphStats`` under ``mode="graph"``, else ().
    """

    lanes: int
    draw_groups: int
    chunk: int
    chunks: int
    branches: int
    graphs: tuple[GraphStats, ...] = ()

    def captured_launches(self) -> dict[str, int]:
        """Per kernel counter, the launches captured in one round of every
        chunk, summed over the chunks."""
        out = {name: 0 for name in kernel_ops.KERNELS}
        for g in self.graphs:
            for k, v in g.captured_launches.items():
                out[k] += v
        return out

    def replay_ms(self) -> float:
        """The chunks' replay times, summed (waits for the last replay)."""
        return sum(g.replay_ms() for g in self.graphs)


@dataclasses.dataclass(frozen=True)
class TrajectoryResult:
    """Output of ``run_trajectory``, or of ``run_grid`` with a leading lane
    axis on ``x``, every metric and the participation state.

    Attributes:
      x: final iterate ``(Q,)``.
      opt_state: the optimizer state after the last step.
      metrics: per-round ``(steps,)`` tensors: ``agg_dist`` (||aggregate -
        honest subset mean||), ``grad_norm``, ``loss`` when a ``loss_fn`` was
        given, ``sol_err`` (||x_t - x*||) when ``x_star`` was, and
        ``n_report`` (reporting devices) under active participation.
      participation_state: the schedule state after the last round (the last
        mask), ``None`` at full participation.
      graph: the capture's launch counts and replay events under
        ``mode="graph"``, else ``None``.
      grid: how ``run_grid`` ran the lanes, else ``None``.
    """

    x: torch.Tensor
    opt_state: OptState
    metrics: dict[str, torch.Tensor]
    participation_state: torch.Tensor | None = None
    graph: GraphStats | None = None
    grid: GridStats | None = None

    def lane(self, i: int) -> "TrajectoryResult":
        """Lane ``i`` of a ``run_grid`` result, as one trajectory's result."""
        p = self.participation_state
        return dataclasses.replace(self, x=self.x[i], metrics={k: v[i] for k, v in self.metrics.items()},
                                   participation_state=None if p is None else p[i])


def _finalize_metrics(raw: dict[str, torch.Tensor], loss_fn, x_star) -> dict[str, torch.Tensor]:
    """Per-round metrics from the stacked ``(..., steps, Q)`` raw vectors."""
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


def _draw(cfg: ProtocolConfig, q: int, randomness: RandomnessProvider | torch.Generator,
          t: int) -> RoundRandomness:
    if isinstance(randomness, torch.Generator):  # drawn in round order
        return sample_round_randomness(cfg, q, randomness)
    rand = randomness(t)
    rand.validate(cfg.n_devices, q)
    return rand


def draw_rounds(cfg: ProtocolConfig, q: int, steps: int,
                randomness: RandomnessProvider | torch.Generator) -> list[RoundRandomness]:
    """Every round's randomness in round order: drawn from a generator, or
    asked of a provider for ``t = 0 .. steps-1`` and checked with
    ``RoundRandomness.validate``."""
    return [_draw(cfg, q, randomness, t) for t in range(steps)]


def stack_rounds(rounds: list[RoundRandomness], device: torch.device | str) -> RoundRandomness:
    """The records of ``rounds`` as one record of ``(steps, ...)`` tensors on
    ``device``."""
    return RoundRandomness.stack(rounds).to(device)


def select_round(stacked: RoundRandomness, t: int | torch.Tensor) -> RoundRandomness:
    """Round ``t``'s record of a ``stack_rounds`` record; ``t`` is an int, or
    a 0-d int64 tensor on the records' device, so nothing is read back."""
    if isinstance(t, int):
        return stacked.map(lambda v: v[t])
    idx = t.reshape(1)
    return stacked.map(lambda v: v.index_select(0, idx)[0])


class _Draws:
    """The randomness of a run's draw groups: one source each, drawn with
    the group's configuration. A round's record stacks the groups on a
    leading axis; ``attack_noise`` stacks only the groups that draw it
    (``gaussian``)."""

    def __init__(self, cfgs: Sequence[ProtocolConfig], sources: Sequence, q: int, dev: torch.device):
        self.cfgs, self.sources, self.q, self.dev = list(cfgs), list(sources), q, dev
        self.noisy = [i for i, c in enumerate(self.cfgs) if c.attack.name == "gaussian"]

    def at(self, t: int) -> RoundRandomness:
        recs = [_draw(c, self.q, s, t).to(self.dev) for c, s in zip(self.cfgs, self.sources)]
        noise = [recs[i].attack_noise for i in self.noisy]
        rec = RoundRandomness.stack([dataclasses.replace(r, attack_noise=None) for r in recs])
        return dataclasses.replace(rec, attack_noise=torch.stack(noise) if noise else None)

    def stacked(self, steps: int) -> RoundRandomness:
        """Every round's record, drawn in round order, on a leading round axis."""
        return RoundRandomness.stack([self.at(t) for t in range(steps)])


@dataclasses.dataclass(frozen=True)
class _Lanes:
    """The lanes of one batched run: the shared configuration, the attack
    and server runs, and which draw group (and which row of the groups that
    draw noise) each lane reads; ``None`` reads group ``i`` for lane ``i``."""

    cfg: ProtocolConfig
    attacks: tuple[LaneBranch, ...]
    servers: tuple[LaneBranch, ...]
    group_of: torch.Tensor | None = None
    noise_of: torch.Tensor | None = None


def _lane_records(groups: RoundRandomness, lanes: _Lanes) -> RoundRandomness:
    """One round's records per lane from the draw groups' records."""
    def pick(name: str, v: torch.Tensor) -> torch.Tensor:
        idx = lanes.noise_of if name == "attack_noise" else lanes.group_of
        return v if idx is None else v.index_select(0, idx)

    return RoundRandomness(**{
        f.name: None if getattr(groups, f.name) is None else pick(f.name, getattr(groups, f.name))
        for f in dataclasses.fields(RoundRandomness)
    })


def _lr_at(lr, t: int | torch.Tensor, dev: torch.device):
    """Round ``t``'s step size: ``lr`` itself, or a schedule's value at ``t``
    (a 0-d int64 tensor on ``dev``, the graph's round counter or its loop
    twin, so both modes evaluate it on the same input)."""
    if not callable(lr):
        return lr
    return lr(t if isinstance(t, torch.Tensor) else torch.tensor(t, dtype=torch.int64, device=dev))


def _map_state(state: OptState, fn: Callable[[torch.Tensor], torch.Tensor], step: bool = False) -> OptState:
    """``fn`` applied to every moment leaf (and to the step with ``step``)."""
    return OptState(step=fn(state.step) if step else state.step, mu=pytree.map_tree(fn, state.mu),
                    nu=pytree.map_tree(fn, state.nu))


def _run_lanes(lanes: _Lanes, records, x: torch.Tensor, grads_of: Callable, *, steps: int, lr, grad_scale,
               opt, state, p_state, mode: str, dev: torch.device, stage_hook: Callable[[str], None] | None = None,
               with_metrics: bool = True):
    """``steps`` rounds of the lanes from iterates ``x`` ``(L, Q)``.

    ``records`` is a ``t -> RoundRandomness`` of the draw groups (drawn as
    each round starts; loop mode only) or every round's records stacked on
    a leading round axis. ``lr`` is a float, a per-lane ``(L,)`` tensor or a
    ``t -> lr`` schedule. ``stage_hook`` (loop mode only) marks the stages
    of every round, see ``run_trajectory``. Returns (the raw ``(steps, L,
    ...)`` vectors, none without ``with_metrics``, the last iterates, the
    schedule state, ``GraphStats`` or ``None``, the optimizer state)."""
    cfg = lanes.cfg
    p_spec = cfg.participation
    n = cfg.n_devices
    hook = stage_hook or (lambda stage: None)

    def one_round(x, groups, t, p_state, state):
        """One round at iterates ``x``: (new x, the raw vectors, schedule
        state, optimizer state)."""
        hook("round")
        rand = _lane_records(groups, lanes)
        grads = grads_of(x)
        hook("grads")
        pm = n_report = None
        if p_spec.active:
            pm, p_state = sample_participation(p_spec, rand.part_u, t, n, p_state)
            n_report = tree_sum(pm, dim=-1)
        g = protocol_round(cfg, grads, rand, device=dev, attack_branches=lanes.attacks,
                           server_branches=lanes.servers, participation_mask=pm, stage_hook=stage_hook)
        new_x, state = opt.update(x, grad_scale * g, state, _lr_at(lr, t, dev))
        raw = {}
        if with_metrics:
            raw = {"g": g, "gmean": stable_mean0(grads, dim=-2), "x": new_x}
            if n_report is not None:
                raw["n_report"] = n_report
        hook("step")
        return new_x, raw, p_state, state

    names = (("g", "gmean", "x") + (("n_report",) if p_spec.active else ())) if with_metrics else ()
    if mode == "loop":
        at = records if callable(records) else (lambda t: select_round(records, t))
        raw: dict[str, list[torch.Tensor]] = {k: [] for k in names}
        for t in range(steps):
            x, r, p_state, state = one_round(x, at(t), t, p_state, state)
            for k in names:
                raw[k].append(r[k])
        return {k: torch.stack(v) for k, v in raw.items()}, x, p_state, None, state
    return _replay_graph(one_round, records, x, p_state, state, steps, names)


def _check_mode(mode: str, dev: torch.device) -> None:
    if mode not in ("loop", "graph"):
        raise ValueError(f"unknown mode {mode!r}; have 'loop' and 'graph'")
    if mode == "graph" and dev.type != "cuda":
        raise ValueError(f"mode='graph' captures a CUDA graph and needs a CUDA device, not {dev}")


def run_trajectory(
    cfg: ProtocolConfig,
    x0: torch.Tensor,
    subset_grad_fn: Callable[..., torch.Tensor],
    *,
    steps: int,
    lr: float | torch.Tensor | Callable[[torch.Tensor], torch.Tensor],
    randomness: RandomnessProvider | torch.Generator | None = None,
    optimizer: str = "sgd",
    momentum_dtype: str | torch.dtype = "float32",
    grad_scale: float = 1.0,
    loss_fn: Callable[..., torch.Tensor] | None = None,
    x_star: torch.Tensor | None = None,
    data: Any = None,
    opt_state: OptState | None = None,
    participation_state: torch.Tensor | None = None,
    device: torch.device | str | None = None,
    mode: str = "loop",
    stage_hook: Callable[[str], None] | None = None,
    with_metrics: bool = True,
) -> TrajectoryResult:
    """Run ``steps`` protocol rounds from ``x0``.

    Args:
      cfg: protocol configuration.
      x0: initial iterate ``(Q,)``; moved to ``device``.
      subset_grad_fn: ``x -> (N, Q)`` subset gradients, or ``(data, x) ->
        (N, Q)`` when ``data`` is given.
      steps: number of rounds.
      lr: step size: a float, a 0-d float32 tensor, or a schedule ``t ->
        lr`` of the round index (a 0-d int64 tensor on ``device``; in graph
        mode the captured round's counter, so it is evaluated on the card).
      randomness: a ``torch.Generator`` on ``device`` that draws every
        round (seeded 0 when not given), or a provider ``t ->
        RoundRandomness`` for rounds ``t = 0 .. steps-1``, whose records are
        checked with ``RoundRandomness.validate`` as they come in.
      optimizer / momentum_dtype: a ``repro_torch.optim.make_optimizer``
        name and the dtype of its moments.
      grad_scale: multiplies the aggregate before the optimizer step (the
        paper's eq.-(7) sum-loss needs ``N x`` the mean-gradient estimate).
      loss_fn / x_star: optional metric hooks; ``loss_fn`` maps stacked
        iterates ``(steps, Q)`` (and ``data`` first, when given) to
        ``(steps,)``.
      data: problem tensors handed to ``subset_grad_fn`` and ``loss_fn``.
      opt_state: optimizer state to resume from (moved to ``device``).
      participation_state: schedule state to resume from (the previous
        ``(N,)`` mask); all ones when not given.
      device: where the rounds run; ``cuda`` when not given (no CUDA then
        raises).
      mode: ``"loop"`` or ``"graph"`` (see the module docstring). Graph mode
        needs a CUDA device and raises on any other; it draws all rounds'
        randomness before the first round (``steps`` records on the card),
        runs one round eagerly on copies of the state (building the kernels
        and setting their attributes outside the capture), captures one
        round and replays it.
      stage_hook: loop mode only; called with ``"round"`` as each round
        begins, ``"grads"`` once its subset gradients are enqueued, then
        ``protocol_round``'s stages, and ``"step"`` after the optimizer step
        and the round's honest subset mean (for per-stage CUDA-event times). A captured round runs no Python,
        so graph mode refuses it.
      with_metrics: ``False`` keeps no per-round ``(steps, Q)`` rows (at a
        model's width they are gigabytes a round): the result holds the
        final iterate and optimizer state and no metrics, and ``loss_fn``
        and ``x_star`` must be ``None``.
    """
    if stage_hook is not None and mode != "loop":
        raise ValueError("stage_hook marks loop-mode rounds; a captured round runs no Python")
    if not with_metrics and (loss_fn is not None or x_star is not None):
        raise ValueError("with_metrics=False is incompatible with loss_fn/x_star")
    dev = resolve_device(device)
    _check_mode(mode, dev)
    opt = make_optimizer(optimizer, momentum_dtype=momentum_dtype)
    x = x0.to(dev)
    state = opt.init(x) if opt_state is None else _map_state(opt_state, lambda v: v.to(dev), step=True)
    q = x.shape[-1]
    if randomness is None:
        randomness = torch.Generator(device=dev).manual_seed(0)
    grads_fn = (lambda x: subset_grad_fn(data, x)) if data is not None else subset_grad_fn
    p_state = None
    if cfg.participation.active:
        p_state = (init_participation_state(cfg.participation, cfg.n_devices, device=dev)
                   if participation_state is None else participation_state.to(dev))[None]

    lanes = _Lanes(cfg, (LaneBranch(0, 1, make_attack_fn(cfg)),), (LaneBranch(0, 1, make_server_fn(cfg)),))
    draws = _Draws([cfg], [randomness], q, dev)
    raw, x, p_state, stats, state = _run_lanes(
        lanes, draws.at if mode == "loop" else draws.stacked(steps), x[None], lambda x: grads_fn(x[0])[None],
        steps=steps, lr=lr, grad_scale=grad_scale, opt=opt, state=_map_state(state, lambda v: v[None]),
        p_state=p_state, mode=mode, dev=dev, stage_hook=stage_hook, with_metrics=with_metrics)
    metrics = {}
    if with_metrics:
        bound_loss = None
        if loss_fn is not None:
            bound_loss = (lambda xs: loss_fn(data, xs)) if data is not None else loss_fn
        metrics = _finalize_metrics({k: v[:, 0] for k, v in raw.items()}, bound_loss, x_star)
    return TrajectoryResult(x=x[0], opt_state=_map_state(state, lambda v: v[0]), metrics=metrics, graph=stats,
                            participation_state=None if p_state is None else p_state[0])


_SIDE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    """One stream a device for the warm-up round before a capture: a new
    stream each call would leave a cuBLAS workspace behind for each."""
    if dev not in _SIDE_STREAMS:
        _SIDE_STREAMS[dev] = torch.cuda.Stream(device=dev)
    return _SIDE_STREAMS[dev]


def _replay_graph(one_round, records: RoundRandomness, x: torch.Tensor, p_state, state: OptState, steps: int,
                  names: tuple[str, ...]):
    """Capture one round of ``one_round`` that reads round ``t``'s records
    and writes row ``t`` of the output buffers, then replay it ``steps``
    times. The iterates, the schedule state and the optimizer state (its
    step and moments) are buffers the round reads and overwrites.

    Returns (the stacked outputs, the last iterates, the schedule state,
    ``GraphStats``, the optimizer state)."""
    dev = x.device
    rows = {"g": x.shape, "gmean": x.shape, "x": x.shape, "n_report": x.shape[:-1]}

    def buffers():
        """The state a round reads and writes: iterates, round counter,
        schedule state, optimizer state, output rows."""
        return {"x": x.clone(), "t": torch.zeros((), dtype=torch.int64, device=dev),
                "p_state": None if p_state is None else p_state.clone(),
                "state": _map_state(state, torch.clone, step=True),
                "out": {k: torch.empty((steps, *rows[k]), dtype=torch.float32, device=dev) for k in names}}

    def step(bufs):
        t = bufs["t"]
        new_x, raw, new_p, new_state = one_round(bufs["x"], select_round(records, t), t, bufs["p_state"],
                                                 bufs["state"])
        for k in names:
            bufs["out"][k].index_copy_(0, t.reshape(1), raw[k][None])
        bufs["x"].copy_(new_x)
        if new_p is not None:
            bufs["p_state"].copy_(new_p)
        for (_, dst), (_, src) in zip(pytree.paths(bufs["state"]), pytree.paths(new_state), strict=True):
            dst.copy_(src)
        t.add_(1)

    side = _side_stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step(buffers())  # on copies: first-use builds and kernel attributes stay outside the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    live = buffers()
    graph = torch.cuda.CUDAGraph()
    before = kernel_ops.launch_counts()
    try:
        # the outer stream context puts the stream back even when the capture's own exit fails
        with torch.cuda.stream(torch.cuda.current_stream(dev)), kernel_ops.record_launches() as work:
            with torch.cuda.graph(graph):
                step(live)
    except Exception as exc:
        oom = _oom_in(exc)
        if oom is None or oom is exc:
            raise
        # an allocation that fails under capture can surface as the capture's own error
        oom.add_note(f"raised inside a CUDA graph capture, which then failed with {exc!r}")
        raise oom from None
    after = kernel_ops.launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        graph.replay()
    end.record()
    stats = GraphStats(replays=steps, captured_launches={k: after[k] - before[k] for k in after},
                       replay_start=start, replay_end=end, captured_work=tuple(work))
    return live["out"], live["x"], live["p_state"], stats, live["state"]


# ------------------------------------------------------------------- ranks

# The reference's shard substrates. Here both name the one rank split: the
# reference holds its two bit for bit equal, so a config reads the same in
# both packages.
SHARD_MODES = ("none", "pmap", "shard_map")


def engine_ranks(group: Any = None) -> tuple[Any, int, int]:
    """``(group, world, rank)`` of the engine's sharded paths, the
    counterpart of the reference's ``make_engine_mesh`` (``world`` its
    ``engine_device_count``): the ranks of ``group``, else of the default
    process group when one is initialised, else one rank with no group
    (and no collective)."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return None, 1, 0
    return group, dist.get_world_size(group), dist.get_rank(group)


def gather_ranks(x: torch.Tensor, group: Any, world: int) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks) concatenated along the
    leading axis in rank order; ``x`` itself with no group."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous(), group=group)  # a list of outputs: gloo and NCCL both take it
    return parts[0] if world == 1 else torch.cat(parts)


# ------------------------------------------------------------------- grid


def padded_lane_count(n: int, n_devices: int = 1) -> int:
    """``n`` lanes rounded up to a multiple of ``n_devices`` (the ranks of
    a sharded run). Padding replicates the last lane, so zero lanes cannot
    be padded and raise."""
    if n < 1:
        raise ValueError(
            f"cannot pad a lane axis of length {n}: padding replicates the last lane, "
            "so at least one lane must exist")
    if n_devices < 1:
        raise ValueError(f"device count must be >= 1, got {n_devices}")
    return -(-n // n_devices) * n_devices


def pad_lanes(lanes: torch.Tensor, pad: int) -> torch.Tensor:
    """Append ``pad`` copies of the last lane to the leading axis. A replica
    runs a real lane's math, so padding never feeds a lane degenerate
    inputs; the padded lanes are sliced off afterwards."""
    return lanes if pad == 0 else torch.cat([lanes, lanes[-1:].expand((pad,) + lanes.shape[1:])])


def _take_lanes(tree: Any, idx: torch.Tensor) -> Any:
    """The lanes ``idx`` of every tensor of ``tree``, in that order."""
    if isinstance(tree, torch.Tensor):
        return tree.index_select(0, idx.to(tree.device))
    if isinstance(tree, dict):
        return {k: _take_lanes(v, idx) for k, v in tree.items()}
    return type(tree)(_take_lanes(v, idx) for v in tree)


_LAST_GRID_CHUNK: dict[str, Any] = {}


def last_grid_chunk_info() -> dict[str, Any]:
    """How the most recent ``run_grid`` call chunked its lanes:
    ``{"max_lanes_per_device", "chunk", "n_lanes", "devices", "auto"}``."""
    return dict(_LAST_GRID_CHUNK)


def _check_capacity(max_lanes_per_device: int | str | None) -> bool:
    """Refuse a capacity that is not an int >= 1, None or ``"auto"``; True
    for ``"auto"``."""
    if isinstance(max_lanes_per_device, str):
        if max_lanes_per_device != "auto":
            raise ValueError(
                f"max_lanes_per_device must be an int, None or 'auto'; got {max_lanes_per_device!r}")
        return True
    if max_lanes_per_device is not None and max_lanes_per_device < 1:
        raise ValueError(f"max_lanes_per_device must be >= 1, got {max_lanes_per_device}")
    return False


def _resolve_chunk(n_lanes: int, max_lanes_per_device: int | None, devices: int = 1, auto: bool = False) -> int:
    """Lanes per chunk of one grid call (``max_lanes_per_device`` checked by
    ``_check_capacity``, and resolved when ``auto``)."""
    if max_lanes_per_device is None:
        chunk = padded_lane_count(n_lanes, devices)
    else:
        chunk = max_lanes_per_device * devices
    _LAST_GRID_CHUNK.clear()
    _LAST_GRID_CHUNK.update(max_lanes_per_device=max_lanes_per_device, chunk=chunk, n_lanes=n_lanes,
                            devices=devices, auto=auto)
    return chunk


def _oom_in(exc: BaseException) -> BaseException | None:
    """The out-of-memory error ``exc`` is, or carries in its chain of causes
    and contexts (a capture's own error raised on top of it), else None."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        if tuner._is_oom(exc):
            return exc
        seen.add(id(exc))
        exc = exc.__cause__ or exc.__context__
    return None


def _release(exc: BaseException, dev: torch.device) -> None:
    """Free what a failed chunk held: the locals of the finished frames of
    ``exc``'s chain (its graph, buffers and stacks), then the allocator's
    cached blocks, so the next probe and the sweep start from the memory
    they had before."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        traceback.clear_frames(exc.__traceback__)
        exc = exc.__cause__ or exc.__context__
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _agree(values: list[float], op, group: Any, dev: torch.device) -> list[float]:
    """``values`` reduced elementwise with ``op`` over the ranks of ``group``."""
    v = torch.tensor(values, dtype=torch.float64, device=dev)
    dist.all_reduce(v, op=op, group=group)
    return v.tolist()


def _probe_chunk(run_chunk: Callable, capacity: int, world: int, group: Any, dev: torch.device) -> float:
    """Seconds of one chunk of ``capacity x world`` lanes through
    ``run_chunk``, the sweep's own chunk path without its gather: one
    untimed call, then one timed by ``timing.block_time``.

    An out-of-memory error (also one a capture raised its own error on top
    of) frees what the chunk held and goes out as itself. Over ranks every
    rank probes, then the ranks agree once, after the chunk, so no rank
    waits in a collective that another, out of memory, never reaches: the
    largest time is every rank's, and an out-of-memory error (or another
    error) on any rank is raised on all."""
    err, status, seconds = None, 0, 0.0
    try:
        seconds = block_time(run_chunk, 0, capacity * world, False, iters=1, warmup=1, device=dev)
    except Exception as exc:  # noqa: BLE001 - sorted into out of memory and the rest below
        err = _oom_in(exc)
        if err is None:
            err, status = exc, 2
        else:
            status = 1
            _release(exc, dev)
        if group is None:
            if err is exc:
                raise
            try:
                raise err from None
            finally:
                err = None
    if group is not None:
        seconds, worst = _agree([seconds, float(status)], dist.ReduceOp.MAX, group, dev)
        if err is not None:
            try:
                raise err
            finally:
                err = None  # no cycle through this frame's locals: the error's frames hold no memory after it
        if worst == 1:
            raise torch.OutOfMemoryError(f"out of memory on another rank at {capacity} lanes a rank")
        if worst == 2:
            raise RuntimeError(f"the probe of {capacity} lanes a rank failed on another rank")
    return seconds


def _device_kind(dev: torch.device) -> str:
    return f"cuda/{torch.cuda.get_device_name(dev)}" if dev.type == "cuda" else dev.type


def _auto_capacity(run_chunk: Callable, n_lanes: int, world: int, group: Any, dev: torch.device,
                   signature: tuple) -> int:
    """Resolve ``max_lanes_per_device="auto"`` through ``launch.tuner``: the
    store's capacity for this signature, device kind and world, else the
    tuned one. Over ranks the stored value counts only when every rank holds
    the same; otherwise every rank tunes (on a scratch store, so that all
    of them probe) and records the result."""
    probes = tuner.tuner_stats()["probes"]
    try:
        return _tuned_capacity(run_chunk, n_lanes, world, group, dev, signature)
    finally:
        if tuner.tuner_stats()["probes"] != probes:  # the sweep starts from the memory it had before the probes
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()


def _tuned_capacity(run_chunk: Callable, n_lanes: int, world: int, group: Any, dev: torch.device,
                    signature: tuple) -> int:
    kind = _device_kind(dev)
    store = tuner.get_store()
    if group is not None:
        key = tuner.signature_key((signature, kind, world))
        held = store.capacity_for(key)
        c = -1.0 if held is None else float(held)
        low, neg_high = _agree([c, -c], dist.ReduceOp.MIN, group, dev)
        if not (low == -neg_high == c >= 1):
            scratch = tuner.TunerStore(None)
            capacity = tuner.auto_max_lanes(lambda cap: _probe_chunk(run_chunk, cap, world, group, dev),
                                            n_lanes=n_lanes, n_devices=world, signature=signature,
                                            device_kind=kind, store=scratch)
            store.record_capacity(key, scratch.data["lane_capacity"][key])
            return capacity
    return tuner.auto_max_lanes(lambda cap: _probe_chunk(run_chunk, cap, world, group, dev), n_lanes=n_lanes,
                                n_devices=world, signature=signature, device_kind=kind, store=store)


def _per_lane_sig(tree: Any, axis: int | None) -> tuple:
    """(path, shape, dtype) of every tensor of ``tree``, without its lane
    (or draw group) ``axis`` unless that is None."""
    return tuple((path, tuple(v.shape[:axis] + v.shape[axis + 1:] if axis is not None else v.shape), str(v.dtype))
                 for path, v in pytree.paths(tree) if isinstance(v, torch.Tensor))


def _chunk_lanes(tmpl: ProtocolConfig, cfgs: list[ProtocolConfig], keys: list[tuple], groups: list[int],
                 n_groups: int, noisy: list[int], dev: torch.device) -> _Lanes:
    """A chunk's lanes, in their sorted order: the attack runs (one per
    (server, attack) key), the server runs, and each lane's draw group and
    noise row (a lane that draws no noise reads any row: its attack ignores
    it)."""
    noise_row = {g: i for i, g in enumerate(noisy)}
    return _Lanes(
        tmpl, _runs(keys, cfgs, make_attack_fn), _runs([k[0] for k in keys], cfgs, make_server_fn),
        group_of=None if groups == list(range(n_groups)) else torch.tensor(groups, device=dev),
        noise_of=None if not noisy or groups == noisy else torch.tensor(
            [noise_row.get(g, 0) for g in groups], device=dev))


def _runs(keys: list, cfgs: list[ProtocolConfig], make: Callable) -> tuple[LaneBranch, ...]:
    """The runs of equal keys along the lanes, each with ``make`` of its
    first lane's configuration."""
    runs, start = [], 0
    for i in range(1, len(keys) + 1):
        if i == len(keys) or keys[i] != keys[start]:
            runs.append(LaneBranch(start, i, make(cfgs[start])))
            start = i
    return tuple(runs)


@dataclasses.dataclass(frozen=True)
class _GridPlan:
    """A grid call set up to run: ``run_chunk(start, chunk, gather=True)``
    runs the sorted lanes ``[start, start + chunk)`` (see ``_plan_grid``),
    ``signature()`` is the tuner's key for the call, the rest how the lanes
    spread over the ranks and how to put them back in input order."""

    run_chunk: Callable
    signature: Callable[[], tuple]
    n_lanes: int
    n_sources: int
    order: list[int]
    world: int
    group: Any
    dev: torch.device


def _plan_grid(cfgs, x0, subset_grad_fn, *, steps, lr, randomness, draw_ids=None, data=None, data_batched=True,
               optimizer="sgd", momentum_dtype="float32", grad_scale=1.0, loss_fn=None, shard="none", group=None,
               device=None, mode="loop", with_metrics=True) -> _GridPlan:
    """Check a ``run_grid`` call (its arguments and defaults), draw its
    records and set up its chunks."""
    if shard not in SHARD_MODES:
        raise ValueError(f"unknown shard mode {shard!r}")
    sharded = shard != "none"
    group, world, rank = engine_ranks(group) if sharded else (None, 1, 0)
    dev = resolve_device(device)
    _check_mode(mode, dev)
    cfgs = list(cfgs)
    n_lanes = len(cfgs)
    if n_lanes == 0:
        raise ValueError("run_grid needs at least one lane")
    tmpl = cfgs[0]
    for c in cfgs:
        if dataclasses.replace(c, attack=tmpl.attack, aggregator=tmpl.aggregator) != tmpl:
            raise ValueError("run_grid lanes must share all but attack and aggregator: bucket them first")
    draw_ids = list(range(n_lanes)) if draw_ids is None else list(draw_ids)
    sources = list(randomness)
    if len(draw_ids) != n_lanes or sorted(set(draw_ids)) != list(range(len(sources))):
        raise ValueError(f"draw_ids must map the {n_lanes} lanes onto the {len(sources)} sources, each used")
    group_cfg = {}
    for c, g in zip(cfgs, draw_ids):
        if draw_signature(group_cfg.setdefault(g, c)) != draw_signature(c):
            raise ValueError(f"lanes of draw group {g} draw different records")

    if not with_metrics and loss_fn is not None:
        raise ValueError("with_metrics=False is incompatible with loss_fn")
    opt = make_optimizer(optimizer, momentum_dtype=momentum_dtype)
    x0 = x0.to(dev)
    q = x0.shape[-1]
    draws = _Draws([group_cfg[g] for g in range(len(sources))], sources, q, dev)
    records = draws.stacked(steps)
    lr_lanes = None
    if not (isinstance(lr, (int, float)) or callable(lr)):
        lr_lanes = torch.as_tensor(lr, dtype=torch.float32, device=dev)
    if lr_lanes is not None and lr_lanes.shape != (n_lanes,):
        raise ValueError(f"lr must be a float or one per lane ({n_lanes},), got {tuple(lr_lanes.shape)}")

    # one (server, attack) key per lane, numbered by first appearance; a stable sort makes runs
    attacks, servers = {}, {}
    keys = [(servers.setdefault(c.aggregator, len(servers)), attacks.setdefault(c.attack, len(attacks)))
            for c in cfgs]
    order = sorted(range(n_lanes), key=lambda i: keys[i])

    def run_chunk(start: int, chunk: int, gather: bool = True):
        """The lanes ``order[start:start + chunk]`` (the last one padded to
        ``chunk``), this rank's share of them; every rank's share gathered
        unless ``gather`` is False. Returns (the chunk's real lanes: x,
        metrics, schedule state, optimizer state; ``GraphStats`` or None;
        its attack and server runs)."""
        per = chunk // world  # lanes a rank runs of the chunk
        take = min(chunk, n_lanes - start)
        padded = pad_lanes(torch.tensor(order[start:start + take], device=dev), chunk - take)
        idx = padded[rank * per:(rank + 1) * per]  # this rank's contiguous share, in sorted order
        keep = per if sharded else take  # a sharded rank keeps its padding lanes until the gather
        ids = idx.tolist()
        lanes = _chunk_lanes(tmpl, [cfgs[i] for i in ids], [keys[i] for i in ids], [draw_ids[i] for i in ids],
                             len(sources), draws.noisy, dev)
        chunk_data = _take_lanes(data, idx) if data is not None and data_batched else data
        x = x0.expand(per, q).clone()
        p_state = None
        if tmpl.participation.active:
            p_state = init_participation_state(tmpl.participation, tmpl.n_devices, device=dev, lanes=per)
        raw, x, p_state, stats, state = _run_lanes(
            lanes, records, x, lambda x, d=chunk_data: subset_grad_fn(d, x), steps=steps,
            lr=lr if lr_lanes is None else lr_lanes.index_select(0, idx), grad_scale=grad_scale, opt=opt,
            state=opt.init(x), p_state=p_state, mode=mode, dev=dev, with_metrics=with_metrics)
        raw = {k: v.transpose(0, 1)[:keep] for k, v in raw.items()}  # (lanes, steps, ...)
        bound_loss = None
        if loss_fn is not None:
            real = chunk_data  # unsharded, the loss reads the chunk's real lanes only
            if data is not None and data_batched and keep < per:
                real = _take_lanes(chunk_data, torch.arange(keep, device=dev))
            bound_loss = _sliced_loss(loss_fn, real, tmpl.n_devices * q)
        # the chunk's real lanes; sharded, every rank's share gathered in rank order first
        real_lanes = ((lambda v: gather_ranks(v, group, world)[:take]) if sharded and gather else
                      (lambda v: v[:take]))
        chunk_metrics = _finalize_metrics(raw, bound_loss, None) if with_metrics else {}
        out = (real_lanes(x), {k: real_lanes(v) for k, v in chunk_metrics.items()},
               None if p_state is None else real_lanes(p_state), _map_state(state, real_lanes))
        return out, stats, len(lanes.attacks) + len(lanes.servers)

    def signature() -> tuple:
        """What the capacity depends on, the lane count aside: sweeps of any
        size share one tuning."""
        return ("grid", tuple(sorted({repr(c) for c in cfgs})), steps, optimizer, str(momentum_dtype), mode,
                shard, world, with_metrics, loss_fn is not None, _per_lane_sig(x0, None),
                _per_lane_sig(data, 0 if data_batched else None), "lanes" if lr_lanes is not None else "shared",
                _per_lane_sig(records, 1))

    return _GridPlan(run_chunk=run_chunk, signature=signature, n_lanes=n_lanes, n_sources=len(sources),
                     order=order, world=world, group=group, dev=dev)


def _plan_chunk(plan: _GridPlan, max_lanes_per_device: int | str | None, auto: bool) -> int:
    """Lanes per chunk of ``plan``'s call, ``"auto"`` resolved by the tuner."""
    if auto:
        max_lanes_per_device = _auto_capacity(plan.run_chunk, plan.n_lanes, plan.world, plan.group, plan.dev,
                                              plan.signature())
    return _resolve_chunk(plan.n_lanes, max_lanes_per_device, devices=plan.world, auto=auto)


def run_grid(
    cfgs: Sequence[ProtocolConfig],
    x0: torch.Tensor,
    subset_grad_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    *,
    steps: int,
    lr: float | Sequence[float] | torch.Tensor | Callable[[torch.Tensor], torch.Tensor],
    randomness: Sequence[RandomnessProvider | torch.Generator],
    draw_ids: Sequence[int] | None = None,
    data: Any = None,
    data_batched: bool = True,
    optimizer: str = "sgd",
    momentum_dtype: str | torch.dtype = "float32",
    grad_scale: float = 1.0,
    loss_fn: Callable[[Any, torch.Tensor], torch.Tensor] | None = None,
    shard: str = "none",
    group: Any = None,
    max_lanes_per_device: int | str | None = None,
    device: torch.device | str | None = None,
    mode: str = "loop",
    with_metrics: bool = True,
) -> TrajectoryResult:
    """Run a batch of trajectories as the lanes of one batched round.

    Lane ``i`` equals ``run_trajectory`` with ``cfgs[i]``, lane ``i``'s
    step size, data and randomness, bit for bit: every reduction of the
    round is a fixed tree or a kernel, and each lane reads its own records.

    Args:
      cfgs: one ``ProtocolConfig`` per lane. They share their static
        structure (everything but the attack and the aggregator) or this
        raises; group lanes into buckets first (``scenarios.run_grid``).
      x0: initial iterate ``(Q,)``, shared by the lanes.
      subset_grad_fn: ``(data, x (l, Q)) -> (l, N, Q)`` subset gradients of
        ``l`` lanes, ``data`` those lanes' slice of ``data`` (or ``data``
        itself with ``data_batched=False``).
      steps: rounds, shared.
      lr: step size, shared or one per lane (held as a float32 tensor: the
        same bits as the float), or a shared schedule ``t -> lr``.
      randomness: one source per draw group: a ``torch.Generator`` or a
        provider ``t -> RoundRandomness`` (checked as in
        ``run_trajectory``). Every round's records are drawn up front.
      draw_ids: each lane's draw group (``None``: lane ``i`` reads source
        ``i``). The lanes of a group must draw alike
        (``byzantine.draw_signature``).
      data: the problem, a tensor or a tuple, list or dict of tensors with
        a leading lane axis (``data_batched=True``), or shared.
      optimizer / momentum_dtype / grad_scale: as in ``run_trajectory``,
        shared; every lane has its own moments.
      loss_fn: optional ``(data, xs (l, T, Q)) -> (l, T)`` metric hook; the
        rounds are handed over in slices that bound its temporaries.
      shard: ``"none"``, or ``"shard_map"``/``"pmap"`` (one program, the
        two names the reference's): the lanes spread over the ``W`` ranks of
        ``group`` (``engine_ranks``). A chunk is padded to a multiple of
        ``W`` by replicating its last lane; rank ``r`` runs the ``r``-th
        contiguous share of the chunk's (sorted) lanes, and the results are
        gathered in rank order (eagerly, after the chunk's rounds), so every
        rank returns the whole, shape-identical result. Every rank must
        make the same call.
      group: the data group of a sharded run; see ``engine_ranks``.
      max_lanes_per_device: lanes per rank and chunk: the lanes run in
        equal chunks of ``max_lanes_per_device x W``, one after another, the
        last one padded by replicating its last lane (sliced off
        afterwards); ``None`` runs them all at once. ``"auto"`` takes the
        tuner's capacity (``launch.tuner``): the store's for this
        signature (the configurations, ``steps``, the optimizer, ``mode``,
        ``shard``, ``W``, each operand's per-lane shape and dtype, the
        device kind), else the fastest that fits, probed on one chunk of
        the sweep's own chunk path at capacities 1, 2, 4, ... (bisected
        at an out-of-memory error) and then stored; every rank of a
        sharded call agrees on each probe. Any capacity gives the same
        bits; ``last_grid_chunk_info()`` says which ran.
      device / mode / with_metrics: as in ``run_trajectory``; under
        ``"graph"`` each chunk captures one round and replays it.

    Returns:
      A ``TrajectoryResult`` with a leading ``(L,)`` axis on ``x``, the
      metrics (``(L, steps)``), the optimizer state's moments and the
      participation state; ``.lane(i)`` gives lane ``i``, and ``grid`` says
      how the lanes ran.
    """
    auto = _check_capacity(max_lanes_per_device)
    plan = _plan_grid(cfgs, x0, subset_grad_fn, steps=steps, lr=lr, randomness=randomness, draw_ids=draw_ids,
                      data=data, data_batched=data_batched, optimizer=optimizer, momentum_dtype=momentum_dtype,
                      grad_scale=grad_scale, loss_fn=loss_fn, shard=shard, group=group, device=device, mode=mode,
                      with_metrics=with_metrics)
    n_lanes, order, dev = plan.n_lanes, plan.order, plan.dev
    chunk = _plan_chunk(plan, max_lanes_per_device, auto)
    outs, graphs, n_branches = [], [], 0
    for start in range(0, n_lanes, chunk):
        out, stats, branches = plan.run_chunk(start, chunk)
        outs.append(out)
        n_branches += branches
        if stats is not None:
            graphs.append(stats)
    # undo the sort: sorted position j holds input lane order[j]
    inverse = torch.empty(n_lanes, dtype=torch.int64)
    inverse[torch.tensor(order)] = torch.arange(n_lanes)
    inverse = inverse.to(dev)
    x = torch.cat([o[0] for o in outs]).index_select(0, inverse)
    metrics = {k: torch.cat([o[1][k] for o in outs]).index_select(0, inverse) for k in outs[0][1]}
    p_state = None if outs[0][2] is None else torch.cat([o[2] for o in outs]).index_select(0, inverse)
    moments = [pytree.leaves((o[3].mu, o[3].nu)) for o in outs]
    state = outs[0][3]  # every chunk took the same steps
    opt_state = OptState(step=state.step, **dict(zip(("mu", "nu"), pytree.from_leaves(
        (state.mu, state.nu), [torch.cat(vs).index_select(0, inverse) for vs in zip(*moments)]))))
    stats = GridStats(lanes=n_lanes, draw_groups=plan.n_sources, chunk=chunk, chunks=len(outs),
                      branches=n_branches, graphs=tuple(graphs))
    return TrajectoryResult(x=x, opt_state=opt_state, metrics=metrics, participation_state=p_state, grid=stats)


def grid_launch_list(
    cfgs: Sequence[ProtocolConfig],
    x0: torch.Tensor,
    subset_grad_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    *,
    steps: int,
    max_lanes_per_device: int | str | None = None,
    **kw,
) -> dict[str, list[dict]]:
    """The kernel launches of one round of the first chunk a ``run_grid``
    call with the same arguments runs (``"auto"`` resolved through the
    tuner's store, probing if it holds nothing), per kernel: each launch's
    lanes, shape, bytes and fp32 operations (``kernels.ops.launch_work``).
    The counterpart of the reference's ``grid_compiled_hlo``, whose module
    ``launch.roofline.analyze_launches`` reads.

    In graph mode it is the chunk's captured round (``GraphStats.
    captured_work``, one entry for each of its ``captured_launches``); in
    loop mode one round of the chunk on the device it runs on, on the CPU
    the launches the card would make. A sharded call lists this rank's
    share of the chunk."""
    one_round = _plan_grid(cfgs, x0, subset_grad_fn, steps=1, **kw)
    if _check_capacity(max_lanes_per_device):  # tuned on the call's own rounds
        chunk = _plan_chunk(_plan_grid(cfgs, x0, subset_grad_fn, steps=steps, **kw), "auto", True)
    else:
        chunk = _resolve_chunk(one_round.n_lanes, max_lanes_per_device, devices=one_round.world)
    with kernel_ops.record_launches() as log:
        _, stats, _ = one_round.run_chunk(0, chunk, False)
    work = log if stats is None else stats.captured_work
    out: dict[str, list[dict]] = {name: [] for name in kernel_ops.KERNELS if name != "cwtm_nnm"}
    for launch in work:
        out[launch["kernel"]].append(launch)
    return out


def _sliced_loss(loss_fn: Callable, data: Any, row_elements: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """``xs (l, T, Q) -> loss_fn(data, xs)`` over slices of the rounds whose
    ``l x rounds x row_elements`` temporaries stay within _LOSS_ELEMENTS."""
    def loss(xs: torch.Tensor) -> torch.Tensor:
        per = max(1, _LOSS_ELEMENTS // max(1, xs.shape[0] * row_elements))
        return torch.cat([loss_fn(data, xs[:, s:s + per]) for s in range(0, xs.shape[1], per)], dim=1)
    return loss


def protocol_rounds(
    cfg: ProtocolConfig,
    subset_grads: torch.Tensor,
    rounds: int,
    *,
    randomness: RandomnessProvider | torch.Generator | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """``rounds`` independent protocol rounds on one ``(N, Q)`` gradient
    stack, run as the lanes of one batched round: the ``(rounds, Q)``
    aggregates. Round ``t`` reads the ``t``-th record of ``randomness`` (a
    generator on ``device``, seeded 0 when not given, or a provider), as
    ``run_trajectory`` would; under an active participation schedule every
    device reports. For estimates of an encoder's bias and variance."""
    dev = resolve_device(device)
    if randomness is None:
        randomness = torch.Generator(device=dev).manual_seed(0)
    q = subset_grads.shape[-1]
    rand = stack_rounds(draw_rounds(cfg, q, rounds, randomness), dev)
    grads = subset_grads.to(dev).expand((rounds,) + tuple(subset_grads.shape)).contiguous()
    return protocol_round(cfg, grads, rand, device=dev)


# --------------------------------------------------------------------------
# Program caches. The engine keeps no program between calls (a graph-mode
# run captures its round anew). The modules that do keep programs or the
# state they pin on the card (launch.train's captured round and apply
# programs, scenarios' lru-cached LM problems and configs) register them
# here, so that one call releases them all without core importing launch.
# --------------------------------------------------------------------------

_PROGRAM_CACHES: dict[str, tuple[Callable[[], None], Callable[[], int]]] = {}


def register_program_cache(name: str, clear_fn: Callable[[], None], size_fn: Callable[[], int]) -> None:
    """Register a program cache (its clear and current-size callables)
    under ``name`` for ``clear_program_caches`` and
    ``program_cache_sizes``; registering a name again replaces it."""
    _PROGRAM_CACHES[name] = (clear_fn, size_fn)


def program_cache_sizes() -> dict[str, int]:
    """The entry count of every registered program cache."""
    return {name: size_fn() for name, (_, size_fn) in _PROGRAM_CACHES.items()}


def clear_program_caches() -> dict[str, int]:
    """Release every registered program cache (and the card memory its
    captures pin); returns the entry counts dropped. After a clear the next
    step of a configuration builds and captures its programs once again,
    and the steps after it capture nothing. A benchmark calls this between
    phases, so that one phase's programs do not inflate the next one's
    footprint."""
    dropped = program_cache_sizes()
    for clear_fn, _ in _PROGRAM_CACHES.values():
        clear_fn()
    return dropped
