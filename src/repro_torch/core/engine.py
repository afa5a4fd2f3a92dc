"""The multi-round trainer: protocol rounds plus optimizer steps.

``run_trajectory`` runs ``steps`` rounds. Each round computes every subset
gradient at the iterate, runs ``protocol_round`` with that round's
``RoundRandomness`` and takes an optimizer step. The round keeps its raw
vectors (aggregate, honest subset mean, new iterate), and the per-round
metrics are computed from the stacked vectors after the last round with
fixed-tree reductions, as the reference's ``_finalize_metrics`` does.

Under an active participation schedule a round also carries the schedule
state (the previous mask, which ``"markov"`` evolves), draws its mask from
the round's ``part_u``, ``t`` and that state, and records its reporting
count as the metric ``n_report``.

Two modes run the same rounds:

  * ``"loop"``: a Python loop, each round's randomness drawn as it starts;
  * ``"graph"`` (the reference's ``scan``; CUDA only): every round's
    randomness is drawn up front in round order and stacked on the card,
    one round is captured as a CUDA graph and replayed ``steps`` times. A
    step counter on the card, advanced inside the graph, selects the
    round's records and the rows of the preallocated ``(steps, ...)``
    output buffers. Graph mode equals loop mode bit for bit.
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
from repro_torch.kernels import ops as kernel_ops
from repro_torch.numerics import stable_mean0, stable_norm, tree_sum
from repro_torch.optim import OptState, make_optimizer

__all__ = ["TrajectoryResult", "GraphStats", "RandomnessProvider", "run_trajectory",
           "draw_rounds", "stack_rounds", "select_round"]

RandomnessProvider = Callable[[int], RoundRandomness]


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
    """

    replays: int
    captured_launches: dict[str, int]
    replay_start: torch.cuda.Event
    replay_end: torch.cuda.Event

    def replay_ms(self) -> float:
        """Milliseconds from the first replay's start to the last one's end
        (waits for the last replay)."""
        self.replay_end.synchronize()
        return self.replay_start.elapsed_time(self.replay_end)


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
      graph: the capture's launch counts and replay events under
        ``mode="graph"``, else ``None``.
    """

    x: torch.Tensor
    opt_state: OptState
    metrics: dict[str, torch.Tensor]
    participation_state: torch.Tensor | None = None
    graph: GraphStats | None = None


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
    ``RoundRandomness.validate``. What ``"graph"`` draws up front, and what
    ``"loop"`` draws one round at a time."""
    return [_draw(cfg, q, randomness, t) for t in range(steps)]


def stack_rounds(rounds: list[RoundRandomness], device: torch.device | str) -> RoundRandomness:
    """The records of ``rounds`` as one record of ``(steps, ...)`` tensors on
    ``device``."""
    return RoundRandomness(**{
        f.name: None if getattr(rounds[0], f.name) is None
        else torch.stack([getattr(r, f.name) for r in rounds]).to(device)
        for f in dataclasses.fields(RoundRandomness)
    })


def select_round(stacked: RoundRandomness, t: torch.Tensor) -> RoundRandomness:
    """Round ``t``'s record of a ``stack_rounds`` record; ``t`` is a 0-d
    int64 tensor on the records' device, so nothing is read back."""
    idx = t.reshape(1)
    return RoundRandomness(**{
        f.name: None if getattr(stacked, f.name) is None
        else getattr(stacked, f.name).index_select(0, idx)[0]
        for f in dataclasses.fields(RoundRandomness)
    })


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
    mode: str = "loop",
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
      mode: ``"loop"`` or ``"graph"`` (see the module docstring). Graph mode
        needs a CUDA device and raises on any other; it draws all rounds'
        randomness before the first round (``steps`` records on the card),
        runs one round eagerly on copies of the state (building the kernels
        and setting their attributes outside the capture), captures one
        round and replays it.
    """
    if mode not in ("loop", "graph"):
        raise ValueError(f"unknown mode {mode!r}; have 'loop' and 'graph'")
    dev = resolve_device(device)
    if mode == "graph" and dev.type != "cuda":
        raise ValueError(f"mode='graph' captures a CUDA graph and needs a CUDA device, not {dev}")
    opt = make_optimizer(optimizer)
    x = x0.to(dev)
    state = opt.init(x) if opt_state is None else opt_state
    q = x.shape[-1]
    n = cfg.n_devices
    if randomness is None:
        randomness = torch.Generator(device=dev).manual_seed(0)

    grads_of = (lambda x: subset_grad_fn(data, x)) if data is not None else subset_grad_fn
    attack_fn = make_attack_fn(cfg)
    server_fn = make_server_fn(cfg)
    p_spec = cfg.participation
    p_state = None
    if p_spec.active:
        p_state = (init_participation_state(p_spec, n, device=dev)
                   if participation_state is None else participation_state.to(dev))

    def one_round(x, rand, t, p_state, state):
        """One round at iterate ``x``: (new x, aggregate, honest subset
        mean, schedule state, reporting count or None, optimizer state)."""
        grads = grads_of(x)
        pm = n_report = None
        if p_spec.active:
            pm, p_state = sample_participation(p_spec, rand.part_u, t, n, p_state)
            n_report = tree_sum(pm, dim=0)
        g = protocol_round(cfg, grads, rand, device=dev, attack_fn=attack_fn,
                           server_fn=server_fn, participation_mask=pm)
        new_x, state = opt.update(x, grad_scale * g, state, lr)
        return new_x, g, stable_mean0(grads), p_state, n_report, state

    names = ("g", "gmean", "x") + (("n_report",) if p_spec.active else ())
    graph_stats = None
    if mode == "loop":
        raw: dict[str, list[torch.Tensor]] = {k: [] for k in names}
        for t in range(steps):
            rand = _draw(cfg, q, randomness, t).to(dev)
            x, g, gmean, p_state, n_report, state = one_round(x, rand, t, p_state, state)
            for k, v in zip(names, (g, gmean, x, n_report)):
                raw[k].append(v)
        stacked = {k: torch.stack(v) for k, v in raw.items()}
    else:
        records = stack_rounds(draw_rounds(cfg, q, steps, randomness), dev)
        stacked, x, p_state, graph_stats = _replay_graph(
            lambda x, rand, t, p: one_round(x, rand, t, p, state)[:5], records, x, p_state, steps, names)
        # the replays ran the tensor part of each step; SGD's state is its step count
        state = dataclasses.replace(state, step=state.step + steps)
    bound_loss = None
    if loss_fn is not None:
        bound_loss = (lambda xs: loss_fn(data, xs)) if data is not None else loss_fn
    return TrajectoryResult(x=x, opt_state=state, participation_state=p_state, graph=graph_stats,
                            metrics=_finalize_metrics(stacked, bound_loss, x_star))


def _replay_graph(one_round, records: RoundRandomness, x: torch.Tensor, p_state, steps: int,
                  names: tuple[str, ...]):
    """Capture one round of ``one_round`` that reads round ``t``'s records
    and writes row ``t`` of the output buffers, then replay it ``steps``
    times.

    Returns (the stacked outputs, the last iterate, the schedule state,
    ``GraphStats``)."""
    dev = x.device
    rows = {"g": x.shape, "gmean": x.shape, "x": x.shape, "n_report": ()}

    def buffers():
        """The state a round reads and writes: iterate, step counter,
        schedule state, output rows."""
        return {"x": x.clone(), "t": torch.zeros((), dtype=torch.int64, device=dev),
                "p_state": None if p_state is None else p_state.clone(),
                "out": {k: torch.empty((steps, *rows[k]), dtype=torch.float32, device=dev) for k in names}}

    def step(bufs):
        t = bufs["t"]
        new_x, g, gmean, new_p, n_report = one_round(bufs["x"], select_round(records, t), t, bufs["p_state"])
        for k, v in zip(names, (g, gmean, new_x, n_report)):
            bufs["out"][k].index_copy_(0, t.reshape(1), v[None])
        bufs["x"].copy_(new_x)
        if new_p is not None:
            bufs["p_state"].copy_(new_p)
        t.add_(1)

    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step(buffers())  # on copies: first-use builds and kernel attributes stay outside the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    live = buffers()
    graph = torch.cuda.CUDAGraph()
    before = kernel_ops.launch_counts()
    with torch.cuda.graph(graph):
        step(live)
    after = kernel_ops.launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        graph.replay()
    end.record()
    stats = GraphStats(replays=steps, captured_launches={k: after[k] - before[k] for k in after},
                       replay_start=start, replay_end=end)
    return live["out"], live["x"], live["p_state"], stats
