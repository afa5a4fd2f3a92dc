"""The LM train step through the protocol engine, and a thin trainer around it.

``build_engine_step`` is the reference's ``protocol_impl="engine"`` step:
the transformer's gradients go through ``byzantine.protocol_round``, the
assignment -> eq.-(5) encode -> compress -> attack -> robust-aggregate
pipeline of the linear-regression runs, at whole-model granularity. Per
microbatch, every data subset's gradient comes from one ``torch.func.vmap``
of ``grad_and_value`` over the N blocks of the batch, each leaf cast to fp32
into its slice of an ``(N, P)`` stack, and one protocol round aggregates the
stack. The optimizer then steps on the aggregate, unflattened into the
parameters' leaves, at the step's ``linear_warmup_cosine`` learning rate.

A round's records are a function of ``(tcfg.seed, step_idx, j)`` alone (``j``
the microbatch), drawn on the step's device: the counterpart of the
reference's ``fold_in(fold_in(PRNGKey(seed), step_idx), j)``, which is what
makes a resumed run equal the uninterrupted one bit for bit.

Two modes run the same step:

  * ``"loop"``: eager PyTorch;
  * ``"graph"`` (CUDA only; the reference's cached compiled programs): the
    round and the optimizer apply are each captured once as a CUDA graph
    and replayed on every later call. The caller's inputs are copied into
    the captures' static buffers and the records drawn into them outside
    the capture; the outputs are copied out, so they are the caller's own.
    Bit for bit equal to ``"loop"``.

The programs (and in graph mode their captures) are cached across
``build_engine_step`` calls on the configuration each reads
(``engine_program_cache_info``), so a warm step, and a second step built
from an equal configuration, capture nothing.

Sharded steps (``TrainConfig.shard``), the GSPMD ``"protomath"`` step and a
device mesh wait for ROADMAP A.9.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import models, pytree
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.base import ArchConfig, TrainConfig
from repro_torch.core import attacks as attack_lib
from repro_torch.core import compression as comp_lib
from repro_torch.core import engine as engine_lib
from repro_torch.core.byzantine import ProtocolConfig, RoundRandomness, protocol_round, sample_round_randomness
from repro_torch.core.coding import tree_spec, unflatten_pytree
from repro_torch.device import resolve_device
from repro_torch.models.transformer import unstack_periods
from repro_torch.numerics import stable_mean0
from repro_torch.optim import OptState, linear_warmup_cosine, make_optimizer

__all__ = ["make_round_config", "redundant_batch", "round_seed", "build_engine_step", "build_train_step",
           "engine_program_cache_info", "engine_program_cache_clear", "Trainer"]

RoundProvider = Callable[[int, int], RoundRandomness]


def make_round_config(tcfg: TrainConfig, n_subsets: int) -> ProtocolConfig:
    """Lower a ``TrainConfig`` to the ``ProtocolConfig`` the engine step
    hands ``protocol_round`` (the lowering a ``Scenario`` performs)."""
    if tcfg.protocol == "none":
        return ProtocolConfig(n_devices=n_subsets, d=1, method="plain", aggregator="mean", n_byz=0,
                              attack=attack_lib.AttackSpec(name="none"))
    method = "plain" if tcfg.protocol == "plain" else tcfg.protocol
    return ProtocolConfig(
        n_devices=n_subsets,
        d=1 if method == "plain" else tcfg.d,
        method=method,
        aggregator=tcfg.aggregator,
        trim_frac=tcfg.trim_frac,
        n_byz=tcfg.n_byz,
        attack=attack_lib.AttackSpec(name=tcfg.attack, n_byz=tcfg.n_byz),
        compression=comp_lib.spec_from(tcfg.compression, q_hat_frac=tcfg.q_hat_frac, levels=tcfg.quant_levels),
    )


def redundant_batch(batch: Any, d: int, n_devices: int) -> Any:
    """Cyclic gradient-coding redundancy in the global view: the batch's
    leading axis is device-blocked ``(N * b, ...)``, and device ``i`` also
    gets blocks ``i+1 .. i+d-1`` (mod N), as ``(N * d * b, ...)``."""
    if d <= 1:
        return batch

    def leaf(x: torch.Tensor) -> torch.Tensor:
        blocks = x.reshape((n_devices, x.shape[0] // n_devices) + tuple(x.shape[1:]))
        out = torch.cat([torch.roll(blocks, -j, dims=0) for j in range(d)], dim=1)  # (N, d*b, ...)
        return out.reshape((x.shape[0] * d,) + tuple(x.shape[1:]))

    return pytree.map_tree(leaf, batch)


_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def round_seed(seed: int, step_idx: int, j: int) -> int:
    """The generator seed of round ``(step_idx, j)`` of a run seeded
    ``seed``: splitmix64 folded over the three, 63 bits (the CPU generator
    reads its low 32, all of them mixed)."""
    return _splitmix64(_splitmix64(_splitmix64(seed) ^ step_idx) ^ j) >> 1


# Programs cached across build_engine_step calls, keyed on exactly the
# configuration each reads: the round on (arch, lowered ProtocolConfig,
# device), the apply on (optimizer, momentum dtype, lr, steps, weight decay,
# device). Under mode="graph" a program keeps its captures, one per
# batch shape (round) or parameter tree (apply); _ENGINE_CAPTURES counts the
# captures made, the test hook for the capture-free warm step.
_ENGINE_PROGRAMS: dict = {}
_ENGINE_CAPTURES = {"round": 0, "apply": 0}


def engine_program_cache_info() -> dict:
    """``{programs, round, apply}``: cached programs and the captures made
    (warm steps leave all three unchanged)."""
    return dict(programs=len(_ENGINE_PROGRAMS), **_ENGINE_CAPTURES)


def engine_program_cache_clear() -> None:
    _ENGINE_PROGRAMS.clear()


def _clone(tree: Any) -> Any:
    """``tree`` (dicts, lists, dataclasses of tensors) with every tensor cloned."""
    return pytree.with_paths(tree, {k: v.clone() for k, v in pytree.paths(tree)})


def _copy_into(dst: Any, src: Any) -> None:
    for (_, a), (_, b) in zip(pytree.paths(dst), pytree.paths(src), strict=True):
        a.copy_(b)


class _Capture:
    """One CUDA graph of ``fn`` over static copies of its first inputs.

    ``fn`` runs once on a side stream first (so first-use builds and
    library workspaces stay outside the capture), the cached blocks that
    run leaves behind are released, then ``fn`` is captured. A call copies
    its inputs into the static buffers and replays; the result is the
    capture's own outputs, overwritten by the next replay."""

    def __init__(self, fn: Callable, inputs: tuple, dev: torch.device):
        self.inputs = _clone(inputs)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # the warm-up's blocks would sit beside the capture's own pool
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*self.inputs)

    def __call__(self, *inputs):
        _copy_into(self.inputs, inputs)
        self.graph.replay()
        return self.outputs


class _Round:
    """``(params, tokens, labels, rand) -> (loss, metrics, g)``: every
    subset's gradient and loss, one protocol round on the ``(N, P)`` stack,
    the subsets' mean loss and metrics (``stable_mean0``)."""

    def __init__(self, cfg: ArchConfig, pcfg: ProtocolConfig, dev: torch.device):
        self.pcfg, self.dev = pcfg, dev

        def subset_loss(params, tokens, labels):
            return models.loss_fn(params, None, cfg, {"tokens": tokens, "labels": labels})

        self.per_subset = torch.func.vmap(torch.func.grad_and_value(subset_loss, has_aux=True),
                                          in_dims=(None, 0, 0))
        self.captures: dict[tuple, _Capture] = {}

    def __call__(self, params, tokens, labels, rand):
        # per-period views: a leaf's gradient comes out per period, with no
        # zero-filled (n_periods, ...) stack per layer
        grads, (losses, metrics) = self.per_subset(unstack_periods(params), tokens, labels)
        spec = tree_spec(params)
        stack = torch.empty((tokens.shape[0], sum(s.numel() for s in pytree.leaves(params))),
                            dtype=torch.float32, device=self.dev)
        for g, dst in zip(pytree.leaves(grads), pytree.leaves(unstack_periods(unflatten_pytree(stack, spec),
                                                                               lead=1))):
            dst.copy_(g)  # the leaf's gradient, cast to fp32, into its slice of every subset's row
        del grads
        g = protocol_round(self.pcfg, stack, rand, device=self.dev)
        return stable_mean0(losses), {k: stable_mean0(v) for k, v in metrics.items()}, g

    def captured(self, params, tokens, labels, rand):
        key = tuple(tokens.shape)
        if key not in self.captures:
            self.captures[key] = _Capture(self, (params, tokens, labels, rand), self.dev)
            _ENGINE_CAPTURES["round"] += 1
        return self.captures[key](params, tokens, labels, rand)


class _Apply:
    """``(params, opt_state, g, step_idx) -> (params, opt_state)``: the
    optimizer step on the aggregate ``g`` unflattened into the params'
    leaves, at the schedule's learning rate for ``step_idx`` (a 0-d int
    tensor on the device)."""

    def __init__(self, tcfg: TrainConfig, dev: torch.device):
        self.dev = dev
        self.opt = make_optimizer(tcfg.optimizer, momentum_dtype=tcfg.momentum_dtype)
        self.schedule = linear_warmup_cosine(tcfg.lr, warmup=max(tcfg.steps // 20, 1), total_steps=tcfg.steps)
        self.weight_decay = tcfg.weight_decay
        self.captures: dict[tuple, _Capture] = {}

    def __call__(self, params, opt_state: OptState, g: torch.Tensor, step_idx: torch.Tensor):
        grads = unflatten_pytree(g, tree_spec(params))
        return self.opt.update(params, grads, opt_state, self.schedule(step_idx), weight_decay=self.weight_decay)

    def _in_place(self, params, opt_state, g, step_idx):
        """The step written back into its input buffers (the capture's body)."""
        new_params, new_state = self(params, opt_state, g, step_idx)
        _copy_into((params, opt_state), (new_params, new_state))
        return params, opt_state

    def captured(self, params, opt_state, g, step_idx):
        key = tuple((tuple(v.shape), v.dtype) for _, v in pytree.paths((params, opt_state)))
        if key not in self.captures:
            self.captures[key] = _Capture(self._in_place, (params, opt_state, g, step_idx), self.dev)
            _ENGINE_CAPTURES["apply"] += 1
        return _clone(self.captures[key](params, opt_state, g, step_idx))


def _program(key: tuple, build: Callable):
    prog = _ENGINE_PROGRAMS.get(key)
    if prog is None:
        prog = _ENGINE_PROGRAMS[key] = build()
    return prog


def build_engine_step(cfg: ArchConfig, tcfg: TrainConfig, specs: Any = None, *,
                      device: torch.device | str | None = None, mode: str = "loop",
                      randomness: RoundProvider | None = None):
    """The protocol-engine train step.

    Returns ``(step, optimizer)``; ``step(params, opt_state, batch,
    step_idx) -> (new_params, new_opt_state, loss, metrics)``, where
    ``params`` is the model's tree in ``cfg.dtype`` (norm scales fp32),
    ``batch`` holds ``tokens`` and ``labels`` ``(N * rows, S)`` whose leading
    axis is blocked into the ``N = tcfg.n_subsets`` subsets, and
    ``step_idx`` an int (or a 0-d integer tensor). Per microbatch ``j`` (a
    slice of every block's rows), one round under round ``(step_idx, j)``'s
    records; with ``tcfg.microbatches > 1`` the aggregates are summed in
    fp32 in microbatch order and divided by the count, and the loss and
    metrics are ``stable_mean0`` over the subsets, then over the
    microbatches. The step never writes into its inputs.

    Args:
      cfg, tcfg: the architecture and the run (protocol, optimizer,
        schedule, ``seed``, ``microbatches``). ``tcfg.remat`` is accepted
        and changes no value: ``torch.utils.checkpoint`` does not compose
        with ``torch.func.vmap``, so the port does not recompute.
      specs: the logical-axis tree of ``models.init``; read by nothing
        until the sharded step (ROADMAP A.9).
      device: where the step runs; ``cuda`` when not given.
      mode: ``"loop"`` or ``"graph"`` (CUDA only), see the module docstring.
      randomness: ``(step_idx, j) -> RoundRandomness`` in place of the
        seeded draws (the tests replay the reference's keys); its records
        are checked with ``RoundRandomness.validate``.
    """
    del specs
    if tcfg.shard != "none":
        raise ValueError(f"shard={tcfg.shard!r}: the sharded engine step waits for ROADMAP A.9")
    if tcfg.n_subsets is None:
        raise ValueError("tcfg.n_subsets is required: taking N from a device mesh waits for ROADMAP A.9")
    dev = resolve_device(device)
    engine_lib._check_mode(mode, dev)
    n_sub, m = tcfg.n_subsets, max(1, tcfg.microbatches)
    pcfg = make_round_config(tcfg, n_sub)
    round_prog = _program(("round", cfg, pcfg, dev), lambda: _Round(cfg, pcfg, dev))
    apply_prog = _program(("apply", tcfg.optimizer, tcfg.momentum_dtype, tcfg.lr, tcfg.steps, tcfg.weight_decay,
                           dev), lambda: _Apply(tcfg, dev))
    run_round = round_prog if mode == "loop" else round_prog.captured
    run_apply = apply_prog if mode == "loop" else apply_prog.captured

    def records(step_idx: int, j: int, q: int) -> RoundRandomness:
        if randomness is None:
            gen = torch.Generator(device=dev).manual_seed(round_seed(tcfg.seed, step_idx, j))
            return sample_round_randomness(pcfg, q, gen)
        rand = randomness(step_idx, j)
        rand.validate(n_sub, q)
        return rand.to(dev)

    def step(params, opt_state: OptState, batch: dict, step_idx):
        step_idx = int(step_idx)
        q = sum(v.numel() for v in pytree.leaves(params))
        tokens, labels = (batch[k].to(dev) for k in ("tokens", "labels"))
        if tokens.shape[0] % n_sub != 0:
            raise ValueError(f"batch of {tokens.shape[0]} rows does not split into {n_sub} subsets")
        rows = tokens.shape[0] // n_sub
        if rows % m != 0:
            raise ValueError(f"{rows} rows a subset do not split into {m} microbatches")
        tokens, labels = (x.reshape((n_sub, rows) + tuple(x.shape[1:])) for x in (tokens, labels))
        sl = rows // m
        g = None
        per = []
        for j in range(m):
            loss_j, metrics_j, g_j = run_round(params, tokens[:, j * sl:(j + 1) * sl].contiguous(),
                                               labels[:, j * sl:(j + 1) * sl].contiguous(), records(step_idx, j, q))
            per.append(_clone((loss_j, metrics_j)))  # a replay overwrites a capture's outputs
            if m == 1:
                g = g_j
            else:  # fp32, in microbatch order
                g = g_j.clone() if g is None else g + g_j
        if m == 1:
            loss, metrics = per[0]
        else:
            g = g / m
            loss = stable_mean0(torch.stack([l for l, _ in per]))
            metrics = {k: stable_mean0(torch.stack([met[k] for _, met in per])) for k in per[0][1]}
        new_params, new_state = run_apply(params, opt_state, g,
                                          torch.tensor(step_idx, dtype=torch.int32, device=dev))
        return new_params, new_state, loss, metrics

    return step, apply_prog.opt


def build_train_step(cfg: ArchConfig, tcfg: TrainConfig, specs: Any = None, *,
                     device: torch.device | str | None = None, mode: str = "loop",
                     randomness: RoundProvider | None = None):
    """Returns ``(step, optimizer)``: ``build_engine_step`` for
    ``tcfg.protocol_impl == "engine"``. The GSPMD ``"protomath"`` step
    waits for ROADMAP A.9."""
    if tcfg.protocol_impl == "protomath":
        raise ValueError("protocol_impl='protomath', the GSPMD-sharded step, waits for ROADMAP A.9; "
                         "use protocol_impl='engine'")
    if tcfg.protocol_impl != "engine":
        raise ValueError(f"unknown protocol_impl {tcfg.protocol_impl!r}")
    return build_engine_step(cfg, tcfg, specs, device=device, mode=mode, randomness=randomness)


@dataclasses.dataclass
class Trainer:
    """A thin trainer over the engine step: the model initialised
    from a CPU generator seeded ``tcfg.seed`` (the same weights on every
    device) and moved to ``device``, the step, and the optimizer state."""

    cfg: ArchConfig
    tcfg: TrainConfig
    device: torch.device | str | None = None
    mode: str = "loop"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        params, self.specs = models.init(torch.Generator().manual_seed(self.tcfg.seed), self.cfg)
        self.params = pytree.map_tree(lambda a: a.to(self.device), params)
        self.step_fn, self.opt = build_train_step(self.cfg, self.tcfg, self.specs, device=self.device,
                                                  mode=self.mode)
        self.opt_state = self.opt.init(self.params)
        self.step = 0

    def run(self, batches, log_every: int = 10) -> list[tuple[int, float]]:
        """One step a batch, ``step_idx`` counting from 0; returns ``(i,
        loss)`` every ``log_every`` steps and at ``tcfg.steps - 1``."""
        history = []
        for i, batch in enumerate(batches):
            self.params, self.opt_state, loss, _ = self.step_fn(self.params, self.opt_state, batch, i)
            self.step = i + 1
            if i % log_every == 0 or i == self.tcfg.steps - 1:
                history.append((i, float(loss)))
        return history

    def save(self, path: str) -> None:
        """Write the current params, the step and the specs as a checkpoint."""
        save_checkpoint(path, self.params, step=self.step, specs=self.specs)

    def eval_loss(self, batch: dict) -> float:
        """Next-token loss of the current params on one batch."""
        with torch.no_grad():
            loss, _ = models.loss_fn(self.params, self.specs, self.cfg,
                                     {k: batch[k].to(self.device) for k in ("tokens", "labels")})
        return float(loss)
