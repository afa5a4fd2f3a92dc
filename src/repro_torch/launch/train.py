"""The LM train steps, and a thin trainer around them.

``build_train_step`` builds one of two realizations of the step, chosen by
``TrainConfig.protocol_impl``, as in the reference:

``"protomath"`` (the reference's default): the per-parameter exchange of
``core.protomath`` over a ``launch.mesh`` mesh of data and model ranks.
Each rank stores only its cut of the parameters and the optimizer's
moments (``param_pspecs``, ``shard_tree``): a leaf's ``fsdp`` dim cut over
the data ranks, its ``tp`` dim over the model ranks, where each divides.
The batch gets its
cyclic ``d``-fold redundancy (``redundant_batch``); each rank takes its
``N/W`` device blocks of it, splits each block's rows into the
microbatches, and runs the forward and backward under
``protocol_context``: every parameter's cotangent is computed per device
block, compressed, attacked and robustly aggregated inside the backward
(``sharded`` or ``gather`` server). The aggregates are summed in fp32
over the microbatches and divided by their count, the optimizer steps at
the ``linear_warmup_cosine`` learning rate on the cuts, and the loss and
metrics are averaged over the ranks. No ``(N, P)`` stack exists: the
largest buffer is one parameter's ``(N/W, *w/model)`` block. Tensor
parallelism (model > 1) takes every family: heads (or, under
``attn_tp="head_dim"``, ``head_dim``) cut, the q heads alone where the kv
heads do not split, MoE's experts, Mamba's ``d_inner``, RWKV's heads, the
cross-attention and the whisper encoder (``models``' modules say how each
runs on its cut). Loop mode only;
``tcfg.remat`` changes no value (nothing is recomputed, so no draw moves).

``"engine"`` (``build_engine_step``): the transformer's gradients go
through ``byzantine.protocol_round``, the assignment -> eq.-(5) encode ->
compress -> attack -> robust-aggregate pipeline of the linear-regression
runs, at whole-model granularity. Every leaf of the batch (``tokens``,
``labels`` and the vlm and audio families' ``frontend``) is blocked into
the N subsets (``block_batch``). Per microbatch, every data subset's
gradient comes from one ``torch.func.vmap`` of ``grad_and_value`` over the
N blocks, each leaf cast to fp32 into its slice of an ``(N, P)`` stack,
and one protocol round aggregates the stack. The optimizer then steps on
the aggregate, unflattened into the parameters' leaves, at the step's
``linear_warmup_cosine`` learning rate.

With ``TrainConfig.shard`` ``"shard_map"`` or ``"pmap"`` (the reference's
two substrates; here one program) the subset fan-out is spread over the
``W`` ranks of the mesh's data group (``engine.engine_ranks``), as the
reference's ``_build_round_program``'s ``per_device``: N is padded to a
multiple of ``W`` by replicating the last subset's block, each rank runs
the vmapped gradient of its ``N_pad / W`` contiguous subsets, and the
losses, metrics and ``(n_local, P)`` gradient rows are gathered in rank
order into the ``(N, P)`` stack, the padding rows dropped. Every rank then
runs the same round (its own records, from the same seed) and the same
apply, so every rank holds the same parameters, bit for bit those of
``shard="none"``. Loop mode only: the gather sits inside the round, and
graph mode of the sharded step waits for ROADMAP A.14.

A step's draws are a function of ``(tcfg.seed, step_idx, j)`` alone (``j``
the microbatch), drawn on the step's device: the counterpart of the
reference's ``fold_in(fold_in(PRNGKey(seed), step_idx), j)``, which is what
makes a resumed run equal the uninterrupted one bit for bit.

The engine step runs in two modes:

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

``tcfg.n_subsets=None`` takes N from the mesh's data axes, as the
reference's ``tcfg.n_subsets or n_data_devices(mesh)``; the engine step
leaves a mesh's model axis unused, as the reference's does.
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
from repro_torch.core.protomath import BlockedProtocol, _all_gather, fold_seed, protocol_context
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh, data_axes, n_data_devices
from repro_torch.launch.roofline import param_shapes_and_specs
from repro_torch.models.module import logical_to_mesh
from repro_torch.models.transformer import unstack_periods
from repro_torch.numerics import stable_mean0
from repro_torch.optim import OptState, linear_warmup_cosine, make_optimizer

__all__ = ["make_protocol", "make_round_config", "param_mesh_rules", "param_pspecs", "batch_pspec",
           "opt_state_shardings", "shard_tree", "gather_tree", "block_batch", "redundant_batch", "round_seed",
           "build_protomath_step", "build_engine_step", "build_train_step", "engine_program_cache_info",
           "engine_program_cache_clear", "Trainer"]

RoundProvider = Callable[[int, int], RoundRandomness]


def make_protocol(tcfg: TrainConfig, mesh: Mesh) -> BlockedProtocol:
    """The ``BlockedProtocol`` of a run on ``mesh``: N from its data axes,
    ``model_size`` its model ranks."""
    return BlockedProtocol(
        n_devices=n_data_devices(mesh),
        data_axes=data_axes(mesh),
        aggregator=tcfg.aggregator,
        trim_frac=tcfg.trim_frac,
        n_byz=tcfg.n_byz,
        attack=attack_lib.AttackSpec(name=tcfg.attack, n_byz=tcfg.n_byz),
        compression=comp_lib.spec_from(tcfg.compression, q_hat_frac=tcfg.q_hat_frac, levels=tcfg.quant_levels),
        server=tcfg.server,
        honest_mean=(tcfg.protocol == "none"),
        model_size=mesh.model,
    )


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


# --- placements: the reference's partition specs, one tuple a leaf --------------


def param_mesh_rules(mesh: Mesh) -> dict:
    axes = data_axes(mesh)
    return {"fsdp": axes if len(axes) > 1 else axes[0], "tp": "model", "stack": None}


def param_pspecs(specs: Any, mesh: Mesh, shapes: Any = None) -> Any:
    """Each leaf's partition spec on ``mesh`` (``models.module.
    logical_to_mesh`` under ``param_mesh_rules``): ``fsdp`` on the data
    axes, ``tp`` on ``model``, a dim that does not divide replicated."""
    return logical_to_mesh(specs, mesh, rules=param_mesh_rules(mesh), shapes=shapes)


def batch_pspec(mesh: Mesh, extra_dims: int = 1) -> tuple:
    axes = data_axes(mesh)
    return (axes if len(axes) > 1 else axes[0],) + (None,) * extra_dims


def opt_state_shardings(opt_shapes: OptState, param_placements: Any, mesh: Mesh) -> OptState:
    """The optimizer state's placements: the moments mirror the params',
    the step is replicated (``()``)."""
    del mesh

    def mirror(moment):
        return () if moment == () or moment is None else param_placements

    return OptState(step=(), mu=mirror(opt_shapes.mu), nu=mirror(opt_shapes.nu))


def _ranks_along(mesh: Mesh, entry) -> tuple[int, int]:
    """(ranks, this rank's index) along a placement entry."""
    if entry is None:
        return 1, 0
    if entry == "model":
        return mesh.model, mesh.model_rank
    if (entry == "data" and not mesh.pod) or tuple(entry) == ("pod", "data"):
        return mesh.world, mesh.rank
    raise ValueError(f"no ranks for the placement entry {entry!r} on a mesh of axes {mesh.axis_names}")


def _placed(fn: Callable, tree: Any, placements: Any) -> Any:
    """``fn(leaf, placement)`` over a dict tree and its placements."""
    if isinstance(tree, dict):
        return {k: _placed(fn, v, placements[k]) for k, v in tree.items()}
    return fn(tree, placements)


def shard_tree(tree: Any, placements: Any, mesh: Mesh) -> Any:
    """This rank's cut of a whole ``tree`` (a copy of each leaf's): each
    dim placed on an axis narrowed to this rank's part of it. The port's
    ``shardings_for`` and ``device_put``."""
    def cut(leaf, placement):
        for dim, entry in enumerate(placement):
            n, i = _ranks_along(mesh, entry)
            leaf = leaf.narrow(dim, i * (leaf.shape[dim] // n), leaf.shape[dim] // n)
        return leaf.clone()

    return _placed(cut, tree, placements)


def gather_tree(tree: Any, placements: Any, mesh: Mesh) -> Any:
    """The whole tree back from every rank's cut (``shard_tree``'s), on
    every rank: each cut dim all-gathered over its group."""
    def whole(leaf, placement):
        for dim, entry in enumerate(placement):
            n, _ = _ranks_along(mesh, entry)
            if n > 1:
                group = mesh.model_group if entry == "model" else mesh.group
                leaf = _all_gather(leaf.movedim(dim, 0), group, n).movedim(0, dim)
        return leaf.contiguous()

    return _placed(whole, tree, placements)


def _cuts(tree: Any, placements: Any, mesh: Mesh, out: dict) -> dict:
    """``{id(leaf): cut}`` for every leaf of ``tree`` (``_grad_leaves``'
    per-period form) that is cut on ``mesh``: per dim ``"model"``,
    ``"data"`` or ``None``, an axis of one rank counting as no cut."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _cuts(v, placements[k], mesh, out)
    elif isinstance(tree, list):  # per-period views of stacked leaves: the stack dim dropped
        for v in tree:
            _cuts(v, _placed(lambda _, pl: pl[1:], placements, placements), mesh, out)
    else:
        cut = tuple(None if _ranks_along(mesh, e)[0] == 1 else ("model" if e == "model" else "data")
                    for e in placements)
        if any(cut):
            out[id(tree)] = cut
    return out


def block_batch(batch: dict, n: int, what: str = "subsets") -> dict:
    """Every leaf of ``batch`` blocked ``(n * rows, ...) -> (n, rows, ...)``,
    as the reference's ``jax.tree.map(blocked, batch)``; raises when a
    leaf's rows do not split into ``n`` ``what``."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n != 0:
            raise ValueError(f"batch leaf {k!r} of {v.shape[0]} rows does not split into {n} {what}")
        out[k] = v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
    return out


def redundant_batch(batch: dict, d: int, n_devices: int) -> dict:
    """Cyclic gradient-coding redundancy in the global view: the batch's
    leading axis is device-blocked ``(N * b, ...)``, and device ``i`` also
    gets blocks ``i+1 .. i+d-1`` (mod N), as ``(N * d * b, ...)``."""
    if d <= 1:
        return batch
    out = {}
    for k, blocks in block_batch(batch, n_devices, "device blocks").items():
        rolled = torch.cat([torch.roll(blocks, -j, dims=0) for j in range(d)], dim=1)  # (N, d*b, ...)
        out[k] = rolled.reshape((-1,) + tuple(blocks.shape[2:]))
    return out


def round_seed(seed: int, step_idx: int, j: int) -> int:
    """The generator seed of round ``(step_idx, j)`` of a run seeded
    ``seed``: splitmix64 folded over the three, 63 bits (the CPU generator
    reads its low 32, all of them mixed)."""
    return fold_seed(seed, step_idx, j)


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
    """``(params, blocks, rand) -> (loss, metrics, g)``: every subset's
    gradient and loss from the ``(N, rows, ...)`` blocked (micro)batch
    ``blocks``, one protocol round on the ``(N, P)`` stack, the subsets'
    mean loss and metrics (``stable_mean0``).

    With ``ranks = (group, world, rank)`` the fan-out is spread over the
    ranks: the blocks padded to ``N_pad`` (a multiple of ``world``) by
    replicating the last one, this rank's ``N_pad / world`` contiguous
    blocks through the vmapped gradient, the losses, metrics and gradient
    rows gathered in rank order and the padding dropped; the round runs on
    the whole stack on every rank."""

    def __init__(self, cfg: ArchConfig, pcfg: ProtocolConfig, dev: torch.device,
                 ranks: tuple[Any, int, int] | None = None):
        self.pcfg, self.dev, self.ranks = pcfg, dev, ranks

        def subset_loss(params, sub_batch):
            return models.loss_fn(params, None, cfg, sub_batch)

        self.per_subset = torch.func.vmap(torch.func.grad_and_value(subset_loss, has_aux=True), in_dims=(None, 0))
        self.captures: dict[tuple, _Capture] = {}

    def __call__(self, params, blocks: dict, rand):
        n = self.pcfg.n_devices
        if self.ranks is not None:
            group, world, rank = self.ranks
            per = engine_lib.padded_lane_count(n, world) // world
            blocks = {k: engine_lib.pad_lanes(v, per * world - n)[rank * per:(rank + 1) * per]
                      for k, v in blocks.items()}
        # per-period views: a leaf's gradient comes out per period, with no
        # zero-filled (n_periods, ...) stack per layer
        grads, (losses, metrics) = self.per_subset(unstack_periods(params), blocks)
        spec = tree_spec(params)
        stack = torch.empty((losses.shape[0], sum(s.numel() for s in pytree.leaves(params))),
                            dtype=torch.float32, device=self.dev)
        for g, dst in zip(pytree.leaves(grads), pytree.leaves(unstack_periods(unflatten_pytree(stack, spec),
                                                                               lead=1))):
            dst.copy_(g)  # the leaf's gradient, cast to fp32, into its slice of every subset's row
        del grads
        if self.ranks is not None:  # the (N, P) stack, the losses and the metrics, in rank order: two gathers
            stack = engine_lib.gather_ranks(stack, group, world)[:n]
            cols = engine_lib.gather_ranks(torch.stack([losses, *metrics.values()], dim=1), group, world)[:n]
            losses, metrics = cols[:, 0], {k: cols[:, i + 1] for i, k in enumerate(metrics)}
        g = protocol_round(self.pcfg, stack, rand, device=self.dev)
        return stable_mean0(losses), {k: stable_mean0(v) for k, v in metrics.items()}, g

    def captured(self, params, blocks: dict, rand):
        key = tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(blocks.items()))
        if key not in self.captures:
            self.captures[key] = _Capture(self, (params, blocks, rand), self.dev)
            _ENGINE_CAPTURES["round"] += 1
        return self.captures[key](params, blocks, rand)


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


def build_engine_step(cfg: ArchConfig, tcfg: TrainConfig, specs: Any = None, *, mesh: Mesh | None = None,
                      device: torch.device | str | None = None, mode: str = "loop",
                      randomness: RoundProvider | None = None):
    """The protocol-engine train step.

    Returns ``(step, optimizer)``; ``step(params, opt_state, batch,
    step_idx) -> (new_params, new_opt_state, loss, metrics)``, where
    ``params`` is the model's tree in ``cfg.dtype`` (norm scales fp32),
    ``batch`` holds ``tokens`` and ``labels`` ``(N * rows, S)`` (and for the
    vlm and audio families ``frontend``, ``(N * rows, n_frontend_tokens,
    d_frontend)``), every leaf's leading axis blocked into the N subsets,
    and ``step_idx`` an int (or a 0-d integer tensor). Per microbatch ``j``
    (a slice of every block's rows), one round under round ``(step_idx,
    j)``'s records; with ``tcfg.microbatches > 1`` the aggregates are summed
    in fp32 in microbatch order and divided by the count, and the loss and
    metrics are ``stable_mean0`` over the subsets, then over the
    microbatches. The step never writes into its inputs. Sharded, every
    rank of the group calls it with the same global batch and gets the
    same result.

    Args:
      cfg, tcfg: the architecture and the run (protocol, optimizer,
        schedule, ``seed``, ``microbatches``, ``shard``). N is
        ``tcfg.n_subsets``, or ``n_data_devices(mesh)`` when that is ``None``.
        ``tcfg.remat`` is accepted and changes no value:
        ``torch.utils.checkpoint`` does not compose with ``torch.func.vmap``,
        so the port does not recompute.
      specs: the logical-axis tree of ``models.init``; the engine step
        reads none of it.
      mesh: ``launch.mesh.make_host_mesh``'s mesh: N when
        ``tcfg.n_subsets`` is ``None``, and the data group a sharded step
        spreads over (without a mesh, ``engine.engine_ranks()``'s).
      device: where the step runs; ``cuda`` when not given.
      mode: ``"loop"`` or ``"graph"`` (CUDA only, unsharded), see the
        module docstring.
      randomness: ``(step_idx, j) -> RoundRandomness`` in place of the
        seeded draws (the tests replay the reference's keys), called on
        every rank; its records are checked with
        ``RoundRandomness.validate``.
    """
    del specs
    if tcfg.shard not in engine_lib.SHARD_MODES:
        raise ValueError(f"unknown engine shard mode {tcfg.shard!r}: expected 'none', 'pmap' or 'shard_map'")
    n_sub = tcfg.n_subsets or (None if mesh is None else n_data_devices(mesh))
    if n_sub is None:
        raise ValueError("tcfg.n_subsets is None and no mesh is given to take N from")
    if tcfg.shard != "none" and mode == "graph":
        raise ValueError(f"mode='graph' with shard={tcfg.shard!r}: graph mode of the sharded engine step waits "
                         "for ROADMAP A.14; run it in loop mode")
    dev = resolve_device(device)
    engine_lib._check_mode(mode, dev)
    ranks = None if tcfg.shard == "none" else engine_lib.engine_ranks(None if mesh is None else mesh.group)
    m = max(1, tcfg.microbatches)
    pcfg = make_round_config(tcfg, n_sub)
    round_prog = _program(("round", cfg, pcfg, dev, ranks), lambda: _Round(cfg, pcfg, dev, ranks))
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
        blocks = block_batch({k: v.to(dev) for k, v in batch.items()}, n_sub)
        rows = blocks["tokens"].shape[1]
        if rows % m != 0:
            raise ValueError(f"{rows} rows a subset do not split into {m} microbatches")
        sl = rows // m
        g = None
        per = []
        for j in range(m):
            loss_j, metrics_j, g_j = run_round(params, {k: v[:, j * sl:(j + 1) * sl].contiguous()
                                                        for k, v in blocks.items()}, records(step_idx, j, q))
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


def _grad_leaves(params) -> Any:
    """``params`` with the periods (and the encoder's layers) as
    per-period views, each leaf detached to a tensor of its own that
    requires grad: a gradient comes out per period, with no zero-filled
    stack per layer."""
    return pytree.map_tree(lambda a: a.detach().requires_grad_(), unstack_periods(params))


def _restack(grads) -> Any:
    """Per-period gradients (``_grad_leaves``' layout) stacked back into
    the parameters' layout."""
    out = dict(grads)
    for key in ("periods", "encoder"):
        if isinstance(grads.get(key), list):
            out[key] = pytree.map_tree(lambda *xs: torch.stack(xs), *grads[key])
    return out


def build_protomath_step(cfg: ArchConfig, tcfg: TrainConfig, specs: Any = None, *, mesh: Mesh,
                         device: torch.device | str | None = None):
    """The ``"protomath"`` train step over ``mesh``'s data and model ranks.

    Returns ``(step, optimizer)``; ``step(params, opt_state, batch,
    step_idx) -> (new_params, new_opt_state, loss, metrics)`` on every rank,
    ``params`` and the moments of ``opt_state`` this rank's cut
    (``shard_tree`` under ``param_pspecs``; on one data rank and one model
    rank the whole tree), ``batch`` the global ``(N * rows, S)`` batch (each
    data rank takes its own blocks of it). Per microbatch ``j`` the forward
    and backward run under ``protocol_context`` seeded ``round_seed(
    tcfg.seed, step_idx, j)``; the local loss is scaled by ``1/W`` (``W``
    data ranks) so that each block's cotangent is its contribution to the
    global mean loss. Loss and metrics are each rank's local means averaged
    over the data ranks (``stable_mean0`` over the microbatches). The step
    never writes into its inputs."""
    if tcfg.shard != "none":
        raise ValueError(f"shard={tcfg.shard!r} is an engine-path option (protocol_impl='engine'); the protomath "
                         "step is spread by its mesh")
    if mesh.abstract:
        raise ValueError("the mesh has no ranks (make_production_mesh, abstract_mesh): it places, it does not step")
    dev = resolve_device(device)
    protocol = make_protocol(tcfg, mesh)
    n, world, rank, n_local = protocol.n_devices, mesh.world, mesh.rank, mesh.local_devices
    shapes, init_specs = param_shapes_and_specs(cfg)
    placements = param_pspecs(init_specs if specs is None else specs, mesh, shapes)
    opt = make_optimizer(tcfg.optimizer, momentum_dtype=tcfg.momentum_dtype)
    schedule = linear_warmup_cosine(tcfg.lr, warmup=max(tcfg.steps // 20, 1), total_steps=tcfg.steps)
    d = 1 if tcfg.protocol == "none" else tcfg.d
    m = max(1, tcfg.microbatches)

    def rank_mean(v: torch.Tensor) -> torch.Tensor:
        if mesh.group is None:
            return v
        v = v.detach().clone()
        torch.distributed.all_reduce(v, group=mesh.group)
        return v * (1.0 / world)

    def step(params, opt_state: OptState, batch: dict, step_idx):
        step_idx = int(step_idx)
        full = block_batch(redundant_batch({k: v.to(dev) for k, v in batch.items()}, d, n), n, "device blocks")
        local = {k: v[rank * n_local:(rank + 1) * n_local] for k, v in full.items()}  # this rank's (n_local, db, ...)
        db = local["tokens"].shape[1]  # rows a device block, its d-fold redundancy included
        if db % m != 0:
            raise ValueError(f"{db} rows a device block do not split into {m} microbatches")
        sl = db // m
        leaves_tree = _grad_leaves(params)
        leaves = pytree.leaves(leaves_tree)
        cuts = _cuts(leaves_tree, placements, mesh, {})
        acc, per = None, []
        for j in range(m):
            mb = {k: v[:, j * sl:(j + 1) * sl].reshape((n_local * sl,) + tuple(v.shape[2:])) for k, v in local.items()}
            with protocol_context(protocol, round_seed(tcfg.seed, step_idx, j), group=mesh.group,
                                  model_group=mesh.model_group, cuts=cuts):
                loss, metrics = models.loss_fn(leaves_tree, specs, cfg, mb)
                grads = torch.autograd.grad(loss * (1.0 / world), leaves, allow_unused=True)
            grads = [torch.zeros_like(a) if g is None else g for g, a in zip(grads, leaves)]
            per.append((rank_mean(loss), {k: rank_mean(v) for k, v in metrics.items()}))
            if m == 1:
                acc = grads
            else:  # fp32, in microbatch order
                grads = [g.to(torch.float32) for g in grads]
                acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
        if m > 1:
            acc = [a / m for a in acc]
        grads = _restack(pytree.from_leaves(leaves_tree, acc))
        loss = per[0][0] if m == 1 else stable_mean0(torch.stack([l for l, _ in per]))
        metrics = per[0][1] if m == 1 else {k: stable_mean0(torch.stack([met[k] for _, met in per]))
                                            for k in per[0][1]}
        lr = schedule(torch.tensor(step_idx, dtype=torch.int32, device=dev))
        new_params, new_state = opt.update(params, grads, opt_state, lr, weight_decay=tcfg.weight_decay)
        return new_params, new_state, loss.detach(), {k: v.detach() for k, v in metrics.items()}

    step.placements = placements
    return step, opt


def build_train_step(cfg: ArchConfig, tcfg: TrainConfig, specs: Any = None, *, mesh: Mesh | None = None,
                     device: torch.device | str | None = None, mode: str = "loop",
                     randomness: RoundProvider | None = None):
    """Returns ``(step, optimizer)``: ``build_protomath_step`` over ``mesh``
    for ``tcfg.protocol_impl == "protomath"`` (loop mode, seeded draws),
    ``build_engine_step`` for ``"engine"`` (N and, under ``tcfg.shard``, the
    ranks from ``mesh``)."""
    if tcfg.protocol_impl == "protomath":
        if mesh is None:
            raise ValueError("protocol_impl='protomath' needs a mesh (launch.mesh.make_host_mesh)")
        if mode != "loop":
            raise ValueError(f"mode={mode!r}: the protomath step runs in loop mode")
        if randomness is not None:
            raise ValueError("the protomath step draws its own randomness (protomath's per-site generators)")
        return build_protomath_step(cfg, tcfg, specs, mesh=mesh, device=device)
    if tcfg.protocol_impl != "engine":
        raise ValueError(f"unknown protocol_impl {tcfg.protocol_impl!r}")
    return build_engine_step(cfg, tcfg, specs, mesh=mesh, device=device, mode=mode, randomness=randomness)


@dataclasses.dataclass
class Trainer:
    """A thin trainer over the train step: the model initialised from a
    CPU generator seeded ``tcfg.seed`` (the same weights on every device
    and rank; under the protomath step each rank keeps its cut) and moved
    to ``device``, the step (``"protomath"`` over ``mesh``, or the
    engine's, over ``mesh``'s ranks under ``tcfg.shard``), and the
    optimizer state."""

    cfg: ArchConfig
    tcfg: TrainConfig
    device: torch.device | str | None = None
    mode: str = "loop"
    mesh: Mesh | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        params, self.specs = models.init(torch.Generator().manual_seed(self.tcfg.seed), self.cfg)
        self.step_fn, self.opt = build_train_step(self.cfg, self.tcfg, self.specs, mesh=self.mesh,
                                                  device=self.device, mode=self.mode)
        # the protomath step's ranks store their cuts; the engine's the whole tree
        self.placements = getattr(self.step_fn, "placements", None)
        if self.placements is not None:
            params = shard_tree(params, self.placements, self.mesh)
        self.params = pytree.map_tree(lambda a: a.to(self.device), params)
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

    def whole_params(self) -> Any:
        """The whole parameter tree, on every rank (``gather_tree`` of the
        protomath step's cuts; every rank takes part)."""
        if self.placements is None:
            return self.params
        return gather_tree(self.params, self.placements, self.mesh)

    def save(self, path: str) -> None:
        """Write the whole params, the step and the specs as a checkpoint,
        from the first rank (every rank takes part in gathering the cuts):
        the files of a one-rank run."""
        params = self.whole_params()
        if self.mesh is None or (self.mesh.rank == 0 and self.mesh.model_rank == 0):
            save_checkpoint(path, params, step=self.step, specs=self.specs)

    def eval_loss(self, batch: dict) -> float:
        """Next-token loss of the current params on one batch (every leaf,
        ``frontend`` included)."""
        params = self.whole_params()
        with torch.no_grad():
            loss, _ = models.loss_fn(params, self.specs, self.cfg,
                                     {k: v.to(self.device) for k, v in batch.items()})
        return float(loss)
