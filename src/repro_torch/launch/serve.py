"""Serving steps (prefill, decode) and one batch of greedy traffic.

Inference carries no gradient exchange, so the LAD protocol is inactive
here: the paper's technique is train-time. The serving path is the model
substrate under the prefill and decode input shapes.

``serve_traffic`` prefills a prompt and decodes greedily, in one of two
modes that give the same tokens and state bit for bit:

  * ``"graph"`` (CUDA only; the reference's ``jax.jit``): one decode step
    and its ``argmax`` captured as a CUDA graph over static buffers (the
    token, the decode state, the output tokens and the step's column) and
    replayed once a token;
  * ``"loop"``: the same step, eager.

Nothing is read back to the host until the last step has run.

The placements of the reference's sharded serving (``decode_state_pspecs``,
``batch_dim_pspec``, ``serve_input_specs``) are the reference's partition
specs on a ``launch.mesh.Mesh``, one tuple a leaf, decided leaf by leaf
from divisibility:

  * the batch dim on the data axes where it divides (``decode_32k``: 128
    over 16);
  * else the KV cache's sequence on the data axes (``long_500k``: batch 1,
    524,288 cache rows);
  * heads, ``d_inner`` and ``d_model`` on ``model`` where they divide; a
    cache whose kv heads do not divide puts its sequence on ``model``
    instead (the reference's flash-decode cut).

``serve_traffic(mesh=)`` over a mesh of more than one rank (``launch.
mesh.make_host_mesh(data, model)`` over a ``torch.distributed`` group)
serves on those placements, in loop mode: each rank holds its cut of the
parameters (``train.param_pspecs``), gathers their data cut once when
serving starts and keeps the model cut (``serving.SERVE_RULES``), holds
exactly the cut of the decode state ``decode_state_pspecs`` gives it, and
runs prefill and greedy decode on those cuts (``models.serving``'s
``shard``); the tokens are gathered over the data ranks, so every rank
returns the whole ``(B, new_tokens)``. ``init_state_cut`` allocates a
rank's cut of a decode state alone (the whole ``decode_32k`` cache of
smollm-360m is 42.95 GB), ``shard_state`` cuts a whole one.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable

import torch

from repro_torch import pytree
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.engine import _check_mode
from repro_torch.core.protomath import _all_gather
from repro_torch.device import resolve_device
from repro_torch.launch import train
from repro_torch.launch.mesh import Mesh, data_axes
from repro_torch.launch.roofline import param_shapes_and_specs
from repro_torch.models import serving
from repro_torch.models.module import _axis_size

__all__ = ["build_prefill_fn", "build_decode_fn", "GreedyDecoder", "serve_traffic", "Placed", "decode_state_pspecs",
           "batch_dim_pspec", "serve_input_specs", "serving_shard", "shard_state", "init_state_cut",
           "serving_params"]


def build_prefill_fn(cfg: ArchConfig, specs: Any, *, capacity: int | None = None,
                     shard: serving.Shard | None = None) -> Callable:
    """``(params, tokens, frontend=None) -> (logits, state)``; ``capacity``
    reserves ring headroom so decode can run past the prompt without
    evicting position 0; ``shard``: a serving rank's (``serving_shard``)."""

    def fn(params, tokens, frontend=None):
        return serving.prefill(params, specs, cfg, tokens, frontend=frontend, capacity=capacity, shard=shard)

    return fn


def build_decode_fn(cfg: ArchConfig, specs: Any, shard: serving.Shard | None = None) -> Callable:
    """``(params, token, state) -> (logits, state)``, the caches written in
    place (``models.serving``); ``shard``: a serving rank's."""

    def fn(params, token, state):
        return serving.decode_step(params, specs, cfg, token, state, shard=shard)

    return fn


def _dax(mesh: Mesh):
    axes = data_axes(mesh)
    return axes if len(axes) > 1 else axes[0]


def _div(n: int, mesh: Mesh, axis) -> bool:
    size = _axis_size(mesh, axis)
    return n % size == 0 and n >= size


def _state_leaf_pspec(field: str, shp: tuple, mesh: Mesh) -> tuple:
    """One decode-state leaf's partition spec (the leaves carry the
    periods' leading dim), by its field's name."""
    dax = _dax(mesh)
    if field in ("k", "v"):  # (P, B, C, Hkv, Dh)
        _, b, c, h, _ = shp
        h_ax = "model" if _div(h, mesh, "model") else None
        c_ax = None if h_ax else ("model" if _div(c, mesh, "model") else None)  # flash-decode: the sequence
        if _div(b, mesh, dax):
            return (None, dax, c_ax, h_ax, None)
        if _div(c, mesh, dax):
            return (None, None, dax, h_ax, None)
        return (None, None, c_ax, h_ax, None)
    if field == "length":
        return (None,)
    if field == "pos":
        return ()
    b_ax = dax if _div(shp[1], mesh, dax) else None
    if field == "h":  # mamba (P, B, di, ds)
        return (None, b_ax, "model" if _div(shp[2], mesh, "model") else None, None)
    if field == "conv":  # (P, B, k-1, di)
        return (None, b_ax, None, "model" if _div(shp[3], mesh, "model") else None)
    if field == "wkv":  # (P, B, H, hd, hd)
        return (None, b_ax, "model" if _div(shp[2], mesh, "model") else None, None, None)
    if field in ("x_prev", "ffn_x_prev"):  # (P, B, D)
        return (None, b_ax, "model" if _div(shp[2], mesh, "model") else None)
    return (None,) * len(shp)


def _state_specs(state_shapes: Any, mesh: Mesh) -> dict[str, tuple]:
    """``decode_state_pspecs``' specs by leaf path."""
    return {path: _state_leaf_pspec(path.split("/")[-1].lstrip("."), tuple(leaf.shape), mesh)
            for path, leaf in pytree.paths(state_shapes)}


def decode_state_pspecs(state_shapes: Any, mesh: Mesh) -> Any:
    """The partition spec of every leaf of a decode state (its structure:
    each cache's fields, and ``pos``, hold a spec each)."""
    return pytree.with_paths(state_shapes, _state_specs(state_shapes, mesh))


def shard_state(state: Any, mesh: Mesh) -> Any:
    """This rank's cut of a whole decode state (a copy of each leaf's), by
    ``decode_state_pspecs`` (``train.shard_tree`` a leaf)."""
    specs = _state_specs(state, mesh)
    return pytree.with_paths(state, {path: train.shard_tree(leaf, specs[path], mesh)
                                     for path, leaf in pytree.paths(state)})


def _cut_shape(shape: tuple, spec: tuple, mesh: Mesh) -> tuple:
    return tuple(n // _axis_size(mesh, e) for n, e in zip(shape, spec))


def init_state_cut(cfg: ArchConfig, batch: int, seq_len: int, mesh: Mesh, filled: int | None = None,
                   device: torch.device | str | None = None, capacity: int | None = None) -> dict:
    """This rank's cut of ``serving.init_decode_state(cfg, batch, seq_len,
    filled, capacity=)``, born cut: each leaf allocated at its cut's shape
    alone (zeros; ``length`` and ``pos`` set to ``filled``), the whole
    state never."""
    whole = serving.init_decode_state(cfg, batch, seq_len, filled, device="meta", capacity=capacity)
    specs = _state_specs(whole, mesh)
    filled = seq_len if filled is None else filled
    cut = {}
    for path, leaf in pytree.paths(whole):
        t = torch.zeros(_cut_shape(tuple(leaf.shape), specs[path], mesh), dtype=leaf.dtype, device=device)
        cut[path] = t.fill_(filled) if path.endswith(".length") or path == "pos" else t
    return pytree.with_paths(whole, cut)


def serving_shard(cfg: ArchConfig, batch: int, seq_len: int, mesh: Mesh, capacity: int | None = None) -> serving.Shard:
    """A rank's ``serving.Shard`` for a batch of ``batch`` prompts of
    ``seq_len`` tokens (and ``capacity``'s headroom) on ``mesh``."""
    whole = serving.init_decode_state(cfg, batch, seq_len, device="meta", capacity=capacity)
    shapes, specs = param_shapes_and_specs(cfg)
    return serving.Shard(mesh=mesh, state_shapes=whole, state=decode_state_pspecs(whole, mesh), param_shapes=shapes,
                         specs=specs, batch_cut=batch_dim_pspec(batch, mesh)[0] is not None and mesh.world > 1)


def serving_params(params: Any, specs: Any, cfg: ArchConfig, mesh: Mesh) -> Any:
    """A serving rank's weights: its stored cut (``train.param_pspecs``, as
    the protomath step and ``Trainer(mesh=)`` hold it) with the data cut
    all-gathered over the data ranks once, the model cut kept."""
    shapes, init_specs = param_shapes_and_specs(cfg)
    placements = train.param_pspecs(init_specs if specs is None else specs, mesh, shapes)
    return train.gather_tree(params, _data_only(placements), mesh)


def _data_only(placements: Any) -> Any:
    if isinstance(placements, dict):
        return {k: _data_only(v) for k, v in placements.items()}
    return tuple(None if e == "model" else e for e in placements)


def batch_dim_pspec(n: int, mesh: Mesh) -> tuple:
    dax = _dax(mesh)
    return (dax,) if _div(n, mesh, dax) else (None,)


@dataclasses.dataclass(frozen=True)
class Placed:
    """A ``meta`` tensor (or a tree of them) and its partition spec (or a
    tree of them): the reference's ``ShapeDtypeStruct`` with a sharding."""

    value: Any
    placement: Any


def serve_input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh) -> dict[str, Placed]:
    """The serve inputs of ``shape`` as placed ``meta`` tensors:
    ``tokens`` (and ``frontend``) for a prefill, ``token`` and the decode
    ``state`` for a decode."""
    b = shape.global_batch
    lead = batch_dim_pspec(b, mesh)[0]

    def meta(shp, dtype) -> torch.Tensor:
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "prefill":
        out = {"tokens": Placed(meta((b, shape.seq_len), torch.int32), (lead, None))}
        if cfg.family in ("vlm", "audio"):
            enc = cfg.encoder
            out["frontend"] = Placed(meta((b, enc.n_frontend_tokens, enc.d_frontend), torch.float32),
                                     (lead, None, None))
        return out
    if shape.kind == "decode":
        state = serving.init_decode_state(cfg, b, shape.seq_len, device="meta")
        return {"token": Placed(meta((b, 1), torch.int32), (lead, None)),
                "state": Placed(state, decode_state_pspecs(state, mesh))}
    raise ValueError(shape.kind)


def _small_leaves(state: dict) -> dict[str, torch.Tensor]:
    """Every leaf of a decode state but the caches' K/V buffers, by path."""
    return {k: v for k, v in pytree.paths(state) if not k.endswith(("/.k", "/.v"))}


class GreedyDecoder:
    """Greedy decode over static buffers: the token, the decode state, the
    ``(B, new_tokens)`` output and the step's column; ``__call__`` runs one
    step (in graph mode a replay of its capture). A step decodes, writes
    the new small leaves of the state into its buffers (the caches' K/V are
    written in place by the step itself), takes the ``argmax`` and writes
    it as the next token and into the output's column.

    The first step runs once untimed (on a side stream in graph mode, before
    the capture) and is then undone: the state's small leaves, the token
    and the column are restored. The K/V it wrote is the slot the first real
    step writes again, with the same values, before it reads it. A call
    past ``new_tokens`` raises: its column would lie outside the output.
    ``argmax``: ``(logits) -> (B, 1) int32`` (default ``torch.argmax``'s
    first maximal index; a serving rank's ``serving.greedy_token`` across
    the vocabulary's cuts)."""

    def __init__(self, decode_fn: Callable, params, tok: torch.Tensor, state: dict, new_tokens: int, mode: str,
                 argmax: Callable | None = None):
        self.decode_fn, self.params = decode_fn, params
        self.argmax = argmax or (lambda logits: torch.argmax(logits, dim=-1).to(torch.int32)[:, None])
        dev = tok.device
        self.bufs = {"tok": tok.clone(), "state": state, "t": torch.zeros((), dtype=torch.int64, device=dev),
                     "out": torch.zeros((tok.shape[0], new_tokens), dtype=torch.int32, device=dev)}
        saved = {k: v.clone() for k, v in _small_leaves(state).items()}
        self.graph, self.calls, self.new_tokens = None, 0, new_tokens
        if mode == "graph":
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._step()
            torch.cuda.current_stream(dev).wait_stream(side)
        else:
            self._step()
        self._restore(saved, tok)
        if mode == "graph":
            torch.cuda.synchronize(dev)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._step()

    def _restore(self, saved: dict, tok: torch.Tensor) -> None:
        for k, v in _small_leaves(self.bufs["state"]).items():
            v.copy_(saved[k])
        self.bufs["tok"].copy_(tok)
        self.bufs["t"].zero_()

    def _step(self) -> None:
        b = self.bufs
        logits, new = self.decode_fn(self.params, b["tok"], b["state"])
        new = _small_leaves(new)
        for k, v in _small_leaves(b["state"]).items():
            v.copy_(new[k])
        nxt = self.argmax(logits)  # the first maximal index, as jnp.argmax's
        b["tok"].copy_(nxt)
        b["out"].index_copy_(1, b["t"].reshape(1), nxt)
        b["t"].add_(1)

    def __call__(self) -> None:
        if self.calls == self.new_tokens:  # the output's columns are full: a step past them writes out of bounds
            raise ValueError(f"the decoder's {self.new_tokens} tokens are all decoded")
        self.calls += 1
        if self.graph is None:
            self._step()
        else:
            self.graph.replay()


class _Clock:
    """Seconds of a stretch of work: by CUDA events on a card (``card_s``)
    and on the host clock up to a synchronize (``host_s``)."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.dev = dev

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.events[1].record()
            torch.cuda.synchronize(self.dev)
        self.host_s = time.perf_counter() - self.t0
        self.card_s = self.events[0].elapsed_time(self.events[1]) / 1e3 if self.cuda else None
        return False


def serve_traffic(cfg: ArchConfig, params, specs, tokens: torch.Tensor, *, frontend: torch.Tensor | None = None,
                  new_tokens: int = 8, mode: str = "graph", device: torch.device | str | None = None,
                  mesh: Mesh | None = None) -> dict:
    """Serve one batch: prefill the prompt ``tokens`` (B, s), then decode
    ``new_tokens`` tokens greedily (capacity ``s + new_tokens``). Each of
    prefill and decode runs once untimed first, as the reference compiles
    first.

    Returns the reference's ``prefill_s``, ``decode_s``,
    ``prefill_tokens_per_s``, ``decode_tokens_per_s``, ``tokens`` (B,
    new_tokens) int32 and ``pos``, plus ``prefill_host_s``/``decode_host_s``
    and the final decode ``state``. On a card the seconds are the card's (CUDA
    events) with the host's beside them; on the CPU both are the host's
    (``clock`` says which).

    ``mesh``: the reference's. Over one rank the whole model serves here.
    Over more (every rank of the mesh calls this, with the same ``tokens``
    and ``frontend``), loop mode only: ``params`` is this rank's stored cut
    (``train.param_pspecs``: what ``Trainer(mesh=)`` holds; ``shard_tree``
    of the whole), ``state`` comes back as this rank's cut, and ``tokens``
    whole on every rank. A mesh with no ranks (``make_production_mesh``,
    ``abstract_mesh``) places and does not serve."""
    if mesh is not None and mesh.abstract:
        raise ValueError("the mesh has no ranks (make_production_mesh, abstract_mesh): it places, it does not serve")
    ranks = mesh is not None and mesh.size > 1
    if ranks and mode != "loop":
        raise ValueError(f"mode={mode!r} over a mesh of {mesh.size} ranks: sharded serving runs in loop mode (its "
                         "collectives are gloo's, which a CUDA graph cannot capture; ROADMAP A.14)")
    dev = resolve_device(device)
    _check_mode(mode, dev)
    params = pytree.map_tree(lambda a: a.to(dev), params)
    tokens = tokens.to(dev)
    frontend = None if frontend is None else frontend.to(dev)
    b, s = tokens.shape
    shard = argmax = None
    if ranks:
        shard = serving_shard(cfg, b, s, mesh, capacity=s + new_tokens)
        params = serving_params(params, specs, cfg, mesh)
        if shard.batch_cut:  # this data rank's rows
            rows = b // mesh.world
            tokens = tokens[mesh.rank * rows:(mesh.rank + 1) * rows]
            frontend = None if frontend is None else frontend[mesh.rank * rows:(mesh.rank + 1) * rows]
        argmax = functools.partial(serving.greedy_token, cfg=cfg, shard=shard)
    prefill_fn = build_prefill_fn(cfg, specs, capacity=s + new_tokens, shard=shard)
    prefill_fn(params, tokens, frontend)  # untimed first call
    with _Clock(dev) as pre:
        logits, state = prefill_fn(params, tokens, frontend)
    tok = argmax(logits) if argmax else torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    greedy = GreedyDecoder(build_decode_fn(cfg, specs, shard), params, tok, state, new_tokens, mode, argmax)
    with _Clock(dev) as dec:
        for _ in range(new_tokens):
            greedy()
    prefill_s = pre.host_s if pre.card_s is None else pre.card_s
    decode_s = dec.host_s if dec.card_s is None else dec.card_s
    out = greedy.bufs["out"]
    if shard is not None and shard.batch_cut:  # every data rank's rows, on every rank
        out = _all_gather(out, mesh.group, mesh.world)
    return {
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "prefill_tokens_per_s": b * s / max(prefill_s, 1e-9),
        "decode_tokens_per_s": b * new_tokens / max(decode_s, 1e-9),
        "tokens": out,
        "pos": int(greedy.bufs["state"]["pos"]),
        "prefill_host_s": pre.host_s,
        "decode_host_s": dec.host_s,
        "clock": "cuda_events" if pre.card_s is not None else "host",
        "state": greedy.bufs["state"],
    }
