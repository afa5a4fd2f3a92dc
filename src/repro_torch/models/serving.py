"""Serving: prefill and single-token decode against per-block caches.

The decode state mirrors the parameters' layout: one cache per block
position of the period, every leaf stacked over the periods on a leading
axis, plus ``"pos"``, a 0-d int32 tensor on the state's device holding the
absolute position of the next token. A decode step is a Python loop over the
periods' views, as the forward is.

Cache kinds per mixer:
  * ``attn`` / ``attn_nope``: a ring-buffer ``KVCache`` of ``capacity``
    slots (the sequence length, ``long_window`` for sliding-window
    long-context decode, or the block's own window);
  * ``cross``: the fixed encoder K/V, written at prefill;
  * ``mamba``: the conv window and the float32 SSM state (O(1) in context);
  * ``rwkv``: the token shifts and the float32 WKV matrix state (O(1)).

``decode_step`` writes each token's K/V into the state's caches in place
(``attention.decode_attention``): the state belongs to the caller, who
passes it in and gets back a state holding the same cache buffers and new
small leaves. Nothing in a step reads a value back to the host, so a step
captures as a CUDA graph (``launch.serve``).

On a rank of a serving mesh (``shard``, a ``Shard`` that ``launch.serve``
builds) ``prefill`` and ``decode_step`` run under
``protomath.model_context`` on this rank's cut of the weights (the
placements ``specs`` gives on the mesh, the data cut gathered once) and of
the decode state (``decode_state_pspecs``): the token lookup is
vocabulary-parallel, the attention, MLP, MoE, Mamba and RWKV blocks run on
their heads, ``d_ff``, experts or ``d_inner`` (``attention.
decode_attention``'s flash-decode cut where the cache's slots are cut),
RWKV's token shifts are stored cut on ``d_model`` and gathered for the
shift, and the logits come back cut by vocabulary; ``greedy_token`` takes
their argmax across the cuts exactly. Prefill computes each cache on this
rank's rows and heads and keeps its cut of it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, BlockSpec
from repro_torch.core import protomath
from repro_torch.core.protomath import plookup, pmm
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models.module import logical_to_mesh
from repro_torch.models.transformer import FRONTEND_FAMILIES, _encode_frontend, unstack_periods

__all__ = ["block_cache_init", "init_decode_state", "decode_step", "prefill", "Shard", "SERVE_RULES",
           "greedy_token"]

# a serving rank's weights: the data (fsdp) cut gathered once when serving starts, the model cut kept
SERVE_RULES = {"fsdp": None, "tp": "model", "stack": None}


@dataclasses.dataclass(frozen=True)
class Shard:
    """A rank's place in a serving mesh: ``mesh`` (a ``launch.mesh.Mesh``
    of ranks), the whole decode state's ``state_shapes`` (``meta``) and
    their placements ``state`` (``decode_state_pspecs``; a tree of the
    state's structure, a tuple in each field), the whole parameters'
    ``param_shapes`` (``meta``) and ``init``'s ``specs`` (for a caller that
    passes none), and ``batch_cut``: whether the data ranks cut the batch."""

    mesh: Any
    state_shapes: Any
    state: Any
    param_shapes: Any
    specs: Any
    batch_cut: bool

    def placements(self, specs=None) -> Any:
        """The parameters' placements on this rank (``SERVE_RULES``: the
        model cut alone)."""
        return logical_to_mesh(self.specs if specs is None else specs, self.mesh, rules=SERVE_RULES,
                               shapes=self.param_shapes)

    def along(self, entry) -> tuple[int, int, Any]:
        """(ranks, this rank's index, their group) along a placement entry."""
        m = self.mesh
        if entry is None:
            return 1, 0, None
        if entry == "model":
            return m.model, m.model_rank, m.model_group
        return m.world, m.rank, m.group  # the data axes (over the pods too)

    def context(self, tree, specs=None):
        """``protomath.model_context`` over ``tree``'s leaves (the
        parameters, ``unstack_periods``' form: their per-period views)."""
        cuts = _model_cuts(tree, self.placements(specs), self.mesh.model, {})
        return protomath.model_context(self.mesh.model_group, cuts, group=self.mesh.group, batch_cut=self.batch_cut)


def _model_cuts(tree, placements, model: int, out: dict) -> dict:
    """``{id(leaf): cut}`` of every leaf cut over the model ranks, the
    per-period views of a stacked leaf (a list) without the stack's dim."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _model_cuts(v, placements[k], model, out)
    elif isinstance(tree, list):
        for v in tree:
            _model_cuts(v, _drop_lead(placements), model, out)
    elif model > 1 and "model" in placements:
        out[id(tree)] = tuple("model" if e == "model" else None for e in placements)
    return out


def _drop_lead(placements):
    if isinstance(placements, dict):
        return {k: _drop_lead(v) for k, v in placements.items()}
    return placements[1:]


def _block_place(shard: Shard | None, name: str) -> dict | None:
    """A block's cache placements, a dim's entry each (the periods' dim
    dropped), by field."""
    if shard is None:
        return None
    place = shard.state[name]
    return {f.name: getattr(place, f.name)[1:] for f in dataclasses.fields(place)}


def _seq_cut(shard: Shard | None, place: dict | None):
    """The flash-decode cut of a cache (its slots' entry), or None."""
    if place is None or "k" not in place or place["k"][1] is None:
        return None
    parts, index, group = shard.along(place["k"][1])
    return attn_lib.SeqCut(group, parts, index, place["k"][1] == "model")


def _cut_leaf(t: torch.Tensor, whole: tuple, place: tuple, shard: Shard) -> torch.Tensor:
    """``t`` with each placed dim that still holds its whole size narrowed
    to this rank's part (a dim a computation already cut is kept)."""
    for dim, entry in enumerate(place):
        n, i, _ = shard.along(entry)
        if n > 1 and t.shape[dim] == whole[dim]:
            t = t.narrow(dim, i * (whole[dim] // n), whole[dim] // n)
    return t.contiguous()


def greedy_token(logits: torch.Tensor, cfg: ArchConfig, shard: Shard | None = None) -> torch.Tensor:
    """(B, V) logits -> (B, 1) int32, the first maximal index (``torch.
    argmax``'s rule and ``jnp.argmax``'s). Where the vocabulary is cut over
    the model ranks, each rank's maximum and the global index of its first
    occurrence are gathered (one float64 (B, 2) ``all_gather``) and the
    largest kept, a tie to the lowest index: the argmax of the whole
    logits, which are never gathered."""
    idx = torch.argmax(logits, dim=-1)
    if shard is None or logits.shape[-1] == cfg.vocab:
        return idx.to(torch.int32)[:, None]
    m = shard.mesh
    val = torch.gather(logits, -1, idx[:, None])[:, 0]
    pair = torch.stack([val.to(torch.float64), (idx + m.model_rank * logits.shape[-1]).to(torch.float64)], -1)
    protomath.count_collective("model", "all_gather", pair)
    every = protomath._all_gather(pair[None], m.model_group, m.model)  # (ranks, B, 2), in vocabulary order
    best = torch.argmax((every[..., 0] == every[..., 0].amax(dim=0)).to(torch.int8), dim=0)  # the first rank
    return torch.gather(every[..., 1], 0, best[None])[0].to(torch.int32)[:, None]


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The token rows: the reference's ``jnp.take``, vocabulary-parallel
    (``plookup``) on a serving rank."""
    if protomath.current_protocol() is None:
        return torch.nn.functional.embedding(tokens, table)
    return plookup(table, tokens, w_spec=("tp", "fsdp"))


def _cache_capacity(cfg: ArchConfig, spec: BlockSpec, seq_len: int, capacity: int | None = None) -> int:
    """A ring's slots for ``seq_len`` tokens; ``capacity``: prefill's
    headroom (not for a block's own window)."""
    if spec.sliding_window is not None:
        return min(spec.sliding_window, seq_len)
    cap = cfg.long_window if cfg.long_context == "window" and seq_len > cfg.long_window else seq_len
    return cap if capacity is None else max(cap, capacity)


def block_cache_init(cfg: ArchConfig, spec: BlockSpec, batch: int, seq_len: int, filled: int,
                     device: torch.device | str | None = None, capacity: int | None = None):
    """A zero cache for one block (one period's slice), ``filled`` tokens
    long."""
    hd = cfg.resolved_head_dim
    if spec.mixer in ("attn", "attn_nope", "cross"):
        cap = (cfg.encoder.n_frontend_tokens if spec.mixer == "cross"
               else _cache_capacity(cfg, spec, seq_len, capacity))
        c = attn_lib.init_cache(batch, cap, cfg.n_kv_heads, hd, cfg.dtype, device)
        return dataclasses.replace(c, length=torch.full((), filled, dtype=torch.int32, device=device))
    if spec.mixer == "mamba":
        mc = cfg.mamba
        return mamba_lib.init_mamba_state(batch, mc.expand * cfg.d_model, mc.d_state, mc.d_conv, cfg.dtype, device)
    if spec.mixer == "rwkv":
        return rwkv_lib.init_rwkv_state(batch, cfg.d_model, cfg.rwkv.head_dim, cfg.dtype, device)
    raise ValueError(f"unknown mixer {spec.mixer!r}")


def _stack(caches: list):
    """One cache of the periods' caches, each field stacked on a leading
    axis."""
    return type(caches[0])(**{f.name: torch.stack([getattr(c, f.name) for c in caches])
                              for f in dataclasses.fields(caches[0])})


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int, filled: int | None = None,
                      device: torch.device | str | None = None, capacity: int | None = None) -> dict:
    """The full decode state: per-block caches stacked over the periods,
    plus ``"pos"``. ``filled`` (default ``seq_len``: one new token against a
    full cache, as the reference's dry-run decode shapes are) is the tokens
    already in the caches. ``"pos"`` is the one source of the position: a
    cross-attention or recurrent first block never advances a ``length``.
    ``capacity``: the ring headroom a prefill of ``seq_len`` tokens
    reserves (``prefill``'s), so the shapes are the state it leaves."""
    filled = seq_len if filled is None else filled
    state = {}
    for i, spec in enumerate(cfg.period):
        # one period's shapes on the meta device, then each leaf allocated once with the periods' axis: a
        # stack of per-period caches would hold the (up to tens of GB of) cache twice
        one = block_cache_init(cfg, spec, batch, seq_len, filled, device="meta", capacity=capacity)
        leaves = {f.name: getattr(one, f.name) for f in dataclasses.fields(one)}
        stacked = {k: torch.zeros((cfg.n_periods, *t.shape), dtype=t.dtype, device=device) for k, t in leaves.items()}
        if "length" in stacked:
            stacked["length"].fill_(filled)
        state[f"blk{i}"] = type(one)(**stacked)
    state["pos"] = torch.full((), filled, dtype=torch.int32, device=device)
    return state


def _sinusoidal_at(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """``layers.sinusoidal_positions(seq, d_model)[pos]`` at a device
    position: (d_model,), for even and odd ``d_model`` (the cos half has
    floor(d/2) slots)."""
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=pos.device)
    angle = pos.to(torch.float32) / torch.pow(torch.full((), 10000.0, device=pos.device), dim / d_model)
    pe = torch.zeros((d_model,), dtype=torch.float32, device=pos.device)
    pe[0::2] = torch.sin(angle)
    pe[1::2] = torch.cos(angle[: d_model // 2])
    return pe


def _joined(t: torch.Tensor, entry) -> torch.Tensor:
    """A token shift stored cut on ``d_model`` over the model ranks,
    gathered whole."""
    return protomath.model_join(t, -1) if entry == "model" else t


def _mlp(cfg: ArchConfig, spec: BlockSpec, bp, x, bcache, prefill: bool, place: dict | None = None):
    """x + mlp(ln2(x)), the RWKV channel mix's token shift carried in
    ``bcache`` (stored cut on ``d_model`` where ``place`` says, gathered
    for the shift). Returns (x, bcache)."""
    if spec.mlp == "none":
        return x, bcache
    normed = L.rmsnorm({"scale": bp["ln2"]}, x, cfg.norm_eps)
    if spec.mlp == "dense":
        h = L.mlp(bp["mlp"], normed)
    elif spec.mlp == "moe":
        h, _ = moe_lib.moe(bp["mlp"], normed, top_k=cfg.moe.top_k, aux_coef=0.0)
    elif spec.mlp == "rwkv_ffn":
        prev = None if prefill else _joined(bcache.ffn_x_prev, place and place["ffn_x_prev"][1])
        h, ffn_x = rwkv_lib.rwkv_channel_mix(bp["mlp"], normed, state_prev=prev, return_state=True)
        bcache = dataclasses.replace(bcache, ffn_x_prev=ffn_x)
    else:
        raise ValueError(f"unknown mlp {spec.mlp!r}")
    return x + h, bcache


def _block_decode(cfg: ArchConfig, spec: BlockSpec, bp, x, bcache, shard: Shard | None = None,
                  place: dict | None = None):
    """x: (B, 1, D) -> (x, the block's cache after the token). On a serving
    rank the cache is this rank's cut (``place``, its fields' entries)."""
    normed = L.rmsnorm({"scale": bp["ln1"]}, x, cfg.norm_eps)
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, seq=_seq_cut(shard, place))
    if spec.mixer in ("attn", "attn_nope"):
        h, bcache = attn_lib.decode_attention(bp["mixer"], normed, bcache,
                                              rope_theta=cfg.rope_theta if spec.mixer == "attn" else None,
                                              window=spec.sliding_window, **kw)
    elif spec.mixer == "cross":
        h, bcache = attn_lib.decode_attention(bp["mixer"], normed, bcache, rope_theta=None, cross=True, **kw)
    elif spec.mixer == "mamba":
        h, bcache = mamba_lib.mamba_decode(bp["mixer"], normed, bcache, cfg.mamba.d_state)
    elif spec.mixer == "rwkv":
        entry = place and place["x_prev"][1]
        state = dataclasses.replace(bcache, x_prev=_joined(bcache.x_prev, entry))
        h, wkv, x_last = rwkv_lib.rwkv_time_mix(bp["mixer"], normed, cfg.rwkv.head_dim, state=state,
                                                return_state=True)
        bcache = dataclasses.replace(bcache, x_prev=_own_part(x_last, entry, shard), wkv=wkv)
    else:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    x, bcache = _mlp(cfg, spec, bp, x + h, bcache, prefill=False, place=place)
    if spec.mlp == "rwkv_ffn":
        bcache = dataclasses.replace(bcache, ffn_x_prev=_own_part(bcache.ffn_x_prev, place and place["ffn_x_prev"][1],
                                                                  shard))
    return x, bcache


def _own_part(t: torch.Tensor, entry, shard: Shard | None) -> torch.Tensor:
    """This rank's part of a whole token shift (B, D) stored cut on
    ``d_model``."""
    if entry is None:
        return t
    n, i, _ = shard.along(entry)
    return t.narrow(-1, i * (t.shape[-1] // n), t.shape[-1] // n).contiguous()


def _restack(old, new: list):
    """The stacked cache after a step: a ``KVCache`` keeps ``old``'s k/v
    buffers (written in place), every other field is the periods' new
    values stacked."""
    if isinstance(old, attn_lib.KVCache):
        return attn_lib.KVCache(k=old.k, v=old.v, length=torch.stack([c.length for c in new]))
    return _stack(new)


def _period_view(cache, p: int):
    """Period ``p``'s slice of a stacked cache, every field a view."""
    return type(cache)(**{f.name: getattr(cache, f.name)[p] for f in dataclasses.fields(cache)})


def _head(params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"]["table"] if cfg.tie_embeddings else params["lm_head"]


@torch.no_grad()
def decode_step(params, specs, cfg: ArchConfig, token: torch.Tensor, state: dict, *, shard: Shard | None = None):
    """One decode step: token (B, 1) int -> (logits (B, V) float32, the
    state after it).

    ``state["pos"]`` is the absolute position of the incoming token (after
    a prefill of s tokens, step t sees ``s + t``); it positions the audio
    family's sinusoidal embedding. The caches' K/V are written in place
    (the module docstring): the returned state holds ``state``'s cache
    buffers, and ``state`` is not to be used again.

    ``shard``: a serving rank's step (the module docstring). ``params`` are
    then this rank's cut of the weights with the data cut gathered (the
    placements ``specs``, or ``init``'s where ``None``, give on
    ``shard.mesh`` under ``SERVE_RULES``), ``token`` and ``state`` this
    rank's cut (``decode_state_pspecs``), and the logits (B, V / model)
    this rank's vocabulary slice where the head's rows are cut."""
    if shard is None:
        return _decode(params, cfg, token, state, None)
    tree = unstack_periods(params)  # the per-period views the context's cuts name
    with shard.context(tree, specs):
        return _decode(tree, cfg, token, state, shard)


def _decode(params, cfg: ArchConfig, token: torch.Tensor, state: dict, shard: Shard | None):
    pos = state["pos"]
    x = _embed(params["embed"]["table"], token)  # (B, 1, D)
    if cfg.family == "audio":
        x = x + _sinusoidal_at(pos, cfg.d_model)[None, None].to(x.dtype)
    names = [f"blk{i}" for i in range(len(cfg.period))]
    places = {name: _block_place(shard, name) for name in names}
    new = {name: [] for name in names}
    for p, pp in enumerate(unstack_periods(params)["periods"]):
        for name, spec in zip(names, cfg.period):
            x, c = _block_decode(cfg, spec, pp[name], x, _period_view(state[name], p), shard, places[name])
            new[name].append(c)
    out = {name: _restack(state[name], new[name]) for name in names}
    out["pos"] = pos + 1
    x = L.rmsnorm({"scale": params["ln_f"]}, x, cfg.norm_eps)
    logits = pmm("bsd,vd->bsv", x, _head(params, cfg), w_spec=("tp", "fsdp"))
    return logits[:, 0, :].to(torch.float32), out


@torch.no_grad()
def prefill(params, specs, cfg: ArchConfig, tokens: torch.Tensor, *, frontend: torch.Tensor | None = None,
            capacity: int | None = None, shard: Shard | None = None):
    """The full forward over the prompt, building the caches: tokens (B, s)
    -> (last position's logits (B, V) float32, decode state).

    Attention K/V go into a ring buffer of ``capacity`` slots (default the
    prompt's length; pass ``s + new_tokens`` to decode past the prompt
    without evicting position 0); the recurrent blocks keep their final
    states; cross-attention keeps the encoder's K/V. ``shard``: a serving
    rank's prefill (as ``decode_step``): ``tokens`` and ``frontend`` this
    rank's rows where the data ranks cut the batch, each cache computed on
    them and cut to this rank's placement, the logits its vocabulary
    slice."""
    if shard is None:
        return _prefill(params, cfg, tokens, frontend, capacity, None)
    tree = unstack_periods(params)
    with shard.context(tree, specs):
        return _prefill(tree, cfg, tokens, frontend, capacity, shard)


def _prefill(params, cfg: ArchConfig, tokens: torch.Tensor, frontend, capacity: int | None, shard: Shard | None):
    b, s = tokens.shape
    x = _embed(params["embed"]["table"], tokens)
    if cfg.family == "audio":
        x = x + L.sinusoidal_positions(s, cfg.d_model, device=x.device)[None].to(x.dtype)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    cross_src = None
    if cfg.family in FRONTEND_FAMILIES:
        if frontend is None:
            raise ValueError(f"{cfg.name} ({cfg.family}) needs frontend embeddings")
        cross_src = _encode_frontend(params, cfg, frontend)
    names = [f"blk{i}" for i in range(len(cfg.period))]
    caches = {name: [] for name in names}
    for pp in unstack_periods(params)["periods"]:
        for name, spec in zip(names, cfg.period):
            x, c = _block_prefill(cfg, spec, pp[name], x, positions, cross_src, s, capacity)
            if shard is not None:  # this rank's cut of the cache, computed on its rows and heads
                whole, place = shard.state_shapes[name], shard.state[name]
                c = type(c)(**{f.name: _cut_leaf(getattr(c, f.name), tuple(getattr(whole, f.name).shape[1:]),
                                                 getattr(place, f.name)[1:], shard)
                               for f in dataclasses.fields(c)})
            caches[name].append(c)
    state = {name: _stack(caches[name]) for name in names}
    state["pos"] = torch.full((), s, dtype=torch.int32, device=tokens.device)
    x = L.rmsnorm({"scale": params["ln_f"]}, x, cfg.norm_eps)
    logits = pmm("bd,vd->bv", x[:, -1, :], _head(params, cfg), w_spec=("tp", "fsdp"))
    return logits.to(torch.float32), state


def _block_prefill(cfg: ArchConfig, spec: BlockSpec, bp, x, positions, cross_src, seq_len: int,
                   capacity: int | None = None):
    normed = L.rmsnorm({"scale": bp["ln1"]}, x, cfg.norm_eps)
    b = x.shape[0]
    length = torch.full((), seq_len, dtype=torch.int32, device=x.device)
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    if spec.mixer in ("attn", "attn_nope", "cross"):
        cross = spec.mixer == "cross"
        extra = {}
        if cross:
            kv_pos = torch.arange(cross_src.shape[1], device=x.device).expand(cross_src.shape[:2])
            extra = dict(kv_override=cross_src, kv_positions=kv_pos)
        h, k, v = attn_lib.multihead_attention(bp["mixer"], normed, positions,
                                               rope_theta=cfg.rope_theta if spec.mixer == "attn" else None,
                                               causal=not cross, window=None if cross else spec.sliding_window,
                                               **extra, **kw)
        if protomath.tp_dim_of(bp["mixer"]["wk"]) == 2:  # a cut head_dim: the cache holds whole heads
            k, v = protomath.model_join(k, -1), protomath.model_join(v, -1)
        if cross:
            bcache = attn_lib.KVCache(k=k.to(cfg.dtype), v=v.to(cfg.dtype), length=length)
        else:
            cap = _cache_capacity(cfg, spec, seq_len, capacity)
            kc, vc = (t[:, -min(cap, seq_len):].to(cfg.dtype) for t in (k, v))
            if cap > seq_len:  # headroom slots at the tail of the ring
                kc, vc = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, cap - seq_len)) for t in (kc, vc))
            elif cap < seq_len:
                # Ring alignment: decode reads slot i as the largest position
                # p <= pos with p % cap == i, so the window's positions
                # [seq_len - cap, seq_len) belong at rows p % cap. The slice
                # above puts position seq_len - cap + i at row i; rolling by
                # seq_len % cap moves each to its slot.
                kc, vc = (torch.roll(t, seq_len % cap, dims=1) for t in (kc, vc))
            bcache = attn_lib.KVCache(k=kc, v=vc, length=length)
    elif spec.mixer == "mamba":
        h, bcache = mamba_lib.mamba(bp["mixer"], normed, cfg.mamba.d_state, return_state=True)
    elif spec.mixer == "rwkv":
        h, wkv, x_last = rwkv_lib.rwkv_time_mix(bp["mixer"], normed, cfg.rwkv.head_dim, return_state=True)
        bcache = rwkv_lib.RWKVState(x_prev=x_last, wkv=wkv,
                                    ffn_x_prev=torch.zeros((b, cfg.d_model), dtype=cfg.dtype, device=x.device))
    else:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    return _mlp(cfg, spec, bp, x + h, bcache, prefill=True)
