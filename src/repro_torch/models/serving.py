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
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, BlockSpec
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models.transformer import FRONTEND_FAMILIES, _encode_frontend, unstack_periods

__all__ = ["block_cache_init", "init_decode_state", "decode_step", "prefill"]


def _cache_capacity(cfg: ArchConfig, spec: BlockSpec, seq_len: int) -> int:
    if spec.sliding_window is not None:
        return min(spec.sliding_window, seq_len)
    if cfg.long_context == "window" and seq_len > cfg.long_window:
        return cfg.long_window
    return seq_len


def block_cache_init(cfg: ArchConfig, spec: BlockSpec, batch: int, seq_len: int, filled: int,
                     device: torch.device | str | None = None):
    """A zero cache for one block (one period's slice), ``filled`` tokens
    long."""
    hd = cfg.resolved_head_dim
    if spec.mixer in ("attn", "attn_nope", "cross"):
        cap = cfg.encoder.n_frontend_tokens if spec.mixer == "cross" else _cache_capacity(cfg, spec, seq_len)
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
                      device: torch.device | str | None = None) -> dict:
    """The full decode state: per-block caches stacked over the periods,
    plus ``"pos"``. ``filled`` (default ``seq_len``: one new token against a
    full cache, as the reference's dry-run decode shapes are) is the tokens
    already in the caches. ``"pos"`` is the one source of the position: a
    cross-attention or recurrent first block never advances a ``length``."""
    filled = seq_len if filled is None else filled
    state = {}
    for i, spec in enumerate(cfg.period):
        # one period's shapes on the meta device, then each leaf allocated once with the periods' axis: a
        # stack of per-period caches would hold the (up to tens of GB of) cache twice
        one = block_cache_init(cfg, spec, batch, seq_len, filled, device="meta")
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


def _mlp(cfg: ArchConfig, spec: BlockSpec, bp, x, bcache, prefill: bool):
    """x + mlp(ln2(x)), the RWKV channel mix's token shift carried in
    ``bcache``. Returns (x, bcache)."""
    if spec.mlp == "none":
        return x, bcache
    normed = L.rmsnorm({"scale": bp["ln2"]}, x, cfg.norm_eps)
    if spec.mlp == "dense":
        h = L.mlp(bp["mlp"], normed)
    elif spec.mlp == "moe":
        h, _ = moe_lib.moe(bp["mlp"], normed, top_k=cfg.moe.top_k, aux_coef=0.0)
    elif spec.mlp == "rwkv_ffn":
        h, ffn_x = rwkv_lib.rwkv_channel_mix(bp["mlp"], normed, state_prev=None if prefill else bcache.ffn_x_prev,
                                             return_state=True)
        bcache = dataclasses.replace(bcache, ffn_x_prev=ffn_x)
    else:
        raise ValueError(f"unknown mlp {spec.mlp!r}")
    return x + h, bcache


def _block_decode(cfg: ArchConfig, spec: BlockSpec, bp, x, bcache):
    """x: (B, 1, D) -> (x, the block's cache after the token)."""
    normed = L.rmsnorm({"scale": bp["ln1"]}, x, cfg.norm_eps)
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    if spec.mixer in ("attn", "attn_nope"):
        h, bcache = attn_lib.decode_attention(bp["mixer"], normed, bcache,
                                              rope_theta=cfg.rope_theta if spec.mixer == "attn" else None,
                                              window=spec.sliding_window, **kw)
    elif spec.mixer == "cross":
        h, bcache = attn_lib.decode_attention(bp["mixer"], normed, bcache, rope_theta=None, cross=True, **kw)
    elif spec.mixer == "mamba":
        h, bcache = mamba_lib.mamba_decode(bp["mixer"], normed, bcache, cfg.mamba.d_state)
    elif spec.mixer == "rwkv":
        h, wkv, x_last = rwkv_lib.rwkv_time_mix(bp["mixer"], normed, cfg.rwkv.head_dim, state=bcache,
                                                return_state=True)
        bcache = dataclasses.replace(bcache, x_prev=x_last, wkv=wkv)
    else:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    return _mlp(cfg, spec, bp, x + h, bcache, prefill=False)


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
def decode_step(params, specs, cfg: ArchConfig, token: torch.Tensor, state: dict):
    """One decode step: token (B, 1) int -> (logits (B, V) float32, the
    state after it).

    ``state["pos"]`` is the absolute position of the incoming token (after
    a prefill of s tokens, step t sees ``s + t``); it positions the audio
    family's sinusoidal embedding. The caches' K/V are written in place
    (the module docstring): the returned state holds ``state``'s cache
    buffers, and ``state`` is not to be used again."""
    del specs  # sharding specs wait for ROADMAP A.9b
    pos = state["pos"]
    table = params["embed"]["table"]
    x = torch.nn.functional.embedding(token, table)  # (B, 1, D), the reference's jnp.take
    if cfg.family == "audio":
        x = x + _sinusoidal_at(pos, cfg.d_model)[None, None].to(x.dtype)
    names = [f"blk{i}" for i in range(len(cfg.period))]
    new = {name: [] for name in names}
    for p, pp in enumerate(unstack_periods(params)["periods"]):
        for name, spec in zip(names, cfg.period):
            x, c = _block_decode(cfg, spec, pp[name], x, _period_view(state[name], p))
            new[name].append(c)
    out = {name: _restack(state[name], new[name]) for name in names}
    out["pos"] = pos + 1
    x = L.rmsnorm({"scale": params["ln_f"]}, x, cfg.norm_eps)
    logits = torch.einsum("bsd,vd->bsv", x, _head(params, cfg))
    return logits[:, 0, :].to(torch.float32), out


@torch.no_grad()
def prefill(params, specs, cfg: ArchConfig, tokens: torch.Tensor, *, frontend: torch.Tensor | None = None,
            capacity: int | None = None):
    """The full forward over the prompt, building the caches: tokens (B, s)
    -> (last position's logits (B, V) float32, decode state).

    Attention K/V go into a ring buffer of ``capacity`` slots (default the
    prompt's length; pass ``s + new_tokens`` to decode past the prompt
    without evicting position 0); the recurrent blocks keep their final
    states; cross-attention keeps the encoder's K/V."""
    del specs
    b, s = tokens.shape
    table = params["embed"]["table"]
    x = torch.nn.functional.embedding(tokens, table)
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
            caches[name].append(c)
    state = {name: _stack(caches[name]) for name in names}
    state["pos"] = torch.full((), s, dtype=torch.int32, device=tokens.device)
    x = L.rmsnorm({"scale": params["ln_f"]}, x, cfg.norm_eps)
    logits = torch.einsum("bd,vd->bv", x[:, -1, :], _head(params, cfg))
    return logits.to(torch.float32), state


def _block_prefill(cfg: ArchConfig, spec: BlockSpec, bp, x, positions, cross_src, seq_len: int,
                   capacity: int | None = None):
    normed = L.rmsnorm({"scale": bp["ln1"]}, x, cfg.norm_eps)
    b = x.shape[0]
    length = torch.full((), seq_len, dtype=torch.int32, device=x.device)
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    if spec.mixer in ("attn", "attn_nope"):
        h, k, v = attn_lib.multihead_attention(bp["mixer"], normed, positions,
                                               rope_theta=cfg.rope_theta if spec.mixer == "attn" else None,
                                               causal=True, window=spec.sliding_window, **kw)
        cap = _cache_capacity(cfg, spec, seq_len)
        if capacity is not None and spec.sliding_window is None:
            cap = max(cap, capacity)
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
    elif spec.mixer == "cross":
        kv_pos = torch.arange(cross_src.shape[1], device=x.device).expand(cross_src.shape[:2])
        h, k, v = attn_lib.multihead_attention(bp["mixer"], normed, positions, rope_theta=None, causal=False,
                                               kv_override=cross_src, kv_positions=kv_pos, **kw)
        bcache = attn_lib.KVCache(k=k.to(cfg.dtype), v=v.to(cfg.dtype), length=length)
    elif spec.mixer == "mamba":
        h, bcache = mamba_lib.mamba(bp["mixer"], normed, cfg.mamba.d_state, return_state=True)
    elif spec.mixer == "rwkv":
        h, wkv, x_last = rwkv_lib.rwkv_time_mix(bp["mixer"], normed, cfg.rwkv.head_dim, return_state=True)
        bcache = rwkv_lib.RWKVState(x_prev=x_last, wkv=wkv,
                                    ffn_x_prev=torch.zeros((b, cfg.d_model), dtype=cfg.dtype, device=x.device))
    else:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    return _mlp(cfg, spec, bp, x + h, bcache, prefill=True)
