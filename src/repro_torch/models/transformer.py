"""The transformer LM of the ``dense`` family.

A model is a repeating *period* of blocks (``ArchConfig.period``). As in
the reference, the parameters of each block position are stacked over the
periods on a leading axis (``periods.blk{i}.*``); a Python loop over the
periods takes the place of ``lax.scan``. ``params["periods"]`` may also be
a list with one tree per period (``unstack_periods``), whose leaves are
then separate tensors: a gradient taken through that form comes out per
period, with no zero-filled stack per layer.

Only the ``dense`` family (causal GQA with RoPE, optional sliding window,
SwiGLU MLP, tied or untied unembedding) is ported; the other families
(MoE, Mamba, RWKV, cross-attention and audio frontends) raise, naming the
slice that brings them (ROADMAP A.7c).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import pytree
from repro_torch.configs.base import ArchConfig, BlockSpec
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.module import dense_param, split_tree

__all__ = ["CE_CHUNK", "init", "unstack_periods", "hidden_states", "forward", "loss_fn"]

CE_CHUNK = 512  # sequence positions per cross-entropy chunk


def _check_supported(cfg: ArchConfig) -> None:
    bad = [s for s in cfg.period if s.mixer != "attn" or s.mlp != "dense"]
    if cfg.family != "dense" or bad:
        raise ValueError(
            f"{cfg.name}: family {cfg.family!r} with blocks {bad or list(cfg.period)} is not ported; "
            "the port runs the dense family (attn + dense SwiGLU); the others come with ROADMAP A.7c")


def _block_init(generator: torch.Generator, cfg: ArchConfig, spec: BlockSpec):
    """One block's (params, specs): ln1, the attention (wq, wk, wv, wo), ln2
    and the MLP (w_gate, w_up, w_down), drawn in that order."""
    dev = generator.device
    pairs: dict[str, Any] = {}
    p_ln1, s_ln1 = L.rmsnorm_init(cfg.d_model, device=dev)
    pairs["ln1"] = (p_ln1["scale"], s_ln1["scale"])
    p, s = attn_lib.attention_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                                   cfg.dtype, attn_tp=cfg.attn_tp)
    pairs["mixer"] = {k: (p[k], s[k]) for k in p}
    p_ln2, s_ln2 = L.rmsnorm_init(cfg.d_model, device=dev)
    pairs["ln2"] = (p_ln2["scale"], s_ln2["scale"])
    p, s = L.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.dtype)
    pairs["mlp"] = {k: (p[k], s[k]) for k in p}
    return split_tree(pairs)


def init(generator: torch.Generator, cfg: ArchConfig):
    """Initialize the model from ``generator`` on its device: the embedding
    table, the untied head if any, then every period's blocks in order.
    Returns (params, specs) trees of the reference's structure."""
    _check_supported(cfg)
    dev = generator.device
    params, specs = {}, {}
    p, s = L.embedding_init(generator, cfg.vocab, cfg.d_model, cfg.dtype)
    params["embed"], specs["embed"] = p, s
    p_lnf, s_lnf = L.rmsnorm_init(cfg.d_model, device=dev)
    params["ln_f"], specs["ln_f"] = p_lnf["scale"], s_lnf["scale"]
    if not cfg.tie_embeddings:
        params["lm_head"], specs["lm_head"] = dense_param(generator, (cfg.vocab, cfg.d_model), ("tp", "fsdp"),
                                                          cfg.dtype)
    per = [{f"blk{i}": _block_init(generator, cfg, spec) for i, spec in enumerate(cfg.period)}
           for _ in range(cfg.n_periods)]
    params["periods"] = {name: pytree.map_tree(lambda *xs: torch.stack(xs), *[p[name][0] for p in per])
                         for name in per[0]}
    specs["periods"] = {name: _stack_specs(per[0][name][1]) for name in per[0]}
    return params, specs


def _stack_specs(specs):
    """A spec tree with the leading ``"stack"`` axis added to every spec."""
    if isinstance(specs, dict):
        return {k: _stack_specs(v) for k, v in specs.items()}
    return ("stack",) + tuple(specs)


def unstack_periods(params, lead: int = 0) -> Any:
    """``params`` with ``periods`` as a list of per-period trees: period
    ``p``'s leaves are views of the stacked ones at index ``p`` of the
    stacking axis, which follows ``lead`` leading axes (1 for a tree of
    ``(N, ...)`` per-subset stacks)."""
    periods = params["periods"]
    if isinstance(periods, list):
        return params
    n = pytree.leaves(periods)[0].shape[lead]
    at = (slice(None),) * lead
    return {**params, "periods": [pytree.map_tree(lambda a, p=p: a[at + (p,)], periods) for p in range(n)]}


def _block_apply(cfg: ArchConfig, spec: BlockSpec, bp, x, positions):
    h, _, _ = attn_lib.multihead_attention(
        bp["mixer"], L.rmsnorm({"scale": bp["ln1"]}, x, cfg.norm_eps), positions,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, rope_theta=cfg.rope_theta,
        causal=True, window=spec.sliding_window,
    )
    x = x + h
    return x + L.mlp(bp["mlp"], L.rmsnorm({"scale": bp["ln2"]}, x, cfg.norm_eps))


def hidden_states(params, specs, cfg: ArchConfig, tokens: torch.Tensor):
    """Backbone forward to the final norm: tokens (B, S) -> (hidden (B, S,
    D), aux (0.0: no MoE), the embedding table)."""
    del specs  # sharding specs wait for the sharded step (ROADMAP A.9)
    _check_supported(cfg)
    b, s = tokens.shape
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    for period in unstack_periods(params)["periods"]:
        for i, spec in enumerate(cfg.period):
            x = _block_apply(cfg, spec, period[f"blk{i}"], x, positions)
    x = L.rmsnorm({"scale": params["ln_f"]}, x, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), params["embed"]["table"]


def _unembed_table(params, cfg: ArchConfig, emb_table: torch.Tensor) -> torch.Tensor:
    return emb_table if cfg.tie_embeddings else params["lm_head"]


def forward(params, specs, cfg: ArchConfig, tokens: torch.Tensor):
    """Full-sequence forward: tokens (B, S) -> (logits (B, S, V) fp32, aux)."""
    x, aux, emb_table = hidden_states(params, specs, cfg, tokens)
    head = _unembed_table(params, cfg, emb_table)
    return (x @ head.T).to(torch.float32), aux


def _chunked_ce(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy over sequence chunks of ``CE_CHUNK``:
    ``nll = logsumexp(x @ head^T) - <x, head[label]>``, the label logit from
    the label's row of the head (``layers.lookup``), never a V-sized
    one-hot of the logits."""
    b, s, d = x.shape
    chunk = min(CE_CHUNK, s)
    if s % chunk != 0:
        raise ValueError(f"sequence length {s} is not a multiple of the CE chunk {chunk}")
    nll = []
    for start in range(0, s, chunk):
        xc, lc = x[:, start:start + chunk], labels[:, start:start + chunk]
        logits = (xc @ head.T).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)  # (B, chunk)
        lab_rows = L.lookup(head, lc).to(torch.float32)  # (B, chunk, D)
        nll.append(lse - torch.sum(xc.to(torch.float32) * lab_rows, dim=-1))
    return torch.mean(torch.stack(nll))


def loss_fn(params, specs, cfg: ArchConfig, batch: dict):
    """Next-token cross entropy: batch holds ``tokens`` and ``labels`` (B, S).
    Returns (loss, {"nll", "aux"})."""
    x, aux, emb_table = hidden_states(params, specs, cfg, batch["tokens"])
    nll = _chunked_ce(x, _unembed_table(params, cfg, emb_table), batch["labels"])
    return nll + aux, {"nll": nll, "aux": aux}
