"""The transformer LM over every family of ``configs/archs.py``.

A model is a repeating *period* of blocks (``ArchConfig.period``). As in
the reference, the parameters of each block position are stacked over the
periods on a leading axis (``periods.blk{i}.*``), and the whisper encoder's
over its layers (``encoder.*``); a Python loop over the periods and layers
takes the place of ``lax.scan``. ``params["periods"]`` and
``params["encoder"]`` may also be lists with one tree per period or layer
(``unstack_periods``), whose leaves are then separate tensors: a gradient
taken through that form comes out per period, with no zero-filled stack
per layer.

Block kinds (``configs.base.BlockSpec``): ``attn`` (causal GQA with RoPE,
optional sliding window), ``attn_nope`` (no RoPE: whisper; causal unless
it is the audio encoder's), ``cross`` (cross-attention to the frontend or
encoder tokens), ``mamba`` and ``rwkv``. MLPs: ``dense`` (SwiGLU), ``moe``,
``rwkv_ffn`` and ``none``. The vlm and audio families take stub frontend
embeddings ``(B, n_frontend_tokens, d_frontend)``, projected to d_model;
audio runs them through its encoder stack, with sinusoidal positions on
the frames and on the tokens.

Every parameter goes through ``core.protomath`` (in the layers, and here
the frontend projection and the head): under a protocol context the loops
over the periods, the encoder's layers and the loss's chunks each share
their body's call sites (``protomath.shared_sites``), as the reference's
scans trace their body once.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import pytree
from repro_torch.configs.base import ArchConfig, BlockSpec
from repro_torch.core.protomath import plookup, pmm, shared_sites
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models.module import dense_param, split_tree

__all__ = ["CE_CHUNK", "FRONTEND_FAMILIES", "init", "unstack_periods", "hidden_states", "forward", "loss_fn"]

CE_CHUNK = 512  # sequence positions per cross-entropy chunk
ENCODER_BLOCK = BlockSpec(mixer="attn_nope", mlp="dense")
FRONTEND_FAMILIES = ("vlm", "audio")  # the families that take frontend embeddings


def _block_init(generator: torch.Generator, cfg: ArchConfig, spec: BlockSpec):
    """One block's (params, specs): ln1, the mixer, and unless the MLP is
    ``none`` ln2 and the MLP, drawn in that order."""
    dev, dtype = generator.device, cfg.dtype
    pairs: dict[str, Any] = {}
    p_ln1, s_ln1 = L.rmsnorm_init(cfg.d_model, device=dev)
    pairs["ln1"] = (p_ln1["scale"], s_ln1["scale"])
    if spec.mixer in ("attn", "attn_nope", "cross"):
        p, s = attn_lib.attention_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                                       dtype, attn_tp=cfg.attn_tp)
    elif spec.mixer == "mamba":
        mc = cfg.mamba
        p, s = mamba_lib.mamba_init(generator, cfg.d_model, mc.d_state, mc.d_conv, mc.expand, dtype)
    elif spec.mixer == "rwkv":
        p, s = rwkv_lib.rwkv_time_mix_init(generator, cfg.d_model, cfg.rwkv.head_dim, cfg.rwkv.decay_lora, dtype)
    else:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    pairs["mixer"] = {k: (p[k], s[k]) for k in p}
    if spec.mlp != "none":
        p_ln2, s_ln2 = L.rmsnorm_init(cfg.d_model, device=dev)
        pairs["ln2"] = (p_ln2["scale"], s_ln2["scale"])
        if spec.mlp == "dense":
            p, s = L.mlp_init(generator, cfg.d_model, cfg.d_ff, dtype)
        elif spec.mlp == "moe":
            mo = cfg.moe
            p, s = moe_lib.moe_init(generator, cfg.d_model, mo.d_ff_expert or cfg.d_ff, mo.n_experts, dtype)
        elif spec.mlp == "rwkv_ffn":
            p, s = rwkv_lib.rwkv_channel_mix_init(generator, cfg.d_model, cfg.d_ff, dtype)
        else:
            raise ValueError(f"unknown mlp {spec.mlp!r}")
        pairs["mlp"] = {k: (p[k], s[k]) for k in p}
    return split_tree(pairs)


def _stacked(blocks: list):
    """(params, specs) of a list of equal blocks' (params, specs), stacked
    on a leading axis."""
    return (pytree.map_tree(lambda *xs: torch.stack(xs), *[b[0] for b in blocks]), _stack_specs(blocks[0][1]))


def init(generator: torch.Generator, cfg: ArchConfig):
    """Initialize the model from ``generator`` on its device: the embedding
    table, the untied head if any, every period's blocks in order, then the
    frontend projection and the encoder's layers where the family has them.
    Returns (params, specs) trees of the reference's structure."""
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
    params["periods"], specs["periods"] = {}, {}
    for name in per[0]:
        params["periods"][name], specs["periods"][name] = _stacked([p[name] for p in per])
    if cfg.family in FRONTEND_FAMILIES:
        params["frontend_proj"], specs["frontend_proj"] = dense_param(
            generator, (cfg.encoder.d_frontend, cfg.d_model), (None, "fsdp"), cfg.dtype)
    if cfg.family == "audio" and cfg.encoder.n_encoder_layers > 0:
        params["encoder"], specs["encoder"] = _stacked(
            [_block_init(generator, cfg, ENCODER_BLOCK) for _ in range(cfg.encoder.n_encoder_layers)])
        p_lne, s_lne = L.rmsnorm_init(cfg.d_model, device=dev)
        params["encoder_ln"], specs["encoder_ln"] = p_lne["scale"], s_lne["scale"]
    return params, specs


def _stack_specs(specs):
    """A spec tree with the leading ``"stack"`` axis added to every spec."""
    if isinstance(specs, dict):
        return {k: _stack_specs(v) for k, v in specs.items()}
    return ("stack",) + tuple(specs)


def unstack_periods(params, lead: int = 0) -> Any:
    """``params`` with ``periods`` (and the ``encoder`` stack, where there
    is one) as a list of per-period (per-layer) trees: period ``p``'s
    leaves are views of the stacked ones at index ``p`` of the stacking
    axis, which follows ``lead`` leading axes (1 for a tree of ``(N, ...)``
    per-subset stacks)."""
    at = (slice(None),) * lead
    out = dict(params)
    for key in ("periods", "encoder"):
        stack = params.get(key)
        if stack is None or isinstance(stack, list):
            continue
        n = pytree.leaves(stack)[0].shape[lead]
        out[key] = [pytree.map_tree(lambda a, p=p: a[at + (p,)], stack) for p in range(n)]
    return out


def _mixer_apply(cfg: ArchConfig, spec: BlockSpec, bp, x, positions, cross_src):
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    if spec.mixer == "attn":
        return attn_lib.multihead_attention(bp["mixer"], x, positions, rope_theta=cfg.rope_theta, causal=True,
                                            window=spec.sliding_window, **kw)[0]
    if spec.mixer == "attn_nope":
        causal = cfg.family != "audio" or cross_src is not None  # whisper's encoder sees both ways
        return attn_lib.multihead_attention(bp["mixer"], x, positions, rope_theta=None, causal=causal,
                                            window=spec.sliding_window, **kw)[0]
    if spec.mixer == "cross":
        kv_pos = torch.arange(cross_src.shape[1], device=x.device).expand(cross_src.shape[:2])
        return attn_lib.multihead_attention(bp["mixer"], x, positions, rope_theta=None, causal=False,
                                            kv_override=cross_src, kv_positions=kv_pos, **kw)[0]
    if spec.mixer == "mamba":
        return mamba_lib.mamba(bp["mixer"], x, cfg.mamba.d_state)
    if spec.mixer == "rwkv":
        return rwkv_lib.rwkv_time_mix(bp["mixer"], x, cfg.rwkv.head_dim)
    raise ValueError(f"unknown mixer {spec.mixer!r}")


def _block_apply(cfg: ArchConfig, spec: BlockSpec, bp, x, positions, cross_src):
    """One block: x + mixer(ln1(x)), then + mlp(ln2(x)). Returns (x, the
    MoE aux loss (0.0 for the other MLPs))."""
    x = x + _mixer_apply(cfg, spec, bp, L.rmsnorm({"scale": bp["ln1"]}, x, cfg.norm_eps), positions, cross_src)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.mlp == "none":
        return x, aux
    normed = L.rmsnorm({"scale": bp["ln2"]}, x, cfg.norm_eps)
    if spec.mlp == "dense":
        h = L.mlp(bp["mlp"], normed)
    elif spec.mlp == "moe":
        h, aux = moe_lib.moe(bp["mlp"], normed, top_k=cfg.moe.top_k, aux_coef=cfg.moe.router_aux_coef)
    elif spec.mlp == "rwkv_ffn":
        h = rwkv_lib.rwkv_channel_mix(bp["mlp"], normed)
    else:
        raise ValueError(f"unknown mlp {spec.mlp!r}")
    return x + h, aux


def _encode_frontend(params, cfg: ArchConfig, frontend: torch.Tensor) -> torch.Tensor:
    """The stub frontend embeddings (B, F, d_frontend) projected to
    d_model (cast to the arch's dtype first, then to the projection's, as
    the reference's promotion does); for audio, with sinusoidal positions
    through the encoder stack and its final norm."""
    proj = params["frontend_proj"]
    f = frontend.to(cfg.dtype)
    src = pmm("bsf,fd->bsd", f.to(torch.promote_types(f.dtype, proj.dtype)), proj, w_spec=(None, "fsdp"))
    if cfg.family == "audio" and cfg.encoder.n_encoder_layers > 0:
        src = src + L.sinusoidal_positions(src.shape[1], cfg.d_model, device=src.device)[None].to(src.dtype)
        positions = torch.arange(src.shape[1], device=src.device).expand(src.shape[:2])
        sites = shared_sites()
        for layer in unstack_periods(params)["encoder"]:
            with sites:
                src, _ = _block_apply(cfg, ENCODER_BLOCK, layer, src, positions, None)
        src = L.rmsnorm({"scale": params["encoder_ln"]}, src, cfg.norm_eps)
    return src


def hidden_states(params, specs, cfg: ArchConfig, tokens: torch.Tensor, *, frontend: torch.Tensor | None = None):
    """Backbone forward to the final norm: tokens (B, S) (and, for vlm and
    audio, the frontend (B, F, d_frontend)) -> (hidden (B, S, D), the MoE
    aux loss (fp32 scalar), the embedding table)."""
    del specs  # the call sites name their parameters' logical axes
    b, s = tokens.shape
    x = L.embed(params["embed"], tokens)
    if cfg.family == "audio":
        x = x + L.sinusoidal_positions(s, cfg.d_model, device=x.device)[None].to(x.dtype)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    cross_src = None
    if cfg.family in FRONTEND_FAMILIES:
        if frontend is None:
            raise ValueError(f"{cfg.name} ({cfg.family}) needs frontend embeddings")
        cross_src = _encode_frontend(params, cfg, frontend)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    sites = shared_sites()
    for period in unstack_periods(params)["periods"]:
        aux_p = torch.zeros((), dtype=torch.float32, device=x.device)
        with sites:
            for i, spec in enumerate(cfg.period):
                x, a = _block_apply(cfg, spec, period[f"blk{i}"], x, positions, cross_src)
                aux_p = aux_p + a
        aux = aux + aux_p
    x = L.rmsnorm({"scale": params["ln_f"]}, x, cfg.norm_eps)
    return x, aux, params["embed"]["table"]


def _unembed_table(params, cfg: ArchConfig, emb_table: torch.Tensor) -> torch.Tensor:
    return emb_table if cfg.tie_embeddings else params["lm_head"]


def forward(params, specs, cfg: ArchConfig, tokens: torch.Tensor, *, frontend: torch.Tensor | None = None):
    """Full-sequence forward: tokens (B, S) -> (logits (B, S, V) fp32, aux)."""
    x, aux, emb_table = hidden_states(params, specs, cfg, tokens, frontend=frontend)
    head = _unembed_table(params, cfg, emb_table)
    return pmm("bsd,vd->bsv", x, head, w_spec=("tp", "fsdp")).to(torch.float32), aux


def _chunked_ce(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy over sequence chunks of ``CE_CHUNK``:
    ``nll = logsumexp(x @ head^T) - <x, head[label]>``, the label logit from
    the label's row of the head (``protomath.plookup``), never a V-sized
    one-hot of the logits."""
    b, s, d = x.shape
    chunk = min(CE_CHUNK, s)
    if s % chunk != 0:
        raise ValueError(f"sequence length {s} is not a multiple of the CE chunk {chunk}")
    nll = []
    sites = shared_sites()
    for start in range(0, s, chunk):
        xc, lc = x[:, start:start + chunk], labels[:, start:start + chunk]
        with sites:
            logits = pmm("bsd,vd->bsv", xc, head, w_spec=("tp", "fsdp")).to(torch.float32)
            lab_rows = plookup(head, lc, w_spec=("tp", "fsdp")).to(torch.float32)  # (B, chunk, D)
        lse = torch.logsumexp(logits, dim=-1)  # (B, chunk)
        nll.append(lse - torch.sum(xc.to(torch.float32) * lab_rows, dim=-1))
    return torch.mean(torch.stack(nll))


def loss_fn(params, specs, cfg: ArchConfig, batch: dict):
    """Next-token cross entropy plus the MoE aux loss: batch holds
    ``tokens`` and ``labels`` (B, S), and for vlm and audio ``frontend``.
    Returns (loss, {"nll", "aux"})."""
    x, aux, emb_table = hidden_states(params, specs, cfg, batch["tokens"], frontend=batch.get("frontend"))
    nll = _chunked_ce(x, _unembed_table(params, cfg, emb_table), batch["labels"])
    return nll + aux, {"nll": nll, "aux": aux}
