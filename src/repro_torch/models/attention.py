"""GQA attention over a full sequence (training and prefill).

The logits, the mask and the softmax are written out in plain ops, in
float32, as the reference's ``_plain_attention`` does, rather than through
``scaled_dot_product_attention``, whose choice of backend would change the
rounding from call to call. Sequences longer than ``PLAIN_THRESHOLD``, where
the reference switches to its chunked online-softmax path, raise: that path
comes with serving (ROADMAP A.8). Sliding windows are masks.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope
from repro_torch.models.module import dense_param, split_tree

__all__ = ["PLAIN_THRESHOLD", "NEG_INF", "attention_init", "multihead_attention"]

PLAIN_THRESHOLD = 2048
NEG_INF = -1e30


def attention_init(generator: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
                   dtype: torch.dtype, attn_tp: str = "heads"):
    """wq, wk, wv, wo, drawn in that order."""
    # tensor parallelism over the heads, or over head_dim where n_heads does not split
    h_ax, d_ax = (None, "tp") if attn_tp == "head_dim" else ("tp", None)
    return split_tree({
        "wq": dense_param(generator, (d_model, n_heads, head_dim), ("fsdp", h_ax, d_ax), dtype),
        "wk": dense_param(generator, (d_model, n_kv_heads, head_dim), ("fsdp", h_ax, d_ax), dtype),
        "wv": dense_param(generator, (d_model, n_kv_heads, head_dim), ("fsdp", h_ax, d_ax), dtype),
        "wo": dense_param(generator, (n_heads, head_dim, d_model), (h_ax, d_ax, "fsdp"), dtype),
    })


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window: int | None) -> torch.Tensor:
    """(..., Sq, Sk) additive mask from absolute positions; a negative
    ``kpos`` marks a padding key (always masked)."""
    rel = qpos[..., :, None] - kpos[..., None, :]
    ok = kpos[..., None, :] >= 0
    if causal:
        ok = ok & (rel >= 0)
    if window is not None:
        ok = ok & (rel < window)
    return torch.where(ok, 0.0, NEG_INF)


def _plain_attention(q, k, v, qpos, kpos, causal: bool, window: int | None) -> torch.Tensor:
    """q: (B,Sq,Hkv,G,D); k,v: (B,Sk,Hkv,D) -> (B,Sq,Hkv,G,D)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q, k).to(torch.float32) * scale
    logits = logits + _mask(qpos, kpos, causal, window)[:, None, None]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def multihead_attention(
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    rope_theta: float | None,
    causal: bool = True,
    window: int | None = None,
    kv_override: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
):
    """Self- or cross-attention over a full sequence.

    Returns (output (B,S,Dm), k, v)."""
    g = n_heads // n_kv_heads
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    kv_src = x if kv_override is None else kv_override
    k = torch.einsum("bsd,dhk->bshk", kv_src, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_src, params["wv"])
    kpos = positions if kv_positions is None else kv_positions
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, kpos, rope_theta)
    b, sq = q.shape[0], q.shape[1]
    if max(sq, k.shape[1]) > PLAIN_THRESHOLD:
        raise ValueError(
            f"sequences over {PLAIN_THRESHOLD} tokens take the reference's chunked online-softmax "
            "path, which is not ported yet (ROADMAP A.8)")
    qg = q.reshape(b, sq, n_kv_heads, g, q.shape[-1])
    out = _plain_attention(qg, k, v, positions, kpos, causal, window)
    out = out.reshape(b, sq, n_heads, q.shape[-1])
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), k, v
