"""Shared layers: norms, embeddings, RoPE, SwiGLU MLP.

Every parameter goes through ``core.protomath``'s ``pmm`` / ``plookup`` /
``pscale``, as in the reference: outside a protocol context they are the
plain einsum, lookup and product; under one (the ``"protomath"`` train
step) their backward runs the LAD exchange.

A row lookup (``lookup``: the embedding, and the label rows of the loss) is
written as a one-hot product. Its forward equals the gather exactly (each
output is one ``1.0 * w`` product plus exact zeros), and its backward is a
matrix product rather than a scatter-add, whose atomics on CUDA would add a
token's gradients in an order that changes from run to run.
"""
from __future__ import annotations

import torch

from repro_torch.core.protomath import lookup, plookup, pmm, pscale
from repro_torch.models.module import dense_param, scale_param, split_tree

__all__ = ["rmsnorm_init", "rmsnorm", "lookup", "embedding_init", "embed", "unembed", "rope_frequencies",
           "apply_rope", "sinusoidal_positions", "mlp_init", "mlp"]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_init(d_model: int, device=None):
    return split_tree({"scale": scale_param((d_model,), (None,), device=device)})


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in float32, cast back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return pscale(out, params["scale"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embedding_init(generator: torch.Generator, vocab: int, d_model: int, dtype: torch.dtype):
    return split_tree({"table": dense_param(generator, (vocab, d_model), ("tp", "fsdp"), dtype, scale=1.0)})


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return plookup(params["table"], tokens, w_spec=("tp", "fsdp"))


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Logits via the (tied or untied) embedding table: (..., d) @ (V, d)^T."""
    return pmm("...d,vd->...v", x, params["table"], w_spec=("tp", "fsdp")).to(torch.float32)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding in the split-halves form: x (..., seq, heads,
    head_dim), positions (..., seq) int."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, device=x.device)  # (hd/2,)
    angles = positions[..., :, None, None].to(torch.float32) * freqs  # (..., seq, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def sinusoidal_positions(seq: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal position embeddings: (seq, d_model)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.full((), 10000.0, device=device), dim / d_model)  # no host copy: graph capture
    pe = torch.zeros((seq, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    # odd d_model: the cos half has floor(d/2) slots, the last sin frequency no partner
    pe[:, 1::2] = torch.cos(angle[:, : d_model // 2])
    return pe


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype):
    return split_tree({
        "w_gate": dense_param(generator, (d_model, d_ff), ("fsdp", "tp"), dtype),
        "w_up": dense_param(generator, (d_model, d_ff), ("fsdp", "tp"), dtype),
        "w_down": dense_param(generator, (d_ff, d_model), ("tp", "fsdp"), dtype),
    })


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    gate = pmm("bsd,df->bsf", x, params["w_gate"], w_spec=("fsdp", "tp"))
    up = pmm("bsd,df->bsf", x, params["w_up"], w_spec=("fsdp", "tp"))
    act = torch.nn.functional.silu(gate.to(torch.float32)).to(x.dtype) * up
    return pmm("bsf,fd->bsd", act, params["w_down"], w_spec=("tp", "fsdp"))
