"""Mamba (selective SSM) mixer, the Jamba hybrid's recurrent block, over a
full sequence.

The Mamba-1 block: in-projection to (x, z), causal depthwise conv,
input-dependent (Δ, B, C) selection and the diagonal recurrence

    h_t = exp(Δ_t ⊙ A) h_{t-1} + Δ_t B_t x_t,   y_t = C_t · h_t + D ⊙ x_t,

gated by SiLU(z) and projected out. The reference's ``lax.scan`` over the
sequence is a Python loop over the tokens here, the state in float32: a
few launches a token, forward and backward, which graph mode captures with
the rest of the round (PERF.md counts them). The decode step and its state
come with serving (ROADMAP A.8).
"""
from __future__ import annotations

import torch

from repro_torch.models.module import dense_param, scale_param, split_tree, zeros_param

__all__ = ["mamba_init", "mamba"]


def mamba_init(generator: torch.Generator, d_model: int, d_state: int, d_conv: int, expand: int,
               dtype: torch.dtype):
    """in_proj, conv_w, x_proj, dt_proj, out_proj drawn in that order; A
    stored as ``a_log = log([1..d_state])`` per channel (S4D-real)."""
    dev = generator.device
    d_inner = expand * d_model
    dt_rank = max(1, d_model // 16)
    a_log = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32, device=dev)).repeat(d_inner, 1)
    draws = {
        "in_proj": dense_param(generator, (d_model, 2 * d_inner), ("fsdp", "tp"), dtype),
        "conv_w": dense_param(generator, (d_conv, d_inner), (None, "tp"), dtype, scale=1.0),
        "x_proj": dense_param(generator, (d_inner, dt_rank + 2 * d_state), ("tp", None), dtype),
        "dt_proj": dense_param(generator, (dt_rank, d_inner), (None, "tp"), dtype),
        "out_proj": dense_param(generator, (d_inner, d_model), ("tp", "fsdp"), dtype),
    }
    return split_tree({
        **draws,
        "conv_b": zeros_param((d_inner,), ("tp",), dtype, device=dev),
        "dt_bias": zeros_param((d_inner,), ("tp",), torch.float32, device=dev),
        "a_log": (a_log, ("tp", None)),
        "d_skip": scale_param((d_inner,), ("tp",), torch.float32, 1.0, device=dev),
    })


def _causal_depthwise_conv(xz: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """xz: (B, S, C); w: (K, C) depthwise taps; a causal conv along S, the
    taps summed in order."""
    k, s = w.shape[0], xz.shape[1]
    pad = torch.nn.functional.pad(xz, (0, 0, k - 1, 0))
    out = torch.zeros_like(xz)
    for i in range(k):
        out = out + pad[:, i:i + s, :] * w[i]
    return out + b


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it,
    ``max(x, 0) + log1p(exp(-|x|))``, with no cut-off (``F.softplus``
    returns ``x`` itself above 20)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _selection(params, x_in: torch.Tensor, d_state: int):
    """Input-dependent Δ (fp32, softplus), B, C. x_in: (..., d_inner)."""
    dt_rank = params["dt_proj"].shape[0]
    proj = x_in @ params["x_proj"]
    dt_raw, b_sel, c_sel = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = (dt_raw @ params["dt_proj"]).to(torch.float32)
    dt = softplus(dt + params["dt_bias"])
    return dt, b_sel.to(torch.float32), c_sel.to(torch.float32)


def mamba(params, x: torch.Tensor, d_state: int) -> torch.Tensor:
    """Full-sequence selective scan. x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    xz = x @ params["in_proj"]
    x_raw, z = torch.chunk(xz, 2, dim=-1)
    x_in = _causal_depthwise_conv(x_raw, params["conv_w"], params["conv_b"])
    x_in = torch.nn.functional.silu(x_in.to(torch.float32)).to(x.dtype)

    dt, b_sel, c_sel = _selection(params, x_in, d_state)
    a = -torch.exp(params["a_log"])  # (di, ds)
    dtx = dt * x_in.to(torch.float32)  # (B, S, di)
    h = x.new_zeros((b, a.shape[0], d_state), dtype=torch.float32)
    ys = []
    for t in range(s):
        h = torch.exp(dt[:, t, :, None] * a) * h + dtx[:, t, :, None] * b_sel[:, t, None, :]
        ys.append(torch.einsum("bis,bs->bi", h, c_sel[:, t]))
    y = torch.stack(ys, dim=1) + x_in.to(torch.float32) * params["d_skip"]
    y = y.to(x.dtype) * torch.nn.functional.silu(z.to(torch.float32)).to(x.dtype)
    return y @ params["out_proj"]

