"""Mamba (selective SSM) mixer, the Jamba hybrid's recurrent block: over a
full sequence, and one token at a time against its state (decode).

The Mamba-1 block: in-projection to (x, z), causal depthwise conv,
input-dependent (Δ, B, C) selection and the diagonal recurrence

    h_t = exp(Δ_t ⊙ A) h_{t-1} + Δ_t B_t x_t,   y_t = C_t · h_t + D ⊙ x_t,

gated by SiLU(z) and projected out. The reference's ``lax.scan`` over the
sequence is a Python loop over the tokens here, the state in float32: a
few launches a token, forward and backward, which graph mode captures with
the rest of the round (PERF.md counts them). ``mamba(...,
return_state=True)`` also returns the ``MambaState`` a prefill leaves (the
conv window's last ``d_conv - 1`` inputs and the final SSM state), from
which ``mamba_decode`` takes single steps.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.protomath import block_tap, pbias, pmm, pscale
from repro_torch.models.module import dense_param, scale_param, split_tree, zeros_param

__all__ = ["mamba_init", "mamba", "MambaState", "init_mamba_state", "mamba_decode"]


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


@dataclasses.dataclass(frozen=True)
class MambaState:
    conv: torch.Tensor  # (B, d_conv - 1, d_inner): the last inputs of the conv window
    h: torch.Tensor  # (B, d_inner, d_state) float32 SSM state


def init_mamba_state(batch: int, d_inner: int, d_state: int, d_conv: int, dtype: torch.dtype,
                     device: torch.device | str | None = None) -> MambaState:
    return MambaState(conv=torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype, device=device),
                      h=torch.zeros((batch, d_inner, d_state), dtype=torch.float32, device=device))


def _causal_depthwise_conv(xz: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """xz: (B, S, C); w: (K, C) depthwise taps; a causal conv along S, the
    taps summed in order."""
    k, s = w.shape[0], xz.shape[1]
    pad = torch.nn.functional.pad(xz, (0, 0, k - 1, 0))
    out = torch.zeros_like(xz)
    for i in range(k):
        out = out + pscale(pad[:, i:i + s, :], w[i])
    return pbias(out, b)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it,
    ``max(x, 0) + log1p(exp(-|x|))``, with no cut-off (``F.softplus``
    returns ``x`` itself above 20)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _selection(params, x_in: torch.Tensor, d_state: int):
    """Input-dependent Δ (fp32, softplus), B, C. x_in: (..., d_inner)."""
    dt_rank = params["dt_proj"].shape[0]
    proj = pmm("...i,ir->...r", x_in, params["x_proj"], w_spec=("tp", None))
    dt_raw, b_sel, c_sel = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = pmm("...r,ri->...i", dt_raw, params["dt_proj"], w_spec=(None, "tp")).to(torch.float32)
    dt = softplus(pbias(dt, params["dt_bias"]))
    return dt, b_sel.to(torch.float32), c_sel.to(torch.float32)


def mamba(params, x: torch.Tensor, d_state: int, return_state: bool = False):
    """Full-sequence selective scan. x: (B, S, D) -> (B, S, D), and with
    ``return_state`` the ``MambaState`` after the last token as well."""
    b, s, _ = x.shape
    xz = pmm("bsd,di->bsi", x, params["in_proj"], w_spec=("fsdp", "tp"))
    x_raw, z = torch.chunk(xz, 2, dim=-1)
    x_in = _causal_depthwise_conv(x_raw, params["conv_w"], params["conv_b"])
    x_in = torch.nn.functional.silu(x_in.to(torch.float32)).to(x.dtype)

    dt, b_sel, c_sel = _selection(params, x_in, d_state)
    a_b, nb = block_tap(-torch.exp(params["a_log"]))  # (nb, di, ds): one A a device block
    if b % nb != 0:
        raise ValueError(f"batch {b} does not split into {nb} device blocks")
    dtx = dt * x_in.to(torch.float32)  # (B, S, di)
    h = x.new_zeros((b, a_b.shape[1], d_state), dtype=torch.float32)
    ys = []
    for t in range(s):
        if nb == 1:
            decay = torch.exp(dt[:, t, :, None] * a_b[0])
        else:  # each block's rows against its own A
            decay = torch.exp(dt[:, t].reshape(nb, b // nb, -1)[..., None] * a_b[:, None]).reshape(h.shape)
        h = decay * h + dtx[:, t, :, None] * b_sel[:, t, None, :]
        ys.append(torch.einsum("bis,bs->bi", h, c_sel[:, t]))
    y = torch.stack(ys, dim=1) + pscale(x_in.to(torch.float32), params["d_skip"])
    y = y.to(x.dtype) * torch.nn.functional.silu(z.to(torch.float32)).to(x.dtype)
    out = pmm("bsi,id->bsd", y, params["out_proj"], w_spec=("tp", "fsdp"))
    if not return_state:
        return out
    d_conv = params["conv_w"].shape[0]
    tail = torch.nn.functional.pad(x_raw, (0, 0, max(d_conv - 1 - s, 0), 0))[:, -(d_conv - 1):]
    return out, MambaState(conv=tail, h=h)


def mamba_decode(params, x: torch.Tensor, state: MambaState, d_state: int):
    """One token. x: (B, 1, D) -> (y (B, 1, D), the new ``MambaState``)."""
    xz = torch.einsum("bsd,di->bsi", x, params["in_proj"])
    x_in, z = torch.chunk(xz, 2, dim=-1)  # (B, 1, di)
    window = torch.cat([state.conv, x_in], dim=1)  # (B, d_conv, di)
    conv_out = torch.einsum("bki,ki->bi", window, params["conv_w"]) + params["conv_b"]
    x_t = torch.nn.functional.silu(conv_out.to(torch.float32)).to(x.dtype)  # (B, di)
    dt, b_sel, c_sel = _selection(params, x_t, d_state)
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dt[..., None] * a[None])
    h = decay * state.h + (dt * x_t.to(torch.float32))[..., None] * b_sel[:, None, :]
    y = torch.einsum("bis,bs->bi", h, c_sel) + params["d_skip"][None] * x_t.to(torch.float32)
    y = y.to(x.dtype) * torch.nn.functional.silu(z[:, 0].to(torch.float32)).to(x.dtype)
    out = torch.einsum("bi,id->bd", y, params["out_proj"])[:, None, :]
    return out, MambaState(conv=window[:, 1:], h=h)

