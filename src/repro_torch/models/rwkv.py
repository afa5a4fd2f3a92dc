"""RWKV-6 ("Finch") time-mix and channel-mix blocks [arXiv:2404.05892].

Token-shift interpolation with learned per-channel mixing coefficients,
receptance/key/value/gate projections, the data-dependent decay ``w_t =
exp(-exp(w0 + LoRA(x_shifted)))``, the bonus ``u`` for the current token,
and the per-head matrix-valued WKV state

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t @ S_{t-1} + (sum_i r_i u_i k_i) * v_t

with the u-bonus readout computed outside the recurrence, as the reference
does. The reference's ``lax.scan`` over the sequence is a Python loop over
the tokens here, the state in float32 (graph mode captures it; PERF.md
counts its launches a token). The readout is group-normed per head and
gated by SiLU(g). The channel mix is RWKV's squared-ReLU FFN with token
shift. Given a ``state`` (``RWKVState``), both mixes continue from it: the
token shift starts from the carried last input and the time mix from the
carried WKV matrix, so a decode step is the same functions on one token;
``return_state`` asks for what a prefill or a step leaves.

Every parameter goes through ``core.protomath`` at the reference's call
sites; the u-bonus readout is outside the recurrence, so ``bonus_u`` is
exchanged once, not a token.

Under a protocol context that cuts the heads over the model ranks (the
d_model columns of ``wr``, ``wk``, ``wv``, ``wg`` and ``w_lora_b``), each
rank runs its heads: the WKV state, ``bonus_u`` and the per-head group
norm are local, the whole ``w0`` and ``ln_scale`` are cut to its columns
(``pscale``/``pbias``; their cotangents joined whole before the exchange)
and ``wo`` is row-parallel. In the channel mix ``wr``'s output is cut and
``wv``'s row-parallel output whole: the receptance is gathered whole over
the model ranks (``protomath.model_join``) before the product.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.protomath import model_join, pbias, pmm, pscale, tp_dim_of
from repro_torch.models.module import dense_param, scale_param, split_tree, zeros_param

__all__ = ["rwkv_time_mix_init", "rwkv_channel_mix_init", "rwkv_time_mix", "rwkv_channel_mix", "RWKVState",
           "init_rwkv_state"]


def rwkv_time_mix_init(generator: torch.Generator, d_model: int, head_dim: int, decay_lora: int,
                       dtype: torch.dtype):
    """wr, wk, wv, wg, wo, w_lora_a, w_lora_b drawn in that order."""
    dev = generator.device
    n_heads = d_model // head_dim
    draws = {name: dense_param(generator, (d_model, d_model), axes, dtype)
             for name, axes in (("wr", ("fsdp", "tp")), ("wk", ("fsdp", "tp")), ("wv", ("fsdp", "tp")),
                                ("wg", ("fsdp", "tp")), ("wo", ("tp", "fsdp")))}
    draws["w_lora_a"] = dense_param(generator, (d_model, decay_lora), ("fsdp", None), dtype)
    draws["w_lora_b"] = dense_param(generator, (decay_lora, d_model), (None, "tp"), dtype)
    return split_tree({
        **draws,
        "mu": scale_param((5, d_model), (None, None), torch.float32, 0.5, device=dev),  # r/k/v/g/w shifts
        "w0": zeros_param((d_model,), (None,), torch.float32, device=dev),
        "bonus_u": zeros_param((n_heads, head_dim), ("tp", None), torch.float32, device=dev),
        "ln_scale": scale_param((d_model,), (None,), torch.float32, 1.0, device=dev),
    })


def rwkv_channel_mix_init(generator: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype):
    """wk, wv, wr drawn in that order."""
    draws = {
        "wk": dense_param(generator, (d_model, d_ff), ("fsdp", "tp"), dtype),
        "wv": dense_param(generator, (d_ff, d_model), ("tp", "fsdp"), dtype),
        "wr": dense_param(generator, (d_model, d_model), ("fsdp", "tp"), dtype),
    }
    return split_tree({**draws, "mu": scale_param((2, d_model), (None, None), torch.float32, 0.5,
                                                  device=generator.device)})


@dataclasses.dataclass(frozen=True)
class RWKVState:
    x_prev: torch.Tensor  # (B, d_model) the last token's input to the time mix (its token shift)
    wkv: torch.Tensor  # (B, H, head_dim, head_dim) float32 WKV state
    ffn_x_prev: torch.Tensor  # (B, d_model) the channel mix's token shift


def init_rwkv_state(batch: int, d_model: int, head_dim: int, dtype: torch.dtype,
                    device: torch.device | str | None = None) -> RWKVState:
    n_heads = d_model // head_dim
    return RWKVState(x_prev=torch.zeros((batch, d_model), dtype=dtype, device=device),
                     wkv=torch.zeros((batch, n_heads, head_dim, head_dim), dtype=torch.float32, device=device),
                     ffn_x_prev=torch.zeros((batch, d_model), dtype=dtype, device=device))


def _token_shift(x: torch.Tensor, x_prev_first: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, S, D) -> the previous token's x: at t=0 zeros, or
    ``x_prev_first`` (B, D) carried from the last step."""
    if x_prev_first is None:
        return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([x_prev_first[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, x_shift: torch.Tensor, mu_row: torch.Tensor) -> torch.Tensor:
    """lerp(x, x_shift, mu): the delta in float32, scaled, cast back."""
    delta = (x_shift - x).to(torch.float32)
    return x + pscale(delta, mu_row).to(x.dtype)


def _projections(params, x: torch.Tensor, x_shift: torch.Tensor, head_dim: int):
    mu = params["mu"]
    r = pmm("bsd,de->bse", _mix(x, x_shift, mu[0]), params["wr"], w_spec=("fsdp", "tp"))
    k = pmm("bsd,de->bse", _mix(x, x_shift, mu[1]), params["wk"], w_spec=("fsdp", "tp"))
    v = pmm("bsd,de->bse", _mix(x, x_shift, mu[2]), params["wv"], w_spec=("fsdp", "tp"))
    g = pmm("bsd,de->bse", _mix(x, x_shift, mu[3]), params["wg"], w_spec=("fsdp", "tp"))
    lora_h = torch.tanh(pmm("bsd,dr->bsr", _mix(x, x_shift, mu[4]), params["w_lora_a"], w_spec=("fsdp", None)))
    lora = pmm("bsr,re->bse", lora_h, params["w_lora_b"], w_spec=(None, "tp")).to(torch.float32)
    w = torch.exp(-torch.exp(pbias(lora, params["w0"])))  # (B, S, D) in (0, 1), this rank's columns where cut
    b, s, d = r.shape  # d: this rank's columns

    if d % head_dim:
        raise ValueError(f"{d} columns a rank do not hold whole heads of {head_dim}")

    def heads(t):
        return t.reshape(b, s, d // head_dim, head_dim)

    return heads(r), heads(k), heads(v), g, heads(w)


def _group_norm(y: torch.Tensor, scale: torch.Tensor, eps: float = 64e-5) -> torch.Tensor:
    """Per-head LayerNorm of the readout (RWKV's group norm), the variance
    the population's, as ``jnp.var``: y (B, S, H, hd) -> (B, S, H*hd)."""
    yf = y.to(torch.float32)
    mean = torch.mean(yf, dim=-1, keepdim=True)
    var = torch.var(yf, dim=-1, keepdim=True, correction=0)
    normed = (yf - mean) * torch.rsqrt(var + eps)
    b, s, h, hd = y.shape
    return pscale(normed.reshape(b, s, h * hd), scale)


def rwkv_time_mix(params, x: torch.Tensor, head_dim: int, state: RWKVState | None = None,
                  return_state: bool = False):
    """RWKV-6 time mix. x: (B, S, D) -> (B, S, D), from zeros or from
    ``state``'s ``x_prev`` and ``wkv``; with ``return_state``, ``(out, the
    final WKV state, x[:, -1])``."""
    b, s, _ = x.shape
    r, k, v, g, w = _projections(params, x, _token_shift(x, None if state is None else state.x_prev), head_dim)
    s_u = torch.sum(pscale((r * k).to(torch.float32), params["bonus_u"]), dim=-1)  # (B, S, H)
    rf, kf, vf = (t.to(torch.float32) for t in (r, k, v))
    wkv = x.new_zeros((b, r.shape[2], head_dim, head_dim), dtype=torch.float32) if state is None else state.wkv
    ys = []
    for t in range(s):
        y = torch.einsum("bhi,bhij->bhj", rf[:, t], wkv) + s_u[:, t, :, None] * vf[:, t]
        wkv = w[:, t, :, :, None] * wkv + kf[:, t, :, :, None] * vf[:, t, :, None, :]
        ys.append(y)
    y = _group_norm(torch.stack(ys, dim=1), params["ln_scale"]).to(x.dtype)
    y = y * torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype)
    out = pmm("bsd,de->bse", y, params["wo"], w_spec=("tp", "fsdp")).to(x.dtype)
    return (out, wkv, x[:, -1, :]) if return_state else out


def rwkv_channel_mix(params, x: torch.Tensor, state_prev: torch.Tensor | None = None, return_state: bool = False):
    """RWKV's squared-ReLU FFN with token shift. x: (B, S, D) -> (B, S, D),
    the shift starting from ``state_prev`` (B, D) where given; with
    ``return_state``, ``(out, x[:, -1])``."""
    mu = params["mu"]
    x_shift = _token_shift(x, state_prev)
    k = pmm("bsd,df->bsf", _mix(x, x_shift, mu[0]), params["wk"], w_spec=("fsdp", "tp"))
    k = torch.square(torch.relu(k.to(torch.float32))).to(x.dtype)
    r_in = pmm("bsd,de->bse", _mix(x, x_shift, mu[1]), params["wr"], w_spec=("fsdp", "tp"))
    r = torch.sigmoid(r_in.to(torch.float32)).to(x.dtype)
    if tp_dim_of(params["wr"]) == 1:  # wr's columns cut over the model ranks
        r = model_join(r, -1)
    out = r * pmm("bsf,fd->bsd", k, params["wv"], w_spec=("tp", "fsdp"))
    return (out, x[:, -1, :]) if return_state else out
