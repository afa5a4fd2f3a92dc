"""Mixture-of-Experts MLP with top-k routing and per-expert capacity.

Every token routes to its ``top_k`` experts by the router's softmax; each
expert takes at most ``C`` tokens (``expert_capacity``), the ones of
largest gate weight, and drops the rest (Switch-style). The router's
load-balance aux loss is ``E * sum_e f_e p_e``. Without a protocol context
the reference routes the batch as one block, as here.

Both picks are a stable descending sort, so equal values keep the lower
index first, as ``lax.top_k`` breaks ties; the capacity pick runs over
gate weights that are mostly exact zeros, so it ties in every call. Every
gather and scatter is a one-hot product: the dispatch of tokens to their
expert slots, the gate values at the chosen experts, the slots' weights and
the combine of the slots back into tokens. Forward, each equals the
gather or scatter exactly (one ``1.0 * v`` product and exact zeros, or the
same few products summed); backward, each is a matrix product, where an
indexed scatter-add's atomics on CUDA would add in an order that changes
from run to run.

Under a protocol context the batch routes per local LAD device block, as
the reference dispatches: each block's tokens route into its own ``(E, C,
D)`` slots, an expert's capacity counted from the block's ``t = (B/N) S``
tokens, and the router and expert products go through ``protomath.pmm``
with the device axis as their leading index (``pre_blocked``), so each
block's expert-weight cotangent stays its own for the exchange.

Where the protocol context cuts the experts over the model ranks (expert
parallelism), routing, top-k and capacity stay replicated: every model
rank sees the same ``x``, so the ranks pick alike. Each rank runs its own
experts' slots of the replicated dispatch buffer through gate, up and down
(``protomath.model_split``: its dx gathered back in the backward), and the
experts' outputs are gathered whole over the model ranks in one collective
(``protomath.model_join``) before the combine back into tokens.

Serving (``protomath.model_context``) routes as one block, as the
reference's decode does; where the data ranks cut the batch, their rows
are gathered whole first (``protomath.data_join``) and each keeps its own
rows of the output, so capacity counts every token of the batch.
"""
from __future__ import annotations

import torch

from repro_torch.core.protomath import current_protocol, data_join, data_part, model_join, model_split, pmm, tp_dim_of
from repro_torch.models.module import dense_param, split_tree

__all__ = ["moe_init", "expert_capacity", "moe"]


def moe_init(generator: torch.Generator, d_model: int, d_ff: int, n_experts: int, dtype: torch.dtype):
    """router (fp32), w_gate, w_up, w_down, drawn in that order."""
    return split_tree({
        "router": dense_param(generator, (d_model, n_experts), ("fsdp", None), torch.float32),
        "w_gate": dense_param(generator, (n_experts, d_model, d_ff), ("tp", "fsdp", None), dtype),
        "w_up": dense_param(generator, (n_experts, d_model, d_ff), ("tp", "fsdp", None), dtype),
        "w_down": dense_param(generator, (n_experts, d_ff, d_model), ("tp", None, "fsdp"), dtype),
    })


def expert_capacity(n_tokens: int, n_experts: int, top_k: int, factor: float = 1.25) -> int:
    """Tokens an expert takes: ``n_tokens * top_k / n_experts * factor``
    truncated, rounded up to a multiple of 8 (at least 8), at most
    ``n_tokens``."""
    c = int(n_tokens * top_k / n_experts * factor)
    c = max(8, -(-c // 8) * 8)
    return min(c, n_tokens)


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``(..., n)`` one-hot rows of ``idx`` as a comparison (``F.one_hot``
    reads its input's maximum back, which ``torch.func.vmap`` refuses)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top(values: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest entries of the last axis, ties to
    the lower index (a stable descending sort)."""
    return torch.sort(values.detach(), dim=-1, descending=True, stable=True).indices[..., :k]


def _combine_weights(probs: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """The combine weights ``(n, T, E)`` of the chosen experts ``(n, T, k,
    E)``: their probabilities renormalised over the token's ``k``, zero at
    the other experts."""
    gate_vals = torch.sum(chosen * probs[:, :, None, :], dim=-1)  # probs at the chosen experts, exactly
    gate_vals = gate_vals / torch.clamp(torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    return torch.sum(chosen * gate_vals[..., None], dim=2)


def _route(params, xb: torch.Tensor, top_k: int, capacity_factor: float):
    """The routing of the ``(n, T, D)`` tokens ``xb``, ``n`` device blocks
    of ``T``: the router's probabilities ``(n, T, E)``, each token's chosen
    experts one-hot ``(n, T, k, E)``, the combine weights ``(n, T, E)`` (the
    renormalised gate values at the chosen experts, zero elsewhere) and
    every expert's ``C`` token indices ``(n, E, C)``."""
    n_experts = params["router"].shape[1]
    logits = pmm("ntd,de->nte", xb.to(torch.float32), params["router"], w_spec=("fsdp", None), pre_blocked=True)
    probs = torch.softmax(logits, dim=-1)
    chosen = _one_hot(_top(probs, top_k), n_experts, torch.float32)  # (n, T, k, E)
    combine = _combine_weights(probs, chosen)
    cap = expert_capacity(xb.shape[1], n_experts, top_k, capacity_factor)
    token_idx = _top(combine.transpose(1, 2), cap)  # per expert its top-C tokens by gate weight
    return probs, chosen, combine, token_idx


def _n_blocks() -> int:
    ctx = current_protocol()
    return 1 if ctx is None or ctx.p is None else ctx.p.n_devices // ctx.world


def moe(params, x: torch.Tensor, *, top_k: int, aux_coef: float = 0.01, capacity_factor: float = 1.25):
    """x: (B, S, D) -> (out (B, S, D), aux loss (fp32 scalar))."""
    x = data_join(x)  # serving over data ranks that cut the batch: the whole batch routes as one block
    b, s, d = x.shape
    n_experts = params["router"].shape[1]
    nb = _n_blocks()
    if b % nb != 0:
        raise ValueError(f"batch {b} does not split into {nb} device blocks")
    t = (b // nb) * s  # tokens a block
    xb = x.reshape(nb, t, d)
    probs, chosen, combine, token_idx = _route(params, xb, top_k, capacity_factor)
    slot = _one_hot(token_idx, t, torch.float32)  # (n, E, C, T)
    weights_ec = torch.sum(slot * combine.transpose(1, 2)[:, :, None, :], dim=-1)  # combine at token_idx, exactly

    x_ec = torch.einsum("nect,ntd->necd", slot.to(x.dtype), xb)  # dispatch
    experts_cut = tp_dim_of(params["w_gate"]) == 0
    if experts_cut:  # this model rank's experts
        x_ec = model_split(x_ec, 1)
    gate = pmm("necd,edf->necf", x_ec, params["w_gate"], w_spec=("tp", "fsdp", None), pre_blocked=True)
    up = pmm("necd,edf->necf", x_ec, params["w_up"], w_spec=("tp", "fsdp", None), pre_blocked=True)
    act = torch.nn.functional.silu(gate.to(torch.float32)).to(x.dtype) * up
    y_ec = pmm("necf,efd->necd", act, params["w_down"], w_spec=("tp", None, "fsdp"), pre_blocked=True)
    if experts_cut:  # every expert's outputs, on every model rank
        y_ec = model_join(y_ec, 1)

    contrib = (y_ec * weights_ec[..., None].to(y_ec.dtype)).to(torch.float32)
    y = torch.einsum("nect,necd->ntd", slot, contrib)  # combine

    # load-balance aux loss
    token_frac = torch.mean(torch.sum(chosen, dim=2), dim=1)  # (n, E)
    prob_frac = torch.mean(probs, dim=1)  # (n, E)
    aux = aux_coef * n_experts * torch.mean(torch.sum(token_frac * prob_frac, dim=-1))
    return data_part(y.to(x.dtype).reshape(b, s, d)), aux
