"""GQA attention: over a full sequence (training and prefill), and one
token against a cache (decode).

The logits, the mask and the softmax are written out in plain ops, in
float32, as the reference's ``_plain_attention`` does, rather than through
``scaled_dot_product_attention``, whose choice of backend would change the
rounding from call to call. Past ``PLAIN_THRESHOLD`` tokens the sequence
takes the reference's chunked online softmax (``_flash_attention``): a
Python loop over query chunks of ``Q_CHUNK`` and, inside it, over key
chunks of ``KV_CHUNK``, so no ``(B, H, S, S)`` logits tensor is ever held;
its backward is written by hand (a ``torch.autograd.Function``) and
recomputes each chunk's probabilities from the saved log-sum-exp. The
projections go through ``core.protomath.pmm`` (the LAD exchange under a
protocol context), the decode step's stay plain, as in the reference. Sliding
windows are masks over a full sequence and a ring buffer in decode, whose
cache holds ``capacity`` slots.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.protomath import pmm
from repro_torch.models.layers import apply_rope
from repro_torch.models.module import dense_param, split_tree

__all__ = ["PLAIN_THRESHOLD", "Q_CHUNK", "KV_CHUNK", "NEG_INF", "attention_init", "multihead_attention", "KVCache",
           "init_cache", "decode_attention"]

PLAIN_THRESHOLD = 2048
Q_CHUNK = 512
KV_CHUNK = 1024
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


def _chunk_q(x: torch.Tensor, nq: int, q_chunk: int) -> torch.Tensor:
    """(B, Sq, ...) -> (nq, B, q_chunk, ...), a view."""
    return x.reshape((x.shape[0], nq, q_chunk) + x.shape[2:]).transpose(0, 1)


def _flash_forward_pass(qs, qps, ks, vs, kps, causal: bool, window: int | None, scale: float):
    """Returns (out (nq, B, qc, Hkv, G, D), lse (nq, B, Hkv, G, qc)).

    Every (query chunk, key chunk) pair is computed, masked ones too, as
    the reference's ``lax.map`` over ``lax.scan`` does: float32 running max
    ``m``, sum ``l`` and accumulator, the probabilities cast to the query's
    dtype before the product with V."""
    nq, b, q_chunk, hkv, g, d = qs.shape
    outs, lses = [], []
    for i in range(nq):
        qb, qp = qs[i], qps[i]
        m = qb.new_full((b, hkv, g, q_chunk), NEG_INF, dtype=torch.float32)
        l = qb.new_zeros((b, hkv, g, q_chunk), dtype=torch.float32)
        acc = qb.new_zeros((b, hkv, g, q_chunk, d), dtype=torch.float32)
        for j in range(ks.shape[0]):
            kb, vb, kp = ks[j], vs[j], kps[j]
            logits = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb).to(torch.float32) * scale
            logits = logits + _mask(qp, kp, causal, window)[:, None, None]
            m_new = torch.maximum(m, torch.amax(logits, dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p.to(qb.dtype), vb).to(torch.float32)
            m = m_new
        out = (acc / torch.clamp(l[..., None], min=1e-30)).to(qb.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))  # (B, Hkv, G, qc)
    return torch.stack(outs), torch.stack(lses)


def _chunks(sq: int, sk: int, q_chunk: int, kv_chunk: int) -> tuple[int, int, int, int]:
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, sk)
    if sq % q_chunk or sk % kv_chunk:
        raise ValueError(f"lengths ({sq}, {sk}) are not multiples of the chunks ({q_chunk}, {kv_chunk})")
    return q_chunk, kv_chunk, sq // q_chunk, sk // kv_chunk


def _flash_fwd_res(q, k, v, qpos, kpos, causal, window, q_chunk, kv_chunk):
    """(out (B, Sq, Hkv, G, D), lse (nq, B, Hkv, G, qc))."""
    b, sq, hkv, g, d = q.shape
    q_chunk, kv_chunk, nq, nk = _chunks(sq, k.shape[1], q_chunk, kv_chunk)
    outs, lse = _flash_forward_pass(_chunk_q(q, nq, q_chunk), _chunk_q(qpos, nq, q_chunk), _chunk_q(k, nk, kv_chunk),
                                    _chunk_q(v, nk, kv_chunk), _chunk_q(kpos, nk, kv_chunk), causal, window, d**-0.5)
    return outs.transpose(0, 1).reshape(b, sq, hkv, g, d), lse


def _flash_bwd(causal, window, q_chunk, kv_chunk, res, dout):
    """The reference's hand-written VJP, in two passes that recompute each
    chunk's probabilities from ``lse``: ``dq`` over the query chunks (each
    an inner loop over the key chunks), then ``dk``/``dv`` over the key
    chunks (each an inner loop over the query chunks)."""
    q, k, v, qpos, kpos, out, lse = res
    b, sq, hkv, g, d = q.shape
    sk = k.shape[1]
    q_chunk, kv_chunk, nq, nk = _chunks(sq, sk, q_chunk, kv_chunk)
    scale = d**-0.5
    delta = torch.sum(dout.to(torch.float32) * out.to(torch.float32), dim=-1)  # (B, Sq, Hkv, G)
    qs, qps, dos, deltas = (_chunk_q(t, nq, q_chunk) for t in (q, qpos, dout, delta))
    ks, vs, kps = (_chunk_q(t, nk, kv_chunk) for t in (k, v, kpos))

    def probs(qb, qp, kb, kp, lse_b):
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb).to(torch.float32) * scale
        logits = logits + _mask(qp, kp, causal, window)[:, None, None]
        return torch.exp(logits - lse_b[..., None])  # (B, Hkv, G, qc, kc)

    do_ts = [dos[i].permute(0, 2, 3, 1, 4).to(torch.float32) for i in range(nq)]  # (B, Hkv, G, qc, D)
    dls = [deltas[i].permute(0, 2, 3, 1)[..., None] for i in range(nq)]  # (B, Hkv, G, qc, 1)

    dqs = []
    for i in range(nq):
        qb = qs[i]
        dq_acc = torch.zeros(qb.shape, dtype=torch.float32, device=qb.device)
        for j in range(nk):
            p = probs(qb, qps[i], ks[j], kps[j], lse[i])
            dp = torch.einsum("bhgqd,bkhd->bhgqk", do_ts[i], vs[j].to(torch.float32))
            ds = p * (dp - dls[i])
            dq_acc = dq_acc + scale * torch.einsum("bhgqk,bkhd->bqhgd", ds.to(qb.dtype), ks[j]).to(torch.float32)
        dqs.append(dq_acc.to(qb.dtype))
    dq = torch.stack(dqs).transpose(0, 1).reshape(b, sq, hkv, g, d)

    dks, dvs = [], []
    for j in range(nk):
        kb, vb = ks[j], vs[j]
        dk_acc = torch.zeros(kb.shape, dtype=torch.float32, device=kb.device)
        dv_acc = torch.zeros(kb.shape, dtype=torch.float32, device=kb.device)
        for i in range(nq):
            p = probs(qs[i], qps[i], kb, kps[j], lse[i])
            dv_acc = dv_acc + torch.einsum("bhgqk,bhgqd->bkhd", p, do_ts[i])
            dp = torch.einsum("bhgqd,bkhd->bhgqk", do_ts[i], vb.to(torch.float32))
            ds = p * (dp - dls[i])
            dk_acc = dk_acc + scale * torch.einsum("bhgqk,bqhgd->bkhd", ds, qs[i].to(torch.float32))
        dks.append(dk_acc.to(kb.dtype))
        dvs.append(dv_acc.to(vb.dtype))
    dk = torch.stack(dks).transpose(0, 1).reshape(b, sk, hkv, d)
    dv = torch.stack(dvs).transpose(0, 1).reshape(b, sk, hkv, d)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The chunked attention with the reference's ``custom_vjp``: autograd
    through the loops would keep every chunk's float32 accumulator alive,
    so the backward is ``_flash_bwd``. The positions get no gradient (the
    reference's ``float0`` cotangents). ``torch.func`` transforms it
    (``generate_vmap_rule``), so the vmapped subset gradients of training
    take it too."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, qpos, kpos, causal, window, q_chunk, kv_chunk):
        return _flash_fwd_res(q, k, v, qpos, kpos, causal, window, q_chunk, kv_chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, qpos, kpos, causal, window, q_chunk, kv_chunk = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, qpos, kpos, out, lse)
        ctx.static = (causal, window, q_chunk, kv_chunk)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        dq, dk, dv = _flash_bwd(*ctx.static, ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None, None, None


def _flash_attention(q, k, v, qpos, kpos, causal: bool, window: int | None, q_chunk: int = Q_CHUNK,
                     kv_chunk: int = KV_CHUNK) -> torch.Tensor:
    """Online-softmax attention chunked over q and kv: q (B,Sq,Hkv,G,D),
    k, v (B,Sk,Hkv,D), each length a multiple of its chunk (or shorter
    than it) -> (B,Sq,Hkv,G,D)."""
    return _FlashAttention.apply(q, k, v, qpos, kpos, causal, window, q_chunk, kv_chunk)[0]


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
    q = pmm("bsd,dhk->bshk", x, params["wq"], w_spec=("fsdp", "tp", None))
    kv_src = x if kv_override is None else kv_override
    k = pmm("bsd,dhk->bshk", kv_src, params["wk"], w_spec=("fsdp", "tp", None))
    v = pmm("bsd,dhk->bshk", kv_src, params["wv"], w_spec=("fsdp", "tp", None))
    kpos = positions if kv_positions is None else kv_positions
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, kpos, rope_theta)
    b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    qg = q.reshape(b, sq, n_kv_heads, g, q.shape[-1])
    if max(sq, sk) <= PLAIN_THRESHOLD:
        out = _plain_attention(qg, k, v, positions, kpos, causal, window)
    else:
        # lengths padded up to the chunks: padded keys carry kpos = -1
        # (always masked), padded query rows are sliced off
        pq, pk = (-sq) % min(Q_CHUNK, sq), (-sk) % min(KV_CHUNK, sk)
        pad = torch.nn.functional.pad
        out = _flash_attention(pad(qg, (0, 0, 0, 0, 0, 0, 0, pq)), pad(k, (0, 0, 0, 0, 0, pk)),
                               pad(v, (0, 0, 0, 0, 0, pk)), pad(positions, (0, pq)), pad(kpos, (0, pk), value=-1),
                               causal, window)[:, :sq]
    out = out.reshape(b, sq, n_heads, q.shape[-1])
    return pmm("bshk,hkd->bsd", out, params["wo"], w_spec=("tp", None, "fsdp")), k, v


@dataclasses.dataclass(frozen=True)
class KVCache:
    """Ring-buffer KV cache: ``k``/``v`` (B, C, Hkv, D); ``length``, a 0-d
    int32 tensor, the tokens already decoded (the absolute position of the
    next one). ``capacity`` is C."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[-3]


def init_cache(batch: int, capacity: int, n_kv_heads: int, head_dim: int, dtype: torch.dtype,
               device: torch.device | str | None = None) -> KVCache:
    shape = (batch, capacity, n_kv_heads, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device), v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))


def decode_attention(params, x: torch.Tensor, cache: KVCache, *, n_heads: int, n_kv_heads: int,
                     rope_theta: float | None, window: int | None = None, cross: bool = False):
    """One-token attention against a cache. x: (B, 1, Dm) -> (output (B, 1,
    Dm), the cache after this token).

    Self-attention writes the new token's K/V **in place** into the
    caller's ``cache.k``/``cache.v`` at slot ``length % capacity`` (an
    ``index_copy_`` at a device index: no host read, so the step captures
    as a CUDA graph) and returns a cache holding those same buffers and
    ``length + 1``. The caller owns the buffers, as a donated buffer is the
    callee's in the reference's functional ``dynamic_update_slice``: the
    ``cache`` passed in is not kept. Each slot's absolute position is the
    largest ``p <= length`` with ``p % capacity == slot``; slots never
    written come out negative and are masked, as is what lies outside
    ``window``. Cross-attention reads its fixed encoder K/V and writes
    nothing."""
    b = x.shape[0]
    g = n_heads // n_kv_heads
    pos = cache.length
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if rope_theta is not None:
        q = apply_rope(q, pos.expand(b, 1), rope_theta)
    if cross:
        new_cache, valid = cache, None
    else:
        k_new = torch.einsum("bsd,dhk->bshk", x, params["wk"])
        v_new = torch.einsum("bsd,dhk->bshk", x, params["wv"])
        if rope_theta is not None:
            k_new = apply_rope(k_new, pos.expand(b, 1), rope_theta)
        cap = cache.capacity
        slot = torch.remainder(pos, cap).reshape(1).long()
        cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
        cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))
        kpos = pos - torch.remainder(pos - torch.arange(cap, dtype=torch.int32, device=x.device), cap)
        valid = kpos >= 0
        if window is not None:
            valid = valid & ((pos - kpos) < window)
        new_cache = KVCache(k=cache.k, v=cache.v, length=pos + 1)
    scale = q.shape[-1] ** -0.5
    qg = q.reshape(b, 1, n_kv_heads, g, q.shape[-1])
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, cache.k).to(torch.float32) * scale
    if valid is not None:
        logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, cache.v).reshape(b, 1, n_heads, q.shape[-1])
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), new_cache
