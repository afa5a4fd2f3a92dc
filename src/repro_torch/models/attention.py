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
protocol context, the model axis alone under a serving one). Sliding
windows are masks over a full sequence and a ring buffer in decode, whose
cache holds ``capacity`` slots.

Over the model ranks (a protocol context that cuts the weights) a rank
runs its heads; where the kv heads do not split, its q heads alone, which
read their kv heads out of the whole k and v; or, under
``attn_tp="head_dim"``, its cut of every head's ``head_dim``, the logits'
partial sums summed over the ranks in fp32 before the mask and the
softmax (in the chunked path's forward and backward too).

On a serving rank (``protomath.model_context``) a decode step's cache may
be cut on its slots (``SeqCut``: over ``model`` where the kv heads do not
split, over the data ranks at batch 1): the flash-decode cut. Each rank
takes the logits of its slots; the max and the sum of ``exp`` are
all-reduced in fp32, the probabilities normalised locally and cast to the
activations' dtype, and their product with this rank's V all-reduced in
fp32 (the last all-reduce's dtype), then cast to the activations' dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core import protomath
from repro_torch.core.protomath import pmm
from repro_torch.models.layers import apply_rope
from repro_torch.models.module import dense_param, split_tree

__all__ = ["PLAIN_THRESHOLD", "Q_CHUNK", "KV_CHUNK", "NEG_INF", "attention_init", "multihead_attention", "KVCache",
           "init_cache", "SeqCut", "decode_attention"]

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


def _plain_attention(q, k, v, qpos, kpos, causal: bool, window: int | None, head_dim: int | None = None,
                     logits_sum=None) -> torch.Tensor:
    """q: (B,Sq,Hkv,G,D); k,v: (B,Sk,Hkv,D) -> (B,Sq,Hkv,G,D). ``head_dim``:
    the whole model's, where D is a cut of it, whose partial logits
    ``logits_sum`` sums over the model ranks."""
    scale = (head_dim or q.shape[-1]) ** -0.5
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q, k).to(torch.float32)
    if logits_sum is not None:
        logits = logits_sum(logits)
    logits = logits * scale
    logits = logits + _mask(qpos, kpos, causal, window)[:, None, None]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def _chunk_q(x: torch.Tensor, nq: int, q_chunk: int) -> torch.Tensor:
    """(B, Sq, ...) -> (nq, B, q_chunk, ...), a view."""
    return x.reshape((x.shape[0], nq, q_chunk) + x.shape[2:]).transpose(0, 1)


def _logits(qb, kb, scale: float, reduce):
    """A chunk's fp32 logits, the partial sums of a cut ``head_dim`` summed
    by ``reduce`` over the model ranks first."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb).to(torch.float32)
    return (logits if reduce is None else reduce(logits)) * scale


def _flash_forward_pass(qs, qps, ks, vs, kps, causal: bool, window: int | None, scale: float, reduce=None):
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
            logits = _logits(qb, kb, scale, reduce) + _mask(qp, kp, causal, window)[:, None, None]
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


def _flash_fwd_res(q, k, v, qpos, kpos, causal, window, q_chunk, kv_chunk, head_dim=None, reduce=None):
    """(out (B, Sq, Hkv, G, D), lse (nq, B, Hkv, G, qc))."""
    b, sq, hkv, g, d = q.shape
    q_chunk, kv_chunk, nq, nk = _chunks(sq, k.shape[1], q_chunk, kv_chunk)
    outs, lse = _flash_forward_pass(_chunk_q(q, nq, q_chunk), _chunk_q(qpos, nq, q_chunk), _chunk_q(k, nk, kv_chunk),
                                    _chunk_q(v, nk, kv_chunk), _chunk_q(kpos, nk, kv_chunk), causal, window,
                                    (head_dim or d)**-0.5, reduce)
    return outs.transpose(0, 1).reshape(b, sq, hkv, g, d), lse


def _flash_bwd(causal, window, q_chunk, kv_chunk, head_dim, reduce, res, dout):
    """The reference's hand-written VJP, in two passes that recompute each
    chunk's probabilities from ``lse``: ``dq`` over the query chunks (each
    an inner loop over the key chunks), then ``dk``/``dv`` over the key
    chunks (each an inner loop over the query chunks). Under a cut
    ``head_dim`` every sum over it (the logits, ``dout · v`` and ``dout ·
    out``) is a partial sum, and ``reduce`` sums it over the model ranks."""
    q, k, v, qpos, kpos, out, lse = res
    b, sq, hkv, g, d = q.shape
    sk = k.shape[1]
    q_chunk, kv_chunk, nq, nk = _chunks(sq, sk, q_chunk, kv_chunk)
    scale = (head_dim or d)**-0.5
    summed = (lambda t: t) if reduce is None else reduce
    delta = summed(torch.sum(dout.to(torch.float32) * out.to(torch.float32), dim=-1))  # (B, Sq, Hkv, G)
    qs, qps, dos, deltas = (_chunk_q(t, nq, q_chunk) for t in (q, qpos, dout, delta))
    ks, vs, kps = (_chunk_q(t, nk, kv_chunk) for t in (k, v, kpos))

    def probs(qb, qp, kb, kp, lse_b):
        logits = _logits(qb, kb, scale, reduce) + _mask(qp, kp, causal, window)[:, None, None]
        return torch.exp(logits - lse_b[..., None])  # (B, Hkv, G, qc, kc)

    do_ts = [dos[i].permute(0, 2, 3, 1, 4).to(torch.float32) for i in range(nq)]  # (B, Hkv, G, qc, D)
    dls = [deltas[i].permute(0, 2, 3, 1)[..., None] for i in range(nq)]  # (B, Hkv, G, qc, 1)

    dqs = []
    for i in range(nq):
        qb = qs[i]
        dq_acc = torch.zeros(qb.shape, dtype=torch.float32, device=qb.device)
        for j in range(nk):
            p = probs(qb, qps[i], ks[j], kps[j], lse[i])
            dp = summed(torch.einsum("bhgqd,bkhd->bhgqk", do_ts[i], vs[j].to(torch.float32)))
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
            dp = summed(torch.einsum("bhgqd,bkhd->bhgqk", do_ts[i], vb.to(torch.float32)))
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
    def forward(q, k, v, qpos, kpos, causal, window, q_chunk, kv_chunk, head_dim, reduce):
        return _flash_fwd_res(q, k, v, qpos, kpos, causal, window, q_chunk, kv_chunk, head_dim, reduce)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, qpos, kpos, causal, window, q_chunk, kv_chunk, head_dim, reduce = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, qpos, kpos, out, lse)
        ctx.static = (causal, window, q_chunk, kv_chunk, head_dim, reduce)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        dq, dk, dv = _flash_bwd(*ctx.static, ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def _flash_attention(q, k, v, qpos, kpos, causal: bool, window: int | None, q_chunk: int = Q_CHUNK,
                     kv_chunk: int = KV_CHUNK, head_dim: int | None = None, reduce=None) -> torch.Tensor:
    """Online-softmax attention chunked over q and kv: q (B,Sq,Hkv,G,D),
    k, v (B,Sk,Hkv,D), each length a multiple of its chunk (or shorter
    than it) -> (B,Sq,Hkv,G,D). ``head_dim`` and ``reduce``: a cut
    ``head_dim``'s whole size and the sum of its partial sums over the
    model ranks (``_flash_bwd``)."""
    return _FlashAttention.apply(q, k, v, qpos, kpos, causal, window, q_chunk, kv_chunk, head_dim, reduce)[0]


def _kv_heads_of(k: torch.Tensor, v: torch.Tensor, heads: int, n_heads: int, n_kv_heads: int):
    """(k, v, group) for this rank's ``heads`` of the ``n_heads`` q heads,
    the model ranks cutting the q heads alone (``n_kv_heads`` does not
    split over them): the kv heads its q heads read, out of the whole k
    and v, whose cotangents are then summed over the model ranks (each
    rank's covers its q heads only)."""
    rank = protomath.current_protocol().model_rank
    g, first = n_heads // n_kv_heads, rank * heads
    if heads % g and g % heads:
        raise ValueError(f"{heads} q heads a rank straddle the kv heads' groups of {g}")
    count = max(heads // g, 1)
    k, v = (protomath.model_grad_sum(t).narrow(2, first // g, count) for t in (k, v))
    return k, v, heads // count


def _rope_cut(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE on this rank's cut of ``head_dim``: it pairs the first half with
    the second, which a cut puts on other ranks, so it runs on the gathered
    ``head_dim`` and this rank's cut is taken back."""
    whole = apply_rope(protomath.model_join(x, -1, partial=True), positions, theta)
    rank = protomath.current_protocol().model_rank
    return whole.narrow(-1, rank * x.shape[-1], x.shape[-1])


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

    Returns (output (B,S,Dm), k, v). Under a protocol context that cuts
    the weights over the model ranks, ``q``, ``k`` and ``v`` hold this
    rank's cut: its heads (its q heads group onto its kv heads as the whole
    model's do, or, where the kv heads are whole, onto the ones they read),
    or its cut of ``head_dim`` (``attn_tp="head_dim"``: the logits' partial
    sums are summed over the model ranks in fp32 before the mask and the
    softmax, and RoPE runs on the gathered ``head_dim``)."""
    q = pmm("bsd,dhk->bshk", x, params["wq"], w_spec=("fsdp", "tp", None))
    kv_src = x if kv_override is None else kv_override
    k = pmm("bsd,dhk->bshk", kv_src, params["wk"], w_spec=("fsdp", "tp", None))
    v = pmm("bsd,dhk->bshk", kv_src, params["wv"], w_spec=("fsdp", "tp", None))
    kpos = positions if kv_positions is None else kv_positions
    dim_cut = protomath.tp_dim_of(params["wq"]) == 2  # attn_tp="head_dim" over the model ranks
    head_dim = logits_sum = None
    if dim_cut:
        head_dim = q.shape[-1] * protomath.current_protocol().model_world
        logits_sum = protomath.model_sum_fn()
    if rope_theta is not None:
        rope = _rope_cut if dim_cut else apply_rope
        q = rope(q, positions, rope_theta)
        k = rope(k, kpos, rope_theta)
    b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    heads, kv_heads = q.shape[2], k.shape[2]  # this rank's, where the heads are cut over the model ranks
    k_read, v_read = k, v
    if heads * n_kv_heads == kv_heads * n_heads:
        group = heads // kv_heads
    else:  # the q heads cut, the kv heads whole: the ones they read (k and v are returned whole, for a cache)
        k_read, v_read, group = _kv_heads_of(k, v, heads, n_heads, n_kv_heads)
    qg = q.reshape(b, sq, heads // group, group, q.shape[-1])
    if max(sq, sk) <= PLAIN_THRESHOLD:
        out = _plain_attention(qg, k_read, v_read, positions, kpos, causal, window, head_dim,
                               protomath.model_logits_sum if dim_cut else None)
    else:
        # lengths padded up to the chunks: padded keys carry kpos = -1
        # (always masked), padded query rows are sliced off
        pq, pk = (-sq) % min(Q_CHUNK, sq), (-sk) % min(KV_CHUNK, sk)
        pad = torch.nn.functional.pad
        out = _flash_attention(pad(qg, (0, 0, 0, 0, 0, 0, 0, pq)), pad(k_read, (0, 0, 0, 0, 0, pk)),
                               pad(v_read, (0, 0, 0, 0, 0, pk)), pad(positions, (0, pq)), pad(kpos, (0, pk), value=-1),
                               causal, window, head_dim=head_dim, reduce=logits_sum)[:, :sq]
    out = out.reshape(b, sq, heads, q.shape[-1])
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


@dataclasses.dataclass(frozen=True)
class SeqCut:
    """A cache whose slots are cut over the ``parts`` ranks of ``group``
    (the flash-decode cut), this rank holding the ``index``-th contiguous
    range of them; ``model``: the group is the model ranks, so every q
    head must read this rank's slots."""

    group: Any
    parts: int
    index: int
    model: bool


def _ring_write(buf: torch.Tensor, new: torch.Tensor, local: torch.Tensor) -> None:
    """``new`` (B, 1, H, D) into slot ``local`` (a 0-d device int) of this
    rank's (B, C_l, H, D) range of the ring, in place, where the slot lies
    in it: a read, a select and a write at a clamped device index, so no
    rank reads the slot back to the host."""
    cap_l = buf.shape[1]
    idx = torch.clamp(local, 0, cap_l - 1).reshape(1).long()
    hit = (local >= 0) & (local < cap_l)
    buf.index_copy_(1, idx, torch.where(hit, new.to(buf.dtype), buf.index_select(1, idx)))


def _seq_reduce(t: torch.Tensor, seq: SeqCut, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the ranks of ``seq.group`` in fp32 (a copy), cast
    back."""
    total = t.to(torch.float32, copy=True)
    protomath.count_collective("model" if seq.model else "data", "all_reduce", total)
    dist.all_reduce(total, op=op, group=seq.group)
    return total.to(t.dtype)


def _model_part(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's part of a whole ``t`` along ``dim``."""
    ctx = protomath.current_protocol()
    size = t.shape[dim] // ctx.model_world
    return t.narrow(dim, ctx.model_rank * size, size)


def decode_attention(params, x: torch.Tensor, cache: KVCache, *, n_heads: int, n_kv_heads: int,
                     rope_theta: float | None, window: int | None = None, cross: bool = False,
                     seq: SeqCut | None = None):
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
    written come out negative and are masked, as is what lie outside
    ``window``. Cross-attention reads its fixed encoder K/V and writes
    nothing.

    On a serving rank (``protomath.model_context``) the projections go
    through ``pmm``: heads cut over the model ranks make q, k and v
    column-parallel and ``wo`` row-parallel; q heads cut over kv heads
    that are whole read the kv heads they group onto; a cut ``head_dim``
    is joined whole (the cache holds whole heads). ``seq`` is the
    flash-decode cut of the cache's slots: the ring of ``parts * C_l``
    slots is written at global slot ``length % capacity`` only by the rank
    whose range holds it, each slot's position from its global index, and
    the softmax is the reference's arithmetic under GSPMD: the max and the
    sum of ``exp`` all-reduced over ``seq.group``, the probabilities
    normalised locally and cast to ``x.dtype``, their product with this
    rank's V all-reduced in fp32 and cast back to ``x.dtype``. A cut over
    the model ranks reads every q head (gathered, then this rank's taken
    back for ``wo``)."""
    b = x.shape[0]
    pos = cache.length
    q = pmm("bsd,dhk->bshk", x, params["wq"], w_spec=("fsdp", "tp", None))
    dim_cut = protomath.tp_dim_of(params["wq"]) == 2  # attn_tp="head_dim": the whole head_dim, RoPE's pairs too
    if dim_cut:
        q = protomath.model_join(q, -1)
    if rope_theta is not None:
        q = apply_rope(q, pos.expand(b, 1), rope_theta)
    heads_split = dim_cut and cache.k.shape[2] < n_kv_heads  # the cache's kv heads cut: this rank's q heads
    if heads_split:
        q = _model_part(q, 2)
    heads = q.shape[2]  # this rank's, where the heads are cut over the model ranks
    joined = seq is not None and seq.model and heads < n_heads
    if joined:
        q = protomath.model_join(q, 2)
    cap_l = cache.capacity
    parts, index = (1, 0) if seq is None else (seq.parts, seq.index)
    if cross:
        new_cache, valid = cache, None
    else:
        k_new = pmm("bsd,dhk->bshk", x, params["wk"], w_spec=("fsdp", "tp", None))
        v_new = pmm("bsd,dhk->bshk", x, params["wv"], w_spec=("fsdp", "tp", None))
        if dim_cut:
            k_new, v_new = protomath.model_join(k_new, -1), protomath.model_join(v_new, -1)
        if rope_theta is not None:
            k_new = apply_rope(k_new, pos.expand(b, 1), rope_theta)
        if k_new.shape[2] > cache.k.shape[2]:  # a cut head_dim joined, the cache's kv heads cut: this rank's
            k_new, v_new = _model_part(k_new, 2), _model_part(v_new, 2)
        cap, first = cap_l * parts, index * cap_l
        slot = torch.remainder(pos, cap)
        if parts == 1:
            cache.k.index_copy_(1, slot.reshape(1).long(), k_new.to(cache.k.dtype))
            cache.v.index_copy_(1, slot.reshape(1).long(), v_new.to(cache.v.dtype))
        else:
            _ring_write(cache.k, k_new, slot - first)
            _ring_write(cache.v, v_new, slot - first)
        kpos = pos - torch.remainder(pos - (first + torch.arange(cap_l, dtype=torch.int32, device=x.device)), cap)
        valid = kpos >= 0
        if window is not None:
            valid = valid & ((pos - kpos) < window)
        new_cache = KVCache(k=cache.k, v=cache.v, length=pos + 1)
    k_all, v_all = cache.k, cache.v
    hq, hkv = q.shape[2], k_all.shape[2]
    if hq * n_kv_heads != hkv * n_heads:  # this rank's q heads, the kv heads whole: the ones they read
        g = n_heads // n_kv_heads
        count = max(hq // g, 1)
        first_kv = protomath.current_protocol().model_rank * hq // g
        k_all, v_all, hkv = k_all.narrow(2, first_kv, count), v_all.narrow(2, first_kv, count), count
    scale = q.shape[-1] ** -0.5
    qg = q.reshape(b, 1, hkv, hq // hkv, q.shape[-1])
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_all).to(torch.float32) * scale
    if valid is not None:
        logits = torch.where(valid, logits, NEG_INF)
    if seq is None:
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_all)
    else:
        m = _seq_reduce(torch.amax(logits, dim=-1, keepdim=True), seq, dist.ReduceOp.MAX)
        e = torch.exp(logits - m)
        probs = (e / _seq_reduce(torch.sum(e, dim=-1, keepdim=True), seq)).to(x.dtype)
        out = _seq_reduce(torch.einsum("bhgqk,bkhd->bqhgd", probs, v_all), seq)
    out = out.reshape(b, 1, hq, q.shape[-1])
    rank = 0 if protomath.current_protocol() is None else protomath.current_protocol().model_rank
    if joined:  # this rank's heads, for the row-parallel wo
        out = out.narrow(2, rank * heads, heads)
    if heads_split:  # every head, for wo's cut of head_dim
        out = protomath.model_join(out, 2)
    if dim_cut:  # this rank's cut of head_dim, for wo
        cut = params["wo"].shape[1]
        out = out.narrow(-1, rank * cut, cut)
    return pmm("bshk,hkd->bsd", out, params["wo"], w_spec=("tp", None, "fsdp")), new_cache
