"""The port's dry run: every (architecture x input shape) on the production
meshes, 16 x 16 (``pod1``, 256 ranks) and 2 x 16 x 16 (``pod2``, 512),
with no allocation.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k --multi-pod pod1

The reference lowers and compiles each case on ``ShapeDtypeStruct``
stand-ins and reads XLA's memory and cost analyses. The port has no
compiler to ask: it places ``meta`` tensors (``roofline.
param_shapes_and_specs``) with the placements the step and the serving
path use (``train.param_pspecs``, ``opt_state_shardings``, ``batch_pspec``,
``serve.decode_state_pspecs``, ``batch_dim_pspec``, ``serve_input_specs``)
and counts, for one rank:

  * the bytes it stores: its cut of the parameters, of the AdamW moments
    (train), and of the decode state (decode);
  * the largest transient of the exchange, one leaf's ``(N/data,
    leaf/model)`` fp32 blocked cotangent (train);
  * the wire bytes of a train step by collective kind, as the protomath
    step issues them on a ring (an all-gather receives ``(r-1)/r`` of the
    whole, an all-reduce moves ``2(r-1)/r`` of it): the ``fsdp`` all-gathers
    of each weight's compute view at each use, the tensor-parallel
    all-reduces of the activations (row-parallel outputs, column-parallel
    input gradients, the vocabulary-parallel lookups and log-sum-exp), the
    lookups' gradient all-reduces over the data ranks, and each exchange's
    ``all_to_all`` (sharded server) or ``all_gather`` (gather server); and
    the other families' model-rank collectives: the MoE's expert outputs and
    dispatch gradients gathered, the k and v gradients summed where the q
    heads alone are cut, Mamba's ``in_proj`` halves gathered and B's and
    C's gradients summed, RWKV's channel-mix receptance and whole-leaf
    gradients gathered, and under ``attn_tp="head_dim"`` the logits'
    partial sums (``tp_logits_all_reduce``) and RoPE's gathered
    ``head_dim``. A serving shape's (``serve_collectives``) are those of one
    decode step and its greedy token, or of one prefill and its greedy
    token, as a serving rank issues them (the data cut of the weights
    gathered once before, ``weights_gather_once``): the vocabulary-parallel
    lookup, the row-parallel outputs, the flash-decode cut's max, sum and
    product over the ranks holding a cache's slots, the q heads gathered
    where those are the model ranks, MoE's batch gathered over the data
    ranks and its experts' outputs over the model ranks, Mamba's
    ``in_proj`` halves, RWKV's token shifts and receptance, and the greedy
    token's (max, index) pairs; with their calls and the bytes a rank puts
    in (``calls_by_kind``, ``payload_bytes_by_kind``, as
    ``protomath.collective_counts`` counts them on the ranks);
  * ``roofline.derive_terms`` at the peaks of the ``NVIDIA H100 80GB
    HBM3``: the analytic 6ND (2ND served) FLOPs a rank, the bytes a rank
    reads and writes at least (its weights' compute views once forward and
    once backward a microbatch, its stored parameters and moments read and
    written by the apply, its decode state read once), and the wire bytes.

These are bounds at the H100's published peaks, not measured times.
Records go to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``;
``launch.report`` renders them.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
from typing import Any

import torch

from repro_torch import pytree
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, ShapeConfig, TrainConfig
from repro_torch.core.protomath import _dim_of, _tp_kind
from repro_torch.launch import roofline, serve, train
from repro_torch.launch.mesh import Mesh, make_production_mesh, n_data_devices
from repro_torch.models import serving
from repro_torch.models.attention import KV_CHUNK, PLAIN_THRESHOLD, Q_CHUNK
from repro_torch.models.module import _axis_size, logical_to_mesh
from repro_torch.models.moe import expert_capacity
from repro_torch.models.transformer import CE_CHUNK

__all__ = ["skip_reason", "serve_collectives", "serve_weights_gather", "run_case", "main"]

DEVICE = roofline.H100
OUT_DIR = "experiments/dryrun_torch"


def skip_reason(cfg: ArchConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and cfg.long_context == "skip":
        return "enc-dec audio model: 500k decoder context is out of scope (DESIGN.md)"
    return None


def _effective_cfg(cfg: ArchConfig, shape: ShapeConfig) -> ArchConfig:
    """Apply the long-context policy: sliding-window attention for window archs."""
    if shape.name == "long_500k" and cfg.long_context in ("window", "native"):
        period = tuple(
            type(b)(mixer=b.mixer, mlp=b.mlp, sliding_window=cfg.long_window)
            if b.mixer in ("attn", "attn_nope")
            else b
            for b in cfg.period
        )
        return cfg.scaled(period=period)
    return cfg


@functools.lru_cache(maxsize=None)
def _shapes_and_specs(arch: str):
    """``ARCHS[arch]``'s parameters on ``meta`` and their specs, built once."""
    return roofline.param_shapes_and_specs(ARCHS[arch])


def _placed(tree: Any, placements: Any) -> list[tuple[str, Any, tuple]]:
    """(path, meta tensor, placement) of every leaf of a dict tree."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}".rstrip("/"), t, pl) for k in sorted(tree) for p, t, pl in _placed(tree[k], placements[k])]
    return [("", tree, placements)]


def _parts(mesh: Mesh, placement: tuple, axes=None) -> int:
    """Into how many parts a placement cuts a leaf (over ``axes`` only:
    ``"model"`` or ``"data"``, the data axes)."""
    def counts(e):
        return e is not None and (axes is None or (e == "model") == (axes == "model"))

    return math.prod(_axis_size(mesh, e) for e in placement if counts(e))


def _cut_bytes(leaves, mesh: Mesh, itemsize: int | None = None) -> int:
    return sum(t.numel() // _parts(mesh, pl) * (itemsize or t.element_size()) for _, t, pl in leaves)


def _ring(parts: int) -> tuple[float, float]:
    """Wire bytes a rank sends, as shares of the whole, of a ring
    all-gather and a ring all-reduce over ``parts`` ranks."""
    return (parts - 1) / parts, 2 * (parts - 1) / parts


def _product_spec(name: str, shape: tuple) -> str | None:
    """The einsum a per-layer weight of ``shape`` takes part in, ``None``
    for the tables (counted apart) and the leaves of the affine ops."""
    if len(shape) == 3:
        return {"wq": "bsd,dhk->bshk", "wk": "bsd,dhk->bshk", "wv": "bsd,dhk->bshk", "wo": "bshk,hkd->bsd",
                "w_gate": "necd,edf->necf", "w_up": "necd,edf->necf", "w_down": "necf,efd->necd"}.get(name)
    if len(shape) == 2 and name not in ("table", "lm_head", "mu", "a_log", "conv_w"):
        return "bsx,xy->bsy"
    return None


def _train_wire(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, tcfg: TrainConfig, leaves) -> dict[str, float]:
    """Wire bytes a rank of the protomath step sends a step, by collective
    kind (the module docstring)."""
    n, data = n_data_devices(mesh), mesh.world
    m, n_local = max(1, tcfg.microbatches), n // mesh.world
    d = 1 if tcfg.protocol == "none" else tcfg.d
    rows = shape.global_batch // n * d * n_local  # a rank's sequences a step
    tokens = rows * shape.seq_len  # a rank's tokens a step
    enc_tokens = rows * cfg.encoder.n_frontend_tokens if cfg.encoder is not None else 0
    chunks = shape.seq_len // min(CE_CHUNK, shape.seq_len)  # the loss's chunks, a head product and lookup each
    act = tokens * cfg.d_model * 4  # the step's fp32 (tokens, d_model) activations
    gather_share, reduce_share = _ring(data)
    model_gather, model_reduce = _ring(mesh.model)
    out = dict.fromkeys(("fsdp_all_gather", "tp_all_reduce", "tp_all_gather", "tp_logits_all_reduce",
                         "lookup_all_reduce", "exchange_all_to_all", "exchange_all_gather"), 0.0)
    cuts = {}
    for path, t, pl in leaves:
        stacked = path.startswith(("periods/", "encoder/"))
        cuts[path] = tuple(None if e is None or _axis_size(mesh, e) == 1 else ("model" if e == "model" else "data")
                           for e in (pl[1:] if stacked else pl))
    for path, t, pl in leaves:
        name, stacked = path.split("/")[-1], path.startswith(("periods/", "encoder/"))
        cut = cuts[path]
        per_layer = tuple(t.shape[1:]) if stacked else tuple(t.shape)
        view = t.numel() // _parts(mesh, pl, "model") // (t.shape[0] if stacked else 1)  # a use's compute view
        head = path == "lm_head" or (name == "table" and cfg.tie_embeddings)
        if stacked:
            products = t.shape[0]  # exchanged uses: one a layer
        else:
            products = chunks if head else (0 if name == "table" else 1)
        lookups = (1 if name == "table" else 0) + (chunks if head else 0)  # the embedding's and the labels' rows
        if "data" in cut:
            out["fsdp_all_gather"] += m * (products + lookups) * gather_share * view * t.element_size()
        if data > 1:
            out["lookup_all_reduce"] += m * lookups * reduce_share * view * t.element_size()
            exchanged = m * products * n_local * view * 4
            if tcfg.server == "sharded" and "data" in cut:
                out["exchange_all_to_all"] += gather_share * exchanged
            else:
                out["exchange_all_gather"] += (data - 1) * exchanged
        if mesh.model == 1:
            continue
        block = cfg.period[int(path.split("/")[1][3:])] if path.startswith("periods/") else None
        mixer = "attn_nope" if path.startswith("encoder/") else (block.mixer if block else None)
        tok = enc_tokens if path.startswith("encoder/") or (mixer == "cross" and name in ("wk", "wv")) else tokens
        layers = t.shape[0] if stacked else 1
        if "model" in cut and name in ("table", "lm_head"):  # vocabulary-parallel: the embedding's rows; the
            # labels' rows, the head's dx and the log-sum-exp's max and sum
            rows_ = (act if name == "table" else 0) + (2 * act + 2 * 4 * tokens if head else 0)
            out["tp_all_reduce"] += model_reduce * rows_
            continue
        spec = _product_spec(name, per_layer)
        kind = None if spec is None else _tp_kind(spec, cut)
        if kind in ("column", "row"):  # a row-parallel output or a column-parallel dx, fp32 a token
            lhs, rhs, out_ix = spec.replace("->", ",").split(",")
            letters = lhs if kind == "column" else out_ix
            elems = math.prod(per_layer[i] for i, c in enumerate(rhs) if c in letters)
            out["tp_all_reduce"] += model_reduce * tok * elems * 4 * layers
        elif kind == "expert" and name == "w_gate":  # the experts' outputs joined, the dispatch's dx gathered
            e, dm = per_layer[0], per_layer[1]
            t_block = shape.global_batch // n * d // m * shape.seq_len
            cap = expert_capacity(t_block, e, cfg.moe.top_k)
            out["tp_all_gather"] += 2 * model_gather * m * n_local * e * cap * dm * 4 * layers
        if name in ("wq", "wk") and len(per_layer) == 3:
            heads, hd = per_layer[1], per_layer[2]
            q_cut = cuts[path[: -len(name)] + "wq"]
            if name == "wk" and _dim_of(q_cut, "model") == 1 and "model" not in cut:  # the q heads alone cut:
                out["tp_all_reduce"] += 2 * model_reduce * tok * heads * hd * 4 * layers  # k's and v's dx summed
            if _dim_of(cut, "model") == 2:  # head_dim cut
                if mixer == "attn" and cfg.rope_theta is not None:  # RoPE on the gathered head_dim
                    out["tp_all_gather"] += model_gather * tok * heads * hd * 4 * layers
                    out["tp_all_reduce"] += model_reduce * tok * heads * hd * 4 * layers
                if name == "wq":  # the logits' partial sums: forward, and the backward's recomputed ones and
                    # dout . v (twice each past the plain threshold, with dout . out), else the logits' dx
                    sk = cfg.encoder.n_frontend_tokens if mixer == "cross" else shape.seq_len
                    sq = cfg.encoder.n_frontend_tokens if path.startswith("encoder/") else shape.seq_len
                    sk = sq if path.startswith("encoder/") else sk
                    times = 5 if max(sq, sk) > PLAIN_THRESHOLD else 2
                    logits = rows * heads * sq * sk * 4
                    out["tp_logits_all_reduce"] += model_reduce * layers * (times * logits
                                                                            + (rows * heads * sq * 4 if times == 5
                                                                               else 0))
        if name == "x_proj" and "model" in cut:  # B's and C's cotangents summed over the model ranks
            out["tp_all_reduce"] += model_reduce * tok * 2 * cfg.mamba.d_state * 4 * layers
        if name == "in_proj" and "model" in cut:  # the x and z halves' slices: the view and dw gathered
            whole = view * mesh.model
            out["tp_all_gather"] += model_gather * m * layers * whole * (t.element_size() + n_local * 4)
        if path.endswith("mlp/wr") and "model" in cut:  # RWKV's channel-mix receptance joined whole
            out["tp_all_gather"] += model_gather * tok * cfg.d_model * 4 * layers
        if name in ("w0", "ln_scale") and "model" in cuts[path[: -len(name)] + "wr"]:  # whole leaves on cut
            out["tp_all_gather"] += model_gather * m * layers * n_local * cfg.d_model * 4  # columns: dw joined
    return out


def _serve_counter():
    """A tally ``{kind: [calls, bytes]}`` and the function that adds one
    collective of ``numel`` elements of ``itemsize`` bytes to it."""
    tally: dict[str, list[int]] = {}

    def add(axis: str, op: str, numel: int, itemsize: int) -> None:
        entry = tally.setdefault(f"{axis}_{op}", [0, 0])
        entry[0] += 1
        entry[1] += int(numel) * itemsize

    return tally, add


def serve_collectives(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh) -> dict[str, dict[str, int]]:
    """The collectives a serving rank issues for ``shape`` on ``mesh``, by
    ``"{axis}_{op}"`` (``protomath.collective_counts``' kinds): calls and
    the bytes the rank puts in. A decode shape counts one ``decode_step``
    against the state ``serve_input_specs`` places, and its greedy token; a
    prefill shape one ``prefill`` and its greedy token. They follow
    ``models.serving``'s code on the placements ``serving.SERVE_RULES``
    gives (the data cut gathered once, apart: ``serve_weights_gather``)."""
    from repro_torch.models.serving import SERVE_RULES

    m, isz = mesh.model, torch.empty((), dtype=cfg.dtype).element_size()
    shapes, specs = _shapes_and_specs_of(cfg)
    pl = logical_to_mesh(specs, mesh, rules=SERVE_RULES, shapes=shapes)
    b = shape.global_batch
    batch_cut = serve.batch_dim_pspec(b, mesh)[0] is not None and mesh.world > 1
    bl = b // mesh.world if batch_cut else b
    decode = shape.kind == "decode"
    s = 1 if decode else shape.seq_len
    d, hd = cfg.d_model, cfg.resolved_head_dim
    tally, add = _serve_counter()
    state_pl = None
    if decode:
        state = serving.init_decode_state(cfg, b, shape.seq_len, device="meta")
        state_pl = serve.decode_state_pspecs(state, mesh)
    if pl["embed"]["table"][0] == "model":  # the vocabulary-parallel lookup
        add("model", "all_reduce", bl * s * d, 4)

    def attention(mix: dict, tokens: int, kv_tokens: int, mixer: str, cache_pl: tuple | None, encoder: bool):
        h, hkv = cfg.n_heads, cfg.n_kv_heads
        q_cut, dim_cut = mix["wq"][1] == "model", mix["wq"][2] == "model"
        cross = mixer == "cross"
        if decode and not encoder:
            hq = h // m if q_cut else h
            if dim_cut:
                add("model", "all_gather", bl * h * hd // m, isz)
                if not cross:
                    add("model", "all_gather", bl * hkv * hd // m, isz)
                    add("model", "all_gather", bl * hkv * hd // m, isz)
            split = dim_cut and cache_pl[3] == "model"
            hq = h // m if split else hq
            seq = cache_pl[2]
            if seq == "model" and hq < h:  # every q head reads this rank's slots
                add("model", "all_gather", bl * hq * hd, isz)
                hq = h
            if seq is not None:
                axis = "model" if seq == "model" else "data"
                add(axis, "all_reduce", bl * hq, 4)
                add(axis, "all_reduce", bl * hq, 4)
                add(axis, "all_reduce", bl * hq * hd, 4)
            if split:
                add("model", "all_gather", bl * hq * hd, isz)
        elif dim_cut:  # a full sequence on a cut head_dim: RoPE's gathers, the logits' partial sums
            if mixer == "attn" and cfg.rope_theta is not None:
                add("model", "all_gather", bl * tokens * h * hd // m, isz)
                add("model", "all_gather", bl * kv_tokens * hkv * hd // m, isz)
            if max(tokens, kv_tokens) <= PLAIN_THRESHOLD:
                add("model", "all_reduce", bl * h * tokens * kv_tokens, 4)
            else:
                qc, kc = min(Q_CHUNK, tokens), min(KV_CHUNK, kv_tokens)
                nq, nk = -(-tokens // qc), -(-kv_tokens // kc)
                for _ in range(nq * nk):
                    add("model", "all_reduce", bl * h * qc * kc, 4)
            if not encoder:  # the cache's whole head_dim
                add("model", "all_gather", bl * kv_tokens * hkv * hd // m, isz)
                add("model", "all_gather", bl * kv_tokens * hkv * hd // m, isz)
        if "model" in mix["wo"][:2]:  # row-parallel wo
            add("model", "all_reduce", bl * tokens * d, 4)

    def mlp(kind: str, blk: dict, tokens: int, x_prev_cut: bool):
        if kind == "dense" and blk["w_down"][0] == "model":
            add("model", "all_reduce", bl * tokens * d, 4)
        elif kind == "moe":
            if batch_cut:
                add("data", "all_gather", bl * tokens * d, isz)
            if blk["w_gate"][0] == "model":
                e = cfg.moe.n_experts
                cap = expert_capacity(b * tokens, e, cfg.moe.top_k)
                add("model", "all_gather", e // m * cap * d, isz)
        elif kind == "rwkv_ffn":
            if decode and x_prev_cut:
                add("model", "all_gather", bl * d // m, isz)
            if blk["wv"][0] == "model":
                add("model", "all_reduce", bl * tokens * d, 4)
            if blk["wr"][1] == "model":
                add("model", "all_gather", bl * tokens * d // m, isz)

    if cfg.family == "audio" and cfg.encoder.n_encoder_layers > 0 and not decode:
        f = cfg.encoder.n_frontend_tokens
        enc = {k: v[1:] for k, v in _flat_leaves(pl["encoder"]).items()}
        for _ in range(cfg.encoder.n_encoder_layers):
            attention(_sub(enc, "mixer"), f, f, "attn_nope", None, True)
            mlp("dense", _sub(enc, "mlp"), f, False)
    for i, spec in enumerate(cfg.period):
        blk = {k: v[1:] for k, v in _flat_leaves(pl["periods"][f"blk{i}"]).items()}
        mix = _sub(blk, "mixer")
        cache = None if state_pl is None else state_pl[f"blk{i}"]
        for _ in range(cfg.n_periods):
            if spec.mixer in ("attn", "attn_nope", "cross"):
                kv = cfg.encoder.n_frontend_tokens if spec.mixer == "cross" else s
                attention(mix, s, kv, spec.mixer, None if cache is None else cache.k, False)
            elif spec.mixer == "mamba":
                if mix["in_proj"][1] == "model":  # the x and z halves' slices: the weight gathered
                    add("model", "all_gather", d * 2 * cfg.mamba.expand * d // m, isz)
                if mix["x_proj"][0] == "model":
                    add("model", "all_reduce", bl * s * (max(1, d // 16) + 2 * cfg.mamba.d_state), 4)
                if mix["out_proj"][0] == "model":
                    add("model", "all_reduce", bl * s * d, 4)
            elif spec.mixer == "rwkv":
                if decode and cache.x_prev[2] == "model":
                    add("model", "all_gather", bl * d // m, isz)
                if mix["wo"][0] == "model":
                    add("model", "all_reduce", bl * s * d, 4)
            if spec.mlp != "none":
                mlp(spec.mlp, _sub(blk, "mlp"), s, cache is not None and spec.mlp == "rwkv_ffn"
                    and cache.ffn_x_prev[2] == "model")
    head = pl["embed"]["table"] if cfg.tie_embeddings else pl["lm_head"]
    if head[0] == "model":  # the greedy token across the vocabulary's cuts
        add("model", "all_gather", bl * 2, 8)
    return {k: {"calls": c, "bytes": n} for k, (c, n) in sorted(tally.items())}


def serve_weights_gather(cfg: ArchConfig, mesh: Mesh) -> dict[str, int]:
    """The one all-gather a leaf over the data ranks with which a serving
    rank turns its stored cut (``train.param_pspecs``) into its model cut
    (``serve.serving_params``), once when serving starts: calls, the bytes
    it puts in, and the wire bytes (ring)."""
    shapes, specs = _shapes_and_specs_of(cfg)
    leaves = _placed(shapes, train.param_pspecs(specs, mesh, shapes))
    cut = [(t, p) for _, t, p in leaves if _parts(mesh, p, "data") > 1]
    payload = sum(t.numel() // _parts(mesh, p) * t.element_size() for t, p in cut)
    return {"calls": len(cut), "bytes": payload, "wire_bytes": (mesh.world - 1) * payload}


def _shapes_and_specs_of(cfg: ArchConfig):
    return _shapes_and_specs(cfg.name) if ARCHS.get(cfg.name) == cfg else roofline.param_shapes_and_specs(cfg)


def _flat_leaves(tree: dict, prefix: str = "") -> dict[str, tuple]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _sub(flat: dict[str, tuple], key: str) -> dict[str, tuple]:
    return {k[len(key) + 1:]: v for k, v in flat.items() if k.startswith(key + "/")}


def run_case(arch: str, shape_name: str, multi_pod: bool, tcfg: TrainConfig, out_dir: str | None = OUT_DIR) -> dict:
    """One (arch, shape, mesh) record; written under ``out_dir`` unless it is ``None``."""
    cfg0, shape = ARCHS[arch], INPUT_SHAPES[shape_name]
    mesh_name = "pod2" if multi_pod else "pod1"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "device": DEVICE,
                 "tcfg": {k: getattr(tcfg, k) for k in ("protocol", "d", "aggregator", "server", "compression",
                                                         "n_byz", "microbatches", "momentum_dtype")}}
    reason = skip_reason(cfg0, shape)
    if reason:
        rec.update(status="skipped", reason=reason)
        return _save(out_dir, rec)
    cfg = _effective_cfg(cfg0, shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    shapes, specs = _shapes_and_specs(arch)  # the window of long_500k changes no parameter
    placements = train.param_pspecs(specs, mesh, shapes)
    leaves = _placed(shapes, placements)
    params_b = _cut_bytes(leaves, mesh)
    rec.update(status="ok", ranks=mesh.size, params_bytes_per_rank=params_b,
               params_bytes_whole=sum(t.numel() * t.element_size() for _, t, _ in leaves))
    n_act = roofline.active_params(cfg, shapes)
    d_red = tcfg.d if (shape.kind == "train" and tcfg.protocol != "none") else 1
    mf = roofline.model_flops(cfg, shape, n_active=n_act, d_redundancy=d_red)
    m = max(1, tcfg.microbatches)
    views = sum(t.numel() // _parts(mesh, pl, "model") * t.element_size() for _, t, pl in leaves)
    extra = {}
    if shape.kind == "train":
        moment = 2 if tcfg.momentum_dtype == "bfloat16" else 4
        moments_b = 2 * _cut_bytes(leaves, mesh, moment)  # AdamW's mu and nu mirror the params
        n_local = n_data_devices(mesh) // mesh.world
        transient = max(n_local * (t.numel() // _parts(mesh, pl, "model")) * 4
                        // (t.shape[0] if p.startswith("periods/") else 1) for p, t, pl in leaves)
        rec.update(moments_bytes_per_rank=moments_b, exchange_transient_bytes=transient,
                   batch_pspec=list(train.batch_pspec(mesh)),
                   opt_state_placement="mu, nu mirror the params; step replicated")
        nbytes = 2 * m * views + 2 * (params_b + moments_b)
        collectives = _train_wire(cfg, shape, mesh, tcfg, leaves)
    else:
        ins = serve.serve_input_specs(cfg, shape, mesh)
        rec["batch_pspec"] = list(serve.batch_dim_pspec(shape.global_batch, mesh))
        state_b = 0
        if shape.kind == "decode":
            state = ins["state"]
            state_b = sum(t.numel() // math.prod(_axis_size(mesh, e) for e in pl if e) * t.element_size()
                          for (_, t), (_, pl) in zip(pytree.paths(state.value), _flat(state.placement)))
            rec["decode_state_bytes_per_rank"] = state_b
        nbytes = views + state_b
        served = serve_collectives(cfg, shape, mesh)
        ranks = {"model": mesh.model, "data": mesh.world}
        collectives = {kind: (ranks[kind.split("_")[0]] - 1) * v["bytes"] if kind.endswith("all_gather")
                       else _ring(ranks[kind.split("_")[0]])[1] * v["bytes"] for kind, v in served.items()}
        extra = {"calls_by_kind": {k: v["calls"] for k, v in served.items()},
                 "payload_bytes_by_kind": {k: v["bytes"] for k, v in served.items()},
                 "weights_gather_once": {**serve_weights_gather(cfg0, mesh),
                                         "choice": "the data (fsdp) cut all-gathered once when serving starts, "
                                                   "the model cut kept (not a gather a product)"},
                 "per": "one decode step and its greedy token" if shape.kind == "decode"
                 else "one prefill and its greedy token"}
    wire = {"total_wire_bytes": sum(collectives.values())}
    terms = roofline.derive_terms({"flops": mf / mesh.size, "bytes accessed": nbytes}, wire, model_flops_total=mf,
                                  chips=mesh.size, device=DEVICE)
    rec.update(collectives={"bytes_by_kind": collectives, **wire, **extra},
               roofline=terms.as_dict(), model_flops_total=mf, bytes_accessed_per_rank=nbytes,
               note="bounds at the H100's published peaks, not measured times")
    return _save(out_dir, rec)


def _flat(tree: Any, prefix: str = "") -> list[tuple[str, tuple]]:
    """(path, placement) of a placement tree of dicts and dataclasses, in
    ``pytree.paths``' order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f"{prefix}{k}/")]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _flat(getattr(tree, f.name), f"{prefix}.{f.name}/")]
    return [(prefix[:-1], tree)]


def _save(out_dir: str | None, rec: dict) -> dict:
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="both", choices=["pod1", "pod2", "both"])
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--protocol", default="lad", choices=["lad", "none"])
    ap.add_argument("--d", type=int, default=2)
    ap.add_argument("--aggregator", default="cwtm")
    ap.add_argument("--server", default="sharded", choices=["sharded", "gather"])
    ap.add_argument("--n-byz", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)
    tcfg = TrainConfig(protocol=args.protocol, d=args.d, aggregator=args.aggregator, server=args.server,
                       n_byz=args.n_byz, microbatches=args.microbatches)
    meshes = {"pod1": [False], "pod2": [True], "both": [False, True]}[args.multi_pod]
    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    results = []
    for mp in meshes:
        for a in archs:
            for s in shapes:
                rec = run_case(a, s, mp, tcfg, args.out_dir)
                extra = rec.get("reason", "")
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    extra = (f"dom={r['dominant']} comp={r['compute_s']:.3e}s mem={r['memory_s']:.3e}s "
                             f"coll={r['collective_s']:.3e}s params={rec['params_bytes_per_rank'] / 2**30:.3f}GiB/rank")
                print(f"[{rec['status']:7s}] {a} x {s} x {rec['mesh']} {extra}", flush=True)
                results.append(rec)
    n_ok = sum(r["status"] == "ok" for r in results)
    print(f"done: {n_ok} ok, {len(results) - n_ok} skipped ({DEVICE} bounds)")
    return results


if __name__ == "__main__":
    main()
