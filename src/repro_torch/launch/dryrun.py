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
    ``head_dim``. The serving shapes hold ``collectives: null`` and the
    reason (serving over a mesh of many ranks, ROADMAP A.9e);
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

from repro_torch import pytree
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, ShapeConfig, TrainConfig
from repro_torch.core.protomath import _dim_of, _tp_kind
from repro_torch.launch import roofline, serve, train
from repro_torch.launch.mesh import Mesh, make_production_mesh, n_data_devices
from repro_torch.models.attention import PLAIN_THRESHOLD
from repro_torch.models.module import _axis_size
from repro_torch.models.moe import expert_capacity
from repro_torch.models.transformer import CE_CHUNK

__all__ = ["skip_reason", "run_case", "main"]

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
    collectives, why = None, None
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
        why = "serving over a mesh of many ranks waits for ROADMAP A.9e"
    wire = {"total_wire_bytes": sum(collectives.values()) if collectives else 0.0}
    terms = roofline.derive_terms({"flops": mf / mesh.size, "bytes accessed": nbytes}, wire, model_flops_total=mf,
                                  chips=mesh.size, device=DEVICE)
    rec.update(collectives=None if collectives is None else {"bytes_by_kind": collectives, **wire},
               roofline=terms.as_dict(), model_flops_total=mf, bytes_accessed_per_rank=nbytes,
               note="bounds at the H100's published peaks, not measured times")
    if why:
        rec["collectives_reason"] = why
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
