"""The port's tensor-parallel model axis on the ranks of a ``gloo`` group, on
the CPU: the helper that tests/test_torch_tp.py and
tests/test_torch_protomath_step.py start once a rank.

    python tests/torch_tp_ranks.py MODE OUT_DIR RANK WORLD MODEL

Every rank joins the group through a file under ``OUT_DIR`` (no port) and
lays the ``WORLD`` ranks out as ``make_host_mesh(N, MODEL)``: ``WORLD /
MODEL`` data ranks of ``MODEL`` model ranks each. It writes its results to
``OUT_DIR/rank{RANK}.npz``. Modes:

  * ``ops`` (data 1 x model 2): ``pmm`` column-parallel and row-parallel
    and the vocabulary-parallel ``plookup`` (plain and robust), forward
    and backward on ``op_inputs()``, each rank's output, input cotangent
    and weight cotangent (its cut); one exchange a compressor of
    ``EXCHANGES`` on this rank's tp slice of each of ``SLICES``; and each
    case of ``run_tp_ops``, its outputs joined whole over the model ranks;
  * ``ops-cuda`` (data 1 x model 2, on the card): ``run_tp_ops`` alone;
  * ``step``: each of ``CONFIGS`` for ``STEPS`` steps of ``ARCH()`` at
    N=4 from the same seeded weights and batches: its losses, the
    gathered parameters (flat), and the bytes this rank stores (params
    and moments);
  * ``families``: each of ``FAMILY_CONFIGS`` on each arch of ``FAMILIES``
    (every family at model > 1), as ``step`` does;
  * ``layout``: ``make_host_mesh``'s rank layout and groups on 4 ranks,
    for (data 2 x model 2), (pod 2 x data 1 x model 2) and (pod 2 x data 2
    x model 1);
  * ``reference``: the runs of ``OUT_DIR/tags.json`` from the reference's
    initial weights and batches (``OUT_DIR/inputs.npz``, written by
    tests/test_torch_protomath_step.py's reference subprocess): each tag's
    losses.

The models are small because a collective on a busy CPU waits until every
rank is scheduled: the run's time follows its count of collectives.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

N = 4
STEPS = 3
_BASE = dict(protocol="lad", d=2, aggregator="cwtm", trim_frac=0.25, n_byz=1, attack="alie", server="sharded",
             optimizer="adamw", lr=1e-3, steps=5, seed=0)
CONFIGS = {
    "cwtm-alie-sharded-mb2": dict(microbatches=2),
    "cwtm-alie-gather-mb2": dict(microbatches=2, server="gather"),
    "nnm-sign_flip-sharded": dict(aggregator="cwtm-nnm", attack="sign_flip"),
    "nnm-sign_flip-gather": dict(aggregator="cwtm-nnm", attack="sign_flip", server="gather"),
    "quant-gaussian-sharded": dict(attack="gaussian", compression="quant", quant_levels=4),
    "quant-gaussian-gather": dict(attack="gaussian", compression="quant", quant_levels=4, server="gather"),
    "honest-sharded": dict(protocol="none"),
    "cwtm-alie-sharded-sgd": dict(optimizer="sgd_momentum", lr=1e-2),
}
EXCHANGES = {  # compressor and attack of an exchange on a tp slice, CWTM over N=4 blocks
    "none": dict(compression="none", attack="sign_flip"),
    "rand_sparse": dict(compression="rand_sparse", attack="sign_flip"),
    "quant": dict(compression="quant", attack="sign_flip"),
    "gaussian": dict(compression="none", attack="gaussian"),
}


# the key-free runs of every family against the reference Trainer (tests/test_torch_protomath_step.py)
FAMILY_TAGS = {
    "honest": dict(protocol="none", optimizer="adamw", lr=1e-3, steps=3, seed=0),
    "lad": dict(protocol="lad", d=2, aggregator="cwtm", trim_frac=0.25, n_byz=1, attack="sign_flip",
                optimizer="adamw", lr=1e-3, steps=3, seed=0),
}
FAMILY_CONFIGS = {name: CONFIGS[name] for name in ("nnm-sign_flip-sharded", "nnm-sign_flip-gather",
                                                   "quant-gaussian-sharded", "quant-gaussian-gather",
                                                   "cwtm-alie-sharded-sgd")}


def FAMILIES() -> dict:
    """Every family the model axis cuts: ``lm_arch()`` (its q heads cut, its
    one kv head whole), ``zoo_arch``'s moe, jamba (Mamba, MoE and
    attention), rwkv, cross and audio (the whisper encoder), and
    ``lm_arch()`` with ``attn_tp="head_dim"``."""
    from repro_torch.core import scenarios

    out = {"lm": scenarios.lm_arch()}
    out.update({fam: scenarios.zoo_arch(fam) for fam in ("moe", "jamba", "rwkv", "cross", "audio")})
    out["head_dim"] = scenarios.lm_arch().scaled(attn_tp="head_dim")
    return out


def ARCH():
    """``lm_arch()`` with 4 heads over 2 kv heads: heads that split over 2
    model ranks."""
    from repro_torch.core import scenarios

    return scenarios.lm_arch().scaled(n_heads=4, n_kv_heads=2)


def op_inputs() -> dict[str, np.ndarray]:
    """Inputs of the op checks: a column-parallel product (w (6, 8), its
    columns cut), a row-parallel one (w (8, 6), its rows cut, x's last dim
    with them), a (8, 6) table cut over its rows, and each op's output
    cotangent."""
    rng = np.random.default_rng(7)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return {"col_x": f(4, 3, 6), "col_w": f(6, 8), "col_ct": f(4, 3, 8),
            "row_x": f(4, 3, 8), "row_w": f(8, 6), "row_ct": f(4, 3, 6),
            "table": f(8, 6), "ids": rng.integers(0, 8, size=(4, 3)), "lookup_ct": f(4, 3, 6)}


def exchange_inputs() -> np.ndarray:
    """An (N, 8, 6) blocked cotangent, cut over 2 model ranks on dim 1."""
    return np.random.default_rng(8).standard_normal((N, 8, 6)).astype(np.float32)


# the tp slices of the exchange: (blocked cotangent shape, the leaf's logical axes, its model-cut dim)
SLICES = {
    "column": ((N, 8, 6), ("tp", "fsdp"), 0),
    "expert": ((N, 4, 6, 5), ("tp", "fsdp", None), 0),  # MoE's w_gate: experts cut
    "d_inner": ((N, 8), None, 0),  # Mamba's conv_b, dt_bias, d_skip: a vector cut
    "heads": ((N, 4, 3), None, 0),  # RWKV's bonus_u: heads cut
}


def slice_inputs(name: str) -> np.ndarray:
    shape = SLICES[name][0]
    return np.random.default_rng(8 + len(shape)).standard_normal(shape).astype(np.float32)


def exchange_protocol(name: str):
    from repro_torch.core import attacks, compression
    from repro_torch.core.protomath import BlockedProtocol

    kw = EXCHANGES[name]
    return BlockedProtocol(n_devices=N, aggregator="cwtm", trim_frac=0.25, n_byz=1,
                           attack=attacks.AttackSpec(name=kw["attack"], n_byz=1),
                           compression=compression.spec_from(kw["compression"], q_hat_frac=0.5, levels=4))


def op_protocol(model_size: int):
    from repro_torch.core import attacks
    from repro_torch.core.protomath import BlockedProtocol

    return BlockedProtocol(n_devices=N, aggregator="cwtm", trim_frac=0.25, n_byz=1,
                           attack=attacks.AttackSpec(name="alie", n_byz=1), model_size=model_size)


def run_ops(p, model_group, model_rank: int, cut_of, robust: bool = False) -> dict[str, np.ndarray]:
    """Each op's (output, dx, dw) under ``p`` on ``model_rank``'s cuts
    (``cut_of(name, array) -> (array, cut)``; the whole op with no model
    group and no cut). ``robust``: the lookup through the exchange."""
    import dataclasses

    from repro_torch.core import protomath

    a = op_inputs()
    p = dataclasses.replace(p, embedding_robust=robust)
    out = {}
    for op, spec, w_spec in (("col", "bsd,df->bsf", ("fsdp", "tp")), ("row", "bsf,fd->bsd", ("tp", "fsdp"))):
        x_np, x_cut = cut_of(f"{op}_x", a[f"{op}_x"])
        w_np, w_cut = cut_of(f"{op}_w", a[f"{op}_w"])
        ct_np, _ = cut_of(f"{op}_ct", a[f"{op}_ct"])
        x, w = torch.tensor(x_np, requires_grad=True), torch.tensor(w_np, requires_grad=True)
        with protomath.protocol_context(p, 3, model_group=model_group, cuts={id(w): w_cut} if w_cut else {}):
            y = protomath.pmm(spec, x, w, w_spec=w_spec)
            dx, dw = torch.autograd.grad(y, (x, w), torch.tensor(ct_np))
        out.update({f"{op}/out": y.detach().numpy(), f"{op}/dx": dx.numpy(), f"{op}/dw": dw.numpy()})
    t_np, t_cut = cut_of("table", a["table"])
    table = torch.tensor(t_np, requires_grad=True)
    with protomath.protocol_context(p, 3, model_group=model_group, cuts={id(table): t_cut} if t_cut else {}):
        y = protomath.plookup(table, torch.tensor(a["ids"]), w_spec=("tp", "fsdp"))
        (dt,) = torch.autograd.grad(y, (table,), torch.tensor(a["lookup_ct"]))
    out.update({"lookup/out": y.detach().numpy(), "lookup/dw": dt.numpy()})
    return out


def _half(a: np.ndarray, dim: int, rank: int) -> np.ndarray:
    size = a.shape[dim] // 2
    return np.take(a, range(rank * size, (rank + 1) * size), axis=dim)


def _ops(mesh) -> dict[str, np.ndarray]:
    from repro_torch.core import protomath

    r = mesh.model_rank
    cuts = {"col_w": (1, (None, "model")), "col_ct": (2, None), "row_x": (2, None), "row_w": (0, ("model", None)),
            "table": (0, ("model", None))}

    def cut_of(name, a):
        if name not in cuts:
            return a, None
        dim, cut = cuts[name]
        return _half(a, dim, r), cut

    out = {}
    for robust in (False, True):
        res = run_ops(op_protocol(mesh.model), mesh.model_group, r, cut_of, robust)
        out.update({f"{'robust' if robust else 'plain'}/{k}": v for k, v in res.items()})
    for kind, (shape, w_spec, dim) in SLICES.items():
        block = torch.tensor(_half(exchange_inputs() if kind == "column" else slice_inputs(kind), 1 + dim, r))
        cut = tuple("model" if i == dim else None for i in range(len(shape) - 1))
        for name in EXCHANGES:
            agg = protomath.robust_combine(exchange_protocol(name), block, w_spec, seed=9,
                                           model_group=mesh.model_group, cut=cut)
            out[f"exchange/{name}" if kind == "column" else f"exchange/{kind}/{name}"] = agg.numpy()
    out.update({f"tp/{k}": v for k, v in run_tp_ops(op_protocol(mesh.model), mesh).items()})
    return out


CHUNKED_S = 2100  # above attention's PLAIN_THRESHOLD: the chunked online softmax
TP_OPS = ("expert", "expert_cut_input", "scale_vector", "bias_row", "tap_derived", "whole_bias_on_cut",
          "whole_scale_on_cut", "attn_q_heads", "attn_head_dim", "attn_head_dim_chunked", "moe", "mamba",
          "rwkv_time", "rwkv_channel")  # run_tp_ops' cases


def run_tp_ops(p, mesh=None, device: str = "cpu") -> dict[str, np.ndarray]:
    """The ops of the model axis's other families, forward and backward
    under ``p`` at N=4 blocks, on ``mesh``'s model ranks (``None``: the
    whole op in one process), every output and cotangent joined whole over
    the model ranks: the expert-parallel ``pmm`` (on a whole input cut by
    ``model_split``, and on a cut one), the cut-aware ``pscale``/``pbias``/``block_tap`` (a cut vector, a
    row of a cut leaf, a tensor derived from a cut leaf), a whole leaf on a
    cut input, attention with the q heads alone cut, attention with
    ``head_dim`` cut and RoPE (plain, and chunked at ``CHUNKED_S``
    tokens), and the MoE, Mamba and RWKV layers."""
    from repro_torch.core import protomath
    from repro_torch.launch import train
    from repro_torch.models import attention, mamba, moe, rwkv
    from repro_torch.models.module import split_tree

    group, r, m = (None, 0, 1) if mesh is None else (mesh.model_group, mesh.model_rank, mesh.model)
    rng = np.random.default_rng(11)
    out = {}

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def part(a, dim):
        return a if m == 1 or dim is None else np.take(a, range(r * (a.shape[dim] // m),
                                                                (r + 1) * (a.shape[dim] // m)), axis=dim)

    def join(t, dim):
        t = t.detach()
        if m > 1 and dim is not None:
            t = protomath._all_gather(t.movedim(dim, 0).contiguous(), group, m).movedim(0, dim)
        return t.cpu().numpy()

    def op(name, call, inputs, ct, out_dim):
        """``inputs``: (array, its model-cut dim or None, whether it is a leaf)."""
        ts = [torch.tensor(part(a, d), device=device, requires_grad=True) for a, d, _ in inputs]
        cuts = {id(t): tuple("model" if i == d else None for i in range(a.ndim))
                for t, (a, d, leaf) in zip(ts, inputs) if leaf and d is not None and m > 1}
        with protomath.protocol_context(p, 3, model_group=group, cuts=cuts):
            y = call(*ts)
            grads = torch.autograd.grad(y, ts, torch.tensor(part(ct, out_dim), device=device))
        out[f"{name}/out"] = join(y, out_dim)
        out.update({f"{name}/d{i}": join(g, d) for i, ((_, d, _), g) in enumerate(zip(inputs, grads))})

    def expert(x, w):
        return protomath.pmm("necd,edf->necf", x, w, w_spec=("tp", "fsdp", None), pre_blocked=True)

    # a replicated input cut to this rank's experts first (MoE's dispatch), and one already cut
    op("expert", lambda x, w: expert(protomath.model_split(x, 1), w),
       [(f(N, 4, 3, 6), None, False), (f(4, 6, 5), 0, True)], f(N, 4, 3, 5), 1)
    op("expert_cut_input", expert, [(f(N, 4, 3, 6), 1, False), (f(4, 6, 5), 0, True)], f(N, 4, 3, 5), 1)
    op("scale_vector", protomath.pscale, [(f(N, 3, 8), 2, False), (f(8), 0, True)], f(N, 3, 8), 2)
    op("bias_row", lambda x, w: protomath.pbias(x, w, index=1), [(f(N, 3, 8), 2, False), (f(3, 8), 1, True)],
       f(N, 3, 8), 2)
    op("tap_derived", lambda w: protomath.block_tap(w, lambda a: -torch.exp(a))[0], [(f(8, 2) * 0.5, 0, True)],
       f(N, 8, 2), 1)
    op("whole_bias_on_cut", protomath.pbias, [(f(N, 3, 8), 2, False), (f(8), None, True)], f(N, 3, 8), 2)
    op("whole_scale_on_cut", protomath.pscale, [(f(N, 3, 8), 2, False), (f(8), None, True)], f(N, 3, 8), 2)

    def layer(name, pairs, call, x, ct):
        """A layer's forward and backward from its (params, specs) on this
        rank's cut of the whole params (placed as the step places them)."""
        params, specs = split_tree(pairs)
        params = {k: torch.tensor(v.numpy()) for k, v in params.items()}
        cuts = {}
        if m > 1:
            placements = train.param_pspecs(specs, mesh, params)
            params = train.shard_tree(params, placements, mesh)
        params = {k: v.to(device).requires_grad_() for k, v in params.items()}
        if m > 1:
            cuts = train._cuts(params, placements, mesh, {})
        xt = torch.tensor(x, device=device, requires_grad=True)
        with protomath.protocol_context(p, 3, model_group=group, cuts=cuts):
            y = call(params, xt)
            grads = torch.autograd.grad(y, [xt, *params.values()], torch.tensor(ct, device=device))
        dparams = dict(zip(params, grads[1:]))
        if m > 1:
            dparams = train.gather_tree(dparams, placements, mesh)
        out[f"{name}/out"], out[f"{name}/dx"] = join(y, None), join(grads[0], None)
        out.update({f"{name}/d_{k}": join(g, None) for k, g in dparams.items()})

    def randomized(pairs, names):  # zero-initialised vectors drawn, so their cotangents are not trivial
        return {k: ((torch.tensor(f(*v[0].shape)) * 0.3, v[1]) if k in names else v) for k, v in pairs.items()}

    def init(fn, *args):
        params, specs = fn(torch.Generator().manual_seed(5), *args)
        return {k: (params[k], specs[k]) for k in params}

    d_model, s = 32, 8

    def attend(params, x, **kw):
        pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
        return attention.multihead_attention(params, x, pos, n_heads=2, n_kv_heads=1, rope_theta=10000.0, **kw)[0]

    layer("attn_q_heads", init(attention.attention_init, d_model, 2, 1, 16, torch.float32), attend,
          f(N, s, d_model), f(N, s, d_model))
    hd = init(attention.attention_init, d_model, 2, 1, 16, torch.float32, "head_dim")
    layer("attn_head_dim", hd, attend, f(N, s, d_model), f(N, s, d_model))
    layer("attn_head_dim_chunked", hd, attend, f(N, CHUNKED_S, d_model), f(N, CHUNKED_S, d_model))
    layer("moe", init(moe.moe_init, d_model, 16, 4, torch.float32),
          lambda prm, x: moe.moe(prm, x, top_k=2)[0], f(N, s, d_model), f(N, s, d_model))
    layer("mamba", randomized(init(mamba.mamba_init, d_model, 4, 4, 2, torch.float32), ("conv_b", "dt_bias")),
          lambda prm, x: mamba.mamba(prm, x, 4), f(N, s, d_model), f(N, s, d_model))
    layer("rwkv_time", randomized(init(rwkv.rwkv_time_mix_init, d_model, 16, 8, torch.float32), ("w0", "bonus_u")),
          lambda prm, x: rwkv.rwkv_time_mix(prm, x, 16), f(N, s, d_model), f(N, s, d_model))
    layer("rwkv_channel", init(rwkv.rwkv_channel_mix_init, d_model, 64, torch.float32), rwkv.rwkv_channel_mix,
          f(N, s, d_model), f(N, s, d_model))
    return out


def batches(arch, steps: int) -> list[dict]:
    """``steps`` batches of 2 rows a device block, 16 tokens, and for the
    vlm and audio families a seeded ``frontend``."""
    from repro_torch.data.synthetic import lm_batch_for_devices

    out = []
    for i in range(steps):
        gen = torch.Generator().manual_seed(100 + i)
        b = {k: v.reshape(-1, 16) for k, v in lm_batch_for_devices(gen, arch.vocab, n_subsets=N, per_subset=2,
                                                                   seq_len=16, sigma_h=0.5).items()}
        if arch.encoder is not None:
            enc = arch.encoder
            b["frontend"] = torch.randn((N * 2, enc.n_frontend_tokens, enc.d_frontend), generator=gen)
        out.append(b)
    return out


def run_configs(mesh, arch=None, configs=None) -> dict[str, dict]:
    """{config: {losses, params (flat, gathered), stored bytes}} on ``mesh``
    (``ARCH()`` and ``CONFIGS`` unless given)."""
    from repro_torch import models
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.coding import flatten_pytree
    from repro_torch.launch import train
    from repro_torch.models.module import tree_bytes

    arch = arch or ARCH()
    out = {}
    for name, kw in (configs or CONFIGS).items():
        tcfg = TrainConfig(arch=arch.name, **{**_BASE, **kw})
        whole, specs = models.init(torch.Generator().manual_seed(0), arch)
        step, opt = train.build_train_step(arch, tcfg, specs, mesh=mesh, device="cpu")
        params = train.shard_tree(whole, step.placements, mesh)
        state, losses = opt.init(params), []
        for i, b in enumerate(batches(arch, STEPS)):
            params, state, loss, _ = step(params, state, b, i)
            losses.append(float(loss))
        stored = tree_bytes(params) + sum(tree_bytes(m) for m in (state.mu, state.nu) if m != ())
        out[name] = {"loss": np.asarray(losses), "stored": np.asarray(stored),
                     "params": flatten_pytree(train.gather_tree(params, step.placements, mesh))[0].numpy()}
    return out


def _tree(flat: dict[str, np.ndarray]) -> dict:
    """A nested dict from ``{"a/b": array}``."""
    out: dict = {}
    for path, a in flat.items():
        *keys, last = path.split("/")
        node = out
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = a
    return out


def run_reference_inputs(mesh, out_dir: Path) -> dict[str, np.ndarray]:
    """Each tag of ``tags.json``: the port's losses from the reference's
    initial weights and batches; and each ``family/tag`` of the
    ``family_{family}.npz`` files there under ``FAMILY_TAGS``."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs.archs import ARCHS, reduced
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train

    tags = json.loads((out_dir / "tags.json").read_text())
    inputs = np.load(out_dir / "inputs.npz")
    params0 = _tree({k[len("param/"):]: inputs[k] for k in inputs.files if k.startswith("param/")})
    steps = sorted({int(k.split("/")[0][len("batch"):]) for k in inputs.files if k.startswith("batch")})
    batch_list = [{k: torch.from_numpy(inputs[f"batch{i}/{k}"]) for k in ("tokens", "labels")} for i in steps]
    arch = reduced(ARCHS["smollm-360m"])
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    out = {}
    for tag, kw in tags.items():
        tcfg = TrainConfig(**{k: v for k, v in kw.items() if k in fields})
        step, opt = train.build_train_step(arch, tcfg, None, mesh=mesh, device="cpu")
        params = convert.lm_params_from_numpy(params0, placements=step.placements, mesh=mesh)
        state, losses = opt.init(params), []
        for i, b in enumerate(batch_list):
            params, state, loss, _ = step(params, state, b, i)
            losses.append(float(loss))
        out[tag] = np.asarray(losses)
    for fam, arch in FAMILIES().items():
        path = out_dir / f"family_{fam}.npz"
        if not path.exists():
            continue
        inputs = np.load(path)
        params0 = _tree({k[len("param/"):]: inputs[k] for k in inputs.files if k.startswith("param/")})
        steps = sorted({int(k.split("/")[0][len("batch"):]) for k in inputs.files if k.startswith("batch")})
        batch_list = [{k.split("/")[1]: torch.from_numpy(inputs[k]) for k in inputs.files
                       if k.startswith(f"batch{i}/")} for i in steps]
        for tag, kw in FAMILY_TAGS.items():
            step, opt = train.build_train_step(arch, TrainConfig(arch=arch.name, **kw), None, mesh=mesh,
                                               device="cpu")
            params = convert.lm_params_from_numpy(params0, placements=step.placements, mesh=mesh)
            state, losses = opt.init(params), []
            for i, b in enumerate(batch_list):
                params, state, loss, _ = step(params, state, b, i)
                losses.append(float(loss))
            out[f"{fam}/{tag}"] = np.asarray(losses)
    return out


LAYOUTS = {"2x2": dict(data=2, model=2), "pod2x1x2": dict(data=1, model=2, pod=2),
           "pod2x2x1": dict(data=2, model=1, pod=2)}


def _layout() -> dict[str, np.ndarray]:
    """Per layout: (data ranks, data rank, model ranks, model rank), and the
    global ranks of this rank's data and model groups (-1: no group)."""
    from repro_torch.launch.mesh import make_host_mesh

    def ranks(group, n):
        return torch.distributed.get_process_group_ranks(group) if group is not None else [-1] * n

    out = {}
    for name, kw in LAYOUTS.items():
        m = make_host_mesh(**kw)
        out[f"{name}/shape"] = np.asarray([m.world, m.rank, m.model, m.model_rank, m.local_devices])
        out[f"{name}/data_group"] = np.asarray(ranks(m.group, m.world))
        out[f"{name}/model_group"] = np.asarray(ranks(m.model_group, m.model))
    return out


def spawn(mode: str, world: int, model: int, out: Path) -> list:
    """Run ``mode`` on ``world`` fresh ranks (one thread each, 300 s each)
    and return each rank's results."""
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent.parent / "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(out), str(r), str(world), str(model)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, err in zip(procs, errs):
        if p.returncode != 0:
            raise RuntimeError(f"a {mode} rank exited {p.returncode}: {err[-4000:]}")
    return [np.load(out / f"rank{r}.npz") for r in range(world)]


def main(mode: str, out_dir: str, rank: int, world: int, model: int) -> None:
    torch.set_num_threads(1)
    out = Path(out_dir)
    torch.distributed.init_process_group("gloo", init_method=f"file://{out / 'rendezvous'}", world_size=world,
                                         rank=rank)
    try:
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(N, model) if mode != "layout" else None
        if mode == "layout":
            res = _layout()
        elif mode == "ops":
            res = _ops(mesh)
        elif mode == "ops-cuda":
            res = run_tp_ops(op_protocol(mesh.model), mesh, device="cuda")
        elif mode == "step":
            res = {f"{k}/{f}": v for k, d in run_configs(mesh).items() for f, v in d.items()}
        elif mode == "families":
            res = {f"{fam}/{k}/{f}": v for fam, arch in FAMILIES().items()
                   for k, d in run_configs(mesh, arch, FAMILY_CONFIGS).items() for f, v in d.items()}
        elif mode == "reference":
            res = run_reference_inputs(mesh, out)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        np.savez(out / f"rank{rank}.npz", **res)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]))
