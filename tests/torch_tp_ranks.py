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
    and weight cotangent (its cut); and one exchange a compressor of
    ``EXCHANGES`` on this rank's tp slice of ``exchange_inputs()``;
  * ``step``: each of ``CONFIGS`` for ``STEPS`` steps of ``ARCH()`` at
    N=4 from the same seeded weights and batches: its losses, the
    gathered parameters (flat), and the bytes this rank stores (params
    and moments);
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
    block = _half(exchange_inputs(), 1, r)
    for name in EXCHANGES:
        agg = protomath.robust_combine(exchange_protocol(name), torch.tensor(block), ("tp", "fsdp"), seed=9,
                                       model_group=mesh.model_group, cut=("model", None))
        out[f"exchange/{name}"] = agg.numpy()
    return out


def batches(arch, steps: int) -> list[dict]:
    from repro_torch.data.synthetic import lm_batch_for_devices

    return [{k: v.reshape(-1, 16) for k, v in lm_batch_for_devices(
        torch.Generator().manual_seed(100 + i), arch.vocab, n_subsets=N, per_subset=2, seq_len=16,
        sigma_h=0.5).items()} for i in range(steps)]


def run_configs(mesh) -> dict[str, dict]:
    """{config: {losses, params (flat, gathered), stored bytes}} on ``mesh``."""
    from repro_torch import models
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.coding import flatten_pytree
    from repro_torch.launch import train
    from repro_torch.models.module import tree_bytes

    arch = ARCH()
    out = {}
    for name, kw in CONFIGS.items():
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
    initial weights and batches."""
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
        elif mode == "step":
            res = {f"{k}/{f}": v for k, d in run_configs(mesh).items() for f, v in d.items()}
        elif mode == "reference":
            res = run_reference_inputs(mesh, out)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        np.savez(out / f"rank{rank}.npz", **res)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]))
