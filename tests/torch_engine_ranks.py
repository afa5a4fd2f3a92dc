"""The port's engine over the ranks of a ``gloo`` group, on the CPU: the
helper that tests/test_torch_engine_shard.py starts once a rank.

    python tests/torch_engine_ranks.py OUT_DIR RANK WORLD [SHARED_DIR]

Every rank sets one thread, joins the group through a file under
``OUT_DIR`` (no port) and runs, under ``shard="shard_map"`` (``"pmap"``
where a name says so):

  * each of ``STEP_CONFIGS`` for ``STEPS`` engine train steps from the same
    seeded weights and batches (``lm_arch()``, and ``zoo_arch("audio")``
    with its ``frontend``);
  * ``Trainer(mesh=make_host_mesh(TRAINER_N))`` with ``n_subsets=None``:
    N from the mesh (the steps above take the default group, since
    ``make_host_mesh`` holds a whole number of devices a rank and N=10
    pads over 3 or 4 ranks);
  * with ``SHARED_DIR`` (the reference's ``PRNGKey(0)`` weights and its
    replayed round keys, written there by the test), the step on those;
  * ``scenarios.run_grid`` over ``GRID_ROWS`` (5 lanes, and 2
    participation lanes; whole and in chunks of 1 lane a rank) and
    ``run_lm_grid`` over 3 ``lm_sweep`` rows;
  * on 4 ranks, both grids again over the 2-rank subgroup each rank is in
    (``group=``).

One rank (``WORLD == 1``) also runs everything with ``shard="none"``: the
baseline every other world is held to. Each rank writes its results to
``OUT_DIR/rank{RANK}.npz``. The models are small because a collective on a
busy CPU waits until every rank is scheduled.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

N = 10
STEPS = 2
SEQ = 8
BASE = dict(protocol="lad", protocol_impl="engine", d=2, aggregator="cwtm", trim_frac=0.2, n_byz=2,
            attack="sign_flip", optimizer="adamw", lr=3e-3, steps=4, seed=0)
STEP_CONFIGS = {  # name: (zoo family, N, TrainConfig fields)
    "lm-n10": ("transformer", 10, {}),
    "lm-n16": ("transformer", 16, {}),
    "lm-n10-pmap": ("transformer", 10, dict(shard="pmap")),
    "lm-n16-pmap": ("transformer", 16, dict(shard="pmap")),
    "lm-n10-mb2-quant4": ("transformer", 10, dict(microbatches=2, compression="quant:4", momentum_dtype="bfloat16")),
    "audio-n10": ("audio", 10, dict(optimizer="sgd_momentum", lr=1e-2)),
}
TRAINER_N = 12  # splits over 1 to 4 ranks
GRID_STEPS = 4
GRID_DIM = 12
SUBGROUP_WORLD = 4
SUBGROUPS = ((0, 1), (2, 3))


def batches(arch, n: int, rows: int = 1, steps: int = STEPS, seed: int = 42) -> list[dict[str, np.ndarray]]:
    """``steps`` batches of ``n * rows`` rows of ``SEQ`` tokens, with the
    vlm and audio families' ``frontend``, drawn with numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        t = rng.integers(0, arch.vocab, (n * rows, SEQ + 1)).astype(np.int32)
        b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        if arch.family in ("vlm", "audio"):
            enc = arch.encoder
            b["frontend"] = rng.standard_normal((n * rows, enc.n_frontend_tokens, enc.d_frontend)).astype(np.float32)
        out.append(b)
    return out


def _flat(tree) -> np.ndarray:
    from repro_torch import pytree

    return np.concatenate([v.detach().to(torch.float32).reshape(-1).numpy() for v in pytree.leaves(tree)])


def _run_step(arch, tcfg, params, randomness=None) -> dict[str, np.ndarray]:
    """``STEPS`` engine steps (sharded over the default group); every
    step's loss and metrics, the final params and optimizer state, flat."""
    from repro_torch.launch import train

    step, opt = train.build_train_step(arch, tcfg, device="cpu", randomness=randomness)
    state, losses, metrics = opt.init(params), [], []
    for i, b in enumerate(batches(arch, tcfg.n_subsets, max(1, tcfg.microbatches))):
        params, state, loss, met = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()}, i)
        losses.append(float(loss))
        metrics.append([float(met[k]) for k in sorted(met)])
    return {"loss": np.asarray(losses), "metrics": np.asarray(metrics), "params": _flat(params),
            "opt": _flat((state.step, state.mu, state.nu))}


def grid_rows():
    from repro_torch.core import scenarios

    return (scenarios.synthetic_sweep(5, n_devices=10, n_byz=2)
            + scenarios.participation_sweep(schedules=("iid",), aggregators=("decode",), attacks=("sign_flip", "alie"),
                                            n_byz=2))


def lm_grid_rows():
    from repro_torch.core import scenarios

    return scenarios.lm_sweep(methods=(("lad", 2),), attacks=("sign_flip", "alie", "ipm"), compressors=("none",))


def _grid_results(res: dict, tag: str) -> dict[str, np.ndarray]:
    out = {}
    for name, r in res.items():
        out[f"{tag}/{name}/x"] = r.x.numpy()
        for k, v in r.metrics.items():
            out[f"{tag}/{name}/{k}"] = v.numpy()
        if r.participation_state is not None:
            out[f"{tag}/{name}/participation_state"] = r.participation_state.numpy()
    return out


def load_shared(shared: Path):
    """The reference's weights and replayed records the test wrote."""
    from repro_torch.core.byzantine import RoundRandomness

    params = torch.load(shared / "params.pt")
    flat = torch.load(shared / "records.pt")
    recs = {}
    for key, v in flat.items():
        i, j, field = key.split("/")
        recs.setdefault((int(i), int(j)), {})[field] = v
    names = [f.name for f in dataclasses.fields(RoundRandomness)]
    recs = {k: RoundRandomness(**{n: d.get(n) for n in names}) for k, d in recs.items()}
    return params, recs


def run_all(shard: str, shared: Path | None) -> dict[str, np.ndarray]:
    """Every run of the module docstring under ``shard`` (``"none"``: the
    baseline)."""
    from repro_torch import models
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import scenarios
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh

    out = {}

    def put(tag: str, res: dict) -> None:
        out.update({f"{tag}/{k}": v for k, v in res.items()})

    for name, (family, n, kw) in STEP_CONFIGS.items():
        arch = scenarios.zoo_arch(family)
        tcfg = TrainConfig(arch=arch.name, **{**BASE, "n_subsets": n, **kw,
                                             "shard": "none" if shard == "none" else kw.get("shard", shard)})
        params, _ = models.init(torch.Generator().manual_seed(0), arch)
        put(f"step/{name}", _run_step(arch, tcfg, params))

    # the Trainer, N from the mesh
    arch = scenarios.lm_arch()
    if shard == "none":
        tr = train.Trainer(arch, TrainConfig(arch=arch.name, **{**BASE, "n_subsets": TRAINER_N}), device="cpu")
    else:
        tr = train.Trainer(arch, TrainConfig(arch=arch.name, **{**BASE, "n_subsets": None, "shard": shard}),
                           device="cpu", mesh=make_host_mesh(TRAINER_N))
    hist = tr.run(({k: torch.from_numpy(v) for k, v in b.items()} for b in batches(arch, TRAINER_N)), log_every=1)
    put("trainer", {"loss": np.asarray([l for _, l in hist]), "params": _flat(tr.params)})

    if shared is not None:  # the reference's weights and keys
        params, recs = load_shared(shared)
        tcfg = TrainConfig(arch=arch.name, **{**BASE, "n_subsets": N, "shard": shard})
        put("reference", _run_step(arch, tcfg, params, randomness=lambda i, j: recs[(i, j)]))

    kw = dict(dim=GRID_DIM, device="cpu", mode="loop", shard=shard)
    out.update(_grid_results(scenarios.run_grid(grid_rows(), GRID_STEPS, **kw), "grid"))
    if shard != "none":
        out.update(_grid_results(scenarios.run_grid(grid_rows(), GRID_STEPS, max_lanes_per_device=1, **kw),
                                 "grid_chunked"))
    out.update(_grid_results(scenarios.run_lm_grid(lm_grid_rows(), GRID_STEPS - 1, per_subset=1, seq_len=SEQ,
                                                   device="cpu", mode="loop", shard=shard), "lm_grid"))
    return out


def run_subgroups(rank: int) -> dict[str, np.ndarray]:
    """The grids over the 2-rank subgroup this rank is in (ranks {0, 1}
    and {2, 3}), passed as ``group=``: each subgroup runs them on its own."""
    from repro_torch.core import engine, scenarios

    groups = [torch.distributed.new_group(list(r)) for r in SUBGROUPS]  # every rank makes every group
    group = groups[rank // len(SUBGROUPS[0])]
    kw = dict(device="cpu", mode="loop", shard="shard_map", group=group)
    out = _grid_results(scenarios.run_grid(grid_rows(), GRID_STEPS, dim=GRID_DIM, **kw), "subgroup_grid")
    out["subgroup_grid_devices"] = np.asarray(engine.last_grid_chunk_info()["devices"])
    out.update(_grid_results(scenarios.run_lm_grid(lm_grid_rows(), GRID_STEPS - 1, per_subset=1, seq_len=SEQ, **kw),
                             "subgroup_lm_grid"))
    out["subgroup_lm_grid_devices"] = np.asarray(engine.last_grid_chunk_info()["devices"])
    return out


def main(out_dir: str, rank: int, world: int, shared: str | None = None) -> None:
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"file://{Path(out_dir) / 'rendezvous'}",
                                         world_size=world, rank=rank)
    try:
        shared_dir = None if shared is None else Path(shared)
        res = run_all("shard_map", shared_dir)
        if world == 1:
            res.update({f"none/{k}": v for k, v in run_all("none", shared_dir).items()})
        from repro_torch.core import engine

        res["grid_devices"] = np.asarray(engine.last_grid_chunk_info()["devices"])
        if world == SUBGROUP_WORLD:
            res.update(run_subgroups(rank))
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:5])
