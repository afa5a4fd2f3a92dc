"""The port's engine over the ranks of a ``gloo`` group, on the CPU: the
sharded engine train step (``TrainConfig.shard``) and the sharded grids
(``run_grid``/``run_lm_grid(shard=)``), the twins of
tests/test_train_engine_shard.py and tests/test_shard_grid.py.

One module fixture starts tests/torch_engine_ranks.py once a rank for 1,
2, 3 and 4 ranks, one world after another (one process a rank, one
thread each, joined through a file under the test's temporary
directory), then the reference's sharded step in a subprocess. Each
process has a time limit, so a hung collective costs this module, not the
suite.

  * The one-rank run under ``shard="none"`` is the baseline. Every rank of
    every world, under ``"shard_map"`` (and ``"pmap"``), equals it bit for
    bit: every step's loss and metrics, the final params and optimizer
    state, at N = 10 (padded to 12 over 4 ranks, to 12 over 3) and 16,
    with 2 microbatches under QSGD (``quant:4``, bf16 moments), and on
    ``zoo_arch("audio")`` with its ``frontend`` leaf (C.10 across ranks).
  * ``Trainer(mesh=make_host_mesh(12))`` with ``n_subsets=None`` takes N
    from the mesh and trains over the ranks, bit for bit the unsharded
    Trainer at N=12.
  * ``run_grid(shard=)`` over 5 linear-regression lanes and 2
    participation lanes (lane counts that 2, 3 and 4 do not divide), whole
    and in chunks of one lane a rank, and ``run_lm_grid(shard=)`` over 3
    rows: every real lane bit for bit its unsharded value; on 4 ranks, the
    same over a 2-rank subgroup passed as ``group=``.
  * chip_smoke.py's ``rank_split_round``, which measures the rank split
    on the card, run here: the round as 2, 3 and 4 ranks compute it bit for
    bit the unsharded round.
  * Against the reference: its ``build_engine_step(shard="shard_map")`` at
    N=10 on 8 virtual CPU devices
    (``XLA_FLAGS=--xla_force_host_platform_device_count=8``), from its
    ``PRNGKey(0)`` weights, against the port on each world from the same
    weights (carried across by ``convert``) under the reference's replayed
    round keys: every step's loss within relative 2e-6.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_engine_ranks as ranks
from repro import models as jmodels
from repro.core import scenarios as jscn
from repro_torch import convert, models, pytree
from repro_torch.configs.base import TrainConfig
from repro_torch.core import engine as tengine
from repro_torch.core import scenarios as tscn
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh
from test_torch_protocol import jax_round_randomness

REPO = Path(__file__).resolve().parent.parent
WORLDS = (1, 2, 3, 4)
LOSS_RTOL = 2e-6
TIMEOUT = 300

_REFERENCE = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    import json
    import jax, jax.numpy as jnp
    from repro import models
    from repro.configs.base import TrainConfig
    from repro.core import engine, scenarios
    from repro.launch import train
    from repro.launch.mesh import make_host_mesh
    import torch_engine_ranks as ranks

    assert engine.engine_device_count() == 8
    cfg = scenarios.lm_arch()
    tcfg = TrainConfig(arch=cfg.name, **{**ranks.BASE, "n_subsets": ranks.N, "shard": "shard_map"})
    params, specs = models.init(jax.random.PRNGKey(0), cfg)
    step, opt = train.build_train_step(cfg, tcfg, make_host_mesh(1, 1), specs)
    state, losses = opt.init(params), []
    for i, b in enumerate(ranks.batches(cfg, ranks.N)):
        params, state, loss, _ = step(params, state, {k: jnp.asarray(v) for k, v in b.items()},
                                      jnp.asarray(i, jnp.int32))
        losses.append(float(loss))
    print("RESULT::" + json.dumps(losses))
    """
)


def _shared_inputs(out: Path) -> None:
    """The reference's ``PRNGKey(0)`` weights of ``lm_arch()`` and its round
    keys ``fold_in(fold_in(PRNGKey(seed), i), 0)`` replayed as the port's
    records, written for the ranks to load."""
    params, _ = jmodels.init(jax.random.PRNGKey(0), jscn.lm_arch())
    tparams = convert.lm_params_from_numpy(jax.device_get(params))
    q = sum(v.numel() for v in pytree.leaves(tparams))
    tcfg = TrainConfig(**{**ranks.BASE, "n_subsets": ranks.N})
    pcfg = train.make_round_config(tcfg, ranks.N)
    base = jax.random.PRNGKey(tcfg.seed)
    flat = {}
    for i in range(ranks.STEPS):
        rec = jax_round_randomness(pcfg, jax.random.fold_in(jax.random.fold_in(base, i), 0), q)
        for f in dataclasses.fields(rec):
            v = getattr(rec, f.name)
            if v is not None:
                flat[f"{i}/0/{f.name}"] = v.contiguous()
    torch.save(tparams, out / "params.pt")
    torch.save(flat, out / "records.pt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks, then the reference's sharded step:
    ``{"worlds": {world: [rank's npz]}, "reference": losses}``."""
    shared = tmp_path_factory.mktemp("shared")
    _shared_inputs(shared)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]),
           "OMP_NUM_THREADS": "1"}
    dirs = {w: tmp_path_factory.mktemp(f"gloo{w}") for w in WORLDS}
    for w in WORLDS:
        procs = [subprocess.Popen([sys.executable, str(Path(ranks.__file__)), str(dirs[w]), str(r), str(w),
                                   str(shared)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(w)]
        try:
            for p in procs:
                _, err = p.communicate(timeout=TIMEOUT)
                assert p.returncode == 0, (w, err[-4000:])
        finally:
            for p in procs:
                p.kill()
    proc = subprocess.run([sys.executable, "-c", _REFERENCE], env={**env, "JAX_PLATFORMS": "cpu"},
                          capture_output=True, text=True, timeout=TIMEOUT, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT::")][0]
    return {"worlds": {w: [np.load(dirs[w] / f"rank{r}.npz") for r in range(w)] for w in WORLDS},
            "reference": np.asarray(json.loads(line[len("RESULT::"):]))}


def _baseline(runs, key: str) -> np.ndarray:
    return runs["worlds"][1][0][f"none/{key}"]


def _assert_equal_to_baseline(runs, world: int, prefix: str, base_prefix: str | None = None) -> int:
    """Every rank's ``prefix/...`` arrays bit for bit the one-rank
    ``shard="none"`` run's; returns how many were compared."""
    n = 0
    for r, res in enumerate(runs["worlds"][world]):
        keys = [k for k in res.files if k.startswith(prefix + "/")]
        assert keys, (world, prefix)
        for k in keys:
            want = _baseline(runs, k if base_prefix is None else base_prefix + k[len(prefix):])
            assert np.array_equal(res[k], want), (world, r, k, float(np.abs(res[k] - want).max()))
            n += 1
    return n


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(ranks.STEP_CONFIGS))
def test_sharded_step_equals_unsharded_bitwise(runs, world, name):
    """Loss and metrics of every step, final params and optimizer state."""
    assert _assert_equal_to_baseline(runs, world, f"step/{name}") == 4 * world


@pytest.mark.parametrize("world", WORLDS)
def test_trainer_takes_n_from_the_mesh_and_trains_over_ranks(runs, world):
    assert _assert_equal_to_baseline(runs, world, "trainer") == 2 * world


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("grid", ["grid", "grid_chunked", "lm_grid"])
def test_sharded_grid_lanes_equal_unsharded_bitwise(runs, world, grid):
    """Every row's final iterate, every metric and the participation
    state; the grid spread over ``world`` devices."""
    rows = ranks.grid_rows() if grid != "lm_grid" else ranks.lm_grid_rows()
    _assert_equal_to_baseline(runs, world, grid, "grid" if grid == "grid_chunked" else None)
    for res in runs["worlds"][world]:
        assert all(f"{grid}/{r.name}/x" in res.files for r in rows), (world, grid)
        assert int(res["grid_devices"]) == world


@pytest.mark.parametrize("grid", ["grid", "lm_grid"])
def test_sharded_grid_over_a_subgroup_equals_unsharded_bitwise(runs, grid):
    """On 4 ranks, ``group=`` a 2-rank subgroup ({0, 1} or {2, 3}): each
    subgroup spreads the grid over its own 2 ranks, every lane bit for bit
    its unsharded value."""
    rows = ranks.grid_rows() if grid == "grid" else ranks.lm_grid_rows()
    n = _assert_equal_to_baseline(runs, ranks.SUBGROUP_WORLD, f"subgroup_{grid}", grid)
    assert n >= len(rows) * ranks.SUBGROUP_WORLD
    for res in runs["worlds"][ranks.SUBGROUP_WORLD]:
        assert int(res[f"subgroup_{grid}_devices"]) == len(ranks.SUBGROUPS[0])


@pytest.mark.parametrize("family", ["transformer", "audio"])
def test_rank_split_round_equals_unsharded_round(family):
    """chip_smoke.py's ``rank_split_round`` (which measures the rank split
    on the card) on the CPU: the round at N=10 as 2, 3 and 4 ranks compute
    it, each share run in turn, bit for bit the unsharded round."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.core import byzantine
    from repro_torch.data import synthetic

    arch = tscn.zoo_arch(family)
    params, _ = models.init(torch.Generator().manual_seed(0), arch)
    batch = smoke.train_batches(synthetic, arch, 10, 2, 1)
    if family == "audio":
        batch = smoke.with_frontend(arch, batch, seed=3)
    tcfg = smoke.train_tcfg(train, arch)
    pcfg = train.make_round_config(tcfg, 10)
    q = sum(v.numel() for v in pytree.leaves(params))
    rand = byzantine.sample_round_randomness(pcfg, q, torch.Generator().manual_seed(5))
    args = (train, tengine, arch, pcfg, torch.device("cpu"), params, train.block_batch(batch[0], 10), rand)
    worlds = smoke.rank_split_round(*args, (2, 3, 4))
    assert {w: r["bitwise"] for w, r in worlds.items()} == {2: True, 3: True, 4: True}, worlds
    assert all(r["g_max_abs_diff"] == 0.0 for r in worlds.values())
    assert tengine.gather_ranks.__module__ == tengine.__name__  # the stand-in is taken out again


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_matches_reference_shard_map(runs, world):
    want = runs["reference"]
    assert want.shape == (ranks.STEPS,)
    for res in runs["worlds"][world]:
        got = res["reference/loss"]
        assert (np.abs(got - want) / np.abs(want)).max() <= LOSS_RTOL, (world, got.tolist(), want.tolist())
        assert np.array_equal(got, runs["worlds"][1][0]["none/reference/loss"])


def test_n_from_the_mesh_and_one_rank_without_a_group():
    """``n_subsets=None`` takes N from ``make_host_mesh(N)``: bit for bit
    the step at ``n_subsets=N``; without a process group the engine has one
    rank and a sharded step is the unsharded one."""
    assert tengine.engine_ranks() == (None, 1, 0)
    x = torch.arange(6.0)
    assert tengine.gather_ranks(x, None, 1) is x
    arch = tscn.lm_arch()
    params, specs = models.init(torch.Generator().manual_seed(0), arch)
    batch = {k: torch.from_numpy(v) for k, v in ranks.batches(arch, 8)[0].items()}
    outs = []
    for kw, mesh in ((dict(n_subsets=8), None), (dict(n_subsets=None), make_host_mesh(8)),
                     (dict(n_subsets=None, shard="shard_map"), make_host_mesh(8))):
        tcfg = TrainConfig(arch=arch.name, **{**ranks.BASE, **kw})
        step, opt = train.build_train_step(arch, tcfg, specs, mesh=mesh, device="cpu")
        outs.append(step(params, opt.init(params), batch, 0))
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(pytree.leaves((outs[0][0], outs[0][1].mu, outs[0][2])),
                                                     pytree.leaves((other[0], other[1].mu, other[2]))))


@pytest.mark.parametrize("case", ["grid-mode", "step-mode", "protomath", "graph", "no-n"])
def test_sharded_refusals(case):
    """An unknown shard mode (the reference's messages), ``shard=`` on the
    protomath step, graph mode of the sharded engine step (ROADMAP A.14)
    and no N at all."""
    arch = tscn.lm_arch()
    want = {"grid-mode": "unknown shard mode 'gspmd'", "step-mode": "unknown engine shard mode 'gspmd'",
            "protomath": "engine-path option", "graph": "A.14", "no-n": "no mesh"}[case]
    with pytest.raises(ValueError, match=want):
        if case == "grid-mode":
            tscn.run_grid(tscn.synthetic_sweep(2), 2, dim=4, device="cpu", mode="loop", shard="gspmd")
        elif case == "step-mode":
            train.build_engine_step(arch, TrainConfig(**{**ranks.BASE, "n_subsets": 4, "shard": "gspmd"}),
                                    device="cpu")
        elif case == "protomath":
            train.build_train_step(arch, TrainConfig(**{**ranks.BASE, "protocol_impl": "protomath",
                                                        "shard": "shard_map"}), mesh=make_host_mesh(4), device="cpu")
        elif case == "graph":
            train.build_engine_step(arch, TrainConfig(**{**ranks.BASE, "n_subsets": 4, "shard": "pmap"}),
                                    device="cpu", mode="graph")
        else:
            train.build_engine_step(arch, TrainConfig(**{**ranks.BASE, "shard": "shard_map"}), device="cpu")
