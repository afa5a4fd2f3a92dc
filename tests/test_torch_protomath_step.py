"""The port's ``"protomath"`` train step against the reference's, and
across ranks of a ``gloo`` group, on the CPU.

(a) The reference ``Trainer`` on an Auto-axis (4, 2) mesh over 8 virtual
    CPU devices (jax's default Explicit axes refuse protomath's sharding
    constraints, ROADMAP C.4), with tests/test_distributed.py's
    configurations, ``reduced(smollm-360m)``, batches and 5 steps, in one
    subprocess; in the same process the port's step, N=4 on one rank, from
    the reference's initial weights (carried across by ``convert``) on the
    same batches. The honest, LAD (CWTM under sign-flip, d=2, 2
    microbatches), mean-attacked and gather runs are key-free: their
    losses agree within relative 2e-6. Com-LAD's random sparsification
    draws from keys the port cannot replay (ROADMAP C.9): the port's run
    is held to "trains", the bound the reference's test holds its own to.
    The same runs on data x model = 2 x 2 (4 ``gloo`` ranks,
    tests/torch_tp_ranks.py, from the initial weights, batches and
    configurations the reference subprocess leaves behind) are held to the
    same reference losses: relative 2e-6, Com-LAD "trains". So is every
    family the model axis cuts (``torch_tp_ranks.FAMILIES``: ``lm_arch()``
    with its one kv head whole, ``zoo_arch``'s moe, jamba, rwkv, cross and
    audio, and ``attn_tp="head_dim"``): the reference ``Trainer`` on the
    same (4, 2) mesh, 3 steps of the honest run and of LAD (CWTM under
    sign-flip), from its own initial weights and batches (with a seeded
    ``frontend`` for cross and audio), in three more subprocesses started
    beside the first (each family's compilation takes most of its time);
    the port's 2 x 2 runs ride on the same spawn of the 4 ranks.
(b) The port's step on 2 and 4 ``gloo`` ranks (tests/torch_protomath_ranks.py:
    ``lm_arch()`` and ``zoo_arch("jamba")``, one process a rank, joined
    through a file under the test's temporary directory) against the same
    run on one rank at the same N=4: every rank ends with the same
    parameters bit for bit; the losses agree within relative 2e-6 and the
    parameters within 1e-6 of their largest magnitude (a rank sums its
    lookups' gradients with an ``all_reduce``, and its loss is its blocks'
    mean, so the last bits differ); under QSGD a rounding difference can
    move one stochastic rounding by a level: at most 8 parameters lie
    farther.
(c) On each group, the ``sharded`` server bit for bit the ``gather`` one:
    CWTM under ALIE with 2 microbatches, CWTM-NNM under sign-flip, and
    CWTM under the gaussian attack with QSGD.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch_protomath_ranks as ranks
import torch_tp_ranks

REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL = 2e-6

_SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    import json, dataclasses, sys, time
    from pathlib import Path
    import jax, jax.numpy as jnp, numpy as np, torch
    from jax.sharding import AxisType
    from repro import models
    from repro.configs.archs import ARCHS, reduced
    from repro.configs.base import TrainConfig
    from repro.launch.train import Trainer
    from repro.data.synthetic import lm_batch_for_devices
    from repro_torch import convert
    from repro_torch.configs.archs import ARCHS as TARCHS, reduced as treduced
    from repro_torch.configs.base import TrainConfig as TTrainConfig
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_host_mesh as port_mesh

    torch.set_num_threads(2)
    mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2, devices=jax.devices())
    cfg, tcfg_arch = reduced(ARCHS["smollm-360m"]), treduced(TARCHS["smollm-360m"])
    out, tags, shared = {}, {}, Path(sys.argv[1])

    def run(tag, reference=True, **kw):
        start = time.perf_counter()
        tcfg = TrainConfig(arch=cfg.name, lr=1e-3, steps=5, remat=True, seed=0, **kw)
        params0, specs = jax.device_get(models.init(jax.random.PRNGKey(tcfg.seed), cfg))
        key = jax.random.PRNGKey(0)
        batches = []
        for i in range(tcfg.steps):
            b = lm_batch_for_devices(jax.random.fold_in(key, i), cfg.vocab, n_subsets=4, per_subset=2, seq_len=32,
                                     sigma_h=0.5)
            batches.append({k: np.asarray(v).reshape(-1, v.shape[-1]) for k, v in b.items()})
        tags[tag] = dataclasses.asdict(tcfg)  # the tp ranks' runs read these, and the inputs below
        if not (shared / "inputs.npz").exists():
            np.savez(shared / "inputs.npz",
                     **{"param/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
                        for path, leaf in jax.tree_util.tree_flatten_with_path(params0)[0]},
                     **{f"batch{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
        ref = None
        if reference:
            tr = Trainer(cfg=cfg, tcfg=tcfg, mesh=mesh)
            ref = [l for _, l in tr.run(iter(batches), log_every=1)]
        fields = {f.name for f in dataclasses.fields(TTrainConfig)}
        step, opt = ttrain.build_train_step(
            tcfg_arch, TTrainConfig(**{k: v for k, v in dataclasses.asdict(tcfg).items() if k in fields}), specs,
            mesh=port_mesh(4), device="cpu")
        params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params0))
        state, port = opt.init(params), []
        for i, b in enumerate(batches):
            params, state, loss, _ = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()}, i)
            port.append(float(loss))
        out[tag] = {"reference": ref, "port": port, "s": time.perf_counter() - start}

    run("honest", protocol="none", optimizer="adamw")
    run("lad", protocol="lad", d=2, aggregator="cwtm", trim_frac=0.25, n_byz=1,
        attack="sign_flip", server="sharded", optimizer="adamw", microbatches=2)
    run("mean_attacked", protocol="lad", d=1, aggregator="mean", n_byz=1,
        attack="sign_flip", server="sharded", optimizer="adamw")
    run("lad_gather", protocol="lad", d=2, aggregator="cwtm", trim_frac=0.25,
        n_byz=1, attack="sign_flip", server="gather", optimizer="adamw", microbatches=2)
    run("com_lad", reference=False, protocol="lad", d=2, aggregator="cwtm", trim_frac=0.25,
        n_byz=1, attack="sign_flip", server="sharded", compression="rand_sparse",
        q_hat_frac=0.5, optimizer="adamw", microbatches=2)
    (shared / "tags.json").write_text(json.dumps(tags))
    print("RESULT::" + json.dumps(out))
    """
)


_FAMILY_SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    import json, sys
    from pathlib import Path
    import jax, numpy as np
    from jax.sharding import AxisType
    from repro import models
    from repro.configs.base import TrainConfig
    from repro.core.scenarios import lm_arch, zoo_arch
    from repro.data.synthetic import lm_batch_for_devices
    from repro.launch.train import Trainer

    mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2, devices=jax.devices())
    shared, families, tags = Path(sys.argv[1]), sys.argv[2].split(","), json.loads(sys.argv[3])
    out = {}
    for fam in families:
        cfg = {"lm": lm_arch(), "head_dim": lm_arch().scaled(attn_tp="head_dim")}.get(fam) or zoo_arch(fam)
        params0, _ = jax.device_get(models.init(jax.random.PRNGKey(0), cfg))
        rng, batches = np.random.default_rng(3), []
        for i in range(3):
            b = lm_batch_for_devices(jax.random.fold_in(jax.random.PRNGKey(0), i), cfg.vocab, n_subsets=4,
                                     per_subset=2, seq_len=16, sigma_h=0.5)
            b = {k: np.asarray(v).reshape(-1, v.shape[-1]) for k, v in b.items()}
            if cfg.encoder is not None:
                enc = cfg.encoder
                b["frontend"] = rng.standard_normal((8, enc.n_frontend_tokens, enc.d_frontend)).astype(np.float32)
            batches.append(b)
        tmp = shared / f"family_{fam}.{os.getpid()}.npz"  # two processes may write it: the same bits, renamed
        np.savez(tmp, **{"param/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
                         for path, leaf in jax.tree_util.tree_flatten_with_path(params0)[0]},
                 **{f"batch{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
        os.replace(tmp, shared / f"family_{fam}.npz")
        for tag, kw in tags.items():
            tr = Trainer(cfg=cfg, tcfg=TrainConfig(arch=cfg.name, **kw), mesh=mesh)
            out[f"{fam}/{tag}"] = [l for _, l in tr.run(iter(batches), log_every=1)]
    print("RESULT::" + json.dumps(out))
    """
)
# the families' reference runs, four subprocesses of about the same length: (families, tags)
FAMILY_GROUPS = ((("jamba",), ("honest",)), (("jamba",), ("lad",)), (("rwkv", "cross", "audio"), None),
                 (("lm", "moe", "head_dim"), None))


@pytest.fixture(scope="module")
def reference_dir(tmp_path_factory):
    """Where the reference subprocesses leave their initial weights, batches
    and configurations for the 2 x 2 tp ranks."""
    return tmp_path_factory.mktemp("reference")


@pytest.fixture(scope="module")
def reference_runs(reference_dir):
    """The reference's runs: ``_SCRIPT``'s, and the families' (one
    ``_FAMILY_SCRIPT`` a group of ``FAMILY_GROUPS``, ``None`` its every
    tag), all started at once:
    (the first's result, {family/tag: losses})."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    tags = torch_tp_ranks.FAMILY_TAGS
    cmds = [[sys.executable, "-c", _SCRIPT, str(reference_dir)]]
    cmds += [[sys.executable, "-c", _FAMILY_SCRIPT, str(reference_dir), ",".join(families),
              json.dumps({t: tags[t] for t in (group_tags or tags)})] for families, group_tags in FAMILY_GROUPS]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
             for cmd in cmds]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, stderr[-4000:]
        line = [ln for ln in stdout.splitlines() if ln.startswith("RESULT::")][0]
        results.append(json.loads(line[len("RESULT::"):]))
    return results[0], {k: v for r in results[1:] for k, v in r.items()}


@pytest.fixture(scope="module")
def against_reference(reference_runs):
    return reference_runs[0]


@pytest.fixture(scope="module")
def tp_against_reference(against_reference, reference_dir):
    """The same runs as the port's one-rank step, on data x model = 2 x 2
    (4 gloo ranks, tests/torch_tp_ranks.py), from the reference's weights
    and batches: {tag: losses}."""
    res = torch_tp_ranks.spawn("reference", 4, 2, reference_dir)
    for r in res[1:]:
        for tag in res[0].files:
            assert np.array_equal(r[tag], res[0][tag]), tag
    return {tag: res[0][tag] for tag in res[0].files}


@pytest.mark.parametrize("tag", list(torch_tp_ranks.FAMILY_TAGS))
@pytest.mark.parametrize("family", list(torch_tp_ranks.FAMILIES()))
def test_tp_families_match_reference_trainer(reference_runs, tp_against_reference, family, tag):
    """Every family at data x model = 2 x 2 against the reference
    ``Trainer`` on its (4, 2) mesh, from the reference's initial weights and
    batches."""
    ref, port = np.asarray(reference_runs[1][f"{family}/{tag}"]), tp_against_reference[f"{family}/{tag}"]
    assert ref.shape == port.shape == (3,)
    rel = np.abs(port - ref) / np.abs(ref)
    assert rel.max() <= LOSS_RTOL, (family, tag, ref.tolist(), port.tolist(), rel.tolist())


@pytest.mark.parametrize("tag", ["honest", "lad", "mean_attacked", "lad_gather"])
def test_tp_losses_match_reference_trainer(against_reference, tp_against_reference, tag):
    """The port's step at data x model = 2 x 2 against the reference
    ``Trainer`` on its (4, 2) mesh (model = 2 there too)."""
    ref, port = np.asarray(against_reference[tag]["reference"]), tp_against_reference[tag]
    assert ref.shape == port.shape == (5,)
    rel = np.abs(port - ref) / np.abs(ref)
    assert rel.max() <= LOSS_RTOL, (tag, ref.tolist(), port.tolist(), rel.tolist())


def test_tp_com_lad_trains(tp_against_reference):
    h = tp_against_reference["com_lad"]
    assert h[-1] < h[0] - 0.2, h


@pytest.mark.parametrize("tag", ["honest", "lad", "mean_attacked", "lad_gather"])
def test_losses_match_reference_trainer(against_reference, tag):
    ref, port = (np.asarray(against_reference[tag][k]) for k in ("reference", "port"))
    assert ref.shape == port.shape == (5,)
    rel = np.abs(port - ref) / np.abs(ref)
    assert rel.max() <= LOSS_RTOL, (tag, ref.tolist(), port.tolist(), rel.tolist())


def test_com_lad_trains(against_reference):
    """tests/test_distributed.py's bound for Com-LAD, in the port."""
    h = against_reference["com_lad"]["port"]
    assert h[-1] < h[0] - 0.2, h


def test_lad_beats_mean_under_attack(against_reference):
    """tests/test_distributed.py's ordering, in the port."""
    assert against_reference["lad"]["port"][-1] < against_reference["mean_attacked"]["port"][-1] + 0.05


@pytest.fixture(scope="module")
def one_rank():
    from repro_torch.launch.mesh import make_host_mesh

    return ranks.run_configs(make_host_mesh(ranks.N))


def _run_ranks(world: int, out: Path) -> list:
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(Path(ranks.__file__)), str(out), str(r), str(world)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    return [np.load(out / f"rank{r}.npz") for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4], ids=["2-ranks", "4-ranks"])
def group_run(request, tmp_path_factory):
    return request.param, _run_ranks(request.param, tmp_path_factory.mktemp(f"gloo{request.param}"))


@pytest.mark.parametrize("name", list(ranks.CONFIGS))
def test_ranks_equal_one_rank(group_run, one_rank, name):
    world, res = group_run
    for r in res[1:]:  # every rank steps to the same parameters
        assert np.array_equal(r[f"{name}/params"], res[0][f"{name}/params"]), (world, name)
    loss, params = res[0][f"{name}/loss"], res[0][f"{name}/params"]
    want_loss, want_params = np.asarray(one_rank[name][0]), one_rank[name][1]
    assert (np.abs(loss - want_loss) / np.abs(want_loss)).max() <= LOSS_RTOL, (name, loss, want_loss)
    far = np.abs(params - want_params) > 1e-6 * np.abs(want_params).max()
    assert far.sum() <= (8 if "quant" in name else 0), (world, name, int(far.sum()))


@pytest.mark.parametrize("pair", [("cwtm-alie-sharded-mb2", "cwtm-alie-gather-mb2"),
                                  ("nnm-sign_flip-sharded", "nnm-sign_flip-gather"),
                                  ("quant-gaussian-sharded", "quant-gaussian-gather")], ids=["cwtm", "nnm", "quant"])
def test_sharded_server_is_bitwise_gather(group_run, pair):
    world, res = group_run
    for key in ("params", "loss"):
        assert np.array_equal(res[0][f"{pair[0]}/{key}"], res[0][f"{pair[1]}/{key}"]), (world, pair, key)


def test_sharded_dim_and_mesh():
    """The sharded server cuts a leaf's fsdp dim where it divides by the
    ranks, the dim ``logical_to_mesh`` places on the data axis;
    ``make_host_mesh`` holds N over one rank without a group, and refuses
    an N that does not split and a model axis with no ranks for it."""
    from repro_torch.core.protomath import sharded_dim
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import train

    assert sharded_dim(("fsdp", "tp"), (8, 3), 4) == 0
    assert sharded_dim(("tp", "fsdp"), (8, 6), 4) is None
    assert sharded_dim(None, (8,), 1) is None
    m = tmesh.make_host_mesh(8)
    assert (m.world, m.rank, m.local_devices, tmesh.n_data_devices(m), m.group) == (1, 0, 8, 8, None)
    import torch
    from repro_torch import models
    from repro_torch.core import scenarios

    params, specs = models.init(torch.Generator().manual_seed(0), scenarios.lm_arch())
    dims = train.param_pspecs(specs, tmesh.abstract_mesh(4), params)
    assert dims["embed"]["table"] == ("model", "data") and dims["ln_f"] == (None,)  # a 1-rank axis divides
    assert dims["periods"]["blk0"]["mlp"]["w_down"] == (None, "model", "data")  # ("stack", "tp", "fsdp")
    w_down = params["periods"]["blk0"]["mlp"]["w_down"]
    assert sharded_dim(("tp", "fsdp"), w_down.shape[1:], 4) == 1  # the per-period leaf's "data" dim
    for call in (lambda: tmesh.make_host_mesh(4, 2), lambda: tmesh.make_host_mesh(0)):
        with pytest.raises(ValueError, match="split"):
            call()
