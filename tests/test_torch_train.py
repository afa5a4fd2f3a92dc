"""The port's LM train step (``launch.train``) and the engine's optimizers
against the reference, on the CPU.

The step is held to the reference's ``build_train_step(...,
protocol_impl="engine", shard="none")`` at ``lm_arch()``, N=10, LAD d=2,
CWTM under sign-flip (tests/test_train_engine_shard.py's ``_tcfg``), both
sides starting from the reference's ``PRNGKey(0)`` weights (carried across
by ``convert``) on the same numpy-drawn batches, the port replaying the
reference's round keys ``fold_in(fold_in(PRNGKey(seed), step), j)``
(``jax_round_randomness``). AdamW makes an update ``g / (|g| + eps)`` per
coordinate, so a rounding-level difference between the frameworks'
gradients at a coordinate whose gradient is near 0 moves the parameter by
up to a tenth of the step size there: a trajectory is not held parameter by
parameter under AdamW. So:

  (a) SGD-momentum, 3 steps (with ``microbatches=2`` and random
      sparsification too): every step's loss and the final params within
      relative 2e-6, the trajectory standard of tests/test_torch_lm.py;
  (b) AdamW, each step's round and apply on the reference's own params and
      optimizer state: the aggregate and the loss of the port's round, and
      the params and moments of the port's apply on the reference's
      aggregate, within rtol 1e-5 and atol 1e-6 (the per-op standard), a
      bf16 moment within one bf16 ulp on at most 1 % of its elements (see
      tests/test_torch_optim.py);
  (c) AdamW, the loss curve over 3 steps within relative 2e-6 (measured:
      at most 1.1e-7, with fp32 or bf16 moments, one or two microbatches).

``engine.run_trajectory`` under SGD-momentum, AdamW and a schedule is held
to the reference's ``run_trajectory`` on the Section-VII problem the same
way as tests/test_torch_engine.py (relative 2e-6 a round); inside the port,
every ``run_grid`` lane equals its standalone run bit for bit (iterate,
metrics, moments), and ``with_metrics=False`` changes no bit of the final
state.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import engine as jengine
from repro.core import scenarios as jscn
from repro.launch import train as jtrain
from repro.launch.mesh import make_host_mesh
from repro.optim import schedule as jschedule
from repro_torch import convert, models, pytree
from repro_torch.configs.archs import ARCHS, reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import engine as tengine
from repro_torch.core import scenarios as tscn
from repro_torch.core.coding import flatten_pytree
from repro_torch.data.synthetic import lm_batch_for_devices, linreg_loss, linreg_subset_grads
from repro_torch.launch import train
from repro_torch.optim import schedule as tschedule
from test_torch_engine import _replayed, jax_grads, jax_loss, problem  # noqa: F401  (problem: a fixture)
from test_torch_grid import same_bits
from test_torch_optim import _assert_close
from test_torch_protocol import jax_round_randomness

TRAJECTORY_RTOL = 2e-6
RTOL, ATOL = 1e-5, 1e-6
N = 10
STEPS = 3
SEQ = 8


def _kw(**kw) -> dict:
    """tests/test_train_engine_shard.py's ``_tcfg`` at N=10 (unsharded)."""
    base = dict(protocol="lad", protocol_impl="engine", n_subsets=N, d=2, aggregator="cwtm", trim_frac=0.2,
                n_byz=2, attack="sign_flip", optimizer="adamw", lr=3e-3, steps=4)
    base.update(kw)
    return base


def _batches(microbatches: int, seed: int = 42) -> list[dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, jscn.lm_arch().vocab, (N * microbatches, SEQ + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def _blocks(b: dict, rows: int):
    return {k: v.reshape(N, rows, SEQ) for k, v in b.items()}


CASES = {
    "sgd_momentum": dict(optimizer="sgd_momentum", momentum_dtype="float32"),
    "sgd_momentum-mb2-rand_sparse": dict(optimizer="sgd_momentum", momentum_dtype="float32", microbatches=2,
                                         compression="rand_sparse", q_hat_frac=0.5),
    "adamw-fp32": dict(momentum_dtype="float32"),
    "adamw-bf16": dict(momentum_dtype="bfloat16"),
    "adamw-bf16-mb2-rand_sparse": dict(momentum_dtype="bfloat16", microbatches=2, compression="rand_sparse",
                                       q_hat_frac=0.5),
}


@functools.lru_cache(maxsize=None)
def _reference(case: str) -> dict:
    """The reference's run of ``case``: every step's (params, state) from
    ``PRNGKey(0)``'s weights, the losses, its round and apply programs."""
    cfg = jscn.lm_arch()
    jt = JTrainConfig(arch=cfg.name, **_kw(**CASES[case]))
    params, specs = jmodels.init(jax.random.PRNGKey(0), cfg)
    step, opt = jtrain.build_train_step(cfg, jt, make_host_mesh(1, 1), specs)
    state = opt.init(params)
    states, losses = [jax.device_get((params, state))], []
    for i, b in enumerate(_batches(jt.microbatches)):
        params, state, loss, _ = step(params, state, {k: jnp.asarray(v) for k, v in b.items()},
                                      jnp.asarray(i, jnp.int32))
        states.append(jax.device_get((params, state)))
        losses.append(float(loss))
    return {"tcfg": jt, "states": states, "losses": np.array(losses),
            "round": jtrain._engine_round_program(cfg, jt, N, specs), "apply": jtrain._engine_apply_program(jt)}


def _port_tcfg(case: str) -> TrainConfig:
    return TrainConfig(arch=tscn.lm_arch().name, **_kw(**CASES[case]))


def _replay(tcfg: TrainConfig):
    """The reference's round keys, as the port's records."""
    pcfg = train.make_round_config(tcfg, N)
    q = tscn._lm_fns(tscn.lm_arch()).x0.numel()
    base = jax.random.PRNGKey(tcfg.seed)
    return lambda i, j: jax_round_randomness(pcfg, jax.random.fold_in(jax.random.fold_in(base, i), j), q)


def _port_run(case: str):
    tcfg = _port_tcfg(case)
    params0, state0 = _reference(case)["states"][0]
    params = convert.lm_params_from_numpy(params0)
    step, opt = train.build_engine_step(tscn.lm_arch(), tcfg, device="cpu", randomness=_replay(tcfg))
    state = opt.init(params)
    losses = []
    for i, b in enumerate(_batches(tcfg.microbatches)):
        params, state, loss, metrics = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()}, i)
        losses.append(float(loss))
        assert set(metrics) == {"nll", "aux"}
    return params, state, np.array(losses)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(v, np.float32).ravel() for v in jax.tree.leaves(tree)])


@pytest.mark.parametrize("case", ["sgd_momentum", "sgd_momentum-mb2-rand_sparse"])
def test_sgd_momentum_trajectory_matches_reference(case):
    """(a): every step's loss and the final params within relative 2e-6."""
    ref = _reference(case)
    params, state, losses = _port_run(case)
    np.testing.assert_allclose(losses, ref["losses"], rtol=TRAJECTORY_RTOL)
    want_p, want_s = ref["states"][-1]
    got = flatten_pytree(params)[0].numpy()
    np.testing.assert_allclose(got, _flat(want_p), rtol=TRAJECTORY_RTOL,
                               atol=TRAJECTORY_RTOL * float(np.abs(_flat(want_p)).max()))
    np.testing.assert_allclose(flatten_pytree(state.mu)[0].numpy(), _flat(want_s.mu), rtol=TRAJECTORY_RTOL,
                               atol=TRAJECTORY_RTOL * float(np.abs(_flat(want_s.mu)).max()))
    assert int(state.step) == int(want_s.step) == STEPS


@pytest.mark.parametrize("case", ["adamw-fp32", "adamw-bf16"])
def test_adamw_round_and_apply_on_the_reference_state(case):
    """(b): at every step's reference params and state, the port's round
    (aggregate, loss) and the port's apply on the reference's aggregate."""
    ref = _reference(case)
    tcfg = _port_tcfg(case)
    replay = _replay(tcfg)
    round_prog = train._Round(tscn.lm_arch(), train.make_round_config(tcfg, N), torch.device("cpu"))
    apply_prog = train._Apply(tcfg, torch.device("cpu"))
    base = jax.random.PRNGKey(tcfg.seed)
    for i, b in enumerate(_batches(1)):
        params, state = ref["states"][i]
        blocks = _blocks(b, 1)
        jloss, _, jg = ref["round"](params, {k: jnp.asarray(v) for k, v in blocks.items()},
                                   jax.random.fold_in(jax.random.fold_in(base, i), 0))
        tparams = convert.lm_params_from_numpy(params)
        tloss, _, tg = round_prog(tparams, {k: torch.from_numpy(v).long() for k, v in blocks.items()}, replay(i, 0))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL, atol=ATOL, err_msg=f"aggregate {i}")
        jp, js = jax.device_get(ref["apply"](params, state, jg, jnp.asarray(i, jnp.int32)))
        tp, ts = apply_prog(tparams, convert.opt_state_from_numpy(state), torch.from_numpy(np.asarray(jg)),
                            torch.tensor(i, dtype=torch.int32))
        _assert_close(tp, jp, f"params step {i}")
        _assert_close(ts.mu, js.mu, f"moment mu step {i}")
        _assert_close(ts.nu, js.nu, f"moment nu step {i}")
        assert int(ts.step) == int(js.step) == i + 1


@pytest.mark.parametrize("case", ["adamw-fp32", "adamw-bf16", "adamw-bf16-mb2-rand_sparse"])
def test_adamw_loss_curve_matches_reference(case):
    """(c): the loss of every step within relative 2e-6."""
    _, state, losses = _port_run(case)
    np.testing.assert_allclose(losses, _reference(case)["losses"], rtol=TRAJECTORY_RTOL)
    assert state.mu["embed"]["table"].dtype == getattr(torch, CASES[case]["momentum_dtype"])


# ------------------------------------------------- every zoo family (C.10)


ZOO_STEPS = 3
ZOO_KW = dict(optimizer="sgd_momentum", momentum_dtype="float32", lr=1e-2)


def _zoo_batches(arch, seed: int = 5) -> list[dict[str, np.ndarray]]:
    """``ZOO_STEPS`` batches of 1 row a subset, with the frontend
    embeddings of the vlm and audio families, drawn with numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(ZOO_STEPS):
        t = rng.integers(0, arch.vocab, (N, SEQ + 1)).astype(np.int32)
        b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        if arch.family in ("vlm", "audio"):
            enc = arch.encoder
            b["frontend"] = rng.standard_normal((N, enc.n_frontend_tokens, enc.d_frontend)).astype(np.float32)
        out.append(b)
    return out


@functools.lru_cache(maxsize=None)
def _zoo_reference(family: str) -> dict:
    """The reference's engine step on ``zoo_arch(family)``: its initial
    weights and every step's loss."""
    cfg = jscn.zoo_arch(family)
    jt = JTrainConfig(arch=cfg.name, **_kw(**ZOO_KW))
    params, specs = jmodels.init(jax.random.PRNGKey(0), cfg)
    step, opt = jtrain.build_train_step(cfg, jt, make_host_mesh(1, 1), specs)
    state, params0, losses = opt.init(params), jax.device_get(params), []
    for i, b in enumerate(_zoo_batches(cfg)):
        params, state, loss, _ = step(params, state, {k: jnp.asarray(v) for k, v in b.items()},
                                      jnp.asarray(i, jnp.int32))
        losses.append(float(loss))
    return {"params0": params0, "losses": np.array(losses), "params": jax.device_get(params)}


@pytest.mark.parametrize("family", jscn.ZOO_FAMILIES)
def test_engine_step_matches_reference_on_every_zoo_family(family):
    """C.10: every family's engine step, the vlm and audio families'
    ``frontend`` leaf blocked with the rest of the batch, against the
    reference's ``build_train_step(protocol_impl="engine")`` from its
    ``PRNGKey(0)`` weights under its replayed round keys, SGD-momentum, 3
    steps: every step's loss within relative 2e-6."""
    ref = _zoo_reference(family)
    arch = tscn.zoo_arch(family)
    tcfg = TrainConfig(arch=arch.name, **_kw(**ZOO_KW))
    params = convert.lm_params_from_numpy(ref["params0"])
    q = sum(v.numel() for v in pytree.leaves(params))
    pcfg = train.make_round_config(tcfg, N)
    base = jax.random.PRNGKey(tcfg.seed)
    step, opt = train.build_engine_step(arch, tcfg, device="cpu", randomness=lambda i, j: jax_round_randomness(
        pcfg, jax.random.fold_in(jax.random.fold_in(base, i), j), q))
    state, losses = opt.init(params), []
    for i, b in enumerate(_zoo_batches(arch)):
        params, state, loss, _ = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()}, i)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref["losses"], rtol=TRAJECTORY_RTOL)


@pytest.mark.parametrize("family", ["cross", "audio"])
def test_trainer_eval_loss_reads_the_frontend(family):
    """C.10: ``Trainer.eval_loss`` on the vlm and audio families passes the
    whole batch, ``frontend`` included: at the reference ``Trainer``'s
    weights (an Auto-axis 1 x 1 mesh, ROADMAP C.4) it equals the
    reference's ``eval_loss`` (rtol 1e-5, atol 1e-6); the port's engine
    ``Trainer`` then trains a step on frontend batches."""
    from jax.sharding import AxisType

    from repro.launch.train import Trainer as JTrainer

    jarch, arch = jscn.zoo_arch(family), tscn.zoo_arch(family)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    jtr = JTrainer(cfg=jarch, tcfg=JTrainConfig(arch=jarch.name, **_kw(**ZOO_KW)), mesh=mesh)
    tr = train.Trainer(cfg=arch, tcfg=TrainConfig(arch=arch.name, **_kw(**ZOO_KW)), device="cpu")
    tr.params = convert.lm_params_from_numpy(jax.device_get(jtr.params))
    batches = _zoo_batches(arch, seed=9)
    want = jtr.eval_loss({k: jnp.asarray(v) for k, v in batches[0].items()})
    got = tr.eval_loss({k: torch.from_numpy(v) for k, v in batches[0].items()})
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    hist = tr.run(({k: torch.from_numpy(v) for k, v in b.items()} for b in batches[1:]), log_every=1)
    assert tr.step == 2 and all(np.isfinite(l) for _, l in hist)
    assert tr.eval_loss({k: torch.from_numpy(v) for k, v in batches[0].items()}) != got


# ------------------------------------------------------------------ lowering


ROUND_CASES = [dict(), dict(protocol="lad", d=3, aggregator="cwtm-nnm", trim_frac=0.2, n_byz=5, attack="ipm",
                            compression="quant", quant_levels=8),
               dict(protocol="plain", d=4), dict(protocol="none", n_byz=3),
               dict(compression="rand_sparse", q_hat_frac=0.5, attack="alie", n_byz=2),
               dict(compression="quant:4", aggregator="median", n_byz=1)]


@pytest.mark.parametrize("kw", ROUND_CASES, ids=range(len(ROUND_CASES)))
def test_make_round_config_matches_reference(kw):
    want = dataclasses.asdict(jtrain.make_round_config(JTrainConfig(**kw), 16))
    want.pop("backend")
    assert dataclasses.asdict(train.make_round_config(TrainConfig(**kw), 16)) == want


def test_make_round_config_lowering():
    """The twin of tests/test_train_engine.py's lowering test."""
    tcfg = TrainConfig(protocol="lad", d=3, aggregator="cwtm-nnm", trim_frac=0.2, n_byz=5, attack="ipm",
                       compression="quant", quant_levels=8)
    pcfg = train.make_round_config(tcfg, 16)
    assert pcfg.n_devices == 16 and pcfg.method == "lad" and pcfg.d == 3
    assert pcfg.aggregator == "cwtm-nnm" and pcfg.trim_frac == 0.2
    assert pcfg.attack.name == "ipm" and pcfg.attack.n_byz == 5
    assert pcfg.compression.name == "quant" and pcfg.compression.levels == 8
    assert train.make_round_config(TrainConfig(protocol="plain", d=4), 8).d == 1
    none = train.make_round_config(TrainConfig(protocol="none", n_byz=3), 8)
    assert none.aggregator == "mean" and none.n_byz == 0
    assert none.attack.name == "none" and none.compression.name == "none"
    with pytest.raises(ValueError, match="protocol_impl"):
        train.build_train_step(reduced(ARCHS["smollm-360m"]), TrainConfig(protocol_impl="bogus"), device="cpu")


@pytest.mark.parametrize("d", [1, 2, 3])
def test_redundant_batch_matches_reference(d):
    rng = np.random.default_rng(d)
    batch = {"tokens": rng.integers(0, 100, (5 * 4, 7)).astype(np.int32),
             "labels": rng.integers(0, 100, (5 * 4, 7)).astype(np.int32)}
    want = jtrain.redundant_batch({k: jnp.asarray(v) for k, v in batch.items()}, d, 5)
    got = train.redundant_batch({k: torch.from_numpy(v) for k, v in batch.items()}, d, 5)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ------------------------------------------------------------ the step itself


def _torch_batches(microbatches: int = 1):
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in _batches(microbatches, seed=7)]


@pytest.fixture(scope="module")
def lm_params():
    return models.init(torch.Generator().manual_seed(0), tscn.lm_arch())


def test_step_never_writes_its_inputs_and_repeats(lm_params):
    """The step leaves its params, state and batch as they were, and gives
    the same bits twice; its records are those of (seed, step, j) alone."""
    params, specs = lm_params
    tcfg = TrainConfig(arch=tscn.lm_arch().name, **_kw(momentum_dtype="bfloat16", microbatches=2))
    step, opt = train.build_engine_step(tscn.lm_arch(), tcfg, specs, device="cpu")
    state = opt.init(params)
    batch = _torch_batches(2)[0]
    before = [t.clone() for t in pytree.leaves((params, state.step, state.mu, state.nu, batch))]
    a = step(params, state, batch, 5)
    after = pytree.leaves((params, state.step, state.mu, state.nu, batch))
    assert all(torch.equal(x, y) for x, y in zip(before, after, strict=True))
    b = step(params, state, batch, 5)
    for x, y in zip(pytree.leaves((a[0], a[1].mu, a[2])), pytree.leaves((b[0], b[1].mu, b[2])), strict=True):
        assert torch.equal(x, y)
    c = step(params, state, batch, 6)
    assert not torch.equal(a[0]["embed"]["table"], c[0]["embed"]["table"])
    seeds = {train.round_seed(s, i, j) for s in range(3) for i in range(50) for j in range(3)}
    assert len(seeds) == 3 * 50 * 3 and all(0 <= v < 1 << 63 for v in seeds)


def test_equal_configs_share_their_programs(lm_params):
    """A second step built from an equal configuration reuses the cached
    programs; loop mode captures nothing."""
    params, specs = lm_params
    tcfg = TrainConfig(arch=tscn.lm_arch().name, **_kw())
    step, opt = train.build_engine_step(tscn.lm_arch(), tcfg, specs, device="cpu")
    step(params, opt.init(params), _torch_batches()[0], 0)
    info = train.engine_program_cache_info()
    step2, _ = train.build_engine_step(tscn.lm_arch(), TrainConfig(arch=tscn.lm_arch().name, **_kw()), specs,
                                       device="cpu")
    step2(params, opt.init(params), _torch_batches()[1], 1)
    assert train.engine_program_cache_info() == info
    train.build_engine_step(tscn.lm_arch(), dataclasses.replace(tcfg, lr=1e-3), specs, device="cpu")
    assert train.engine_program_cache_info()["programs"] == info["programs"] + 1  # a new apply, the same round


@pytest.mark.parametrize("case", ["protomath", "shard", "n_subsets", "unknown-shard", "graph-on-cpu", "rows",
                                  "frontend-rows", "microbatches"])
def test_step_refusals(lm_params, case):
    """The protomath step needs a mesh; graph mode of the sharded engine
    step waits for A.14; N needs ``n_subsets`` or a mesh; an unknown shard
    mode is refused with the reference's message; graph mode needs the
    card; every leaf of a batch must block into N subsets and its rows into
    the microbatches."""
    params, specs = lm_params
    arch = tscn.lm_arch()
    want = {"protomath": "needs a mesh", "shard": "A.14", "n_subsets": "no mesh", "graph-on-cpu": "CUDA",
            "unknown-shard": "unknown engine shard mode", "rows": "'tokens' of 9 rows does not split into 10 subsets",
            "frontend-rows": "'frontend' of 19 rows", "microbatches": "microbatches"}[case]
    with pytest.raises(ValueError, match=want):
        if case == "protomath":
            train.build_train_step(arch, TrainConfig(arch=arch.name, **_kw(protocol_impl="protomath")), device="cpu")
        elif case == "shard":
            train.build_train_step(arch, TrainConfig(arch=arch.name, **_kw(shard="shard_map")), device="cpu",
                                   mode="graph")
        elif case == "n_subsets":
            train.build_engine_step(arch, TrainConfig(arch=arch.name, **_kw(n_subsets=None)), device="cpu")
        elif case == "unknown-shard":
            train.build_train_step(arch, TrainConfig(arch=arch.name, **_kw(shard="gspmd")), device="cpu")
        elif case == "graph-on-cpu":
            train.build_engine_step(arch, TrainConfig(arch=arch.name, **_kw()), device="cpu", mode="graph")
        else:
            step, opt = train.build_engine_step(arch, TrainConfig(arch=arch.name, **_kw(microbatches=3)),
                                                device="cpu")
            batch = _torch_batches()[0]
            if case == "rows":
                batch = {k: v[:-1] for k, v in batch.items()}
            elif case == "frontend-rows":  # the frontend leaf is blocked too, and checked
                batch = {**batch, "frontend": torch.zeros((19, 8, 16))}
            step(params, opt.init(params), batch, 0)


def test_protomath_step_builds_and_trains(lm_params):
    """``build_train_step`` builds the protomath step over a one-rank mesh
    of N=10: it never writes its inputs, repeats bit for bit, and its loss
    falls over the steps; it refuses graph mode, replayed records and a
    ``shard=``. (Its parity with the reference is in
    tests/test_torch_protomath_step.py.)"""
    from repro_torch.launch.mesh import make_host_mesh as port_mesh

    params, specs = lm_params
    arch = tscn.lm_arch()
    mesh = port_mesh(N)
    tcfg = TrainConfig(arch=arch.name, **_kw(protocol_impl="protomath", steps=6))
    step, opt = train.build_train_step(arch, tcfg, specs, mesh=mesh, device="cpu")
    before = [v.clone() for v in pytree.leaves(params)]
    batches = _torch_batches()
    p, s, losses = params, opt.init(params), []
    for i in range(6):
        p, s, loss, metrics = step(p, s, batches[i % len(batches)], i)
        losses.append(float(loss))
        assert set(metrics) == {"nll", "aux"}
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(params), before))
    again = step(params, opt.init(params), batches[0], 0)
    first = step(params, opt.init(params), batches[0], 0)
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(again[0]), pytree.leaves(first[0])))
    assert losses[-1] < losses[0], losses
    for kw, match in ((dict(mode="graph"), "loop mode"), (dict(randomness=lambda i, j: None), "own randomness")):
        with pytest.raises(ValueError, match=match):
            train.build_train_step(arch, tcfg, specs, mesh=mesh, device="cpu", **kw)
    with pytest.raises(ValueError, match="engine-path option"):
        train.build_train_step(arch, dataclasses.replace(tcfg, shard="pmap"), specs, mesh=mesh, device="cpu")


# ----------------------------------------------------------------- Trainer


def _tiny_cfg():
    """The reference's ``_tiny_cfg`` of tests/test_train_engine.py."""
    return reduced(ARCHS["smollm-360m"]).scaled(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
                                                d_ff=128, vocab=128)


def test_lm_trains_through_protocol_engine(tmp_path):
    """The twin of tests/test_train_engine.py's test: LAD + CWTM under a
    sign-flip attack through the port's Trainer (N=8, AdamW, 8 steps): the
    loss is finite and decreases; the trainer saves a checkpoint and
    evaluates a batch."""
    from repro_torch import checkpoint

    cfg = _tiny_cfg()
    tcfg = TrainConfig(arch=cfg.name, protocol="lad", protocol_impl="engine", n_subsets=8, d=2, aggregator="cwtm",
                       trim_frac=0.25, n_byz=2, attack="sign_flip", optimizer="adamw", lr=3e-3, steps=8)
    tr = train.Trainer(cfg=cfg, tcfg=tcfg, device="cpu")

    def batches():
        for i in range(tcfg.steps):
            b = lm_batch_for_devices(torch.Generator().manual_seed(i), cfg.vocab, n_subsets=8, per_subset=2,
                                     seq_len=16, sigma_h=0.5)
            yield {k: v.reshape(-1, v.shape[-1]) for k, v in b.items()}

    hist = tr.run(batches(), log_every=1)
    losses = [l for _, l in hist]
    assert [i for i, _ in hist] == list(range(8)) and tr.step == 8
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    tr.save(str(tmp_path / "ck"))
    restored, step = checkpoint.load_checkpoint(str(tmp_path / "ck"), tr.params)
    assert step == 8 and all(torch.equal(a, b) for a, b in zip(pytree.leaves(restored), pytree.leaves(tr.params)))
    b = next(batches())
    assert tr.eval_loss(b) == pytest.approx(float(models.loss_fn(tr.params, None, cfg, b)[0]))


# ------------------------------------------------------- the engine's optimizers


TRAJ_STEPS = 30
TRAJ_CASES = {
    "sgd_momentum": dict(optimizer="sgd_momentum", lr=1e-5),
    "adamw": dict(optimizer="adamw", lr=1e-2),
    "adamw-schedule": dict(optimizer="adamw", lr=("linear_warmup_cosine", 1e-2, 3, TRAJ_STEPS)),
    "sgd-schedule": dict(optimizer="sgd", lr=("cosine_decay", 1e-5, TRAJ_STEPS)),
}


def _lr(spec, module):
    return spec if isinstance(spec, float) else getattr(module, spec[0])(*spec[1:])


@pytest.mark.parametrize("case", list(TRAJ_CASES))
def test_run_trajectory_optimizers_match_reference(problem, case):  # noqa: F811
    """The Fig. 4 LAD-CWTM-d10 round under each optimizer and schedule, 30
    rounds: loss, agg_dist and grad_norm within relative 2e-6 a round."""
    z, y = problem
    kw = TRAJ_CASES[case]
    scn = tscn.PAPER_FIG4["LAD-CWTM-d10"]
    jres = jengine.run_trajectory(
        jscn.PAPER_FIG4["LAD-CWTM-d10"].protocol(), jax.random.PRNGKey(4), jnp.zeros(z.shape[1]),
        lambda data, x: jax_grads(data[0], data[1], x), steps=TRAJ_STEPS, lr=_lr(kw["lr"], jschedule),
        optimizer=kw["optimizer"], grad_scale=100.0, loss_fn=lambda data, x: jax_loss(data[0], data[1], x),
        mode="loop", data=(jnp.asarray(z), jnp.asarray(y)))
    cfg = scn.protocol()
    tres = tengine.run_trajectory(
        cfg, torch.zeros(z.shape[1]), lambda data, x: linreg_subset_grads(data[0], data[1], x), steps=TRAJ_STEPS,
        lr=_lr(kw["lr"], tschedule), optimizer=kw["optimizer"], randomness=_replayed(cfg, 4, TRAJ_STEPS, z.shape[1]),
        grad_scale=100.0, loss_fn=lambda data, xs: linreg_loss(data[0], data[1], xs),
        data=(torch.from_numpy(z), torch.from_numpy(y)), device="cpu")
    for name in ("loss", "agg_dist", "grad_norm"):
        np.testing.assert_allclose(tres.metrics[name].numpy(), np.asarray(jres.metrics[name]),
                                   rtol=TRAJECTORY_RTOL, err_msg=name)
    assert int(tres.opt_state.step) == TRAJ_STEPS


@pytest.mark.parametrize("case", ["sgd_momentum", "adamw", "adamw-schedule"])
def test_grid_lanes_equal_standalone_runs_and_metrics_do_not_change_bits(problem, case):  # noqa: F811
    """Three lanes (sign-flip, ALIE, IPM; one step size each, or a shared
    schedule) under each optimizer with bf16 moments: every lane bit for bit
    its standalone run, moments included; ``with_metrics=False`` gives the
    same final iterate and state bit for bit, for the grid and alone."""
    z, y = problem
    kw = TRAJ_CASES[case]
    base = tscn.PAPER_FIG4["LAD-CWTM-d10"]
    rows = [dataclasses.replace(base, attack=a) for a in ("sign_flip", "alie", "ipm")]
    cfgs = [r.protocol() for r in rows]
    lrs = [_lr(kw["lr"], tschedule)] * 3 if isinstance(kw["lr"], tuple) else [kw["lr"] * f for f in (1.0, 0.5, 2.0)]
    data = (torch.from_numpy(z), torch.from_numpy(y))
    common = dict(steps=12, optimizer=kw["optimizer"], momentum_dtype="bfloat16", grad_scale=100.0, device="cpu")
    grads = lambda d, x: linreg_subset_grads(d[0], d[1], x)

    def grid(with_metrics):
        return tengine.run_grid(
            cfgs, torch.zeros(z.shape[1]), grads, lr=lrs[0] if callable(lrs[0]) else lrs, data=data,
            data_batched=False, randomness=[torch.Generator().manual_seed(s) for s in (1, 2, 3)],
            loss_fn=(lambda d, xs: linreg_loss(d[0], d[1], xs)) if with_metrics else None,
            with_metrics=with_metrics, **common)

    res = grid(True)
    bare = grid(False)
    assert bare.metrics == {} and torch.equal(bare.x, res.x)
    for i, cfg in enumerate(cfgs):
        alone = tengine.run_trajectory(cfg, torch.zeros(z.shape[1]), grads, lr=lrs[i], data=data,
                                       randomness=torch.Generator().manual_seed(i + 1),
                                       loss_fn=lambda d, xs: linreg_loss(d[0], d[1], xs), **common)
        assert same_bits(res.lane(i), alone), i
        for lane_m, alone_m, bare_m in zip(pytree.leaves((res.opt_state.mu, res.opt_state.nu)),
                                           pytree.leaves((alone.opt_state.mu, alone.opt_state.nu)),
                                           pytree.leaves((bare.opt_state.mu, bare.opt_state.nu)), strict=True):
            assert lane_m.dtype == torch.bfloat16 and torch.equal(lane_m[i], alone_m) and torch.equal(bare_m[i], alone_m)
        quiet = tengine.run_trajectory(cfg, torch.zeros(z.shape[1]), grads, lr=lrs[i], data=data,
                                       randomness=torch.Generator().manual_seed(i + 1), with_metrics=False, **common)
        assert quiet.metrics == {} and torch.equal(quiet.x, alone.x)
        assert all(torch.equal(a, b) for a, b in zip(pytree.leaves((quiet.opt_state.mu, quiet.opt_state.step)),
                                                     pytree.leaves((alone.opt_state.mu, alone.opt_state.step))))


def test_with_metrics_false_refuses_metric_hooks():
    with pytest.raises(ValueError, match="with_metrics=False"):
        tengine.run_trajectory(tscn.PAPER_FIG4["VA"].protocol(), torch.zeros(3), lambda x: torch.zeros(100, 3),
                               steps=1, lr=0.1, loss_fn=lambda xs: xs.sum(-1), with_metrics=False, device="cpu")
