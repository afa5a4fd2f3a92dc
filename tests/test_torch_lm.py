"""The port's LM trainer (``run_lm_scenario``, ``run_lm_grid``) on the CPU.

Against the reference: ``repro.core.scenarios.run_lm_scenario`` (its
compiled scan) and the port's on the same ``PRNGKey(0)`` parameters
(carried across by ``convert.lm_params_from_numpy``), the same token
arrays (the reference's ``_lm_problem``), and the port's per-round
randomness replayed from the reference's keys, as in
``tests/test_torch_engine.py``; 3 rounds, as the reference's own LM tests
run.

Tolerance: relative 2e-6 on every round's ``loss``, ``agg_dist`` and
``grad_norm``, and the final iterate within 2e-6 of its largest value: the
trajectory tolerance of tests/test_torch_engine.py. The two frameworks'
gradients of a softmax model differ by float32 rounding (the per-op check
is tests/test_torch_models.py), so the trajectories are not bitwise. Every
stage of these rows is continuous in its inputs (CWTM, the three attacks,
the encode, random sparsification at replayed indices), so there is no
selection to flip: on all 12 ``lm_sweep()`` rows the largest difference
measured over 3 rounds is 3.3e-7, and over 100 rounds 5.5e-7, four times
inside the tolerance.

Inside the port, bitwise: every lane of ``run_lm_grid`` (its buckets in
``mode="loop"``) equals ``run_lm_scenario`` of its row with the same seed,
chunked or not, at N=10 and N=16.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.core import scenarios as jscn
from repro_torch import convert
from repro_torch.core import scenarios as tscn
from repro_torch.data.synthetic import HeterogeneousLM, lm_batch_for_devices
from test_torch_grid import same_bits
from test_torch_protocol import jax_round_randomness

TRAJECTORY_RTOL = 2e-6
STEPS = 3


@pytest.fixture(scope="module")
def carried_params():
    params, _ = jmodels.init(jax.random.PRNGKey(0), jscn.lm_arch())
    params = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)
    return convert.lm_params_from_numpy(params)


def _fields(row) -> dict:
    return {k: v for k, v in dataclasses.asdict(row).items() if k != "backend"}


def test_lm_sweep_rows_match_reference_rows():
    got, want = tscn.lm_sweep(), jscn.lm_sweep()
    assert len(got) == 12 and [_fields(r) for r in got] == [_fields(r) for r in want]
    kw = dict(methods=(("draco", 4), ("lad", 3)), n_devices=14, n_byz=3)
    assert [_fields(r) for r in tscn.lm_sweep(**kw)] == [_fields(r) for r in jscn.lm_sweep(**kw)]
    assert len({tscn._bucket_signature(r) for r in got}) == 4


# one row of each bucket, each attack twice
REF_ROWS = ["lm/lad-d2/cwtm/sign_flip/s0.5", "lm/lad-d2/cwtm/alie/rand_sparse/s0.5",
            "lm/plain-d1/cwtm/ipm/s0.5", "lm/plain-d1/cwtm/alie/rand_sparse/s0.5"]


@pytest.mark.parametrize("name", REF_ROWS)
def test_run_lm_scenario_matches_reference(carried_params, name):
    jrow = {r.name: r for r in jscn.lm_sweep()}[name]
    trow = {r.name: r for r in tscn.lm_sweep()}[name]
    jres = jscn.run_lm_scenario(jrow, STEPS, mode="scan")
    tokens, labels = jscn._lm_problem(jscn.lm_arch(), seed=0, n_subsets=jrow.n_devices, sigma_h=jrow.sigma_h,
                                      per_subset=2, seq_len=16)
    cfg, q = trow.protocol(), jres.x.shape[0]
    rands = [jax_round_randomness(cfg, jax.random.fold_in(jax.random.PRNGKey(0), t), q) for t in range(STEPS)]
    tres = tscn.run_lm_scenario(
        trow, STEPS, params=carried_params, device="cpu", randomness=lambda t: rands[t],
        batch={"tokens": torch.from_numpy(np.array(tokens)).long(),
               "labels": torch.from_numpy(np.array(labels)).long()})
    for k in ("loss", "agg_dist", "grad_norm"):
        np.testing.assert_allclose(tres.metrics[k].numpy(), np.asarray(jres.metrics[k]), rtol=TRAJECTORY_RTOL,
                                   err_msg=k)
    want = np.asarray(jres.x)
    np.testing.assert_allclose(tres.x.numpy(), want, rtol=TRAJECTORY_RTOL,
                               atol=TRAJECTORY_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("kw", [dict(), dict(n_devices=16, n_byz=3)], ids=["n10", "n16"])
def test_grid_lanes_equal_run_lm_scenario_bitwise(kw):
    """``lm_sweep()``'s 12 rows in their 4 buckets (and the reference's
    full-matrix N=16 sweep): every lane bit for bit its row alone."""
    rows = tscn.lm_sweep(**kw)
    grid = tscn.run_lm_grid(rows, STEPS, seed=2, device="cpu", mode="loop", per_subset=1, seq_len=8)
    assert list(grid) == [r.name for r in rows]
    assert len({id(grid[r.name].grid) for r in rows}) == 4
    for row in rows:
        alone = tscn.run_lm_scenario(row, STEPS, seed=2, device="cpu", per_subset=1, seq_len=8)
        assert same_bits(grid[row.name], alone), row.name


def test_chunked_lm_grid_is_bitwise_unchunked():
    rows = tscn.lm_sweep(methods=(("lad", 2),), compressors=("rand_sparse",))
    kw = dict(seed=4, device="cpu", mode="loop", per_subset=1, seq_len=8)
    whole = tscn.run_lm_grid(rows, STEPS, **kw)
    chunked = tscn.run_lm_grid(rows, STEPS, max_lanes_per_device=2, **kw)
    assert chunked[rows[0].name].grid.chunks == 2
    for row in rows:
        assert same_bits(chunked[row.name], whole[row.name]), row.name


@pytest.mark.parametrize("case", ["empty", "sigma_h", "shard", "mode", "graph-on-cpu", "params"])
def test_lm_validation(case):
    """The reference's refusals (no rows, rows of several sigma_h), the
    sharded grid waiting for A.9b, an unknown mode, graph mode off the card,
    and a parameter tree of the wrong size."""
    rows = tscn.lm_sweep(methods=(("lad", 2),), attacks=("sign_flip",), compressors=("none",))
    kw = dict(device="cpu", mode="loop")
    want = {"empty": "at least one scenario", "sigma_h": "sigma_h", "shard": "A.9b", "mode": "mode",
            "graph-on-cpu": "CUDA", "params": "tree of leaves"}[case]
    with pytest.raises(ValueError, match=want):
        if case == "empty":
            tscn.run_lm_grid([], 2, **kw)
        elif case == "sigma_h":
            tscn.run_lm_grid(rows + [dataclasses.replace(rows[0], name="x", sigma_h=0.1)], 2, **kw)
        elif case == "shard":
            tscn.run_lm_grid(rows, 2, shard="shard_map", **kw)
        elif case == "mode":
            tscn.run_lm_grid(rows, 2, device="cpu", mode="scan")
        elif case == "graph-on-cpu":
            tscn.run_lm_scenario(rows[0], 2, device="cpu", mode="graph")
        else:
            tscn.run_lm_scenario(rows[0], 2, device="cpu", params={"w": torch.zeros(3)})


def test_lm_scenario_is_reproducible_and_trains():
    """The same seed gives the same bits, another seed other data and draws;
    the loss falls under a sign-flip attack with CWTM."""
    row = tscn.lm_sweep()[0]
    a = tscn.run_lm_scenario(row, 12, seed=7, device="cpu")
    b = tscn.run_lm_scenario(row, 12, seed=7, device="cpu")
    assert same_bits(a, b)
    assert not torch.equal(a.x, tscn.run_lm_scenario(row, 12, seed=8, device="cpu").x)
    loss = a.metrics["loss"]
    assert loss.shape == (12,) and bool(torch.isfinite(loss).all()) and float(loss[-1]) < float(loss[0])


def test_stage_hook_marks_every_round():
    row = tscn.lm_sweep()[0]
    marks = []
    tscn.run_lm_scenario(row, 2, device="cpu", stage_hook=marks.append)
    one = ["round", "grads", "encode", "compress", "attack", "server", "step"]
    assert marks == one + one
    with pytest.raises(ValueError, match="stage_hook"):
        from repro_torch.core import engine

        engine.run_trajectory(row.protocol(), torch.zeros(4), lambda x: torch.zeros(10, 4), steps=1, lr=1.0,
                              device="cpu", mode="graph", stage_hook=marks.append)


def test_lm_batch_layout():
    batch = lm_batch_for_devices(torch.Generator().manual_seed(0), 64, n_subsets=5, per_subset=3, seq_len=7)
    assert batch["tokens"].shape == batch["labels"].shape == (5, 3, 7)
    assert torch.equal(batch["tokens"][..., 1:], batch["labels"][..., :-1])  # next-token labels
    assert int(batch["tokens"].min()) >= 0 and int(batch["tokens"].max()) < 64


def _heterogeneity(sigma_h: float, seed: int) -> float:
    """Mean total-variation distance between each subset's unigram
    distribution and the subsets' average."""
    gen = HeterogeneousLM(vocab=256, n_subsets=16, sigma_h=sigma_h)
    probs = torch.softmax(gen.subset_logits(torch.Generator().manual_seed(seed)), dim=-1)
    return float(0.5 * (probs - probs.mean(0)).abs().sum(-1).mean())


def test_heterogeneity_rises_with_sigma_h():
    """A statistical check on the port's own generator: over 8 seeds, the
    subsets' spread grows with sigma_h, and the tokens follow their
    subset's distribution (empirical frequencies within 4 sigma)."""
    levels = (0.0, 0.1, 0.5, 2.0)
    spread = [np.mean([_heterogeneity(s, seed) for seed in range(8)]) for s in levels]
    assert all(a < b for a, b in zip(spread, spread[1:])), spread
    assert spread[0] < 0.05 < spread[-1]
    gen = HeterogeneousLM(vocab=32, n_subsets=3, sigma_h=0.5)
    g = torch.Generator().manual_seed(3)
    logits = gen.subset_logits(g)
    toks = gen.sample(g, logits, 100, 200)
    probs = torch.softmax(logits, -1)
    freq = torch.stack([torch.bincount(toks[k].reshape(-1), minlength=32) for k in range(3)]).double() / 20000
    assert bool(((freq - probs).abs() <= 4 * (probs * (1 - probs) / 20000).sqrt() + 1e-4).all())
