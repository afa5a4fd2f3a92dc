"""The model zoo through the port's trajectory engine, on the CPU.

Against the reference: for every ``ZOO_FAMILIES`` family, the LAD-d2 row of
``zoo_sweep()`` through ``repro.core.scenarios.run_lm_scenario`` (its
compiled scan) and the port's ``run_lm_scenario`` on the same ``PRNGKey(0)``
parameters (carried across by ``convert.lm_params_from_numpy``), the same
tokens, labels and frontend (the reference's ``_lm_problem``) and the
reference's per-round draws replayed, 10 rounds. Tolerance: relative 2e-6
on every round's ``loss``, ``agg_dist`` and ``grad_norm`` (the trajectory
tolerance of tests/test_torch_lm.py). Measured over 20 rounds, six families
stay within 7.8e-7 (Jamba's ``grad_norm``).

RWKV parts at round 9. At some iterates a subset's float32 gradient is
ill-conditioned (ROADMAP C.7): rounding upstream of the time mix's
projections moves it by up to 1e-4 of its norm, so any float32 evaluation
is only that good, on either side, and the curves part (C.6's provision,
as ``test_selection_rows_match_reference_round_by_round``). Where a curve
parts, every round is held on the port's own input: the reference's round
on the port's gradient stack equals the port's aggregate (rtol 1e-5, atol
1e-6 of its largest value), and the reference's subset gradients at the
port's iterate equal the port's (each row within ``GRAD_ROW_RTOL`` of its
norm), or, at a round where they differ more, both frameworks' gradients
are taken in float64 too (the reference under ``reference_float64``, the
port under ``precision.float64``, each checked to compute in float64):
the two float64 gradients agree row for row within ``FLOAT64_RTOL``
(the port computes the reference's gradient), and each float32 gradient
lies within ``ILL_ROW_BOUND`` of the reference's float64 one. The first
such round must come no later than the round where the curves part; no
family other than RWKV may part. Measured on RWKV
(tests/torch_rwkv_conditioning.py): rounds 2, 5, 8 and 9 differ by more
than 1e-5; there the worst rows lie 7.3e-6, 6.5e-6, 8.1e-6 and 6.0e-5
(reference) and 8.0e-6, 4.2e-6, 1.26e-5 and 9.5e-5 (port) from float64,
each inside the spread of the port's own gradient over 24 permuted
summation orders of the time mix's projections (round 9: 1.1e-5 to
2.5e-4, median 1.2e-4).

Inside the port, bitwise: every ``run_zoo_sweep`` lane (buckets in
``mode="loop"``) equals ``run_lm_scenario`` of its row on the family's
``zoo_arch``, and a chunked sweep equals the unchunked one.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.core import byzantine as jbyz
from repro.core import scenarios as jscn
from repro_torch import convert, models
from repro_torch.configs.archs import ARCHS as TARCHS
from repro_torch.core import scenarios as tscn
from repro_torch.models import attention as tattn
from repro_torch.models import precision
from repro_torch.models.precision import FLOAT64_RTOL, GRAD_ROW_RTOL, ILL_ROW_BOUND, row_error
from test_torch_grid import same_bits
from test_torch_protocol import jax_round_randomness
from test_torch_zoo_ops import float64_jit, reference_float64

TRAJECTORY_RTOL = 2e-6
STEPS = 10


class Replayed(NamedTuple):
    jarch: object
    jrow: object
    jres: object  # the reference's run
    tres: object  # the port's run
    data: tuple  # the reference's problem (tokens, labels[, frontend])
    batch: dict  # the same, as the port's tensors
    fns: object  # the port's ``_lm_fns``
    xs: list  # the port's iterate at each round
    stacks: list  # the port's (N, P) subset gradients at each round
    aggs: list  # the port's aggregate at each round


def replayed_run(family: str, steps: int = STEPS) -> Replayed:
    """The family's LAD-d2 ``zoo_sweep`` row through the reference's scan
    and through the port on the same parameters, problem and per-round
    draws (module docstring), the port's iterates, gradient stacks and
    aggregates recorded round by round."""
    jarch, tarch = jscn.zoo_arch(family), tscn.zoo_arch(family)
    jrow, trow = jscn.zoo_sweep((family,))[family][0], tscn.zoo_sweep((family,))[family][0]
    assert trow.name == jrow.name == f"zoo/{family}/lad-d2/cwtm/sign_flip/s0.5"
    jres = jscn.run_lm_scenario(jrow, steps, arch=jarch, mode="scan")
    data = jscn._lm_problem(jarch, seed=0, n_subsets=jrow.n_devices, sigma_h=jrow.sigma_h, per_subset=2, seq_len=16)
    assert len(data) == (3 if family in ("cross", "audio") else 2)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in zip(("tokens", "labels", "frontend"), data)}
    batch["tokens"], batch["labels"] = batch["tokens"].long(), batch["labels"].long()
    params, _ = jmodels.init(jax.random.PRNGKey(0), jarch)
    params = convert.lm_params_from_numpy(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params))
    cfg, q = trow.protocol(), jres.x.shape[0]
    rands = [jax_round_randomness(cfg, jax.random.fold_in(jax.random.PRNGKey(0), t), q) for t in range(steps)]

    fns = tscn._lm_fns(tarch)
    xs, stacks, aggs = [], [], []

    def recording_grads(d, x):
        xs.append(x.clone())
        out = fns.subset_grad_fn(d, x)
        stacks.append(out.clone())
        return out

    real_fns, real_round = tscn._lm_fns, tscn.engine_lib.protocol_round

    def recording_round(*args, **kw):
        out = real_round(*args, **kw)
        aggs.append(out[0].clone())
        return out

    tscn._lm_fns = lambda arch: fns._replace(subset_grad_fn=recording_grads)
    tscn.engine_lib.protocol_round = recording_round
    try:
        tres = tscn.run_lm_scenario(trow, steps, arch=tarch, params=params, batch=batch, device="cpu",
                                    randomness=lambda t: rands[t])
    finally:
        tscn._lm_fns, tscn.engine_lib.protocol_round = real_fns, real_round
    assert len(xs) == len(aggs) == steps
    return Replayed(jarch, jrow, jres, tres, data, batch, fns, xs, stacks, aggs)


@pytest.mark.parametrize("family", jscn.ZOO_FAMILIES)
def test_run_lm_scenario_matches_reference(family):
    jarch, jrow, jres, tres, data, batch, fns, xs, stacks, aggs = replayed_run(family)
    metric = {k: np.asarray(jres.metrics[k]) for k in ("loss", "agg_dist", "grad_norm")}
    port = {k: tres.metrics[k].numpy() for k in metric}
    ok = np.ones(STEPS, dtype=bool)
    for k in metric:
        ok &= np.abs(port[k] - metric[k]) <= TRAJECTORY_RTOL * np.abs(metric[k])
    if ok.all():
        want = np.asarray(jres.x)
        np.testing.assert_allclose(tres.x.numpy(), want, rtol=TRAJECTORY_RTOL,
                                   atol=TRAJECTORY_RTOL * float(np.abs(want).max()))
        return
    assert family in precision.PARTING_FAMILIES, f"{family}: the curves part at round {int(np.argmin(ok))}"
    parted = int(np.argmin(ok))

    # every round on the port's own input
    _, jgrads, _ = jscn._lm_fns(jarch)
    jgrads = jax.jit(jgrads)
    jround = jax.jit(lambda key, g: jbyz.protocol_round(jrow.protocol(), key, g))
    data64 = tuple(np.asarray(d, np.float64 if i == 2 else None) for i, d in enumerate(data))
    batch64 = tuple(v.double() if v.is_floating_point() else v for v in batch.values())
    jgrads64, ill = None, []
    for t in range(STEPS):
        got = stacks[t]
        want = torch.from_numpy(np.asarray(jgrads(data, jnp.asarray(xs[t].numpy()))))
        if row_error(got, want) > GRAD_ROW_RTOL:
            x64 = xs[t].numpy().astype(np.float64)
            with reference_float64():
                if jgrads64 is None:
                    fn = jscn._lm_fns(dataclasses.replace(jarch, param_dtype="float64"))[1]
                    jgrads64 = float64_jit(fn, data64, x64)
                want64 = torch.from_numpy(np.asarray(jgrads64(data64, x64)))
            with precision.float64():
                got64 = fns.subset_grad_fn(batch64, xs[t].double())
            assert want64.dtype == got64.dtype == torch.float64
            assert row_error(got64, want64) <= FLOAT64_RTOL, (t, row_error(got64, want64))
            assert row_error(want, want64) <= ILL_ROW_BOUND, (t, row_error(want, want64))
            assert row_error(got, want64) <= ILL_ROW_BOUND, (t, row_error(got, want64))
            ill.append(t)
        agg = np.asarray(jround(jax.random.fold_in(jax.random.PRNGKey(0), t), jnp.asarray(got.numpy())))
        np.testing.assert_allclose(aggs[t].numpy(), agg, rtol=1e-5, atol=1e-6 * float(np.abs(agg).max()),
                                   err_msg=f"round {t}")
    assert ill and ill[0] <= parted, (ill, parted)


@pytest.mark.parametrize("family", jscn.ZOO_FAMILIES)
def test_zoo_sweep_lanes_equal_run_lm_scenario_bitwise(family):
    """Each family's rows through ``run_zoo_sweep`` (buckets in loop mode):
    every lane bit for bit its row alone on the family's ``zoo_arch``."""
    kw = dict(seed=3, per_subset=1, seq_len=8)
    sweep = tscn.run_zoo_sweep(3, families=(family,), device="cpu", mode="loop", **kw)
    rows = tscn.zoo_sweep((family,))[family]
    assert list(sweep) == [family] and list(sweep[family]) == [r.name for r in rows]
    for row in rows:
        alone = tscn.run_lm_scenario(row, 3, arch=tscn.zoo_arch(family), device="cpu", **kw)
        assert same_bits(sweep[family][row.name], alone), row.name
        assert bool(torch.isfinite(alone.metrics["loss"]).all())


def test_chunked_zoo_sweep_is_bitwise_unchunked():
    """The moe family's LAD bucket of three attacks, in chunks of 2 lanes."""
    sweep = tscn.zoo_sweep(("moe",), methods=(("lad", 2),), attacks=("sign_flip", "alie", "ipm"))
    kw = dict(sweep=sweep, seed=4, device="cpu", mode="loop", per_subset=1, seq_len=8)
    whole = tscn.run_zoo_sweep(3, **kw)["moe"]
    chunked = tscn.run_zoo_sweep(3, max_lanes_per_device=2, **kw)["moe"]
    assert chunked[sweep["moe"][0].name].grid.chunks == 2
    for row in sweep["moe"]:
        assert same_bits(chunked[row.name], whole[row.name]), row.name


def test_frontend_problem_layout():
    """vlm and audio problems carry a third leaf, the stub frontend (the
    tokens unchanged by it); a batch without it raises."""
    arch = tscn.zoo_arch("audio")
    data = tscn._lm_problem(arch, seed=5, n_subsets=8, sigma_h=0.5, per_subset=2, seq_len=8,
                            device=torch.device("cpu"))
    plain = tscn._lm_problem(tscn.lm_arch(), seed=5, n_subsets=8, sigma_h=0.5, per_subset=2, seq_len=8,
                             device=torch.device("cpu"))
    assert len(data) == 3 and len(plain) == 2
    assert data[2].shape == (8, 2, arch.encoder.n_frontend_tokens, arch.encoder.d_frontend)
    assert data[2].dtype == torch.float32 and 0.8 < float(data[2].std()) < 1.2
    assert torch.equal(data[0], plain[0]) and torch.equal(data[1], plain[1])
    row = tscn.zoo_sweep(("audio",))["audio"][0]
    with pytest.raises(ValueError, match="frontend"):
        tscn.run_lm_scenario(row, 1, arch=arch, device="cpu", batch={"tokens": data[0], "labels": data[1]})
    res = tscn.run_lm_scenario(row, 2, arch=arch, device="cpu",
                               batch={"tokens": data[0], "labels": data[1], "frontend": data[2]})
    assert res.metrics["loss"].shape == (2,)


def test_every_arch_trains_and_what_waits_still_raises():
    """``models.init`` and ``loss_fn`` take every family of the table (at
    ``reduced`` widths); attention past 2048 tokens (the whisper encoder
    over PLAIN_THRESHOLD + 1 frames, the chunked online-softmax path ported
    with serving) gives the reference's loss."""
    from repro_torch.configs.archs import reduced

    for name, arch in TARCHS.items():
        arch = reduced(arch)
        params, _ = models.init(torch.Generator().manual_seed(0), arch)
        batch = {"tokens": torch.zeros((1, 8), dtype=torch.long), "labels": torch.ones((1, 8), dtype=torch.long)}
        if arch.family in ("vlm", "audio"):
            batch["frontend"] = torch.zeros((1, arch.encoder.n_frontend_tokens, arch.encoder.d_frontend))
        loss, parts = models.loss_fn(params, None, arch, batch)
        assert bool(torch.isfinite(loss)), name
    params, specs = jmodels.init(jax.random.PRNGKey(0), jscn.zoo_arch("audio"))
    rng = np.random.default_rng(12)
    data = {"tokens": rng.integers(0, 64, (1, 8)), "labels": rng.integers(0, 64, (1, 8)),
            "frontend": rng.standard_normal((1, tattn.PLAIN_THRESHOLD + 1, 16)).astype(np.float32)}
    want, _ = jmodels.loss_fn(params, specs, jscn.zoo_arch("audio"), {k: jnp.asarray(v) for k, v in data.items()})
    got, _ = models.loss_fn(convert.lm_params_from_numpy(jax.device_get(params)), None, tscn.zoo_arch("audio"),
                            {k: torch.from_numpy(v) for k, v in data.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
