"""The paper's theory (Section VI) in the port, on the CPU.

Parity: the port's copies of ``core/theory.py``, ``aggregators.kappa_bound``
and the task-matrix analysis helpers return the reference's numbers
exactly (``==``), over a grid of parameters; the reference's own property
tests (tests/test_theory.py, tests/test_task_matrix.py) hold on the port.

``run_scenario(with_sol_err=True)``: the port solves ``Z x = y`` in float64
(``scenarios.least_squares``), the reference in float32, so the two ``x*``
differ by the float32 solve's error ``e = ||x*_port - x*_ref||``. With the
iterates within relative 2e-6 (tests/test_torch_engine.py), the triangle
inequality bounds the two ``sol_err`` curves' gap by ``e`` plus that
tolerance: that is what is held.

Statistics (Lemmas 1 and 2, and the round's behaviour under attack, as in
tests/test_protocol.py) run through the port's own draws and
``engine.protocol_rounds``: bounds with stated sampling margins, not
replays.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.core import scenarios as jscn
from repro.core import task_matrix as jtm
from repro.core import theory as jtheory
from repro.data.synthetic import linear_regression_problem as jax_problem
from repro_torch.core import aggregators as tagg
from repro_torch.core import byzantine as tbyz
from repro_torch.core import engine as tengine
from repro_torch.core import scenarios as tscn
from repro_torch.core import task_matrix as ttm
from repro_torch.core import theory as ttheory
from repro_torch.core.attacks import AttackSpec
from repro_torch.core.compression import CompressionSpec
from repro_torch.kernels import ops as tops

PARAMS = [dict(n=n, h=h, d=d, kappa=kappa, beta=beta, delta=delta)
          for n, h, d in ((100, 65, 1), (100, 65, 5), (100, 80, 20), (100, 65, 100), (16, 13, 4), (64, 40, 8),
                          (7, 4, 3))
          for kappa, beta, delta in ((1.5, 1.0, 0.0), (0.4, 2.0, 0.5), (6.0, 0.3, 2.0), (0.0, 1.0, 0.0))]
FUNCS = ["kappas", "xis", "max_learning_rate", "com_lad_error_order", "lad_error_order", "baseline_error_order"]


def _outcome(fn, *args):
    """``fn(*args)``, or the type of what it raised (the reference divides
    by zero at d = N, delta = 0 in ``com_lad_error_order``)."""
    try:
        return fn(*args)
    except ArithmeticError as err:
        return type(err)


@pytest.mark.parametrize("fn", FUNCS)
def test_theory_constants_equal_reference(fn):
    for kw in PARAMS:
        want = _outcome(getattr(jtheory, fn), jtheory.TheoryParams(**kw))
        assert _outcome(getattr(ttheory, fn), ttheory.TheoryParams(**kw)) == want, kw


@pytest.mark.parametrize("fn", ["com_lad_error_term", "lad_error_term"])
def test_error_terms_equal_reference(fn):
    for kw, gamma in itertools.product(PARAMS, (0.0, 1e-4, 0.5)):
        want = _outcome(getattr(jtheory, fn), jtheory.TheoryParams(**kw), gamma)
        got = _outcome(getattr(ttheory, fn), ttheory.TheoryParams(**kw), gamma)
        assert got == want or (math.isnan(got) and math.isnan(want)), (kw, gamma)


def test_lemma_bounds_and_min_d_equal_reference():
    for n, h, d, beta in itertools.product((7, 16, 100), (5, 13, 65), (1, 3, 7), (0.5, 1.0, 2.0)):
        if not (h <= n and d <= n):
            continue
        assert ttheory.lemma1_deviation(n, h, d) == jtheory.lemma1_deviation(n, h, d)
        assert ttheory.lemma2_variance_bound(n, d, beta) == jtheory.lemma2_variance_bound(n, d, beta)
    for n, h, kappa in itertools.product((10, 100, 257), (6, 65, 200), (0.1, 1.5, 8.0)):
        if h < n:
            assert ttheory.min_d_for_improvement(n, h, kappa) == jtheory.min_d_for_improvement(n, h, kappa)


@pytest.mark.parametrize("kw", [dict(n=10, h=5, d=2, kappa=1.0), dict(n=10, h=8, d=0, kappa=1.0),
                                dict(n=10, h=8, d=11, kappa=1.0)])
def test_theory_params_refuse_what_the_reference_refuses(kw):
    for mod in (jtheory, ttheory):
        with pytest.raises(ValueError):
            mod.TheoryParams(**kw)


def test_paper_example_min_d():
    """Section VI: N=100, H=65, kappa=1.5 -> improvement for d >= 3."""
    assert ttheory.min_d_for_improvement(100, 65, 1.5) == 3


def test_error_falls_with_d_and_rises_with_delta():
    """Figs. 3 and 2: the error order shrinks as d grows and grows with delta."""
    by_d = [ttheory.com_lad_error_order(ttheory.TheoryParams(n=100, h=65, d=d, kappa=1.5, delta=0.5))
            for d in range(1, 101)]
    assert all(a >= b - 1e-12 for a, b in zip(by_d, by_d[1:]))
    by_delta = [ttheory.com_lad_error_order(ttheory.TheoryParams(n=100, h=65, d=5, kappa=1.5, delta=dl))
                for dl in (0.0, 0.25, 0.5, 1.0, 2.0)]
    assert all(a <= b + 1e-12 for a, b in zip(by_delta, by_delta[1:]))


def test_lad_is_com_lad_at_delta_zero():
    """xi_1, xi_2 equal kappa_1, kappa_2 at delta=0; the printed xi_3, xi_4
    carry twice the substituted lam-term (the paper's inconsistency, see
    theory.xis)."""
    p = ttheory.TheoryParams(n=64, h=40, d=8, kappa=1.2, beta=2.0, delta=0.0)
    k1, k2, k3, k4 = ttheory.kappas(p)
    x1, x2, x3, x4 = ttheory.xis(p)
    assert (k1, k2) == pytest.approx((x1, x2), rel=1e-12)
    assert x3 == pytest.approx(2.0 * k3, rel=1e-12)
    assert x4 - 2.0 / p.n**2 == pytest.approx(2.0 * (k4 - 2.0 / p.n**2), rel=1e-12)
    p = ttheory.TheoryParams(n=50, h=30, d=50, kappa=1.0)
    assert ttheory.lad_error_order(p) == 0.0 and ttheory.xis(p)[:3] == (0.0, 0.0, 0.0)


def test_baseline_comparison_eq35_vs_eq36():
    n, h, kappa = 100, 65, 1.5
    dmin = ttheory.min_d_for_improvement(n, h, kappa)
    hi = ttheory.TheoryParams(n=n, h=h, d=dmin, kappa=kappa)
    lo = ttheory.TheoryParams(n=n, h=h, d=max(dmin - 1, 1), kappa=kappa)
    assert ttheory.lad_error_order(hi) <= ttheory.baseline_error_order(hi) + 1e-9
    assert ttheory.lad_error_order(lo) > ttheory.baseline_error_order(hi) * 0.9


@pytest.mark.parametrize("name", ["mean", "median", "geomed", "cwtm", "krum", "multi_krum", "cwtm-nnm",
                                  "median-nnm", "mcc", "tgn"])
def test_kappa_bound_equals_reference(name):
    for n, h in ((100, 100), (100, 80), (100, 51), (100, 50), (10, 3), (16, 13)):
        assert tagg.kappa_bound(name, n, h) == jagg.kappa_bound(name, n, h), (n, h)
    with pytest.raises(KeyError):
        tagg.kappa_bound("bogus", 10, 8)


# ------------------------------------------------------------- task matrices


@pytest.mark.parametrize("n,d", [(12, 4), (12, 1), (12, 12), (100, 4), (9, 3)])
def test_fractional_repetition_matrix_equals_reference(n, d):
    got = ttm.fractional_repetition_matrix(n, d)
    np.testing.assert_array_equal(got, jtm.fractional_repetition_matrix(n, d))
    assert ttm.is_column_balanced(got) and (got.sum(axis=1) == d).all()
    np.testing.assert_array_equal(ttm.column_counts(got), jtm.column_counts(got))


def test_fractional_repetition_needs_d_to_divide_n():
    with pytest.raises(ValueError):
        ttm.fractional_repetition_matrix(10, 4)


@pytest.mark.parametrize("n", [2, 5, 8, 16, 30])
def test_assignment_deviation_equals_reference_and_lemma1(n):
    """The generic evaluation (eqs. 38-41) equals the reference's exactly,
    and on the cyclic matrix the closed form of eq. (17)."""
    rng = np.random.default_rng(n)
    for d in sorted({1, max(1, n // 3), n}):
        s = ttm.cyclic_task_matrix(n, d)
        for h in sorted({n // 2 + 1, n}):
            assert ttm.assignment_deviation(s, h) == jtm.assignment_deviation(s, h)
            assert ttm.assignment_deviation(s, h) == pytest.approx(ttheory.lemma1_deviation(n, h, d), rel=1e-9,
                                                                   abs=1e-12)
        unbalanced = np.zeros((n, n), dtype=np.int32)
        for i in range(n):
            unbalanced[i, rng.choice(n, size=d, replace=False)] = 1
        assert ttm.is_column_balanced(unbalanced) == jtm.is_column_balanced(unbalanced)
        assert ttm.assignment_deviation(unbalanced, n // 2 + 1) == jtm.assignment_deviation(unbalanced, n // 2 + 1)


def test_cyclic_beats_unbalanced_matrices():
    """Lemma 1: the column-balanced cyclic matrix attains the infimum."""
    n, h, d = 8, 6, 3
    base = ttm.assignment_deviation(ttm.cyclic_task_matrix(n, d), h)
    rng = np.random.default_rng(0)
    for _ in range(50):
        s = np.zeros((n, n), dtype=np.int32)
        for i in range(n):
            s[i, rng.choice(n, size=d, replace=False)] = 1
        assert ttm.assignment_deviation(s, h) >= base - 1e-12


# --------------------------------------------------------------- sol_err


@pytest.fixture(scope="module")
def problem():
    z, y = jax_problem(jax.random.PRNGKey(0), n=100, dim=100, sigma_h=0.3)
    return np.array(z), np.array(y)


@pytest.mark.parametrize("name", ["LAD-CWTM-d10", "DRACO-d41"])
def test_with_sol_err_matches_reference(problem, name):
    """``sol_err`` against the reference's: the gap within the two ``x*``'s
    distance plus the trajectory tolerance. DRACO-d41 solves the wide
    (82, 100) system: the minimum-norm solution on both sides."""
    from test_torch_engine import STEPS, TRAJECTORY_RTOL, _replayed

    z, y = problem
    jrow, trow = jscn.PAPER_FIG4[name], tscn.PAPER_FIG4[name]
    jres = jscn.run_scenario(jrow, STEPS, problem=(jnp.asarray(z), jnp.asarray(y)), mode="scan", with_sol_err=True)
    zt, yt = torch.tensor(z), torch.tensor(y)
    tres = tscn.run_scenario(trow, STEPS, problem=(zt, yt), device="cpu", with_sol_err=True,
                             randomness=_replayed(trow.protocol(), 0, STEPS, z.shape[1]))
    n = trow.n_devices
    x_ref = np.asarray(jnp.linalg.lstsq(jnp.asarray(z[:n]), jnp.asarray(y[:n]))[0], np.float64)
    x_port = tscn.least_squares(zt[:n], yt[:n]).double().numpy()
    gap = float(np.linalg.norm(x_port - x_ref))
    assert gap <= 1e-3 * float(np.linalg.norm(x_ref))  # the float32 solve's error
    want = np.asarray(jres.metrics["sol_err"])
    got = tres.metrics["sol_err"].numpy()
    assert np.all(np.abs(got - want) <= gap + TRAJECTORY_RTOL * want), (got - want, gap)
    np.testing.assert_allclose(tres.metrics["loss"].numpy(), np.asarray(jres.metrics["loss"]), rtol=TRAJECTORY_RTOL)
    assert "sol_err" not in tscn.run_scenario(trow, 2, problem=(zt, yt), device="cpu").metrics


def test_least_squares_is_the_float64_solution():
    rng = np.random.default_rng(1)
    z, x = rng.standard_normal((30, 12)), rng.standard_normal(12)
    y = z @ x
    got = tscn.least_squares(torch.tensor(z, dtype=torch.float32), torch.tensor(y, dtype=torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), x, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- statistics


def _grads(n=16, q=64, beta=1.0, seed=0):
    """Subset gradients with mean exactly 1 per coordinate and heterogeneity beta."""
    dev = np.random.default_rng(seed).standard_normal((n, q))
    dev -= dev.mean(axis=0, keepdims=True)
    return torch.tensor(1.0 + beta * dev, dtype=torch.float32)


def _coded(cfg, g: torch.Tensor, rounds: int, seed: int) -> torch.Tensor:
    """Every device's eq.-(5) coded vector over ``rounds`` of the port's
    draws: (rounds, N, Q)."""
    recs = tengine.stack_rounds(tengine.draw_rounds(cfg, g.shape[1], rounds,
                                                    torch.Generator().manual_seed(seed)), "cpu")
    assign = ttm.assignment_from(recs.task_index, recs.subset_perm, cfg.effective_d())
    w = torch.full((cfg.effective_d(),), 1.0 / cfg.effective_d())
    return tops.gather_combine(g.expand((rounds,) + tuple(g.shape)).contiguous(), assign.subsets, w)


def test_lemma1_honest_average_deviation():
    """Lemma 1 by Monte Carlo over the port's assignments: with the
    Byzantine rows fixed, E||(1/(dH)) sum_{honest} S_{T_i} - (1/N) 1||^2 is
    (N-H)(N-d) / (d H (N-1) N), within 5 standard errors over 4000 rounds."""
    n, d, n_byz, rounds = 16, 4, 5, 4000
    cfg = tbyz.ProtocolConfig(n_devices=n, d=d, n_byz=n_byz, attack=AttackSpec("sign_flip", n_byz=n_byz))
    recs = tengine.stack_rounds(tengine.draw_rounds(cfg, 1, rounds, torch.Generator().manual_seed(3)), "cpu")
    assign = ttm.assignment_from(recs.task_index, recs.subset_perm, d)
    honest = (recs.byz_mask == 0).double()  # (rounds, N)
    counts = torch.zeros((rounds, n), dtype=torch.float64)
    counts.scatter_add_(1, assign.subsets.reshape(rounds, -1),
                        honest[..., None].expand(rounds, n, d).reshape(rounds, -1))
    h = n - n_byz
    dev = ((counts / (d * h) - 1.0 / n) ** 2).sum(-1)
    want = ttheory.lemma1_deviation(n, h, d)
    assert abs(float(dev.mean()) - want) <= 5 * float(dev.std()) / math.sqrt(rounds), (float(dev.mean()), want)


def test_encoder_unbiased():
    """E[g_i] = mu (eq. 44): the coded vectors average to the subsets' mean."""
    g = _grads(n=8, q=16)
    cfg = tbyz.ProtocolConfig(n_devices=8, d=3, n_byz=0, aggregator="mean", attack=AttackSpec("none"))
    est = tengine.protocol_rounds(cfg, g, 600, device="cpu").mean(0)
    mu = g.mean(0)
    assert float((est - mu).norm() / mu.norm()) < 0.02


def test_redundancy_reduces_variance_as_lemma2():
    """Lemma 2: Var(g_i) falls with d as (N-d) / (d (N-1)); d = N sends mu."""
    n, q, beta = 16, 32, 2.0
    g = _grads(n=n, q=q, beta=beta, seed=1)
    mu = g.mean(0)

    def coded_var(d, rounds=250):
        cfg = tbyz.ProtocolConfig(n_devices=n, d=d, n_byz=0, aggregator="mean", attack=AttackSpec("none"))
        return float(((_coded(cfg, g, rounds, seed=d) - mu) ** 2).sum(-1).mean())

    v1, v4, v16 = coded_var(1), coded_var(4), coded_var(16)
    assert v4 < 0.5 * v1 and v16 < 1e-9
    expected = ttheory.lemma2_variance_bound(n, 4, 1.0) / ttheory.lemma2_variance_bound(n, 1, 1.0)
    assert v4 / v1 == pytest.approx(expected, rel=0.35)


def test_d_equals_n_immune_to_attack():
    n = 12
    g = _grads(n=n, q=24, beta=3.0, seed=2)
    cfg = tbyz.ProtocolConfig(n_devices=n, d=n, n_byz=4, aggregator="cwtm", trim_frac=0.34,
                              attack=AttackSpec("sign_flip", n_byz=4))
    out = tengine.protocol_rounds(cfg, g, 5, device="cpu")
    np.testing.assert_allclose(out.numpy(), g.mean(0).expand(5, -1).numpy(), rtol=1e-4, atol=1e-5)


def test_lad_beats_plain_under_attack():
    """The paper's core claim: redundancy tightens the aggregation error
    under attack and heterogeneity, averaged over rounds."""
    n = 16
    g = _grads(n=n, q=48, beta=4.0, seed=3)

    def err(d, rounds=150):
        cfg = tbyz.ProtocolConfig(n_devices=n, d=d, n_byz=4, aggregator="cwtm", trim_frac=0.25,
                                  attack=AttackSpec("sign_flip", n_byz=4))
        out = tengine.protocol_rounds(cfg, g, rounds, randomness=torch.Generator().manual_seed(d), device="cpu")
        return float(((out - g.mean(0)) ** 2).sum(-1).mean())

    assert err(8) < 0.6 * err(1)


def test_draco_exact_recovery():
    n, d = 12, 4
    g = _grads(n=n, q=20, beta=5.0, seed=4)
    cfg = tbyz.ProtocolConfig(n_devices=n, d=d, method="draco", n_byz=1, attack=AttackSpec("sign_flip", n_byz=1))
    out = tengine.protocol_rounds(cfg, g, 4, device="cpu")
    np.testing.assert_allclose(out.numpy(), g.mean(0).expand(4, -1).numpy(), rtol=1e-4, atol=1e-5)


def test_com_lad_error_floor_under_compression():
    """Theorem 1: a bounded error floor under compression, which d = N
    shrinks."""
    n = 16
    g = _grads(n=n, q=64, beta=1.0, seed=5)
    mu = g.mean(0)

    def run(d):
        cfg = tbyz.ProtocolConfig(n_devices=n, d=d, n_byz=3, aggregator="cwtm", trim_frac=0.2,
                                  attack=AttackSpec("sign_flip", n_byz=3),
                                  compression=CompressionSpec("rand_sparse", q_hat_frac=0.5))
        out = tengine.protocol_rounds(cfg, g, 200, device="cpu")
        return float((out.mean(0) - mu).norm() / mu.norm())

    err4 = run(4)
    assert err4 < 1.0 and run(16) < err4


def test_theory_module_is_a_copy():
    """The port's theory module names everything the reference's does."""
    assert set(jtheory.__all__) <= set(ttheory.__all__)
    assert [f.name for f in dataclasses.fields(ttheory.TheoryParams)] == [
        f.name for f in dataclasses.fields(jtheory.TheoryParams)]
