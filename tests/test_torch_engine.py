"""The port's trainer against the JAX reference's, on the CPU.

The paper's Section-VII rows run through ``repro.core.scenarios.run_scenario``
(the reference's compiled scan) and ``repro_torch.core.scenarios.run_scenario``
on the same ``(Z, y)``, with the port's per-round randomness replayed from
the reference's keys (``fold_in(PRNGKey(seed), t)``, split as in
``tests/test_torch_protocol.py``).

Tolerance: relative 2e-6 on every per-round ``loss``, ``agg_dist``,
``grad_norm`` and on the final ``x``; ``n_report`` under partial
participation bitwise. The port sums in other orders than
XLA (the eq.-(5) encode, NNM's mix, the server means), each round differing
by fp32 rounding; the step size is small, so the differences do not grow
with rounds. On this problem, over these 30 rounds, every metric agrees to
a few 1e-7 relative, about ten times inside the tolerance.

Selections (NNM's neighbours, TGN's kept rows) are discrete: where two
candidates lie within the distances' fp32 rounding of the cut-off, the two
sides may pick differently, and the curves part. The 30-round rows above
have no such round. ``test_selection_rows_match_reference_round_by_round``
runs three rows where one comes within 200 rounds (cwtm-nnm and tgn-nnm
under random sparsification, and geomed, whose aggregate's norm falls to
a fifth of its median): every round of the port is held against the
reference's round on the port's own input, and a round that differs, or
the round where the curves part, must show a pick within the Gram's fp32
rounding bound of the cut-off (and, where the two selections on one input
differ, every differing pick within it). Past that round the curves are
not held. ``grad_norm`` there is held on the scale of the aggregate's
typical norm (the run's median), as ``agg_dist`` is on its round's
``grad_norm``: where the aggregate nearly cancels, its norm keeps the
rounding of the vectors summed.

Under the erasure decode, and under DRACO's decode where every group keeps
an honest majority (DRACO-d41), the aggregate is the honest mean up to
rounding, so ``agg_dist`` (their distance) is rounding noise, some 1e-7 of the
vectors' norm, and differs between the two sides by as much: there it is
held to ``2e-6 * grad_norm`` of its round (the scale of the two vectors it
subtracts) on top of the relative 2e-6.

The QSGD row rounds the port's own pre-quantization vectors, which differ
from the reference's by a few ulps: where a draw lies that close to its
remainder the two trainers round to different levels (a flip, see
tests/test_torch_protocol.py). The row records the port's vectors of every
round and asserts that every draw lies more than ``2 * levels * 2^-20``
from its remainder (the margin of the round test) before it holds the
curves to the tolerance; its seed, 30, was chosen so.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.core import engine as jengine
from repro.core import scenarios as jscn
from repro.data.synthetic import linear_regression_problem as jax_problem
from repro.data.synthetic import linreg_loss as jax_loss
from repro.data.synthetic import linreg_subset_grads as jax_grads
from repro_torch import convert
from repro_torch.core import aggregators as tagg
from repro_torch.core import engine as tengine
from repro_torch.core import scenarios as tscn
from repro_torch.data.synthetic import linreg_loss, linreg_subset_grads
from repro_torch.kernels import ops as tops
from test_torch_protocol import _quant_y, flip_margin, jax_round_randomness

TRAJECTORY_RTOL = 2e-6
STEPS = 30
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def problem():
    z, y = jax_problem(jax.random.PRNGKey(0), n=100, dim=100, sigma_h=0.3)
    return np.asarray(z), np.asarray(y)


def _replayed(cfg, seed: int, steps: int, q: int):
    key = jax.random.PRNGKey(seed)
    rands = [jax_round_randomness(cfg, jax.random.fold_in(key, t), q) for t in range(steps)]
    return lambda t: rands[t]


def _assert_metrics_close(jres, tres, names):
    for name in names:
        np.testing.assert_allclose(tres.metrics[name].numpy(), np.asarray(jres.metrics[name]),
                                   rtol=TRAJECTORY_RTOL, err_msg=name)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=TRAJECTORY_RTOL,
                               atol=TRAJECTORY_RTOL * float(np.max(np.abs(np.asarray(jres.x)))))


ROWS = [("PAPER_FIG4", name) for name in ("VA", "CWTM", "CWTM-NNM", "LAD-CWTM-d10", "LAD-CWTM-NNM-d10",
                                          "DRACO-d41")]
ROWS += [("PAPER_FIG6", name) for name in ("Com-CWTM", "Com-LAD-CWTM")]


@pytest.mark.parametrize("fig,name", ROWS, ids=[n for _, n in ROWS])
def test_run_scenario_matches_reference(problem, fig, name):
    z, y = problem
    jres = jscn.run_scenario(getattr(jscn, fig)[name], STEPS, seed=0,
                             problem=(jnp.asarray(z), jnp.asarray(y)), mode="scan")
    state = convert.state_from_numpy(np.zeros(z.shape[1]), 0, z, y, device="cpu")
    scn = getattr(tscn, fig)[name]
    tres = tscn.run_scenario(scn, STEPS, problem=(state.z, state.y), device="cpu",
                             randomness=_replayed(scn.protocol(), 0, STEPS, z.shape[1]))
    if scn.method == "draco":  # the decode is exact: agg_dist is rounding noise
        _assert_metrics_close(jres, tres, ("loss", "grad_norm"))
        _assert_agg_dist_close(jres, tres)
    else:
        _assert_metrics_close(jres, tres, ("loss", "agg_dist", "grad_norm"))


def test_quant_row_matches_reference(problem, monkeypatch):
    """Com-LAD-CWTM with QSGD at 4 levels (the fleet's ``quant:4``)."""
    z, y = problem
    seed = 30
    jrow = dataclasses.replace(jscn.PAPER_FIG6["Com-LAD-CWTM"], compressor="quant:4")
    trow = dataclasses.replace(tscn.PAPER_FIG6["Com-LAD-CWTM"], compressor="quant:4")
    jres = jscn.run_scenario(jrow, STEPS, seed=seed, problem=(jnp.asarray(z), jnp.asarray(y)), mode="scan")
    seen = []
    quantize = tops.stochastic_quantize

    def recording(g, u, levels, block):
        seen.append((_quant_y(g.numpy(), trow.protocol().compression), u.numpy()))
        return quantize(g, u, levels, block)

    monkeypatch.setattr(tops, "stochastic_quantize", recording)
    tres = tscn.run_scenario(trow, STEPS, problem=(torch.tensor(z), torch.tensor(y)), device="cpu",
                             randomness=_replayed(trow.protocol(), seed, STEPS, z.shape[1]))
    assert len(seen) == STEPS
    assert min(flip_margin(yv, u) for yv, u in seen) > 2 * 4 * 2.0**-20
    _assert_metrics_close(jres, tres, ("loss", "agg_dist", "grad_norm"))


def _assert_agg_dist_close(jres, tres):
    """agg_dist within relative 2e-6, or within 2e-6 of the round's
    grad_norm where the aggregate equals the honest mean up to rounding."""
    got, want = tres.metrics["agg_dist"].numpy(), np.asarray(jres.metrics["agg_dist"])
    scale = np.asarray(jres.metrics["grad_norm"])
    assert np.all(np.abs(got - want) <= TRAJECTORY_RTOL * (np.abs(want) + scale)), (got, want)


PART_ROWS = [("iid", "decode"), ("iid", "cwtm"), ("onoff", "mean"), ("adversarial", "decode"),
             ("adversarial", "mean"), ("markov", "cwtm")]


@pytest.fixture(scope="module")
def small_problem():
    z, y = jax_problem(jax.random.PRNGKey(0), n=16, dim=32, sigma_h=0.3)
    return np.array(z), np.array(y)


@pytest.mark.parametrize("sched,agg", PART_ROWS, ids=[f"{s}-{a}" for s, a in PART_ROWS])
def test_participation_rows_match_reference(small_problem, sched, agg):
    """``participation_sweep`` rows (N=16, d=4, dim=32, sign-flip with 3
    Byzantine devices), the schedules' draws replayed."""
    z, y = small_problem
    kw = dict(schedules=(sched,), aggregators=(agg,), n_byz=3)
    (jrow,), (trow,) = jscn.participation_sweep(**kw), tscn.participation_sweep(**kw)
    assert dataclasses.asdict(trow) == {k: v for k, v in dataclasses.asdict(jrow).items() if k != "backend"}
    jres = jscn.run_scenario(jrow, STEPS, seed=0, problem=(jnp.asarray(z), jnp.asarray(y)), dim=32, mode="scan")
    tres = tscn.run_scenario(trow, STEPS, problem=(torch.from_numpy(z), torch.from_numpy(y)), device="cpu",
                             randomness=_replayed(trow.protocol(), 0, STEPS, z.shape[1]))
    np.testing.assert_array_equal(tres.metrics["n_report"].numpy(), np.asarray(jres.metrics["n_report"]))
    _assert_metrics_close(jres, tres, ("loss", "grad_norm"))
    _assert_agg_dist_close(jres, tres)


def test_participation_state_carries_across(small_problem):
    """A markov run cut in two and resumed through ``convert`` equals the
    uncut run bitwise, and the uncut run matches the reference."""
    z, y = small_problem
    kw = dict(schedules=("markov",), aggregators=("decode",))
    (jrow,), (trow,) = jscn.participation_sweep(**kw), tscn.participation_sweep(**kw)
    cfg = trow.protocol()
    replay = _replayed(cfg, 5, 20, z.shape[1])

    def run(steps, state, offset):
        return tengine.run_trajectory(
            cfg, state.x, lambda data, x: linreg_subset_grads(data[0], data[1], x), steps=steps, lr=trow.lr,
            randomness=lambda t: replay(t + offset), grad_scale=16.0,
            loss_fn=lambda data, xs: linreg_loss(data[0], data[1], xs), data=(state.z, state.y),
            opt_state=state.opt_state, participation_state=state.participation_state, device="cpu")

    whole = run(20, convert.state_from_numpy(np.zeros(32), 0, z, y, device="cpu"), 0)
    first = convert.result_to_numpy(run(10, convert.state_from_numpy(np.zeros(32), 0, z, y, device="cpu"), 0))
    resumed = run(10, convert.state_from_numpy(first["x"], first["step"], z, y,
                                               participation_state=first["participation_state"], device="cpu"), 10)
    assert torch.equal(resumed.x, whole.x)
    assert torch.equal(resumed.metrics["n_report"], whole.metrics["n_report"][10:])
    assert torch.equal(resumed.participation_state, whole.participation_state)
    jres = jengine.run_trajectory(
        jrow.protocol(), jax.random.PRNGKey(5), jnp.zeros(32), lambda data, x: jax_grads(data[0], data[1], x),
        steps=20, lr=jrow.lr, grad_scale=16.0, loss_fn=lambda data, x: jax_loss(data[0], data[1], x),
        mode="loop", data=(jnp.asarray(z), jnp.asarray(y)))
    np.testing.assert_array_equal(whole.metrics["n_report"].numpy(), np.asarray(jres.metrics["n_report"]))
    _assert_metrics_close(jres, whole, ("loss", "grad_norm"))
    _assert_agg_dist_close(jres, whole)


def test_run_trajectory_from_carried_state_matches_reference(problem):
    """Both trainers start from the same non-zero iterate, SGD step and
    ``x_star``, carried across with ``convert``."""
    z, y = problem
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal(z.shape[1]).astype(np.float32)
    x_star = np.linalg.lstsq(z.astype(np.float64), y.astype(np.float64), rcond=None)[0]
    scn = jscn.PAPER_FIG4["LAD-CWTM-d10"]
    jres = jengine.run_trajectory(
        scn.protocol(), jax.random.PRNGKey(3), jnp.asarray(x0),
        lambda data, x: jax_grads(data[0], data[1], x), steps=10, lr=scn.lr,
        grad_scale=100.0, loss_fn=lambda data, x: jax_loss(data[0], data[1], x),
        x_star=jnp.asarray(x_star, jnp.float32), mode="loop", data=(jnp.asarray(z), jnp.asarray(y)))
    state = convert.state_from_numpy(x0, 5, z, y, x_star, device="cpu")
    tcfg = tscn.PAPER_FIG4["LAD-CWTM-d10"].protocol()
    tres = tengine.run_trajectory(
        tcfg, state.x, lambda data, x: linreg_subset_grads(data[0], data[1], x), steps=10,
        lr=scn.lr, randomness=_replayed(tcfg, 3, 10, z.shape[1]), grad_scale=100.0,
        loss_fn=lambda data, xs: linreg_loss(data[0], data[1], xs), x_star=state.x_star,
        data=(state.z, state.y), opt_state=state.opt_state, device="cpu")
    _assert_metrics_close(jres, tres, ("loss", "agg_dist", "grad_norm", "sol_err"))
    out = convert.result_to_numpy(tres)
    assert out["step"] == 15
    np.testing.assert_array_equal(out["x"], tres.x.numpy())
    assert out["loss"].shape == (10,)


@pytest.mark.parametrize("name", ["LAD-CWTM-NNM-d10", "Com-LAD-CWTM"])
def test_torch_provider_is_reproducible(name):
    """Seeding the production provider twice gives the same bits."""
    scn = {**tscn.PAPER_FIG4, **tscn.PAPER_FIG6}[name]
    a = tscn.run_scenario(scn, 20, seed=7, device="cpu")
    b = tscn.run_scenario(scn, 20, seed=7, device="cpu")
    assert torch.equal(a.x, b.x)
    for k in a.metrics:
        assert torch.equal(a.metrics[k], b.metrics[k])
    assert not torch.equal(a.x, tscn.run_scenario(scn, 20, seed=8, device="cpu").x)


@pytest.mark.parametrize("field", ["subset_perm", "task_index", "byz_mask", "keep_idx", "attack_noise"])
def test_provider_records_are_validated_before_the_round(field):
    """A record from a caller's provider is checked where it enters the
    trainer: the kernel wrapper reads no ids back on the card."""
    from repro_torch.core.byzantine import sample_round_randomness

    scn = tscn.PAPER_FIG6["Com-LAD-CWTM"]
    good = sample_round_randomness(scn.protocol(), 100, torch.Generator().manual_seed(0))
    bad = {"subset_perm": torch.zeros(100, dtype=torch.int64),
           "task_index": torch.arange(1, 101),
           "byz_mask": torch.full((100,), 0.5),
           "keep_idx": good.keep_idx + 100,
           "attack_noise": torch.full((100, 100), float("nan"))}[field]
    rand = dataclasses.replace(good, **{field: bad})
    with pytest.raises(ValueError, match=field):
        tscn.run_scenario(scn, 2, randomness=lambda t: rand, device="cpu")
    tscn.run_scenario(scn, 2, randomness=lambda t: good, device="cpu")


def test_run_scenario_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscn.run_scenario(tscn.PAPER_FIG4["VA"], 2)


def test_paper_rows_match_reference_rows():
    """The port's figure rows are the reference's."""
    for fig in ("PAPER_FIG4", "PAPER_FIG5", "PAPER_FIG6"):
        want = getattr(jscn, fig)
        got = getattr(tscn, fig)
        assert sorted(got) == sorted(want)
        for k, row in got.items():
            for field in ("method", "d", "aggregator", "attack", "n_byz", "compressor",
                          "q_hat_frac", "sigma_h", "trim_frac", "n_devices", "lr"):
                assert getattr(row, field) == getattr(want[k], field), (fig, k, field)


def _fields(row) -> dict:
    return {k: v for k, v in dataclasses.asdict(row).items() if k != "backend"}


def test_section7_grid_rows_match_reference_rows():
    """15 rows: 3 methods x 3 attacks x 2 compressors, DRACO's compressed
    rows dropped, its N rounded down to a multiple of d, its rows named
    ``vote``."""
    got, want = tscn.section7_grid(), jscn.section7_grid()
    assert len(got) == len(want) == 15
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    kw = dict(methods=(("draco", 6), ("lad", 5)), aggregators=("cwtm", "median"), sigma_levels=(0.0, 0.3))
    assert [_fields(r) for r in tscn.section7_grid(**kw)] == [_fields(r) for r in jscn.section7_grid(**kw)]


# one DRACO row and one Com-LAD row of the grid, and a Weiszfeld server under gaussian noise
GRID_ROWS = ["draco-d4/vote/alie/s0.3", "lad-d10/cwtm/ipm/rand_sparse/s0.3", "lad-d10/geomed/gaussian/s0.3"]


def _grid_row(mod, name):
    if name.startswith("lad-d10/geomed"):
        return mod.Scenario(name=name, method="lad", d=10, aggregator="geomed", attack="gaussian")
    return {row.name: row for row in mod.section7_grid()}[name]


@pytest.mark.parametrize("name", GRID_ROWS)
def test_section7_rows_match_reference(problem, name):
    z, y = problem
    jrow, trow = _grid_row(jscn, name), _grid_row(tscn, name)
    assert _fields(trow) == _fields(jrow)
    jres = jscn.run_scenario(jrow, STEPS, seed=0, problem=(jnp.asarray(z), jnp.asarray(y)), mode="scan")
    tres = tscn.run_scenario(trow, STEPS, problem=(torch.from_numpy(z), torch.from_numpy(y)), device="cpu",
                             randomness=_replayed(trow.protocol(), 0, STEPS, z.shape[1]))
    _assert_metrics_close(jres, tres, ("loss", "agg_dist", "grad_norm"))


def test_graph_mode_raises_on_the_cpu():
    """Graph mode captures a CUDA graph: on the CPU it raises and never
    falls back to the loop."""
    with pytest.raises(ValueError, match="CUDA"):
        tscn.run_scenario(tscn.PAPER_FIG4["VA"], 2, device="cpu", mode="graph")
    with pytest.raises(ValueError, match="mode"):
        tscn.run_scenario(tscn.PAPER_FIG4["VA"], 2, device="cpu", mode="scan")


@pytest.mark.parametrize("row", ["DRACO-d41", "Com-LAD-CWTM", "markov", "geomed-gaussian"])
@pytest.mark.parametrize("source", ["generator", "provider"])
def test_graph_draws_equal_loop_draws(monkeypatch, row, source):
    """What graph mode draws up front, stacked and selected by a step
    counter, equals record for record what loop mode hands each round (as
    the one lane of a batched round: a leading axis of 1)."""
    from repro_torch.core import byzantine as tbyz

    scn = {"DRACO-d41": tscn.PAPER_FIG4["DRACO-d41"], "Com-LAD-CWTM": tscn.PAPER_FIG6["Com-LAD-CWTM"],
           "markov": tscn.participation_sweep(schedules=("markov",), aggregators=("decode",))[0],
           "geomed-gaussian": _grid_row(tscn, "lad-d10/geomed/gaussian/s0.3")}[row]
    cfg, steps, q = scn.protocol(), 6, 100
    seen = []
    real_round = tengine.protocol_round
    monkeypatch.setattr(tengine, "protocol_round", lambda cfg, g, rand, **kw: (
        seen.append(rand), real_round(cfg, g, rand, **kw))[1])

    def randomness():
        gen = torch.Generator().manual_seed(9)
        if source == "generator":
            return gen
        recs = [tbyz.sample_round_randomness(cfg, q, gen) for _ in range(steps)]
        return lambda t: recs[t]

    tscn.run_scenario(scn, steps, randomness=randomness(), device="cpu")
    stacked = tengine.stack_rounds(tengine.draw_rounds(cfg, q, steps, randomness()), "cpu")
    assert len(seen) == steps
    for t, rand in enumerate(seen):
        got = tengine.select_round(stacked, torch.tensor(t))
        for f in dataclasses.fields(rand):
            a, b = getattr(rand, f.name), getattr(got, f.name)
            assert (a is None) == (b is None), f.name
            assert a is None or (a.shape[0] == 1 and torch.equal(a[0], b)), (t, f.name)


def test_chip_smoke_wide_q_is_smollm_360m_parameter_count():
    from repro import models
    from repro.configs.archs import ARCHS

    shapes = jax.eval_shape(lambda k: models.init(k, ARCHS["smollm-360m"])[0], jax.random.PRNGKey(0))
    count = sum(math.prod(leaf.shape) for leaf in jax.tree.leaves(shapes))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.WIDE_Q == count == 361_821_120


# ------------------------------------------------- selections (ROADMAP C.6)

C6_STEPS = 200
C6_ROWS = [("lad", 10, "cwtm-nnm", "alie", "rand_sparse"), ("lad", 10, "tgn-nnm", "gaussian", "rand_sparse"),
           ("plain", 1, "geomed", "sign_flip", "none")]


def _gram_error_bound(q: int) -> float:
    """gamma_Q of a Q-term fp32 dot product: |fl(a.b) - a.b| <= gamma_Q sum |a_k b_k|."""
    u = 2.0 ** -24
    return q * u / (1 - q * u)


def _cutoff_margins(values: torch.Tensor, keep: int, bound) -> torch.Tensor:
    """Per row of ``values`` (rows, M), float64: the least ``(v_b - v_a) /
    bound(a, b)`` over a among the ``keep`` smallest (ties to the lower
    index) and b among the rest, with ``v_a < v_b``. Exactly equal values
    (identical rows, such as the colluding ALIE rows) order by index on both
    sides alike and are no margin. Below 1, a pick lies within the rounding
    bound of the cut-off."""
    order = torch.sort(values, dim=-1, stable=True).indices
    sel, rest = order[:, :keep], order[:, keep:]
    va, vb = torch.gather(values, 1, sel), torch.gather(values, 1, rest)
    ratio = (vb[:, None, :] - va[:, :, None]) / bound(sel[:, :, None], rest[:, None, :])
    return torch.where(vb[:, None, :] > va[:, :, None], ratio, torch.inf).flatten(1).min(dim=1).values


def _selections(cfg, stack: torch.Tensor) -> list[tuple[str, torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The server's selections on the port's transmitted ``stack`` (N, Q):
    (name, the port's picks, the reference's picks, each row's cut-off
    margin): NNM's neighbours (by the Gram distances), and for TGN-NNM
    TGN's kept rows of the port's mixed stack (by their squared norms)."""
    n, q = stack.shape
    gam = _gram_error_bound(q)
    k = n - cfg.n_byz
    x = stack.double()
    sq = (x * x).sum(-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * x @ x.T  # each fp32 side is within 2 gamma_Q (sq_i + sq_j)
    port = tagg.nnm_neighbours(tops.pairwise_sqdist(stack), cfg.n_byz).long()
    ref = torch.from_numpy(np.array(jax.lax.top_k(-jagg._pairwise_sqdist(jnp.asarray(stack.numpy())), k)[1]))
    rows = torch.arange(n)[:, None, None]
    out = [("nnm", port, ref, _cutoff_margins(d2, k, lambda a, b: 2 * gam * (2 * sq[rows] + sq[a] + sq[b])))]
    if cfg.aggregator == "tgn-nnm":
        mixed = tagg.nnm_mix(stack, cfg.n_byz)
        f = min(max(int(0.2 * n), cfg.n_byz), n - 1)
        norms = (mixed.double() ** 2).sum(-1)
        port = tagg._smallest(tagg._sum_last(mixed * mixed), n - f)[None]
        ref = torch.from_numpy(np.array(jax.lax.top_k(-jnp.sum(jnp.asarray(mixed.numpy()) ** 2, axis=1),
                                                      n - f)[1]))[None]
        out.append(("tgn", port, ref, _cutoff_margins(norms[None], n - f,
                                                      lambda a, b: gam * (norms[a] + norms[b]))))
    return out


def _assert_flip_within_margin(cfg, stack: torch.Tensor, t: int) -> None:
    """Round ``t`` may pick differently on the two sides: some pick lies
    within the rounding bound of its cut-off, and where the two sides'
    selections on this one input differ, the rows that differ are such
    picks."""
    least = min(float(m.min()) for _, _, _, m in _selections(cfg, stack))
    assert least <= 1.0, f"round {t}: the curves part, yet every pick clears its cut-off by {least:.3g} bounds"
    for name, port, ref, margin in _selections(cfg, stack):
        for i in range(port.shape[0]):
            if set(port[i].tolist()) != set(ref[i].tolist()):
                assert float(margin[i]) <= 1.0, f"round {t}: {name} row {i} differs with margin {margin[i]:.3g}"


@pytest.mark.parametrize("method,d,agg,attack,comp", C6_ROWS, ids=["/".join(map(str, r)) for r in C6_ROWS])
def test_selection_rows_match_reference_round_by_round(problem, monkeypatch, method, d, agg, attack, comp):
    """Rows whose selections come within rounding of a tie in 200 rounds
    (see the module docstring): every port round against the reference's
    round on the port's input, and the curves up to the round where they
    part, which must be such a tie."""
    from repro.core import byzantine as jbyz

    z, y = problem
    kw = dict(name=f"{method}-d{d}/{agg}/{attack}/{comp}", method=method, d=d, aggregator=agg, attack=attack,
              compressor=comp)
    jrow, trow = jscn.Scenario(**kw), tscn.Scenario(**kw)
    jres = jscn.run_scenario(jrow, C6_STEPS, seed=0, problem=(jnp.asarray(z), jnp.asarray(y)), mode="scan")
    rounds, stacks = [], []
    real_round, real_server = tengine.protocol_round, tengine.make_server_fn

    def recording_round(cfg, grads, rand, **k):
        out = real_round(cfg, grads, rand, **k)
        rounds.append((grads[0].clone(), out[0].clone()))
        return out

    def recording_server(cfg):
        server = real_server(cfg)
        return lambda t: (stacks.append(t[0].clone()), server(t))[1]

    monkeypatch.setattr(tengine, "protocol_round", recording_round)
    monkeypatch.setattr(tengine, "make_server_fn", recording_server)
    tres = tscn.run_scenario(trow, C6_STEPS, problem=(torch.from_numpy(z), torch.from_numpy(y)), device="cpu",
                             randomness=_replayed(trow.protocol(), 0, C6_STEPS, z.shape[1]))
    assert len(rounds) == len(stacks) == C6_STEPS
    cfg = trow.protocol()
    ref_round = jax.jit(lambda key, grads: jbyz.protocol_round(jrow.protocol(), key, grads))
    flips = []
    for t, (grads, got) in enumerate(rounds):
        want = np.asarray(ref_round(jax.random.fold_in(jax.random.PRNGKey(0), t), jnp.asarray(grads.numpy())))
        scale = float(np.abs(want).max())
        if not np.allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * scale):
            _assert_flip_within_margin(cfg, stacks[t], t)
            flips.append(t)

    metric = {k: np.asarray(jres.metrics[k]) for k in ("loss", "agg_dist", "grad_norm")}
    port = {k: tres.metrics[k].numpy() for k in metric}
    typical = float(np.median(metric["grad_norm"]))
    ok = np.abs(port["loss"] - metric["loss"]) <= TRAJECTORY_RTOL * np.abs(metric["loss"])
    ok &= np.abs(port["agg_dist"] - metric["agg_dist"]) <= TRAJECTORY_RTOL * (metric["agg_dist"] + metric["grad_norm"])
    ok &= np.abs(port["grad_norm"] - metric["grad_norm"]) <= TRAJECTORY_RTOL * (metric["grad_norm"] + typical)
    parted = int(np.argmin(ok)) if not ok.all() else None
    if parted is None:
        assert not flips, f"rounds {flips} picked differently, yet the curves agree"
        np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=TRAJECTORY_RTOL,
                                   atol=TRAJECTORY_RTOL * float(np.abs(np.asarray(jres.x)).max()))
    else:
        assert cfg.aggregator.endswith("-nnm"), f"{kw['name']}: the curves part at round {parted} with no selection"
        assert not flips or flips[0] >= parted, (flips, parted)
        _assert_flip_within_margin(cfg, stacks[parted], parted)
