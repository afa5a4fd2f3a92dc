"""The port's lane-batched grid (``repro_torch.core.scenarios.run_grid``) on
the CPU.

Bitwise: every lane of the grid (its buckets in ``mode="loop"``)
equals the port's own ``run_scenario`` of that row with the same seed, bit
for bit, in the final iterate, every metric and the participation state:
with and without a shared problem, with ``exact=False`` (several servers in
one bucket), with draw groups (``gaussian`` beside the kernel attacks),
under ``quant:4`` and the participation schedules, chunked and unchunked.
``protocol_round`` on an ``(N, Q)`` stack is the ``L = 1`` case of the
batched round, and lane ``i`` of a batch equals the single call.

Against the reference: lanes of the port's grid against the reference's
``run_scenario(mode="scan")`` of the same rows, with the port's records
replayed from the reference's keys, within relative 2e-6 as in
``tests/test_torch_engine.py`` (whose docstring gives the tolerance and the
provisions for the decodes' ``agg_dist`` and for QSGD's level flips). The
reference's own ``run_grid`` is not the oracle: on this tree its DRACO lane
misses its standalone run by one ulp (ROADMAP C.4, C.5).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scenarios as jscn
from repro_torch.core import aggregators as tagg
from repro_torch.core import byzantine as tbyz
from repro_torch.core import engine as tengine
from repro_torch.core import scenarios as tscn
from repro_torch.numerics import tree_sum, tree_sum_
from repro_torch.kernels import ops as tops
from repro_torch.optim import make_optimizer
from test_torch_engine import STEPS, _assert_agg_dist_close, _assert_metrics_close, _replayed
from test_torch_protocol import _quant_y, flip_margin

GRID_STEPS = 12
AGGREGATORS = ("cwtm", "cwtm-nnm", "median", "krum", "multi_krum", "geomed", "mcc", "tgn", "mean")


def same_bits(a, b) -> bool:
    """Two results agree bit for bit: iterate, every metric, schedule state."""
    if not torch.equal(a.x, b.x) or sorted(a.metrics) != sorted(b.metrics):
        return False
    if (a.participation_state is None) != (b.participation_state is None):
        return False
    return all(torch.equal(a.metrics[k], b.metrics[k]) for k in a.metrics) and (
        a.participation_state is None or torch.equal(a.participation_state, b.participation_state))


def _small_problem(n=16, dim=12):
    gen = torch.Generator().manual_seed(11)
    return tscn.linear_regression_problem(gen, n=n, dim=dim, sigma_h=0.3)


def _mixed_rows():
    """One bucket under exact=False: every aggregator, attacks cycled."""
    attacks = ("sign_flip", "alie", "ipm")
    return [tscn.Scenario(name=f"mix/{agg}", method="lad", d=4, aggregator=agg, attack=attacks[i % 3],
                          n_byz=3, n_devices=16, lr=1e-5 * (1 + 0.1 * i))
            for i, agg in enumerate(AGGREGATORS)]


def _gaussian_rows():
    """One bucket of two draw groups: gaussian lanes draw noise, the others do not."""
    return [tscn.Scenario(name=f"gauss/{a}/{i}", method="lad", d=4, aggregator="cwtm", attack=a, n_byz=3,
                          n_devices=16, lr=1e-5, sigma_h=0.1 * i)
            for i, a in enumerate(("gaussian", "sign_flip", "gaussian", "alie", "ipm"))]


def _quant_rows():
    return [dataclasses.replace(tscn.PAPER_FIG6[k], name=f"{k}/quant:4", compressor="quant:4", n_devices=16,
                                n_byz=4, d=min(tscn.PAPER_FIG6[k].d, 4))
            for k in ("Com-CWTM", "Com-LAD-CWTM", "Com-LAD-CWTM-NNM")]


def _section7_rows():
    return tscn.section7_grid(n_devices=16, n_byz=3, methods=(("plain", 1), ("lad", 4), ("draco", 4)),
                              aggregators=("cwtm", "cwtm-nnm"), compressors=("none", "rand_sparse"))


# name -> (rows, run_grid keywords)
CASES = {
    "section7": (_section7_rows, dict(dim=12)),
    "section7-shared-problem": (_section7_rows, dict(problem=_small_problem())),
    "mixed-aggregators-exact-false": (_mixed_rows, dict(dim=12, exact=False)),
    "gaussian-draw-groups": (_gaussian_rows, dict(dim=12, exact=False)),
    "quant4": (_quant_rows, dict(dim=40)),
    "participation": (lambda: tscn.participation_sweep(schedules=("iid", "onoff", "adversarial", "markov"),
                                                      aggregators=("decode", "mean", "cwtm"), n_byz=3),
                      dict(dim=12, exact=False)),
    "synthetic-sweep": (lambda: tscn.synthetic_sweep(10), dict(dim=12)),
    "fig4-shared-problem": (lambda: list(tscn.PAPER_FIG4.values()), dict(problem=_small_problem(100, 8))),
    "fig6-exact-false": (lambda: list(tscn.PAPER_FIG6.values()), dict(problem=_small_problem(100, 8),
                                                                     exact=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_grid_lanes_equal_run_scenario_bitwise(case):
    rows_of, kw = CASES[case]
    rows = rows_of()
    grid = tscn.run_grid(rows, GRID_STEPS, seed=3, device="cpu", mode="loop", **kw)
    assert list(grid) == [r.name for r in rows]
    for row in rows:
        alone = tscn.run_scenario(row, GRID_STEPS, seed=3, device="cpu", problem=kw.get("problem"),
                                  dim=kw.get("dim", 100))
        assert same_bits(grid[row.name], alone), row.name


def test_grid_mixes_provided_and_seeded_lanes():
    """A row that ``randomness`` gives a provider draws from it alone; the
    rows it maps to ``None`` draw from their seeded generators, as
    ``run_scenario`` with and without that provider."""
    rows = tscn.synthetic_sweep(4)
    cfg = rows[1].protocol()
    gen = torch.Generator().manual_seed(5)
    recs = [tbyz.sample_round_randomness(cfg, 12, gen) for _ in range(GRID_STEPS)]
    provider = lambda t: recs[t]  # noqa: E731
    grid = tscn.run_grid(rows, GRID_STEPS, dim=12, device="cpu", mode="loop",
                         randomness=lambda scn: provider if scn is rows[1] else None)
    assert grid[rows[0].name].grid.draw_groups == 2
    for row in rows:
        alone = tscn.run_scenario(row, GRID_STEPS, dim=12, device="cpu",
                                  randomness=provider if row is rows[1] else None)
        assert same_bits(grid[row.name], alone), row.name


def test_bucket_counts_match_reference():
    """section7_grid's 15 rows in 5 buckets, PAPER_FIG6 in 2 under
    exact=False, as the reference buckets them."""
    def count(mod, rows, exact):
        return len({mod._bucket_signature(r, exact=exact) for r in rows})

    for jrows, trows, exact, want in ((jscn.section7_grid(), tscn.section7_grid(), True, 5),
                                      (list(jscn.PAPER_FIG6.values()), list(tscn.PAPER_FIG6.values()), False, 2),
                                      (list(jscn.PAPER_FIG4.values()), list(tscn.PAPER_FIG4.values()), True, None)):
        assert count(tscn, trows, exact) == count(jscn, jrows, exact)
        assert want is None or count(tscn, trows, exact) == want


def test_grid_draw_groups_and_branches():
    """Lanes sorted by (server, attack): each server one run, each attack
    one run within its server's."""
    rows = _gaussian_rows()  # one server, four attacks
    grid = tscn.run_grid(rows, 3, dim=12, device="cpu", mode="loop", exact=False)
    stats = grid[rows[0].name].grid
    assert (stats.lanes, stats.draw_groups, stats.chunks, stats.branches) == (5, 2, 1, 1 + 4)
    rows = _mixed_rows()  # nine servers, each under one attack
    stats = tscn.run_grid(rows, 3, dim=12, device="cpu", mode="loop", exact=False)[rows[0].name].grid
    assert (stats.lanes, stats.draw_groups, stats.branches) == (9, 1, 9 + 9)


def test_synthetic_sweep_rows_match_reference_rows():
    got, want = tscn.synthetic_sweep(7, n_devices=100, n_byz=20), jscn.synthetic_sweep(7, n_devices=100, n_byz=20)
    assert [{k: v for k, v in dataclasses.asdict(r).items()} for r in got] == [
        {k: v for k, v in dataclasses.asdict(r).items() if k != "backend"} for r in want]


@pytest.mark.parametrize("per", [1, 3, 11])
def test_chunked_grid_is_bitwise_unchunked(per):
    rows = tscn.synthetic_sweep(7) + tscn.synthetic_sweep(3, aggregator="cwtm-nnm")
    whole = tscn.run_grid(rows, GRID_STEPS, dim=12, device="cpu", mode="loop", exact=False)
    chunked = tscn.run_grid(rows, GRID_STEPS, dim=12, device="cpu", mode="loop", exact=False,
                            max_lanes_per_device=per)
    info = tengine.last_grid_chunk_info()
    assert info == {"max_lanes_per_device": per, "chunk": per, "n_lanes": 10, "devices": 1, "auto": False}
    assert chunked[rows[0].name].grid.chunks == -(-10 // per)
    for row in rows:
        assert same_bits(chunked[row.name], whole[row.name]), row.name


def test_unchunked_grid_reports_one_chunk():
    rows = tscn.synthetic_sweep(4)
    tscn.run_grid(rows, 2, dim=8, device="cpu", mode="loop")
    assert tengine.last_grid_chunk_info() == {"max_lanes_per_device": None, "chunk": 4, "n_lanes": 4,
                                              "devices": 1, "auto": False}


@pytest.mark.parametrize("case", ["auto", "shard", "no-lanes", "mode", "graph-on-cpu", "zero-per-device"])
def test_grid_refusals(case):
    rows = tscn.synthetic_sweep(3)
    kw = dict(dim=8, device="cpu", mode="loop")
    with pytest.raises(ValueError) as err:
        if case == "auto":
            tscn.run_grid(rows, 2, max_lanes_per_device="auto", **kw)
        elif case == "shard":
            tengine.run_grid([r.protocol() for r in rows], torch.zeros(4), None, steps=2, lr=1.0,
                             randomness=[torch.Generator()] * 3, device="cpu", shard="shard_map")
        elif case == "no-lanes":
            tengine.run_grid([], torch.zeros(4), None, steps=2, lr=1.0, randomness=[], device="cpu")
        elif case == "mode":
            tscn.run_grid(rows, 2, mode="scan", dim=8, device="cpu")
        elif case == "graph-on-cpu":
            tscn.run_grid(rows, 2, dim=8, device="cpu")
        else:
            tscn.run_grid(rows, 2, max_lanes_per_device=0, **kw)
    want = {"auto": "A.11", "shard": "A.9b", "no-lanes": "at least one",
            "mode": "mode", "graph-on-cpu": "CUDA", "zero-per-device": ">= 1"}[case]
    assert want in str(err.value)


def test_grid_refuses_lanes_of_different_structure():
    a, b = tscn.synthetic_sweep(2)
    b = dataclasses.replace(b, d=2)
    with pytest.raises(ValueError, match="bucket"):
        tengine.run_grid([a.protocol(), b.protocol()], torch.zeros(4), None, steps=1, lr=1.0,
                         randomness=[torch.Generator(), torch.Generator()], device="cpu")


def test_pad_lanes_and_padded_lane_count():
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(tengine.pad_lanes(x, 2), torch.cat([x, x[-1:], x[-1:]]))
    assert torch.equal(tengine.pad_lanes(x[:, 0], 1), torch.tensor([0.0, 2.0, 4.0, 4.0]))
    assert tengine.pad_lanes(x, 0) is x
    assert tengine.padded_lane_count(5) == 5 and tengine.padded_lane_count(5, 4) == 8
    with pytest.raises(ValueError, match="at least one lane"):
        tengine.padded_lane_count(0)


# ------------------------------------------------------------- one code path


def _round_cfgs():
    """Every attack under one server, every server under one attack, the
    masked servers and DRACO."""
    base = dict(n_devices=16, d=4, n_byz=3)
    cfgs = [tbyz.ProtocolConfig(**base, aggregator="cwtm", attack=tbyz.attack_lib.AttackSpec(a))
            for a in ("none", "zero", "label_shift", "sign_flip", "alie", "ipm", "gaussian")]
    cfgs += [tbyz.ProtocolConfig(**base, aggregator=g, attack=tbyz.attack_lib.AttackSpec("alie"))
             for g in AGGREGATORS + ("tgn-nnm",)]
    cfgs += [tbyz.ProtocolConfig(**base, method="draco", attack=tbyz.attack_lib.AttackSpec("sign_flip")),
             tbyz.ProtocolConfig(**base, aggregator="decode", attack=tbyz.attack_lib.AttackSpec("sign_flip"),
                                 participation=tscn.ParticipationSpec("iid", rate=0.3)),
             tbyz.ProtocolConfig(**base, aggregator="cwtm-nnm", attack=tbyz.attack_lib.AttackSpec("ipm"),
                                 participation=tscn.ParticipationSpec("iid", rate=0.3)),
             tbyz.ProtocolConfig(**base, method="draco", attack=tbyz.attack_lib.AttackSpec("sign_flip"),
                                 participation=tscn.ParticipationSpec("iid", rate=0.3)),
             tbyz.ProtocolConfig(**base, aggregator="cwtm", attack=tbyz.attack_lib.AttackSpec("alie"),
                                 compression=tbyz.comp_lib.CompressionSpec.parse("quant:4:8"))]
    return cfgs


ROUND_CFGS = _round_cfgs()


@pytest.mark.parametrize("i", range(len(ROUND_CFGS)),
                         ids=[f"{c.method}-{c.aggregator}-{c.attack.name}-{c.participation.name}-"
                              f"{c.compression.canonical()}" for c in ROUND_CFGS])
def test_single_stack_round_is_the_one_lane_case(i):
    """``protocol_round`` on an (N, Q) stack equals the (1, N, Q) call
    squeezed, and lane ``i`` of an L = 5 call equals the single call on
    lane ``i``'s stack, records and mask, bit for bit."""
    cfg = ROUND_CFGS[i]
    gen = torch.Generator().manual_seed(i)
    q = 24
    grads = torch.randn((5, cfg.n_devices, q), generator=gen)
    stacked = tbyz.RoundRandomness.stack([tbyz.sample_round_randomness(cfg, q, gen) for _ in range(5)])
    rands = [stacked.map(lambda v, i=i: v[i]) for i in range(5)]
    pms = [None] * 5
    if cfg.participation.active:
        pms = [(r.part_u >= cfg.participation.rate).float() for r in rands]
    batched = tbyz.protocol_round(cfg, grads, stacked, device="cpu",
                                  participation_mask=None if pms[0] is None else torch.stack(pms))
    assert batched.shape == (5, q)
    for lane in range(5):
        single = tbyz.protocol_round(cfg, grads[lane], rands[lane], device="cpu", participation_mask=pms[lane])
        one = tbyz.protocol_round(cfg, grads[lane:lane + 1], rands[lane].map(lambda v: v[None]), device="cpu",
                                  participation_mask=None if pms[lane] is None else pms[lane][None])
        assert torch.equal(one[0], single) and torch.equal(batched[lane], single), lane


def test_protocol_rounds_are_lanes_of_one_round():
    """``protocol_rounds`` runs its rounds as the lanes of one batched round:
    row t equals protocol_round with the t-th draw of the same generator."""
    cfg = tbyz.ProtocolConfig(n_devices=12, d=3, n_byz=2, aggregator="cwtm-nnm",
                              compression=tbyz.comp_lib.CompressionSpec.parse("randk:5"))
    grads = torch.randn((12, 20), generator=torch.Generator().manual_seed(0))
    outs = tengine.protocol_rounds(cfg, grads, 6, randomness=torch.Generator().manual_seed(4), device="cpu")
    gen = torch.Generator().manual_seed(4)
    assert outs.shape == (6, 20)
    for t in range(6):
        assert torch.equal(outs[t], tbyz.protocol_round(cfg, grads, tbyz.sample_round_randomness(cfg, 20, gen),
                                                        device="cpu"))


def test_tensor_step_size_has_the_float_bits():
    """A float32 tensor lr (one per lane) and grad_scale give the bits of the
    Python floats that run_trajectory passes."""
    opt = make_optimizer("sgd")
    gen = torch.Generator().manual_seed(0)
    x, g = torch.randn((4, 50), generator=gen), torch.randn((4, 50), generator=gen) * 1e3
    lrs = [1e-6, 3e-7, 1e-5 * 1.37, 0.1]
    scale = 100.0
    batched, _ = opt.update(x, torch.tensor(scale, dtype=torch.float32) * g, opt.init(x),
                            torch.tensor(lrs, dtype=torch.float32))
    for i, lr in enumerate(lrs):
        want, _ = opt.update(x[i], scale * g[i], opt.init(x[i]), lr)
        assert torch.equal(batched[i], want), lr


@pytest.mark.parametrize("shape,dim", [((7,), 0), ((3, 100, 5), 1), ((2, 3, 37), -1), ((1,), 0), ((4, 64), -1)])
def test_in_place_tree_sum_is_tree_sum(shape, dim):
    v = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    v.view(-1)[::3] = -0.0
    got = tree_sum_(v.clone(), dim)
    want = tree_sum(v, dim)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("shape", [(7,), (3, 100), (2, 5, 37), (4, 300), (1, 1)])
def test_last_axis_sum_is_tree_sum(shape):
    """``aggregators._sum_last`` (terms moved to rows, one row-combine
    launch; past 256 terms the tree in place) is ``tree_sum`` over the last
    axis bit for bit, signed zeros included."""
    v = torch.randn(shape, generator=torch.Generator().manual_seed(2))
    v.view(-1)[::3] = -0.0
    got, want = tagg._sum_last(v.clone()), tree_sum(v, -1)
    assert got.shape == want.shape and torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("shape", [(7, 5), (3, 100, 6), (2, 260, 4)])
@pytest.mark.parametrize("weighted", [False, True])
def test_row_sum_is_tree_sum_of_products(shape, weighted):
    """``aggregators._sum_rows`` is ``tree_sum`` over the rows of the
    products ``w * x`` (of ``x`` itself without weights) bit for bit, within
    the row-combine kernel's 256 rows and past them."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(shape, generator=gen)
    w = torch.rand(shape[:-1], generator=gen) if weighted else None
    want = tree_sum(x if w is None else x * w[..., None], -2)
    assert torch.equal(tagg._sum_rows(x, w), want)


# ---------------------------------------------------------- against the reference


REF_ROWS = [("PAPER_FIG4", n) for n in ("VA", "CWTM", "CWTM-NNM", "LAD-CWTM-d10", "LAD-CWTM-NNM-d10",
                                        "DRACO-d41")]
REF_ROWS += [("PAPER_FIG6", n) for n in ("Com-CWTM", "Com-LAD-CWTM")]
REF_ROWS += [("section7", n) for n in ("draco-d4/vote/alie/s0.3", "lad-d10/cwtm/ipm/rand_sparse/s0.3",
                                       "plain-d1/cwtm/sign_flip/s0.3")]


def _ref_row(mod, fig, name):
    if fig == "section7":
        return {r.name: r for r in mod.section7_grid()}[name]
    return getattr(mod, fig)[name]


@pytest.fixture(scope="module")
def ref_problem():
    import jax

    from repro.data.synthetic import linear_regression_problem as jax_problem
    z, y = jax_problem(jax.random.PRNGKey(0), n=100, dim=100, sigma_h=0.3)
    return np.array(z), np.array(y)


@pytest.fixture(scope="module")
def port_grid(ref_problem):
    """The REF_ROWS as one port grid under exact=False, each lane's records
    replayed from the reference's keys."""
    z, y = ref_problem
    rows = [_ref_row(tscn, fig, name) for fig, name in REF_ROWS]
    return tscn.run_grid(rows, STEPS, problem=(torch.from_numpy(z), torch.from_numpy(y)), device="cpu",
                         mode="loop", exact=False,
                         randomness=lambda scn: _replayed(scn.protocol(), 0, STEPS, z.shape[1]))


@pytest.mark.parametrize("fig,name", REF_ROWS, ids=[n for _, n in REF_ROWS])
def test_grid_lane_matches_reference(ref_problem, port_grid, fig, name):
    z, y = ref_problem
    jres = jscn.run_scenario(_ref_row(jscn, fig, name), STEPS, seed=0, problem=(jnp.asarray(z), jnp.asarray(y)),
                             mode="scan")
    tres = port_grid[name]
    if _ref_row(tscn, fig, name).method == "draco":  # the decode is exact: agg_dist is rounding noise
        _assert_metrics_close(jres, tres, ("loss", "grad_norm"))
        _assert_agg_dist_close(jres, tres)
    else:
        _assert_metrics_close(jres, tres, ("loss", "agg_dist", "grad_norm"))


def test_quant_grid_lane_matches_reference(ref_problem, monkeypatch):
    """Com-LAD-CWTM under quant:4 (seed 30, as in tests/test_torch_engine.py)
    as lane 0 of a two-lane bucket (the second lane reads the same records
    at another step size): every draw of lane 0 lies more than
    ``2 * levels * 2^-20`` from its remainder, and the lane is held to the
    reference within the tolerance."""
    z, y = ref_problem
    seed, n = 30, 100
    jrow = dataclasses.replace(jscn.PAPER_FIG6["Com-LAD-CWTM"], compressor="quant:4")
    trow = dataclasses.replace(tscn.PAPER_FIG6["Com-LAD-CWTM"], compressor="quant:4")
    other = dataclasses.replace(trow, name="Com-LAD-CWTM/quant:4/lr2", lr=2 * trow.lr)
    seen = []
    quantize = tops.stochastic_quantize

    def recording(g, u, levels, block):  # g: (lanes x N, Q); lane 0's rows come first
        seen.append((_quant_y(g[:n].numpy(), trow.protocol().compression), u[:n].numpy()))
        return quantize(g, u, levels, block)

    monkeypatch.setattr(tops, "stochastic_quantize", recording)
    grid = tscn.run_grid([trow, other], STEPS, problem=(torch.from_numpy(z), torch.from_numpy(y)), device="cpu",
                         mode="loop", randomness=lambda scn: _replayed(scn.protocol(), seed, STEPS, z.shape[1]))
    assert grid[trow.name].grid.lanes == 2 and len(seen) == STEPS
    assert min(flip_margin(yv, u) for yv, u in seen) > 2 * 4 * 2.0**-20
    jres = jscn.run_scenario(jrow, STEPS, seed=seed, problem=(jnp.asarray(z), jnp.asarray(y)), mode="scan")
    _assert_metrics_close(jres, grid[trow.name], ("loss", "agg_dist", "grad_norm"))


PART_ROWS = [("iid", "decode"), ("onoff", "mean"), ("adversarial", "decode"), ("markov", "cwtm")]


@pytest.fixture(scope="module")
def part_problem():
    import jax

    from repro.data.synthetic import linear_regression_problem as jax_problem
    z, y = jax_problem(jax.random.PRNGKey(0), n=16, dim=32, sigma_h=0.3)
    return np.array(z), np.array(y)


def test_participation_grid_matches_reference(part_problem):
    """The participation rows as one port grid (exact=False), against the
    reference's standalone runs."""
    z, y = part_problem
    trows = [tscn.participation_sweep(schedules=(s,), aggregators=(a,), n_byz=3)[0] for s, a in PART_ROWS]
    jrows = [jscn.participation_sweep(schedules=(s,), aggregators=(a,), n_byz=3)[0] for s, a in PART_ROWS]
    grid = tscn.run_grid(trows, STEPS, problem=(torch.from_numpy(z), torch.from_numpy(y)), dim=32, device="cpu",
                         mode="loop", exact=False,
                         randomness=lambda scn: _replayed(scn.protocol(), 0, STEPS, z.shape[1]))
    for trow, jrow in zip(trows, jrows):
        jres = jscn.run_scenario(jrow, STEPS, seed=0, problem=(jnp.asarray(z), jnp.asarray(y)), dim=32,
                                 mode="scan")
        tres = grid[trow.name]
        np.testing.assert_array_equal(tres.metrics["n_report"].numpy(), np.asarray(jres.metrics["n_report"]))
        _assert_metrics_close(jres, tres, ("loss", "grad_norm"))
        _assert_agg_dist_close(jres, tres)
