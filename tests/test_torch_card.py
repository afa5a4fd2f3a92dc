"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: they skip where no card is present. On the machine with
the card (which has no JAX, so this file imports none, and
``tests/conftest.py``, which imports it, is skipped):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_card.py

Tolerance: gather_combine, cwtm (with and without the NNM mix), quantize
and the two row combines run the plain version's arithmetic term for term,
so they must agree bitwise; the attack's honest statistics and the Gram sum
in another order than the plain versions (rtol 1e-5, atol 1e-6, the Gram's
atol scaled by the largest squared row norm). The Gram must still be
symmetric bit for bit, carry the row norms on its diagonal, and give the
same bits on every run and in every lane of a batch.

The median through the CWTM kernel and DRACO's decode, masked and unmasked,
are held to the same computations on the CPU bit for bit (elementwise fp32
arithmetic and sorts give the same bits on both devices). A trajectory in
graph mode (one captured round replayed) equals loop mode bit for bit, for
the rows that ``chip_smoke.py``'s ``graph`` phase runs. A grid of small
buckets in graph mode equals the loop-mode grid and each lane's standalone
graph run bit for bit, and the kernels launch folded lane counts above the
grid's 65535 blocks in slices, equal to their plain versions. The
protomath exchange through the kernels agrees with the plain versions
(rtol 1e-5, atol 1e-6 of its largest value), and the protomath step's
losses on the card with the CPU's within relative 2e-6. The engine step
and the grid sharded over a 1-rank NCCL group equal their unsharded runs
bit for bit, and at ``zoo_arch`` widths so does the round as 2, 3 and 4
ranks compute it, each rank's share run in turn on the card. A ``quant:4``
fleet (server and workers in threads of one process) gives the CPU's losses
within relative 2e-6, its server's decode launching ``masked_combine`` once
a round and every block's compression ``quantize`` once a round.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import socket
import threading
from pathlib import Path

import pytest
import torch

from repro_torch.core import scenarios as tscn
from repro_torch.core.aggregators import coordinate_median, nnm_neighbours
from repro_torch.core.coding import draco_decode
from repro_torch.launch import fleet as tfleet
from repro_torch.kernels import cwtm as tcwtm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import ref as tref

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


@pytest.mark.cuda
@pytest.mark.parametrize("n,q", [(100, 3000), (8, (1 << 20) + 37), (3, 64)])
def test_kernels_match_plain_on_card(card, n, q):
    """Each CUDA kernel against its plain version on the card."""
    gen = card
    msgs = torch.randn((n, q), generator=gen, device="cuda") * 3
    mask = (torch.arange(n, device="cuda") < max(1, n // 5)).float()
    d = min(n, 10)
    subsets = torch.randint(0, n, (n, d), generator=gen, device="cuda")
    w = torch.full((d,), 1.0 / d, device="cuda")
    torch.testing.assert_close(tops.gather_combine(msgs, subsets, w),
                               tref.gather_combine_ref(msgs, subsets, w), rtol=0, atol=0)
    for name, param in (("sign_flip", -2.0), ("alie", 1.5), ("ipm", 0.5)):
        torch.testing.assert_close(tops.attack(msgs, mask, name, param),
                                   tref.attack_ref(msgs, mask, name, param), rtol=RTOL, atol=ATOL)
    trim = (n - 1) // 4
    torch.testing.assert_close(tops.cwtm(msgs, trim), tref.cwtm_ref(msgs, trim), rtol=0, atol=0)
    gram, sq = tops.gram(msgs)
    want_gram, want_sq = tref.gram_ref(msgs)
    scale = float(want_sq.max())
    torch.testing.assert_close(gram, want_gram, rtol=RTOL, atol=ATOL * scale)
    torch.testing.assert_close(sq, want_sq, rtol=RTOL, atol=ATOL)
    w = (torch.rand((n,), generator=gen, device="cuda") < 0.5) * torch.rand((n,), generator=gen, device="cuda")
    torch.testing.assert_close(tops.masked_combine(msgs, w), tref.masked_combine_ref(msgs, w), rtol=0, atol=0)
    torch.testing.assert_close(tops.coded_combine(msgs, w), tref.coded_combine_ref(msgs, w), rtol=0, atol=0)
    u = torch.rand((n, q), generator=gen, device="cuda")
    for levels, chunk in ((4, 1024), (16, 1000), (3, 7), (4, q + 5)):
        torch.testing.assert_close(tops.stochastic_quantize(msgs, u, levels, chunk),
                                   tquant.plain(msgs, u, levels, min(chunk, q)), rtol=0, atol=0)


@pytest.mark.cuda
def test_batched_kernels_equal_single_on_card(card):
    msgs = torch.randn((3, 16, 1000), generator=card, device="cuda")
    batched_cwtm = tops.cwtm(msgs, 3)
    batched_gram, batched_sq = tops.gram(msgs)
    w = torch.rand((3, 16), generator=card, device="cuda")
    u = torch.rand((3, 16, 1000), generator=card, device="cuda")
    batched_combine = tops.masked_combine(msgs, w)
    batched_quant = tops.stochastic_quantize(msgs, u, 4, 96)
    for i in range(3):
        assert torch.equal(batched_cwtm[i], tops.cwtm(msgs[i], 3))
        gram, sq = tops.gram(msgs[i])
        assert torch.equal(batched_gram[i], gram) and torch.equal(batched_sq[i], sq)
        assert torch.equal(batched_combine[i], tops.masked_combine(msgs[i], w[i]))
        assert torch.equal(batched_quant[i], tops.stochastic_quantize(msgs[i], u[i], 4, 96))


@pytest.mark.cuda
def test_quantize_masks_the_ragged_block_of_each_row(card):
    """Rows are contiguous: the ragged last block of row 0 must not take
    the first coordinates of row 1 into its scale."""
    g = torch.randn((2, 1000), generator=card, device="cuda")
    g[1, :40] = 1e6  # would dominate row 0's last block's scale if read
    u = torch.rand((2, 1000), generator=card, device="cuda")
    out = tops.stochastic_quantize(g, u, 4, 96)
    torch.testing.assert_close(out[0], tquant.plain(g[:1], u[:1], 4, 96)[0], rtol=0, atol=0)


@pytest.mark.cuda
def test_gather_combine_marks_out_of_range_rows_with_nan(card):
    """On the card the wrapper reads no ids back: a device row with an id
    outside [0, N) comes out NaN, the other rows as the plain version."""
    msgs = torch.randn((4, 1000), generator=card, device="cuda")
    subsets = torch.tensor([[0, 1], [1, 2], [2, 4], [3, -1]], device="cuda")
    w = torch.full((2,), 0.5, device="cuda")
    out = tops.gather_combine(msgs, subsets, w)
    assert bool(torch.isnan(out[2:]).all())
    torch.testing.assert_close(out[:2], tref.gather_combine_ref(msgs, subsets[:2], w), rtol=0, atol=0)


@pytest.mark.cuda
def test_kernels_count_their_launches(card):
    tops.reset_launch_counts()
    msgs = torch.randn((8, 100), generator=card, device="cuda")
    tops.cwtm(msgs, 1)
    tops.pairwise_sqdist(msgs)
    tops.stochastic_quantize(msgs, torch.rand_like(msgs), 4, 32)
    tops.masked_combine(msgs, torch.ones(8, device="cuda"))
    tops.cwtm(msgs, 1, torch.arange(8, dtype=torch.int32, device="cuda")[:, None].contiguous())
    assert tops.launch_counts() == {"gather_combine": 0, "attack": 0, "cwtm": 2, "gram": 1,
                                    "quantize": 1, "masked_combine": 1, "coded_combine": 0,
                                    "cwtm_nnm": 1}


# (lanes, N, Q, n_byz): the wide round's N = 8 at a ragged Q (4-column groups
# that cross a row's end) and at Q % 4 == 0 (float4 loads), the register
# path's largest N, the shared-memory path just above it, the trainer's
# N = 100, and a lane axis
CWTM_NNM_CARD = [(1, 8, (1 << 20) + 37, 2), (1, 8, 1 << 20, 2), (1, 12, 1001, 3), (1, 13, 300, 3),
                 (1, 100, 100, 20), (3, 8, 4096, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n,q,n_byz", CWTM_NNM_CARD,
                         ids=[f"L{c[0]}-N{c[1]}-Q{c[2]}" for c in CWTM_NNM_CARD])
def test_cwtm_nnm_matches_plain_bitwise_on_card(card, lanes, n, q, n_byz):
    msgs = torch.randn((lanes, n, q), generator=card, device="cuda") * 3
    table = nnm_neighbours(tops.pairwise_sqdist(msgs), n_byz)
    trim = (n - 1) // 4
    got = tops.cwtm(msgs, trim, table)
    torch.testing.assert_close(got, tcwtm.plain(msgs, trim, table), rtol=0, atol=0)
    for i in range(lanes):
        assert torch.equal(got[i], tops.cwtm(msgs[i], trim, table[i]))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 16])
def test_cwtm_marks_a_lane_with_a_bad_table_nan(card, n):
    """On the card the table is not read back: a lane whose rows are not
    strictly ascending comes out NaN, the other lanes as the plain version."""
    msgs = torch.randn((2, n, 1000), generator=card, device="cuda")
    first = torch.arange(n).clamp(max=n - 2)
    good = torch.stack([first, first + 1], dim=1)
    bad = torch.stack([torch.arange(n), torch.arange(n)], dim=1)  # each id twice
    table = torch.stack([good, bad]).to(device="cuda", dtype=torch.int32)
    out = tops.cwtm(msgs, 1, table)
    assert bool(torch.isnan(out[1]).all())
    torch.testing.assert_close(out[0], tcwtm.plain(msgs[:1], 1, table[:1])[0], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,q", [(8, 1 << 22), (8, (1 << 20) + 37), (12, 10001), (3, 64), (13, 3000), (100, 100)])
def test_gram_on_card_is_close_symmetric_and_deterministic(card, n, q):
    msgs = torch.randn((3, n, q), generator=card, device="cuda") * 3
    gram, sq = tops.gram(msgs)
    again, sq_again = tops.gram(msgs)
    assert torch.equal(gram, again) and torch.equal(sq, sq_again)
    assert torch.equal(gram, gram.transpose(-1, -2))
    assert torch.equal(torch.diagonal(gram, dim1=-2, dim2=-1), sq)
    want_gram, want_sq = tref.gram_ref(msgs)
    scale = float(want_sq.max())
    torch.testing.assert_close(gram, want_gram, rtol=RTOL, atol=ATOL * scale)
    torch.testing.assert_close(sq, want_sq, rtol=RTOL, atol=ATOL * scale)
    for i in range(3):
        single, single_sq = tops.gram(msgs[i])
        assert torch.equal(gram[i], single) and torch.equal(sq[i], single_sq)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [7, 8, 41, 100])
def test_median_via_the_cwtm_kernel_is_bitwise_the_plain_version(card, n):
    msgs = torch.randn((n, (1 << 16) + 37), generator=card, device="cuda")
    before = tops.launch_counts()["cwtm"]
    got = coordinate_median(msgs)
    assert tops.launch_counts()["cwtm"] == before + 1
    torch.testing.assert_close(got, tref.cwtm_ref(msgs, (n - 1) // 2), rtol=0, atol=0)


# (N, d, mask): DRACO-d41's two groups of 41, the grid's groups of 4, partial and empty groups
DRACO_CARD = [(82, 41, None), (100, 4, None), (8, 4, None), (82, 41, "partial"), (12, 3, "empty"),
              (100, 4, "ones")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,mask", DRACO_CARD, ids=[f"N{c[0]}-d{c[1]}-{c[2]}" for c in DRACO_CARD])
def test_draco_decode_on_card_equals_plain(card, n, d, mask):
    msgs = torch.randn((n, 3000), generator=card, device="cuda")
    pm = None
    if mask == "partial":
        pm = (torch.arange(n, device="cuda") % 3 != 1).float()
    elif mask == "empty":
        pm = (torch.arange(n, device="cuda") // d != 1).float()
    elif mask == "ones":
        pm = torch.ones(n, device="cuda")
    if pm is not None:
        msgs = msgs * pm[:, None]
    got = draco_decode(msgs, d, mask=pm)
    want = draco_decode(msgs.cpu(), d, mask=None if pm is None else pm.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    if mask == "ones":
        assert torch.equal(got, draco_decode(msgs, d))


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
@pytest.mark.parametrize("row", range(6))
def test_graph_mode_equals_loop_mode_bitwise(card, row):
    """The six rows of chip_smoke.py's graph phase, 50 rounds: the final
    iterate, every metric and the participation state, bit for bit; the
    captured round replayed once a round."""
    smoke = _chip_smoke()
    scn = smoke.graph_rows(tscn)[row]
    dim = 32 if scn.participation != "full" else 100
    loop = tscn.run_scenario(scn, 50, seed=3, dim=dim, device="cuda", mode="loop")
    graph = tscn.run_scenario(scn, 50, seed=3, dim=dim, device="cuda", mode="graph")
    assert smoke.same_bits(loop, graph)
    assert graph.graph.replays == 50 and graph.graph.captured_launches["gather_combine"] == 1
    assert graph.opt_state == loop.opt_state


def _grid_rows():
    """Small buckets of every kind the grid phase runs: section-7 rows with
    DRACO, mixed servers with gaussian draw groups, quant:4, participation."""
    rows = tscn.section7_grid(n_devices=16, n_byz=3, methods=(("plain", 1), ("lad", 4), ("draco", 4)))
    rows += [tscn.Scenario(name=f"mix/{agg}/{attack}", method="lad", d=4, aggregator=agg, attack=attack,
                           n_byz=3, n_devices=16, lr=1e-5)
             for agg, attack in (("cwtm-nnm", "gaussian"), ("geomed", "alie"), ("krum", "gaussian"),
                                 ("mcc", "ipm"), ("tgn", "sign_flip"))]
    rows += [tscn.Scenario(name=f"quant/{m}", method=m, d=4 if m == "lad" else 1, aggregator="cwtm",
                           compressor="quant:4", n_byz=3, n_devices=16) for m in ("lad", "plain")]
    rows += tscn.participation_sweep(schedules=("iid", "onoff", "markov"), n_byz=3)
    return rows


@pytest.mark.cuda
def test_graph_grid_equals_loop_grid_and_standalone_graph_runs(card):
    """The grid in mode="graph" equals mode="loop" bit for bit,
    and each lane equals its standalone graph-mode run."""
    from repro_torch.core.engine import last_grid_chunk_info

    rows = _grid_rows()
    loop = tscn.run_grid(rows, 30, dim=24, device="cuda", mode="loop", exact=False)
    graph = tscn.run_grid(rows, 30, dim=24, device="cuda", mode="graph", exact=False,
                          max_lanes_per_device=4)
    assert last_grid_chunk_info()["chunk"] == 4
    smoke = _chip_smoke()
    for row in rows:
        assert smoke.same_bits(loop[row.name], graph[row.name]), row.name
        alone = tscn.run_scenario(row, 30, dim=24, device="cuda", mode="graph")
        assert smoke.same_bits(graph[row.name], alone), row.name
    stats = graph[rows[0].name].grid
    assert stats.graphs and all(g.replays == 30 for g in stats.graphs)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gather_combine", "attack", "cwtm", "cwtm_nnm"])
def test_kernels_above_the_grid_limit_equal_plain(card, kernel):
    """Folded lane counts above 65535 launch in slices of lanes: each slice
    counts, and the result equals the plain version bit for bit (within
    the attack's tolerance)."""
    if kernel == "gather_combine":
        lanes, n, q = 700, 100, 40  # 70,000 (lane, device) rows
    else:
        lanes, n, q = 70_000, 5, 40
    msgs = torch.randn((lanes, n, q), generator=card, device="cuda")
    before = tops.launch_counts()
    if kernel == "gather_combine":
        subsets = torch.randint(0, n, (lanes, n, 3), generator=card, device="cuda")
        w = torch.rand((lanes, 3), generator=card, device="cuda")
        got, want = tops.gather_combine(msgs, subsets, w), tref.gather_combine_ref(msgs, subsets, w)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    elif kernel == "attack":
        mask = (torch.rand((lanes, n), generator=card, device="cuda") < 0.4).float()
        torch.testing.assert_close(tops.attack(msgs, mask, "alie", 1.5), tref.attack_ref(msgs, mask, "alie", 1.5),
                                   rtol=RTOL, atol=ATOL)
    elif kernel == "cwtm":
        torch.testing.assert_close(tops.cwtm(msgs, 1), tref.cwtm_ref(msgs, 1), rtol=0, atol=0)
    else:
        table = torch.tensor([[0, 1, 2], [1, 2, 3], [2, 3, 4], [0, 3, 4], [0, 1, 4]], dtype=torch.int32,
                             device="cuda").expand(lanes, n, 3).contiguous()
        torch.testing.assert_close(tops.cwtm(msgs, 1, table), tcwtm.plain(msgs, 1, table), rtol=0, atol=0)
    after = tops.launch_counts()
    counter = "cwtm" if kernel == "cwtm_nnm" else kernel
    assert after[counter] - before[counter] == 2


# ------------------------------------------------------------------- the LM


LM_STEPS = 20
# a leaf's vmapped gradient against a plain backward on the card: the batched
# and the single products sum in other orders, 2 layers deep (chip_smoke.py's
# lm_wide phase holds the full 32-layer depth to the same bound)
SUBSET_GRAD_RTOL = 1e-4


@pytest.mark.cuda
def test_lm_graph_mode_equals_loop_mode_bitwise(card):
    """An LM row (LAD d=2 under ALIE, random sparsification): the captured
    round, torch.func backward included, replayed 20 times equals the loop
    bit for bit."""
    smoke = _chip_smoke()
    row = next(r for r in tscn.lm_sweep() if r.attack == "alie" and r.compressor == "rand_sparse" and r.d == 2)
    loop = tscn.run_lm_scenario(row, LM_STEPS, seed=2, device="cuda", mode="loop")
    graph = tscn.run_lm_scenario(row, LM_STEPS, seed=2, device="cuda", mode="graph")
    assert smoke.same_bits(loop, graph)
    assert graph.graph.replays == LM_STEPS and graph.graph.captured_launches["gather_combine"] == 1


@pytest.mark.cuda
def test_lm_grid_lane_equals_standalone_run_bitwise(card):
    """A 3-lane LM bucket in graph mode: each lane equals its row's
    standalone graph-mode run bit for bit."""
    smoke = _chip_smoke()
    rows = tscn.lm_sweep(methods=(("lad", 2),), compressors=("none",))
    grid = tscn.run_lm_grid(rows, LM_STEPS, seed=1, device="cuda")
    assert grid[rows[0].name].grid.lanes == 3
    for row in rows:
        assert smoke.same_bits(grid[row.name], tscn.run_lm_scenario(row, LM_STEPS, seed=1, device="cuda",
                                                                    mode="graph")), row.name


@pytest.mark.cuda
def test_lm_round_is_deterministic(card):
    """One LM round run twice gives the same bits: the embedding's and the
    label rows' gradients are matrix products, not atomic scatter-adds."""
    row = tscn.lm_sweep()[0]
    a, b = (tscn.run_lm_scenario(row, 1, seed=5, device="cuda") for _ in range(2))
    assert torch.equal(a.x, b.x)
    x0, _, grads, _ = tscn._lm_fns(tscn.lm_arch())
    data = tscn._lm_problem(tscn.lm_arch(), seed=5, n_subsets=row.n_devices, sigma_h=row.sigma_h, per_subset=2,
                            seq_len=16, device=torch.device("cuda"))
    x = x0.to("cuda")
    assert torch.equal(grads(data, x), grads(data, x))


@pytest.mark.cuda
def test_lm_vmapped_gradient_equals_plain_backward(card):
    """smollm-360m's widths at 2 layers: subset 3's row of the vmapped
    gradient stack against a plain ``backward()`` on its rows, each leaf
    within SUBSET_GRAD_RTOL of its largest magnitude."""
    from repro_torch import models, pytree
    from repro_torch.configs.archs import ARCHS
    from repro_torch.core.coding import flatten_pytree, unflatten_pytree

    arch = ARCHS["smollm-360m"].scaled(n_layers=2)
    x0, spec, grads, _ = tscn._lm_fns(arch)
    data = tscn._lm_problem(arch, seed=0, n_subsets=4, sigma_h=0.5, per_subset=2, seq_len=16,
                            device=torch.device("cuda"))
    x = x0.to("cuda")
    stack = grads(data, x)
    tree = pytree.map_tree(lambda a: a.detach().clone().requires_grad_(True), unflatten_pytree(x, spec))
    models.loss_fn(tree, None, arch, {"tokens": data[0][3], "labels": data[1][3]})[0].backward()
    plain = flatten_pytree(pytree.map_tree(lambda a: a.grad, tree))[0]
    for want, got in zip(pytree.leaves(unflatten_pytree(plain, spec)), pytree.leaves(unflatten_pytree(stack[3], spec))):
        assert float((got - want).abs().max()) <= SUBSET_GRAD_RTOL * float(want.abs().max())


# ------------------------------------------------------------------ the zoo

ZOO_STEPS = 10


@pytest.mark.cuda
@pytest.mark.parametrize("family", tscn.ZOO_FAMILIES)
def test_zoo_graph_mode_equals_loop_mode_bitwise(card, family):
    """Each family's LAD row: the captured round replayed equals the loop
    bit for bit (the Mamba and RWKV token loops and the MoE's one-hot
    dispatch inside the capture)."""
    smoke = _chip_smoke()
    row = tscn.zoo_sweep((family,))[family][0]
    kw = dict(arch=tscn.zoo_arch(family), seed=1, device="cuda")
    loop = tscn.run_lm_scenario(row, ZOO_STEPS, mode="loop", **kw)
    graph = tscn.run_lm_scenario(row, ZOO_STEPS, mode="graph", **kw)
    assert smoke.same_bits(loop, graph)
    assert bool(torch.isfinite(graph.metrics["loss"]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("family", tscn.ZOO_FAMILIES)
def test_zoo_sweep_lanes_equal_standalone_runs_on_card(card, family):
    """``run_zoo_sweep`` in graph mode: every lane bit for bit its row's
    standalone graph-mode run."""
    smoke = _chip_smoke()
    sweep = tscn.run_zoo_sweep(ZOO_STEPS, families=(family,), seed=2, device="cuda")[family]
    for row in tscn.zoo_sweep((family,))[family]:
        alone = tscn.run_lm_scenario(row, ZOO_STEPS, arch=tscn.zoo_arch(family), seed=2, device="cuda",
                                     mode="graph")
        assert smoke.same_bits(sweep[row.name], alone), row.name


@pytest.mark.cuda
@pytest.mark.parametrize("family", ("jamba", "moe", "rwkv", "audio"))
def test_zoo_gradients_are_deterministic_and_a_plain_backward(card, family):
    """The subset gradients twice give the same bits (the MoE's dispatch
    and combine are one-hot products, no atomic scatter-add), and subset
    1's row is a plain ``backward()`` within SUBSET_GRAD_RTOL of each
    leaf's largest magnitude."""
    from repro_torch import models, pytree
    from repro_torch.core.coding import flatten_pytree, unflatten_pytree

    arch = tscn.zoo_arch(family)
    x0, spec, grads, _ = tscn._lm_fns(arch)
    data = tscn._lm_problem(arch, seed=0, n_subsets=4, sigma_h=0.5, per_subset=2, seq_len=16,
                            device=torch.device("cuda"))
    x = x0.to("cuda")
    stack = grads(data, x)
    assert torch.equal(stack, grads(data, x))
    tree = pytree.map_tree(lambda a: a.detach().clone().requires_grad_(True), unflatten_pytree(x, spec))
    batch = dict(zip(("tokens", "labels", "frontend"), (d[1] for d in data)))
    models.loss_fn(tree, None, arch, batch)[0].backward()
    plain = flatten_pytree(pytree.map_tree(lambda a: a.grad, tree))[0]
    for want, got in zip(pytree.leaves(unflatten_pytree(plain, spec)), pytree.leaves(unflatten_pytree(stack[1], spec))):
        assert float((got - want).abs().max()) <= SUBSET_GRAD_RTOL * float(want.abs().max())


# ------------------------------------------------------------ the train step


def _train_parts():
    from repro_torch import models, pytree
    from repro_torch.launch import train

    smoke = _chip_smoke()
    arch = tscn.lm_arch()
    params, specs = models.init(torch.Generator().manual_seed(0), arch)
    params = pytree.map_tree(lambda a: a.to("cuda"), params)
    return smoke, train, pytree, arch, params, specs


@pytest.mark.cuda
def test_run_trajectory_graph_equals_loop_under_adamw(card):
    """The Fig. 4 LAD-CWTM-NNM-d10 round under AdamW with bf16 moments and a
    warm-up-cosine schedule evaluated on the card: 30 captured rounds equal
    the loop bit for bit (iterate, metrics, step and moments)."""
    from repro_torch.core import engine
    from repro_torch.data.synthetic import linear_regression_problem, linreg_loss, linreg_subset_grads
    from repro_torch.optim import linear_warmup_cosine

    smoke = _chip_smoke()
    cfg = tscn.PAPER_FIG4["LAD-CWTM-NNM-d10"].protocol()
    z, y = linear_regression_problem(torch.Generator(device="cuda").manual_seed(0), n=100, dim=100)
    out = {}
    for mode in ("loop", "graph"):
        out[mode] = engine.run_trajectory(
            cfg, torch.zeros(100), lambda d, x: linreg_subset_grads(d[0], d[1], x), steps=30,
            lr=linear_warmup_cosine(1e-2, 3, 30), optimizer="adamw", momentum_dtype="bfloat16",
            randomness=torch.Generator(device="cuda").manual_seed(1), loss_fn=lambda d, xs: linreg_loss(d[0], d[1], xs),
            data=(z, y), device="cuda", mode=mode)
    assert smoke.same_bits(out["loop"], out["graph"])
    a, b = out["loop"].opt_state, out["graph"].opt_state
    assert int(a.step) == int(b.step) == 30
    assert torch.equal(a.mu, b.mu) and torch.equal(a.nu, b.nu) and a.mu.dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(momentum_dtype="float32"), dict(momentum_dtype="bfloat16"),
                                dict(microbatches=2, compression="quant", quant_levels=4)],
                         ids=["adamw-fp32", "adamw-bf16", "mb2-quant"])
def test_train_step_graph_equals_loop_and_captures_once(card, kw):
    """build_engine_step at lm_arch(), N=10, 4 steps: graph mode equals loop
    mode bit for bit (params, state, losses); warm steps and a second step
    built from an equal config capture nothing."""
    smoke, train, pytree, arch, params, specs = _train_parts()
    tcfg = smoke.train_tcfg(train, arch, **kw)
    from repro_torch.data import synthetic

    batches = smoke.train_batches(synthetic, arch, 10, tcfg.microbatches, 4)
    runs = {}
    for mode in ("loop", "graph"):
        step, opt = train.build_train_step(arch, tcfg, specs, device="cuda", mode=mode)
        runs[mode] = smoke.drive(step, params, opt.init(params), batches[:1])
        if mode == "graph":
            info = train.engine_program_cache_info()
        rest = smoke.drive(step, runs[mode][0], runs[mode][1], batches[1:], start=1)
        runs[mode] = (rest[0], rest[1], torch.cat([runs[mode][2], rest[2]]))
    step2, _ = train.build_train_step(arch, smoke.train_tcfg(train, arch, **kw), specs, device="cuda", mode="graph")
    step2(params, opt.init(params), batches[0], 0)
    assert train.engine_program_cache_info() == info
    (lp, ls, ll), (gp, gs, gl) = runs["loop"], runs["graph"]
    assert smoke.tree_equal((lp, ls), (gp, gs), pytree) and torch.equal(ll, gl)


@pytest.mark.cuda
def test_train_resume_is_bitwise_on_card(card, tmp_path):
    """A checkpoint after step 2 (params and AdamW state, bf16 moments),
    loaded and resumed in graph mode to step 4, equals the run straight
    through bit for bit."""
    from repro_torch import checkpoint
    from repro_torch.data import synthetic

    smoke, train, pytree, arch, params, specs = _train_parts()
    tcfg = smoke.train_tcfg(train, arch, momentum_dtype="bfloat16")
    batches = smoke.train_batches(synthetic, arch, 10, 1, 4)
    step, opt = train.build_train_step(arch, tcfg, specs, device="cuda", mode="graph")
    whole = smoke.drive(step, params, opt.init(params), batches)
    p_mid, s_mid, _ = smoke.drive(step, params, opt.init(params), batches[:2])
    ck = str(tmp_path / "ck")
    checkpoint.save_checkpoint(ck, {"params": p_mid, "opt": s_mid}, step=2)
    restored, at = checkpoint.load_checkpoint(ck, {"params": params, "opt": opt.init(params)})
    assert at == 2
    p_fin, s_fin, _ = smoke.drive(step, restored["params"], restored["opt"], batches[2:], start=2)
    assert smoke.tree_equal((p_fin, s_fin), whole[:2], pytree)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,kernel", [(dict(aggregator="cwtm-nnm"), "gram"),
                                       (dict(protocol="none"), "masked_combine")], ids=["cwtm-nnm", "none"])
def test_train_step_launches_its_server_kernel(card, kw, kernel):
    """A train step under CWTM-NNM launches the Gram kernel, and one under
    ``protocol="none"`` (the mean) the masked-combine kernel; graph mode
    still equals loop mode."""
    from repro_torch.data import synthetic

    smoke, train, pytree, arch, params, specs = _train_parts()
    tcfg = smoke.train_tcfg(train, arch, **kw)
    batches = smoke.train_batches(synthetic, arch, 10, 1, 2)
    before = tops.launch_counts()[kernel]
    step, opt = train.build_train_step(arch, tcfg, specs, device="cuda", mode="loop")
    loop = smoke.drive(step, params, opt.init(params), batches)
    assert tops.launch_counts()[kernel] > before
    step, opt = train.build_train_step(arch, tcfg, specs, device="cuda", mode="graph")
    graph = smoke.drive(step, params, opt.init(params), batches)
    assert smoke.tree_equal(loop[0], graph[0], pytree) and torch.equal(loop[2], graph[2])


# --------------------------------------------------- the engine over ranks


@pytest.fixture
def nccl_group(card, tmp_path):
    """A 1-rank NCCL group (``file://`` rendezvous), destroyed after."""
    torch.distributed.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1,
                                         rank=0)
    yield torch.distributed.group.WORLD
    torch.distributed.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("family,kw", [("transformer", dict()), ("transformer", dict(shard="pmap")),
                                       ("transformer", dict(microbatches=2, compression="quant", quant_levels=4)),
                                       ("audio", dict())],
                         ids=["lm", "lm-pmap", "lm-mb2-quant", "audio"])
def test_engine_shard_step_equals_unsharded_on_card(nccl_group, family, kw):
    """The engine step at N=10, 3 loop steps, sharded over a 1-rank NCCL
    group (its all-gather of the gradient rows) against ``shard="none"``:
    params, optimizer state and losses bit for bit; the audio family with
    its ``frontend``."""
    from repro_torch import models
    from repro_torch.data import synthetic

    smoke, train, pytree, _, _, _ = _train_parts()
    arch = tscn.zoo_arch(family)
    params, specs = models.init(torch.Generator().manual_seed(0), arch)
    params = pytree.map_tree(lambda a: a.to("cuda"), params)
    rows = kw.get("microbatches", 1)
    batches = smoke.train_batches(synthetic, arch, 10, rows, 3)
    if family == "audio":
        batches = smoke.with_frontend(arch, batches, seed=3)
    runs = []
    for shard in ("none", kw.get("shard", "shard_map")):
        tcfg = smoke.train_tcfg(train, arch, **{**kw, "shard": shard})
        step, opt = train.build_train_step(arch, tcfg, specs, device="cuda")
        runs.append(smoke.drive(step, params, opt.init(params), batches))
    assert smoke.tree_equal(runs[0][:2], runs[1][:2], pytree) and torch.equal(runs[0][2], runs[1][2])


@pytest.mark.cuda
def test_engine_shard_grid_equals_unsharded_on_card(nccl_group):
    """A grid of two buckets in graph mode, sharded over a 1-rank NCCL
    group, in chunks of 2 lanes: every lane bit for bit the unsharded
    grid's."""
    from repro_torch.core import engine

    smoke = _chip_smoke()
    rows = tscn.synthetic_sweep(5, n_devices=10, n_byz=2) + tscn.section7_grid(
        methods=(("lad", 10),), compressors=("none",))
    none = tscn.run_grid(rows, 20, dim=16, device="cuda")
    got = tscn.run_grid(rows, 20, dim=16, device="cuda", shard="shard_map", max_lanes_per_device=2)
    assert engine.last_grid_chunk_info()["devices"] == 1
    for row in rows:
        assert smoke.same_bits(got[row.name], none[row.name]), row.name


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["transformer", "audio"])
@pytest.mark.parametrize("kw", [dict(), dict(compression="quant", quant_levels=4, attack="alie")],
                         ids=["lad-cwtm", "quant4-alie"])
def test_engine_rank_shares_equal_unsharded_round_on_card(card, family, kw):
    """The engine step's round at N=10 as 2, 3 and 4 ranks compute it
    (3 to 5 blocks and a padding block through each rank's vmapped
    gradient, the shares concatenated in rank order in place of the
    all-gather, every share run on this card): loss, metrics and the
    aggregate bit for bit the unsharded round's at these widths (at
    smollm-360m's they are not: ROADMAP C.12, ``chip_smoke.py``'s
    ``engine_shard``)."""
    from repro_torch import models
    from repro_torch.core import byzantine, engine
    from repro_torch.data import synthetic

    smoke, train, pytree, _, _, _ = _train_parts()
    arch = tscn.zoo_arch(family)
    params, _ = models.init(torch.Generator().manual_seed(0), arch)
    params = pytree.map_tree(lambda a: a.to("cuda"), params)
    batch = smoke.train_batches(synthetic, arch, 10, 2, 1)
    if family == "audio":
        batch = smoke.with_frontend(arch, batch, seed=3)
    tcfg = smoke.train_tcfg(train, arch, **kw)
    pcfg = train.make_round_config(tcfg, 10)
    q = sum(v.numel() for v in pytree.leaves(params))
    blocks = train.block_batch({k: v.to("cuda") for k, v in batch[0].items()}, 10)
    rand = byzantine.sample_round_randomness(pcfg, q, torch.Generator(device="cuda").manual_seed(5))
    worlds = smoke.rank_split_round(train, engine, arch, pcfg, torch.device("cuda"), params, blocks, rand, (2, 3, 4))
    assert {w: r["bitwise"] for w, r in worlds.items()} == {2: True, 3: True, 4: True}, worlds


# ------------------------------------------------------- the protomath step


@pytest.mark.cuda
@pytest.mark.parametrize("agg,attack,kernels", [("cwtm", "alie", ("attack", "cwtm")),
                                                ("cwtm-nnm", "sign_flip", ("attack", "gram", "cwtm")),
                                                ("median", "ipm", ("attack", "cwtm")),
                                                ("mean-nnm", "zero", ("gram", "cwtm"))],
                         ids=["cwtm-alie", "cwtm_nnm-sign_flip", "median-ipm", "mean_nnm-zero"])
def test_protomath_exchange_kernels_match_plain(card, agg, attack, kernels):
    """One exchange (``robust_combine``) of an (8, 96, 1000) stack through
    the kernels against the same exchange on the CPU (the plain
    versions), rtol 1e-5 and atol 1e-6 of its largest value; each of its
    kernels launches."""
    from repro_torch.core import protomath
    from repro_torch.core.attacks import AttackSpec

    p = protomath.BlockedProtocol(n_devices=8, aggregator=agg, trim_frac=0.25, n_byz=2,
                                  attack=AttackSpec(name=attack, n_byz=2))
    x = torch.randn((8, 96, 1000), generator=card, device="cuda")
    before = tops.launch_counts()
    got = protomath.robust_combine(p, x, ("fsdp", None)).cpu()
    after = tops.launch_counts()
    want = protomath.robust_combine(p, x.cpu(), ("fsdp", None))
    assert torch.allclose(got, want, rtol=RTOL, atol=ATOL * float(want.abs().max()))
    assert all(after[k] > before[k] for k in kernels), (before, after)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(aggregator="cwtm", attack="alie"),
                                dict(aggregator="cwtm-nnm", attack="sign_flip", microbatches=2)],
                         ids=["cwtm-alie", "cwtm_nnm-sign_flip-mb2"])
def test_protomath_step_card_against_cpu(card, kw):
    """The protomath step at lm_arch(), N=8 on one rank, 4 steps: the
    card's losses within relative 2e-6 of the CPU's, a second card run
    equal bit for bit."""
    from repro_torch.data import synthetic
    from repro_torch.launch.mesh import make_host_mesh

    smoke, train, pytree, arch, params, specs = _train_parts()
    tcfg = smoke.protomath_tcfg(train, arch, **kw)
    batches = smoke.train_batches(synthetic, arch, 8, tcfg.microbatches, 4)
    runs = []
    for dev in ("cuda", "cuda", "cpu"):
        step, opt = train.build_train_step(arch, tcfg, specs, mesh=make_host_mesh(8), device=dev)
        p = pytree.map_tree(lambda a: a.to(dev), params)
        runs.append(smoke.drive(step, p, opt.init(p), batches))
    assert smoke.tree_equal(runs[0][:2], runs[1][:2], pytree) and torch.equal(runs[0][2], runs[1][2])
    card_loss, cpu_loss = runs[0][2].cpu(), runs[2][2]
    assert float(((card_loss - cpu_loss) / cpu_loss).abs().max()) <= smoke.TRAIN_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("family", tscn.ZOO_FAMILIES)
def test_serve_traffic_graph_equals_loop(card, family):
    """``serve_traffic`` in graph mode (one captured decode step and its
    argmax, replayed) gives loop mode's tokens and final decode state bit
    for bit, for every zoo family; the prefill's chunked path past 2048
    tokens equals the plain attention on the card."""
    from repro_torch import models, pytree
    from repro_torch.launch import serve
    from repro_torch.models import attention as tattn

    arch = tscn.zoo_arch(family)
    params, _ = models.init(torch.Generator().manual_seed(0), arch)
    params = pytree.map_tree(lambda a: a.to("cuda"), params)
    tokens = torch.randint(0, arch.vocab, (2, 13), generator=card, device="cuda")
    frontend = None
    if arch.family in ("vlm", "audio"):
        enc = arch.encoder
        frontend = torch.randn((2, enc.n_frontend_tokens, enc.d_frontend), generator=card, device="cuda")
    out = {mode: serve.serve_traffic(arch, params, None, tokens, frontend=frontend, new_tokens=7, mode=mode,
                                     device="cuda") for mode in ("loop", "graph")}
    assert torch.equal(out["loop"]["tokens"], out["graph"]["tokens"]) and out["graph"]["pos"] == 20
    for (ka, a), (kb, b) in zip(pytree.paths(out["loop"]["state"]), pytree.paths(out["graph"]["state"]),
                                strict=True):
        assert ka == kb and torch.equal(a, b), ka
    q = torch.randn((1, 2100, 1, 2, 16), generator=card, device="cuda")
    k, v = (torch.randn((1, 2100, 1, 16), generator=card, device="cuda") for _ in range(2))
    pos = torch.arange(2100, device="cuda")[None]
    pad = torch.nn.functional.pad
    pq, pk = (-2100) % tattn.Q_CHUNK, (-2100) % tattn.KV_CHUNK  # as multihead_attention pads
    flash = tattn._flash_attention(pad(q, (0, 0, 0, 0, 0, 0, 0, pq)), pad(k, (0, 0, 0, 0, 0, pk)),
                                   pad(v, (0, 0, 0, 0, 0, pk)), pad(pos, (0, pq)), pad(pos, (0, pk), value=-1), True,
                                   None)
    plain = tattn._plain_attention(q, k, v, pos, pos, True, None)
    torch.testing.assert_close(flash[:, :2100], plain, rtol=RTOL, atol=ATOL)


def _fleet_in_threads(cfg) -> dict:
    """A fleet with its workers in threads of this process; the server's
    RESULT."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        cfg = dataclasses.replace(cfg, port=sock.getsockname()[1])
    threads = [threading.Thread(target=tfleet.run_worker, args=(dataclasses.replace(cfg, proc_id=pid),), daemon=True)
               for pid in range(1, cfg.procs)]
    for th in threads:
        th.start()
    res = tfleet.run_server(cfg)
    for th in threads:
        th.join(60)
        assert not th.is_alive()
    return res


@pytest.mark.cuda
def test_fleet_quant4_card_against_cpu(card):
    cfg = tfleet.FleetConfig(procs=3, n_devices=6, d=3, dim=64, steps=8, lr=1e-6, compress="quant:4",
                             distributed=False, round_timeout=15.0)
    got = _fleet_in_threads(cfg)
    launches = tops.launch_counts()  # every block's process is a thread here: one set of counters
    want = _fleet_in_threads(dataclasses.replace(cfg, device="cpu"))
    assert got["n_report"] == want["n_report"] == [6] * 8 and got["wire"] == want["wire"]
    rel = max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"]))
    assert rel <= 2e-6, rel
    assert launches["masked_combine"] == cfg.steps and launches["quantize"] == cfg.procs * cfg.steps
