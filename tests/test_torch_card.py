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
grid's 65535 blocks in slices, equal to their plain versions.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.core import scenarios as tscn
from repro_torch.core.aggregators import coordinate_median, nnm_neighbours
from repro_torch.core.coding import draco_decode
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
