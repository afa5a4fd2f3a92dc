"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: they skip where no card is present. On the machine with
the card (which has no JAX, so this file imports none, and
``tests/conftest.py``, which imports it, is skipped):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_card.py

Tolerance: gather_combine, the attack, cwtm (with and without the NNM
mix), quantize and the two row combines run the plain version's arithmetic
term for term, in its order, so they must agree bitwise; the Gram sums in
another order than the plain version (rtol 1e-5, atol 1e-6 scaled by the
largest squared row norm). The encode and the three attacks are held bit
for bit at N=100, Q=100 (1 and 1,000 lanes), at N=8 and Q = 2^20 + 37, at
N=3, at a Q that is not 16-byte aligned and at N=2,048 (the encode's large-N
path), the attack also on a -0.0 in an honest row, all-honest and
all-Byzantine masks and NaN rows, and a lane-batched launch equals its
single-lane launches. Every sort that can meet a Byzantine value puts a NaN
whose sign bit is set last, as the CPU does (ROADMAP C.14). The Gram must still be
symmetric bit for bit, carry the row norms on its diagonal, and give the
same bits on every run and in every lane of a batch (N = 3 to 128, at the
paper's N = Q = 100 at 1 and 1,000 lanes, on an unaligned view and with a
NaN entry, whose row and column come out NaN), take one kernel launch where
Q is one chunk, and give NNM the CPU's neighbour tables at N = Q = 100. The
row combines are held bit for bit at R = 1 to 256 rows, Q = 1 to 4097,
1 and 1,000 lanes, and at ``_sum_last``'s (1, 100, 100,000), -0.0 and
0 * inf included.

CWTM is bitwise its plain version on both sides of every padded size of
its sorting network (N = 13 to 256, with and without the mix, at 1 and 3
lanes), and orders NaN, +-inf and +-0 as ``torch.sort`` does, NaN last
(NaN at the same places, every other value equal). Its mix path (13 <= N
<= 128: the mix kernel, then the sort) is bitwise at every padded size, k
of 1, 80 and N, 1, 3 and 1,000 lanes, Q = 100 and a Q no column tile
divides, each lane of a batch its single-lane launch, with NaN, +-inf and
+-0 in the Byzantine rows, and a table out of range or order makes its
lane NaN alone. QSGD is bitwise at blocks of 96 (ragged), 100, 1,024 and
4,096, a warp or a thread block a block, on 16-byte and 4-byte loads and
unaligned rows, an all-zero block and a block holding a NaN coming out
0; 100,000 rows are one launch.

The median through the CWTM kernel and DRACO's decode, masked and unmasked,
are held to the same computations on the CPU bit for bit (elementwise fp32
arithmetic and sorts give the same bits on both devices). A trajectory in
graph mode (one captured round replayed) equals loop mode bit for bit, for
the rows that ``chip_smoke.py``'s ``graph`` phase runs. A grid of small
buckets in graph mode equals the loop-mode grid and each lane's standalone
graph run bit for bit, and the kernels launch folded lane counts above the
grid's 65535 blocks in slices (the encode's flat grid in one launch),
equal to their plain versions. The
protomath exchange through the kernels agrees with the plain versions
(rtol 1e-5, atol 1e-6 of its largest value), and the protomath step's
losses on the card with the CPU's within relative 2e-6. The engine step
and the grid sharded over a 1-rank NCCL group equal their unsharded runs
bit for bit, and at ``zoo_arch`` widths so does the round as 2, 3 and 4
ranks compute it, each rank's share run in turn on the card. A ``quant:4``
fleet (server and workers in threads of one process) gives the CPU's losses
within relative 2e-6, its server's decode launching ``masked_combine`` once
a round and every block's compression ``quantize`` once a round.

The tooling: a tuner probe whose captured round allocates past the card's
memory is recorded as out of memory, the next probe runs, and the memory
comes back; ``timing.block_time``'s CUDA events agree with a synchronised
host clock within a factor 2; every kernel's per-lane loop of launches
(the crossover table's ``"loop"``) equals its batched launch bit for bit at
1, 3 and 8 lanes; and a captured round's launch list is the CPU's.

The model axis: the expert-parallel ``pmm`` and the MoE, Mamba and RWKV
layers on 2 model ranks on the card (tests/torch_tp_ranks.py, two
processes over ``gloo``) agree with the whole ops on the CPU (rtol 1e-5,
atol 1e-6 of the largest value).
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import importlib.util
import math
import socket
import threading
import time
from pathlib import Path

import pytest
import torch

from repro_torch.core import scenarios as tscn
from repro_torch.core.aggregators import coordinate_median, nnm_neighbours
from repro_torch.core.coding import draco_decode
from repro_torch.launch import fleet as tfleet
from repro_torch.kernels import _build
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
                                   tref.attack_ref(msgs, mask, name, param), rtol=0, atol=0)
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


# (lanes, N, Q): the main path's N=100, Q=100 at 1 and 1,000 lanes, the wide
# round's N=8 at a ragged Q, N=3, a Q that is not 16-byte aligned, and N=2,048
# (the encode's large-N path)
TILE_CARD = [(1, 100, 100), (1000, 100, 100), (1, 8, (1 << 20) + 37), (1, 3, 64), (1, 100, 101), (1, 2048, 64)]
ATTACKS = (("sign_flip", -2.0), ("alie", 1.5), ("ipm", 0.5))


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN at the same places, every other value the same bits (-0.0 is not
    +0.0)."""
    nan = torch.isnan(want)
    return (got.shape == want.shape and torch.equal(torch.isnan(got), nan)
            and torch.equal(got.view(torch.int32)[~nan], want.view(torch.int32)[~nan]))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n,q", TILE_CARD, ids=[f"L{c[0]}-N{c[1]}-Q{c[2]}" for c in TILE_CARD])
def test_encode_and_attacks_are_bitwise_the_plain_versions(card, lanes, n, q):
    """The encode and the three attacks bit for bit against their plain
    versions, the encode in one launch; at 1,000 lanes, lanes of the
    batched launch against single-lane launches."""
    d = min(n, 10)
    msgs = torch.randn((lanes, n, q), generator=card, device="cuda") * 3
    subsets = torch.randint(0, n, (lanes, n, d), generator=card, device="cuda", dtype=torch.int32)
    w = torch.rand((lanes, d), generator=card, device="cuda")
    mask = (torch.rand((lanes, n), generator=card, device="cuda") < 0.2).float()
    before = tops.launch_counts()["gather_combine"]
    enc = tops.gather_combine(msgs, subsets, w)
    assert tops.launch_counts()["gather_combine"] - before == 1
    assert _same_bits(enc, tref.gather_combine_ref(msgs, subsets, w))
    got = {name: tops.attack(msgs, mask, name, param) for name, param in ATTACKS}
    for name, param in ATTACKS:
        assert _same_bits(got[name], tref.attack_ref(msgs, mask, name, param)), name
    for i in sorted({0, lanes // 2, lanes - 1}) if lanes > 1 else ():
        assert _same_bits(enc[i], tops.gather_combine(msgs[i], subsets[i], w[i]))
        for name, param in ATTACKS:
            assert _same_bits(got[name][i], tops.attack(msgs[i], mask[i], name, param)), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["negative_zero", "all_honest", "all_byzantine", "nan_rows"])
def test_attack_edge_cases_are_bitwise_the_plain_version(card, case):
    """A column of -0.0 (the tree's padding adds make its honest sum +0.0),
    no Byzantine row, no honest row (the count clamped to 1), and NaN in an
    honest and in a Byzantine row: the three attacks bit for bit, at N=100,
    Q=100 and 3 lanes."""
    lanes, n, q = 3, 100, 100
    msgs = torch.randn((lanes, n, q), generator=card, device="cuda")
    mask = (torch.arange(n, device="cuda") < 20).float().expand(lanes, n).contiguous()
    if case == "negative_zero":
        msgs[:, :, :7] = -0.0
        msgs[:, 50, 7:20] = -0.0
    elif case == "all_honest":
        mask = torch.zeros_like(mask)
    elif case == "all_byzantine":
        mask = torch.ones_like(mask)
    else:
        msgs[0, 40, 3] = math.nan  # an honest row
        msgs[1, 2, 9] = math.nan  # a Byzantine row: its term NaN * 0 is NaN too
    for name, param in ATTACKS:
        got, want = tops.attack(msgs, mask, name, param), tref.attack_ref(msgs, mask, name, param)
        assert _same_bits(got, want), name
        if case == "all_honest":
            assert torch.equal(got, msgs)


def _sign_bit_nan(x: torch.Tensor, *where) -> torch.Tensor:
    """x with a NaN whose sign bit is set at ``where``."""
    x = x.clone()
    x[where] = math.nan
    bits = x.view(torch.int32)
    bits[where] = bits[where] | -0x80000000
    assert bool(torch.signbit(x[where]).all())
    return x


C14_SITES = ["draco_d41_masked", "vector_median", "smallest", "mcc", "tgn", "multi_krum", "nnm_table",
             "krum_scores", "top_k"]


@pytest.mark.cuda
@pytest.mark.parametrize("site", C14_SITES)
def test_sorts_put_a_sign_bit_nan_last_as_on_the_cpu(card, site):
    """ROADMAP C.14: a NaN whose sign bit is set, in a Byzantine row (or,
    for the selections, in the raw values they sort), gives the same result
    on the card as on the CPU at N=100 (DRACO-d41 at N=82): bit for bit, NaN
    at the same places; where the card's Gram kernel makes the distances,
    within its tolerance."""
    from repro_torch.core import aggregators as tagg
    from repro_torch.core import compression as tcomp

    n, q, b = 100, 64, 20
    x = _sign_bit_nan(torch.randn((n, q), generator=card, device="cuda"), 3, 5)
    if site == "draco_d41_masked":
        x = _sign_bit_nan(torch.randn((82, q), generator=card, device="cuda"), 2, 5)
        mask = torch.ones(82, device="cuda")
        mask[7] = 0.0
        x = torch.where(mask[:, None] > 0, x, 0.0)
        got, want = draco_decode(x, 41, mask=mask), draco_decode(x.cpu(), 41, mask=mask.cpu())
    elif site == "vector_median":
        v = _sign_bit_nan(torch.randn((3, n), generator=card, device="cuda"), slice(None), 7)
        got, want = tagg._vector_median(v), tagg._vector_median(v.cpu())
    elif site == "smallest":
        v = _sign_bit_nan(torch.randn((3, n), generator=card, device="cuda"), slice(None), 7)
        got, want = tagg._smallest(v, n - b), tagg._smallest(v.cpu(), n - b)
        assert not bool((got == 7).any())
    elif site in ("mcc", "tgn"):
        rule = tagg.make_aggregator(site, n_byz=b)
        got, want = rule(x), rule(x.cpu())
    elif site == "multi_krum":
        got, want = tagg.multi_krum(x, b), tagg.multi_krum(x.cpu(), b)
        torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL, equal_nan=True)
        return
    elif site == "nnm_table":  # the distances with sign-bit NaN in the NaN row's row and column
        d2 = tops.pairwise_sqdist(torch.randn((n, q), generator=card, device="cuda"))
        d2 = _sign_bit_nan(_sign_bit_nan(d2, 3, slice(None)), slice(None), 3)
        got, want = nnm_neighbours(d2, b), nnm_neighbours(d2.cpu(), b)
        assert not bool((torch.cat([got[:3], got[4:]]) == 3).any())
    elif site == "krum_scores":
        got, want = tagg.krum_scores(x, b), tagg.krum_scores(x.cpu(), b)
        assert torch.equal(torch.isnan(got).cpu(), torch.isnan(want)) and bool(torch.isnan(want[3]))
        nan = torch.isnan(want)
        torch.testing.assert_close(got.cpu()[~nan], want[~nan], rtol=RTOL, atol=ATOL)
        return
    else:
        assert not bool(torch.signbit(x.abs()).any())  # abs clears the sign bit: top-k needs no repair
        got, want = tcomp.top_k(x, 8), tcomp.top_k(x.cpu(), 8)
    assert _same_bits(got.cpu(), want) if got.is_floating_point() else torch.equal(got.cpu(), want)


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
@pytest.mark.parametrize("n", [8, 16, 100, 128])
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


# CWTM-NNM's mix path (13 <= N <= 128, csrc/cwtm.cu's mix-and-sort
# kernel): every padded size of the network, k of 1, 80 and N
MIX_CARD = [(n, k) for n in (13, 16, 33, 64, 100, 128) for k in sorted({1, 80, n}) if k <= n]


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", MIX_CARD, ids=[f"N{n}-k{k}" for n, k in MIX_CARD])
def test_cwtm_nnm_mix_path_is_bitwise_the_plain_version(card, n, k):
    """At 1, 3 and 1,000 lanes, Q = 100 (16-byte loads) and Q = 101 (a Q
    that no column tile divides, 4-byte loads), trim floor(0.1 N): the
    kernel equals ``cwtm.plain`` bit for bit, and each lane of the 3-lane
    launch its single-lane launch."""
    for lanes in (1, 3, 1000):
        for q in (100, 101):
            assert q % tcwtm.mix_plan(lanes, n, q).cols or q == 100
            msgs = torch.randn((lanes, n, q), generator=card, device="cuda") * 3
            table = _random_tables(card, lanes, n, k)
            got = tops.cwtm(msgs, n // 10, table)
            assert torch.equal(got, tcwtm.plain(msgs, n // 10, table)), (lanes, q)
            if lanes == 3:
                for i in range(lanes):
                    assert torch.equal(got[i], tops.cwtm(msgs[i], n // 10, table[i]))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [13, 100, 128])
def test_cwtm_nnm_mix_path_orders_specials_as_the_plain_version(card, n):
    """NaN (either sign), +-inf and +-0 in the Byzantine rows through the
    mix path at k = 2 and k = N // 2: NaN at the plain version's places,
    every other value equal; a table with an id out of range or out of
    order makes its lane NaN and leaves the others alone."""
    lanes, q, byz = 3, 203, max(2, n // 5)
    msgs = torch.randn((lanes, n, q), generator=card, device="cuda")
    nan = math.copysign(math.nan, -1.0)
    specials = torch.tensor([math.nan, nan, math.inf, -math.inf, 0.0, -0.0], device="cuda")
    pick = torch.randint(0, 24, (lanes, byz, q), generator=card, device="cuda")
    msgs[:, :byz] = torch.where(pick < 6, specials[pick.clamp(max=5)], msgs[:, :byz])
    for k in (2, n // 2):
        table = _random_tables(card, lanes, n, k)
        got, want = tops.cwtm(msgs, 1, table), tcwtm.plain(msgs, 1, table)
        nan_at = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan_at) and torch.equal(got[~nan_at], want[~nan_at])
        for bad in ("range", "order"):
            broken = table.clone()
            if bad == "range":
                broken[1, n - 1, -1] = n
            else:
                broken[1, 0, :2] = broken[1, 0, :2].flip(0)
            out = tops.cwtm(msgs, 1, broken)
            assert bool(torch.isnan(out[1]).all())
            for i in (0, 2):
                nan_i = torch.isnan(want[i])
                assert torch.equal(torch.isnan(out[i]), nan_i) and torch.equal(out[i][~nan_i], want[i][~nan_i])


def _quantize_layout(g: torch.Tensor, u: torch.Tensor, levels: int, chunk: int, warp: bool) -> torch.Tensor:
    """QSGD through its C entry in the layout ``warp`` names, whatever
    ``quant_plan`` would pick for the shape."""
    out = torch.empty_like(g)
    err = _build.library("quantize")(g.data_ptr(), u.data_ptr(), out.data_ptr(), g.shape[0], g.shape[1], chunk,
                                     levels, int(warp), torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"CUDA error {err}"
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [96, 100, 256, 512, 1024, 4096])
def test_quantize_is_bitwise_the_plain_version_at_every_layout(card, chunk):
    """Blocks of 96 (ragged at the row's end), 100, 256, 512, 1,024 and
    4,096 coordinates, each through ``quant_plan``'s layout and, up to
    ``WARP_MAX_CHUNK`` (512), through both (a warp a block, a thread block
    a block): bit for bit the plain version with 16-byte loads (Q % 4 ==
    0), 4-byte loads (an odd Q)
    and on rows 4 bytes off 16-byte alignment; an all-zero block comes out
    0 and a block holding a NaN 0, as the plain version's."""
    for rows, q in ((5, 8192), (5, 8191), (3, 100)):
        base = torch.randn((rows * q + 1,), generator=card, device="cuda") * 3
        for g in (base[:-1].view(rows, q), base[1:].view(rows, q)):
            u = torch.rand((rows, q), generator=card, device="cuda")
            g[0, :min(chunk, q)] = 0.0
            if rows > 1:
                g[1, 3] = math.nan
            got = tops.stochastic_quantize(g, u, 4, chunk)
            want = tquant.plain(g, u, 4, min(chunk, q))
            assert torch.equal(got, want), (rows, q, g.data_ptr() % 16)
            for warp in (True, False) if min(chunk, q) <= tquant.WARP_MAX_CHUNK else (False,):
                assert torch.equal(_quantize_layout(g, u, 4, min(chunk, q), warp), want), (rows, q, warp)
            assert not bool(got[0, :min(chunk, q)].any())
            if rows > 1:
                assert not bool(got[1, :min(chunk, q)].any())


@pytest.mark.cuda
def test_quantize_launches_100000_rows_once(card):
    """quant:4 at 1,000 lanes of N = 100 rows and Q = 100: one launch, bit
    for bit the plain version."""
    g = torch.randn((1000, 100, 100), generator=card, device="cuda")
    u = torch.rand((1000, 100, 100), generator=card, device="cuda")
    before = tops.launch_counts()["quantize"]
    got = tops.stochastic_quantize(g, u, 4, 1024)
    assert tops.launch_counts()["quantize"] == before + 1
    assert torch.equal(got, tquant.plain(g.reshape(-1, 100), u.reshape(-1, 100), 4, 100).reshape(g.shape))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


# (lanes, N, Q, case): the register path (N <= 12) and the tile path (13 to
# 128) at the paper's N = Q = 100 at 1 and 1,000 lanes (a segment a thread,
# and a thread every segment), one 32-column segment (Q = 1, 3), several
# chunks (Q = 4097, 2^20), a view 4 bytes off 16-byte alignment (4-byte
# copies) and a NaN entry (its row and column of the Gram NaN)
GRAM_CARD = ([(3, 8, 1 << 22, ""), (3, 8, (1 << 20) + 37, ""), (3, 12, 10001, ""), (3, 3, 64, ""),
              (3, 13, 3000, ""), (3, 100, 100, ""), (1, 100, 100, ""), (1000, 100, 100, "")]
             + [(3, n, q, "") for n in (13, 64, 128) for q in (1, 3, 4097, 1 << 20)]
             + [(3, 100, 100, "unaligned"), (3, 64, 4097, "unaligned"), (1, 100, 100, "nan"),
                (1000, 100, 100, "nan"), (3, 64, 4097, "nan")])


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n,q,case", GRAM_CARD, ids=[f"L{c[0]}-N{c[1]}-Q{c[2]}{'-' + c[3] if c[3] else ''}"
                                                          for c in GRAM_CARD])
def test_gram_on_card_is_close_symmetric_and_deterministic(card, lanes, n, q, case):
    """Bit for bit the same on a second call and in each lane called
    alone, symmetric with sq on the diagonal, and within ATOL times the
    largest squared row norm of the plain version (NaN where it has NaN)."""
    size = lanes * n * q
    if case == "unaligned":
        msgs = (torch.randn(size + 1, generator=card, device="cuda") * 3)[1:].view(lanes, n, q)
        assert msgs.is_contiguous() and msgs.data_ptr() % 16 != 0
    else:
        msgs = torch.randn((lanes, n, q), generator=card, device="cuda") * 3
    if case == "nan":
        msgs[0, n // 3, q // 2] = math.nan
    gram, sq = tops.gram(msgs)
    again, sq_again = tops.gram(msgs)
    assert torch.equal(_bits(gram), _bits(again)) and torch.equal(_bits(sq), _bits(sq_again))
    assert torch.equal(_bits(gram), _bits(gram.transpose(-1, -2)))
    assert torch.equal(_bits(torch.diagonal(gram, dim1=-2, dim2=-1)), _bits(sq))
    want_gram, want_sq = tref.gram_ref(msgs)
    scale = float(want_sq[~torch.isnan(want_sq)].max())
    torch.testing.assert_close(gram, want_gram, rtol=RTOL, atol=ATOL * scale, equal_nan=True)
    torch.testing.assert_close(sq, want_sq, rtol=RTOL, atol=ATOL * scale, equal_nan=True)
    if case == "nan":
        nan = torch.zeros((n, n), dtype=torch.bool, device="cuda")
        nan[n // 3] = nan[:, n // 3] = True
        assert torch.equal(torch.isnan(gram[0]), nan) and not bool(torch.isnan(gram[1:]).any())
    for i in sorted({0, lanes // 2, lanes - 1}):
        single, single_sq = tops.gram(msgs[i].contiguous() if case != "unaligned" else msgs[i])
        assert torch.equal(_bits(gram[i]), _bits(single)) and torch.equal(_bits(sq[i]), _bits(single_sq))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,q,kernels", [(1, 100, 1), (1000, 100, 1), (1, 256, 1), (3, 4097, 2)])
def test_gram_is_one_launch_where_q_is_one_chunk(card, lanes, q, kernels):
    """At N = 100 a Q of at most 256 columns takes one kernel (it writes the
    Gram itself); past that the chunks' sums take a second."""
    from torch.profiler import ProfilerActivity, profile

    msgs = torch.randn((lanes, 100, q), generator=card, device="cuda")
    tops.gram(msgs)  # the kernels built and loaded
    torch.cuda.synchronize()
    before = tops.launch_counts()["gram"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tops.gram(msgs)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    assert tops.launch_counts()["gram"] == before + 1
    assert len(names) == kernels and all("gram" in name for name in names), names


@pytest.mark.cuda
def test_nnm_table_on_card_equals_the_cpus(card):
    """NNM's neighbour tables from the card's Gram equal the CPU's (the
    plain version's tree) on the Fig. 4 rows' shape: N = 100, Q = 100,
    b = 20 (k = 80 neighbours), 200 lanes."""
    msgs = torch.randn((200, 100, 100), generator=card, device="cuda") * 3
    table = nnm_neighbours(tops.pairwise_sqdist(msgs), 20)
    want = nnm_neighbours(tops.pairwise_sqdist(msgs.cpu()), 20)
    assert torch.equal(table.cpu(), want)


ROW_COMBINE_R = [1, 2, 3, 8, 13, 100, 128, 129, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("r", ROW_COMBINE_R)
def test_row_combines_are_bitwise_the_plain_versions(card, r):
    """``masked_combine`` and ``coded_combine`` equal their plain versions
    bit for bit at Q = 1, 100 and 4097, at 1 and 1,000 lanes, with a -0.0
    entry, an all -0.0 column and a 0-weight row over an inf (0 * inf is
    NaN in both); ``_sum_last``'s (1, 100, 100,000) at R = 100; one launch
    a call."""
    shapes = [(lanes, q) for lanes in (1, 1000) for q in (1, 100, 4097)]
    if r == 100:
        shapes.append((1, 100_000))
    for lanes, q in shapes:
        x = torch.randn((lanes, r, q), generator=card, device="cuda")
        w = (torch.rand((lanes, r), generator=card, device="cuda") < 0.6) * torch.rand(
            (lanes, r), generator=card, device="cuda")
        x[:, :, 0] = -0.0
        x[:, r // 2, min(1, q - 1)] = -0.0
        w[:, 0] = 0.0
        x[:, 0, q // 2] = math.inf
        for name, op, plain in (("masked_combine", tops.masked_combine, tref.masked_combine_ref),
                                ("coded_combine", tops.coded_combine, tref.coded_combine_ref)):
            before = tops.launch_counts()[name]
            got = op(x, w)
            want = plain(x, w)
            torch.cuda.synchronize()
            assert tops.launch_counts()[name] == before + 1
            nan = torch.isnan(want)
            assert bool(nan[:, q // 2].all()), (name, lanes, q)
            assert torch.equal(torch.isnan(got), nan) and torch.equal(_bits(got[~nan]), _bits(want[~nan])), \
                (name, lanes, q)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [7, 8, 41, 100])
def test_median_via_the_cwtm_kernel_is_bitwise_the_plain_version(card, n):
    msgs = torch.randn((n, (1 << 16) + 37), generator=card, device="cuda")
    before = tops.launch_counts()["cwtm"]
    got = coordinate_median(msgs)
    assert tops.launch_counts()["cwtm"] == before + 1
    torch.testing.assert_close(got, tref.cwtm_ref(msgs, (n - 1) // 2), rtol=0, atol=0)


def _random_tables(gen, lanes, n, k):
    """(lanes, n, k) int32 tables of k distinct ascending ids of [0, n) a row."""
    pick = torch.rand((lanes, n, n), generator=gen, device=gen.device).argsort(dim=-1)[..., :k]
    return pick.sort(dim=-1).values.to(torch.int32).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 100, 4097])
@pytest.mark.parametrize("n", [13, 41, 64, 65, 100, 128, 129, 256])
def test_cwtm_at_every_network_size_is_bitwise_the_plain_version(card, n, q):
    """Both sides of each padded size of the sorting network (16 to 256
    slots) and the shared-memory path past 128, at 1 and 3 lanes (columns
    that cross a lane's end inside a block), trim 0, floor(0.1 N) and
    (N - 1) // 2, with and without the mix."""
    for lanes in (1, 3):
        msgs = torch.randn((lanes, n, q), generator=card, device="cuda") * 3
        table = _random_tables(card, lanes, n, n - n // 5)
        for trim in sorted({0, n // 10, (n - 1) // 2}):
            torch.testing.assert_close(tops.cwtm(msgs, trim), tref.cwtm_ref(msgs, trim), rtol=0, atol=0)
            torch.testing.assert_close(tops.cwtm(msgs, trim, table), tcwtm.plain(msgs, trim, table),
                                       rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 100])
def test_cwtm_sorts_nan_last_as_the_plain_version(card, n):
    """NaN (either sign), +inf, -inf, +0 and -0 in the Byzantine rows: the
    kernel orders them as ``torch.sort`` does (NaN last), so a NaN inside the trim is
    dropped and one past it comes out NaN, with and without the mix. NaN at
    the same places, every other value equal (+0 equals -0)."""
    lanes, q, byz = 3, 1000, max(2, n // 5)
    msgs = torch.randn((lanes, n, q), generator=card, device="cuda")
    nan = math.copysign(math.nan, -1.0)  # a NaN with its sign bit set sorts last too
    specials = torch.tensor([math.nan, nan, math.inf, -math.inf, 0.0, -0.0], device="cuda")
    pick = torch.randint(0, 24, (lanes, byz, q), generator=card, device="cuda")  # a quarter of the entries
    msgs[:, :byz] = torch.where(pick < 6, specials[pick.clamp(max=5)], msgs[:, :byz])
    msgs[:, :byz, 0] = math.nan  # NaN in every Byzantine row: one outlasts a trim of 1
    msgs[:, 0, 0] = nan
    table = _random_tables(card, lanes, n, 2)  # two rows a mix: most mixed values stay finite
    for trim in sorted({1, max(1, n // 10)}):
        for nb in (None, table):
            got = tops.cwtm(msgs, trim, nb)
            want = tcwtm.plain(msgs, trim, nb)
            on_cpu = tcwtm.plain(msgs.cpu(), trim, None if nb is None else nb.cpu())
            assert torch.equal(torch.isnan(want).cpu(), torch.isnan(on_cpu))  # the plain version on both devices
            nan = torch.isnan(want)
            if trim == 1 and nb is None:  # two NaN in a column outlast a trim of 1
                assert 0 < int(nan.sum()) < nan.numel()
            assert torch.equal(torch.isnan(got), nan)
            assert torch.equal(got[~nan], want[~nan])


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
@pytest.mark.parametrize("kernel", ["gather_combine", "attack", "cwtm", "cwtm_nnm", "masked_combine"])
def test_kernels_above_the_grid_limit_equal_plain(card, kernel):
    """Folded lane counts above 65535 launch in slices of lanes: each slice
    counts, and the result equals the plain version bit for bit. The
    encode's grid is flat (lanes x column tiles): its 70,000 (lane, device)
    rows take one launch; so is the row combine's (lanes x columns)."""
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
                                   rtol=0, atol=0)
    elif kernel == "cwtm":
        torch.testing.assert_close(tops.cwtm(msgs, 1), tref.cwtm_ref(msgs, 1), rtol=0, atol=0)
    elif kernel == "masked_combine":
        w = torch.rand((lanes, n), generator=card, device="cuda")
        torch.testing.assert_close(tops.masked_combine(msgs, w), tref.masked_combine_ref(msgs, w), rtol=0, atol=0)
    else:
        table = torch.tensor([[0, 1, 2], [1, 2, 3], [2, 3, 4], [0, 3, 4], [0, 1, 4]], dtype=torch.int32,
                             device="cuda").expand(lanes, n, 3).contiguous()
        torch.testing.assert_close(tops.cwtm(msgs, 1, table), tcwtm.plain(msgs, 1, table), rtol=0, atol=0)
    after = tops.launch_counts()
    counter = "cwtm" if kernel == "cwtm_nnm" else kernel
    assert after[counter] - before[counter] == (1 if kernel in ("gather_combine", "masked_combine") else 2)


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


# ------------------------------------------------------------------ tooling


def _clear_workspaces() -> None:
    """Drop cuBLAS's per-stream workspaces where the build can, so that
    allocated memory counts what a run keeps."""
    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


MEM_SLACK = 4 << 20  # bytes a run may leave: a small cache of the allocator's; a probe or graph keeps nothing


@pytest.mark.cuda
def test_probe_past_the_cards_memory_is_none_and_frees_it(card):
    """A grid whose captured round allocates 0.55 of the card a lane (only
    under capture): the probe of 2 lanes runs out of memory inside the
    capture and raises the allocator's own error, the memory comes back,
    the next probe (1 lane) runs; the tuner records 2 as ``None`` and
    chooses 1, and the auto sweep equals loop mode bit for bit."""
    from repro_torch.core import engine
    from repro_torch.launch import tuner

    per_lane = int(0.55 * torch.cuda.get_device_properties(0).total_memory) // 4

    def grads(data, x):
        if torch.cuda.is_current_stream_capturing():
            torch.empty(x.shape[0] * per_lane, device=x.device).fill_(0.0)
        return tscn._subset_grads(data, x)

    rows = tscn.synthetic_sweep(4, n_devices=10, n_byz=2)
    z, y = tscn.linear_regression_problem(torch.Generator(device="cuda").manual_seed(0), n=10, dim=16)

    def kw(mode):
        return dict(steps=3, lr=[r.lr for r in rows], data=(z, y), data_batched=False, loss_fn=tscn._loss,
                    device="cuda", mode=mode,
                    randomness=[torch.Generator(device="cuda").manual_seed(i) for i in range(4)])

    dev = torch.device("cuda", torch.cuda.current_device())
    _clear_workspaces()
    before = torch.cuda.memory_allocated()
    plan = engine._plan_grid([r.protocol() for r in rows], torch.zeros(16), grads, **kw("graph"), draw_ids=None,
                             optimizer="sgd", momentum_dtype="float32", grad_scale=1.0, shard="none", group=None,
                             with_metrics=True)
    with pytest.raises(torch.OutOfMemoryError):
        engine._probe_chunk(plan.run_chunk, 2, 1, None, dev)
    _clear_workspaces()
    assert torch.cuda.memory_allocated() <= before + MEM_SLACK, (torch.cuda.memory_allocated(), before)
    assert engine._probe_chunk(plan.run_chunk, 1, 1, None, dev) > 0
    capacity, measured = tuner.tune_lane_capacity(lambda c: engine._probe_chunk(plan.run_chunk, c, 1, None, dev),
                                                  n_lanes=4, n_devices=1)
    assert capacity == 1 and measured[2] is None and measured[1] > 0, measured
    del plan
    store = tuner.set_store_path(None)
    try:
        auto = engine.run_grid([r.protocol() for r in rows], torch.zeros(16), grads, max_lanes_per_device="auto",
                               **kw("graph"))
        (rec,) = store.data["lane_capacity"].values()
        assert rec["capacity"] == 1 and rec["per_lane_s"]["2"] is None, rec
        loop = engine.run_grid([r.protocol() for r in rows], torch.zeros(16), grads, **kw("loop"))
        assert torch.equal(auto.x, loop.x) and all(torch.equal(auto.metrics[k], loop.metrics[k]) for k in loop.metrics)
    finally:
        tuner.reset_store()
    del auto, loop
    _clear_workspaces()
    assert torch.cuda.memory_allocated() <= before + MEM_SLACK, (torch.cuda.memory_allocated(), before)


@pytest.mark.cuda
def test_block_time_on_card_agrees_with_a_synchronised_clock(card):
    from repro_torch.timing import block_time

    a = torch.randn((4096, 4096), generator=card, device="cuda")

    def fn():
        for _ in range(8):
            torch.mm(a, a)

    events = block_time(fn, iters=5, warmup=2, device="cuda")
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - start) / 5
    assert 0.5 < events / host < 2.0, (events, host)


def _lane_inputs(gen, lanes, n=8, q=(1 << 16) + 37):
    """Each kernel's call on fixed inputs of ``lanes`` lanes."""
    x = torch.randn((lanes, n, q), generator=gen, device="cuda")
    subsets = torch.randint(0, n, (lanes, n, 2), generator=gen, device="cuda")
    table = nnm_neighbours(tops.pairwise_sqdist(x), 2)
    mask = (torch.arange(n, device="cuda") < 2).float().expand(lanes, n).contiguous()
    g0 = x[:, 0].contiguous()
    u = torch.rand(g0.shape, generator=gen, device="cuda")
    rw = torch.rand((lanes, n), generator=gen, device="cuda")
    stack, cw = x[:, :2].contiguous(), torch.rand((lanes, 2), generator=gen, device="cuda")
    return {
        "gather_combine": lambda: tops.gather_combine(x, subsets, torch.full((2,), 0.5, device="cuda")),
        "attack": lambda: tops.attack(x, mask, "alie", 1.5),
        "cwtm": lambda: (tops.cwtm(x, 2), tops.cwtm(x, 2, table)),
        "gram": lambda: tops.gram(x),
        "quantize": lambda: tops.stochastic_quantize(g0, u, 4, 1024),
        "masked_combine": lambda: tops.masked_combine(x, rw),
        "coded_combine": lambda: tops.coded_combine(stack, cw),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 3, 8])
@pytest.mark.parametrize("kernel", ["gather_combine", "attack", "cwtm", "gram", "quantize", "masked_combine",
                                    "coded_combine"])
def test_lane_loop_dispatch_equals_batched_launch_on_card(card, kernel, lanes):
    """The crossover table steering a kernel to one launch a lane gives the
    batched launch's bits, with one launch a lane."""
    from repro_torch.launch import tuner

    store = tuner.TunerStore(None)
    calls = _lane_inputs(card, lanes)
    batched = calls[kernel]()
    tuner.record_crossover(kernel, lanes, batched_us=10.0, loop_us=1.0, store=store)
    before = tops.launch_counts()[kernel]
    with tops.crossover(functools.partial(tuner.lane_dispatch, store=store)):
        looped = calls[kernel]()
    launched = tops.launch_counts()[kernel] - before
    for b, lp in zip(batched if isinstance(batched, tuple) else (batched,),
                     looped if isinstance(looped, tuple) else (looped,)):
        assert torch.equal(b, lp)
    per_call = 2 if kernel == "cwtm" else 1  # CWTM is called with and without the mix
    assert launched == per_call * lanes


@pytest.mark.cuda
def test_captured_launch_list_is_the_cpus(card):
    """The launch list of a captured round on the card has one entry for
    each captured launch, and the same kernels, shapes and work as the
    CPU's loop-mode list: the work does not depend on which
    implementation runs."""
    from repro_torch.launch import roofline

    rows = tscn.synthetic_sweep(5, n_devices=16, n_byz=3)
    kw = dict(dim=24, max_lanes_per_device=2)
    card_list = tscn.grid_launch_list(rows, 4, device="cuda", mode="graph", **kw)
    cpu_list = tscn.grid_launch_list(rows, 4, device="cpu", mode="loop", **kw)
    res = tscn.run_grid(rows, 4, device="cuda", mode="graph", **kw)
    captured = res[rows[0].name].grid.graphs[0].captured_launches
    assert {k: len(v) for k, v in card_list.items()} == {k: captured[k] for k in card_list}
    assert card_list == cpu_list
    bound = roofline.analyze_launches(card_list, "cuda")
    assert bound["launches"] == sum(len(v) for v in card_list.values()) and bound["predicted_s"] > 0


# ------------------------------------------------------- the model axis's ops


@pytest.fixture(scope="module")
def tp_ops_on_card(tmp_path_factory):
    """``torch_tp_ranks.run_tp_ops`` on 2 model ranks on the card (two
    processes over ``gloo``'s CUDA path), and the whole ops on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch_tp_ranks

    ranks = torch_tp_ranks.spawn("ops-cuda", 2, 2, tmp_path_factory.mktemp("tp_ops_cuda"))
    return ranks, torch_tp_ranks.run_tp_ops(torch_tp_ranks.op_protocol(1))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["expert", "expert_cut_input", "moe", "mamba", "rwkv_time", "rwkv_channel"])
def test_tp_ops_on_card_match_the_whole_op_on_cpu(tp_ops_on_card, name):
    """The expert-parallel ``pmm`` and the MoE, Mamba and RWKV layers on 2
    model ranks on the card, forward and backward (each output and
    cotangent joined whole over the ranks, the two ranks' joins equal),
    against the whole op on the CPU: rtol 1e-5, atol 1e-6 of the largest
    value."""
    ranks, whole = tp_ops_on_card
    keys = [k for k in whole if k.split("/")[0] == name]
    assert keys
    for key in keys:
        got, want = torch.from_numpy(ranks[0][key]), torch.from_numpy(whole[key])
        assert torch.equal(got, torch.from_numpy(ranks[1][key])), key
        assert torch.allclose(got, want, rtol=RTOL, atol=ATOL * float(want.abs().max())), key
