"""The plans and the summation orders of the Gram and row-combine kernels
(``csrc/gram.cu``, ``csrc/row_combine.cu``), replayed on the CPU.

The kernels run only on the card (``tests/test_torch_card.py``), so here
their orders are replayed in float32 numpy from the plans that the wrappers
pass them:

  * the row combine deals the R rows to G groups (row g + k G to group g),
    adds each group's rows as the tree's first log2(P / G) levels, then
    crosses the groups in the tree's order. The replay equals
    ``numerics.tree_sum`` of the products (the port's and the reference's)
    bit for bit for every G ``row_plan`` may choose, -0.0 and 0 * inf
    included;
  * the Gram's tile plan covers every pair i <= j exactly once, fits in
    shared memory, and cuts Q by N and Q alone; its order (32-column FMA
    chains, the segments added left to right, then the chunks) gives the
    same bits whether a segment has a thread of its own or not.
"""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import numerics as jnum
from repro_torch.kernels import coded_combine as tcc
from repro_torch.kernels import nnm_dist as tnd
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tiles
from repro_torch.numerics import tree_sum

CSRC = Path(tnd.__file__).resolve().parent.parent / "csrc"
ROWS = [1, 2, 3, 8, 13, 100, 128, 129, 256]
PLAN_LANES = [1, 3, 131, 1000]
PLAN_Q = [1, 3, 4, 100, 101, 4097, 100_000, 361_821_120]


def _constant(source: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text()).group(1))


def test_plans_carry_the_kernels_constants():
    """The Python plans and the CUDA sources agree on their constants."""
    assert _constant("gram.cu", "kSeg") == tnd.SEG
    assert _constant("gram.cu", "kMaxN") == tnd.MAX_N
    assert _constant("gram.cu", "kRegMaxN") == tnd.REG_MAX_N
    assert _constant("gram.cu", "kTile") == tnd.TILE
    assert _constant("gram.cu", "kTileThreads") == tnd._TILE_THREADS
    assert _constant("row_combine.cu", "kMaxRows") == tcc.MAX_ROWS
    assert _constant("row_combine.cu", "kMaxLocal") == tcc.ROW_MAX_LOCAL
    assert _constant("row_combine.cu", "kMaxGroups") == tcc.ROW_MAX_GROUPS


# ------------------------------------------------------------- row combine


def _row_groups(r: int) -> list[int]:
    """Every G ``row_plan`` may give R rows."""
    p = 1 << (r - 1).bit_length()
    if p <= tcc.ROW_MAX_LOCAL:
        return [1]
    return [1 << k for k in range((p // tcc.ROW_MAX_LOCAL).bit_length() - 1, min(p, tcc.ROW_MAX_GROUPS).bit_length())]


def _row_replay(x: np.ndarray, w: np.ndarray, groups: int) -> np.ndarray:
    """csrc/row_combine.cu's order in float32: group g holds rows g + k G
    (+0.0 past R), adds them as a tree in registers (u[k] += u[k + h] for
    h = P / 2G, ..., 1), then group g < h adds group g + h's sum for
    h = G / 2, ..., 1."""
    r = x.shape[0]
    p = 1 << (r - 1).bit_length()
    local = p // groups
    terms = np.zeros((p,) + x.shape[1:], dtype=np.float32)
    with np.errstate(invalid="ignore"):
        terms[:r] = w[:, None] * x
    sums = []
    for g in range(groups):
        u = [terms[g + k * groups] for k in range(local)]
        h = local // 2
        while h >= 1:
            u = [u[k] + u[k + h] for k in range(h)]
            h //= 2
        sums.append(u[0])
    h = groups // 2
    while h >= 1:
        sums = [sums[g] + sums[g + h] for g in range(h)]
        h //= 2
    return sums[0]


def _same_bits(got: np.ndarray, want: np.ndarray) -> bool:
    nan = np.isnan(want)
    return bool(np.array_equal(np.isnan(got), nan)
                and np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32)))


@pytest.mark.parametrize("r", ROWS)
def test_row_combine_order_replayed_is_tree_sum_bitwise(r):
    """For every G the plan may choose, the replayed order equals
    ``tree_sum(x * w)`` (the port's plain version and the reference's
    tree) bit for bit, with a -0.0 in a column, an all -0.0 column, and a
    0-weight row over an inf (0 * inf is NaN in both)."""
    rng = np.random.default_rng(r)
    x = rng.standard_normal((r, 40)).astype(np.float32)
    w = (rng.random(r) * (rng.random(r) < 0.6)).astype(np.float32)
    w[0] = 0.0
    x[:, 0] = -0.0
    x[r // 2, 1] = -0.0
    x[0, 2] = np.inf
    x[r - 1, 3] = -np.inf
    with np.errstate(invalid="ignore"):
        products = x * w[:, None]
    want = tree_sum(torch.from_numpy(products), dim=0).numpy()
    reference = np.asarray(jnum.tree_sum(jnp.asarray(products), axis=0))
    assert _same_bits(reference, want)
    # 0 * inf is NaN; an all -0.0 column stays -0.0 only where no padding zero is added
    zero = np.float32(-0.0 if r & (r - 1) == 0 else 0.0)
    assert np.isnan(want[2]) and want[0].view(np.int32) == zero.view(np.int32)
    for groups in _row_groups(r):
        assert _same_bits(_row_replay(x, w, groups), want), groups
    plain = tref.masked_combine_ref(torch.from_numpy(x)[None], torch.from_numpy(w)[None])[0].numpy()
    assert _same_bits(plain, want)


@pytest.mark.parametrize("r", ROWS)
def test_row_plan_picks_a_power_of_two_that_fits(r):
    """G is a power of two, at most P and 16, leaves a thread at most 16
    rows (8 below P = 256), is 1 up to 16 rows, and grows past that only
    where the card would idle; 16-byte loads only on aligned rows, and only
    where the 4-column threads make a warp for every SM."""
    p = 1 << (r - 1).bit_length()
    for lanes in PLAN_LANES:
        for q in PLAN_Q:
            for aligned in (False, True):
                g, vec = tcc.row_plan(lanes, r, q, aligned)
                assert vec in (1, 4) and (vec == 1 or aligned and q % 4 == 0), (lanes, q, aligned, vec)
                assert (vec == 4) == (aligned and q % 4 == 0 and lanes * (q // 4) >= tcc._ROW_VEC_ITEMS)
                assert g & (g - 1) == 0 and 1 <= g <= min(p, tcc.ROW_MAX_GROUPS), (lanes, q, vec, g)
                assert p // g <= (tcc.ROW_MAX_LOCAL if p == 256 else 8) or p <= 16, (lanes, q, vec, g)
                assert p > 16 or g == 1, (lanes, q, vec, g)
                assert g in _row_groups(r)
                if g > max(1, min(tcc.ROW_MAX_GROUPS, p // 8)):
                    assert lanes * -(-q // vec) * (g // 2) < tcc._ROW_FILL
    assert tcc.row_plan(1, 100, 100, True) == (16, 1) and tcc.row_plan(1000, 100, 100, True) == (16, 4)
    assert tcc.row_plan(1, 100, 100_000, True) == (16, 4)
    assert tcc.row_plan(1, 8, 361_821_120, True) == (1, 4) and tcc.row_plan(8, 2, 361_821_120, True) == (1, 4)


# -------------------------------------------------------------------- Gram

GRAM_N = [13, 16, 20, 41, 64, 100, 127, 128]
GRAM_Q = [1, 3, 31, 32, 33, 100, 256, 257, 300, 4097, 1 << 20, (1 << 20) + 37, 361_821_120]


@pytest.mark.parametrize("n", GRAM_N)
def test_gram_plan_covers_every_pair_once_and_fits(n):
    """Tile pairs a <= b over rows a + r K cover every pair i <= j exactly
    once (the diagonal tiles by r <= s); the blocks of ``pairs`` tile pairs
    cover every tile pair; the panel and the slots fit in shared memory;
    chunks and panels are whole 32-column segments; a block has at most 512
    threads; Q is cut by N and Q alone, the same for every lane count."""
    seen = np.zeros((n, n), dtype=np.int64)
    count = -(-n // tnd.TILE)
    for a, b in tnd.tile_pairs(n):
        for r, i in enumerate(tnd.tile_rows(n, a)):
            for s, j in enumerate(tnd.tile_rows(n, b)):
                if i < n and j < n and (a != b or r <= s):
                    seen[min(i, j), max(i, j)] += 1
    assert np.array_equal(seen, np.triu(np.ones((n, n), dtype=np.int64)))
    assert len(tnd.tile_pairs(n)) == count * (count + 1) // 2
    for q in GRAM_Q:
        chunking = tnd.gram_chunking(n, q)
        for lanes in PLAN_LANES:
            plan = tnd.gram_plan(lanes, n, q)
            assert (plan.chunk_len, plan.chunks) == chunking, (q, lanes)
            assert (plan.chunks - 1) * plan.chunk_len < q <= plan.chunks * plan.chunk_len
            assert plan.chunk_len % tnd.SEG == 0 and plan.width % tnd.SEG == 0
            assert plan.chunk_len % plan.width == 0 and plan.stride >= min(plan.width, -(-q // 4) * 4)
            assert plan.stride % 4 == 0 and (plan.stride // 4) % 2 == 1
            assert plan.split in (1, plan.chunk_len // tnd.SEG)
            assert plan.split == 1 or (plan.chunks == 1 and plan.width == plan.chunk_len)
            assert plan.pairs * plan.split <= tnd._TILE_THREADS and plan.threads % 32 == 0
            all_pairs = len(tnd.tile_pairs(n))
            assert plan.pair_blocks * plan.pairs >= all_pairs > (plan.pair_blocks - 1) * plan.pairs
            assert plan.smem <= tiles.SMEM_MAX
            assert plan.chunks < 2 ** 31 // (lanes * plan.pair_blocks) or lanes * n * q * 4 > 80e9
        if q <= 256:
            assert chunking == (-(-q // tnd.SEG) * tnd.SEG, 1)  # one launch, no scratch


def _fma(a, b, c):
    """An fp32 FMA, rounded once from the exact float64 product (the add
    rounds twice, which the replay does alike on both of its paths)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _gram_replay(x: np.ndarray, plan: tnd.GramPlan) -> tuple[np.ndarray, np.ndarray]:
    """csrc/gram.cu's tile path on one lane, in float32, loop for loop:
    each chunk's panels of ``plan.width`` columns (columns past Q to a
    multiple of 4 and rows past N zero); each tile pair's sums (a
    thread's registers) as 32-column FMA chains; with ``plan.split`` > 1
    slot s chains segment s of the one panel and slot 0 adds the non-empty
    slots' sums left to right, else a thread adds its segments' sums in
    turn, panel after panel; the chunks' triangles left to right; G[i][j],
    G[j][i] and sq from the one sum."""
    n, q = x.shape
    count = -(-n // tnd.TILE)
    cols = plan.chunks * plan.chunk_len
    rows = np.zeros((tnd.TILE * count, cols), dtype=np.float32)
    rows[:n, :q] = x
    tri = n * (n + 1) // 2
    partial = np.zeros((plan.chunks, tri), dtype=np.float32)
    gram, sq = np.full((n, n), np.nan, dtype=np.float32), np.full(n, np.nan, dtype=np.float32)

    def chain(ra, rb, c0, c1):
        acc = np.zeros((tnd.TILE, tnd.TILE), dtype=np.float32)
        for c in range(c0, c1):
            acc = _fma(rows[ra, c][:, None], rows[rb, c][None, :], acc)
        return acc

    for chunk in range(plan.chunks):
        c_begin = chunk * plan.chunk_len
        c_end = min(q, c_begin + plan.chunk_len)
        for a, b in tnd.tile_pairs(n):
            ra, rb = tnd.tile_rows(n, a), tnd.tile_rows(n, b)
            if plan.split > 1:
                valid = c_end - c_begin
                valid4 = -(-valid // 4) * 4
                slots = [chain(ra, rb, c_begin + k * tnd.SEG, c_begin + min(k * tnd.SEG + tnd.SEG, valid4))
                         for k in range(plan.split) if k * tnd.SEG < valid]
                total = slots[0]
                for v in slots[1:]:
                    total = total + v
            else:
                total = None
                for base in range(c_begin, c_end, plan.width):
                    valid = min(c_end - base, plan.width)
                    valid4 = -(-valid // 4) * 4
                    for c0 in range(0, valid, tnd.SEG):
                        part = chain(ra, rb, base + c0, base + min(c0 + tnd.SEG, valid4))
                        total = part if total is None else total + part
            for r, i in enumerate(ra):
                for s, j in enumerate(rb):
                    if i >= n or j >= n or (a == b and r > s):
                        continue
                    lo, hi = min(i, j), max(i, j)
                    partial[chunk, lo * n - lo * (lo - 1) // 2 + (hi - lo)] = total[r, s]
    for i in range(n):
        for j in range(i, n):
            v = partial[0, i * n - i * (i - 1) // 2 + (j - i)]
            for c in range(1, plan.chunks):
                v = v + partial[c, i * n - i * (i - 1) // 2 + (j - i)]
            gram[i, j] = gram[j, i] = v
            if i == j:
                sq[i] = v
    return gram, sq


@pytest.mark.parametrize("n,q", [(13, 1), (13, 3), (16, 100), (20, 257), (41, 70)])
def test_gram_order_replayed_is_symmetric_and_close_to_gram_ref(n, q):
    """The replayed tile path is symmetric with sq on its diagonal, equal
    at the plan of 1 lane (a slot a segment where Q is one chunk) and of
    100,000 lanes (a thread every segment), and within ATOL * max(sq) of the
    plain version (rtol 1e-5, atol 1e-6, as the card tests hold it)."""
    rng = np.random.default_rng(n * 1000 + q)
    x = (rng.standard_normal((n, q)) * 3.0).astype(np.float32)
    one, many = tnd.gram_plan(1, n, q), tnd.gram_plan(100_000, n, q)
    assert one.chunk_len == many.chunk_len and many.split == 1 and (q > 32) <= (one.split > 1 or one.chunks > 1)
    gram, sq = _gram_replay(x, one)
    again, sq_again = _gram_replay(x, many)
    assert np.array_equal(gram.view(np.int32), again.view(np.int32))
    assert np.array_equal(sq.view(np.int32), sq_again.view(np.int32))
    assert np.array_equal(gram, gram.T) and np.array_equal(np.diagonal(gram), sq)
    want_gram, want_sq = tref.gram_ref(torch.from_numpy(x))
    scale = float(want_sq.max())
    np.testing.assert_allclose(gram, want_gram.numpy(), rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(sq, want_sq.numpy(), rtol=1e-5, atol=1e-6 * scale)


def test_row_combine_launches_any_lane_count_once():
    """The row combine's grid is flat over (lane, column): 70,000 lanes, past
    the 65535 blocks of a grid's y axis, are one launch of its work."""
    from repro_torch.kernels import ops as tops

    x, w = torch.randn((70_000, 3, 4)), torch.rand((70_000, 3))
    with tops.record_launches() as log:
        got = tops.masked_combine(x, w)
    assert [(e["kernel"], e["lanes"]) for e in log] == [("masked_combine", 70_000)]
    assert log[0]["bytes"] == 4.0 * 70_000 * (3 * 4 + 4)
    assert _same_bits(got.numpy(), tref.masked_combine_ref(x, w).numpy())
