"""The port's kernel wrappers against the JAX reference, on the CPU.

On a CPU tensor each ``repro_torch.kernels.ops`` wrapper runs its plain
PyTorch version; the CUDA kernels themselves are held against those plain
versions on the card by ``chip_smoke.py`` and ``tests/test_torch_card.py``.
Here the same numpy inputs go through
``repro.kernels.ops.<op>(..., backend="interpret")`` (the Pallas kernel in
interpret mode, as tests/test_kernels.py runs it), through the
``repro.kernels.ref`` oracle and through the port.

Tolerance: rtol 1e-5, atol 1e-6, as tests/test_kernels.py, except the
Gram, whose fp32 rounding scales with sum_q |x_i[q] x_j[q]| <= max row norm
squared rather than with |G_ij| (an off-diagonal entry can be near 0 after
cancellation): there atol is 1e-6 times the largest squared row norm.
QSGD is bitwise: the port's quantizer divides as the reference's oracle and
its Pallas kernel do. At a level count that is not a power of two the
Pallas kernel in interpret mode rounds one division differently (one ulp of
the output; its own oracle and XLA path agree with the port bitwise), so
there it is held to rtol 1e-6 only.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.coded_combine import coded_combine_pallas_lanes, masked_combine_pallas_lanes
from repro.kernels.nnm_dist import gram_pallas_lanes
from repro_torch.core import aggregators as tagg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.numerics import tree_sum

RTOL, ATOL = 1e-5, 1e-6

# (lanes, N, Q); lanes 0 means no lane axis. Q=300 is ragged against every
# CUDA kernel's block width.
SHAPES = [(0, 100, 100), (0, 8, 4096), (0, 100, 300), (3, 16, 300)]
SHAPE_IDS = ["N100-Q100", "N8-Q4096", "N100-Q300", "L3-N16-Q300"]


def _stack(rng, lanes, n, q, scale=3.0):
    shape = (n, q) if lanes == 0 else (lanes, n, q)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got: torch.Tensor, want, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **({"rtol": RTOL, "atol": ATOL} | kw))


def _lanes_equal_single(fn, *args):
    """A batched call equals the per-lane calls bitwise."""
    batched = fn(*args)
    lanes = args[0].shape[0]
    for i in range(lanes):
        single = fn(*(a[i] if isinstance(a, torch.Tensor) and a.ndim > 1 else a for a in args))
        for b, s in zip(batched if isinstance(batched, tuple) else (batched,),
                        single if isinstance(single, tuple) else (single,)):
            assert torch.equal(b[i], s)


@pytest.mark.parametrize("lanes,n,q", SHAPES, ids=SHAPE_IDS)
def test_gather_combine_matches_reference(lanes, n, q):
    rng = np.random.default_rng(n * q + lanes)
    grads = _stack(rng, lanes, n, q)
    d = 3 if n < 10 else 10
    lead = () if lanes == 0 else (lanes,)
    subsets = rng.integers(0, n, size=lead + (n, d)).astype(np.int32)
    w = np.full((d,), 1.0 / d, np.float32)
    got = tops.gather_combine(torch.from_numpy(grads), torch.from_numpy(subsets), torch.from_numpy(w))
    want_kernel = jops.gather_combine(jnp.asarray(grads), jnp.asarray(subsets), jnp.asarray(w),
                                      backend="interpret")
    _close(got, want_kernel)
    _close(got, jref.gather_combine_ref(jnp.asarray(grads), jnp.asarray(subsets), jnp.asarray(w)))


@pytest.mark.parametrize("name,param", [("sign_flip", -2.0), ("alie", 1.5), ("ipm", 0.5)])
@pytest.mark.parametrize("lanes,n,q", SHAPES, ids=SHAPE_IDS)
def test_attack_matches_reference(lanes, n, q, name, param):
    rng = np.random.default_rng(7 * n + q + lanes)
    msgs = _stack(rng, lanes, n, q)
    lead = () if lanes == 0 else (lanes,)
    mask = (rng.random(lead + (n,)) < 0.25).astype(np.float32)
    got = tops.attack(torch.from_numpy(msgs), torch.from_numpy(mask), name, param)
    want_kernel = jops.attack(jnp.asarray(msgs), jnp.asarray(mask), name, param, backend="interpret")
    _close(got, want_kernel)
    _close(got, jref.attack_ref(jnp.asarray(msgs), jnp.asarray(mask), name, param))


@pytest.mark.parametrize("lanes,n,q", SHAPES, ids=SHAPE_IDS)
def test_cwtm_matches_reference(lanes, n, q):
    rng = np.random.default_rng(3 * n + q + lanes)
    msgs = _stack(rng, lanes, n, q)
    trim = max(1, n // 10)
    got = tops.cwtm(torch.from_numpy(msgs), trim)
    _close(got, jops.cwtm(jnp.asarray(msgs), trim, backend="interpret"))
    _close(got, jref.cwtm_ref(jnp.asarray(msgs), trim))


@pytest.mark.parametrize("lanes,n,q", SHAPES, ids=SHAPE_IDS)
def test_gram_and_sqdist_match_reference(lanes, n, q):
    rng = np.random.default_rng(5 * n + q + lanes)
    msgs = _stack(rng, lanes, n, q)
    gram, sq = tops.gram(torch.from_numpy(msgs))
    flat = jnp.asarray(msgs.reshape((-1, n, q)))
    want_gram, want_sq = gram_pallas_lanes(flat, q_block=min(2048, q), interpret=True)
    scale = float(np.max(np.asarray(want_sq)))
    _close(gram, np.asarray(want_gram).reshape(gram.shape), atol=ATOL * scale)
    _close(sq, np.asarray(want_sq).reshape(sq.shape))
    d2 = tops.pairwise_sqdist(torch.from_numpy(msgs))
    for want in (jops.pairwise_sqdist(jnp.asarray(msgs), backend="interpret"),
                 jref.pairwise_sqdist_ref(jnp.asarray(msgs))):
        _close(d2, want, atol=4 * ATOL * scale)


def test_batched_equals_single_bitwise():
    """Inside the port a lane of a batched call equals the single call."""
    rng = np.random.default_rng(11)
    msgs = torch.from_numpy(_stack(rng, 3, 16, 300))
    mask = torch.from_numpy((rng.random((3, 16)) < 0.25).astype(np.float32))
    subsets = torch.from_numpy(rng.integers(0, 16, size=(3, 16, 4)).astype(np.int32))
    w = torch.full((3, 4), 0.25)
    _lanes_equal_single(tops.gather_combine, msgs, subsets, w)
    for name, param in (("sign_flip", -2.0), ("alie", 1.5), ("ipm", 0.5)):
        _lanes_equal_single(lambda m, mk: tops.attack(m, mk, name, param), msgs, mask)
    _lanes_equal_single(lambda m: tops.cwtm(m, 2), msgs)
    _lanes_equal_single(tops.gram, msgs)
    _lanes_equal_single(tops.masked_combine, msgs, torch.from_numpy(rng.random((3, 16)).astype(np.float32)))
    _lanes_equal_single(tops.coded_combine, msgs, torch.from_numpy(rng.random((3, 16)).astype(np.float32)))
    u = torch.from_numpy(rng.random((3, 16, 300)).astype(np.float32))
    _lanes_equal_single(lambda g, uu: tops.stochastic_quantize(g, uu, 4, 128), msgs, u)


def test_cwtm_plain_sums_the_kept_rows_as_a_tree():
    """The plain CWTM is sort, trim, then numerics.tree_sum times 1/k: the
    order the CUDA kernel reproduces term for term."""
    rng = np.random.default_rng(2)
    msgs = torch.from_numpy(_stack(rng, 0, 13, 50))
    kept = torch.sort(msgs, dim=0).values[2:11]
    assert torch.equal(tops.cwtm(msgs, 2), tree_sum(kept, dim=0) * (1.0 / 9))


@pytest.mark.parametrize("bad", ["float64", "strided", "trim"])
def test_wrappers_raise_on_what_they_do_not_take(bad):
    msgs = torch.randn(8, 64)
    if bad == "float64":
        with pytest.raises(TypeError):
            tops.cwtm(msgs.double(), 1)
    elif bad == "strided":
        with pytest.raises(ValueError):
            tops.attack(msgs.t(), torch.zeros(64), "sign_flip", -2.0)
    else:
        with pytest.raises(ValueError):
            tops.cwtm(msgs, 4)


def test_gather_combine_rejects_out_of_range_ids():
    with pytest.raises(IndexError):
        tops.gather_combine(torch.randn(4, 8), torch.tensor([[0], [1], [2], [4]]), torch.ones(1))


def test_cpu_calls_launch_no_kernel():
    tops.reset_launch_counts()
    msgs = torch.randn(8, 64)
    tops.cwtm(msgs, 1)
    tops.pairwise_sqdist(msgs)
    tops.stochastic_quantize(msgs, torch.rand(8, 64), 4, 16)
    tops.masked_combine(msgs, torch.ones(8))
    tops.coded_combine(msgs, torch.ones(8))
    assert tops.launch_counts() == {name: 0 for name in tops.KERNELS}


# (lanes, Q, chunk, levels): ragged Q against the chunk, Q < chunk, a chunk
# that is not a power of two, and a lane axis
QUANT_CASES = [(0, 3000, 1024, 16), (0, 100, 1024, 4), (8, 3000, 1000, 4), (3, 777, 96, 16),
               (8, 4096, 1024, 4)]


@pytest.mark.parametrize("lanes,q,chunk,levels", QUANT_CASES, ids=[f"L{c[0]}-Q{c[1]}-c{c[2]}-l{c[3]}" for c in QUANT_CASES])
def test_stochastic_quantize_matches_reference_bitwise(lanes, q, chunk, levels):
    rng = np.random.default_rng(q + chunk + levels)
    shape = (q,) if lanes == 0 else (lanes, q)
    g = (rng.standard_normal(shape) * 3).astype(np.float32)
    g[..., 5:9] = 0.0  # exact zeros, and below a block whose scale is 0
    if q > 2 * min(chunk, q):
        g[..., :min(chunk, q)] = 0.0
    u = rng.random(shape).astype(np.float32)
    got = tops.stochastic_quantize(torch.from_numpy(g), torch.from_numpy(u), levels, chunk).numpy()
    for backend in ("interpret", "xla"):
        want = np.asarray(jops.stochastic_quantize(jnp.asarray(g), jnp.asarray(u), levels, chunk, backend=backend))
        np.testing.assert_array_equal(got, want, err_msg=backend)


def test_stochastic_quantize_odd_levels_match_reference():
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((3, 1000)) * 3).astype(np.float32)
    u = rng.random((3, 1000)).astype(np.float32)
    got = tops.stochastic_quantize(torch.from_numpy(g), torch.from_numpy(u), 3, 96).numpy()
    want = np.asarray(jops.stochastic_quantize(jnp.asarray(g), jnp.asarray(u), 3, 96, backend="xla"))
    np.testing.assert_array_equal(got, want)
    kernel = jops.stochastic_quantize(jnp.asarray(g), jnp.asarray(u), 3, 96, backend="interpret")
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=1e-6)


@pytest.mark.parametrize("lanes,n,q", SHAPES, ids=SHAPE_IDS)
def test_masked_combine_matches_reference(lanes, n, q):
    rng = np.random.default_rng(13 * n + q + lanes)
    # rows of scale 1/sqrt(N), so that a sum is of order 1 and atol 1e-6
    # stays above the rounding of a sum that cancels
    msgs = _stack(rng, lanes, n, q, scale=n ** -0.5)
    lead = () if lanes == 0 else (lanes,)
    # a mask times a class selection: exact zeros on most rows
    w = ((rng.random(lead + (n,)) < 0.5) * rng.random(lead + (n,))).astype(np.float32)
    got = tops.masked_combine(torch.from_numpy(msgs), torch.from_numpy(w))
    want_kernel = masked_combine_pallas_lanes(jnp.asarray(msgs.reshape((-1, n, q))), jnp.asarray(w.reshape((-1, n))),
                                              q_block=q, interpret=True)
    _close(got, np.asarray(want_kernel).reshape(got.shape))
    _close(got, jops.masked_combine(jnp.asarray(msgs), jnp.asarray(w), backend="interpret"))
    _close(got, jref.masked_combine_ref(jnp.asarray(msgs), jnp.asarray(w)))


@pytest.mark.parametrize("lanes,d,q", [(0, 3, 300), (4, 10, 4096), (8, 2, 2048), (3, 1, 100)])
def test_coded_combine_matches_reference(lanes, d, q):
    rng = np.random.default_rng(17 * d + q + lanes)
    grads = _stack(rng, lanes, d, q, scale=d ** -0.5)
    lead = () if lanes == 0 else (lanes,)
    w = rng.random(lead + (d,)).astype(np.float32)
    got = tops.coded_combine(torch.from_numpy(grads), torch.from_numpy(w))
    want_kernel = coded_combine_pallas_lanes(jnp.asarray(grads.reshape((-1, d, q))), jnp.asarray(w.reshape((-1, d))),
                                             q_block=min(2048, q), interpret=True)
    _close(got, np.asarray(want_kernel).reshape(got.shape))
    _close(got, jops.coded_combine(jnp.asarray(grads), jnp.asarray(w), backend="interpret"))
    _close(got, jref.coded_combine_ref(jnp.asarray(grads), jnp.asarray(w)))
    # one weight vector for every lane
    _close(tops.coded_combine(torch.from_numpy(grads), torch.from_numpy(w.reshape((-1, d))[0])),
           jref.coded_combine_ref(jnp.asarray(grads), jnp.asarray(w.reshape((-1, d))[0])))


def test_row_combines_sum_as_the_plain_tree():
    """The plain combines are one product per row, then numerics.tree_sum
    over rows: the order the CUDA kernel repeats term for term."""
    rng = np.random.default_rng(4)
    msgs = torch.from_numpy(_stack(rng, 0, 13, 50))
    w = torch.from_numpy(rng.random(13).astype(np.float32))
    want = tree_sum(msgs * w[:, None], dim=0)
    assert torch.equal(tops.masked_combine(msgs, w), want)
    assert torch.equal(tops.coded_combine(msgs, w), want)


# (lanes, N, Q, n_byz, trim): the wide round's N = 8 at a ragged Q, a lane
# axis, and the trainer's N = 100
CWTM_NNM_CASES = [(1, 8, 1000 + 37, 2, 2), (3, 8, 257, 2, 1), (1, 100, 100, 20, 10)]


@pytest.mark.parametrize("lanes,n,q,n_byz,trim", CWTM_NNM_CASES,
                         ids=[f"L{c[0]}-N{c[1]}-Q{c[2]}-b{c[3]}-t{c[4]}" for c in CWTM_NNM_CASES])
def test_cwtm_nnm_matches_reference(lanes, n, q, n_byz, trim):
    """The fused CWTM-NNM (the CWTM wrapper given NNM's neighbour table)
    against the reference's ``nnm_then(cwtm)`` and against its Pallas
    composition in interpret mode (Gram distances, the mix, then the CWTM
    kernel on the mixed stack), lane by lane. Tolerance: rtol 1e-5, atol
    1e-6 times the inputs' scale (the mix sums k rows in another order)."""
    scale = 3.0
    rng = np.random.default_rng(19 * n + q + lanes)
    msgs = _stack(rng, lanes, n, q, scale=scale)
    x = torch.from_numpy(msgs)
    got = tops.cwtm(x, trim, tagg.nnm_neighbours(tops.pairwise_sqdist(x), n_byz))
    assert got.shape == (lanes, q)
    trim_frac = (trim + 0.5) / n  # int(trim_frac * n) == trim
    for lane in range(lanes):
        xj = jnp.asarray(msgs[lane])
        want = jagg.make_aggregator("cwtm-nnm", n_byz=n_byz, trim_frac=trim_frac)(xj)
        _close(got[lane], want, atol=ATOL * scale)
        mixed = jagg.nnm_mix(xj, n_byz, jops.pairwise_sqdist(xj, backend="interpret"))
        _close(got[lane], jops.cwtm(mixed, trim, backend="interpret"), atol=ATOL * scale)


@pytest.mark.parametrize("lanes,n,q", SHAPES, ids=SHAPE_IDS)
def test_cwtm_with_identity_neighbours_is_cwtm_bitwise(lanes, n, q):
    """k = 1, each row its own neighbour: the mix multiplies by 1.0, so the
    fused plain version is the plain CWTM bit for bit."""
    rng = np.random.default_rng(23 * n + q + lanes)
    x = torch.from_numpy(_stack(rng, lanes, n, q))
    ident = torch.arange(n, dtype=torch.int32)[:, None].expand(x.shape[:-1] + (1,)).contiguous()
    trim = max(1, n // 10)
    assert torch.equal(tops.cwtm(x, trim, ident), tops.cwtm(x, trim))


def test_nnm_mix_plain_sums_in_table_order():
    """The plain mix adds the named rows in table order, then multiplies by
    1/k: the order the CUDA kernel repeats term for term."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(_stack(rng, 0, 5, 40))
    table = torch.tensor([[0, 2, 4], [1, 2, 3], [0, 1, 2], [2, 3, 4], [0, 3, 4]], dtype=torch.int32)
    got = tref.nnm_mix_ref(x, table)
    for n in range(5):
        a, b, c = (x[int(j)] for j in table[n])
        assert torch.equal(got[n], ((a + b) + c) * (1.0 / 3))


def test_cwtm_nnm_batched_equals_single_bitwise():
    rng = np.random.default_rng(12)
    x = torch.from_numpy(_stack(rng, 3, 8, 300))
    table = tagg.nnm_neighbours(tops.pairwise_sqdist(x), 2)
    _lanes_equal_single(lambda m, nb: tops.cwtm(m, 2, nb), x, table)


@pytest.mark.parametrize("table", [[[0, 1], [1, 3], [0, 2]], [[0, 1], [2, 1], [0, 2]], [[0, 0], [1, 2], [0, 2]]],
                         ids=["out-of-range", "descending", "repeated"])
def test_cwtm_rejects_a_bad_neighbour_table(table):
    with pytest.raises(IndexError):
        tops.cwtm(torch.randn(3, 16), 0, torch.tensor(table, dtype=torch.int32))


# ---------------------------------------------------------------- tile plans

# N from 1 to 4,096 (the large-N path of the encode from about N = 1,400 at
# d = 10) and Q from 1 to 2^31 + 37 (smollm-360m's width, ragged Qs)
PLAN_N = [1, 2, 3, 8, 13, 41, 100, 101, 128, 129, 1024, 1383, 1384, 2048, 4096]
PLAN_Q = [1, 3, 31, 32, 33, 64, 100, 101, 1000, 4097, (1 << 20) + 37, 361_821_120, (1 << 31) + 37]
PLAN_LANES = [1, 3, 131, 1000]


def _gather_smem(n: int, d: int, cols: int) -> int:
    """Shared bytes of an encode block (csrc/gather_combine.cu): the tile,
    the ids and the weights."""
    return 4 * (n * cols + n * d + d)


def _attack_smem(n: int, cols: int) -> int:
    """Shared bytes of an ALIE/IPM block (csrc/attack.cu): the tile, the
    statistic, the weights and, above 16 rows, the tree's P / 2 levels of
    cols + 1."""
    half = 0 if n <= 16 else (1 << (n - 1).bit_length()) // 2
    return 4 * (n * cols + cols + n + half * (cols + 1))


@pytest.mark.parametrize("kernel", ["gather_combine", "attack"])
@pytest.mark.parametrize("n", PLAN_N)
def test_tile_plan_covers_every_column_once_and_fits(kernel, n):
    """The tiles cover every column exactly once, fit in 227 KB, are whole
    rows or 16-byte multiples, fill the 132 SMs where Q allows, and the
    encode takes its large-N path exactly where a 32-column tile does not
    fit (the attack: where one column does not)."""
    from repro_torch.kernels import attacks as tattacks
    from repro_torch.kernels import coded_combine as tcc
    from repro_torch.kernels import tiles

    d = min(n, 10)
    if kernel == "gather_combine":
        plan, smem, least = (lambda lanes, q: tcc.gather_tile(lanes, n, q, d)), (lambda c: _gather_smem(n, d, c)), 32
    else:
        plan, smem, least = (lambda lanes, q: tattacks.attack_tile(lanes, n, q)), (lambda c: _attack_smem(n, c)), 1
    for q in PLAN_Q:
        for lanes in PLAN_LANES:
            cols = plan(lanes, q)
            if cols == 0:
                assert smem(least) > tiles.SMEM_MAX, (q, lanes)
                continue
            assert smem(least) <= tiles.SMEM_MAX and smem(cols) <= tiles.SMEM_MAX, (q, lanes, cols)
            count = -(-q // cols)
            assert (count - 1) * cols < q <= count * cols, (q, lanes, cols)
            assert cols == q or cols % 4 == 0 or smem(4) > tiles.SMEM_MAX, (q, lanes, cols)
            assert lanes * count >= tiles.SMS or cols <= tiles.FILL_COLUMNS or cols == q, (q, lanes, cols)
            if lanes * n * q * 4 <= 80e9:  # a stack the card holds: its grid's x dimension takes the tiles
                assert (lanes if kernel == "gather_combine" else 1) * count < 2**31, (q, lanes, cols)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 20, 100, 128, 129])
def test_attack_tree_replayed_in_numpy_is_the_plain_version(n):
    """csrc/attack.cu's tree (level 1: term i plus term i + P/2, or plus
    +0.0 past N; then the upper half of each level onto its lower half; the
    term itself at N = 1), replayed in float32 numpy, equals
    ``numerics.tree_sum`` bit for bit, a -0.0 term and an all -0.0 column
    included, and so does the ALIE vector it builds (its square root taken
    by ``torch.sqrt`` on the CPU, as the plain version takes it there: it is
    not always numpy's correctly rounded one)."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 64)).astype(np.float32)
    x[:, 0] = -0.0
    x[n // 2, 1] = -0.0
    hw = (rng.random(n) < 0.7).astype(np.float32)

    def tree(terms):
        half = (1 << (n - 1).bit_length()) // 2
        if half == 0:
            return terms[0].copy()
        acc = np.stack([terms[i] + (terms[i + half] if i + half < n else np.float32(0.0))
                        for i in range(half)])
        while half > 1:
            half //= 2
            acc = acc[:half] + acc[half:2 * half]
        return acc[0]

    count = tree(hw[:, None])[0]
    h = np.float32(max(count, np.float32(1.0)))
    mu = tree(x * hw[:, None]) / h
    dev = x - mu
    var = tree(dev * dev * hw[:, None]) / h
    adv = mu - np.float32(1.5) * torch.sqrt(torch.from_numpy(var + np.float32(1e-12))).numpy()
    mask = 1.0 - hw
    want = tref.attack_ref(torch.from_numpy(x), torch.from_numpy(mask), "alie", 1.5)
    got = np.where(mask[:, None] > 0, adv[None, :], x)
    assert np.array_equal(got.view(np.int32), want.numpy().view(np.int32))
    t = tree_sum(torch.from_numpy(x), dim=0).numpy()
    assert np.array_equal(tree(x).view(np.int32), t.view(np.int32))
