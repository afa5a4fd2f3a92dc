"""The port's round primitives and ``protocol_round`` against the JAX
reference, on the CPU, with the reference's own random draws replayed.

The port draws nothing inside a round: its randomness comes in as a
``RoundRandomness`` record. Here that record is computed in JAX with the
reference's split of the round key (``core/byzantine.py::protocol_round``):
``k_assign, k_mask, k_attack, k_comp = split(key, 4)``, the assignment from
``sample_assignment(k_assign, N, d)``, the mask from
``sample_byzantine_mask(k_mask, ...)``, device ``i``'s kept coordinates
from ``permutation(split(k_comp, N)[i], Q)[:q_hat]``, device ``i``'s QSGD
rounding draws from ``uniform(split(k_comp, N)[i], (Q,))`` and the
participation draws from ``uniform(fold_in(key, PARTICIPATION_KEY_SALT),
(N,))``. Under ``method="draco"`` the subset permutation is
``permutation(k_assign, N)`` (``task_index`` is ``arange(N)``, which DRACO
does not read); under the ``gaussian`` attack the noise is
``normal(k_attack, (N, Q))``. With ``jax_threefry_partitionable`` on, the reference's XLA
quantizer's padded draw ``uniform(k_i, (chunks, chunk))`` begins with the
same Q values, so one record replays both of its paths.

ALIE and IPM are held against ``repro.kernels.ref.attack_ref`` and against
``protocol_round`` with ``backend="xla"``, not against the reference's
``backend="interpret"`` routing: there ``core/attacks.py::make_attack``
sends only sign-flip through the Pallas kernel and keeps ALIE/IPM in plain
XLA (core/attacks.py:149-151), an artifact of the CPU interpret mode. The
port sends all three through its kernel wherever it runs, so the XLA forms
are the reference for what the attacks compute.

Tolerance: rtol 1e-5, atol 1e-6 per op and per round (as
tests/test_kernels.py): the port sums in other orders than XLA (the encode
as sum_j w_j g_j rather than a mean, NNM's mix as a matrix product).
``median`` is held to ``jnp.median`` bit for bit. Krum and multi-Krum are
held to a numpy oracle that excludes each message's own distance, not to
the reference, whose scores are all NaN (ROADMAP C.1, pinned below).

QSGD in a round: the port's encode and the reference's differ by an ulp or
two, so ``y = g / scale * levels`` differs by a few ulps of ``levels``, and
where a draw ``u`` lies that close to ``y - floor(y)`` the two sides round
to different levels, a whole ``scale / levels`` apart: a flip, not a fault.
Each quant case therefore first asserts that the two sides' y agree within
``levels * 2^-20`` (8 ulps of ``levels``) and that every draw lies more
than twice that from the reference's remainder (measured around the circle,
so a y next to an integer counts too); then the rounding is the same on
both sides and the round is held to the tolerance above. The seeds were
chosen so that the margin holds.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.core import attacks as jatt
from repro.core import byzantine as jbyz
from repro.core import coding as jcoding
from repro.core import compression as jcomp
from repro.core import participation as jpart
from repro.core import task_matrix as jtm
from repro.kernels import ref as jref
from repro_torch.core import aggregators as tagg
from repro_torch.core import attacks as tatt
from repro_torch.core import byzantine as tbyz
from repro_torch.core import coding as tcoding
from repro_torch.core import compression as tcomp
from repro_torch.core import participation as tpart
from repro_torch.core import task_matrix as ttm
from repro_torch.kernels import ops as tops

RTOL, ATOL = 1e-5, 1e-6
N, Q = 100, 100


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def jax_round_randomness(cfg: jbyz.ProtocolConfig, key, q: int) -> tbyz.RoundRandomness:
    """The reference's draws for one round, as the port's record."""
    n = cfg.n_devices
    k_assign, k_mask, k_attack, k_comp = jax.random.split(key, 4)
    if cfg.method == "draco":
        task_index, subset_perm = jnp.arange(n), jax.random.permutation(k_assign, n)
    else:
        ta = jtm.sample_assignment(k_assign, n, cfg.effective_d())
        task_index, subset_perm = ta.task_index, ta.subset_perm
    mask = jatt.sample_byzantine_mask(k_mask, n, cfg.n_byz, fixed=cfg.attack.fixed_identity)
    spec = cfg.compression
    keep = None
    if spec.name == "rand_sparse":
        q_hat = spec.kept(q)
        keep = jax.vmap(lambda k: jax.random.permutation(k, q)[:q_hat])(jax.random.split(k_comp, n))
    elif spec.name == "rand_sparse_shared":
        keep = jnp.broadcast_to(jax.random.permutation(k_comp, q)[: spec.kept(q)], (n, spec.kept(q)))
    quant_u = None
    if spec.name == "quant":
        quant_u = jax.vmap(lambda k: jax.random.uniform(k, (q,)))(jax.random.split(k_comp, n))
    part_u = None
    if cfg.participation.active:
        part_u = jax.random.uniform(jax.random.fold_in(key, jpart.PARTICIPATION_KEY_SALT), (n,))
    noise = None
    if cfg.attack.name == "gaussian":
        noise = jax.random.normal(k_attack, (n, q), dtype=jnp.float32)
    return tbyz.RoundRandomness(
        task_index=_t(task_index),
        subset_perm=_t(subset_perm),
        byz_mask=_t(mask),
        keep_idx=None if keep is None else _t(keep),
        quant_u=None if quant_u is None else _t(quant_u),
        part_u=None if part_u is None else _t(part_u),
        attack_noise=None if noise is None else _t(noise),
    )


def _msgs(seed, n=N, q=Q, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((n, q)) * scale).astype(np.float32)


def _quant_y(coded: np.ndarray, spec) -> np.ndarray:
    """``g / scale * levels`` of QSGD on (N, Q) rows, per block of
    ``min(chunk, Q)`` (the ragged last block zero-padded)."""
    q = coded.shape[-1]
    block = min(spec.chunk, q)
    padded = np.pad(coded, ((0, 0), (0, (-q) % block))).reshape(coded.shape[0], -1, block)
    scale = np.abs(padded).max(-1, keepdims=True)
    return (padded / np.where(scale > 0, scale, 1.0) * spec.levels).reshape(coded.shape[0], -1)[:, :q]


def flip_margin(y: np.ndarray, quant_u) -> float:
    """The least distance, around the unit circle, between a draw and the
    remainder ``y - floor(y)`` it is compared with."""
    gap = np.abs(np.asarray(quant_u) - (y - np.floor(y)))
    return float(np.minimum(gap, 1.0 - gap).min())


def assert_no_level_flip(ref_coded, port_coded, quant_u, spec):
    """The reference's and the port's pre-quantization rows round to the
    same levels (see the module docstring)."""
    y_ref, y_port = _quant_y(np.asarray(ref_coded), spec), _quant_y(np.asarray(port_coded), spec)
    bound = spec.levels * 2.0**-20
    assert np.max(np.abs(y_ref - y_port)) <= bound
    margin = flip_margin(y_ref, quant_u)
    assert margin > 2 * bound, f"a draw lies {margin:.2e} from its remainder: pick another seed"


# ------------------------------------------------------------------ task matrix


@pytest.mark.parametrize("n,d", [(10, 1), (10, 3), (100, 10), (7, 7)])
def test_cyclic_task_matrix_matches(n, d):
    np.testing.assert_array_equal(ttm.cyclic_task_matrix(n, d), jtm.cyclic_task_matrix(n, d))


@pytest.mark.parametrize("n,d", [(100, 1), (100, 10), (12, 5)])
def test_assignment_from_reference_draws(n, d):
    ta = jtm.sample_assignment(jax.random.PRNGKey(n + d), n, d)
    got = ttm.assignment_from(_t(ta.task_index), _t(ta.subset_perm), d)
    np.testing.assert_array_equal(got.subsets.numpy(), np.asarray(ta.subsets))
    # every subset is computed by exactly d devices (column-balanced)
    counts = np.bincount(got.subsets.numpy().ravel(), minlength=n)
    assert (counts == d).all()


# ---------------------------------------------------------------------- attacks


@pytest.mark.parametrize("name", ["none", "zero", "label_shift", "sign_flip", "alie", "ipm"])
def test_attacks_match(name):
    msgs = _msgs(1)
    mask = np.asarray(jatt.sample_byzantine_mask(jax.random.PRNGKey(0), N, 20, fixed=False))
    spec_kw = dict(name=name, n_byz=20)
    want = jatt.make_attack(jatt.AttackSpec(**spec_kw))(None, jnp.asarray(msgs), jnp.asarray(mask))
    got = tatt.make_attack(tatt.AttackSpec(**spec_kw))(_t(msgs), _t(mask))
    _close(got, want)


@pytest.mark.parametrize("name,param", [("alie", 1.5), ("ipm", 0.5)])
def test_collusion_attacks_match_reference_oracle(name, param):
    msgs = _msgs(2)
    mask = (np.arange(N) < 20).astype(np.float32)
    got = tatt.make_attack(tatt.AttackSpec(name=name))(_t(msgs), _t(mask))
    _close(got, jref.attack_ref(jnp.asarray(msgs), jnp.asarray(mask), name, param))


@pytest.mark.parametrize("fixed", [True, False])
def test_gaussian_attack_matches_under_replayed_noise(fixed):
    """Byzantine rows ``std * normal(key, (N, Q))``, honest rows untouched:
    bit for bit with the reference's noise handed in."""
    msgs = _msgs(6)
    key = jax.random.PRNGKey(11)
    mask = np.asarray(jatt.sample_byzantine_mask(jax.random.PRNGKey(1), N, 20, fixed=fixed))
    spec = dict(name="gaussian", n_byz=20, std=7.0)
    want = jatt.make_attack(jatt.AttackSpec(**spec))(key, jnp.asarray(msgs), jnp.asarray(mask))
    noise = _t(jax.random.normal(key, (N, Q), dtype=jnp.float32))
    got = tatt.make_attack(tatt.AttackSpec(**spec))(_t(msgs), _t(mask), noise)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="noise"):
        tatt.make_attack(tatt.AttackSpec(**spec))(_t(msgs), _t(mask))


@pytest.mark.parametrize("n,n_byz", [(100, 0), (100, 20), (8, 2)])
def test_fixed_byzantine_mask_matches(n, n_byz):
    want = jatt.sample_byzantine_mask(jax.random.PRNGKey(0), n, n_byz, fixed=True)
    np.testing.assert_array_equal(tatt.sample_byzantine_mask(n, n_byz).numpy(), np.asarray(want))


# ------------------------------------------------------------------ aggregators


@pytest.mark.parametrize("name", ["mean", "cwtm", "cwtm-nnm", "tgn", "mean-nnm"])
def test_aggregators_match(name):
    msgs = _msgs(3)
    msgs[:20] *= -2.0  # a sign-flipped Byzantine block
    want = jagg.make_aggregator(name, n_byz=20, trim_frac=0.1)(jnp.asarray(msgs))
    got = tagg.make_aggregator(name, n_byz=20, trim_frac=0.1)(_t(msgs))
    _close(got, want)


def test_every_reference_aggregator_is_ported():
    assert sorted(tagg.AGGREGATORS) == sorted(jagg.AGGREGATORS)


@pytest.mark.parametrize("n,ties", [(7, False), (8, False), (41, False), (100, False), (8, True)])
def test_median_is_bitwise_jnp_median(n, ties):
    """The CWTM kernel's plain version at trim (N - 1) // 2 is
    ``jnp.median``: the middle value, or ``(lo + hi) * 0.5``."""
    msgs = _msgs(n, n=n, q=257)
    if ties:
        msgs = np.round(msgs)  # many equal values per coordinate
    got = tagg.make_aggregator("median")(_t(msgs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.median(jnp.asarray(msgs), axis=0)))


# (aggregator, N, n_byz): the trainer's N = 100 and the wide round's N = 8
ITERATIVE = [(name, n, b) for name in ("geomed", "mcc") for n, b in ((100, 20), (8, 2), (9, 2))]


@pytest.mark.parametrize("name,n,n_byz", ITERATIVE, ids=[f"{c[0]}-N{c[1]}" for c in ITERATIVE])
def test_geomed_and_mcc_match_reference(name, n, n_byz):
    """Weiszfeld (8 steps) and MCC (4 reweightings from the median) on a
    stack with a sign-flipped Byzantine block, within rtol 1e-5, atol 1e-6:
    the iterations do not amplify the different summation orders."""
    msgs = _msgs(30 + n, n=n, q=300)
    msgs[:n_byz] *= -2.0
    want = jagg.make_aggregator(name, n_byz=n_byz)(jnp.asarray(msgs))
    got = tagg.make_aggregator(name, n_byz=n_byz)(_t(msgs))
    _close(got, want)


def _krum_oracle(msgs: np.ndarray, n_byz: int, multi: bool) -> np.ndarray:
    """Krum in float64 numpy: each row's summed squared distance to its
    N - b - 2 nearest other rows; Krum takes the first least score,
    multi-Krum the mean of the N - b least (ties to the lower index)."""
    x = msgs.astype(np.float64)
    n = x.shape[0]
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    d2[np.arange(n), np.arange(n)] = np.inf
    scores = np.sort(d2, axis=1)[:, : max(n - n_byz - 2, 1)].sum(1)
    if not multi:
        return msgs[int(np.argmin(scores))]
    return msgs[np.argsort(scores, kind="stable")[: n - n_byz]].astype(np.float64).mean(0)


KRUM_CASES = [(name, n, b) for name in ("krum", "multi_krum") for n, b in ((100, 20), (8, 2), (12, 3))]


@pytest.mark.parametrize("name,n,n_byz", KRUM_CASES, ids=[f"{c[0]}-N{c[1]}" for c in KRUM_CASES])
def test_krum_rules_match_numpy_oracle(name, n, n_byz):
    msgs = _msgs(50 + n, n=n, q=200)
    msgs[:n_byz] = msgs[:n_byz] * -2.0 + 5.0  # a Byzantine block away from the rest
    got = tagg.make_aggregator(name, n_byz=n_byz)(_t(msgs))
    _close(got, _krum_oracle(msgs, n_byz, multi=name == "multi_krum"))
    if name == "krum":  # Krum returns one of the messages, bit for bit
        assert any(np.array_equal(got.numpy(), row) for row in msgs[n_byz:])


def test_reference_krum_is_nan_poisoned():
    """ROADMAP C.1: the reference adds ``eye * inf``, whose off-diagonal
    ``0 * inf`` is NaN, so every score is NaN and ``krum`` returns row 0
    (a Byzantine row under fixed identities). The port's scores are finite
    and its Krum avoids the Byzantine row."""
    msgs = _msgs(60, n=10, q=6)
    msgs[0] += 100.0
    assert np.isnan(np.asarray(jagg._krum_scores(jnp.asarray(msgs), 2))).all()
    np.testing.assert_array_equal(np.asarray(jagg.krum(jnp.asarray(msgs), 2)), msgs[0])
    assert bool(torch.isfinite(tagg.krum_scores(_t(msgs), 2)).all())
    got = tagg.krum(_t(msgs), 2)
    assert not np.array_equal(got.numpy(), msgs[0])
    np.testing.assert_array_equal(got.numpy(), _krum_oracle(msgs, 2, multi=False))


def test_multi_krum_ties_go_to_the_lower_index():
    msgs = np.zeros((6, 3), np.float32)
    msgs[:, 0] = [0.0, 1.0, 0.0, 1.0, 0.0, 9.0]  # rows 0, 2, 4 tie, as do rows 1, 3
    got = tagg.multi_krum(_t(msgs), n_byz=2)  # keeps 4 of 6
    np.testing.assert_array_equal(got.numpy(), _krum_oracle(msgs, 2, multi=True).astype(np.float32))


def test_nnm_tie_order_is_lower_index():
    """Equal distances: the port picks the lower index, as jax.lax.top_k
    does in the reference (torch.topk promises no order)."""
    msgs = np.zeros((5, 6), np.float32)
    for i in range(1, 5):
        msgs[i, i] = 1.0  # rows 1..4 all at distance 1 from row 0
    got = tagg.nnm_mix(_t(msgs), n_byz=2)  # k = 3 neighbours
    _close(got, jagg.nnm_mix(jnp.asarray(msgs), 2))
    np.testing.assert_array_equal(got[0].numpy(), msgs[[0, 1, 2]].mean(0))


# (N, Q, n_byz, trim_frac): the wide round's N = 8 (ragged Q) and the trainer's N = 100
CWTM_NNM_SERVERS = [(8, 1000 + 37, 2, 0.25), (8, 257, 2, 0.125), (100, 100, 20, 0.1)]


@pytest.mark.parametrize("n,q,n_byz,trim_frac", CWTM_NNM_SERVERS,
                         ids=[f"N{c[0]}-Q{c[1]}-b{c[2]}" for c in CWTM_NNM_SERVERS])
def test_cwtm_nnm_server_is_cwtm_of_the_mix(n, q, n_byz, trim_frac):
    """make_aggregator("cwtm-nnm") is the fused launch; it equals the CWTM
    of the mixed stack bitwise and the reference's nnm_then(cwtm) within
    rtol 1e-5, atol 1e-6 times the inputs' scale."""
    rng = np.random.default_rng(n + q)
    msgs = (rng.standard_normal((n, q)) * 3.0).astype(np.float32)
    msgs[:n_byz] *= -2.0  # a sign-flipped Byzantine block
    fused = tagg.make_aggregator("cwtm-nnm", n_byz=n_byz, trim_frac=trim_frac)(_t(msgs))
    assert torch.equal(fused, tagg.make_aggregator("cwtm", nnm=True, n_byz=n_byz, trim_frac=trim_frac)(_t(msgs)))
    assert torch.equal(fused, tagg.cwtm(tagg.nnm_mix(_t(msgs), n_byz), trim_frac))
    want = jagg.make_aggregator("cwtm-nnm", n_byz=n_byz, trim_frac=trim_frac)(jnp.asarray(msgs))
    _close(fused, want, atol=ATOL * 3.0)


@pytest.mark.parametrize("n,n_byz,ties", [(8, 2, False), (100, 20, False), (6, 2, True)])
def test_nnm_neighbours_are_the_reference_selection_in_ascending_order(n, n_byz, ties):
    """The neighbour table holds, for each row, the ids that the reference's
    top_k picks (ties to the lower index), sorted, as int32."""
    rng = np.random.default_rng(n)
    d2 = rng.random((n, n)).astype(np.float32)
    if ties:
        d2 = np.round(d2 * 2).astype(np.float32)  # many equal distances
    d2 = d2 + d2.T
    np.fill_diagonal(d2, 0.0)
    got = tagg.nnm_neighbours(_t(d2), n_byz)
    assert got.dtype == torch.int32 and got.shape == (n, n - n_byz)
    _, idx = jax.lax.top_k(-jnp.asarray(d2), n - n_byz)
    np.testing.assert_array_equal(got.numpy(), np.sort(np.asarray(idx), axis=-1))


def test_tgn_tie_order_is_lower_index():
    msgs = np.zeros((6, 4), np.float32)
    msgs[:, 0] = [1.0, -1.0, 1.0, -1.0, 1.0, 3.0]  # five rows of equal norm
    got = tagg.tgn(_t(msgs), thresh_frac=0.5)  # keeps the 3 smallest norms
    _close(got, jagg.tgn(jnp.asarray(msgs), thresh_frac=0.5))
    np.testing.assert_array_equal(got.numpy(), msgs[[0, 1, 2]].mean(0))


# ------------------------------------------------------------------ compression


@pytest.mark.parametrize("text", ["identity", "randk:8", "randk:0.3", "randk_shared:8",
                                  "quant:4", "quant:8:512", "topk:8"])
def test_compression_spec_spelling_matches(text):
    want = jcomp.CompressionSpec.parse(text)
    got = tcomp.CompressionSpec.parse(text)
    assert got.canonical() == want.canonical() == tcomp.CompressionSpec.parse(got.canonical()).canonical()
    assert got.kept(Q) == want.kept(Q)


@pytest.mark.parametrize("text", ["randk:0.3", "randk_shared:0.3", "quant:4", "quant:16", "quant:4:32",
                                  "quant:3:7", "topk:0.3", "topk:8"])
def test_compress_rows_matches(text):
    """Every compressor on the same rows under the reference's draws; QSGD
    bitwise (the rows are the same on both sides, so no level can flip)."""
    rows = _msgs(4)
    spec_j = jcomp.CompressionSpec.parse(text)
    cfg = jbyz.ProtocolConfig(n_devices=N, compression=spec_j)
    key = jax.random.PRNGKey(9)
    rand = jax_round_randomness(cfg, key, Q)
    k_comp = jax.random.split(key, 4)[3]
    want = jcomp.compress_rows(spec_j, k_comp, jnp.asarray(rows), n_total=N)
    got = tcomp.compress_rows(tcomp.CompressionSpec.parse(text), _t(rows), rand.keep_idx, rand.quant_u)
    if spec_j.name == "quant":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(got, want)


def test_top_k_ties_go_to_the_lower_index():
    rows = np.array([[1.0, -3.0, 3.0, 2.0, -3.0, 0.5]], np.float32)
    got = tcomp.top_k(_t(rows), 2)
    _close(got, jcomp.top_k(None, jnp.asarray(rows[0]), 2)[None])
    np.testing.assert_array_equal(got.numpy(), [[0.0, -3.0, 3.0, 0.0, 0.0, 0.0]])


@pytest.mark.parametrize("text", ["identity", "randk:0.3", "randk_shared:8", "quant:4", "quant:16:100",
                                  "topk:8"])
@pytest.mark.parametrize("q", [100, 361_821_120])
def test_delta_and_wire_bits_match(text, q):
    spec_j, spec_t = jcomp.CompressionSpec.parse(text), tcomp.CompressionSpec.parse(text)
    assert tcomp.delta_of(spec_t, q) == jcomp.delta_of(spec_j, q)
    assert tcomp.wire_bits(spec_t, q) == jcomp.wire_bits(spec_j, q)


# --------------------------------------------------------------- protocol round


def _configs(method, d, agg, attack, comp, part=None):
    kw = dict(n_devices=N, d=d, method=method, aggregator=agg, trim_frac=0.1, n_byz=20)
    part = part or {}
    jcfg = jbyz.ProtocolConfig(**kw, attack=jatt.AttackSpec(attack, n_byz=20),
                               compression=jcomp.spec_from(comp),
                               participation=jpart.ParticipationSpec(**part), backend="xla")
    tcfg = tbyz.ProtocolConfig(**kw, attack=tatt.AttackSpec(attack, n_byz=20),
                               compression=tcomp.spec_from(comp),
                               participation=tpart.ParticipationSpec(**part))
    return jcfg, tcfg


ROUND_CASES = [
    (method, d, agg, attack, comp)
    for method, d in (("plain", 1), ("lad", 10))
    for agg in ("mean", "cwtm", "cwtm-nnm")
    for attack in ("sign_flip", "alie", "ipm")
    for comp in ("none", "rand_sparse")
] + [("lad", 3, "tgn", "sign_flip", "rand_sparse")]  # Com-TGN's server under Com-LAD


@pytest.mark.parametrize("method,d,agg,attack,comp", ROUND_CASES,
                         ids=["-".join(map(str, c)) for c in ROUND_CASES])
def test_protocol_round_matches_reference(method, d, agg, attack, comp):
    jcfg, tcfg = _configs(method, d, agg, attack, comp)
    grads = _msgs(ROUND_CASES.index((method, d, agg, attack, comp)), scale=2.0)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    want = jbyz.protocol_round(jcfg, key, jnp.asarray(grads))
    got = tbyz.protocol_round(tcfg, _t(grads), jax_round_randomness(jcfg, key, Q), device="cpu")
    _close(got, want)


def test_protocol_round_needs_a_device_or_cuda():
    _, tcfg = _configs("lad", 10, "cwtm", "sign_flip", "none")
    rand = jax_round_randomness(_configs("lad", 10, "cwtm", "sign_flip", "none")[0],
                                jax.random.PRNGKey(0), Q)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        tbyz.protocol_round(tcfg, torch.zeros(N, Q), rand)


_IID = dict(name="iid", rate=0.25)
_ADV = dict(name="adversarial", n_drop=9, offset=20)  # the whole margin d - 1 at d = 10
_ADV_BEYOND = dict(name="adversarial", n_drop=15, offset=20)
# (method, d, aggregator, attack, compressor, participation, key seed)
MASKED_CASES = [
    ("lad", 10, "cwtm", "sign_flip", "quant:4", None, 4),
    ("lad", 10, "cwtm-nnm", "alie", "quant:16", None, 4),
    ("plain", 1, "mean", "ipm", "quant:4:32", None, 3),
    ("lad", 10, "cwtm", "sign_flip", "topk:0.3", None, 3),
    ("plain", 1, "cwtm-nnm", "alie", "topk:8", None, 3),
] + [
    ("lad", 10, agg, "sign_flip", "none", part, 3)
    for part in (_IID, _ADV) for agg in ("decode", "mean", "cwtm")
] + [
    ("lad", 10, "decode", "alie", "none", _ADV_BEYOND, 3),
    ("lad", 10, "cwtm-nnm", "ipm", "none", dict(name="iid", rate=0.0), 3),
    ("lad", 10, "decode", "sign_flip", "quant:4", _IID, 3),
    ("lad", 5, "cwtm", "alie", "quant:4", _ADV, 3),
    # DRACO's masked decode: partial groups, an empty group (rows 20-29), all reporting
    ("draco", 4, "mean", "sign_flip", "none", _IID, 3),
    ("draco", 10, "mean", "alie", "none", dict(name="adversarial", n_drop=10, offset=20), 3),
    ("draco", 10, "mean", "gaussian", "none", dict(name="iid", rate=0.0), 3),
]
MASKED_IDS = ["-".join(map(str, c[:5])) + ("" if c[5] is None else f"-{c[5]['name']}{c[5].get('n_drop', '')}")
              for c in MASKED_CASES]


@pytest.mark.parametrize("method,d,agg,attack,comp,part,seed", MASKED_CASES, ids=MASKED_IDS)
def test_protocol_round_with_compression_and_participation_matches(method, d, agg, attack, comp, part, seed):
    """quant / top_k compression and the masked servers (erasure decode,
    impute-then-aggregate) against the reference's XLA round, the
    participation mask drawn by each side's own schedule from the replayed
    uniforms."""
    jcfg, tcfg = _configs(method, d, agg, attack, comp, part)
    grads = _msgs(100 + MASKED_CASES.index((method, d, agg, attack, comp, part, seed)), scale=2.0)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    rand = jax_round_randomness(jcfg, key, Q)
    pm_j = pm_t = None
    if part is not None:
        pm_j, _ = jpart.sample_participation(jcfg.participation, jax.random.fold_in(key, jpart.PARTICIPATION_KEY_SALT),
                                             0, N, jnp.ones((N,), jnp.float32))
        pm_t, _ = tpart.sample_participation(tcfg.participation, rand.part_u, 0, N, torch.ones(N))
        np.testing.assert_array_equal(pm_t.numpy(), np.asarray(pm_j))
    if jcfg.compression.name == "quant":
        subsets = ttm.assignment_from(rand.task_index, rand.subset_perm, tcfg.effective_d()).subsets
        ref_coded = jnp.mean(jnp.asarray(grads)[jnp.asarray(subsets.numpy())], axis=1)
        port_coded = tops.gather_combine(_t(grads), subsets, torch.full((tcfg.effective_d(),), 1.0 / tcfg.effective_d()))
        assert_no_level_flip(ref_coded, port_coded.numpy(), rand.quant_u.numpy(), jcfg.compression)
    want = jbyz.protocol_round(jcfg, key, jnp.asarray(grads), participation_mask=pm_j)
    got = tbyz.protocol_round(tcfg, _t(grads), rand, device="cpu", participation_mask=pm_t)
    _close(got, want)


# (method, d, aggregator, attack, compressor, server oracle): the new rules
# in a round; Krum's rounds hold the port to the reference's round with the
# numpy Krum as its server (the reference's own Krum is NaN-poisoned)
RULE_CASES = [
    ("draco", 4, "mean", "sign_flip", "none", None),
    ("draco", 4, "mean", "alie", "none", None),
    ("draco", 10, "mean", "gaussian", "none", None),
    ("draco", 10, "mean", "ipm", "none", None),
    ("lad", 10, "median", "alie", "none", None),
    ("lad", 10, "geomed", "gaussian", "none", None),
    ("plain", 1, "mcc", "alie", "rand_sparse", None),
    ("lad", 10, "cwtm", "gaussian", "none", None),
    ("lad", 10, "krum", "sign_flip", "none", "krum"),
    ("lad", 10, "multi_krum", "ipm", "none", "multi_krum"),
]


@pytest.mark.parametrize("method,d,agg,attack,comp,oracle", RULE_CASES,
                         ids=["-".join(map(str, c[:5])) for c in RULE_CASES])
def test_protocol_round_with_draco_and_new_rules_matches(method, d, agg, attack, comp, oracle):
    jcfg, tcfg = _configs(method, d, agg, attack, comp)
    grads = _msgs(200 + RULE_CASES.index((method, d, agg, attack, comp, oracle)), scale=2.0)
    key = jax.random.fold_in(jax.random.PRNGKey(1), 5)
    server = None
    if oracle is not None:
        server = lambda t: jnp.asarray(_krum_oracle(np.asarray(t), 20, multi=oracle == "multi_krum"),
                                       jnp.float32)
    want = jbyz.protocol_round(jcfg, key, jnp.asarray(grads), server_fn=server)
    got = tbyz.protocol_round(tcfg, _t(grads), jax_round_randomness(jcfg, key, Q), device="cpu")
    _close(got, want)


# (N, d, n_byz rows, mask or None): the unmasked decode, partial groups, an empty group
DRACO_DECODES = [
    (82, 41, 20, None), (100, 4, 20, None), (12, 3, 3, None), (100, 10, 20, None),
    (12, 4, 3, [1, 1, 0, 1, 1, 0, 0, 1, 1, 1, 1, 1]),  # groups of 3, 2 and 4 reporting
    (12, 3, 0, [1, 1, 1, 0, 0, 0, 1, 0, 1, 1, 1, 1]),  # group 1 empty
    (82, 41, 20, [1] * 41 + [1, 0] * 20 + [1]),  # 41 and 21 reporting
]


@pytest.mark.parametrize("n,d,n_byz,mask", DRACO_DECODES,
                         ids=[f"N{c[0]}-d{c[1]}-{'full' if c[3] is None else 'masked'}-{i}"
                              for i, c in enumerate(DRACO_DECODES)])
def test_draco_decode_matches_reference(n, d, n_byz, mask):
    """Replicated groups with a sign-flipped Byzantine block; erased rows
    are zero, as the round leaves them."""
    rng = np.random.default_rng(n + d)
    blocks = rng.standard_normal((n // d, 1, 64)).astype(np.float32)
    msgs = np.broadcast_to(blocks, (n // d, d, 64)).reshape(n, 64).copy()
    msgs[:n_byz] *= -2.0
    pm = None
    if mask is not None:
        pm = np.asarray(mask, np.float32)
        msgs = msgs * pm[:, None]
    want = jcoding.draco_decode(jnp.asarray(msgs), d, mask=None if pm is None else jnp.asarray(pm))
    got = tcoding.draco_decode(_t(msgs), d, mask=None if pm is None else _t(pm))
    _close(got, want)


@pytest.mark.parametrize("n,d", [(82, 41), (100, 4)])
def test_draco_masked_decode_at_all_ones_is_the_unmasked_decode(n, d):
    msgs = _msgs(n + d, n=n, q=77)
    full = tcoding.draco_decode(_t(msgs), d)
    assert torch.equal(tcoding.draco_decode(_t(msgs), d, mask=torch.ones(n)), full)


@pytest.mark.parametrize("case", ["decode-at-full", "decode-d-not-dividing-n", "mask-at-full", "draco-decode"])
def test_masked_server_refusals_match_reference(case):
    """The reference's three ValueErrors of make_server_fn (the erasure
    decode at full participation, without d | N, and under DRACO), and a
    mask handed to a full-participation round."""
    if case == "mask-at-full":
        jcfg, tcfg = _configs("lad", 10, "cwtm", "sign_flip", "none")
        rand = jax_round_randomness(jcfg, jax.random.PRNGKey(0), Q)
        with pytest.raises(ValueError):
            tbyz.protocol_round(tcfg, torch.zeros(N, Q), rand, device="cpu", participation_mask=torch.ones(N))
        return
    part = None if case == "decode-at-full" else _IID
    method, d = ("draco", 4) if case == "draco-decode" else ("lad", 10 if part is None else 3)
    jcfg, tcfg = _configs(method, d, "decode", "sign_flip", "none", part)
    with pytest.raises(ValueError):
        jbyz.make_server_fn(jcfg)
    with pytest.raises(ValueError):
        tbyz.make_server_fn(tcfg)


def test_stage_hook_sees_every_stage():
    _, tcfg = _configs("lad", 10, "cwtm-nnm", "alie", "rand_sparse")
    gen = torch.Generator().manual_seed(0)
    rand = tbyz.sample_round_randomness(tcfg, Q, gen)
    stages = []
    tbyz.protocol_round(tcfg, torch.from_numpy(_msgs(5)), rand, device="cpu",
                        stage_hook=stages.append)
    assert stages == ["encode", "compress", "attack", "server"]


@pytest.mark.parametrize("comp,fixed", [("rand_sparse", True), ("rand_sparse_shared", False), ("none", True)])
def test_production_draws_are_valid(comp, fixed):
    """The torch provider's records: two permutations of N, exactly n_byz
    Byzantine devices, q_hat distinct kept coordinates per device (one set
    shared by all devices under rand_sparse_shared)."""
    tcfg = tbyz.ProtocolConfig(n_devices=N, d=10, n_byz=20,
                               attack=tatt.AttackSpec("sign_flip", fixed_identity=fixed),
                               compression=tcomp.CompressionSpec(name=comp))
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):
        rand = tbyz.sample_round_randomness(tcfg, Q, gen)
        for perm in (rand.task_index, rand.subset_perm):
            assert torch.equal(torch.sort(perm).values, torch.arange(N))
        assert int(rand.byz_mask.sum()) == 20
        assert fixed == bool(rand.byz_mask[:20].all())
        if comp == "none":
            assert rand.keep_idx is None
            continue
        assert rand.keep_idx.shape == (N, 30)
        assert all(len(set(row.tolist())) == 30 for row in rand.keep_idx)
        assert 0 <= int(rand.keep_idx.min()) and int(rand.keep_idx.max()) < Q
        if comp == "rand_sparse_shared":
            assert (rand.keep_idx == rand.keep_idx[0]).all()


def test_draco_and_gaussian_draws_are_valid():
    """DRACO's record: ``task_index`` is ``arange(N)``, ``subset_perm`` a
    permutation whose blocks of d the groups share; the gaussian attack's
    noise is (N, Q) float32 and replaces exactly the Byzantine rows."""
    tcfg = tbyz.ProtocolConfig(n_devices=N, d=4, method="draco", n_byz=20,
                               attack=tatt.AttackSpec("gaussian", fixed_identity=False))
    gen = torch.Generator().manual_seed(4)
    rand = tbyz.sample_round_randomness(tcfg, Q, gen)
    rand.validate(N, Q)
    assert torch.equal(rand.task_index, torch.arange(N))
    assert torch.equal(torch.sort(rand.subset_perm).values, torch.arange(N))
    assert rand.attack_noise.shape == (N, Q) and rand.attack_noise.dtype == torch.float32
    subsets = ttm.fractional_repetition(rand.subset_perm, 4).subsets
    assert torch.equal(subsets[0::4], subsets[3::4])
    assert torch.equal(torch.sort(subsets[::4].reshape(-1)).values, torch.arange(N))
    grads = torch.from_numpy(_msgs(7))
    out = tbyz.make_attack_fn(tcfg)(grads, rand.byz_mask, rand.attack_noise)
    byz = rand.byz_mask > 0
    assert torch.equal(out[~byz], grads[~byz])
    assert torch.equal(out[byz], 10.0 * rand.attack_noise[byz])
