"""The port's round primitives and ``protocol_round`` against the JAX
reference, on the CPU, with the reference's own random draws replayed.

The port draws nothing inside a round: its randomness comes in as a
``RoundRandomness`` record. Here that record is computed in JAX with the
reference's split of the round key (``core/byzantine.py::protocol_round``):
``k_assign, k_mask, k_attack, k_comp = split(key, 4)``, the assignment from
``sample_assignment(k_assign, N, d)``, the mask from
``sample_byzantine_mask(k_mask, ...)`` and device ``i``'s kept coordinates
from ``permutation(split(k_comp, N)[i], Q)[:q_hat]``.

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
from repro.core import compression as jcomp
from repro.core import task_matrix as jtm
from repro.kernels import ref as jref
from repro_torch.core import aggregators as tagg
from repro_torch.core import attacks as tatt
from repro_torch.core import byzantine as tbyz
from repro_torch.core import compression as tcomp
from repro_torch.core import task_matrix as ttm

RTOL, ATOL = 1e-5, 1e-6
N, Q = 100, 100


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def jax_round_randomness(cfg: jbyz.ProtocolConfig, key, q: int) -> tbyz.RoundRandomness:
    """The reference's draws for one round, as the port's record."""
    n = cfg.n_devices
    k_assign, k_mask, _, k_comp = jax.random.split(key, 4)
    ta = jtm.sample_assignment(k_assign, n, cfg.effective_d())
    mask = jatt.sample_byzantine_mask(k_mask, n, cfg.n_byz, fixed=cfg.attack.fixed_identity)
    spec = cfg.compression
    keep = None
    if spec.name == "rand_sparse":
        q_hat = spec.kept(q)
        keep = jax.vmap(lambda k: jax.random.permutation(k, q)[:q_hat])(jax.random.split(k_comp, n))
    elif spec.name == "rand_sparse_shared":
        keep = jnp.broadcast_to(jax.random.permutation(k_comp, q)[: spec.kept(q)], (n, spec.kept(q)))
    return tbyz.RoundRandomness(
        task_index=_t(ta.task_index),
        subset_perm=_t(ta.subset_perm),
        byz_mask=_t(mask),
        keep_idx=None if keep is None else _t(keep),
    )


def _msgs(seed, n=N, q=Q, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((n, q)) * scale).astype(np.float32)


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


def test_gaussian_attack_waits_for_later_slice():
    with pytest.raises(NotImplementedError):
        tatt.make_attack(tatt.AttackSpec(name="gaussian"))


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


@pytest.mark.parametrize("name", ["median", "geomed", "krum", "multi_krum", "mcc"])
def test_unported_aggregators_raise(name):
    with pytest.raises(NotImplementedError):
        tagg.make_aggregator(name)


def test_nnm_tie_order_is_lower_index():
    """Equal distances: the port picks the lower index, as jax.lax.top_k
    does in the reference (torch.topk promises no order)."""
    msgs = np.zeros((5, 6), np.float32)
    for i in range(1, 5):
        msgs[i, i] = 1.0  # rows 1..4 all at distance 1 from row 0
    got = tagg.nnm_mix(_t(msgs), n_byz=2)  # k = 3 neighbours
    _close(got, jagg.nnm_mix(jnp.asarray(msgs), 2))
    np.testing.assert_array_equal(got[0].numpy(), msgs[[0, 1, 2]].mean(0))


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


@pytest.mark.parametrize("name", ["rand_sparse", "rand_sparse_shared"])
def test_compress_rows_matches(name):
    rows = _msgs(4)
    spec_j = jcomp.CompressionSpec(name=name, q_hat_frac=0.3)
    cfg = jbyz.ProtocolConfig(n_devices=N, compression=spec_j)
    key = jax.random.PRNGKey(9)
    rand = jax_round_randomness(cfg, key, Q)
    k_comp = jax.random.split(key, 4)[3]
    want = jcomp.compress_rows(spec_j, k_comp, jnp.asarray(rows), n_total=N)
    got = tcomp.compress_rows(tcomp.CompressionSpec(name=name, q_hat_frac=0.3), _t(rows), rand.keep_idx)
    _close(got, want)


@pytest.mark.parametrize("name", ["quant", "top_k"])
def test_unported_compressors_raise(name):
    with pytest.raises(NotImplementedError):
        tcomp.compress_rows(tcomp.CompressionSpec(name=name), torch.zeros(4, 8), None)


# --------------------------------------------------------------- protocol round


def _configs(method, d, agg, attack, comp):
    kw = dict(n_devices=N, d=d, method=method, aggregator=agg, trim_frac=0.1, n_byz=20)
    jcfg = jbyz.ProtocolConfig(**kw, attack=jatt.AttackSpec(attack, n_byz=20),
                               compression=jcomp.CompressionSpec(name=comp), backend="xla")
    tcfg = tbyz.ProtocolConfig(**kw, attack=tatt.AttackSpec(attack, n_byz=20),
                               compression=tcomp.CompressionSpec(name=comp))
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


@pytest.mark.parametrize("change", [dict(method="draco"), dict(participation="iid")])
def test_unported_protocol_options_raise(change):
    with pytest.raises(NotImplementedError):
        dataclasses.replace(tbyz.ProtocolConfig(n_devices=N), **change)


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
