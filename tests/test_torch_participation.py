"""The port's participation schedules, erasure decode and masked mean
against the JAX reference, on the CPU.

The schedules' draws are replayed from the reference's keys: round ``t``'s
uniforms are ``uniform(fold_in(fold_in(key, t), PARTICIPATION_KEY_SALT),
(N,))``, as the reference's engine draws them. Masks and states are 0/1
and compared bitwise. The decode sums in a fixed tree on both sides (the
reference's XLA path) or in the Pallas kernel's order (interpret mode):
rtol 1e-5, atol 1e-6 on rows of order 1.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import numerics as jnum
from repro.core import coding as jcoding
from repro.core import participation as jpart
from repro.core import task_matrix as jtm
from repro_torch import numerics as tnum
from repro_torch.core import coding as tcoding
from repro_torch.core import participation as tpart

RTOL, ATOL = 1e-5, 1e-6
ROUNDS = 20

SPECS = {
    "full": dict(name="full"),
    "iid": dict(name="iid", rate=0.3),
    "iid-all-erased": dict(name="iid", rate=0.97),  # forces the one-reporter fallback
    "onoff": dict(name="onoff", n_drop=3, period=5, duty=0.4),
    "adversarial": dict(name="adversarial", n_drop=3, offset=2),
    "markov": dict(name="markov", p_drop=0.3, p_recover=0.4),
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", sorted(SPECS))
@pytest.mark.parametrize("n", [4, 16])
def test_sample_participation_matches_bitwise(case, n):
    """ROUNDS rounds of every schedule, the state carried on both sides."""
    jspec, tspec = jpart.ParticipationSpec(**SPECS[case]), tpart.ParticipationSpec(**SPECS[case])
    assert tspec.active == jspec.active
    key = jax.random.PRNGKey(n)
    j_state = jpart.init_participation_state(jspec, n)
    t_state = tpart.init_participation_state(tspec, n)
    history = []
    for t in range(ROUNDS):
        pk = jax.random.fold_in(jax.random.fold_in(key, t), jpart.PARTICIPATION_KEY_SALT)
        j_mask, j_state = jpart.sample_participation(jspec, pk, t, n, j_state)
        t_mask, t_state = tpart.sample_participation(tspec, _t(jax.random.uniform(pk, (n,))), t, n, t_state)
        np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask), err_msg=f"round {t}")
        np.testing.assert_array_equal(t_state.numpy(), np.asarray(j_state), err_msg=f"round {t}")
        assert t_mask.sum() >= 1
        history.append(t_mask.tolist())
    assert tpart.mask_stats(history, 2) == jpart.mask_stats(history, 2)


def test_external_schedule_cannot_be_sampled():
    spec = tpart.ParticipationSpec("external")
    with pytest.raises(ValueError):
        tpart.sample_participation(spec, torch.zeros(4), 0, 4, torch.ones(4))
    with pytest.raises(ValueError):
        jpart.sample_participation(jpart.ParticipationSpec("external"), jax.random.PRNGKey(0), 0, 4, jnp.ones(4))


@pytest.mark.parametrize("bad", [dict(name="sometimes"), dict(name="iid", rate=1.0), dict(name="iid", rate=-0.1),
                                 dict(name="adversarial", n_drop=-1), dict(name="onoff", period=0),
                                 dict(name="onoff", duty=0.0)])
def test_participation_spec_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError):
        jpart.ParticipationSpec(**bad)
    with pytest.raises(ValueError):
        tpart.ParticipationSpec(**bad)


@pytest.mark.parametrize("mask", [[1, 1, 1, 1, 1, 1], [0, 1, 1, 0, 1, 1], [0, 0, 0, 0, 0, 0]])
def test_stable_masked_mean0_matches_bitwise(mask):
    rng = np.random.default_rng(len(mask) + sum(mask))
    m = (rng.standard_normal((6, 50)) * 3).astype(np.float32)
    w = np.asarray(mask, np.float32)
    got = tnum.stable_masked_mean0(_t(m), _t(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnum.stable_masked_mean0(jnp.asarray(m), jnp.asarray(w))))
    np.testing.assert_array_equal(tnum.stable_masked_mean0(_t(m[0]), _t(w[:1])).numpy(),
                                  np.asarray(jnum.stable_masked_mean0(jnp.asarray(m[0]), jnp.asarray(w[:1]))))


def _coded_round(n: int, d: int, q: int, seed: int):
    """The subset gradients of one round and its cyclic coded vectors."""
    rng = np.random.default_rng(seed)
    grads = rng.standard_normal((n, q)).astype(np.float32)
    ta = jtm.sample_assignment(jax.random.PRNGKey(seed), n, d)
    coded = np.asarray(jnp.mean(jnp.asarray(grads)[ta.subsets], axis=1))
    return grads, coded, np.asarray(ta.task_index)


# (N, d, erased rows): none, within the margin d - 1, and beyond it
DECODE_CASES = [(16, 4, []), (16, 4, [3]), (16, 4, [0, 7, 9]), (16, 4, [1, 2, 3, 4, 5]),
                (16, 4, list(range(12))), (12, 3, [5, 6]), (12, 3, [0, 4, 8, 11]), (10, 1, [])]


@pytest.mark.parametrize("n,d,erased", DECODE_CASES, ids=[f"N{c[0]}-d{c[1]}-e{len(c[2])}" for c in DECODE_CASES])
def test_cyclic_erasure_decode_matches_reference(n, d, erased):
    grads, coded, task_index = _coded_round(n, d, 300, n * 31 + len(erased))
    mask = np.ones(n, np.float32)
    mask[erased] = 0.0
    transmitted = coded * mask[:, None]
    got = tcoding.cyclic_erasure_decode(_t(transmitted), _t(mask), _t(task_index), d)
    for backend in ("xla", "interpret"):
        want = jcoding.cyclic_erasure_decode(jnp.asarray(transmitted), jnp.asarray(mask),
                                             jnp.asarray(task_index), d, backend=backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=backend)
    if len(erased) <= tcoding.erasure_margin(d):
        # within the margin the decode is the full-participation mean
        np.testing.assert_allclose(got.numpy(), grads.mean(0), rtol=RTOL, atol=ATOL)


def test_decode_ties_choose_the_first_class():
    """All classes whole: class 0 is chosen, as the reference's argmax does."""
    n, d = 8, 4
    task_index = np.arange(n)
    msgs = np.arange(n, dtype=np.float32)[:, None] * np.ones((1, 5), np.float32)
    got = tcoding.cyclic_erasure_decode(_t(msgs), torch.ones(n), _t(task_index), d)
    np.testing.assert_array_equal(got.numpy(), np.full(5, (0 + 4) / 2, np.float32))
    assert tcoding.coded_weights(d).tolist() == np.asarray(jcoding.coded_weights(d)).tolist()
