"""Sorts that meet a Byzantine NaN, on the CPU, against the JAX reference.

Every sort of the port that can meet a Byzantine value sorts through
``numerics.nan_last``, so a NaN sorts last whatever its sign bit, on the
CPU and on the card (ROADMAP C.14: on a CUDA device ``torch.sort`` puts a
NaN whose sign bit is set first on a long enough axis; the card side is
``tests/test_torch_card.py::test_sorts_put_a_sign_bit_nan_last_as_on_the_cpu``).
The sites: DRACO's masked group median (``coding.draco_decode``), the MCC
scale (``aggregators._vector_median``), the selections of tgn, multi-Krum
and NNM's table (``aggregators._smallest``) and the Krum scores. Top-k
sparsification sorts ``|g|``, whose sign bit ``abs`` clears, so it needs no
repair; it is held here too.

The same inputs go through the port and the reference, with the NaN's sign
bit set (``0xFFC00000``) and clear (``0x7FC00000``) in a Byzantine row at
N = 100 (DRACO-d41 at N = 82):

  * DRACO's masked decode and MCC: the reference and the port agree (rtol
    1e-5, atol 1e-6, NaN at the same places; MCC is all NaN on both sides,
    a NaN row's weight being NaN);
  * tgn and NNM's table: with the sign bit clear, the reference; with it
    set, a numpy oracle that sorts every NaN last (``np.argsort``), since
    the reference's ``lax.top_k(-x, k)`` orders totally and ranks the
    negation of a sign-bit NaN, a positive NaN, first: it keeps the NaN row
    (ROADMAP C.15, pinned below);
  * multi-Krum and the Krum scores: the numpy oracle of
    ``tests/test_torch_protocol.py`` with the NaN sorted last (the
    reference's scores are all NaN, C.1).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.core import coding as jcoding
from repro.core import compression as jcomp
from repro_torch.core import aggregators as tagg
from repro_torch.core import coding as tcoding
from repro_torch.core import compression as tcomp
from repro_torch.numerics import nan_last

RTOL, ATOL = 1e-5, 1e-6
N, Q, B = 100, 64, 20
NAN_BITS = {"sign_bit": np.uint32(0xFFC00000), "positive": np.uint32(0x7FC00000)}


def _with_nan(x: np.ndarray, where: tuple, sign: str) -> np.ndarray:
    x = x.copy()
    x.view(np.uint32)[where] = NAN_BITS[sign]
    return x


def _stack(seed: int, n: int = N, q: int = Q) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, q)).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL, equal_nan=True)


@pytest.mark.parametrize("sign", list(NAN_BITS))
def test_nan_last_sorts_every_nan_last(sign):
    """Raw values with a NaN of either sign: ``_vector_median`` and
    ``_smallest`` equal numpy's sort, which puts every NaN last."""
    v = _with_nan(_stack(0, 3, N), (slice(None), 7), sign)
    v[1, 50] = -0.0
    assert np.signbit(v[0, 7]) == (sign == "sign_bit")
    t = torch.from_numpy(v)
    srt = np.sort(v, axis=-1)
    want = (srt[:, (N - 1) // 2] + srt[:, N // 2]) * np.float32(0.5)
    assert np.array_equal(tagg._vector_median(t).numpy(), want)
    np.testing.assert_array_equal(tagg._smallest(t, N - B).numpy(), np.argsort(v, axis=-1, kind="stable")[:, : N - B])
    assert not bool(torch.signbit(nan_last(t)[torch.isnan(t)]).any())


@pytest.mark.parametrize("sign", list(NAN_BITS))
def test_draco_masked_decode_with_a_nan_matches_reference(sign):
    """DRACO-d41 (N = 82, two groups of 41): a NaN in a reporting row of a
    group with an erased member, whose median runs over its reporting rows
    through the masked sort; the other group full."""
    x = _with_nan(_stack(1, 82), (2, 5), sign)
    mask = np.ones(82, np.float32)
    mask[7] = 0.0
    x = x * mask[:, None]
    got = tcoding.draco_decode(torch.from_numpy(x), 41, mask=torch.from_numpy(mask))
    want = jcoding.draco_decode(jnp.asarray(x), 41, mask=jnp.asarray(mask))
    _close(got, want)


@pytest.mark.parametrize("sign", list(NAN_BITS))
def test_mcc_with_a_nan_row_matches_reference(sign):
    x = _with_nan(_stack(2), (3, 5), sign)
    got = tagg.make_aggregator("mcc", n_byz=B)(torch.from_numpy(x))
    want = jagg.make_aggregator("mcc", n_byz=B)(jnp.asarray(x))
    _close(got, want)
    assert bool(torch.isnan(got).all())


def _oracle_mean(x: np.ndarray, keep: np.ndarray) -> np.ndarray:
    return x[keep].astype(np.float64).mean(0)


@pytest.mark.parametrize("sign", list(NAN_BITS))
def test_tgn_with_a_nan_row_drops_it(sign):
    x = _with_nan(_stack(3), (3, 5), sign)
    got = tagg.tgn(torch.from_numpy(x), n_byz=B)
    norms = (x.astype(np.float64) ** 2).sum(1)
    _close(got, _oracle_mean(x, np.argsort(norms, kind="stable")[: N - B]))
    assert bool(torch.isfinite(got).all())
    if sign == "positive":
        _close(got, jagg.make_aggregator("tgn", n_byz=B)(jnp.asarray(x)))


@pytest.mark.parametrize("sign", list(NAN_BITS))
def test_nnm_table_with_a_nan_row_leaves_it_out(sign):
    """The same (N, N) distances, from the reference, into both selections."""
    x = _with_nan(_stack(4), (3, 5), sign)
    d2 = np.asarray(jagg._pairwise_sqdist(jnp.asarray(x)))
    got = tagg.nnm_neighbours(torch.from_numpy(d2.copy()), B).numpy()
    oracle = np.sort(np.argsort(d2, axis=-1, kind="stable")[:, : N - B], axis=-1)
    np.testing.assert_array_equal(got, oracle)
    assert not (np.delete(got, 3, axis=0) == 3).any()  # no other row takes the NaN row as a neighbour
    if sign == "positive":
        _, idx = jax.lax.top_k(-jnp.asarray(d2), N - B)
        np.testing.assert_array_equal(got, np.sort(np.asarray(idx), axis=-1))


def _krum_oracle_scores(x: np.ndarray, n_byz: int) -> np.ndarray:
    """tests/test_torch_protocol.py's oracle: float64 distances, each row's
    own excluded, the N - b - 2 nearest summed; a NaN distance sorts last."""
    y = x.astype(np.float64)
    d2 = ((y[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    d2[np.arange(len(y)), np.arange(len(y))] = np.inf
    return np.sort(d2, axis=1)[:, : max(len(y) - n_byz - 2, 1)].sum(1)


@pytest.mark.parametrize("sign", list(NAN_BITS))
def test_krum_scores_and_multi_krum_with_a_nan_row_match_the_oracle(sign):
    x = _with_nan(_stack(5), (3, 5), sign)
    scores = _krum_oracle_scores(x, B)
    got = tagg.krum_scores(torch.from_numpy(x), B)
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(scores)) and np.isnan(scores[3])
    np.testing.assert_allclose(got.numpy()[~np.isnan(scores)], scores[~np.isnan(scores)], rtol=RTOL)
    keep = np.argsort(scores, kind="stable")[: N - B]
    _close(tagg.multi_krum(torch.from_numpy(x), B), _oracle_mean(x, keep))


@pytest.mark.parametrize("sign", list(NAN_BITS))
def test_top_k_compression_keeps_a_nan_of_either_sign_as_the_reference(sign):
    """``|g|`` of a NaN is a positive NaN on the CPU (and ``abs`` clears the
    sign bit on the card too): top-k needs no repair and ranks it first, as
    the reference's ``lax.top_k(|g|)`` does."""
    x = _with_nan(_stack(6, 4, Q), (1, 9), sign)
    assert not bool(torch.signbit(torch.from_numpy(x).abs()).any())
    got = tcomp.top_k(torch.from_numpy(x), 8)
    want = np.stack([np.asarray(jcomp.top_k(None, jnp.asarray(row), 8)) for row in x])
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_reference_top_k_keeps_a_sign_bit_nan():
    """ROADMAP C.15: the reference selects with ``lax.top_k(-x, k)``, which
    orders totally; ``-x`` of a sign-bit NaN is a positive NaN, ranked above
    every number, so tgn keeps the NaN row (the port drops it, as it drops a
    NaN without the sign bit, and as the reference does that one)."""
    x = _with_nan(_stack(3), (3, 5), "sign_bit")
    norms = jnp.sum(jnp.asarray(x) * jnp.asarray(x), axis=1)
    _, idx = jax.lax.top_k(-norms, N - B)
    assert 3 in np.asarray(idx).tolist()
    assert bool(jnp.isnan(jagg.make_aggregator("tgn", n_byz=B)(jnp.asarray(x))).any())
    y = _with_nan(_stack(3), (3, 5), "positive")
    _, idx = jax.lax.top_k(-jnp.sum(jnp.asarray(y) * jnp.asarray(y), axis=1), N - B)
    assert 3 not in np.asarray(idx).tolist()
