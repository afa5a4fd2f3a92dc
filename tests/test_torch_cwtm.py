"""CWTM's order and sorting network on the CPU, against the reference.

The CUDA kernel (``csrc/cwtm.cu``) turns each float into an ordered
signed 32-bit key (its bits, the lower 31 flipped if it is negative; every
NaN one key, 0x7FFFFFFE, above +inf's), pads a column to a power of two
with a key above NaN's, sorts the keys with Batcher's odd-even merge network
(``kernels/cwtm.network``), and sums the kept slots as the plain version's
fixed tree. Here:

  * the plain CWTM and CWTM-NNM, the CPU route of ``ops.cwtm``, on stacks
    with NaN and +-inf, against the reference's ``aggregators.cwtm`` (after
    its ``nnm_mix`` on the same distances), rtol and atol 1e-6, NaN at the
    same places: NaN sorts last, so a trim drops it;
  * ``launch_work``'s CWTM operations: a min and a max for each of
    Batcher's compare-exchanges on ``pow2_ceil(N)`` slots;
  * the network sorts every 0/1 input of N <= 16 slots padded as the kernel
    pads them (the 0-1 principle), and random keys with NaN, +-inf and +-0
    as ``torch.sort`` orders their floats, at N = 13 to 256;
  * the kernel's arithmetic replayed in numpy (keys, the network, the kept
    slots, the tree) equals the plain version bit for bit (+0 equals -0).

The kernel itself is held to the plain version on the card by
``tests/test_torch_card.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro_torch.core import aggregators as tagg
from repro_torch.kernels import cwtm as tcwtm
from repro_torch.kernels import ops as tops

NAN_KEY, PAD_KEY = np.int32(0x7FFFFFFE), np.int32(0x7FFFFFFF)


def _special_stack(rng, n: int, q: int, byz: int, share: float) -> np.ndarray:
    """An (n, q) normal stack whose first ``byz`` rows carry NaN, NaN with
    its sign bit set, +inf, -inf, +0 or -0 in ``share`` of their entries;
    column 0 is NaN in all of them."""
    x = rng.standard_normal((n, q)).astype(np.float32)
    specials = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0], dtype=np.float32)
    specials[1] = np.copysign(specials[1], -1.0)
    planted = rng.random((byz, q)) < share
    x[:byz] = np.where(planted, specials[rng.integers(0, 6, (byz, q))], x[:byz])
    x[:byz, 0] = np.nan
    return x


def _flip(b: np.ndarray) -> np.ndarray:
    """int32 bits with the lower 31 flipped where the sign bit is set: its
    own inverse."""
    return b ^ ((b >> 31) & np.int32(0x7FFFFFFF))


def _keys(x: np.ndarray) -> np.ndarray:
    """The kernel's ordered keys of float32 values."""
    return np.where(np.isnan(x), NAN_KEY, _flip(x.view(np.int32))).astype(np.int32)


def _floats(k: np.ndarray) -> np.ndarray:
    return _flip(k).astype(np.int32).view(np.float32)


def _sorted_keys(keys: np.ndarray) -> np.ndarray:
    """(n, q) keys padded to pow2_ceil(n) slots and run through the network
    column by column."""
    n = keys.shape[0]
    slots = 1 << (n - 1).bit_length()
    v = np.concatenate([keys, np.full((slots - n,) + keys.shape[1:], PAD_KEY, dtype=np.int32)])
    for a, b in tcwtm.network(slots):
        lo, hi = np.minimum(v[a], v[b]), np.maximum(v[a], v[b])
        v[a], v[b] = lo, hi
    return v


def _assert_same(got: torch.Tensor, want: torch.Tensor) -> None:
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.parametrize("n,trim_frac", [(100, 0.0), (100, 0.1), (13, 0.1), (41, 0.1)])
def test_plain_cwtm_sorts_nan_last_as_the_reference(n, trim_frac):
    rng = np.random.default_rng(n)
    byz = n // 5
    x = _special_stack(rng, n, 300, byz, 0.1)
    got = tagg.cwtm(torch.from_numpy(x), trim_frac)
    want = np.array(jagg.cwtm(jnp.asarray(x), trim_frac))
    torch.testing.assert_close(got, torch.from_numpy(want), rtol=1e-6, atol=1e-6, equal_nan=True)
    nan = np.isnan(want)
    assert nan[0] and not nan.all()  # column 0's NaN outlast any trim below byz; most columns stay finite
    # with the mix: NNM on distances of the stack before the planting, the same selection on both sides
    base = rng.standard_normal((n, 300)).astype(np.float32)
    d2 = ((base[:, None, :] - base[None, :, :]) ** 2).sum(-1).astype(np.float32)
    got = tagg.cwtm(torch.from_numpy(x), trim_frac, tagg.nnm_neighbours(torch.from_numpy(d2), byz))
    want = np.array(jagg.cwtm(jagg.nnm_mix(jnp.asarray(x), byz, d2=jnp.asarray(d2)), trim_frac))
    torch.testing.assert_close(got, torch.from_numpy(want), rtol=1e-6, atol=1e-6, equal_nan=True)


# Batcher's odd-even merge sort on 2^m slots: (m^2 - m + 4) 2^(m - 2) - 1 compare-exchanges
BATCHER = {8: 19, 16: 63, 64: 543, 128: 1471, 256: 3839}


@pytest.mark.parametrize("n", [8, 41, 100, 128, 256])
def test_launch_work_counts_batchers_compare_exchanges(n):
    slots = 1 << (n - 1).bit_length()
    m = slots.bit_length() - 1
    assert len(tcwtm.network(slots)) == BATCHER[slots] == (m * m - m + 4) * 2 ** (m - 2) - 1
    trim, k, q = n // 10, n - n // 5, 7
    assert tops.launch_work("cwtm", 3, n, q, trim=trim) == (4.0 * 3 * (n * q + q),
                                                           3.0 * q * (2 * BATCHER[slots] + n - 2 * trim + 1))
    mixed = tops.launch_work("cwtm", 3, n, q, trim=trim, k=k)[1] - tops.launch_work("cwtm", 3, n, q, trim=trim)[1]
    assert mixed == 3.0 * q * n * (k + 1)


def test_network_sorts_every_zero_one_input():
    """The 0-1 principle: a comparator network that sorts every 0/1 input
    sorts every input. Each N <= 16, its pow2_ceil(N) - N padding slots
    above every value, as the kernel pads."""
    for n in range(1, 17):
        bits = np.array(list(itertools.product((0, 1), repeat=n)), dtype=np.int32).T  # (n, 2^n)
        v = _sorted_keys(bits)
        assert (np.diff(v.astype(np.int64), axis=0) >= 0).all(), n
        assert (v[n:] == PAD_KEY).all()


@pytest.mark.parametrize("n", [13, 41, 100, 128, 256])
def test_network_orders_keys_as_torch_sort(n):
    rng = np.random.default_rng(1000 + n)
    x = _special_stack(rng, n, 400, n, 0.2)
    v = _sorted_keys(_keys(x))
    assert (v[n:] == PAD_KEY).all()
    _assert_same(torch.from_numpy(_floats(v[:n])), torch.sort(torch.from_numpy(x), dim=0).values)


@pytest.mark.parametrize("n,trim", [(100, 10), (100, 0), (41, 20), (13, 1), (256, 25)])
def test_kernel_arithmetic_replayed_is_the_plain_version(n, trim):
    """Keys, the network, the kept slots [trim, n - trim) as floats, the
    tree zero-padded to a power of two, times 1 / (n - 2 trim) in float32."""
    rng = np.random.default_rng(n + trim)
    x = _special_stack(rng, n, 500, n // 5, 0.05) * np.float32(3)
    kept = _floats(_sorted_keys(_keys(x))[trim:n - trim])
    valid = n - 2 * trim
    t = np.concatenate([kept, np.zeros(((1 << (valid - 1).bit_length()) - valid, x.shape[1]), np.float32)])
    with np.errstate(invalid="ignore"):  # +inf and -inf kept in one column: NaN, as on the card
        while t.shape[0] > 1:
            h = t.shape[0] // 2
            t = t[:h] + t[h:]
    got = torch.from_numpy(t[0] * np.float32(1.0 / valid))
    _assert_same(got, tcwtm.plain(torch.from_numpy(x), trim))
