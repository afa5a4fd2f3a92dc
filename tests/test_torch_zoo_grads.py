"""Each zoo family's parameters, loss and per-subset gradients in the port
against the JAX reference, on the CPU: the flat parameter vector, the
port's own initialisation, ``loss_fn`` and the engine's ``(N, P)`` stack
of subset gradients, for the twelve architectures of
tests/test_torch_zoo_ops.py, whose module docstring states the
tolerances and the float64 anchor these tests hold the ill-conditioned
gradients to.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.core.coding import flatten_pytree as jflatten
from repro_torch import convert, models, pytree
from repro_torch.core import scenarios as tscn
from repro_torch.core.coding import flatten_pytree
from repro_torch.models import precision
from repro_torch.models.precision import FLOAT64_RTOL
from test_torch_zoo_ops import (ARCHS, FLOAT64_ANCHORED, arch_pair, close, close_sum, float64_jit,
                                reference_float64, _batch)

FLOAT32_SPREAD = 2.5e-4  # a float32 gradient from float64, the same measure: twice the widest order measured


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    """(name, reference arch, port arch, reference params, specs, port params)."""
    jarch, tarch = arch_pair(request.param)
    params, specs = jmodels.init(jax.random.PRNGKey(0), jarch)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return (request.param, jarch, tarch, params, specs,
            convert.lm_params_from_numpy(jax.tree.map(np.asarray, params)))


def test_flat_vector_is_the_reference(carried):
    _, _, tarch, params, specs, tparams = carried
    want, _ = jflatten(params)
    flat, _ = flatten_pytree(tparams)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))


def test_init_tree_and_specs_are_the_reference(carried):
    """The port's own initialisation has the reference's tree, shapes,
    dtypes (float32 here) and logical-axis specs."""
    _, _, tarch, params, specs, _ = carried
    own, own_specs = models.init(torch.Generator().manual_seed(0), tarch)
    assert [tuple(p.shape) for p in pytree.leaves(own)] == [p.shape for p in jax.tree.leaves(params)]
    assert own_specs == jax.tree.map(tuple, specs, is_leaf=lambda x: isinstance(x, tuple))
    for i, spec in enumerate(tarch.period):
        if spec.mixer == "mamba":  # A's constant init, S4D-real, to the logarithm's last bit
            close(own["periods"][f"blk{i}"]["mixer"]["a_log"], params["periods"][f"blk{i}"]["mixer"]["a_log"],
                  rtol=2e-7, atol=0)


def test_loss_fn_matches(carried):
    _, jarch, tarch, params, specs, tparams = carried
    jb, tb = _batch(jarch, 20)
    want, wparts = jmodels.loss_fn(params, specs, jarch, jax.tree.map(lambda a: a[1], jb), remat=False)
    got, parts = models.loss_fn(tparams, None, tarch, {k: v[1] for k, v in tb.items()})
    close(got, want)
    close(parts["nll"], wparts["nll"])
    close(parts["aux"], wparts["aux"])
    assert (float(parts["aux"]) > 0) == any(s.mlp == "moe" for s in tarch.period)


def test_per_subset_gradients_match(carried):
    """The engine's ``(N, P)`` stack of 3 subsets' gradients (``_lm_fns``:
    ``vmap`` of the loss's ``vjp`` through the per-period views), leaf by
    leaf, against ``jax.vmap(jax.grad)``; the float64-anchored archs as the
    ops module's docstring states."""
    name, jarch, tarch, params, specs, tparams = carried
    jb, tb = _batch(jarch, 21)

    def reference(p, b, arch=jarch):
        g = jax.vmap(jax.grad(lambda p, b: jmodels.loss_fn(p, specs, arch, b, remat=False)[0]),
                     in_axes=(None, 0))(p, b)
        return jnp.stack([jflatten(jax.tree.map(lambda a: a[n], g))[0] for n in range(3)])

    want = np.asarray(reference(params, jb))
    _, spec, subset_grads, _ = tscn._lm_fns(tarch)
    data = tuple(tb[k] for k in ("tokens", "labels", "frontend") if k in tb)
    x = flatten_pytree(tparams)[0]
    stack = subset_grads(data, x).numpy()
    sizes = [int(np.prod(shape)) for shape in spec[1]]
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(params)]
    if name not in FLOAT64_ANCHORED:
        at = 0
        for path, size in zip(paths, sizes):
            close_sum(torch.from_numpy(stack[:, at:at + size]), want[:, at:at + size], path)
            at += size
        return

    with reference_float64():
        args = (jax.tree.map(lambda a: np.asarray(a, np.float64), params),
                {k: np.asarray(v, np.float64) if k == "frontend" else np.asarray(v) for k, v in jb.items()})
        fn = partial(reference, arch=dataclasses.replace(jarch, param_dtype="float64"))
        want64 = np.asarray(float64_jit(fn, *args)(*args))
    with precision.float64():
        stack64 = subset_grads(tuple(d.double() if d.is_floating_point() else d for d in data), x.double())
    assert want64.dtype == np.float64 and stack64.dtype == torch.float64

    def worst(flat):
        err, at = 0.0, 0
        for size in sizes:
            ref = want64[:, at:at + size]
            err = max(err, float(np.abs(flat[:, at:at + size] - ref).max() / np.abs(ref).max()))
            at += size
        return err

    assert worst(stack64.numpy()) <= FLOAT64_RTOL, worst(stack64.numpy())
    assert worst(want) <= FLOAT32_SPREAD, worst(want)
    assert worst(stack) <= FLOAT32_SPREAD, worst(stack)
