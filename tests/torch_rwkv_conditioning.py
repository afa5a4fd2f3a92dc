"""Why RWKV's float32 subset gradients part from the reference (ROADMAP
C.7): where the rounding comes from, and how far equally valid float32
evaluations spread. Prints one JSON line per measurement; runs on the CPU
in about a minute::

    PYTHONPATH=src python tests/torch_rwkv_conditioning.py

On ``zoo/rwkv/lad-d2``'s replayed trajectory (``test_torch_zoo.py``'s
``replayed_run``), at every round where the port's and the reference's
float32 subset gradients differ by more than ``GRAD_ROW_RTOL``, for the
worst row (its distance from the reference's float64 gradient over its
norm):

  * ``float32``: the reference's and the port's float32 gradients;
  * ``float32_alone``: the port in float64 with one part of the model
    left in float32 (the time mix's projections, its group norm, the
    whole time mix, the channel mix, the RMS norms, the cross entropy);
  * ``rounded_once``: the port in float64 with one projection of the time
    mix (r, k, v, g, the decay w, or all five) rounded once to float32;
  * ``orders``: the port's float32 gradient with the contraction order of
    the time mix's projections permuted (24 orders; the same sums, added
    in another order).

Then, on ``reduced(rwkv6-1.6b)`` (``test_torch_zoo_grads.py``'s inputs),
the largest leaf error over the leaf's largest value of the reference's
and the port's float32 gradients and of 16 permuted orders.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro import models as jmodels  # noqa: E402
from repro.core import scenarios as jscn  # noqa: E402
from repro.core.coding import flatten_pytree as jflatten  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import scenarios as tscn  # noqa: E402
from repro_torch.core.coding import flatten_pytree  # noqa: E402
from repro_torch.models import layers, precision  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.precision import GRAD_ROW_RTOL  # noqa: E402
from test_torch_zoo import replayed_run  # noqa: E402
from test_torch_zoo_ops import _batch, arch_pair, float64_jit, reference_float64  # noqa: E402

F32, F64 = torch.float32, torch.float64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def widen(obj, dtype):
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, dict):
        return {k: widen(v, dtype) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(widen(v, dtype) for v in obj)
    return obj


@contextlib.contextmanager
def patched(module, name, fn):
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield real
    finally:
        setattr(module, name, real)


def float32_alone(fn):
    """``fn`` computing in float32 inside ``precision.float64()``: its
    inputs rounded to float32, its outputs widened back."""
    def run(*args, **kw):
        torch.float32 = F32
        try:
            with torch._C.DisableTorchFunction():
                out = fn(*widen(args, F32), **widen(kw, F32))
                return widen(out, F64)
        finally:
            torch.float32 = F64
    return run


def permuted_projections(perm):
    """``rwkv._projections`` with the model dimension, the contraction of
    every projection, taken in the order ``perm``."""
    real = R._projections

    def projections(params, x, x_shift, head_dim):
        p = dict(params)
        p["mu"] = params["mu"][:, perm]
        for name in ("wr", "wk", "wv", "wg", "w_lora_a"):
            p[name] = params[name][..., perm, :]
        return real(p, x[..., perm], x_shift[..., perm], head_dim)
    return projections


def row_errors(got: torch.Tensor, want: torch.Tensor) -> np.ndarray:
    got, want = got.to(F64), want.to(F64)
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).numpy()


def trajectory() -> None:
    run = replayed_run("rwkv")
    data64 = tuple(np.asarray(d, np.float64 if i == 2 else None) for i, d in enumerate(run.data))
    batch = tuple(run.batch.values())
    _, jgrads, _ = jscn._lm_fns(run.jarch)
    jgrads = jax.jit(jgrads)
    jgrads64 = None
    d_model = run.jarch.d_model
    for t, (x, got) in enumerate(zip(run.xs, run.stacks)):
        want = torch.from_numpy(np.asarray(jgrads(run.data, jnp.asarray(x.numpy()))))
        if precision.row_error(got, want) <= GRAD_ROW_RTOL:
            continue
        x64 = x.numpy().astype(np.float64)
        with reference_float64():
            if jgrads64 is None:
                fn = jscn._lm_fns(dataclasses.replace(run.jarch, param_dtype="float64"))[1]
                jgrads64 = float64_jit(fn, data64, x64)
            exact = torch.from_numpy(np.asarray(jgrads64(data64, x64)))
        ref_err = row_errors(want, exact)
        row = int(ref_err.argmax())

        def port_err(in_float64=False):
            if in_float64:
                with precision.float64():
                    g = run.fns.subset_grad_fn(batch, x.double())
            else:
                g = run.fns.subset_grad_fn(batch, x)
            return float(row_errors(g, exact)[row])

        line = {"round": t, "row": row, "float32": {"reference": float(ref_err[row]),
                                                    "port": float(row_errors(got, exact)[row])}}
        line["float32_alone"] = {}
        for name, module, attr in (("projections", R, "_projections"), ("group_norm", R, "_group_norm"),
                                   ("time_mix", R, "rwkv_time_mix"), ("channel_mix", R, "rwkv_channel_mix"),
                                   ("rms_norms", layers, "rmsnorm"), ("cross_entropy", T, "_chunked_ce")):
            with patched(module, attr, float32_alone(getattr(module, attr))):
                line["float32_alone"][name] = port_err(in_float64=True)
        line["rounded_once"] = {}
        for name, which in (("r", (0,)), ("k", (1,)), ("v", (2,)), ("g", (3,)), ("w", (4,)),
                            ("all", (0, 1, 2, 3, 4))):
            def rounded(params, x_, x_shift, head_dim, real=R._projections, which=which):
                out = list(real(params, x_, x_shift, head_dim))
                with torch._C.DisableTorchFunction():
                    for j in which:
                        out[j] = out[j].to(F32).to(F64)
                return tuple(out)
            with patched(R, "_projections", rounded):
                line["rounded_once"][name] = port_err(in_float64=True)
        orders = []
        for seed in range(24):
            perm = torch.from_numpy(np.random.default_rng(seed).permutation(d_model))
            with patched(R, "_projections", permuted_projections(perm)):
                orders.append(port_err())
        line["orders"] = {"n": len(orders), "min": min(orders), "median": float(np.median(orders)),
                          "max": max(orders), "all": orders}
        emit(line)


def reduced_rwkv() -> None:
    jarch, tarch = arch_pair("reduced-rwkv6-1.6b")
    params, specs = jmodels.init(jax.random.PRNGKey(0), jarch)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params))
    jb, tb = _batch(jarch, 21)

    def reference(p, b, arch=jarch):
        g = jax.vmap(jax.grad(lambda p, b: jmodels.loss_fn(p, specs, arch, b, remat=False)[0]),
                     in_axes=(None, 0))(p, b)
        return jnp.stack([jflatten(jax.tree.map(lambda a: a[n], g))[0] for n in range(3)])

    want = np.asarray(reference(params, jb))
    with reference_float64():
        args = (jax.tree.map(lambda a: np.asarray(a, np.float64), params), {k: np.asarray(v) for k, v in jb.items()})
        fn = lambda p, b: reference(p, b, dataclasses.replace(jarch, param_dtype="float64"))  # noqa: E731
        exact = np.asarray(float64_jit(fn, *args)(*args))
    _, spec, subset_grads, _ = tscn._lm_fns(tarch)
    data = (tb["tokens"], tb["labels"])
    x = flatten_pytree(tparams)[0]
    sizes = [int(np.prod(shape)) for shape in spec[1]]

    def worst(flat):
        err, at = 0.0, 0
        for size in sizes:
            ref = exact[:, at:at + size]
            err = max(err, float(np.abs(flat[:, at:at + size] - ref).max() / np.abs(ref).max()))
            at += size
        return err

    orders = []
    for seed in range(16):
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(tarch.d_model))
        with patched(R, "_projections", permuted_projections(perm)):
            orders.append(worst(subset_grads(data, x).numpy()))
    port = worst(subset_grads(data, x).numpy())
    emit({"arch": "reduced-rwkv6-1.6b", "float32": {"reference": worst(want), "port": port},
          "orders": {"n": len(orders), "min": min(orders), "median": float(np.median(orders)), "max": max(orders),
                     "all": orders}})


if __name__ == "__main__":
    trajectory()
    reduced_rwkv()
