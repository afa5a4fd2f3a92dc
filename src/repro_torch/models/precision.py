"""The model evaluated in float64, and the bounds that hold a float32
gradient where float32 cannot resolve it.

The model names ``torch.float32`` wherever it casts or accumulates, as the
reference names ``jnp.float32``, and an arch's ``dtype`` is
``getattr(torch, param_dtype)``. Inside ``float64()`` that name is
``torch.float64``: every cast and accumulator of the model, and every
arch whose ``param_dtype`` is ``"float32"``, computes in float64. The
parameters and inputs are the caller's to widen. A dtype bound before the
block (a default argument, a dtype stored in an object) would stay
float32, so the block also watches every torch call made inside it and
raises where one turns float64 input into a floating-point result of
another type (a cast, or a write into a narrower tensor). A constant made
from Python numbers in the default type is let through: an operation
with float64 promotes it.

Some subset gradients of the zoo are ill-conditioned in float32 (ROADMAP
C.7, PERF.md §6): at some iterates one rounding of the RWKV time mix's
projections moves a subset's gradient by 1e-5 of its norm, and equally
valid summation orders of those projections put the float32 gradient
anywhere from 1e-5 to 2.5e-4 of its norm away from the float64 one. Two
float32 evaluations there (two frameworks, the card and the CPU) differ by
that much, and their trajectories part. Such a round is held in two
parts: the two float64 evaluations of the gradient agree to
``FLOAT64_RTOL`` (the same function), and each float32 evaluation lies
within ``ILL_ROW_BOUND`` of float64 (the spread of its rounding).
"""
from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["float64", "row_error", "PARTING_FAMILIES", "GRAD_ROW_RTOL", "ILL_ROW_BOUND", "FLOAT64_RTOL"]

PARTING_FAMILIES = ("rwkv",)  # zoo families whose float32 trajectories may part at an ill-conditioned iterate
GRAD_ROW_RTOL = 1e-5  # two float32 evaluations of a subset gradient: each row within this of its norm
ILL_ROW_BOUND = 5e-4  # past that, each float32 row within this of float64 (twice the widest order measured)
FLOAT64_RTOL = 1e-9  # two float64 evaluations of one gradient: a row over its norm, or a leaf over its max

_F32, _F64 = torch.float32, torch.float64


def row_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest row distance of two ``(N, P)`` stacks over the row's
    norm, in float64."""
    got, want = got.to(_F64), want.to(_F64)
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for item in obj:
            yield from _tensors(item)
    elif isinstance(obj, dict):
        for item in obj.values():
            yield from _tensors(item)


class _NoNarrowing(TorchFunctionMode):
    """Raises on a torch call that turns float64 input into a narrower
    floating-point result (its output, or the tensor an in-place call
    writes)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(t.dtype == _F64 for t in _tensors((args, kwargs))):
            name = getattr(func, "__name__", str(func))
            written = list(_tensors(out))
            if args and (name.endswith("_") or name == "__setitem__"):
                written += list(_tensors(args[0]))
            for t in written:
                if t.is_floating_point() and t.dtype != _F64:
                    raise TypeError(f"{name} narrowed float64 to {t.dtype} inside float64()")
        return out


@contextlib.contextmanager
def float64():
    """The model's float32 computes in float64 inside the block; see the
    module docstring."""
    torch.float32 = _F64
    try:
        with _NoNarrowing():
            yield
    finally:
        torch.float32 = _F32
