"""State carried between the JAX reference and the port, as numpy arrays.

``state_from_numpy`` turns the reference's trainer state (the iterate, the
SGD step count, the problem ``(Z, y)``, optionally ``x_star`` and, under
partial participation, the schedule state: the previous ``(N,)`` mask) into
the port's tensors on a chosen device; ``result_to_numpy`` turns a
``TrajectoryResult`` back. Both sides then start from identical state.
``lm_params_from_numpy`` carries the LM's parameter tree across, leaf for
leaf (or a rank's cut of it), and ``opt_state_from_numpy`` its optimizer state (step and moments),
so the port can start from the reference's mid-run state.
``decode_state_from_numpy`` carries a serving decode state across (the
caches, ``KVCache``, ``MambaState`` and ``RWKVState``, and ``pos``), and
``decode_state_to_numpy`` takes one back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.core.engine import TrajectoryResult
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba import MambaState
from repro_torch.models.rwkv import RWKVState
from repro_torch.optim import OptState

__all__ = ["TrainerState", "state_from_numpy", "result_to_numpy", "lm_params_from_numpy", "opt_state_from_numpy",
           "decode_state_from_numpy", "decode_state_to_numpy"]

_CACHES = {cls.__name__: cls for cls in (KVCache, MambaState, RWKVState)}


@dataclasses.dataclass(frozen=True)
class TrainerState:
    x: torch.Tensor
    opt_state: OptState
    z: torch.Tensor
    y: torch.Tensor
    x_star: torch.Tensor | None = None
    participation_state: torch.Tensor | None = None


def _step(step, device) -> torch.Tensor:
    return torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device)


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def state_from_numpy(x, step, z, y, x_star=None, participation_state=None, *,
                     device: torch.device | str) -> TrainerState:
    """The reference's state (numpy arrays and an int step) on ``device``."""
    return TrainerState(
        x=_tensor(x, device),
        opt_state=OptState(step=_step(step, device), mu=(), nu=()),
        z=_tensor(z, device),
        y=_tensor(y, device),
        x_star=None if x_star is None else _tensor(x_star, device),
        participation_state=None if participation_state is None else _tensor(participation_state, device),
    )


def result_to_numpy(res: TrajectoryResult) -> dict[str, np.ndarray]:
    """``{"x": ..., "step": ..., <metric>: ...}`` as numpy arrays, plus
    ``"participation_state"`` under partial participation."""
    out = {"x": res.x.detach().cpu().numpy(), "step": res.opt_state.step.detach().cpu().numpy()}
    if res.participation_state is not None:
        out["participation_state"] = res.participation_state.detach().cpu().numpy()
    out.update({k: v.detach().cpu().numpy() for k, v in res.metrics.items()})
    return out


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own: widen exactly, narrow back
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_numpy(tree, *, device: torch.device | str = "cpu", placements=None, mesh=None):
    """The reference's LM parameter tree (nested dicts of numpy arrays) as
    the port's tree of tensors on ``device``, leaf for leaf, bits and dtypes
    unchanged: ``coding.flatten_pytree`` of the result is the reference's
    flat vector of the same tree. With ``placements`` (``launch.train.
    param_pspecs``) and ``mesh``, this rank's cut of it (``shard_tree``)."""
    out = pytree.map_tree(lambda a: _leaf(a, "cpu"), tree)
    if placements is not None:
        from repro_torch.launch.train import shard_tree

        out = shard_tree(out, placements, mesh)
    return pytree.map_tree(lambda a: a.to(device), out)


def opt_state_from_numpy(state, *, device: torch.device | str = "cpu") -> OptState:
    """The reference's ``OptState`` (its ``step``, ``mu`` and ``nu``, the
    leaves numpy arrays, as ``jax.device_get`` gives them) as the port's on
    ``device``: the step a 0-d int32 tensor, the moment trees leaf for leaf
    with their bits and dtypes (``()`` stays ``()``)."""
    moments = {k: pytree.map_tree(lambda a: _leaf(a, device), getattr(state, k)) for k in ("mu", "nu")}
    return OptState(step=_step(state.step, device), **moments)


def decode_state_from_numpy(state, *, device: torch.device | str = "cpu") -> dict:
    """The reference's decode state (``{"blk<i>": cache, ..., "pos": ...}``,
    each cache a ``KVCache``, ``MambaState`` or ``RWKVState`` whose fields
    are numpy arrays, as ``jax.device_get`` gives them) as the port's on
    ``device``: each cache the port's class of the same name, its fields
    leaf for leaf with their bits and dtypes, ``pos`` a 0-d int32 tensor."""
    out = {}
    for name, cache in state.items():
        if name == "pos":
            out[name] = _step(cache, device)
            continue
        fields = {f.name: _leaf(getattr(cache, f.name), device) for f in dataclasses.fields(cache)}
        out[name] = _CACHES[type(cache).__name__](**fields)
    return out


def decode_state_to_numpy(state: dict) -> dict:
    """A port decode state as numpy: ``pos`` an int32 array, each cache a
    dict of its fields (bfloat16 widened to float32), with ``"kind"`` its
    class's name, from which the reference's dataclass is rebuilt."""
    def arr(t: torch.Tensor) -> np.ndarray:
        return (t.float() if t.dtype == torch.bfloat16 else t).detach().cpu().numpy()

    out = {"pos": arr(state["pos"])}
    for name, cache in state.items():
        if name != "pos":
            out[name] = {"kind": type(cache).__name__,
                         **{f.name: arr(getattr(cache, f.name)) for f in dataclasses.fields(cache)}}
    return out
