"""State carried between the JAX reference and the port, as numpy arrays.

``state_from_numpy`` turns the reference's trainer state (the iterate, the
SGD step count, the problem ``(Z, y)``, optionally ``x_star`` and, under
partial participation, the schedule state: the previous ``(N,)`` mask) into
the port's tensors on a chosen device; ``result_to_numpy`` turns a
``TrajectoryResult`` back. Both sides then start from identical state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import TrajectoryResult
from repro_torch.optim import OptState

__all__ = ["TrainerState", "state_from_numpy", "result_to_numpy"]


@dataclasses.dataclass(frozen=True)
class TrainerState:
    x: torch.Tensor
    opt_state: OptState
    z: torch.Tensor
    y: torch.Tensor
    x_star: torch.Tensor | None = None
    participation_state: torch.Tensor | None = None


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def state_from_numpy(x, step, z, y, x_star=None, participation_state=None, *,
                     device: torch.device | str) -> TrainerState:
    """The reference's state (numpy arrays and an int step) on ``device``."""
    return TrainerState(
        x=_tensor(x, device),
        opt_state=OptState(step=int(step)),
        z=_tensor(z, device),
        y=_tensor(y, device),
        x_star=None if x_star is None else _tensor(x_star, device),
        participation_state=None if participation_state is None else _tensor(participation_state, device),
    )


def result_to_numpy(res: TrajectoryResult) -> dict[str, np.ndarray]:
    """``{"x": ..., "step": ..., <metric>: ...}`` as numpy arrays, plus
    ``"participation_state"`` under partial participation."""
    out = {"x": res.x.detach().cpu().numpy(), "step": np.asarray(res.opt_state.step)}
    if res.participation_state is not None:
        out["participation_state"] = res.participation_state.detach().cpu().numpy()
    out.update({k: v.detach().cpu().numpy() for k, v in res.metrics.items()})
    return out
