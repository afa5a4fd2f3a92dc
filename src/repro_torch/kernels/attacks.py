"""Byzantine attack construction on the card: ``csrc/attack.cu``.

Replaces ``src/repro/kernels/attacks.py::attack_pallas_lanes``. The kernel
is bound by bytes (one read of the (L, N, Q) stack, one write of the
output); one thread owns a coordinate and computes the honest mean and
(ALIE) variance over N itself, in a fixed order, before it writes the rows.
The output is a new tensor. ``plain`` is the version the wrapper runs on
the CPU; it sums over N as a fixed tree, the kernel in row order, so the two
agree to fp32 rounding.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attack_ref as plain

__all__ = ["launch", "plain", "KERNEL_ATTACK_PARAMS"]

# attack name -> (kernel mode, the AttackSpec field that is its scalar)
_MODES = {"sign_flip": (0, "coeff"), "alie": (1, "z"), "ipm": (2, "eps")}
KERNEL_ATTACK_PARAMS = {name: field for name, (_, field) in _MODES.items()}


def launch(msgs: torch.Tensor, mask: torch.Tensor, name: str, param: float,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """msgs (L, N, Q) f32, mask (L, N) f32, contiguous on one CUDA device
    -> (L, N, Q) transmitted stack, written into ``out`` when given."""
    lanes, n, q = msgs.shape
    out = torch.empty_like(msgs) if out is None else out
    err = _build.library("attack")(
        msgs.data_ptr(), mask.data_ptr(), out.data_ptr(), lanes, n, q,
        _MODES[name][0], float(param), torch.cuda.current_stream(msgs.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"attack kernel launch failed: CUDA error {err}")
    return out
