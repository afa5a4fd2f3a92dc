"""Byzantine attack construction on the card: ``csrc/attack.cu``.

Replaces ``src/repro/kernels/attacks.py::attack_pallas_lanes``. The kernel
is bound by bytes (one read of the (L, N, Q) stack, one write of the
output). Sign-flip is a flat elementwise pass; for ALIE and IPM a block
stages a lane's (N, C) column tile in shared memory once (``attack_tile``
picks C) and sums the honest statistics over N as ``numerics.tree_sum``'s
tree, across its threads, before it writes the rows. The output is a new
tensor. ``plain`` is the version the wrapper runs on the CPU; the kernel
repeats its arithmetic in its order, so the two agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, tiles
from repro_torch.kernels.ref import attack_ref as plain

__all__ = ["launch", "attack_tile", "plain", "KERNEL_ATTACK_PARAMS"]

# attack name -> (kernel mode, the AttackSpec field that is its scalar)
_MODES = {"sign_flip": (0, "coeff"), "alie": (1, "z"), "ipm": (2, "eps")}
KERNEL_ATTACK_PARAMS = {name: field for name, (_, field) in _MODES.items()}


REG_MAX_N = 16  # up to this N the kernel's trees run in registers (``csrc/attack.cu``'s kRegMaxN)


def attack_tile(lanes: int, n: int, q: int) -> int:
    """ALIE's and IPM's tile width C (``tiles.tile_width``): a block holds
    the (N, C) tile, the statistic's C values and N honest weights in shared
    memory, and above ``REG_MAX_N`` rows the tree's P / 2 levels of C + 1
    values (P the next power of two >= N; the extra column is the honest
    count). 0 where not even one column fits."""
    half = 0 if n <= REG_MAX_N else (1 << (n - 1).bit_length()) // 2
    return tiles.tile_width(lanes, q, 4 * (n + 1 + half), 4 * (n + half), least=1)


def launch(msgs: torch.Tensor, mask: torch.Tensor, name: str, param: float,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """msgs (L, N, Q) f32, mask (L, N) f32, contiguous on one CUDA device
    -> (L, N, Q) transmitted stack, written into ``out`` when given."""
    lanes, n, q = msgs.shape
    out = torch.empty_like(msgs) if out is None else out
    mode = _MODES[name][0]
    cols = 0 if name == "sign_flip" else attack_tile(lanes, n, q)
    if mode and not cols:
        raise ValueError(f"attack kernel: N = {n} leaves no column tile in shared memory")
    err = _build.library("attack")(
        msgs.data_ptr(), mask.data_ptr(), out.data_ptr(), lanes, n, q,
        mode, float(param), cols, torch.cuda.current_stream(msgs.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"attack kernel launch failed: CUDA error {err}")
    return out
