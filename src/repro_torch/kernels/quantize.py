"""QSGD stochastic quantization on the card: ``csrc/quantize.cu``.

Replaces ``src/repro/kernels/quantize.py::stochastic_quantize_pallas_lanes``.
The kernel is bound by bytes (one read of g and of the rounding draws u, one
write of the output); one thread block per (lane, quantization block) takes
the block's max-abs and then quantizes it with IEEE divisions, so kernel and
``plain`` agree bitwise. A row's ragged last block is masked in the kernel,
not padded. ``plain`` is the version the wrapper runs on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import stochastic_quantize_ref

__all__ = ["launch", "plain"]


def plain(g: torch.Tensor, u: torch.Tensor, levels: int, block: int) -> torch.Tensor:
    """g, u (L, Q) -> (L, Q), blocks of ``block`` coordinates along each
    row; the ragged last block is zero-padded, which changes no scale (a
    zero never wins the max-abs), and cut off again."""
    q = g.shape[-1]
    pad = (-q) % block
    if pad:
        g = torch.nn.functional.pad(g, (0, pad))
        u = torch.nn.functional.pad(u, (0, pad))
    return stochastic_quantize_ref(g, u, levels, block)[..., :q].contiguous()


def launch(g: torch.Tensor, u: torch.Tensor, levels: int, block: int,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """g, u (L, Q) f32, contiguous on one CUDA device -> (L, Q), written
    into ``out`` when given."""
    lanes, q = g.shape
    out = torch.empty_like(g) if out is None else out
    err = _build.library("quantize")(
        g.data_ptr(), u.data_ptr(), out.data_ptr(), lanes, q, block, levels,
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {err}")
    return out
