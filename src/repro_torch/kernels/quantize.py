"""QSGD stochastic quantization on the card: ``csrc/quantize.cu``.

Replaces ``src/repro/kernels/quantize.py::stochastic_quantize_pallas_lanes``.
The kernel is bound by bytes (one read of g and of the rounding draws u, one
write of the output). Its (row, quantization block) pairs are one flat
range, so any row count is one launch; ``quant_plan`` gives a block of at
most ``WARP_MAX_CHUNK`` coordinates one warp (its max-abs from shuffles
alone) where the blocks are many, and a thread block otherwise. Either
takes the block's max-abs and then quantizes it with IEEE divisions, so
kernel and ``plain`` agree bitwise. A row's ragged last block is masked in the kernel, not padded.
``plain`` is the version the wrapper runs on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import stochastic_quantize_ref

__all__ = ["launch", "plain", "quant_plan", "WARP_MAX_CHUNK", "WARP_LEAST_BLOCKS"]

WARP_MAX_CHUNK = 512  # csrc/quantize.cu's kWarpMaxChunk: the longest block the warp layout takes
WARP_LEAST_BLOCKS = 2000  # fewer blocks take the thread block (scripts/torch_quant_layouts.py)


def quant_plan(rows: int, q: int, chunk: int) -> bool:
    """Whether ``csrc/quantize.cu`` quantizes ``rows`` rows of Q in blocks
    of ``chunk`` coordinates a warp a block (True) or a thread block a
    block (False): a warp up to ``WARP_MAX_CHUNK`` coordinates where the
    blocks number at least ``WARP_LEAST_BLOCKS``, else the thread block.
    On the paths users run, the warp takes quant:4 over a 1,000-lane
    ``synthetic_sweep`` at N = 100 (100,000 blocks of 100); the thread
    block takes a quant:4 trajectory and the paper grid's quant:4 buckets
    (100 and 200 blocks of 100), and the LM's blocks of 1,024. A few blocks
    are latency-bound: a warp's thread quantizes four or more coordinates
    one after another where a thread block's quantizes one.
    ``scripts/torch_quant_layouts.py`` times both layouts through the C
    entry on both sides of the threshold: on an H100 at 700 W the thread
    block was ahead or level at 1,000 blocks and fewer (by 5-6 % at 528
    blocks of 100, 10-13 % of 256, 25-33 % of 512), the warp ahead from
    1,500 blocks of 100 or 256 but level with the thread block at 2,000
    blocks of 512, and 2.5x ahead at 100,000 blocks of 100; at 2,000 and
    more it is ahead or level for every chunk up to 512."""
    if rows < 1 or q < 1 or chunk < 1:
        raise ValueError(f"quant_plan: rows={rows}, q={q}, chunk={chunk}")
    return chunk <= WARP_MAX_CHUNK and rows * -(-q // chunk) >= WARP_LEAST_BLOCKS


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
    into ``out`` when given; one launch for any L, in ``quant_plan``'s
    layout."""
    lanes, q = g.shape
    out = torch.empty_like(g) if out is None else out
    err = _build.library("quantize")(
        g.data_ptr(), u.data_ptr(), out.data_ptr(), lanes, q, block, levels, int(quant_plan(lanes, q, block)),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {err}")
    return out
