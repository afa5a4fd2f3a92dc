"""The launch plans of CWTM-NNM's mix and of QSGD (``csrc/cwtm.cu``,
``csrc/quantize.cu``), checked on the CPU.

The kernels run only on the card (``tests/test_torch_card.py``); here the
Python plans the wrappers pass them are held to what the kernels need:

  * ``cwtm.mix_plan`` deals every (lane, row, column) of the mix to
    exactly one thread's item (``_mix_cover`` replays the kernel's index
    arithmetic), in tiles of whole 16-byte groups, with a block's staged
    originals, masks and table (then its mixed tile) inside the 227 KB a
    Hopper block may use, and a thread for each of its columns' sorts;
  * QSGD's grid is flat over (row, block): 100,000 rows are one launch of
    its work, whichever layout ``quantize.quant_plan`` picks;
  * the plans and the CUDA sources agree on their constants.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import cwtm as tcwtm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import tiles

CSRC = Path(tcwtm.__file__).resolve().parent.parent / "csrc"
MIX_N = [13, 16, 33, 64, 100, 128]
MIX_Q = [1, 3, 4, 28, 100, 101, 129, 4097]
MIX_LANES = [1, 3, 131, 1000]


def _constant(source: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = ([^;]+);", (CSRC / source).read_text()).group(1)
               .replace("kNetMaxN / 32", str(tcwtm.NET_MAX_N // 32)))


def _mix_cover(plan: tcwtm.MixPlan, lanes: int, n: int, q: int) -> np.ndarray:
    """How many times the mix-and-sort kernel mixes each (lane, row, column)
    under ``plan``: its index arithmetic (block -> lane and
    tile, item -> row group and 4-column group, the ragged tile's columns
    masked) replayed on the CPU. Every entry is 1 for a sound plan."""
    count = np.zeros((lanes, n, q), dtype=np.int64)
    for block in range(lanes * plan.tiles):
        lane, tile = divmod(block, plan.tiles)
        c0 = tile * plan.cols
        width = min(plan.cols, q - c0)
        groups = -(-width // 4)
        for item in range(-(-n // tcwtm.MIX_ROWS) * groups):  # the block's threads take items t, t + threads, ...
            r0, g = item // groups * tcwtm.MIX_ROWS, item % groups
            r1, cols = min(r0 + tcwtm.MIX_ROWS, n), range(c0 + 4 * g, c0 + min(4 * g + 4, width))
            count[lane, r0:r1, cols.start:cols.stop] += 1
    return count


def test_plans_carry_the_kernels_constants():
    assert _constant("cwtm.cu", "kRegMaxN") == tcwtm.REG_MAX_N
    assert _constant("cwtm.cu", "kNetMaxN") == tcwtm.NET_MAX_N
    assert _constant("cwtm.cu", "kMixRows") == tcwtm.MIX_ROWS
    assert _constant("cwtm.cu", "kMixStep") == tcwtm.MIX_STEP
    assert _constant("cwtm.cu", "kMixWords") == tcwtm.MIX_WORDS
    assert _constant("cwtm.cu", "kMixMaxCols") == tcwtm.MIX_MAX_COLS
    assert _constant("cwtm.cu", "kMixMaxThreads") == tcwtm.MIX_MAX_THREADS
    assert _constant("quantize.cu", "kWarpMaxChunk") == tquant.WARP_MAX_CHUNK


@pytest.mark.parametrize("n", MIX_N)
def test_mix_plan_covers_every_value_once_and_fits(n):
    """Each (lane, row, column) written once, for every lane count's plan
    (replayed on up to 2 lanes: lanes are alike); whole 16-byte column
    groups, a thread for each column of the tile's sorts, and the staged
    tile, masks and table or mixed tile inside a block's shared memory (at
    k = N, the largest table; the tiling does not depend on k)."""
    for q in MIX_Q:
        for lanes in MIX_LANES:
            plan = tcwtm.mix_plan(lanes, n, q)
            assert plan.cols % 4 == 0 and 4 <= plan.cols <= tcwtm.MIX_MAX_COLS, (lanes, q, plan)
            assert (plan.tiles - 1) * plan.cols < q <= plan.tiles * plan.cols
            assert plan.threads % 32 == 0 and 32 <= plan.threads <= tcwtm.MIX_MAX_THREADS
            assert plan.threads >= plan.cols
            rows = -(-n // tcwtm.MIX_STEP) * tcwtm.MIX_STEP
            assert plan.smem == 4 * (rows * (plan.cols + tcwtm.MIX_WORDS) + n * max(n, plan.cols)) <= tiles.SMEM_MAX
            assert tcwtm.mix_plan(lanes, n, q, 1)[:3] == plan[:3]
            assert np.array_equal(_mix_cover(plan, min(lanes, 2), n, q), np.ones((min(lanes, 2), n, q)))
    with pytest.raises(ValueError):
        tcwtm.mix_plan(1, tcwtm.REG_MAX_N, 100)
    with pytest.raises(ValueError):
        tcwtm.mix_plan(1, tcwtm.NET_MAX_N + 1, 100)
    with pytest.raises(ValueError):
        tcwtm.mix_plan(1, 100, 100, 101)


def test_mix_plan_at_the_papers_shape():
    """N = Q = 100: a lane's 100 columns in 7 tiles of 16 columns and 256
    threads at 1 and 4 lanes (the blocks spread over SMs), one tile of 128
    threads a lane at 1,000 lanes (two blocks an SM), the mixed tile over
    the table."""
    assert tcwtm.mix_plan(1, 100, 100, 80) == (16, 7, 256, 4 * (104 * 20 + 8000))
    assert tcwtm.mix_plan(4, 100, 100, 80) == tcwtm.mix_plan(1, 100, 100, 80)
    assert tcwtm.mix_plan(1000, 100, 100, 80) == (100, 1, 128, 4 * (104 * 104 + 10000))


def test_quantize_launches_100000_rows_once():
    """quant:4's blocks of 100 coordinates at 1,000 lanes x N = 100 rows:
    one launch of its work (the CPU logs the launches the card would make),
    the plan a warp a block; a block past ``WARP_MAX_CHUNK`` coordinates
    (the LM's 1,024), or few blocks (a trajectory's 100 rows, the paper
    grid's quant:4 bucket of 2 lanes), take a thread block."""
    g = torch.randn((100_000, 8))
    u = torch.rand((100_000, 8))
    with tops.record_launches() as log:
        got = tops.stochastic_quantize(g, u, 4, 1024)
    assert [(e["kernel"], e["lanes"], e["q"]) for e in log] == [("quantize", 100_000, 8)]
    assert log[0]["bytes"] == 4.0 * 3 * 100_000 * 8
    assert torch.equal(got, tquant.plain(g, u, 4, 8))
    assert tquant.quant_plan(100_000, 100, 100)
    assert not tquant.quant_plan(100, 100, 100) and not tquant.quant_plan(200, 100, 100)
    assert tquant.quant_plan(8, 361_821_120, tquant.WARP_MAX_CHUNK)
    assert not tquant.quant_plan(8, 361_821_120, tquant.WARP_MAX_CHUNK + 1)
    assert not tquant.quant_plan(8, 361_821_120, 1024)
