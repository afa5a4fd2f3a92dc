"""Time QSGD's two layouts through their C entry, on the card.

``csrc/quantize.cu`` quantizes a block of coordinates a warp (up to
``quantize.WARP_MAX_CHUNK`` coordinates) or a thread block, as
``kernels/quantize.py::quant_plan`` picks from the block count and the
chunk; neither changes the bits, only the time. This script calls
``repro_quantize`` with each layout:

  * quant:4's blocks of 100 (Q = 100, 4 levels) at row counts on both
    sides of ``quant_plan``'s ``WARP_LEAST_BLOCKS``: a trajectory's 100
    rows, the paper grid's quant:4 bucket of 2 lanes (200), up to a
    1,000-lane sweep's 100,000;
  * blocks of 256 and 512 coordinates (the warp's longest) at 100 to
    100,000 blocks, and one long row stack (8 rows of 2^25) at chunks 256,
    512 and, for the thread block alone, 1,024.

It prints one JSON line a shape: the median CUDA-event ms of 20 calls of
each layout, the L2 (50 MB) flushed before each, the layout the plan picks,
every output held bit for bit to ``quantize.plain``, and the card's
``nvidia-smi`` name and power limit::

    PYTHONPATH=src python3 scripts/torch_quant_layouts.py
"""
from __future__ import annotations

import json
import statistics
import subprocess

import torch

from repro_torch.kernels import _build, quantize

LEVELS = 4
FLUSH_BYTES = 1 << 28
CHUNK_100_ROWS = (100, 200, 300, 400, 528, 700, 1000, 1500, 2000, 5000, 10_000, 100_000)
LONG_CHUNK_BLOCKS = (100, 528, 1000, 1500, 2000, 100_000)
STACK = (8, 1 << 25)


def timed(fn, flush: torch.Tensor, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    entry = _build.library("quantize")
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def shape(rows: int, q: int, chunk: int) -> None:
        g = torch.randn((rows, q), generator=gen, device="cuda") * 3
        u = torch.rand((rows, q), generator=gen, device="cuda")
        out = torch.empty_like(g)
        want = quantize.plain(g, u, LEVELS, chunk)

        def call(warp: bool) -> None:
            err = entry(g.data_ptr(), u.data_ptr(), out.data_ptr(), rows, q, chunk, LEVELS, int(warp), stream)
            if err:
                raise RuntimeError(f"quantize: CUDA error {err}")

        line = {"rows": rows, "q": q, "chunk": chunk, "blocks": rows * -(-q // chunk), "nvidia_smi": smi,
                "plan": "warp" if quantize.quant_plan(rows, q, chunk) else "block", "ms": {}}
        for layout in ("warp", "block") if chunk <= quantize.WARP_MAX_CHUNK else ("block",):
            line["ms"][layout] = timed(lambda: call(layout == "warp"), flush)
            if not torch.equal(out, want):
                raise AssertionError(f"QSGD's {layout} layout differs from quantize.plain at {line}")
        print(json.dumps(line), flush=True)

    for rows in CHUNK_100_ROWS:
        shape(rows, 100, 100)
    for chunk in (256, 512):
        for blocks in LONG_CHUNK_BLOCKS:
            shape(blocks, chunk, chunk)
    for chunk in (256, 512, 1024):
        shape(*STACK, chunk)


if __name__ == "__main__":
    main()
