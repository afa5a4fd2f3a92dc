"""The port's timers: ``wallclock`` for the host, ``block_time`` for a call.

``wallclock`` is monotonic (``time.perf_counter``): ``time.time()`` follows
NTP adjustments, so an interval measured across a clock step is wrong. The
fleet's deadlines and round times read it.

``block_time`` is the counterpart of the reference's: the mean seconds of a
call, waiting for each call to finish. On a CUDA device it times each call
with a pair of CUDA events on the current stream, so the card's time is
measured, host gaps between its kernels included; on the CPU it reads
``wallclock``.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

__all__ = ["wallclock", "block_time"]


def wallclock() -> float:
    """Monotonic wall-clock seconds."""
    return time.perf_counter()


def _device_of(args: tuple) -> torch.device:
    """The device of the first tensor among ``args`` (the CPU when none is)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def block_time(fn: Callable[..., Any], *args: Any, iters: int = 1, warmup: int = 1,
               device: torch.device | str | None = None) -> float:
    """Mean seconds per call of ``fn(*args)`` over ``iters`` calls, after
    ``warmup`` untimed calls (first-use builds, allocations, captures).

    ``device`` says whose clock: a CUDA device synchronises before the timed
    calls and times each with CUDA events, waiting for it to finish; the CPU
    times each call on ``wallclock``. When not given, the device of the
    first tensor argument, else the CPU.
    """
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    dev = torch.device(device) if device is not None else _device_of(args)
    for _ in range(warmup):
        fn(*args)
    if dev.type != "cuda":
        total = 0.0
        for _ in range(iters):
            t0 = wallclock()
            fn(*args)
            total += wallclock() - t0
        return total / iters
    torch.cuda.synchronize(dev)
    total_ms = 0.0
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        fn(*args)
        end.record(torch.cuda.current_stream(dev))
        end.synchronize()
        total_ms += start.elapsed_time(end)
    return total_ms / iters / 1e3
