"""The one wall clock of the port's host-side timing.

``wallclock`` is monotonic (``time.perf_counter``): ``time.time()`` follows
NTP adjustments, so an interval measured across a clock step is wrong. The
fleet's deadlines and round times read it. Card time is measured with CUDA
events where a phase times kernels.
"""
from __future__ import annotations

import time

__all__ = ["wallclock"]


def wallclock() -> float:
    """Monotonic wall-clock seconds."""
    return time.perf_counter()
