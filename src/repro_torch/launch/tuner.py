"""Lane-capacity auto-tuner + kernel-launch crossover table.

A copy of the reference's ``repro.launch.tuner`` (no JAX inside it), with
three changes:

  * ``_is_oom`` also recognises ``torch.OutOfMemoryError`` by its type;
  * the default store is ``$REPRO_TORCH_TUNER_CACHE``, else
    ``~/.cache/repro_torch/tuner.json``, so the port's measurements on the
    card and the reference's stay in stores of their own;
  * the probes are the port's: ``engine.run_grid`` probes one chunk through
    the same chunk path its sweep takes (in graph mode the capture and the
    replays), and the kernel wrappers read the crossover table only where
    a caller passes it in (``kernels.ops.crossover(functools.partial(
    lane_dispatch, store=store))``).

``engine.run_grid``'s ``max_lanes_per_device`` bounds device memory by
streaming a sweep through equal-shaped chunks, but the capacity that is
safe and fast depends on the bucket's shapes, the device and the machine.
This module picks it automatically, in the style of a batch-size finder:

  * **power phase** — double the per-device capacity from 1, probing the
    bucket's actual chunk program each time, until the sweep is covered, a
    probe runs out of memory, or warm time per lane turns clearly past its
    minimum (the time-vs-capacity curve is convex: once per-lane time
    degrades the larger capacities only pad more);
  * **binary search** — on an OOM, bisect between the last good and the
    first failing capacity for the feasibility frontier;
  * the winner is the *fastest measured feasible* capacity (not merely the
    largest), cached per ``(bucket signature, device kind, device count)``
    in a small on-disk JSON store so the next sweep of the same bucket makes
    **zero re-probes** — a warm ``max_lanes_per_device="auto"`` call costs
    one dict lookup.

Because the per-lane math never depends on the chunk size (see
``engine.run_grid``), the auto-tuned result is **bitwise equal** to any
hand-picked capacity — tuning is purely a throughput decision.

The same store keeps the **crossover table** for the kernel wrappers: per
(op, lane-count bucket), whether the lane-batched launch or the per-lane
loop of single-lane launches measured faster. ``lane_dispatch`` answers
from the nearest measured bucket and falls back to ``"batched"`` — the
previous unconditional behavior — when nothing was ever measured. No code
of the port writes the table yet: its writer is the kernel benchmark,
which comes with the port's benchmark.

Store location: ``$REPRO_TORCH_TUNER_CACHE`` if set, else
``~/.cache/repro_torch/tuner.json``; tests point it at a tmp dir via
``set_store_path``.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import tempfile
from typing import Any, Callable

import torch

__all__ = [
    "SCHEMA_VERSION",
    "TunerStore",
    "get_store",
    "set_store_path",
    "reset_store",
    "tuner_stats",
    "reset_tuner_stats",
    "signature_key",
    "tune_lane_capacity",
    "auto_max_lanes",
    "record_crossover",
    "lane_dispatch",
]

SCHEMA_VERSION = 1

# Warm per-lane time is allowed to degrade this far past its running minimum
# before the power phase stops doubling: the capacity-vs-time curve is convex
# (too small => padding + per-chunk dispatch overhead, too large => cache and
# scheduler pressure), so one clear upturn ends the search.
_UPTURN_TOLERANCE = 1.25

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory", "OOM")


def _is_oom(exc: BaseException) -> bool:
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return any(marker in text for marker in _OOM_MARKERS)


def _default_store_path() -> str:
    env = os.environ.get("REPRO_TORCH_TUNER_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "tuner.json")


class TunerStore:
    """The on-disk JSON store: lane capacities + kernel crossover pairs.

    Schema (``schema_version`` 1)::

        {"schema_version": 1,
         "lane_capacity": {<sig-key>: {"capacity": int, "n_devices": int,
                                       "device_kind": str, "desc": str,
                                       "per_lane_s": {<cap>: float|null}}},
         "crossover":     {<op>: {<lanes>: {"batched_us": float,
                                            "loop_us": float}}}}

    A ``path`` of ``None`` keeps the store in memory only (probing still
    works; nothing persists).  A corrupt or version-mismatched file is
    discarded, not migrated — every entry is a re-derivable measurement.
    """

    def __init__(self, path: str | None):
        self.path = path
        self.data: dict[str, Any] = {
            "schema_version": SCHEMA_VERSION,
            "lane_capacity": {},
            "crossover": {},
        }
        if path is not None and os.path.exists(path):
            try:
                with open(path) as f:
                    loaded = json.load(f)
                if (
                    isinstance(loaded, dict)
                    and loaded.get("schema_version") == SCHEMA_VERSION
                ):
                    self.data["lane_capacity"] = dict(loaded.get("lane_capacity", {}))
                    self.data["crossover"] = dict(loaded.get("crossover", {}))
            except (OSError, ValueError):
                pass  # unreadable/corrupt: start fresh, overwrite on save

    def save(self) -> None:
        if self.path is None:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        # atomic replace: a concurrent reader never sees a torn file
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(self.path) or ".", suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # -- lane capacity ------------------------------------------------------
    def capacity_for(self, sig_key: str) -> int | None:
        rec = self.data["lane_capacity"].get(sig_key)
        return int(rec["capacity"]) if rec else None

    def record_capacity(self, sig_key: str, record: dict[str, Any]) -> None:
        self.data["lane_capacity"][sig_key] = record
        self.save()

    # -- kernel-launch crossover -------------------------------------------
    def crossover_for(self, op: str, lanes: int) -> dict[str, float] | None:
        """The measured (batched_us, loop_us) pair at the nearest recorded
        lane bucket for ``op`` (log-distance), or ``None`` if unmeasured."""
        table = self.data["crossover"].get(op)
        if not table:
            return None
        target = math.log2(max(1, lanes))
        nearest = min(table, key=lambda k: abs(math.log2(max(1, int(k))) - target))
        return table[nearest]

    def record_crossover(
        self, op: str, lanes: int, batched_us: float, loop_us: float
    ) -> None:
        self.data["crossover"].setdefault(op, {})[str(int(lanes))] = {
            "batched_us": float(batched_us),
            "loop_us": float(loop_us),
        }
        self.save()


_STORE: TunerStore | None = None
_STATS = {"probes": 0, "hits": 0, "misses": 0}


def get_store() -> TunerStore:
    """The process-wide store (created lazily from the default path)."""
    global _STORE
    if _STORE is None:
        _STORE = TunerStore(_default_store_path())
    return _STORE


def set_store_path(path: str | None) -> TunerStore:
    """Point the process-wide store at ``path`` (``None`` = in-memory only)
    and return the fresh store.  Tests use this to isolate from the user
    cache; it also resets the probe/hit counters."""
    global _STORE
    _STORE = TunerStore(path)
    reset_tuner_stats()
    return _STORE


def reset_store() -> None:
    """Drop the process-wide store; the next ``get_store()`` re-creates it
    from the default path (undoes a test's ``set_store_path``)."""
    global _STORE
    _STORE = None
    reset_tuner_stats()


def tuner_stats() -> dict[str, int]:
    """Counters since the last reset: ``probes`` (chunk-program timings
    run), ``hits`` / ``misses`` (store lookups).  The zero-re-probe guarantee
    of a warm ``"auto"`` sweep is asserted on ``probes``."""
    return dict(_STATS)


def reset_tuner_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0


def signature_key(signature: Any) -> str:
    """Stable store key for a bucket signature: sha1 of ``repr(signature)``.

    The signature must capture everything the capacity decision depends on —
    per-lane shapes/dtypes, protocol structure, scan length, shard mode,
    device kind and count (``engine.run_grid`` builds it; lane count itself
    is deliberately excluded so sweeps of different sizes share one tuning).
    """
    return hashlib.sha1(repr(signature).encode()).hexdigest()[:20]


def tune_lane_capacity(
    probe: Callable[[int], float],
    *,
    n_lanes: int,
    n_devices: int,
    max_capacity: int | None = None,
) -> tuple[int, dict[int, float | None]]:
    """Power-then-binary-search for the fastest feasible per-device capacity.

    ``probe(c)`` must run ONE chunk of ``c * n_devices`` lanes through the
    bucket's chunk program and return warm seconds per call; it raises on
    OOM (a ``torch.OutOfMemoryError``, or any exception whose text carries a
    resource-exhausted marker, counts as "this capacity does not fit" —
    everything else propagates).

    Returns ``(capacity, measured)`` where ``measured`` maps every probed
    capacity to its per-lane seconds (``None`` = OOM at that capacity).
    Raises ``RuntimeError`` if even capacity 1 does not fit.
    """
    if n_lanes < 1 or n_devices < 1:
        raise ValueError(f"need n_lanes>=1, n_devices>=1; got {n_lanes}, {n_devices}")
    cap = -(-n_lanes // n_devices)  # chunks beyond the sweep only add padding
    if max_capacity is not None:
        cap = min(cap, max_capacity)
    measured: dict[int, float | None] = {}

    def try_cap(c: int) -> float | None:
        _STATS["probes"] += 1
        try:
            t = probe(c)
        except Exception as exc:  # noqa: BLE001 — OOM is data, not failure
            if not _is_oom(exc):
                raise
            measured[c] = None
            return None
        per_lane = float(t) / (c * n_devices)
        measured[c] = per_lane
        return per_lane

    best_c, best_t = 0, math.inf
    last_good, first_bad = 0, 0
    c = 1
    while c <= cap:  # power phase: 1, 2, 4, ... (clamped to the sweep)
        t = try_cap(c)
        if t is None:
            first_bad = c
            break
        last_good = c
        if t < best_t:
            best_c, best_t = c, t
        elif t > best_t * _UPTURN_TOLERANCE:
            break  # clearly past the minimum; stop doubling
        if c == cap:
            break
        c = min(c * 2, cap)

    if first_bad and last_good:  # bisect the OOM frontier
        lo, hi = last_good, first_bad
        while hi - lo > 1:
            mid = (lo + hi) // 2
            t = try_cap(mid)
            if t is None:
                hi = mid
            else:
                lo = mid
                if t < best_t:
                    best_c, best_t = mid, t

    if not best_c:
        raise RuntimeError(
            f"lane-capacity tuning failed: capacity 1 x {n_devices} device(s) "
            "already exhausts memory — the bucket does not fit this machine"
        )
    return best_c, measured


def auto_max_lanes(
    probe: Callable[[int], float],
    *,
    n_lanes: int,
    n_devices: int,
    signature: Any,
    device_kind: str = "",
    store: TunerStore | None = None,
) -> int:
    """Resolve ``max_lanes_per_device="auto"``: cached capacity if the store
    has this (signature, device kind, device count), else tune and record.

    The cached value is clamped to ``ceil(n_lanes / n_devices)`` — a capacity
    tuned on a bigger sweep would otherwise just pad a smaller one (bitwise
    results are unaffected either way; see ``engine.run_grid``).
    """
    store = store if store is not None else get_store()
    key = signature_key((signature, device_kind, n_devices))
    cap_ceil = -(-n_lanes // n_devices)
    cached = store.capacity_for(key)
    if cached is not None:
        _STATS["hits"] += 1
        return max(1, min(cached, cap_ceil))
    _STATS["misses"] += 1
    capacity, measured = tune_lane_capacity(
        probe, n_lanes=n_lanes, n_devices=n_devices
    )
    store.record_capacity(
        key,
        {
            "capacity": int(capacity),
            "n_devices": int(n_devices),
            "device_kind": str(device_kind),
            "desc": repr(signature)[:400],
            "per_lane_s": {str(c): t for c, t in sorted(measured.items())},
        },
    )
    return capacity


def record_crossover(
    op: str,
    lanes: int,
    batched_us: float,
    loop_us: float,
    store: TunerStore | None = None,
) -> None:
    """Record one measured (lane-batched launch, per-lane loop) timing pair
    for ``op`` (a ``kernels.ops.KERNELS`` counter name) at ``lanes``."""
    (store if store is not None else get_store()).record_crossover(
        op, lanes, batched_us, loop_us
    )


def lane_dispatch(op: str, lanes: int, store: TunerStore | None = None) -> str:
    """``"batched"`` or ``"loop"``: which launch strategy measured faster for
    ``op`` at the nearest recorded lane count.

    Falls back to ``"batched"`` — the always-lane-batch behavior this table
    replaces — when the op was never measured, so an empty store reproduces
    the previous dispatch exactly.
    """
    rec = (store if store is not None else get_store()).crossover_for(op, lanes)
    if rec is None:
        return "batched"
    return "loop" if rec["loop_us"] < rec["batched_us"] else "batched"
