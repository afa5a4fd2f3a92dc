"""Deterministic fault injection for the multi-process fleet.

A chaos schedule is a *seeded, declarative* list of faults, each scoped to
one worker process and an explicit set of rounds::

    {"seed": 7, "faults": [
        {"op": "corrupt",   "proc": 2, "rounds": [2, 3]},
        {"op": "delay",     "proc": 1, "rounds": [1],    "arg": 0.2},
        {"op": "partition", "proc": 2, "rounds": [4],    "arg": 0.5},
    ]}

Ops (applied to the worker's outgoing ``K_ROWS`` frame for that round):

  * ``drop``      — the frame is silently never sent (a lost packet: the
                    server erases the block at the round deadline).
  * ``delay``     — sleep ``arg`` seconds before sending (a straggler).
  * ``dup``       — send the frame twice (a confused retransmit; the server
                    must tolerate the duplicate).
  * ``corrupt``   — flip bytes of the encoded frame before sending
                    (``corrupt_bytes``; the server's CRC/shape validation
                    must turn this into a per-round erasure, never a crash).
  * ``byz_payload`` — flip bytes of the *payload's structural header* and
                    re-seal the frame CRC (``byz_payload_bytes``): a
                    Byzantine worker sending a well-framed lie, not line
                    noise.  The CRC passes; the codec-level shape/payload
                    validation (dense or compressed) must reject it as a
                    tallied per-round erasure.
  * ``partition`` — close the connection without sending, stay dark for
                    ``arg`` seconds, then rejoin through the worker's
                    reconnect-with-backoff loop.
  * ``kill``      — hard-exit the worker process (``os._exit(17)``, the same
                    exit code as the fleet's ``--die-after-round`` hook).

Everything is deterministic: which bytes ``corrupt`` flips is derived from
``(seed, proc, round, op)`` via :func:`fault_rng`, never from wall clock or
global RNG state.  A schedule with **no faults is a byte-exact pass-through**
— ``ChaosTransport.send`` calls ``sock.sendall(frame)`` on the untouched
frame bytes, which is what makes "all-healthy chaos fleet == plain fleet"
testable at the byte level (``tests/test_torch_fleet.py``). The same seeds
give the same faults on the same frames as the JAX package's
``launch/chaos.py``.

This module is stdlib-only (no torch, no numpy), so a schedule is parsed and
checked without touching the card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import struct
import time
import zlib

__all__ = [
    "OPS",
    "Fault",
    "ChaosSpec",
    "ChaosTransport",
    "parse_chaos",
    "fault_rng",
    "corrupt_bytes",
    "byz_payload_bytes",
]

OPS = ("drop", "delay", "dup", "corrupt", "byz_payload", "partition", "kill")

_FAULT_KEYS = {"op", "proc", "rounds", "arg"}
_SPEC_KEYS = {"seed", "faults"}


@dataclasses.dataclass(frozen=True)
class Fault:
    """One fault: ``op`` applied to worker ``proc`` on each round in ``rounds``.

    ``arg`` is the op's scalar parameter (seconds for delay/partition;
    ignored by the others).
    """

    op: str
    proc: int
    rounds: tuple[int, ...]
    arg: float = 0.0

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown chaos op {self.op!r}; known: {OPS}")
        if self.proc < 1:
            raise ValueError(f"chaos proc must be a worker id >= 1, got {self.proc}")
        if not self.rounds or any(int(r) < 0 for r in self.rounds):
            raise ValueError(f"chaos rounds must be a non-empty list of rounds >= 0, got {self.rounds!r}")
        if self.arg < 0:
            raise ValueError(f"chaos arg must be >= 0, got {self.arg}")

    def active(self, proc: int, t: int) -> bool:
        return proc == self.proc and t in self.rounds


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """A full seeded schedule; ``ops_for(proc, t)`` is the per-send view."""

    seed: int = 0
    faults: tuple[Fault, ...] = ()

    def ops_for(self, proc: int, t: int) -> dict[str, Fault]:
        return {f.op: f for f in self.faults if f.active(proc, t)}

    def to_json(self) -> str:
        return json.dumps(
            {
                "seed": self.seed,
                "faults": [
                    {"op": f.op, "proc": f.proc, "rounds": list(f.rounds), "arg": f.arg}
                    for f in self.faults
                ],
            },
            sort_keys=True,
        )


def parse_chaos(src) -> ChaosSpec:
    """Build a :class:`ChaosSpec` from a dict, a JSON string, or a file path."""
    if isinstance(src, ChaosSpec):
        return src
    if isinstance(src, str):
        s = src.strip()
        if s.startswith("{"):
            obj = json.loads(s)
        else:
            with open(s) as f:
                obj = json.load(f)
    elif isinstance(src, dict):
        obj = src
    else:
        raise TypeError(f"chaos schedule must be dict/JSON/path, got {type(src).__name__}")
    unknown = set(obj) - _SPEC_KEYS
    if unknown:
        raise ValueError(f"unknown chaos schedule keys: {sorted(unknown)}")
    faults = []
    for f in obj.get("faults", ()):
        bad = set(f) - _FAULT_KEYS
        if bad:
            raise ValueError(f"unknown chaos fault keys: {sorted(bad)}")
        faults.append(
            Fault(
                op=f["op"],
                proc=int(f["proc"]),
                rounds=tuple(int(r) for r in f["rounds"]),
                arg=float(f.get("arg", 0.0)),
            )
        )
    return ChaosSpec(seed=int(obj.get("seed", 0)), faults=tuple(faults))


def fault_rng(seed: int, proc: int, t: int, op: str) -> random.Random:
    """The deterministic RNG for one (schedule, proc, round, op) event."""
    return random.Random(zlib.crc32(f"{seed}:{proc}:{t}:{op}".encode()))


def corrupt_bytes(data: bytes, rng: random.Random, n_flips: int = 4) -> bytes:
    """Flip ``n_flips`` bytes of ``data`` (each XORed with a nonzero mask)."""
    if not data:
        return data
    buf = bytearray(data)
    for _ in range(min(n_flips, len(buf))):
        i = rng.randrange(len(buf))
        buf[i] ^= 1 + rng.randrange(255)
    return bytes(buf)


# the fleet's frame header (kept in step with launch/fleet.py by
# tests/test_torch_fleet.py; repeated here so this module stays stdlib-only)
_FRAME = struct.Struct("!4sBBII")  # magic, version, kind, crc32(payload), len


def byz_payload_bytes(frame: bytes, rng: random.Random, n_flips: int = 2) -> bytes:
    """Corrupt the payload's structural header *and re-seal the CRC*.

    Unlike ``corrupt_bytes`` (line noise the CRC catches), this models a
    Byzantine worker: the frame stays perfectly well-formed — magic, version,
    CRC all valid — but the payload lies.  Flips land in payload bytes
    [8, 14): just past the 8-byte round header, the region where both row
    codecs declare their shape (the dense path's dtype/ndim/dims, the
    compressed path's rows/q header), so the server's *codec-level*
    validation must reject it deterministically (``wrong_shape`` /
    ``bad_payload``), never the CRC check.
    """
    if len(frame) <= _FRAME.size + 8:
        return frame  # too short to carry a row payload: pass through
    magic, ver, kind, _, _ = _FRAME.unpack_from(frame, 0)
    payload = bytearray(frame[_FRAME.size :])
    lo, hi = 8, min(14, len(payload))
    for _ in range(n_flips):
        i = lo + rng.randrange(hi - lo)
        payload[i] ^= 1 + rng.randrange(255)
    payload = bytes(payload)
    return _FRAME.pack(magic, ver, kind, zlib.crc32(payload), len(payload)) + payload


class ChaosTransport:
    """Applies a schedule to one worker's outgoing row frames.

    ``send`` returns ``(status, arg)`` with status in ``"sent" | "dropped" |
    "partition" | "error"``; the worker loop turns ``partition`` into
    close + sleep(arg) + reconnect and ``error`` into an immediate
    reconnect.  ``kill`` never returns.
    """

    def __init__(self, spec, proc: int):
        self.spec = parse_chaos(spec)
        self.proc = int(proc)
        self.events = {op: 0 for op in OPS}

    def send(self, sock, frame: bytes, t: int) -> tuple[str, float]:
        ops = self.spec.ops_for(self.proc, t)
        if "kill" in ops:
            self.events["kill"] += 1
            os._exit(17)
        if "delay" in ops:
            self.events["delay"] += 1
            time.sleep(ops["delay"].arg)
        if "partition" in ops:
            self.events["partition"] += 1
            return "partition", ops["partition"].arg
        if "drop" in ops:
            self.events["drop"] += 1
            return "dropped", 0.0
        data = frame
        if "byz_payload" in ops:
            # re-sealed before corrupt: a later corrupt breaks the CRC anyway
            self.events["byz_payload"] += 1
            data = byz_payload_bytes(
                data, fault_rng(self.spec.seed, self.proc, t, "byz_payload")
            )
        if "corrupt" in ops:
            self.events["corrupt"] += 1
            data = corrupt_bytes(data, fault_rng(self.spec.seed, self.proc, t, "corrupt"))
        try:
            sock.sendall(data)
            if "dup" in ops:
                self.events["dup"] += 1
                sock.sendall(data)
        except OSError:
            return "error", 0.0
        return "sent", 0.0
