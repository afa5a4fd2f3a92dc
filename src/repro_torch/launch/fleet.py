"""Self-healing multi-process protocol fleet, with its round math on the card.

One OS process per (simulated) host. The N logical devices are split into
``procs`` contiguous blocks; every process computes the eq.-(5) coded
gradients of its block's devices each round and ships them to process 0 (the
server) over TCP. The server gathers with a **round deadline**: blocks that
arrive in time form the round's participation mask, blocks that miss it are
erased for that round. The observed mask goes through the same machinery as
the simulated path: a ``ProtocolConfig`` with ``ParticipationSpec("external")``
and the mask-aware server of ``make_server_fn`` (``aggregator="decode"`` is
the cyclic K-of-N erasure decode, whose surviving-class sum is the
``masked_combine`` kernel). A killed process **is** an erasure.

On the card (``--device cuda``, the default) the workers' subset gradients,
their Com-LAD compression (the ``quantize`` kernel under ``--compress
quant:L``) and the server's decode run there; ``--device cpu`` runs the same
code on the plain PyTorch versions. With no card and no ``--device``, the
fleet raises. The data plane is TCP on the host, byte for byte the JAX
package's ``launch/fleet.py``: the same frames, the same payload codec, the
same chaos faults, so a server of either package takes the other's workers.

The fleet heals itself:

* **Byzantine-tolerant transport.** Every message is a versioned frame
  (magic, schema version, kind, CRC32, declared length; array payloads carry
  an explicit dtype/shape header; no pickle anywhere). Any malformed,
  corrupt, oversized, truncated, wrong-shaped, wrong-round or wrong-worker
  frame raises :class:`FrameError`, which the server turns into a
  *per-round erasure* of that worker (connection dropped, its mask rows 0,
  the fault tallied in the ``wire`` stats), never an exception. Stale and
  duplicate replies are tolerated and counted.
* **Worker rejoin.** The listen socket stays live during training: a
  crashed or partitioned worker reconnects with exponential backoff,
  re-hellos and contributes again from the current round. ``dead`` is the
  set of workers disconnected at the end. A worker that faulted *this*
  round cannot un-erase it by racing a rejoin.
* **Adaptive deadlines.** The round deadline is ``median + k * MAD`` of the
  observed honest latencies, floored by ``--round-timeout``
  (:func:`adaptive_deadline`).
* **Checkpointed crash recovery.** With ``--checkpoint PATH
  --checkpoint-every K`` the server saves its round state ``(x, t, losses,
  masks, wire stats, latency window)`` through ``repro_torch.checkpoint``
  every K rounds in the JAX package's file format; ``--resume`` restarts a
  killed server and its loss trajectory is bit for bit an uninterrupted
  run's (data and draws derive from the seed and the round).
* **Deterministic chaos.** ``--chaos`` wraps a worker's sends in
  ``launch/chaos.py``'s seeded fault schedule; an empty schedule is
  byte-identical to the plain fleet.
* **Com-LAD compressed uplink.** ``--compress quant:4`` (or ``randk:K`` /
  ``randk_shared:K`` / ``topk:K``) makes every worker compress its coded rows
  and ship the smaller representation as a ``CROWS`` frame
  (``core/compression.py``'s payload codec). The spec is declared in each
  worker's HELLO and must match the server's (``spec_mismatch`` otherwise).
  The server tallies frames and bytes sent and received per kind
  (``RESULT["wire"]``) and measured against predicted uplink cost
  (``RESULT["comlad"]``).

Randomness: round ``t``'s draws are ``byzantine.sample_round_randomness`` of
the fleet's protocol configuration from a CPU ``torch.Generator`` seeded
``protomath.fold_seed(seed, t)``: the assignment first, then the compression
draws of all N devices, moved to the process's device. Every process gets
them from ``(seed, t)`` alone, on the card as on the CPU, so nothing is
broadcast and a rejoining worker or a resumed server needs no replay. The
problem is ``linear_regression_problem`` from a CPU generator seeded
``seed``. ``FleetState`` takes both from outside where a caller gives them
(the tests hand it the JAX package's problem and draws).

Identity layer against data plane: ``--distributed`` (the default for
``procs > 1``) joins a ``torch.distributed`` gloo group at ``--coordinator``
(rank ``--proc-id``, world ``--procs``), the shape of a multi-host launch. It
gives identity only: a collective needs every member, so a gather that
times out and goes on cannot be one. The data plane is the TCP loop below.

Run (one line per process, the same flags but ``--proc-id``)::

    python -m repro_torch.launch.fleet --procs 3 --proc-id 0 --n-devices 6 --d 3 --device cpu --no-distributed
    python -m repro_torch.launch.fleet --procs 3 --proc-id 1 --n-devices 6 --d 3 --device cpu --no-distributed
    python -m repro_torch.launch.fleet --procs 3 --proc-id 2 --n-devices 6 --d 3 --device cpu --no-distributed

Every process prints ``RESULT::{json}`` (the server: per-round losses,
report counts, masks, the dead set, wire tallies, Com-LAD bytes, rejoins,
mask statistics and this process's kernel ``launches``; a worker: its
rounds, rejoins, sent bytes and launches) and ``TIMES::{json}`` (``ready_at``,
the ``wallclock`` second at which its start-up ended: the server's when every
worker had joined, a worker's when its first HELLO went out; the server also
each round's wall ms). Then it hard-exits (``os._exit``), so that a killed
peer cannot hang the exit.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import datetime
import json
import os
import select
import socket
import statistics
import struct
import sys
import time
import traceback
import zlib
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core import compression as comp
from repro_torch.core import task_matrix as tm
from repro_torch.core.byzantine import ProtocolConfig, RoundRandomness, make_server_fn, sample_round_randomness
from repro_torch.core.participation import ParticipationSpec, mask_stats
from repro_torch.core.protomath import fold_seed
from repro_torch.data.synthetic import linear_regression_problem, linreg_loss, linreg_subset_grads
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.chaos import ChaosTransport
from repro_torch.numerics import tree_sum
from repro_torch.timing import wallclock

__all__ = [
    "main",
    "run_server",
    "run_worker",
    "build_parser",
    "FleetConfig",
    "FleetState",
    "FrameError",
    "WIRE_KEYS",
    "WIRE_VERSION",
    "K_HELLO",
    "K_ROUND",
    "K_ROWS",
    "K_DONE",
    "K_CROWS",
    "KIND_NAMES",
    "encode_frame",
    "decode_frame_bytes",
    "recv_frame",
    "pack_hello",
    "unpack_hello",
    "pack_round",
    "unpack_round",
    "pack_rows",
    "unpack_rows",
    "pack_crows",
    "unpack_crows",
    "predicted_uplink_frame_bytes",
    "new_wire_tallies",
    "adaptive_deadline",
    "save_server_checkpoint",
    "load_server_checkpoint",
]

# --------------------------------------------------------------------------
# framing: versioned, CRC-checked, shape-declared frames (no pickle: a
# Byzantine peer controls every byte, so nothing on the wire may carry code)
# --------------------------------------------------------------------------
_MAGIC = b"RFLT"
WIRE_VERSION = 2  # v2: HELLO declares the compression spec; CROWS frame kind
_FRAME = struct.Struct("!4sBBII")  # magic, version, kind, crc32(payload), len
_MAX_MSG = 1 << 26  # 64 MiB: a block of coded vectors is far smaller

K_HELLO, K_ROUND, K_ROWS, K_DONE, K_CROWS = 1, 2, 3, 4, 5
_KINDS = (K_HELLO, K_ROUND, K_ROWS, K_DONE, K_CROWS)
KIND_NAMES = {
    K_HELLO: "hello",
    K_ROUND: "round",
    K_ROWS: "rows",
    K_DONE: "done",
    K_CROWS: "crows",  # compressed rows (the Com-LAD payload codec)
}

# every way a frame can be rejected; the server tallies these in RESULT
WIRE_KEYS = (
    "bad_magic",      # wrong 4-byte magic: not this protocol at all
    "bad_version",    # schema version mismatch
    "bad_kind",       # unknown frame kind, or a kind illegal in this state
    "bad_crc",        # payload CRC32 mismatch (corruption in flight)
    "oversize",       # declared length over _MAX_MSG (memory-exhaustion DoS)
    "truncated",      # EOF or timeout mid-frame
    "bad_payload",    # payload fails structural decode (dtype/ndim/length)
    "wrong_shape",    # well-formed array of the wrong declared shape
    "bad_hello",      # malformed hello, or proc id out of range
    "spec_mismatch",  # hello declares a different compression spec
    "pid_mismatch",   # rows claim a different worker than the connection's
    "future_round",   # rows for a round the server has not started
    "stale",          # rows for an already-finished round (tolerated)
    "duplicate",      # second delivery for the same round (tolerated)
)

_U32 = struct.Struct("!I")
_U16 = struct.Struct("!H")
_ROWS_HDR = struct.Struct("!II")  # round, proc
_ARR = struct.Struct("!BB")       # dtype code, ndim
_DIM = struct.Struct("!I")
_DT_F32 = 0
_DTYPES = {_DT_F32: "<f4"}
_MAX_SPEC = 64  # canonical spec strings are short; anything longer is hostile


class FrameError(Exception):
    """A rejected frame; ``reason`` is one of :data:`WIRE_KEYS`."""

    def __init__(self, reason: str):
        if reason not in WIRE_KEYS:
            raise ValueError(f"unknown frame-error reason {reason!r}")
        super().__init__(reason)
        self.reason = reason


def encode_frame(kind: int, payload: bytes = b"") -> bytes:
    if kind not in _KINDS:
        raise ValueError(f"unknown frame kind {kind}")
    if len(payload) > _MAX_MSG:
        raise ValueError(f"payload over _MAX_MSG: {len(payload)}")
    return _FRAME.pack(_MAGIC, WIRE_VERSION, kind, zlib.crc32(payload), len(payload)) + payload


def _check_header(magic: bytes, ver: int, kind: int, ln: int) -> None:
    if magic != _MAGIC:
        raise FrameError("bad_magic")
    if ver != WIRE_VERSION:
        raise FrameError("bad_version")
    if kind not in _KINDS:
        raise FrameError("bad_kind")
    if ln > _MAX_MSG:
        raise FrameError("oversize")


def decode_frame_bytes(data: bytes) -> tuple[int, bytes]:
    """Decode exactly one frame from a bytes buffer (tests and docs)."""
    if len(data) < _FRAME.size:
        raise FrameError("truncated")
    magic, ver, kind, crc, ln = _FRAME.unpack_from(data, 0)
    _check_header(magic, ver, kind, ln)
    if len(data) < _FRAME.size + ln:
        raise FrameError("truncated")
    if len(data) > _FRAME.size + ln:
        raise FrameError("bad_payload")
    payload = data[_FRAME.size:_FRAME.size + ln]
    if zlib.crc32(payload) != crc:
        raise FrameError("bad_crc")
    return kind, payload


def _recv_exact(sock: socket.socket, n: int, *, start: bool) -> bytes | None:
    """``n`` bytes, ``None`` on EOF at a frame boundary (``start=True``)."""
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            raise FrameError("truncated") from None
        if not chunk:
            if start and not buf:
                return None  # clean EOF between frames: the peer hung up
            raise FrameError("truncated")
        buf += chunk
    return buf


def recv_frame(sock: socket.socket) -> tuple[int, bytes] | None:
    """One validated frame, ``None`` on clean EOF, :class:`FrameError` else."""
    hdr = _recv_exact(sock, _FRAME.size, start=True)
    if hdr is None:
        return None
    magic, ver, kind, crc, ln = _FRAME.unpack(hdr)
    _check_header(magic, ver, kind, ln)
    payload = _recv_exact(sock, ln, start=False) if ln else b""
    if zlib.crc32(payload) != crc:
        raise FrameError("bad_crc")
    return kind, payload


def _pack_array(a) -> bytes:
    a = np.ascontiguousarray(np.asarray(a, dtype="<f4"))
    return b"".join([_ARR.pack(_DT_F32, a.ndim), *(_DIM.pack(s) for s in a.shape), a.tobytes()])


def _unpack_array(buf: bytes, expect_shape=None) -> np.ndarray:
    if len(buf) < _ARR.size:
        raise FrameError("bad_payload")
    code, ndim = _ARR.unpack_from(buf, 0)
    if code not in _DTYPES or ndim > 4:
        raise FrameError("bad_payload")
    off = _ARR.size
    shape = []
    for _ in range(ndim):
        if len(buf) < off + _DIM.size:
            raise FrameError("bad_payload")
        (s,) = _DIM.unpack_from(buf, off)
        off += _DIM.size
        shape.append(s)
    count = 1
    for s in shape:
        count *= s
    itemsize = np.dtype(_DTYPES[code]).itemsize
    if count > _MAX_MSG // itemsize:
        raise FrameError("oversize")
    if len(buf) - off != count * itemsize:
        raise FrameError("bad_payload")
    if expect_shape is not None and tuple(shape) != tuple(expect_shape):
        raise FrameError("wrong_shape")
    return np.frombuffer(buf, dtype=_DTYPES[code], count=count, offset=off).reshape(shape)


def pack_hello(proc: int, spec: str = "identity") -> bytes:
    """HELLO: the proc id and the worker's canonical compression spec, so a
    worker and server that disagree are a tallied ``spec_mismatch`` at
    connect time, not a wrong decode at round time."""
    raw = spec.encode("ascii")
    if len(raw) > _MAX_SPEC:
        raise ValueError(f"spec string too long: {spec!r}")
    return _U32.pack(proc) + _U16.pack(len(raw)) + raw


def unpack_hello(payload: bytes, procs: int, spec: str = "identity") -> int:
    if len(payload) < _U32.size + _U16.size:
        raise FrameError("bad_hello")
    (pid,) = _U32.unpack_from(payload, 0)
    (slen,) = _U16.unpack_from(payload, _U32.size)
    if slen > _MAX_SPEC or len(payload) != _U32.size + _U16.size + slen:
        raise FrameError("bad_hello")
    if not (1 <= pid < procs):
        raise FrameError("bad_hello")
    try:
        declared = payload[_U32.size + _U16.size:].decode("ascii")
    except UnicodeDecodeError:
        raise FrameError("bad_hello") from None
    if declared != spec:
        raise FrameError("spec_mismatch")
    return pid


def pack_round(t: int, x) -> bytes:
    return _U32.pack(t) + _pack_array(x)


def unpack_round(payload: bytes, dim: int) -> tuple[int, np.ndarray]:
    if len(payload) < _U32.size:
        raise FrameError("bad_payload")
    (t,) = _U32.unpack_from(payload, 0)
    return t, _unpack_array(payload[_U32.size:], expect_shape=(dim,))


def pack_rows(t: int, proc: int, rows) -> bytes:
    return _ROWS_HDR.pack(t, proc) + _pack_array(rows)


def unpack_rows(payload: bytes, expect_shape) -> tuple[int, int, np.ndarray]:
    if len(payload) < _ROWS_HDR.size:
        raise FrameError("bad_payload")
    t, proc = _ROWS_HDR.unpack_from(payload, 0)
    return t, proc, _unpack_array(payload[_ROWS_HDR.size:], expect_shape=expect_shape)


def pack_crows(t: int, proc: int, spec: comp.CompressionSpec, rows) -> bytes:
    """CROWS payload: the round header and the spec's compressed form of the
    dense ``(block, dim)`` compressed rows (``pack_payload`` derives the
    bit-packed levels or index/value records from them losslessly)."""
    return _ROWS_HDR.pack(t, proc) + comp.pack_payload(spec, np.asarray(rows))


def unpack_crows(payload: bytes, spec: comp.CompressionSpec, expect_shape) -> tuple[int, int, np.ndarray]:
    """Decode and validate one CROWS payload; a structural fault is the
    dense path's ``bad_payload`` / ``wrong_shape`` :class:`FrameError`."""
    if len(payload) < _ROWS_HDR.size:
        raise FrameError("bad_payload")
    t, proc = _ROWS_HDR.unpack_from(payload, 0)
    try:
        rows = comp.unpack_payload(spec, payload[_ROWS_HDR.size:], expect_shape)
    except comp.PayloadError as exc:
        raise FrameError(exc.reason) from None
    return t, proc, rows


def _identity(spec: comp.CompressionSpec) -> bool:
    return spec.name in ("none", "identity")


def predicted_uplink_frame_bytes(spec: comp.CompressionSpec, block: int, dim: int) -> int:
    """The schema's on-the-wire size of one uplink frame (header included)
    for a ``(block, dim)`` coded block: what the measured traffic is held
    to in ``RESULT["comlad"]``."""
    if _identity(spec):
        return _FRAME.size + _ROWS_HDR.size + _ARR.size + 2 * _DIM.size + block * dim * 4
    return _FRAME.size + _ROWS_HDR.size + comp.packed_nbytes(spec, (block, dim))


def new_wire_tallies() -> dict:
    """The ``RESULT["wire"]`` schema: fault reasons, and ``sent`` / ``recv``
    mapping each frame kind's name to ``[frames, bytes]`` of observed traffic
    (bytes include the frame header)."""
    return {
        "faults": {k: 0 for k in WIRE_KEYS},
        "sent": {name: [0, 0] for name in KIND_NAMES.values()},
        "recv": {name: [0, 0] for name in KIND_NAMES.values()},
    }


def _tally(counters: dict, kind: int, nbytes: int) -> None:
    row = counters[KIND_NAMES[kind]]
    row[0] += 1
    row[1] += nbytes


# --------------------------------------------------------------------------
# adaptive round deadline
# --------------------------------------------------------------------------
def adaptive_deadline(latencies, floor: float, k: float = 4.0, min_samples: int = 4) -> float:
    """Round deadline from observed honest latencies: ``median + k * MAD``,
    floored by ``floor`` (``--round-timeout``), and the floor alone until
    ``min_samples`` observations exist. Only accepted deliveries feed the
    window, so a stalled worker cannot raise the deadline it is measured
    against."""
    lat = list(latencies)
    if len(lat) < min_samples:
        return float(floor)
    med = statistics.median(lat)
    mad = statistics.median(abs(v - med) for v in lat)
    return max(float(floor), med + k * mad)


# --------------------------------------------------------------------------
# typed configuration (the CLI is generated from the dataclass)
# --------------------------------------------------------------------------
def _f(default, help_: str):
    return dataclasses.field(default=default, metadata={"help": help_})


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Typed fleet configuration, one field per CLI flag: the JAX package's
    fields and ``device``.

    ``build_parser()`` is generated from these fields (flag ``--proc-id``
    binds field ``proc_id``; bools get ``--x/--no-x``), ``from_argv`` parses
    a command line, and ``to_argv`` gives the least flag list that
    reproduces the config (``from_argv(to_argv()) == self``).
    """

    procs: int = _f(1, "fleet size (processes)")
    proc_id: int = _f(0, "this process (0 = server)")
    host: str = _f("127.0.0.1", "server gather host")
    port: int = _f(57313, "server gather port")
    coordinator: str = _f("127.0.0.1:57312", "torch.distributed rendezvous host:port (gloo, identity only)")
    distributed: bool = _f(True, "join a torch.distributed gloo group (identity only)")
    n_devices: int = _f(6, "N logical devices across the fleet")
    d: int = _f(3, "computational load / redundancy")
    dim: int = _f(8, "model dimension")
    sigma_h: float = _f(0.3, "heterogeneity of the synthetic problem")
    steps: int = _f(6, "training rounds")
    lr: float = _f(1e-5, "learning rate")
    seed: int = _f(0, "shared fleet seed (data, assignment, compression draws)")
    aggregator: str = _f("decode", "masked server rule (decode = cyclic K-of-N erasure decode)")
    compress: str = _f(
        "identity",
        "uplink CompressionSpec (registry spelling: identity | quant:L[:chunk] "
        "| randk:K | randk_shared:K | topk:K)",
    )
    round_timeout: float = _f(10.0, "floor of the adaptive per-round deadline")
    deadline_k: float = _f(4.0, "adaptive deadline spread multiplier (median + k*MAD)")
    deadline_window: int = _f(32, "sliding window of honest latencies the deadline sees")
    init_timeout: float = _f(60.0, "startup connect window (seconds)")
    rejoin_timeout: float = _f(30.0, "how long a disconnected worker keeps retrying")
    checkpoint: str = _f("", "server state checkpoint path prefix (empty = off)")
    checkpoint_every: int = _f(0, "persist server state every K rounds (0 = off)")
    resume: bool = _f(False, "resume the server from --checkpoint if present")
    chaos: str = _f("", "fault-injection schedule (JSON or path; launch/chaos.py)")
    die_after_round: int = _f(-1, "test hook: worker hard-exits when it sees this round")
    stall_after_round: int = _f(-1, "test hook: worker sleeps past the deadline from this round")
    stall_seconds: float = _f(-1.0, "injected stall length (default: 4x --round-timeout)")
    server_crash_after_round: int = _f(-1, "test hook: server hard-exits after finishing this round")
    device: str = _f("cuda", "where the round math runs: cuda (the default; raises without a card) or cpu")

    def spec(self) -> comp.CompressionSpec:
        """The parsed :class:`CompressionSpec` of ``compress``."""
        return comp.CompressionSpec.parse(self.compress)

    def torch_device(self) -> torch.device:
        """``device`` resolved; ``cuda`` with no card raises."""
        return resolve_device(None if self.device == "cuda" else self.device)

    @classmethod
    def build_parser(cls) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
        # `from __future__ import annotations` makes f.type a string
        types = {"int": int, "float": float, "str": str}
        for f in dataclasses.fields(cls):
            flag = "--" + f.name.replace("_", "-")
            help_ = f.metadata.get("help", "")
            if f.type == "bool":
                p.add_argument(flag, action=argparse.BooleanOptionalAction, default=f.default, help=help_)
            else:
                p.add_argument(flag, type=types[f.type], default=f.default, help=help_)
        return p

    @classmethod
    def from_argv(cls, argv=None) -> "FleetConfig":
        ns = cls.build_parser().parse_args(argv)
        return cls(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(cls)})

    def to_argv(self) -> list[str]:
        """The least flag list reproducing this config (non-default fields
        only): what harnesses pass to the processes they start."""
        argv: list[str] = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v == f.default:
                continue
            flag = f.name.replace("_", "-")
            if f.type == "bool":
                argv.append(f"--{flag}" if v else f"--no-{flag}")
            else:
                argv.extend([f"--{flag}", str(v)])
        return argv


# --------------------------------------------------------------------------
# shared round math
# --------------------------------------------------------------------------
def _protocol(cfg: FleetConfig) -> ProtocolConfig:
    """The fleet's protocol condition: LAD at load ``d`` with the uplink's
    compression, no Byzantine devices drawn (the fleet's faults are the
    wire's), and the mask the server observes."""
    return ProtocolConfig(n_devices=cfg.n_devices, d=cfg.d, method="lad", aggregator=cfg.aggregator,
                          compression=cfg.spec(), participation=ParticipationSpec(name="external"))


class FleetState:
    """What every process derives from the shared seed: the problem, each
    round's draws, a block's coded rows and their compression.

    ``problem`` (``(z (N, dim), y (N,))``) and ``randomness`` (``t ->
    RoundRandomness``) replace the seeded defaults when given; the tests
    pass the JAX package's problem and draws this way. Tensors given on the
    CPU are moved to ``cfg``'s device.
    """

    def __init__(self, cfg: FleetConfig, *, problem: tuple[torch.Tensor, torch.Tensor] | None = None,
                 randomness: Callable[[int], RoundRandomness] | None = None):
        n, d = cfg.n_devices, cfg.d
        if n % cfg.procs != 0:
            raise ValueError(f"n_devices={n} not divisible by procs={cfg.procs}")
        if n % d != 0:
            raise ValueError(f"decode exactness needs d | N: N={n} d={d}")
        self.cfg = cfg
        self.device = cfg.torch_device()
        self.spec = cfg.spec()
        self.protocol = _protocol(cfg)
        self.block = n // cfg.procs
        if problem is None:
            problem = linear_regression_problem(torch.Generator().manual_seed(cfg.seed), n=n, dim=cfg.dim,
                                                sigma_h=cfg.sigma_h)
        self.z, self.y = (v.to(self.device) for v in problem)
        self._draw = randomness or self._seeded_round
        self._last: tuple[int, RoundRandomness] | None = None

    def _seeded_round(self, t: int) -> RoundRandomness:
        gen = torch.Generator().manual_seed(fold_seed(self.cfg.seed, t))
        return sample_round_randomness(self.protocol, self.cfg.dim, gen)

    def round_randomness(self, t: int) -> RoundRandomness:
        """Round ``t``'s draws on this process's device (the last round's
        record is kept: the server reads it twice a round)."""
        if self._last is None or self._last[0] != t:
            self._last = (t, self._draw(t).to(self.device))
        return self._last[1]

    def block_rows(self, t: int, x: torch.Tensor, proc_id: int) -> torch.Tensor:
        """The ``(block, dim)`` coded vectors of process ``proc_id``'s
        devices: each the mean of its ``d`` subset gradients. Only the
        subsets this block's windows touch are computed, ``d`` a device."""
        rand = self.round_randomness(t)
        d, block = self.cfg.d, self.block
        ta = tm.assignment_from(rand.task_index, rand.subset_perm, d)
        need = ta.subsets[proc_id * block:(proc_id + 1) * block].reshape(-1)
        g = linreg_subset_grads(self.z[need], self.y[need], x)  # (block * d, dim)
        return tree_sum(g.reshape(block, d, x.shape[-1]), dim=1) / d

    def coded_block(self, t: int, x: torch.Tensor, proc_id: int) -> torch.Tensor:
        """``block_rows`` with the round's Com-LAD compression applied to
        devices ``[proc_id * block, ...)``: each device's rows of the round's
        draws, so the block is bit for bit the rows that ``protocol_round``'s
        compression stage gives these devices."""
        rows = self.block_rows(t, x, proc_id)
        if _identity(self.spec):
            return rows
        rand = self.round_randomness(t)
        lo, hi = proc_id * self.block, (proc_id + 1) * self.block
        keep = None if rand.keep_idx is None else rand.keep_idx[lo:hi].contiguous()
        quant_u = None if rand.quant_u is None else rand.quant_u[lo:hi].contiguous()
        return comp.compress_rows(self.spec, rows, keep, quant_u)

    def warm_up(self, proc_id: int) -> None:
        """One block of round 0 at x = 0 (and, on the server, one decode):
        the card's context, the kernels' libraries and their first launch
        are set up before this process says HELLO. Then the launch counts
        start again from 0."""
        x = torch.zeros((self.cfg.dim,), dtype=torch.float32, device=self.device)
        rows = self.coded_block(0, x, proc_id)
        if proc_id == 0:
            n = self.cfg.n_devices
            make_server_fn(self.protocol)(torch.zeros((n, self.cfg.dim), dtype=torch.float32, device=self.device),
                             torch.ones((n,), dtype=torch.float32, device=self.device),
                             self.round_randomness(0).task_index)
        rows.cpu()
        kernel_ops.reset_launch_counts()


def _maybe_init_distributed(cfg: FleetConfig) -> bool:
    """Join the gloo group at ``--coordinator``: identity only."""
    if not cfg.distributed or cfg.procs < 2:
        return False
    if cfg.coordinator.split(":")[0] in ("127.0.0.1", "localhost"):
        # processes of one host meet on the loopback; gloo otherwise takes
        # the interface of the host name, which a sealed machine may lack
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        torch.distributed.init_process_group(
            "gloo", init_method=f"tcp://{cfg.coordinator}", rank=cfg.proc_id, world_size=cfg.procs,
            timeout=datetime.timedelta(seconds=cfg.init_timeout))
    except (RuntimeError, OSError) as exc:  # environment-dependent
        print(f"fleet: torch.distributed unavailable ({exc!r}); continuing on the TCP data plane only",
              file=sys.stderr)
        return False
    return True


# --------------------------------------------------------------------------
# server checkpointing (crash recovery, the JAX package's file format)
# --------------------------------------------------------------------------
_CKPT_KEYS = ("x", "t", "losses", "n_report", "mask_hist", "wire", "wire_sent", "wire_recv", "rejoins", "lat")
_KIND_ORDER = tuple(sorted(KIND_NAMES.values()))


def save_server_checkpoint(path, *, x, step, losses, n_report, mask_hist, wire, rejoins, lat, n) -> None:
    state = {
        "x": torch.as_tensor(np.asarray(x, np.float32)),
        # the step also lives inside the npz, so a torn write (npz and json
        # of different saves) shows at load time
        "t": torch.tensor(step, dtype=torch.int64),
        "losses": torch.tensor(losses, dtype=torch.float64),
        "n_report": torch.tensor(n_report, dtype=torch.int32),
        "mask_hist": torch.tensor(mask_hist, dtype=torch.int8).reshape(len(mask_hist), n),
        "wire": torch.tensor([wire["faults"][k] for k in WIRE_KEYS], dtype=torch.int64),
        "wire_sent": torch.tensor([wire["sent"][k] for k in _KIND_ORDER], dtype=torch.int64),
        "wire_recv": torch.tensor([wire["recv"][k] for k in _KIND_ORDER], dtype=torch.int64),
        "rejoins": torch.tensor(rejoins, dtype=torch.int64),
        "lat": torch.tensor(list(lat), dtype=torch.float64),
    }
    save_checkpoint(path, state, step=step)


def load_server_checkpoint(path):
    """``(state, step)``, or ``(None, 0)`` when absent or torn (start fresh)."""
    if not (os.path.exists(path + ".npz") and os.path.exists(path + ".json")):
        return None, 0
    try:
        state, step = load_checkpoint(path, {k: 0 for k in _CKPT_KEYS})
    except ValueError as exc:
        # another wire schema's checkpoint: its traffic counters cannot be
        # recovered, so start fresh rather than resume with wrong tallies
        print(f"fleet: checkpoint {path} has an incompatible schema ({exc}); starting fresh", file=sys.stderr)
        return None, 0
    if int(state["t"]) != int(step):
        print(f"fleet: checkpoint {path} is torn (npz round {int(state['t'])} != sidecar step {step}); "
              "starting fresh", file=sys.stderr)
        return None, 0
    return state, int(step)


# --------------------------------------------------------------------------
# server (process 0)
# --------------------------------------------------------------------------
def run_server(cfg: FleetConfig, *, problem=None, randomness=None) -> dict:
    """Serve ``cfg.steps`` rounds; returns the RESULT dict (and ``"times"``,
    which ``main`` prints apart). ``problem``/``randomness``: see
    :class:`FleetState`."""
    fs = FleetState(cfg, problem=problem, randomness=randomness)
    fs.warm_up(0)
    server = make_server_fn(fs.protocol)  # (transmitted, pmask, task_index) -> (dim,)
    dev = fs.device
    n, dim, procs, block = cfg.n_devices, cfg.dim, cfg.procs, fs.block
    spec = fs.spec
    spec_text = spec.canonical()
    identity = _identity(spec)
    # identity keeps the plain dense ROWS frames byte for byte; a real
    # compressor switches the uplink to the CROWS codec
    rows_kind = K_ROWS if identity else K_CROWS

    # --- state (possibly resumed) --------------------------------------
    x = torch.zeros((dim,), dtype=torch.float32, device=dev)
    t0 = resumed_from = 0
    losses: list[float] = []
    n_report: list[int] = []
    mask_hist: list[list[int]] = []
    wire = new_wire_tallies()
    rejoins = 0
    lat = collections.deque(maxlen=cfg.deadline_window)
    if cfg.resume:
        if not cfg.checkpoint:
            raise SystemExit("--resume requires --checkpoint PATH")
        state, step = load_server_checkpoint(cfg.checkpoint)
        if state is not None:
            x = torch.as_tensor(np.asarray(state["x"], np.float32)).to(dev)
            t0 = resumed_from = step
            losses = [float(v) for v in state["losses"]]
            n_report = [int(v) for v in state["n_report"]]
            mask_hist = [[int(b) for b in row] for row in state["mask_hist"]]
            wire["faults"] = {k: int(v) for k, v in zip(WIRE_KEYS, state["wire"])}
            wire["sent"] = {k: [int(a), int(b)] for k, (a, b) in zip(_KIND_ORDER, state["wire_sent"])}
            wire["recv"] = {k: [int(a), int(b)] for k, (a, b) in zip(_KIND_ORDER, state["wire_recv"])}
            rejoins = int(state["rejoins"])
            lat.extend(float(v) for v in state["lat"])
            print(f"fleet: resumed from {cfg.checkpoint} at round {t0}", file=sys.stderr)

    def send(conn: socket.socket, kind: int, frame: bytes) -> bool:
        try:
            conn.sendall(frame)
        except OSError:
            return False
        _tally(wire["sent"], kind, len(frame))
        return True

    # --- connections ----------------------------------------------------
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind((cfg.host, cfg.port))
    lsock.listen(cfg.procs)
    conns: dict[int, socket.socket] = {}
    sock2pid: dict[socket.socket, int] = {}

    def register(conn) -> int | None:
        """HELLO handshake; on success the conn replaces any stale one."""
        conn.settimeout(2.0)
        try:
            got = recv_frame(conn)
            if got is None:
                raise FrameError("truncated")
            kind, payload = got
            if kind != K_HELLO:
                raise FrameError("bad_hello")
            pid = unpack_hello(payload, procs, spec_text)
        except (FrameError, OSError) as exc:
            wire["faults"][exc.reason if isinstance(exc, FrameError) else "truncated"] += 1
            conn.close()
            return None
        _tally(wire["recv"], K_HELLO, _FRAME.size + len(payload))
        conn.settimeout(None)
        drop_conn(pid)
        conns[pid] = conn
        sock2pid[conn] = pid
        return pid

    def drop_conn(pid: int) -> None:
        conn = conns.pop(pid, None)
        if conn is not None:
            sock2pid.pop(conn, None)
            try:
                conn.close()
            except OSError:
                pass

    init_deadline = wallclock() + cfg.init_timeout
    while len(conns) < procs - 1:
        if wallclock() > init_deadline:
            raise TimeoutError(f"fleet server: only {len(conns)}/{procs - 1} workers connected before "
                               "--init-timeout")
        lsock.settimeout(max(0.1, init_deadline - wallclock()))
        try:
            conn, _ = lsock.accept()
        except socket.timeout:
            continue
        register(conn)
    lsock.settimeout(None)  # select() drives readiness from here on
    ready_at = wallclock()
    round_ms: list[float] = []

    # --- rounds ----------------------------------------------------------
    for t in range(t0, cfg.steps):
        round_start = wallclock()
        round_frame = encode_frame(K_ROUND, pack_round(t, x.cpu().numpy()))
        for pid in list(conns):
            if not send(conns[pid], K_ROUND, round_frame):
                drop_conn(pid)

        # the server's own block always reports (it is the aggregation
        # host) and is compressed like every worker's
        transmitted = np.zeros((n, dim), np.float32)
        mask = np.zeros((n,), np.float32)
        transmitted[:block] = fs.coded_block(t, x, 0).cpu().numpy()
        mask[:block] = 1.0

        delivered: set[int] = {0}
        erased: set[int] = set()  # faulted THIS round: a rejoin cannot undo it
        start = wallclock()
        deadline = start + adaptive_deadline(lat, cfg.round_timeout, k=cfg.deadline_k)

        while True:
            pending = [p for p in conns if p not in delivered and p not in erased]
            # with every worker gone, idle to the deadline instead of racing
            # through rounds faster than any rejoin could land
            waiting_rejoin = not conns and len(delivered) < procs
            if not pending and not waiting_rejoin:
                break
            remaining = deadline - wallclock()
            if remaining <= 0:
                break  # stragglers are erased for this round
            readable, _, _ = select.select([lsock, *sock2pid], [], [], remaining)
            for s in readable:
                if s is lsock:
                    try:
                        conn, _ = lsock.accept()
                    except OSError:
                        continue
                    pid = register(conn)
                    if pid is not None:
                        rejoins += 1
                        if pid not in erased and not send(conns[pid], K_ROUND, round_frame):
                            drop_conn(pid)  # faulted rounds stay erased
                    continue
                pid = sock2pid.get(s)
                if pid is None:
                    continue  # replaced by a rejoin within this batch
                s.settimeout(max(0.05, deadline - wallclock()))
                try:
                    got = recv_frame(s)
                except FrameError as exc:
                    wire["faults"][exc.reason] += 1
                    erased.add(pid)
                    drop_conn(pid)
                    continue
                except OSError:  # reset mid-read: gone, as a clean EOF
                    drop_conn(pid)
                    continue
                if got is None:  # clean EOF: the worker is gone (until it rejoins)
                    drop_conn(pid)
                    continue
                if conns.get(pid) is s:
                    s.settimeout(None)
                kind, payload = got
                if kind != rows_kind:
                    # a dense ROWS frame under a compressed spec (or CROWS
                    # under identity) is as illegal as an unknown kind
                    wire["faults"]["bad_kind"] += 1
                    erased.add(pid)
                    drop_conn(pid)
                    continue
                _tally(wire["recv"], kind, _FRAME.size + len(payload))
                try:
                    if identity:
                        tm_, pid_claim, rows = unpack_rows(payload, expect_shape=(block, dim))
                    else:
                        tm_, pid_claim, rows = unpack_crows(payload, spec, expect_shape=(block, dim))
                except FrameError as exc:
                    wire["faults"][exc.reason] += 1
                    erased.add(pid)
                    drop_conn(pid)
                    continue
                if pid_claim != pid:
                    wire["faults"]["pid_mismatch"] += 1
                    erased.add(pid)
                    drop_conn(pid)
                    continue
                if tm_ < t:
                    wire["faults"]["stale"] += 1  # a straggled round: discard, keep the conn
                    continue
                if tm_ > t:
                    wire["faults"]["future_round"] += 1
                    erased.add(pid)
                    drop_conn(pid)
                    continue
                if pid in delivered:
                    wire["faults"]["duplicate"] += 1  # a retransmit: discard, keep the conn
                    continue
                lo = pid * block
                transmitted[lo:lo + block] = rows
                mask[lo:lo + block] = 1.0
                delivered.add(pid)
                lat.append(wallclock() - start)

        pm = torch.from_numpy(mask).to(dev)
        decoded = server(torch.from_numpy(transmitted).to(dev) * pm[:, None], pm,
                         fs.round_randomness(t).task_index)
        x = x - cfg.lr * float(n) * decoded
        losses.append(float(linreg_loss(fs.z, fs.y, x)))
        n_report.append(int(mask.sum()))
        mask_hist.append(mask.astype(int).tolist())
        round_ms.append((wallclock() - round_start) * 1e3)

        if cfg.checkpoint and cfg.checkpoint_every > 0 and (t + 1) % cfg.checkpoint_every == 0:
            save_server_checkpoint(cfg.checkpoint, x=x.cpu().numpy(), step=t + 1, losses=losses,
                                   n_report=n_report, mask_hist=mask_hist, wire=wire, rejoins=rejoins,
                                   lat=lat, n=n)
        if 0 <= cfg.server_crash_after_round <= t:
            # test hook: die after the round completed (after its checkpoint
            # when one was due); the crash-recovery tests resume from here
            os._exit(23)

    dead = sorted(set(range(1, procs)) - set(conns))  # before teardown
    done_frame = encode_frame(K_DONE)
    for pid in list(conns):
        send(conns[pid], K_DONE, done_frame)
        drop_conn(pid)
    lsock.close()

    # --- Com-LAD uplink accounting (measured against predicted) ----------
    up_frames, up_bytes = wire["recv"][KIND_NAMES[rows_kind]]
    hdr = _FRAME.size + _ROWS_HDR.size
    body_overhead = (_ARR.size + 2 * _DIM.size) if identity else comp._CHDR.size
    comlad = {
        "spec": spec_text,
        "uplink_frames": up_frames,
        "uplink_bytes": up_bytes,
        "uplink_bytes_per_round": up_bytes / max(1, len(losses)),
        "frame_bytes_predicted": predicted_uplink_frame_bytes(spec, block, dim),
        "frame_bytes_measured": (up_bytes / up_frames) if up_frames else 0.0,
        "wire_bits_predicted": comp.wire_bits(spec, dim),
        "wire_bits_measured": (up_bytes / up_frames - hdr - body_overhead) * 8.0 / block if up_frames else 0.0,
    }
    return {
        "losses": losses,
        "n_report": n_report,
        "mask_hist": mask_hist,
        "dead": dead,
        "final_loss": losses[-1],
        "wire": wire,
        "comlad": comlad,
        "rejoins": rejoins,
        "resumed_from": resumed_from,
        "stats": mask_stats(mask_hist, cfg.d),
        "launches": kernel_ops.launch_counts(),
        "times": {"proc": 0, "ready_at": ready_at, "round_ms": round_ms},
    }


# --------------------------------------------------------------------------
# worker (processes 1..P-1)
# --------------------------------------------------------------------------
def run_worker(cfg: FleetConfig, *, problem=None, randomness=None) -> dict:
    """Answer rounds until the server's DONE (or until it is gone for good);
    returns this worker's report (and ``"times"``)."""
    fs = FleetState(cfg, problem=problem, randomness=randomness)
    fs.warm_up(cfg.proc_id)
    spec = fs.spec
    identity = _identity(spec)
    rows_kind = K_ROWS if identity else K_CROWS
    chaos = ChaosTransport(cfg.chaos, cfg.proc_id) if cfg.chaos else None
    stall_s = cfg.stall_seconds if cfg.stall_seconds > 0 else cfg.round_timeout * 4.0
    hello = encode_frame(K_HELLO, pack_hello(cfg.proc_id, spec.canonical()))
    sent_frames = sent_bytes = 0

    sock: socket.socket | None = None
    ever_connected = False
    ready_at = None
    give_up = wallclock() + cfg.init_timeout
    backoff = 0.05
    rounds = rejoins = 0

    def lost() -> None:
        nonlocal sock, give_up
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        sock = None
        give_up = wallclock() + cfg.rejoin_timeout

    while True:
        if sock is None:
            if wallclock() > give_up:
                if ever_connected:
                    break  # the server is gone for good: exit quietly
                raise TimeoutError("fleet worker: server never accepted before --init-timeout")
            try:
                sock = socket.create_connection((cfg.host, cfg.port), timeout=2.0)
                sock.settimeout(None)
                sock.sendall(hello)
            except OSError:
                if sock is not None:
                    sock.close()
                    sock = None
                time.sleep(backoff)
                backoff = min(backoff * 2.0, 2.0)  # exponential, capped
                continue
            if ever_connected:
                rejoins += 1
            else:
                ready_at = wallclock()
            ever_connected = True
            backoff = 0.05
        try:
            got = recv_frame(sock)
        except (FrameError, OSError):
            got = None  # a garbled stream or a reset: resync by reconnecting
        if got is None:
            lost()
            continue
        kind, payload = got
        if kind == K_DONE:
            break
        if kind != K_ROUND:
            lost()
            continue
        try:
            t, xb = unpack_round(payload, cfg.dim)
        except FrameError:
            lost()
            continue
        if 0 <= cfg.die_after_round <= t:
            # a crashed host mid-round: vanish without replying
            sock.close()
            os._exit(17)
        if 0 <= cfg.stall_after_round <= t:
            time.sleep(stall_s)  # straggle past the deadline
        x = torch.from_numpy(np.array(xb)).to(fs.device)
        rows = fs.coded_block(t, x, cfg.proc_id).cpu().numpy()
        if identity:
            frame = encode_frame(K_ROWS, pack_rows(t, cfg.proc_id, rows))
        else:
            frame = encode_frame(K_CROWS, pack_crows(t, cfg.proc_id, spec, rows))
        if chaos is None:
            try:
                sock.sendall(frame)
            except OSError:
                lost()
                continue
        else:
            status, arg = chaos.send(sock, frame, t)
            if status == "partition":
                lost()
                time.sleep(arg)  # dark for the partition window, then rejoin
                give_up = wallclock() + cfg.rejoin_timeout
                continue
            if status == "error":
                lost()
                continue
        sent_frames += 1
        sent_bytes += len(frame)
        rounds += 1
    if sock is not None:
        sock.close()
    return {
        "proc": cfg.proc_id,
        "rounds": rounds,
        "rejoins": rejoins,
        "spec": spec.canonical(),
        "sent": {KIND_NAMES[rows_kind]: [sent_frames, sent_bytes]},
        "launches": kernel_ops.launch_counts(),
        "times": {"proc": cfg.proc_id, "ready_at": ready_at},
    }


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------
def build_parser() -> argparse.ArgumentParser:
    """The CLI, generated from :class:`FleetConfig`'s fields."""
    return FleetConfig.build_parser()


def main(argv=None) -> int:
    cfg = FleetConfig.from_argv(argv)
    if not (0 <= cfg.proc_id < cfg.procs):
        raise SystemExit(f"--proc-id {cfg.proc_id} out of range for --procs {cfg.procs}")
    cfg.spec()  # fail fast on an unparseable --compress before any socket work
    cfg.torch_device()  # and on --device cuda without a card
    try:
        _maybe_init_distributed(cfg)
        out = run_server(cfg) if cfg.proc_id == 0 else run_worker(cfg)
    except Exception:
        # report and hard-exit: a torn-down gloo group must not hang the exit
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    times = out.pop("times")
    print("RESULT::" + json.dumps(out), flush=True)
    print("TIMES::" + json.dumps(times), flush=True)
    # hard exit: a killed peer can leave the gloo group wedged; the results
    # are on stdout and flushed
    os._exit(0)


if __name__ == "__main__":
    main()
