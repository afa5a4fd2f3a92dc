"""The port's fleet (``repro_torch.launch.fleet``, ``launch.chaos``, the
payload codec of ``core.compression`` and ``scenarios.fleet_*_cases``)
against the JAX package's, on the CPU.

The wire is held byte for byte: every frame kind and packer, every
corruption class's ``FrameError`` reason, every compressor's payload (and
its ``PayloadError`` reasons), the predicted sizes, and the chaos layer's
seeded faults. The round math is held on the reference's problem and its
replayed draws (``fold_in(PRNGKey(seed), t)`` split four ways: the
assignment from the first key, device ``i``'s compression draws from
``split(k_comp, N)[i]``): the server's decode within rtol 1e-5 and atol
1e-6 (as ``tests/test_torch_protocol.py``), ``block_rows`` and
``coded_block`` within rtol 1e-5 and atol 1e-6 of the block's largest value
(a device's row is the mean of ``d`` subset gradients of some 10^3 that
cancel to less, so a few ulps of the terms are what the sum order moves),
QSGD's
``coded_block`` under that file's flip margin (every draw more than twice
``levels * 2^-20`` from the remainder it is compared with, so both sides
round alike), and a whole fleet round by round within relative 2e-6 (as the
trajectory tests). Servers of one package take the other's workers.

Whole fleets run in threads (on the reference's draws) and as real
processes (``python -m repro_torch.launch.fleet --device cpu
--no-distributed``, ports from the OS). The slow tier runs every
``fleet_chaos_cases()`` row against ``benchmarks/out/BENCH_fleet_chaos.json``
and every ``fleet_comlad_cases()`` row, as ``benchmarks/fleet_bench.py``
does for the reference.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import struct
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as rcomp
from repro.core import scenarios as rscn
from repro.core import task_matrix as rtm
from repro.data.synthetic import linear_regression_problem as r_problem
from repro.launch import chaos as RC
from repro.launch import fleet as RF
from repro_torch.core import byzantine as tbyz
from repro_torch.core import compression as tcomp
from repro_torch.core import scenarios as tscn
from repro_torch.launch import chaos as TC
from repro_torch.launch import fleet as TF

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-6
TRAJ_RTOL = 2e-6
GEOMETRY = dict(procs=3, n_devices=6, d=3, dim=8, steps=8, lr=1e-5, seed=0)  # the reference's test geometry
COMLAD = dict(GEOMETRY, dim=64, lr=1e-6)  # benchmarks/fleet_bench.py's COMLAD_DEFAULTS
SPECS = ("identity", "quant:4", "quant:8", "quant:3:16", "randk:16", "randk_shared:16", "topk:16", "randk:0.25")
ENVELOPE_RTOL = 1e-3  # benchmarks/fleet_bench.py's erasure-decode envelope


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def configs(**kw) -> tuple[RF.FleetConfig, TF.FleetConfig]:
    """The same fleet as the reference's config and the port's (on the CPU)."""
    kw.setdefault("port", free_port())
    kw.setdefault("distributed", False)
    return RF.FleetConfig(**kw), TF.FleetConfig(**kw, device="cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def ref_problem(rcfg) -> tuple[torch.Tensor, torch.Tensor]:
    z, y = r_problem(jax.random.PRNGKey(rcfg.seed), n=rcfg.n_devices, dim=rcfg.dim, sigma_h=rcfg.sigma_h)
    return _t(z), _t(y)


def ref_draws(rcfg):
    """The reference fleet's round draws as the port's records."""
    key = jax.random.PRNGKey(rcfg.seed)
    spec = rcfg.spec()
    n, q = rcfg.n_devices, rcfg.dim

    def draw(t: int) -> tbyz.RoundRandomness:
        ks = jax.random.split(jax.random.fold_in(key, t), 4)
        ta = rtm.sample_assignment(ks[0], n, rcfg.d)
        keep = quant_u = None
        if spec.name == "rand_sparse":
            keep = jax.vmap(lambda k: jax.random.permutation(k, q)[:spec.kept(q)])(jax.random.split(ks[3], n))
        elif spec.name == "rand_sparse_shared":
            keep = jnp.broadcast_to(jax.random.permutation(ks[3], q)[:spec.kept(q)], (n, spec.kept(q)))
        if spec.name == "quant":
            quant_u = jax.vmap(lambda k: jax.random.uniform(k, (q,)))(jax.random.split(ks[3], n))
        return tbyz.RoundRandomness(
            task_index=_t(ta.task_index), subset_perm=_t(ta.subset_perm), byz_mask=torch.zeros(n),
            keep_idx=None if keep is None else _t(keep), quant_u=None if quant_u is None else _t(quant_u))

    return draw


def flip_margin(rows: np.ndarray, quant_u: np.ndarray, spec) -> float:
    """The least distance, around the unit circle, between a QSGD draw and
    the remainder of ``y = g / scale * levels`` it is compared with."""
    q = rows.shape[-1]
    block = min(spec.chunk, q)
    padded = np.pad(rows, ((0, 0), (0, (-q) % block))).reshape(rows.shape[0], -1, block)
    scale = np.abs(padded).max(-1, keepdims=True)
    y = (padded / np.where(scale > 0, scale, 1.0) * spec.levels).reshape(rows.shape[0], -1)[:, :q]
    gap = np.abs(quant_u - (y - np.floor(y)))
    return float(np.minimum(gap, 1.0 - gap).min())


# --------------------------------------------------------------------------
# frames and packers, byte for byte
# --------------------------------------------------------------------------
def _frames(F, comp):
    x = np.linspace(-3, 3, 8, dtype=np.float32)
    rows = np.random.default_rng(0).standard_normal((2, 16)).astype(np.float32)
    q4 = comp.CompressionSpec.parse("quant:4")
    return {
        "hello": F.encode_frame(F.K_HELLO, F.pack_hello(2)),
        "hello_quant": F.encode_frame(F.K_HELLO, F.pack_hello(1, "quant:4")),
        "round": F.encode_frame(F.K_ROUND, F.pack_round(3, x)),
        "rows": F.encode_frame(F.K_ROWS, F.pack_rows(5, 1, rows)),
        "done": F.encode_frame(F.K_DONE),
        "crows": F.encode_frame(F.K_CROWS, F.pack_crows(7, 2, q4, tcomp.compress_rows(
            tcomp.CompressionSpec.parse("quant:4"), torch.from_numpy(rows),
            quant_u=torch.rand((2, 16), generator=torch.Generator().manual_seed(1))).numpy())),
    }


@pytest.mark.parametrize("kind", ["hello", "hello_quant", "round", "rows", "done", "crows"])
def test_frames_byte_identical(kind):
    got, want = _frames(TF, tcomp)[kind], _frames(RF, rcomp)[kind]
    assert got == want
    assert TF.decode_frame_bytes(got) == RF.decode_frame_bytes(want)


def test_packers_decode_across_packages():
    x = np.arange(8, dtype=np.float32)
    rows = np.full((2, 8), 2.5, np.float32)
    t, x2 = TF.unpack_round(RF.pack_round(3, x), 8)
    assert t == 3 and np.array_equal(x2, x)
    t, pid, r2 = TF.unpack_rows(RF.pack_rows(5, 1, rows), (2, 8))
    assert (t, pid) == (5, 1) and np.array_equal(r2, rows)
    assert TF.unpack_hello(RF.pack_hello(2, "quant:4"), procs=3, spec="quant:4") == 2
    assert RF.unpack_hello(TF.pack_hello(2, "quant:4"), procs=3, spec="quant:4") == 2
    assert TF.WIRE_KEYS == RF.WIRE_KEYS and TF.KIND_NAMES == RF.KIND_NAMES and TF.WIRE_VERSION == RF.WIRE_VERSION
    assert TF.new_wire_tallies() == RF.new_wire_tallies()


def _good_rows_frame(F):
    return F.encode_frame(F.K_ROWS, F.pack_rows(0, 1, np.zeros((2, 8), np.float32)))


def _flipped_last(good):
    flipped = bytearray(good)
    flipped[-1] ^= 0xFF
    return bytes(flipped)


# tests/test_chaos.py::test_every_corruption_class_has_a_reason's classes
CORRUPTIONS = {
    "good": lambda g: g,
    "bad_magic": lambda g: b"XXXX" + g[4:],
    "bad_version": lambda g: g[:4] + bytes([99]) + g[5:],
    "bad_kind": lambda g: g[:5] + bytes([77]) + g[6:],
    "truncated_payload": lambda g: g[:-1],
    "truncated_header": lambda g: g[:10],
    "bad_crc": _flipped_last,
    "oversize": lambda g: struct.pack("!4sBBII", b"RFLT", RF.WIRE_VERSION, RF.K_ROWS, 0, 1 << 30),
    "trailing": lambda g: g + b"\0",
}


def _reason(decode, data):
    try:
        decode(data)
    except (RF.FrameError, TF.FrameError) as exc:
        return exc.reason
    return None


def _recv_reason(F, data):
    a, b = socket.socketpair()
    with a, b:
        b.settimeout(2.0)
        a.sendall(data)
        a.shutdown(socket.SHUT_WR)
        return _reason(F.recv_frame, b)


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_every_corruption_class_has_the_same_reason(case):
    data = CORRUPTIONS[case](_good_rows_frame(RF))
    assert CORRUPTIONS[case](_good_rows_frame(TF)) == data
    want = _reason(RF.decode_frame_bytes, data)
    assert _reason(TF.decode_frame_bytes, data) == want
    assert want == (None if case == "good" else {"truncated_payload": "truncated", "truncated_header": "truncated",
                                                 "trailing": "bad_payload"}.get(case, case))
    if case != "trailing":  # a socket reads one frame and leaves what follows
        assert _recv_reason(TF, data) == _recv_reason(RF, data)


@pytest.mark.parametrize("what", ["wrong_shape", "short_rows", "hello_range", "hello_short", "spec_mismatch",
                                  "hello_truncated_spec", "crows_shape", "crows_truncated", "crows_short"])
def test_payload_faults_have_the_same_reason(what):
    spec_r, spec_t = rcomp.CompressionSpec.parse("quant:4"), tcomp.CompressionSpec.parse("quant:4")
    rows = np.random.default_rng(0).standard_normal((2, 16)).astype(np.float32)
    payload = RF.pack_crows(3, 1, spec_r, rows)
    _, good = RF.decode_frame_bytes(_good_rows_frame(RF))
    calls = {
        "wrong_shape": lambda F, s: F.unpack_rows(good, (3, 8)),
        "short_rows": lambda F, s: F.unpack_rows(good[:F._ROWS_HDR.size + 1], (2, 8)),
        "hello_range": lambda F, s: F.unpack_hello(F.pack_hello(7), procs=3),
        "hello_short": lambda F, s: F.unpack_hello(b"xx", procs=3),
        "spec_mismatch": lambda F, s: F.unpack_hello(F.pack_hello(1, "quant:4"), procs=3, spec="identity"),
        "hello_truncated_spec": lambda F, s: F.unpack_hello(F.pack_hello(1, "quant:4")[:-2], procs=3, spec="quant:4"),
        "crows_shape": lambda F, s: F.unpack_crows(payload, s, (3, 16)),
        "crows_truncated": lambda F, s: F.unpack_crows(payload[:-1], s, (2, 16)),
        "crows_short": lambda F, s: F.unpack_crows(payload[:F._ROWS_HDR.size + 2], s, (2, 16)),
    }
    reasons = []
    for F, s in ((RF, spec_r), (TF, spec_t)):
        with pytest.raises(F.FrameError) as e:
            calls[what](F, s)
        reasons.append(e.value.reason)
    assert reasons[0] == reasons[1]


# --------------------------------------------------------------------------
# the payload codec
# --------------------------------------------------------------------------
def _compressed_rows(text: str, r: int = 3, q: int = 40, seed: int = 0) -> np.ndarray:
    """Compressed rows of ``text``: the port's compression of normal rows
    (QSGD levels on the lattice, sparse rows with their zeros)."""
    spec = tcomp.CompressionSpec.parse(text)
    gen = torch.Generator().manual_seed(seed)
    rows = torch.randn((r, q), generator=gen)
    keep = tcomp.sample_keep_idx(spec, r, q, gen)
    quant_u = tcomp.sample_quant_u(spec, r, q, gen)
    return tcomp.compress_rows(spec, rows, keep, quant_u).numpy()


@pytest.mark.parametrize("text", SPECS)
def test_pack_payload_byte_identical_and_lossless(text):
    rows = _compressed_rows(text)
    rs, ts = rcomp.CompressionSpec.parse(text), tcomp.CompressionSpec.parse(text)
    packed = tcomp.pack_payload(ts, rows)
    assert packed == rcomp.pack_payload(rs, rows)
    out = tcomp.unpack_payload(ts, packed, rows.shape)
    assert out.dtype == np.float32 and np.array_equal(out, rows)  # bitwise up to the sign of a dropped 0
    assert np.array_equal(rcomp.unpack_payload(rs, packed, rows.shape), out)
    if text in ("identity",) or text.startswith("quant"):
        assert len(packed) == tcomp.packed_nbytes(ts, rows.shape) == rcomp.packed_nbytes(rs, rows.shape)
    else:
        assert len(packed) <= tcomp.packed_nbytes(ts, rows.shape) == rcomp.packed_nbytes(rs, rows.shape)


@pytest.mark.parametrize("text", SPECS)
@pytest.mark.parametrize("fault", ["truncated", "trailing", "short_header", "wrong_shape", "bad_level_or_index"])
def test_unpack_payload_faults_have_the_same_reason(text, fault):
    rows = _compressed_rows(text)
    rs, ts = rcomp.CompressionSpec.parse(text), tcomp.CompressionSpec.parse(text)
    packed = rcomp.pack_payload(rs, rows)
    shape = rows.shape
    if fault == "truncated":
        packed = packed[:-1]
    elif fault == "trailing":
        packed = packed + b"\0"
    elif fault == "short_header":
        packed = packed[:3]
    elif fault == "wrong_shape":
        shape = (rows.shape[0] + 1, rows.shape[1])
    else:  # the first coordinate's level, or the first sparse index, out of range
        buf = bytearray(packed)
        if text.startswith("quant"):
            buf[6 + 4 * -(-rows.shape[1] // rs.chunk)] = 0xFF
        elif text != "identity":
            buf[6 + 2:6 + 6] = struct.pack(">I", 1 << 20)
        packed = bytes(buf)
    reasons = []
    for comp, spec in ((rcomp, rs), (tcomp, ts)):
        try:
            comp.unpack_payload(spec, packed, shape)
            reasons.append(None)
        except comp.PayloadError as exc:
            reasons.append(exc.reason)
    assert reasons[0] == reasons[1]
    if not (fault == "bad_level_or_index" and text == "identity"):
        assert reasons[1] in ("bad_payload", "wrong_shape")


@pytest.mark.parametrize("text", SPECS)
@pytest.mark.parametrize("shape", [(2, 8), (2, 64), (10, 100), (3, 1025)])
def test_predicted_sizes_equal(text, shape):
    rs, ts = rcomp.CompressionSpec.parse(text), tcomp.CompressionSpec.parse(text)
    assert tcomp.packed_nbytes(ts, shape) == rcomp.packed_nbytes(rs, shape)
    assert TF.predicted_uplink_frame_bytes(ts, *shape) == RF.predicted_uplink_frame_bytes(rs, *shape)
    assert tcomp.wire_bits(ts, shape[1]) == rcomp.wire_bits(rs, shape[1])
    if ts.name == "quant":
        assert tcomp.quant_level_bits(ts.levels) == rcomp.quant_level_bits(rs.levels)


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 7, 8, 16, 100])
def test_quant_level_bits_equal(levels):
    assert tcomp.quant_level_bits(levels) == rcomp.quant_level_bits(levels)


# --------------------------------------------------------------------------
# the chaos layer
# --------------------------------------------------------------------------
SCHEDULE = {"seed": 7, "faults": [{"op": "corrupt", "proc": 2, "rounds": [2, 3]},
                                  {"op": "delay", "proc": 1, "rounds": [1], "arg": 0.01},
                                  {"op": "partition", "proc": 2, "rounds": [4], "arg": 0.5}]}


def test_parse_chaos_same_schedule(tmp_path):
    path = tmp_path / "chaos.json"
    path.write_text(json.dumps(SCHEDULE))
    for src in (SCHEDULE, json.dumps(SCHEDULE), str(path)):
        assert TC.parse_chaos(src).to_json() == RC.parse_chaos(src).to_json()
    parsed = TC.parse_chaos(SCHEDULE)
    assert parsed.ops_for(2, 2).keys() == {"corrupt"} and parsed.ops_for(2, 5) == {}
    assert TC.OPS == RC.OPS and TC._FRAME.format == TF._FRAME.format == RC._FRAME.format
    for bad in ({"seed": 0, "faults": [{"op": "explode", "proc": 1, "rounds": [0]}]},
                {"seed": 0, "faults": [{"op": "drop", "proc": 0, "rounds": [0]}]},
                {"seed": 0, "faults": [{"op": "drop", "proc": 1, "rounds": []}]},
                {"seed": 0, "unknown_key": 1}):
        with pytest.raises(ValueError):
            TC.parse_chaos(bad)


@pytest.mark.parametrize("t", range(6))
def test_corrupt_and_byz_payload_same_bytes(t):
    frame = _good_rows_frame(RF)
    for op, fn in (("corrupt", "corrupt_bytes"), ("byz_payload", "byz_payload_bytes")):
        got = getattr(TC, fn)(frame, TC.fault_rng(6, 1, t, op))
        assert got == getattr(RC, fn)(frame, RC.fault_rng(6, 1, t, op))
        assert got != frame
    ours, theirs = TC.fault_rng(2, 2, t, "corrupt"), RC.fault_rng(2, 2, t, "corrupt")
    assert [ours.random() for _ in range(4)] == [theirs.random() for _ in range(4)]
    # a forged dense header: the CRC passes, the codec refuses
    forged = TC.byz_payload_bytes(frame, TC.fault_rng(6, 1, t, "byz_payload"))
    kind, payload = TF.decode_frame_bytes(forged)
    with pytest.raises(TF.FrameError) as e:
        TF.unpack_rows(payload, (2, 8))
    assert e.value.reason in ("wrong_shape", "bad_payload", "oversize")


class _FakeSock:
    def __init__(self):
        self.sent = b""

    def sendall(self, data):
        self.sent += data


def test_chaos_transport_same_bytes():
    frame = _good_rows_frame(RF)
    schedule = {"seed": 1, "faults": [{"op": "dup", "proc": 1, "rounds": [0]},
                                      {"op": "drop", "proc": 1, "rounds": [1]},
                                      {"op": "partition", "proc": 1, "rounds": [2], "arg": 0.25},
                                      {"op": "corrupt", "proc": 1, "rounds": [3]},
                                      {"op": "byz_payload", "proc": 1, "rounds": [4]}]}
    socks, results = [], []
    for C in (RC, TC):
        sock, tr = _FakeSock(), C.ChaosTransport(schedule, proc=1)
        results.append([tr.send(sock, frame, t) for t in range(6)])
        socks.append(sock.sent)
        assert tr.events["dup"] == 1 and tr.events["corrupt"] == 1 and tr.events["byz_payload"] == 1
    assert results[0] == results[1] and socks[0] == socks[1]
    assert results[1][:3] == [("sent", 0.0), ("dropped", 0.0), ("partition", 0.25)]


def test_chaos_transport_empty_schedule_passes_bytes_through():
    frame = _good_rows_frame(TF)
    sock = _FakeSock()
    tr = TC.ChaosTransport({"seed": 0, "faults": []}, proc=1)
    assert [tr.send(sock, frame, t) for t in range(4)] == [("sent", 0.0)] * 4
    assert sock.sent == frame * 4 and all(v == 0 for v in tr.events.values())


@pytest.mark.parametrize("lat", [[], [0.1, 0.1], [0.01] * 16, [5.0, 5.2, 4.8, 5.1, 5.0], [0.3, 9.0, 0.2, 0.25, 0.4]])
@pytest.mark.parametrize("k", [1.0, 4.0])
def test_adaptive_deadline_equal(lat, k):
    assert TF.adaptive_deadline(lat, 2.0, k=k) == RF.adaptive_deadline(lat, 2.0, k=k)


# --------------------------------------------------------------------------
# configuration and cases
# --------------------------------------------------------------------------
def test_fleet_config_argv_round_trip_and_reference_flags():
    assert TF.FleetConfig.from_argv([]) == TF.FleetConfig() and TF.FleetConfig().to_argv() == []
    cfg = TF.FleetConfig(procs=3, proc_id=2, dim=64, lr=1e-6, distributed=False, compress="quant:4",
                         chaos='{"seed": 1, "faults": []}', resume=True, round_timeout=2.5, device="cpu")
    argv = cfg.to_argv()
    assert "--no-distributed" in argv and "--device" in argv and "--port" not in argv
    assert TF.FleetConfig.from_argv(argv) == cfg
    ours = {f.name: f for f in dataclasses.fields(TF.FleetConfig)}
    for f in dataclasses.fields(RF.FleetConfig):  # every reference field, its type and default
        assert f.name in ours and (ours[f.name].type, ours[f.name].default) == (f.type, f.default), f.name
    assert set(ours) - {f.name for f in dataclasses.fields(RF.FleetConfig)} == {"device"}
    ref = RF.FleetConfig(procs=11, proc_id=4, n_devices=100, d=20, dim=100, steps=20, lr=1e-6, compress="quant:4",
                         chaos='{"seed": 6, "faults": []}', die_after_round=5, stall_after_round=3,
                         stall_seconds=0.5, server_crash_after_round=2, checkpoint="ck", checkpoint_every=2,
                         resume=True, deadline_k=3.0, deadline_window=8, rejoin_timeout=5.0, init_timeout=9.0,
                         aggregator="cwtm", sigma_h=0.1, seed=3, host="localhost", port=1234,
                         coordinator="127.0.0.1:1", distributed=False)
    port = TF.FleetConfig.from_argv(ref.to_argv())
    assert port.to_argv() == ref.to_argv() and port.device == "cuda"
    with pytest.raises(SystemExit):
        TF.FleetConfig.from_argv(["--not-a-flag"])
    with pytest.raises(ValueError):
        TF.FleetConfig(compress="quant:nope").spec()


@pytest.mark.parametrize("procs,steps", [(3, 8), (11, 20), (4, 5)])
def test_fleet_cases_equal(procs, steps):
    assert tscn.fleet_chaos_cases(procs, steps) == rscn.fleet_chaos_cases(procs, steps)
    assert tscn.fleet_comlad_cases(procs, steps) == rscn.fleet_comlad_cases(procs, steps)
    for fn in (tscn.fleet_chaos_cases, tscn.fleet_comlad_cases):
        with pytest.raises(ValueError):
            fn(2)


# --------------------------------------------------------------------------
# the round math on the reference's problem and draws
# --------------------------------------------------------------------------
MATH_CASES = [(GEOMETRY, "identity"), (COMLAD, "identity"), (COMLAD, "quant:4"), (COMLAD, "quant:8"),
              (COMLAD, "randk:16"), (COMLAD, "randk_shared:16"), (COMLAD, "topk:16")]


@pytest.mark.parametrize("geo,text", MATH_CASES, ids=[f"dim{g['dim']}-{t}" for g, t in MATH_CASES])
def test_block_rows_and_coded_block_on_replayed_draws(geo, text):
    rcfg, tcfg = configs(**geo, compress=text)
    _, _, _, block, r_rows, r_coded = RF._fleet_state(rcfg)
    fs = TF.FleetState(tcfg, problem=ref_problem(rcfg), randomness=ref_draws(rcfg))
    assert fs.block == block
    rng = np.random.default_rng(1)
    spec = fs.spec
    for t in range(4):
        x = (rng.standard_normal(rcfg.dim) * 0.1).astype(np.float32)
        xt = torch.from_numpy(x)
        for pid in range(rcfg.procs):
            want = np.asarray(r_rows(t, jnp.asarray(x), pid))
            got = fs.block_rows(t, xt, pid)
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL * np.abs(want).max())
            if spec.name == "quant":
                lo = pid * block
                margin = flip_margin(want, fs.round_randomness(t).quant_u[lo:lo + block].numpy(), spec)
                assert margin > 2 * spec.levels * 2.0 ** -20, (t, pid, margin)
            want_c = np.asarray(r_coded(t, jnp.asarray(x), pid))
            got_c = fs.coded_block(t, xt, pid).numpy()
            np.testing.assert_allclose(got_c, want_c, rtol=RTOL, atol=ATOL * np.abs(want_c).max())
            if spec.name in ("rand_sparse", "rand_sparse_shared", "top_k"):
                assert np.array_equal(got_c == 0, want_c == 0)  # the same coordinates kept


@pytest.mark.parametrize("text", ["quant:4", "randk:16", "randk_shared:16", "topk:16", "identity"])
def test_worker_block_is_the_round_compression_rows(text):
    """Each process's compressed block is bit for bit the rows of the
    compression stage of ``protocol_round`` (``compress_rows`` over all N
    coded rows under the round's draws) for its devices."""
    _, tcfg = configs(**COMLAD, compress=text)
    fs = TF.FleetState(tcfg)
    x = torch.randn((tcfg.dim,), generator=torch.Generator().manual_seed(3)) * 0.1
    for t in range(3):
        rand = fs.round_randomness(t)
        stack = torch.cat([fs.block_rows(t, x, pid) for pid in range(tcfg.procs)])
        whole = tcomp.compress_rows(fs.spec, stack, rand.keep_idx, rand.quant_u)
        for pid in range(tcfg.procs):
            got = fs.coded_block(t, x, pid)
            assert torch.equal(got, whole[pid * fs.block:(pid + 1) * fs.block])


def test_seeded_draws_depend_on_seed_and_round_alone():
    _, tcfg = configs(**COMLAD, compress="quant:4")
    a, b = TF.FleetState(tcfg), TF.FleetState(tcfg)
    for t in (5, 0, 3, 5):  # any order, any process
        ra, rb = a.round_randomness(t), b.round_randomness(t)
        assert torch.equal(ra.task_index, rb.task_index) and torch.equal(ra.quant_u, rb.quant_u)
    assert not torch.equal(a.round_randomness(1).quant_u, a.round_randomness(2).quant_u)
    a.round_randomness(0).validate(tcfg.n_devices, tcfg.dim)


@pytest.mark.parametrize("erased", [(), (2,), (1, 2)])
def test_server_decode_on_replayed_draws(erased):
    rcfg, tcfg = configs(**GEOMETRY)
    r_server = RF._server_decode_fn(rcfg)
    fs = TF.FleetState(tcfg, problem=ref_problem(rcfg), randomness=ref_draws(rcfg))
    server = tbyz.make_server_fn(fs.protocol)
    _, _, r_assign, block, _, _ = RF._fleet_state(rcfg)
    rng = np.random.default_rng(2)
    for t in range(3):
        transmitted = rng.standard_normal((rcfg.n_devices, rcfg.dim)).astype(np.float32)
        mask = np.ones((rcfg.n_devices,), np.float32)
        for pid in erased:
            mask[pid * block:(pid + 1) * block] = 0.0
        ta = r_assign(t)
        pm = jnp.asarray(mask)
        want = r_server(jnp.asarray(transmitted) * pm[:, None], pm, ta.task_index.astype(jnp.int32))
        tpm = torch.from_numpy(mask)
        got = server(torch.from_numpy(transmitted) * tpm[:, None], tpm, fs.round_randomness(t).task_index)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _ckpt_args(n=6, rounds=3):
    wire = RF.new_wire_tallies()
    wire["faults"]["stale"] = 2
    wire["sent"]["round"] = [rounds * 2, 123]
    wire["recv"]["crows"] = [rounds * 2, 456]
    return dict(x=np.linspace(-1, 1, 8, dtype=np.float32), step=rounds, losses=[3.5, 2.25, 1.125],
                n_report=[6, 4, 6], mask_hist=[[1] * n, [1, 1, 1, 1, 0, 0], [1] * n], wire=wire, rejoins=1,
                lat=[0.01, 0.02, 0.03], n=n)


@pytest.mark.parametrize("writer,reader", [(RF, TF), (TF, RF), (TF, TF)], ids=["ref-to-port", "port-to-ref", "port"])
def test_server_checkpoint_loads_across_packages(tmp_path, writer, reader):
    args = _ckpt_args()
    path = str(tmp_path / "ck")
    writer.save_server_checkpoint(path, **args)
    state, step = reader.load_server_checkpoint(path)
    assert step == 3 and int(state["t"]) == 3
    assert np.array_equal(np.asarray(state["x"]), args["x"])
    assert [float(v) for v in np.asarray(state["losses"])] == args["losses"]
    assert np.asarray(state["mask_hist"]).tolist() == args["mask_hist"]
    assert np.asarray(state["n_report"]).tolist() == args["n_report"]
    assert np.asarray(state["wire"]).tolist() == [args["wire"]["faults"][k] for k in RF.WIRE_KEYS]
    assert np.asarray(state["wire_recv"]).tolist() == [args["wire"]["recv"][k] for k in sorted(RF.KIND_NAMES.values())]
    assert int(state["rejoins"]) == 1 and np.asarray(state["lat"]).tolist() == args["lat"]
    assert reader.load_server_checkpoint(str(tmp_path / "absent")) == (None, 0)


# --------------------------------------------------------------------------
# whole fleets in threads
# --------------------------------------------------------------------------
def run_threads(server, workers, cfgs):
    """Run ``server(cfgs[0])`` here and ``workers[pid](cfgs[pid])`` in threads."""
    out, errors = {}, []

    def work(pid):
        try:
            out[pid] = workers[pid](cfgs[pid])
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(pid,), daemon=True) for pid in range(1, len(cfgs))]
    for th in threads:
        th.start()
    res = server(cfgs[0])
    for th in threads:
        th.join(60)
        assert not th.is_alive()
    assert not errors, errors
    return res, out


def per_proc(cfg, n):
    return [dataclasses.replace(cfg, proc_id=pid) for pid in range(n)]


@pytest.fixture(scope="module")
def reference_fleet():
    rcfg, _ = configs(**GEOMETRY, round_timeout=15.0)
    res, _ = run_threads(RF.run_server, {p: RF.run_worker for p in (1, 2)}, per_proc(rcfg, 3))
    assert res["dead"] == [] and res["n_report"] == [6] * 8
    return res


def _rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))))


def test_fleet_in_threads_matches_reference_fleet(reference_fleet):
    rcfg, tcfg = configs(**GEOMETRY, round_timeout=15.0)
    seam = dict(problem=ref_problem(rcfg), randomness=ref_draws(rcfg))
    res, out = run_threads(lambda c: TF.run_server(c, **seam), {p: lambda c: TF.run_worker(c, **seam) for p in (1, 2)},
                           per_proc(tcfg, 3))
    assert _rel(res["losses"], reference_fleet["losses"]) <= TRAJ_RTOL
    for key in ("n_report", "mask_hist", "dead", "wire", "comlad", "rejoins", "resumed_from", "stats"):
        assert res[key] == reference_fleet[key], key
    assert set(res) == set(reference_fleet) | {"launches", "times"}
    assert out[1]["sent"] == {"rows": [8, 8 * TF.predicted_uplink_frame_bytes(tcomp.CompressionSpec(), 2, 8)]}


@pytest.mark.parametrize("server_pkg", ["port", "reference"])
def test_servers_take_the_other_packages_workers(reference_fleet, server_pkg):
    rcfg, tcfg = configs(**GEOMETRY, round_timeout=15.0)
    seam = dict(problem=ref_problem(rcfg), randomness=ref_draws(rcfg))
    if server_pkg == "port":
        server, worker, cfgs = (lambda c: TF.run_server(c, **seam)), RF.run_worker, per_proc(rcfg, 3)
        cfgs[0] = tcfg
    else:
        server, worker, cfgs = RF.run_server, (lambda c: TF.run_worker(c, **seam)), per_proc(tcfg, 3)
        cfgs[0] = rcfg
    res, _ = run_threads(server, {1: worker, 2: worker}, cfgs)
    assert all(v == 0 for v in res["wire"]["faults"].values()), res["wire"]["faults"]
    assert res["wire"] == reference_fleet["wire"] and res["n_report"] == [6] * 8
    assert _rel(res["losses"], reference_fleet["losses"]) <= TRAJ_RTOL


# --------------------------------------------------------------------------
# whole fleets as processes (--device cpu --no-distributed)
# --------------------------------------------------------------------------
def spawn(cfg: TF.FleetConfig, pid: int, *extra: str) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1) // cfg.procs))}  # the processes share the cores
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.fleet",
                             *dataclasses.replace(cfg, proc_id=pid).to_argv(), *extra],
                            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(procs: list[subprocess.Popen], timeout: float = 120.0) -> list[tuple[str, str]]:
    """Every process's (stdout, stderr); kills the rest when one overruns."""
    try:
        return [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def line(out: str, tag: str) -> dict:
    found = [ln for ln in out.splitlines() if ln.startswith(tag + "::")]
    assert found, out
    return json.loads(found[0][len(tag) + 2:])


def run_procs(cfg: TF.FleetConfig, extra: dict[int, list[str]] | None = None, timeout: float = 120.0):
    extra = extra or {}
    procs = [spawn(cfg, pid, *extra.get(pid, [])) for pid in range(cfg.procs)]
    outs = finish(procs, timeout)
    assert procs[0].returncode == 0, outs[0][1][-4000:]
    return line(outs[0][0], "RESULT"), procs, outs


def _proc_cfg(**kw) -> TF.FleetConfig:
    return TF.FleetConfig(**{**COMLAD, "round_timeout": 15.0, "distributed": False, "device": "cpu",
                             "port": free_port(), **kw})


@pytest.fixture(scope="module")
def quant_fleet():
    res, procs, outs = run_procs(_proc_cfg(compress="quant:4"))
    assert [p.returncode for p in procs] == [0, 0, 0], [o[1][-2000:] for o in outs]
    return res, [line(o[0], "RESULT") for o in outs[1:]], line(outs[0][0], "TIMES")


def test_process_fleet_quant4_bytes_as_predicted(quant_fleet):
    res, workers, times = quant_fleet
    com = res["comlad"]
    assert com["spec"] == "quant:4" and com["uplink_frames"] == 2 * 8
    assert com["frame_bytes_measured"] == com["frame_bytes_predicted"]
    assert com["wire_bits_measured"] == com["wire_bits_predicted"]
    dense = TF.predicted_uplink_frame_bytes(tcomp.CompressionSpec(), 2, 64)
    assert dense / com["frame_bytes_measured"] >= 4.0
    assert res["wire"]["recv"]["crows"] == [com["uplink_frames"], com["uplink_bytes"]]
    assert res["wire"]["recv"]["rows"] == [0, 0]
    assert sum(w["sent"]["crows"][1] for w in workers) == com["uplink_bytes"]
    assert res["losses"][-1] < res["losses"][0] and res["dead"] == []
    # the plain versions run on the CPU, so no kernel launched
    assert all(v == 0 for v in res["launches"].values()) and all(
        v == 0 for w in workers for v in w["launches"].values())
    assert len(times["round_ms"]) == 8 and times["ready_at"] > 0


def test_process_fleet_killed_worker_is_permanent_erasure():
    res, procs, outs = run_procs(_proc_cfg(dim=8, lr=1e-5), {2: ["--die-after-round", "2"]})
    assert procs[2].returncode == 17, outs[2][1][-2000:]
    assert res["dead"] == [2] and res["n_report"] == [6, 6, 4, 4, 4, 4, 4, 4]
    for t, mask in enumerate(res["mask_hist"]):
        assert mask == ([1] * 6 if t < 2 else [1, 1, 1, 1, 0, 0]), (t, mask)
    losses = res["losses"]
    assert all(b < a for a, b in zip(losses, losses[1:])), losses  # 2 erasures = margin(3): still exact
    assert res["stats"]["max_erasures"] <= res["stats"]["margin"]


def test_process_fleet_server_crash_then_resume_is_bitwise(quant_fleet, tmp_path):
    """The server hard-exits after round 3 (its checkpoint of round 4
    written); a new server ``--resume``s on the same port while the workers
    ride their reconnect backoff. The losses are bit for bit those of the
    uninterrupted ``quant:4`` fleet."""
    cfg = _proc_cfg(compress="quant:4", rejoin_timeout=60.0)
    ck = str(tmp_path / "ck")
    server1 = spawn(cfg, 0, "--checkpoint", ck, "--checkpoint-every", "2", "--server-crash-after-round", "3")
    workers = [spawn(cfg, pid) for pid in (1, 2)]
    try:
        out1 = server1.communicate(timeout=120)
        assert server1.returncode == 23, out1[1][-2000:]
        server2 = spawn(cfg, 0, "--checkpoint", ck, "--resume")
        outs = finish([server2, *workers])
    finally:
        for p in workers:
            if p.poll() is None:
                p.kill()
    assert server2.returncode == 0 and [w.returncode for w in workers] == [0, 0], [o[1][-1500:] for o in outs]
    res = line(outs[0][0], "RESULT")
    want = quant_fleet[0]
    assert res["resumed_from"] == 4 and res["dead"] == []
    assert res["losses"] == want["losses"] and res["final_loss"] == want["final_loss"]
    assert res["mask_hist"] == want["mask_hist"]


def test_no_card_and_no_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is it")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.fleet", "--procs", "1"],
                          env={**os.environ, "PYTHONPATH": str(REPO / "src")}, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert "RESULT::" not in proc.stdout


# --------------------------------------------------------------------------
# slow tier: the reference bench's cases
# --------------------------------------------------------------------------
BENCH = REPO / "benchmarks" / "out" / "BENCH_fleet_chaos.json"


def _bench_run(cfg: TF.FleetConfig, chaos: dict | None, extra: list[str] = ()):
    procs = []
    for pid in range(cfg.procs):
        c = cfg
        if pid:
            c = dataclasses.replace(c, rejoin_timeout=30.0)
            if chaos is not None:
                c = dataclasses.replace(c, chaos=json.dumps(chaos, sort_keys=True))
        procs.append(spawn(c, pid, *extra))
    outs = finish(procs, 300.0)
    assert procs[0].returncode == 0, outs[0][1][-3000:]
    return line(outs[0][0], "RESULT")


@pytest.mark.slow
def test_chaos_cases_against_reference_bench():
    oracle = json.loads(BENCH.read_text())
    cfg = TF.FleetConfig(procs=oracle["procs"], n_devices=oracle["n_devices"], d=oracle["d"], dim=oracle["dim"],
                         steps=oracle["steps"], lr=1e-5, seed=0, round_timeout=oracle["round_timeout"],
                         distributed=False, device="cpu")
    rows = {r["name"]: r for r in oracle["rows"]}
    plain = _bench_run(dataclasses.replace(cfg, port=free_port()), None)
    for case in tscn.fleet_chaos_cases(cfg.procs, steps=cfg.steps):
        res = _bench_run(dataclasses.replace(cfg, port=free_port()), case["chaos"])
        want = rows[case["name"]]
        assert res["dead"] == want["dead"] and min(res["n_report"]) == want["n_report_min"], case["name"]
        assert res["wire"]["faults"] == want["wire"]["faults"], case["name"]
        if case["within_margin"]:
            assert res["stats"]["max_erasures"] <= res["stats"]["margin"]
            assert abs(res["final_loss"] - plain["final_loss"]) <= ENVELOPE_RTOL * abs(plain["final_loss"])
        if case["name"] == "healthy":
            assert res["wire"] == want["wire"]
            assert {k: v for k, v in res.items() if k != "launches"} == {
                k: v for k, v in plain.items() if k != "launches"}


@pytest.mark.slow
def test_comlad_cases_as_the_reference_bench():
    cfg = TF.FleetConfig(procs=3, n_devices=6, d=3, dim=64, steps=8, lr=1e-6, seed=0, round_timeout=2.5,
                         distributed=False, device="cpu")
    plain = _bench_run(dataclasses.replace(cfg, port=free_port()), None)
    for case in tscn.fleet_comlad_cases(cfg.procs, steps=cfg.steps):
        res = _bench_run(dataclasses.replace(cfg, port=free_port()), case["chaos"], ["--compress", case["compress"]])
        com = res["comlad"]
        rel_dev = abs(res["final_loss"] - plain["final_loss"]) / abs(plain["final_loss"])
        ratio = plain["comlad"]["uplink_bytes_per_round"] / com["uplink_bytes_per_round"]
        if case["name"] == "identity":
            assert res == plain
        if case["chaos"] is None:
            assert com["uplink_frames"] == (cfg.procs - 1) * cfg.steps
            if com["spec"].startswith(("identity", "quant")):
                assert com["frame_bytes_measured"] == com["frame_bytes_predicted"]
            assert ratio >= case["min_ratio"], (case["name"], ratio)
        else:
            faults = res["wire"]["faults"]
            assert sum(faults.values()) >= sum(len(f["rounds"]) for f in case["chaos"]["faults"]), faults
            assert faults["wrong_shape"] + faults["bad_payload"] >= 1, faults
            assert min(res["n_report"]) < cfg.n_devices
        if case["within_envelope"]:
            assert rel_dev <= ENVELOPE_RTOL, (case["name"], rel_dev)
