"""The port's tooling on the CPU: the lane-capacity tuner behind
``max_lanes_per_device="auto"`` (``repro_torch.launch.tuner``), the
crossover dispatch and launch work of ``kernels/ops.py``, ``timing.
block_time``, the roofline (``repro_torch.launch.roofline``), the captured
round's launch list, and the five ``examples/torch_*.py``.

Against the reference: the search (power phase, upturn stop, out-of-memory
bisection, clamp) gives the reference's ``(capacity, measured)`` on the same
fake probes (the port's probe raises ``torch.OutOfMemoryError``, the
reference's a resource-exhausted ``RuntimeError``); ``derive_terms``,
``percent_of_peak``, ``active_params`` and ``model_flops`` equal the
reference's on the same inputs, the last two for every arch of
``configs/archs.ARCHS`` (the port builds their parameter shapes on the
``meta`` device).

Inside the port, bit for bit: ``"auto"`` equals hand-picked capacities 1, 2
and ``None`` through ``engine.run_grid``, ``scenarios.run_grid``,
``run_lm_grid`` and ``run_zoo_sweep`` (loop mode), a warm call makes 0
probes, and the per-lane loop of single-lane launches equals the batched
launch. Over 2 ``gloo`` ranks (``tests/torch_tuner_ranks.py``, a time limit
a process) the ranks agree on every probe: each reports another time and
one alone runs out of memory, and both choose one capacity and equal the
unsharded grid.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import archs as jarchs
from repro.configs import base as jbase
from repro.launch import roofline as jroof
from repro.launch import tuner as jtuner
from repro_torch.configs import archs as tarchs
from repro_torch.configs import base as tbase
from repro_torch.core import engine, scenarios
from repro_torch.kernels import attacks as tattacks
from repro_torch.kernels import ops
from repro_torch.launch import roofline, tuner
from repro_torch.timing import block_time

import torch_tuner_ranks as ranks

REPO = Path(__file__).resolve().parent.parent
STEPS, DIM = 3, 8


@pytest.fixture()
def mem_store():
    """Isolate every test from the user's on-disk tuner store."""
    store = tuner.set_store_path(None)
    yield store
    tuner.reset_store()


def same_bits(a, b) -> bool:
    if not torch.equal(a.x, b.x) or sorted(a.metrics) != sorted(b.metrics):
        return False
    return all(torch.equal(a.metrics[k], b.metrics[k]) for k in a.metrics)


def _match(got: dict, want: dict) -> None:
    for name, w in want.items():
        assert same_bits(got[name], w), name


# --------------------------------------------------------- search: the reference's


class _Oom:
    """A probe that fails above ``limit`` as each package's out-of-memory error."""

    def __init__(self, limit, time_of):
        self.limit, self.time_of, self.probed = limit, time_of, []

    def __call__(self, error):
        def probe(c):
            self.probed.append(c)
            if self.limit is not None and c > self.limit:
                raise error()
            return self.time_of(c)
        return probe


SEARCH_CASES = {  # (limit, time of a chunk at capacity c, n_lanes, n_devices)
    "fastest-feasible": (None, lambda c: {1: 1.0, 2: 0.6, 4: 0.3, 8: 0.5, 16: 0.9}[c] * c, 16, 1),
    "upturn-stops": (None, lambda c: {1: 1.0, 2: 0.4, 4: 2.0}[c] * c, 64, 1),
    "oom-bisection": (5, lambda c: 1.0 / c, 64, 1),
    "clamp": (None, lambda c: 1.0, 6, 2),
    "oom-at-2-over-4-devices": (1, lambda c: 0.5 * c, 32, 4),
}


@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_tune_matches_reference(case):
    """The port's search gives the reference's capacity, per-lane
    measurements (``None`` out of memory) and probe order."""
    limit, time_of, n_lanes, n_devices = SEARCH_CASES[case]
    mine, ref = _Oom(limit, time_of), _Oom(limit, time_of)
    got = tuner.tune_lane_capacity(mine(lambda: torch.OutOfMemoryError("CUDA error: out of memory")),
                                   n_lanes=n_lanes, n_devices=n_devices)
    want = jtuner.tune_lane_capacity(ref(lambda: RuntimeError("RESOURCE_EXHAUSTED: out of memory allocating")),
                                     n_lanes=n_lanes, n_devices=n_devices)
    assert got == want
    assert mine.probed == ref.probed
    if case == "oom-bisection":
        assert got[0] == 5 and got[1][8] is None and got[1][6] is None and got[1][5] is not None
    if case == "upturn-stops":
        assert mine.probed == [1, 2, 4]
    if case == "clamp":
        assert max(mine.probed) == 3  # ceil(6 / 2)


@pytest.mark.parametrize("error,match", [(torch.OutOfMemoryError("tried to allocate 80.00 GiB"), "does not fit"),
                                         (ValueError("shape mismatch"), "shape mismatch")])
def test_tune_capacity_one_oom_raises_and_other_errors_propagate(error, match):
    """Out of memory at capacity 1 is an error (an OutOfMemoryError is one
    by its type, whatever its text); any other error propagates."""
    def probe(c):
        raise error

    with pytest.raises((RuntimeError, ValueError), match=match):
        tuner.tune_lane_capacity(probe, n_lanes=4, n_devices=2)
    assert tuner._is_oom(torch.OutOfMemoryError("no marker here"))
    assert not tuner._is_oom(RuntimeError("no marker here"))


def test_auto_cache_hit_makes_zero_reprobes(mem_store):
    def probe(c):
        return {1: 1.0, 2: 0.5}[c] * c

    cap = tuner.auto_max_lanes(probe, n_lanes=2, n_devices=1, signature=("sig",), store=mem_store)
    assert cap == 2
    assert tuner.tuner_stats()["misses"] == 1 and tuner.tuner_stats()["probes"] > 0
    tuner.reset_tuner_stats()

    def must_not_probe(c):  # pragma: no cover - the assertion is that it never runs
        raise AssertionError("cache hit must not re-probe")

    assert tuner.auto_max_lanes(must_not_probe, n_lanes=2, n_devices=1, signature=("sig",), store=mem_store) == 2
    assert tuner.tuner_stats() == {"probes": 0, "hits": 1, "misses": 0}
    # a smaller sweep reuses the tuning, clamped to its own lane ceiling
    assert tuner.auto_max_lanes(must_not_probe, n_lanes=1, n_devices=1, signature=("sig",), store=mem_store) == 1


def test_store_roundtrips_and_discards_corrupt(tmp_path):
    path = str(tmp_path / "tuner.json")
    store = tuner.TunerStore(path)
    store.record_capacity("k1", {"capacity": 3})
    store.record_crossover("cwtm", 8, 10.0, 5.0)
    again = tuner.TunerStore(path)
    assert again.capacity_for("k1") == 3
    assert again.crossover_for("cwtm", 8) == {"batched_us": 10.0, "loop_us": 5.0}
    with open(path, "w") as f:
        f.write("{ not json")
    assert tuner.TunerStore(path).capacity_for("k1") is None  # fresh, no raise
    with open(path, "w") as f:
        json.dump({"schema_version": 999, "lane_capacity": {"k1": {"capacity": 3}}}, f)
    assert tuner.TunerStore(path).capacity_for("k1") is None  # version mismatch
    assert tuner.SCHEMA_VERSION == jtuner.SCHEMA_VERSION == 1
    assert tuner._UPTURN_TOLERANCE == jtuner._UPTURN_TOLERANCE


def test_default_store_is_the_ports_own(monkeypatch, tmp_path):
    """``$REPRO_TORCH_TUNER_CACHE``, else ``~/.cache/repro_torch/tuner.json``:
    never the reference's store."""
    monkeypatch.delenv("REPRO_TORCH_TUNER_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert tuner._default_store_path() == str(tmp_path / ".cache" / "repro_torch" / "tuner.json")
    assert tuner._default_store_path() != jtuner._default_store_path()
    monkeypatch.setenv("REPRO_TORCH_TUNER_CACHE", str(tmp_path / "t.json"))
    assert tuner._default_store_path() == str(tmp_path / "t.json")


def test_lane_dispatch_fallback_and_nearest_bucket(mem_store):
    assert tuner.lane_dispatch("cwtm", 8, store=mem_store) == "batched"
    tuner.record_crossover("cwtm", 4, batched_us=10.0, loop_us=2.0, store=mem_store)
    tuner.record_crossover("cwtm", 64, batched_us=10.0, loop_us=50.0, store=mem_store)
    assert tuner.lane_dispatch("cwtm", 3, store=mem_store) == "loop"  # nearest: 4
    assert tuner.lane_dispatch("cwtm", 48, store=mem_store) == "batched"  # nearest: 64


def test_signature_key_is_stable_distinct_and_the_references():
    sig = ("grid", "cfg", 5, "sgd", "none")
    assert tuner.signature_key(sig) == tuner.signature_key(sig) == jtuner.signature_key(sig)
    assert tuner.signature_key(sig) != tuner.signature_key(sig + ("x",))


def test_grid_signature_leaves_out_the_lane_count(mem_store):
    """Sweeps of 4 and of 6 lanes of one structure share one tuning; a
    change of width or steps does not."""
    keys = []
    for n, dim, steps in ((4, DIM, STEPS), (6, DIM, STEPS), (4, DIM + 1, STEPS), (4, DIM, STEPS + 1)):
        tuner.set_store_path(None)
        scenarios.run_grid(scenarios.synthetic_sweep(n, n_devices=10, n_byz=2), steps, dim=dim, device="cpu",
                           mode="loop", max_lanes_per_device="auto")
        keys.append(list(tuner.get_store().data["lane_capacity"]))
    assert keys[0] == keys[1]
    assert keys[2] != keys[0] and keys[3] != keys[0]


# ------------------------------------------------ auto == hand-picked, bit for bit


def _engine_call(rows, **kw):
    """``engine.run_grid`` over the rows' configurations on one shared
    problem (``data_batched=False``)."""
    gen = torch.Generator().manual_seed(3)
    z, y = scenarios.linear_regression_problem(gen, n=rows[0].n_devices, dim=DIM, sigma_h=0.3)
    cfgs = [r.protocol() for r in rows]
    return engine.run_grid(cfgs, torch.zeros(DIM), scenarios._subset_grads, steps=STEPS, lr=[r.lr for r in rows],
                           randomness=[torch.Generator().manual_seed(i) for i in range(len(rows))], data=(z, y),
                           data_batched=False, loss_fn=scenarios._loss, device="cpu", mode="loop", **kw)


def _entry(entry):
    rows = scenarios.synthetic_sweep(5, n_devices=10, n_byz=2)
    if entry == "engine":
        def call(cap):
            res = _engine_call(rows, max_lanes_per_device=cap)
            return {str(i): res.lane(i) for i in range(len(rows))}
        return call
    if entry == "scenarios":
        return lambda cap: scenarios.run_grid(rows, STEPS, dim=DIM, device="cpu", mode="loop",
                                              max_lanes_per_device=cap)
    if entry == "lm":  # one bucket of 3 lanes
        lm_rows = scenarios.lm_sweep((("lad", 2),), compressors=("none",))
        return lambda cap: scenarios.run_lm_grid(lm_rows, 1, device="cpu", mode="loop", max_lanes_per_device=cap)
    sweep = scenarios.zoo_sweep(("moe",), (("lad", 2),), attacks=("sign_flip", "alie"))  # one bucket of 2 lanes
    return lambda cap: scenarios.run_zoo_sweep(1, sweep=sweep, device="cpu", mode="loop",
                                               max_lanes_per_device=cap)["moe"]


@pytest.mark.parametrize("entry", ["engine", "scenarios", "lm", "zoo"])
def test_auto_equals_hand_picked_bitwise(mem_store, entry):
    """``"auto"`` equals capacities 1, 2 and ``None`` bit for bit; the warm
    call makes 0 probes and gives the same bits."""
    call = _entry(entry)
    auto = call("auto")
    info = engine.last_grid_chunk_info()
    assert info["auto"] is True and info["max_lanes_per_device"] >= 1
    stats = tuner.tuner_stats()
    assert stats["misses"] >= 1 and stats["probes"] >= 1
    for cap in (1, 2, None):
        _match(auto, call(cap))
    tuner.reset_tuner_stats()
    _match(call("auto"), auto)
    assert tuner.tuner_stats()["probes"] == 0, "the warm auto call probed"
    assert tuner.tuner_stats()["hits"] >= 1


@pytest.mark.parametrize("entry", ["engine", "scenarios", "lm"])
def test_auto_rejects_unknown_string(mem_store, entry):
    with pytest.raises(ValueError, match="'auto'"):
        _entry(entry)("fastest")


def test_probe_out_of_memory_bisects_and_keeps_the_bits(mem_store, monkeypatch):
    """A chunk of more than 3 lanes runs out of memory: the tuner bisects
    to 3, the sweep runs in chunks of 3 and equals the unchunked sweep.

    The probe runs the real chunk but reports a fixed time for each lane
    count (bigger is faster a lane), so that the frontier wins however
    long the chunk took on a busy host."""
    real = engine.block_time

    def limited(fn, start, lanes, gather, **kw):
        if lanes > 3:
            raise torch.OutOfMemoryError(f"CUDA out of memory: {lanes} lanes")
        real(fn, start, lanes, gather, **kw)
        return 1.0 / lanes

    monkeypatch.setattr(engine, "block_time", limited)
    rows = scenarios.synthetic_sweep(7, n_devices=10, n_byz=2)
    auto = scenarios.run_grid(rows, STEPS, dim=DIM, device="cpu", mode="loop", max_lanes_per_device="auto")
    (rec,) = tuner.get_store().data["lane_capacity"].values()
    assert rec["capacity"] == 3 and engine.last_grid_chunk_info()["chunk"] == 3
    assert rec["per_lane_s"]["4"] is None and rec["per_lane_s"]["3"] is not None
    monkeypatch.setattr(engine, "block_time", real)
    _match(auto, scenarios.run_grid(rows, STEPS, dim=DIM, device="cpu", mode="loop"))


def test_probe_lets_the_original_oom_through_a_capture_error():
    """An out-of-memory error under a capture may come out with the
    capture's own error raised on top of it: the probe raises the original
    one, and frees what the failed chunk's frames held."""
    def chunk(start, lanes, gather):
        big = torch.zeros(1 << 16)  # noqa: F841 - a local of the failed frame, freed by the probe
        try:
            raise torch.OutOfMemoryError("CUDA out of memory (under capture)")
        except torch.OutOfMemoryError:
            raise RuntimeError("operation failed due to a previous error during capture")

    with pytest.raises(torch.OutOfMemoryError, match="under capture") as err:
        engine._probe_chunk(chunk, 2, 1, None, torch.device("cpu"))
    assert tuner._is_oom(err.value)
    assert all(f.tb_frame.f_locals.get("big") is None for f in _frames(err.value.__traceback__)
               if f.tb_frame.f_code.co_name == "chunk")
    with pytest.raises(RuntimeError, match="not memory"):  # any other error propagates as itself
        engine._probe_chunk(lambda *a: (_ for _ in ()).throw(RuntimeError("not memory")), 1, 1, None,
                            torch.device("cpu"))


def _frames(tb):
    while tb is not None:
        yield tb
        tb = tb.tb_next


def test_ranks_agree_on_every_probe(tmp_path):
    """2 ``gloo`` ranks: rank 0's probes favour capacity 1, rank 1's
    capacity 2, and rank 1 alone runs out of memory at 3. Both take the
    largest time a probe and treat rank 1's out-of-memory as everyone's:
    both choose 2 with no hang, record the same measurements, re-probe
    together when only one holds the capacity, and equal the unsharded
    grid bit for bit."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, ranks.__file__, str(tmp_path), str(r), "2"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for g in got:
        assert int(g["capacity"]) == ranks.AGREED == int(g["capacity_again"]) == int(g["capacity_warm"])
        assert json.loads(str(g["measured"])) == ranks.AGREED_MEASURED
        assert int(g["warm_probes"]) == 0 and int(g["again_probes"]) == len(ranks.AGREED_MEASURED)
        for k in ("x", "loss"):
            np.testing.assert_array_equal(g[k], g[f"none/{k}"])
    np.testing.assert_array_equal(got[0]["x"], got[1]["x"])


# ------------------------------------------------------------ kernels/ops.py


def _attack_stack(lanes=5, n=6, q=40):
    gen = torch.Generator().manual_seed(9)
    msgs = torch.randn((lanes, n, q), generator=gen)
    mask = (torch.arange(n) < 2).float().expand(lanes, n).contiguous()
    return msgs, mask


def test_loop_dispatch_equals_batched_launch(mem_store):
    """``_lane_launch`` over the per-lane slices the crossover table asks
    for gives the bits of one batched launch (here the launch runs the
    plain version, as a stand-in for the kernel the card launches)."""
    msgs, mask = _attack_stack()
    launch = lambda m, k, out: out.copy_(tattacks.plain(m, k, "alie", 1.5))  # noqa: E731
    batched_slices = ops._slices("attack", 5, ops._MAX_GRID_Y, rows=6, q=40)
    tuner.record_crossover("attack", 5, batched_us=10.0, loop_us=1.0)
    assert ops._slices("attack", 5, ops._MAX_GRID_Y, rows=6, q=40) == batched_slices  # no table passed in
    with ops.crossover(functools.partial(tuner.lane_dispatch, store=mem_store)):
        loop_slices = ops._slices("attack", 5, ops._MAX_GRID_Y, rows=6, q=40)
        assert ops._slices("attack", ops._LOOP_UNROLL_MAX + 1, ops._MAX_GRID_Y, rows=6, q=40) == [
            (0, ops._LOOP_UNROLL_MAX + 1)]  # past the loop's bound, one launch
    assert batched_slices == [(0, 5)] and loop_slices == [(i, i + 1) for i in range(5)]
    assert ops._dispatch is None
    before = ops.launch_counts()["attack"]
    got = ops._lane_launch("attack", launch, torch.empty_like(msgs), loop_slices, msgs, mask)
    assert ops.launch_counts()["attack"] - before == 5
    assert torch.equal(got, ops._lane_launch("attack", launch, torch.empty_like(msgs), batched_slices, msgs, mask))


LAUNCH_WORK = [  # (kernel, call, lanes, rows, q, kw): shapes the wrappers see
    ("gather_combine", lambda x: ops.gather_combine(x, torch.zeros(x.shape[:-1] + (2,), dtype=torch.int64),
                                                    torch.full((2,), 0.5)), 3, 8, 50, dict(d=2)),
    ("attack", lambda x: ops.attack(x, torch.zeros(x.shape[:-1]), "alie", 1.5), 3, 8, 50, {}),
    ("cwtm", lambda x: ops.cwtm(x, 2), 3, 8, 50, dict(trim=2)),
    ("gram", lambda x: ops.gram(x), 3, 8, 50, {}),
    ("quantize", lambda x: ops.stochastic_quantize(x, torch.rand(x.shape), 4, 16), 24, 1, 50, {}),
    ("masked_combine", lambda x: ops.masked_combine(x, torch.ones(x.shape[:-1])), 3, 8, 50, {}),
    ("coded_combine", lambda x: ops.coded_combine(x[..., :2, :].contiguous(), torch.ones(2)), 3, 2, 50, {}),
]


@pytest.mark.parametrize("case", range(len(LAUNCH_WORK)), ids=[c[0] for c in LAUNCH_WORK])
def test_launch_work_of_every_kernel(mem_store, case):
    """``record_launches`` logs the launch the card would make, with the
    bytes and operations of ``launch_work`` (the formulas behind PERF.md's
    bound column)."""
    name, call, lanes, rows, q, kw = LAUNCH_WORK[case]
    with ops.record_launches() as log:
        call(torch.randn((3, 8, 50)))
    assert [e["kernel"] for e in log] == [name]
    assert log[0]["lanes"] == lanes and log[0]["rows"] == rows and log[0]["q"] == q
    assert (log[0]["bytes"], log[0]["flops"]) == ops.launch_work(name, lanes, rows, q, **kw)
    per = {  # per lane: (fp32 values moved, operations)
        "gather_combine": (2 * rows * q, 2 * 2 * rows * q), "attack": (2 * rows * q, 8 * rows * q),
        # a min and a max for each of the 19 compare-exchanges of Batcher's network on 8 slots
        "cwtm": (rows * q + q, (2 * 19 + rows - 4 + 1) * q),
        # an FMA for each of the N (N + 1) / 2 pairs that symmetry leaves, a column
        "gram": (rows * q + rows * rows + rows, rows * (rows + 1) * q),
        "quantize": (3 * q, 10 * q), "masked_combine": (rows * q + q, 2 * rows * q),
        "coded_combine": (rows * q + q, 2 * rows * q)}[name]
    assert ops.launch_work(name, lanes, rows, q, **kw) == (4.0 * per[0] * lanes, float(per[1] * lanes))
    assert ops.launch_work("cwtm", 1, 8, q, trim=2, k=6)[1] - ops.launch_work("cwtm", 1, 8, q, trim=2)[1] == 8 * 7 * q


def test_grid_launch_list_counts_section7_buckets(mem_store):
    """Each of ``section7_grid()``'s 5 buckets (3 lanes, one per attack):
    one encode, one attack launch per attack run, one CWTM launch a round
    (DRACO's vote is the median through it); each launch's work is
    ``launch_work``'s, and the list is what a loop-mode round of the
    grid launches. A sweep of several buckets is refused."""
    rows = scenarios.section7_grid()
    buckets: dict = {}
    for r in rows:
        buckets.setdefault(scenarios._bucket_signature(r), []).append(r)
    assert len(buckets) == 5
    for group in buckets.values():
        listed = scenarios.grid_launch_list(group, 4, dim=DIM, device="cpu", mode="loop")
        counts = {k: len(v) for k, v in listed.items() if v}
        assert counts == {"gather_combine": 1, "attack": 3, "cwtm": 1}, (group[0].name, counts)
        for name, launches in listed.items():
            for e in launches:
                shape = {k: e[k] for k in ("rows", "q", "d", "trim", "k") if k in e}
                assert (e["bytes"], e["flops"]) == ops.launch_work(name, e["lanes"], **shape)
        with ops.record_launches() as log:
            scenarios.run_grid(group, 1, dim=DIM, device="cpu", mode="loop")
        assert sorted(e["kernel"] for e in log) == sorted(e["kernel"] for v in listed.values() for e in v)
    with pytest.raises(ValueError, match="single compile bucket"):
        scenarios.grid_launch_list(rows, 4, dim=DIM, device="cpu", mode="loop")
    chunked = scenarios.grid_launch_list(scenarios.synthetic_sweep(6, n_devices=10, n_byz=2), 4, dim=DIM,
                                         device="cpu", mode="loop", max_lanes_per_device=2)
    assert sum(e["lanes"] for e in chunked["cwtm"]) == 2  # the first chunk's round


# ------------------------------------------------------------------ timing


def test_block_time_on_the_cpu():
    calls = []

    def fn(x):
        calls.append(x)
        time.sleep(0.01)

    t = block_time(fn, 1, iters=3, warmup=2)
    assert len(calls) == 5
    assert 0.009 <= t < 0.5
    assert block_time(lambda: None, iters=1, warmup=0) >= 0.0
    with pytest.raises(ValueError, match="iters"):
        block_time(fn, 1, iters=0)


# ---------------------------------------------------------------- roofline


def test_roofline_pure_functions_equal_the_references():
    cost, coll = {"flops": 3.2e12, "bytes accessed": 7.5e9}, {"total_wire_bytes": 1.1e9}
    for kw in (dict(), dict(model_flops_total=2.4e13, chips=4), dict(model_flops_total=1e12)):
        assert (roofline.derive_terms(cost, coll, device="tpu", **kw).as_dict()
                == jroof.derive_terms(cost, coll, **kw).as_dict())
    assert roofline.derive_terms({}, {}, device="tpu").as_dict() == jroof.derive_terms({}, {}).as_dict()
    analysis = {"predicted_s": 0.004}
    for measured, calls in ((0.01, 1.0), (0.002, 3.0), (1e-9, 1.0)):
        assert roofline.percent_of_peak(analysis, measured, calls) == jroof.percent_of_peak(analysis, measured, calls)
    with pytest.raises(ValueError):
        roofline.percent_of_peak(analysis, 0.0)
    for key in ("tpu", "cpu"):
        assert roofline.PLATFORM_PEAKS[key] == jroof.PLATFORM_PEAKS[key]


def test_platform_peaks_has_the_h100_and_refuses_an_unknown_card(monkeypatch):
    h100 = roofline.platform_peaks("NVIDIA H100 80GB HBM3")
    assert h100 == {"peak_flops": 67e12, "tensor_flops": 989e12, "mem_bw": 3.35e12, "link_bw": 450e9}
    assert roofline.platform_peaks("cpu") == roofline.PLATFORM_PEAKS["cpu"]
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert roofline.platform_peaks(torch.device("cuda", 0)) is roofline.PLATFORM_PEAKS[roofline.H100]
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError, match="A100"):
        roofline.platform_peaks(torch.device("cuda", 0))  # the reference would fall back to the CPU's
    with pytest.raises(KeyError):
        roofline.platform_peaks("NVIDIA A100-SXM4-80GB")


def test_derive_terms_takes_the_named_devices_peaks(monkeypatch):
    """``derive_terms`` divides by the peaks of the device its caller names:
    the H100's for the card, and no TPU figures for a card without an entry."""
    cost, coll = {"flops": 6.7e12, "bytes accessed": 3.35e9}, {"total_wire_bytes": 4.5e8}
    got = roofline.derive_terms(cost, coll, device=roofline.H100)
    assert got.compute_s == pytest.approx(0.1) and got.memory_s == pytest.approx(1e-3)
    assert got.collective_s == pytest.approx(1e-3) and got.dominant == "compute"
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError, match="A100"):
        roofline.derive_terms(cost, coll, device=torch.device("cuda", 0))
    with pytest.raises(TypeError):
        roofline.derive_terms(cost, coll)  # the device is not optional


def test_analyze_launches_bounds_the_listed_kernels_only():
    listed = {"attack": [{"kernel": "attack", "bytes": 3.35e9, "flops": 6.7e9}],
              "cwtm": [{"kernel": "cwtm", "bytes": 0.0, "flops": 1.34e12}, {"kernel": "cwtm", "bytes": 0.0,
                                                                             "flops": 0.0}]}
    got = roofline.analyze_launches(listed, roofline.H100)
    assert got["launches"] == 3 and got["bytes_hbm"] == 3.35e9 and got["flops"] == 6.7e9 + 1.34e12
    assert got["memory_s"] == pytest.approx(1e-3) and got["compute_s"] == pytest.approx(20.1e-3)
    assert got["predicted_s"] == got["compute_s"] and got["dominant"] == "compute"


@pytest.mark.parametrize("name", sorted(tarchs.ARCHS))
def test_active_params_and_model_flops_equal_the_references(name):
    """Every arch, the largest included: the port counts on ``meta``
    tensors and allocates nothing."""
    got, want = roofline.active_params(tarchs.ARCHS[name]), jroof.active_params(jarchs.ARCHS[name])
    assert got == want
    for shape in tbase.INPUT_SHAPES:
        for d in (1, 2):
            assert roofline.model_flops(tarchs.ARCHS[name], tbase.INPUT_SHAPES[shape], n_active=got,
                                        d_redundancy=d) == jroof.model_flops(
                jarchs.ARCHS[name], jbase.INPUT_SHAPES[shape], n_active=want, d_redundancy=d)


# ---------------------------------------------------------------- examples

EXAMPLES = {  # example: arguments of a cut run on the CPU
    "torch_quickstart.py": ["--steps", "6", "--seq-len", "16"],
    "torch_linear_regression_paper.py": ["--steps", "200"],
    "torch_compressed_training.py": ["--steps", "250"],
    "torch_scenario_sweep.py": ["--steps", "30", "--attacks", "sign_flip", "alie", "--compressors", "none",
                                "--max-lanes-per-device", "auto"],
    "torch_serve_decode.py": ["--prompt-len", "8", "--new-tokens", "4"],
}


@pytest.mark.parametrize("example", list(EXAMPLES))
def test_example_runs_on_the_cpu(example, tmp_path):
    """Each example on the CPU at a cut size: exits 0 past its own asserts
    of the paper's orderings."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "REPRO_TORCH_TUNER_CACHE": str(tmp_path / "t.json"),
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, str(REPO / "examples" / example), "--device", "cpu", *EXAMPLES[example]],
                          env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "OK" in proc.stdout
