#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the four CUDA kernels of the protocol round from ``src/repro_torch/
csrc`` and prints one JSON line per phase:

  device      the card, its power limit and the kernel build time;
  trajectory  the paper's Section-VII trainer on the card (N=100, dim=100,
              200 rounds) for every Fig. 4 row except DRACO and three Fig. 6
              rows; asserts the paper's orderings and holds the
              LAD-CWTM-NNM-d10 loss curve against the same run on the CPU
              (the plain versions) under the same randomness;
  wide_round  one protocol round at the gradient width of smollm-360m
              (Q = 361,821,120; N=8, d=2, CWTM-NNM, ALIE then sign-flip),
              after a warm-up round: per-stage ms (the server split into
              Gram distances, NNM mix and CWTM), peak memory, finiteness;
  kernels     per kernel: its error against its plain version on the card
              (at small shapes, and at the wide shape on columns past
              element 2^31), its time at the wide shape beside the plain
              version's, a PyTorch library call's where one computes the
              same function, and the least time the card could take; plus
              its launches during the two phases above, which must all be
              above 0;

then the card's name and power limit as ``nvidia-smi`` gives them, and, as
the last line, ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero. Without a CUDA card, or without the
repository's ``src/repro_torch`` beside it, it exits non-zero at once.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

WIDE_Q = 361_821_120  # parameters of smollm-360m: the gradient width of one round
WIDE_N = 8
PLAIN_Q = 1 << 26  # the plain versions are timed on this many coordinates
CHECK_SHAPES = ((100, 100), (100, (1 << 20) + 37), (8, 1 << 20))  # (N, Q)
RTOL, ATOL = 1e-5, 1e-6  # kernel against plain, as tests/test_torch_kernels.py
TRAJECTORY_RTOL = 2e-6  # card against CPU over 200 rounds, as tests/test_torch_engine.py
STEPS = 200

# Published peaks by card name (NVIDIA data sheet, SXM part at 700 W): HBM
# bytes/s and fp32 FLOP/s outside the tensor cores. Only the card this
# script has run on is listed; another card needs its own entry.
_PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}

TPU_KERNELS = {
    "gather_combine": ("src/repro_torch/csrc/gather_combine.cu", "src/repro/kernels/coded_combine.py:70"),
    "attack": ("src/repro_torch/csrc/attack.cu", "src/repro/kernels/attacks.py:97"),
    "cwtm": ("src/repro_torch/csrc/cwtm.cu", "src/repro/kernels/cwtm.py:71"),
    "gram": ("src/repro_torch/csrc/gram.cu", "src/repro/kernels/nnm_dist.py:42"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peaks(name: str) -> tuple[float, float]:
    if name not in _PEAKS:
        raise RuntimeError(f"no published peak rates for {name!r} in _PEAKS: add the card's own")
    return _PEAKS[name]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 5) -> float:
    """Median CUDA-event time of one call after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------- kernels


def kernel_errors(ops, ref) -> dict[str, float]:
    """Max abs error of every kernel against its plain version on the card,
    over CHECK_SHAPES; raises past the tolerance."""
    err = {name: 0.0 for name in ops.KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, q in CHECK_SHAPES:
        x = torch.randn((n, q), generator=gen, device="cuda") * 3.0
        mask = (torch.arange(n, device="cuda") < max(1, n // 5)).float()
        d = 10 if n >= 10 else 2
        subsets = torch.randint(0, n, (n, d), generator=gen, device="cuda")
        w = torch.full((d,), 1.0 / d, device="cuda")
        pairs = [("gather_combine", ops.gather_combine(x, subsets, w), ref.gather_combine_ref(x, subsets, w), ATOL)]
        for name, param in (("sign_flip", -2.0), ("alie", 1.5), ("ipm", 0.5)):
            pairs.append(("attack", ops.attack(x, mask, name, param), ref.attack_ref(x, mask, name, param), ATOL))
        trim = int(0.1 * n) if n >= 10 else 2
        pairs.append(("cwtm", ops.cwtm(x, trim), ref.cwtm_ref(x, trim), ATOL))
        gram, sq = ops.gram(x)
        want_gram, want_sq = ref.gram_ref(x)
        # an fp32 dot product's rounding scales with the largest squared row norm
        scale = float(want_sq.max())
        pairs += [("gram", gram, want_gram, ATOL * scale), ("gram", sq, want_sq, ATOL * scale)]
        torch.cuda.synchronize()
        for name, got, want, atol in pairs:
            check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite output at N={n} Q={q}")
            check(torch.allclose(got, want, rtol=RTOL, atol=atol),
                  f"{name} disagrees with its plain version at N={n} Q={q}")
            err[name] = max(err[name], float((got - want).abs().max()))
    return err


def kernel_timings(ops, ref, hbm: float, fp32: float) -> dict[str, dict]:
    """Kernel, plain and library times at the wide shape (N=8, Q=WIDE_Q),
    the least time the card could take, and each kernel's agreement with its
    plain version at that shape.

    The kernels work column by column (the Gram sums over columns), so the
    full-width output's last PLAIN_Q columns are held against the plain
    version of the input's last PLAIN_Q columns; for rows 6 and 7 those lie
    past element 2^31, where a 32-bit offset would read the wrong rows. The
    Gram is held against the plain version summed over blocks of PLAIN_Q
    columns. Raises past the tolerance of ``kernel_errors``."""
    n, q = WIDE_N, WIDE_Q
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((n, q), generator=gen, device="cuda")
    # the Byzantine rows are the last two: every element they write lies past 2^31
    mask = (torch.arange(n, device="cuda") >= n - 2).float()
    # the cyclic assignment at d=2, so every row is read
    rows = torch.arange(n, device="cuda")
    subsets = torch.stack([rows, (rows + 1) % n], dim=1)
    w = torch.full((2,), 0.5, device="cuda")
    xp = x[:, :PLAIN_Q].contiguous()
    tail = x[:, q - PLAIN_Q:].contiguous()
    mix = torch.zeros((n, n), device="cuda")
    mix.index_put_((rows[:, None].expand(n, 2), subsets), w.expand(n, 2), accumulate=True)
    f32 = 4
    out = {}

    def entry(name, kernel_ms, kernel_plain_q_ms, plain_ms, library_ms, nbytes, nops):
        bound_bytes, bound_ops = nbytes / hbm * 1e3, nops / fp32 * 1e3
        out[name] = {
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "shape": [n, q], "plain_q": PLAIN_Q, "ms_at_plain_q": kernel_plain_q_ms,
            "max_abs_err_wide": 0.0,
        }

    def hold(name, got, want, atol=ATOL):
        torch.cuda.synchronize()
        where = f"N={n} Q={q}"
        check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)} at {where}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output at {where}")
        check(torch.allclose(got, want, rtol=RTOL, atol=atol),
              f"{name} disagrees with its plain version at {where}")
        err = out[name]["max_abs_err_wide"]
        out[name]["max_abs_err_wide"] = max(err, float((got - want).abs().max()))

    entry("gather_combine",
          time_ms(lambda: ops.gather_combine(x, subsets, w)),
          time_ms(lambda: ops.gather_combine(xp, subsets, w)),
          time_ms(lambda: ref.gather_combine_ref(xp, subsets, w)),
          time_ms(lambda: torch.mm(mix, x)),
          f32 * 2 * n * q, 2 * 2 * n * q)
    hold("gather_combine", ops.gather_combine(x, subsets, w)[:, q - PLAIN_Q:],
         ref.gather_combine_ref(tail, subsets, w))

    modes = (("sign_flip", -2.0), ("alie", 1.5), ("ipm", 0.5))
    by_mode = {name: time_ms(lambda: ops.attack(x, mask, name, param)) for name, param in modes}
    entry("attack", by_mode["alie"],
          time_ms(lambda: ops.attack(xp, mask, "alie", 1.5)),
          time_ms(lambda: ref.attack_ref(xp, mask, "alie", 1.5)),
          None, f32 * 2 * n * q, 8 * n * q)
    out["attack"]["ms_by_mode"] = by_mode
    for name, param in modes:
        hold("attack", ops.attack(x, mask, name, param)[:, q - PLAIN_Q:],
             ref.attack_ref(tail, mask, name, param))

    trim = 2
    entry("cwtm",
          time_ms(lambda: ops.cwtm(x, trim)),
          time_ms(lambda: ops.cwtm(xp, trim)),
          time_ms(lambda: ref.cwtm_ref(xp, trim)),
          None, f32 * (n * q + q), (n * (n // 2) * 2 + (n - 2 * trim) + 1) * q)
    hold("cwtm", ops.cwtm(x, trim)[q - PLAIN_Q:], ref.cwtm_ref(tail, trim))
    del tail

    entry("gram",
          time_ms(lambda: ops.gram(x)),
          time_ms(lambda: ops.gram(xp)),
          time_ms(lambda: ref.gram_ref(xp)),
          time_ms(lambda: torch.mm(x, x.T)),
          f32 * (n * q + n * n + n), 2 * (n * n + n) * q)
    gram, sq = ops.gram(x)
    want_gram, want_sq = torch.zeros_like(gram), torch.zeros_like(sq)
    for start in range(0, q, PLAIN_Q):
        g_blk, sq_blk = ref.gram_ref(x[:, start:start + PLAIN_Q].contiguous())
        want_gram += g_blk
        want_sq += sq_blk
    # an fp32 dot product's rounding scales with the largest squared row norm
    scale = float(want_sq.max())
    hold("gram", gram, want_gram, ATOL * scale)
    hold("gram", sq, want_sq, ATOL * scale)
    return out


# ---------------------------------------------------------------- trajectory


def trajectory_phase(S, byz, ops, gen_problem) -> dict:
    """Fig. 4 (without DRACO) and Fig. 6 rows on the card, 200 rounds each.

    Every row trains on one problem drawn from seed 0, as each figure's
    example does (examples/linear_regression_paper.py,
    examples/compressed_training.py)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    problem = gen_problem(gen, n=100, dim=100, sigma_h=0.3)
    rows = [S.PAPER_FIG4[k] for k in S.PAPER_FIG4] + [
        S.PAPER_FIG6[k] for k in ("Com-CWTM", "Com-LAD-CWTM", "Com-TGN")]
    nnm = S.PAPER_FIG4["LAD-CWTM-NNM-d10"]
    cpu_gen = torch.Generator().manual_seed(1)
    shared = [byz.sample_round_randomness(nnm.protocol(), 100, cpu_gen) for _ in range(STEPS)]
    final, ms_per_round, results = {}, {}, {}
    for scn in rows:
        provider = (lambda t: shared[t]) if scn.name == nnm.name else None
        torch.cuda.synchronize()
        start = time.perf_counter()
        res = S.run_scenario(scn, STEPS, seed=0, problem=problem, randomness=provider, device="cuda")
        torch.cuda.synchronize()
        ms_per_round[scn.name] = (time.perf_counter() - start) * 1e3 / STEPS
        loss = res.metrics["loss"]
        check(loss.shape == (STEPS,) and bool(torch.isfinite(loss).all()), f"{scn.name}: bad loss")
        final[scn.name] = float(loss[-1])
        results[scn.name] = res
    check(final["LAD-CWTM-d10"] < final["CWTM"], "Fig. 4 ordering: LAD-CWTM-d10 must end below CWTM")
    check(final["Com-LAD-CWTM"] < final["Com-CWTM"], "Fig. 6 ordering: Com-LAD-CWTM must end below Com-CWTM")

    cpu = S.run_scenario(nnm, STEPS, seed=0, problem=tuple(t.cpu() for t in problem),
                         randomness=lambda t: shared[t], device="cpu")
    card_loss = results[nnm.name].metrics["loss"].cpu()
    rel = float(((card_loss - cpu.metrics["loss"]).abs() / cpu.metrics["loss"].abs()).max())
    check(rel <= TRAJECTORY_RTOL, f"LAD-CWTM-NNM-d10 card vs CPU loss: rel {rel} > {TRAJECTORY_RTOL}")
    launches = ops.launch_counts()
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the trainer")
    return {"phase": "trajectory", "launches": launches, "rounds": STEPS, "n_devices": 100, "dim": 100,
            "final_loss": final, "ms_per_round": ms_per_round,
            "nnm_card_vs_cpu_max_rel_loss": rel, "tolerance": TRAJECTORY_RTOL,
            "orderings": {"LAD-CWTM-d10<CWTM": True, "Com-LAD-CWTM<Com-CWTM": True}}


# ---------------------------------------------------------------- wide round


def wide_round_phase(byz, attacks, compression, agg, ops) -> dict:
    """One round at Q = WIDE_Q: N=8, d=2, CWTM-NNM, trim 0.25, 2 Byzantine.

    Per attack, an untimed round with the default server first warms the
    caching allocator (so no stage pays for cudaMalloc); then the timed
    round runs the same server composed by hand with a mark after the Gram
    distances and after the NNM mix, and must give the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    grads = torch.randn((WIDE_N, WIDE_Q), generator=gen, device="cuda")
    out = {"phase": "wide_round", "q": WIDE_Q, "n_devices": WIDE_N, "d": 2,
           "aggregator": "cwtm-nnm", "trim_frac": 0.25, "n_byz": 2, "attacks": {}}
    for attack in ("alie", "sign_flip"):
        cfg = byz.ProtocolConfig(n_devices=WIDE_N, d=2, method="lad", aggregator="cwtm-nnm",
                                 trim_frac=0.25, n_byz=2, attack=attacks.AttackSpec(attack),
                                 compression=compression.CompressionSpec())
        rand = byz.sample_round_randomness(cfg, WIDE_Q, gen)
        want = byz.protocol_round(cfg, grads, rand, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def hook(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

        def server(msgs):
            # what make_server_fn(cfg) builds for cwtm-nnm, with marks
            d2 = ops.pairwise_sqdist(msgs)
            hook("server_gram")
            mixed = agg.nnm_mix(msgs, cfg.n_byz, d2)
            hook("server_nnm_mix")
            return agg.cwtm(mixed, cfg.trim_frac)

        g = byz.protocol_round(cfg, grads, rand, device="cuda", stage_hook=hook, server_fn=server)
        torch.cuda.synchronize()
        stages = {events[i][0]: events[i - 1][1].elapsed_time(events[i][1]) for i in range(1, len(events))}
        stages["server_cwtm"] = stages.pop("server")
        finite = bool(torch.isfinite(g).all())
        check(g.shape == (WIDE_Q,) and finite, f"wide round ({attack}): bad aggregate")
        check(torch.equal(g, want), f"wide round ({attack}): marked server differs from make_server_fn")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(peak_gb < 50.0, f"wide round ({attack}): peak {peak_gb:.1f} GB")
        out["attacks"][attack] = {"stage_ms": stages, "total_ms": sum(stages.values()),
                                  "peak_gb": peak_gb, "finite": finite,
                                  "aggregate_norm": float(g.norm())}
        del g, want
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import aggregators, attacks, byzantine, compression, scenarios
    from repro_torch.data.synthetic import linear_regression_problem
    from repro_torch.kernels import _build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    hbm, fp32 = peaks(kind)
    build_s = _build.build_all()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda, "kernel_build_s": build_s,
          "peak_hbm_bytes_per_s": hbm, "peak_fp32_flops": fp32})

    errors = kernel_errors(ops, ref)
    timings = kernel_timings(ops, ref, hbm, fp32)
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    emit(trajectory_phase(scenarios, byzantine, ops, linear_regression_problem))
    emit(wide_round_phase(byzantine, attacks, compression, aggregators, ops))
    launches = ops.launch_counts()
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": TPU_KERNELS[name][0],
         "replaces": TPU_KERNELS[name][1], "launches": launches[name],
         "max_abs_err": max(errors[name], timings[name]["max_abs_err_wide"]), **timings[name]}
        for name in ops.KERNELS
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
