"""Time the PyTorch port's servers on one tree, for parent-against-change
comparisons in one session on one card.

Imports ``repro_torch`` from ``--src`` (the ``src`` directory of the tree
under test) and prints one JSON line, also written to ``--out``:

  * ``graph``: replay ms per round (``run_scenario(mode="graph")``, CUDA
    only) of the 15 ``section7_grid()`` rows and of the geomed, mcc, tgn,
    krum and multi_krum rows at N = 100, dim = 100, LAD d = 10;
  * ``grid``: replay ms per round of each bucket of ``run_grid`` in graph
    mode (CUDA only) over ``PAPER_FIG4`` (``exact=True``), ``PAPER_FIG6``
    (``exact=False``) and three ``PAPER_FIG6`` rows under ``quant:4``
    (``exact=False``), as ``chip_smoke.py``'s grid phase runs them, and
    ``synthetic_sweep(1000)`` at N = 100 under ``quant:4`` (100,000 rows
    quantized a round), keyed by the bucket's first row;
  * ``loop``: host ms per round of the ``PAPER_FIG4`` and ``PAPER_FIG6``
    rows and of the same five rule rows in ``mode="loop"``;
  * ``wide``: one warmed round each of geomed under gaussian noise and mcc
    under ALIE at N = 8, d = 2, two Byzantine devices and ``--wide-q``
    coordinates: total and server-stage ms (CUDA events) and peak GB.

Run parent, change, change, parent in one session::

    python3 scripts/torch_server_times.py --src parent/src --label parent
    python3 scripts/torch_server_times.py --src src --label change

``--grid-only`` prints the ``grid`` buckets alone (parent against change
for the NNM buckets, a minute a tree). ``--device cpu`` (small
``--steps`` and ``--wide-q``) rehearses the script
on the host clock and skips the graph rows. ``--profile ROW`` instead runs
that ``PAPER_FIG4`` / ``PAPER_FIG6`` / rule row in loop mode under
``cProfile`` and prints where the host time goes.
"""
from __future__ import annotations

import argparse
import cProfile
import dataclasses
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path

import torch


class Timer:
    """Milliseconds between two marks: CUDA events on the card, the host
    clock on the CPU."""

    def __init__(self, dev: str):
        self.cuda = dev == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        if self.cuda:
            torch.cuda.synchronize()
            return a.elapsed_time(b)
        return (b - a) * 1e3


def sync(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def rule_rows(S) -> list:
    """The plain-PyTorch rules at N = 100, dim = 100, LAD d = 10, 20 Byzantine."""
    return [S.Scenario(name=f"LAD-{agg}-d10/{attack}", method="lad", d=10, aggregator=agg, attack=attack,
                       n_byz=20)
            for agg, attack in (("geomed", "gaussian"), ("mcc", "alie"), ("tgn", "sign_flip"),
                                ("krum", "sign_flip"), ("multi_krum", "ipm"))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the src directory holding repro_torch")
    ap.add_argument("--label", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--wide-q", type=int, default=361_821_120)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="a file to append the JSON line to")
    ap.add_argument("--profile", default=None, help="a row to profile on the host in loop mode")
    ap.add_argument("--grid-only", action="store_true", help="only the grid buckets' replay ms")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.core import attacks, byzantine as byz, compression, scenarios as S

    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        print("torch_server_times: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = Timer(dev)
    out = {"label": args.label, "src": str(src), "steps": args.steps, "device": dev}
    if dev == "cuda":
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]

    if args.profile:
        rows = {r.name: r for r in list(S.PAPER_FIG4.values()) + list(S.PAPER_FIG6.values()) + rule_rows(S)}
        scn = rows[args.profile]
        S.run_scenario(scn, 5, seed=0, device=dev, mode="loop")  # first use: builds, allocations
        prof = cProfile.Profile()
        prof.runcall(lambda: (S.run_scenario(scn, args.steps, seed=0, device=dev, mode="loop"), sync(dev)))
        print(f"== {args.label}: {args.profile}, {args.steps} rounds in loop mode")
        pstats.Stats(prof, stream=sys.stdout).sort_stats("tottime").print_stats(30)
        return 0

    if dev == "cuda" and not args.grid_only:
        out["graph_replay_ms_per_round"] = {}
        for scn in list(S.section7_grid()) + rule_rows(S):
            res = S.run_scenario(scn, args.steps, seed=0, device=dev, mode="graph")
            out["graph_replay_ms_per_round"][scn.name] = res.graph.replay_ms() / args.steps

    if dev == "cuda":
        out["grid_replay_ms_per_round"] = {}
        quant = [dataclasses.replace(S.PAPER_FIG6[k], name=f"{k}/quant:4", compressor="quant:4")
                 for k in ("Com-CWTM", "Com-LAD-CWTM", "Com-LAD-CWTM-NNM")]
        sweep = S.synthetic_sweep(1000, n_devices=100, n_byz=20, compressor="quant:4")
        for name, rows, exact in (("fig4", list(S.PAPER_FIG4.values()), True),
                                  ("fig6", list(S.PAPER_FIG6.values()), False), ("quant4", quant, False),
                                  ("sweep1000_quant4", sweep, True)):
            res = S.run_grid(rows, args.steps, seed=0, device=dev, mode="graph", exact=exact)
            buckets = {}
            for row in rows:
                buckets.setdefault(id(res[row.name].grid), (res[row.name].grid, row.name))
            out["grid_replay_ms_per_round"][name] = {
                first: {"lanes": stats.lanes, "replay_ms_per_round": stats.replay_ms() / args.steps}
                for stats, first in buckets.values()}
    if args.grid_only:
        return emit(out, args.out)

    out["loop_ms_per_round"] = {}
    for scn in list(S.PAPER_FIG4.values()) + list(S.PAPER_FIG6.values()) + rule_rows(S):
        sync(dev)
        start = time.perf_counter()
        S.run_scenario(scn, args.steps, seed=0, device=dev, mode="loop")
        sync(dev)
        out["loop_ms_per_round"][scn.name] = (time.perf_counter() - start) * 1e3 / args.steps

    gen = torch.Generator(device=dev).manual_seed(2)
    grads = torch.randn((8, args.wide_q), generator=gen, device=dev)
    out["wide"] = {"q": args.wide_q, "n_devices": 8, "d": 2, "n_byz": 2}
    for agg, attack in (("geomed", "gaussian"), ("mcc", "alie")):
        cfg = byz.ProtocolConfig(n_devices=8, d=2, method="lad", aggregator=agg, n_byz=2,
                                 attack=attacks.AttackSpec(attack), compression=compression.CompressionSpec())
        rand = byz.sample_round_randomness(cfg, args.wide_q, gen)
        want = byz.protocol_round(cfg, grads, rand, device=dev)  # warm-up
        sync(dev)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        marks = [("start", timer.mark())]
        g = byz.protocol_round(cfg, grads, rand, device=dev, stage_hook=lambda s: marks.append((s, timer.mark())))
        sync(dev)
        stages = {marks[i][0]: timer.ms(marks[i - 1][1], marks[i][1]) for i in range(1, len(marks))}
        if not torch.equal(g, want) or not bool(torch.isfinite(g).all()):
            print(f"torch_server_times: wide {agg} round is not finite or not repeatable", file=sys.stderr)
            return 1
        out["wide"][f"{agg}/{attack}"] = {
            "total_ms": sum(stages.values()), "server_ms": stages["server"],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else None}
        del g, want, rand

    return emit(out, args.out)


def emit(out: dict, path: str | None) -> int:
    """Print ``out`` as one JSON line and append it to ``path`` when given."""
    line = json.dumps(out)
    print(line, flush=True)
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
