"""Where a replayed grid round spends the card's time, kernel by kernel.

Runs ``scenarios.run_grid`` in graph mode (one captured round a bucket,
replayed ``--steps`` times) on ``synthetic_sweep(--lanes)`` at N =
``--n`` (N // 5 Byzantine devices, dim 100) under ``torch.profiler``, and
prints one JSON line: the replay ms a round (the buckets' CUDA events, as
``chip_smoke.py``'s ``grid_replays``); the device ms a round of the
kernels the replays ran (those whose correlation id is a
``cudaGraphLaunch``'s in the profiler's trace, written to
``build/replay_profile/trace.json``), by kernel, the largest first, and
their sum over the replay ms (the busy share); and the same for every
kernel of the run divided by ``--steps`` (the set-up before the capture,
the draws of every round and one warm-up round, and the results' copies
after the replays);
then the card's ``nvidia-smi`` name and power limit. A first unprofiled run
builds the kernels. To compare two trees, run it from each (``PYTHONPATH``
naming the tree's ``src``), one after the other on one card::

    PYTHONPATH=src python3 scripts/torch_replay_profile.py
"""
from __future__ import annotations

import argparse
import json
import subprocess
from collections import Counter
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import scenarios as S


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lanes", type=int, default=1000)
    parser.add_argument("--n", type=int, default=100)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args()
    rows = S.synthetic_sweep(args.lanes, n_devices=args.n, n_byz=args.n // 5)

    def run():
        res = S.run_grid(rows, args.steps, seed=0, dim=100, device="cuda", mode="graph")
        buckets = {id(res[r.name].grid): res[r.name].grid for r in rows}.values()
        return sum(b.replay_ms() for b in buckets) / args.steps

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        replay_ms = run()
        torch.cuda.synchronize()
    trace = Path(__file__).resolve().parent.parent / "build" / "replay_profile" / "trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    graph_launches = {e["args"]["correlation"] for e in events
                      if e.get("name", "").startswith("cudaGraphLaunch") and "correlation" in e.get("args", {})}
    if not graph_launches:
        raise RuntimeError("the trace holds no cudaGraphLaunch: the replays cannot be told from the set-up")
    whole, replays = Counter(), Counter()
    for e in events:
        if e.get("cat") == "kernel":
            ms = e["dur"] / 1e3 / args.steps
            whole[e["name"][:200]] += ms
            if e.get("args", {}).get("correlation") in graph_launches:
                replays[e["name"][:200]] += ms
    print(json.dumps({"lanes": args.lanes, "n": args.n, "steps": args.steps, "replay_ms_per_round": replay_ms,
                      "replay_kernel_ms_per_round": sum(replays.values()),
                      "replay_busy_share": sum(replays.values()) / replay_ms,
                      "replay_top": [[name, t] for name, t in replays.most_common(args.top)],
                      "run_kernel_ms_per_round": sum(whole.values()), "kernels": len(whole),
                      "run_top": [[name, t] for name, t in whole.most_common(args.top)]}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
