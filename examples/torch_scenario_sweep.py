"""Sweep the Section-VII scenario matrix over the PyTorch port.

One declarative registry call generates the paper's comparison grid,
method x attack x compressor (x aggregator x heterogeneity), and the whole
grid runs as a handful of compile buckets, each bucket's rows the lanes of
one batched round (on the card one captured round replayed, ``--mode
loop`` for a Python loop of rounds):

    PYTHONPATH=src python examples/torch_scenario_sweep.py
    PYTHONPATH=src python examples/torch_scenario_sweep.py --steps 400 \\
        --attacks sign_flip alie ipm --device cpu

``--per-scenario`` runs the rows one by one (``run_scenario``, the
bit-exactness reference). ``--max-lanes-per-device`` streams a bucket
through equal chunks of that many lanes, or ``auto`` lets the lane-capacity
tuner pick the fastest capacity that fits per bucket (probing one chunk at
capacities 1, 2, 4, ..., cached across runs in the tuner's store,
``$REPRO_TORCH_TUNER_CACHE`` or ``~/.cache/repro_torch/tuner.json``):

    PYTHONPATH=src python examples/torch_scenario_sweep.py --max-lanes-per-device auto

``--shard shard_map`` spreads each bucket's lanes over the ranks of the
default ``torch.distributed`` group (one rank when none is initialised).
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.core import engine, scenarios
from repro_torch.data.synthetic import linear_regression_problem
from repro_torch.device import resolve_device
from repro_torch.launch import tuner


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--attacks", nargs="*", default=["sign_flip", "alie", "ipm"])
    parser.add_argument("--compressors", nargs="*", default=["none", "rand_sparse"])
    parser.add_argument("--sigma", type=float, nargs="*", default=[0.3])
    parser.add_argument("--mode", default=None, choices=["loop", "graph"],
                        help="how a bucket's rounds run (default: graph on the card, loop on the CPU)")
    parser.add_argument("--per-scenario", action="store_true",
                        help="run the rows one by one instead of the lane-batched grid")
    parser.add_argument("--shard", default="none", choices=["none", "pmap", "shard_map"],
                        help="spread each bucket's lanes over the ranks of the process group")
    parser.add_argument("--max-lanes-per-device", default=None,
                        type=lambda v: v if v == "auto" else int(v),
                        help="stream the sweep in chunks of this many lanes per rank (memory-bounded "
                             "1000+-row sweeps), or 'auto' to probe-tune the capacity per bucket "
                             "(cached across runs in the tuner store)")
    args = parser.parse_args()
    dev = resolve_device(args.device)
    mode = args.mode or ("graph" if dev.type == "cuda" else "loop")

    grid = scenarios.section7_grid(attacks=args.attacks, compressors=args.compressors, sigma_levels=args.sigma)
    # one shared problem so final losses are comparable across the grid —
    # only when a single heterogeneity level is swept; with several sigmas
    # each scenario must generate its own sigma_h-matched problem
    problem = None
    if len(args.sigma) == 1:
        problem = linear_regression_problem(torch.Generator(device=dev).manual_seed(0), n=100, dim=100,
                                            sigma_h=args.sigma[0])

    how = "per-scenario" if args.per_scenario else "grid"
    print(f"{len(grid)} scenarios x {args.steps} rounds ({how}, mode={mode}, shard={args.shard}, {dev})\n")
    print(f"{'scenario':44s} {'final loss':>12s} {'agg dist':>10s}")
    t0 = time.perf_counter()
    if args.per_scenario:
        runs = {s.name: scenarios.run_scenario(s, args.steps, problem=problem, device=dev, mode=mode)
                for s in grid}
    else:
        runs = scenarios.run_grid(grid, args.steps, problem=problem, mode=mode, shard=args.shard,
                                  max_lanes_per_device=args.max_lanes_per_device, device=dev)
    results = scenarios.grid_finals(runs)
    elapsed = time.perf_counter() - t0
    for name, m in results.items():
        print(f"{name:44s} {m['final_loss']:12.4g} {m['final_agg_dist']:10.4g}")
    print(f"\nswept {len(grid)} scenarios in {elapsed:.2f}s ({how})")
    if args.max_lanes_per_device == "auto" and not args.per_scenario:
        info = engine.last_grid_chunk_info()
        print(f"tuner: last bucket {info['max_lanes_per_device']} lanes a rank ({info['n_lanes']} lanes), "
              f"{tuner.tuner_stats()}, store {tuner.get_store().path}")

    # the paper's headline: under every attack, LAD improves on the plain
    # robust baseline at the same aggregator (redundancy tightens the error)
    for attack in args.attacks:
        for comp in args.compressors:
            for sigma in args.sigma:
                lad = results.get(scenarios.scenario_name("lad", 10, "cwtm", attack, comp, sigma))
                plain = results.get(scenarios.scenario_name("plain", 1, "cwtm", attack, comp, sigma))
                if lad and plain:
                    verdict = "OK " if lad["final_loss"] <= plain["final_loss"] else "?? "
                    print(f"{verdict} lad-d10 vs plain under {attack}/{comp}/s{sigma:g}: "
                          f"{lad['final_loss']:.4g} vs {plain['final_loss']:.4g}")


if __name__ == "__main__":
    main()
