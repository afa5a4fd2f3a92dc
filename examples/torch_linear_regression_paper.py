"""The paper's Section-VII experiment over the PyTorch port: LAD against
the baselines on linear regression.

Reproduces the Fig. 4 comparison at full protocol scale (N=100 devices,
20 Byzantine, sign-flipping attack x(-2)) with a reduced iteration count.
The whole comparison set runs through the lane-batched grid: compile
buckets whose rows are the lanes of one batched round, each lane bit for
bit its standalone trajectory. On the card each bucket's round is captured
as a CUDA graph and replayed; on the CPU it runs as a loop.

    PYTHONPATH=src python examples/torch_linear_regression_paper.py
    PYTHONPATH=src python examples/torch_linear_regression_paper.py --device cpu
"""
import argparse

import torch

from repro_torch.core import scenarios
from repro_torch.data.synthetic import linear_regression_problem
from repro_torch.device import resolve_device

CURVES = {
    "VA (mean)": "VA",
    "CWTM": "CWTM",
    "CWTM-NNM": "CWTM-NNM",
    "LAD-CWTM d=5": "LAD-CWTM-d5",
    "LAD-CWTM d=10": "LAD-CWTM-d10",
    "LAD-CWTM d=20": "LAD-CWTM-d20",
    "LAD-CWTM-NNM d=10": "LAD-CWTM-NNM-d10",
}


def main():
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=200)
    args = parser.parse_args()
    dev = resolve_device(args.device)

    problem = linear_regression_problem(torch.Generator(device=dev).manual_seed(0), n=100, dim=100, sigma_h=0.3)
    grid = scenarios.run_grid(
        [scenarios.PAPER_FIG4[label] for label in CURVES.values()],
        steps=args.steps, problem=problem, device=dev, mode="graph" if dev.type == "cuda" else "loop",
    )
    print(f"{'method':24s} final-loss")
    results = {}
    for name, label in CURVES.items():
        results[name] = float(grid[label].metrics["loss"][-1])
        print(f"{name:24s} {results[name]:.4g}")

    assert results["LAD-CWTM d=10"] < results["CWTM"]
    print("\nOK: redundancy (d>1) beats the non-redundant robust baselines,")
    print("matching the paper's Fig. 4 ordering.")


if __name__ == "__main__":
    main()
