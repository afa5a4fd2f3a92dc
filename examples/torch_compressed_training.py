"""Com-LAD over the PyTorch port: Byzantine robustness under communication
compression (Fig. 6).

Random sparsification (Q_hat = 30% of coordinates), 30 Byzantine devices,
sign-flipping attack applied before compression, CWTM/CWTM-NNM servers,
plus the wire-byte accounting that motivates Com-LAD. The Fig.-6 registry
rows sweep through the lane-batched grid in one call:

    PYTHONPATH=src python examples/torch_compressed_training.py
    PYTHONPATH=src python examples/torch_compressed_training.py --device cpu
"""
import argparse

import torch

from repro_torch.core import scenarios
from repro_torch.core.compression import CompressionSpec, wire_bits
from repro_torch.data.synthetic import linear_regression_problem
from repro_torch.device import resolve_device


def main():
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=250)
    args = parser.parse_args()
    dev = resolve_device(args.device)

    problem = linear_regression_problem(torch.Generator(device=dev).manual_seed(0), n=100, dim=100, sigma_h=0.3)

    print("wire bytes per message:")
    dense_bits = wire_bits(CompressionSpec.parse("identity"), 100)
    for text in ["identity", "randk:0.3", "randk_shared:0.3", "quant:16:100"]:
        spec = CompressionSpec.parse(text)
        bits = wire_bits(spec, 100)
        print(f"  {spec.name:20s} {bits / 8:7.0f} B  ({bits / dense_bits:.0%} of dense)")

    curves = {
        "Com-VA": "Com-VA",
        "Com-CWTM": "Com-CWTM",
        "Com-TGN": "Com-TGN",
        "Com-LAD-CWTM d=3": "Com-LAD-CWTM",
        "Com-LAD-CWTM-NNM d=3": "Com-LAD-CWTM-NNM",
    }
    grid = scenarios.run_grid(
        [scenarios.PAPER_FIG6[label] for label in curves.values()],
        steps=args.steps, problem=problem, device=dev, mode="graph" if dev.type == "cuda" else "loop",
    )
    print(f"\n{'method':22s} final-loss")
    results = {}
    for name, label in curves.items():
        results[name] = float(grid[label].metrics["loss"][-1])
        print(f"{name:22s} {results[name]:.4g}")

    assert results["Com-LAD-CWTM d=3"] < results["Com-CWTM"]
    print("\nOK: Com-LAD improves on compressed robust baselines (Fig. 6).")


if __name__ == "__main__":
    main()
