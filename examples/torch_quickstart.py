"""Quickstart over the PyTorch port: Byzantine-robust training of a small LM
with LAD.

Builds a reduced SmolLM-family model, marks one of four logical LAD devices
Byzantine (sign-flipping attack) and trains with cyclic gradient coding
(d=2) and CWTM aggregation through the protomath step (each parameter's
gradient exchanged inside the backward, the sharded server). The four
devices are the blocks of one rank's batch: the port's mesh has no model
axis yet, so this is the reference quickstart's 4 (data) x 1.

    PYTHONPATH=src python examples/torch_quickstart.py               # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain PyTorch
"""
import argparse

import torch

from repro_torch.configs.archs import ARCHS, reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.data.synthetic import lm_batch_for_devices
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import Trainer


def main():
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--seq-len", type=int, default=64)
    args = parser.parse_args()

    mesh = make_host_mesh(data=4)
    cfg = reduced(ARCHS["smollm-360m"])
    tcfg = TrainConfig(
        arch=cfg.name,
        protocol="lad",
        d=2,                      # cyclic gradient-coding redundancy
        aggregator="cwtm",        # kappa-robust server rule
        trim_frac=0.25,
        n_byz=1,                  # one of four devices is Byzantine
        attack="sign_flip",       # Section VII attack (coefficient -2)
        server="sharded",         # all-to-all sharded server (beyond-paper)
        optimizer="adamw",
        lr=1e-3,
        steps=args.steps,
        microbatches=2,
    )
    trainer = Trainer(cfg=cfg, tcfg=tcfg, mesh=mesh, device=args.device)

    def batches():
        for i in range(tcfg.steps):
            b = lm_batch_for_devices(torch.Generator().manual_seed(i), cfg.vocab,
                                     n_subsets=4, per_subset=2, seq_len=args.seq_len, sigma_h=0.3)
            yield {k: v.reshape(-1, v.shape[-1]) for k, v in b.items()}

    history = trainer.run(batches(), log_every=5)
    print("step  loss")
    for step, loss in history:
        print(f"{step:4d}  {loss:.4f}")
    assert history[-1][1] < history[0][1], "training under attack should converge"
    print("OK: LAD-CWTM converged despite the Byzantine device.")


if __name__ == "__main__":
    main()
