"""The port's protomath train step on the ranks of a ``gloo`` group, on the
CPU: the helper that tests/test_torch_protomath_step.py starts once a rank.

    python tests/torch_protomath_ranks.py OUT_DIR RANK WORLD

Every rank joins the group through a file under ``OUT_DIR`` (no port),
runs each of ``CONFIGS`` for ``STEPS`` steps of ``lm_arch()`` (and of
``zoo_arch("jamba")``) at N=4 from the same seeded weights and batches,
and writes its losses and final flat parameters to
``OUT_DIR/rank{RANK}.npz``. The models are small because a collective on
a busy CPU waits until every rank is scheduled: the run's time follows its
count of collectives, one to three an exchange. ``run_configs(mesh)`` is the same run on any
mesh, the one-rank run of the test included.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

N = 4
STEPS = 3
_BASE = dict(protocol="lad", d=2, aggregator="cwtm", trim_frac=0.25, n_byz=1, attack="alie", server="sharded",
             optimizer="adamw", lr=1e-3, steps=5, seed=0)
CONFIGS = {
    "cwtm-alie-sharded-mb2": dict(microbatches=2),
    "cwtm-alie-gather-mb2": dict(microbatches=2, server="gather"),
    "nnm-sign_flip-sharded": dict(aggregator="cwtm-nnm", attack="sign_flip"),
    "nnm-sign_flip-gather": dict(aggregator="cwtm-nnm", attack="sign_flip", server="gather"),
    "quant-gaussian-sharded": dict(attack="gaussian", compression="quant", quant_levels=4),
    "quant-gaussian-gather": dict(attack="gaussian", compression="quant", quant_levels=4, server="gather"),
    "honest-sharded": dict(protocol="none"),
    "jamba-cwtm-ipm-sharded": dict(attack="ipm", optimizer="sgd_momentum", lr=1e-2),
}


def run_configs(mesh) -> dict[str, tuple[list[float], np.ndarray]]:
    """{config: (losses, final flat parameters)} on ``mesh``."""
    from repro_torch import models
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import scenarios
    from repro_torch.core.coding import flatten_pytree
    from repro_torch.data.synthetic import lm_batch_for_devices
    from repro_torch.launch import train

    out = {}
    for name, kw in CONFIGS.items():
        arch = scenarios.zoo_arch("jamba") if name.startswith("jamba") else scenarios.lm_arch()
        tcfg = TrainConfig(arch=arch.name, **{**_BASE, **kw})
        params, specs = models.init(torch.Generator().manual_seed(0), arch)
        step, opt = train.build_train_step(arch, tcfg, specs, mesh=mesh, device="cpu")
        state, losses = opt.init(params), []
        for i in range(STEPS):
            b = lm_batch_for_devices(torch.Generator().manual_seed(100 + i), arch.vocab, n_subsets=N, per_subset=2,
                                     seq_len=16, sigma_h=0.5)
            params, state, loss, _ = step(params, state, {k: v.reshape(-1, 16) for k, v in b.items()}, i)
            losses.append(float(loss))
        out[name] = (losses, flatten_pytree(params)[0].numpy())
    return out


def main(out_dir: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"file://{Path(out_dir) / 'rendezvous'}",
                                         world_size=world, rank=rank)
    try:
        from repro_torch.launch.mesh import make_host_mesh

        res = run_configs(make_host_mesh(N))
        np.savez(Path(out_dir) / f"rank{rank}.npz",
                 **{f"{k}/loss": np.asarray(v[0]) for k, v in res.items()},
                 **{f"{k}/params": v[1] for k, v in res.items()})
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
