"""How the engine step's subset gradients depend on how many subsets ride in
one vmapped call, on a CUDA card (ROADMAP C.12). JSON lines on stdout.

    PYTHONPATH=src python tests/torch_fanout_bits.py [ARCH]

``ARCH`` is an ``ARCHS`` name (default ``smollm-360m``, at its published
widths and dtype). The script blocks one batch of ``chip_smoke.py``'s
``train_batches`` (N=8 subsets of 2 rows of 16 tokens) and runs the step's
per-subset ``vmap(grad_and_value(loss_fn))`` over the first k blocks for k
= 8, 4, 3, 2, 1: the shares a rank of 1, 2, 3 (8 padded to 9) and 4 ranks
computes, and one block. For each k it prints whether every block's loss
and every gradient leaf are bit for bit those of the 8-block call, with the
leaves that differ (the first few, with their largest difference and
largest value). It does so for the whole-batch call the step makes and for
``vmap(..., chunk_size=1)`` (one block a call), with the 8-block call's
wall time, the card synchronised (median of 3 after a warm-up call).
TF32 is off, as on the port's parity paths.
"""
from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
N = 8
SHARES = (4, 3, 2, 1)


def main(arch_name: str = "smollm-360m") -> None:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import models, pytree
    from repro_torch.configs import archs
    from repro_torch.data import synthetic
    from repro_torch.launch import train

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    arch = archs.ARCHS[arch_name]
    params, _ = models.init(torch.Generator().manual_seed(0), arch)
    params = train.unstack_periods(pytree.map_tree(lambda a: a.to("cuda"), params))
    names = [k for k, _ in pytree.paths(params)]
    batch = smoke.train_batches(synthetic, arch, N, 2, 1)[0]
    blocks = train.block_batch({k: v.to("cuda") for k, v in batch.items()}, N)

    def loss(p, sub):
        return models.loss_fn(p, None, arch, sub)

    for chunk in (None, 1):
        fn = torch.func.vmap(torch.func.grad_and_value(loss, has_aux=True), in_dims=(None, 0), chunk_size=chunk)

        def call(k: int):
            grads, (losses, _) = fn(params, {name: v[:k] for name, v in blocks.items()})
            return [g.float() for g in pytree.leaves(grads)], losses

        call(N)  # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            whole = call(N)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        row = {"arch": arch.name, "chunk_size": chunk, "n": N, "ms_n_blocks": statistics.median(times),
               "ms_all": times, "nvidia_smi": smi}
        for k in SHARES:
            part = call(k)
            bad = [(names[i], float((a[:k] - b).abs().max()), float(a[:k].abs().max()))
                   for i, (a, b) in enumerate(zip(whole[0], part[0])) if not torch.equal(a[:k], b)]
            row[f"k{k}"] = {"loss_bitwise": bool(torch.equal(whole[1][:k], part[1])), "leaves_differ": len(bad),
                            "leaves": len(names), "first": bad[:4]}
            del part
        print(json.dumps(row), flush=True)
        del whole


if __name__ == "__main__":
    main(*sys.argv[1:2])
