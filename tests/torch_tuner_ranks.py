"""The lane-capacity tuner over the ranks of a ``gloo`` group, on the CPU:
the helper that tests/test_torch_tuner.py starts once a rank.

    python tests/torch_tuner_ranks.py OUT_DIR RANK WORLD

Every rank sets one thread, joins the group through a file under
``OUT_DIR`` and runs ``scenarios.run_grid(ROWS, shard="shard_map",
max_lanes_per_device="auto")`` with its probes' times replaced by
``TIMES[rank]`` (each chunk still runs) and, on rank 1 alone, an
out-of-memory error at ``OOM_CAPACITY`` lanes a rank. Alone, rank 0
would choose capacity 1 and rank 1 capacity 2; together they must both
choose ``AGREED``. Then rank 0 drops its store and both call again (they
must probe again together), then both call warm (no probe). Each rank also
runs the grid unsharded and writes ``OUT_DIR/rank{RANK}.npz``.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

STEPS, DIM = 3, 8
# seconds of a chunk at capacity c, as each rank "measures" them; rank 1 runs out of memory at 3
TIMES = {0: {1: 1.0, 2: 3.0, 3: 3.0}, 1: {1: 2.5, 2: 2.0}}
OOM_CAPACITY = 3
AGREED = 2  # per lane over the ranks' largest times: 2.5 / 2 at capacity 1, 3.0 / 4 at 2; 3 out of memory
AGREED_MEASURED = {"1": 1.25, "2": 0.75, "3": None}


def main(out_dir: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"file://{Path(out_dir) / 'rendezvous'}",
                                         world_size=world, rank=rank)
    try:
        from repro_torch.core import engine, scenarios
        from repro_torch.launch import tuner

        real = engine.block_time

        def probe_time(fn, start, lanes, gather, **kw):
            real(fn, start, lanes, gather, **kw)
            capacity = lanes // world
            if rank == 1 and capacity == OOM_CAPACITY:
                raise torch.OutOfMemoryError(f"CUDA out of memory at {capacity} lanes a rank (rank 1 alone)")
            return TIMES[rank][capacity]

        engine.block_time = probe_time
        rows = scenarios.synthetic_sweep(6, n_devices=10, n_byz=2)
        kw = dict(dim=DIM, device="cpu", mode="loop")
        store = tuner.set_store_path(None)
        res = scenarios.run_grid(rows, STEPS, shard="shard_map", max_lanes_per_device="auto", **kw)
        capacity = engine.last_grid_chunk_info()["max_lanes_per_device"]
        (rec,) = store.data["lane_capacity"].values()
        if rank == 0:
            tuner.set_store_path(None)  # the ranks' stores now disagree: both must probe again
        tuner.reset_tuner_stats()
        again = scenarios.run_grid(rows, STEPS, shard="shard_map", max_lanes_per_device="auto", **kw)
        capacity_again = engine.last_grid_chunk_info()["max_lanes_per_device"]
        again_probes = tuner.tuner_stats()["probes"]
        tuner.reset_tuner_stats()
        warm = scenarios.run_grid(rows, STEPS, shard="shard_map", max_lanes_per_device="auto", **kw)
        capacity_warm = engine.last_grid_chunk_info()["max_lanes_per_device"]
        warm_probes = tuner.tuner_stats()["probes"]
        engine.block_time = real
        alone = scenarios.run_grid(rows, STEPS, **kw)

        def stack(results, key):
            return np.stack([(r.x if key == "x" else r.metrics[key]).numpy() for r in results.values()])

        for other in (again, warm):
            for key in ("x", "loss"):
                if not np.array_equal(stack(other, key), stack(res, key)):
                    raise AssertionError(f"rank {rank}: a repeated auto call changed {key}")
        np.savez(Path(out_dir) / f"rank{rank}.npz", capacity=capacity, capacity_again=capacity_again,
                 capacity_warm=capacity_warm, again_probes=again_probes, warm_probes=warm_probes,
                 measured=json.dumps(rec["per_lane_s"]), x=stack(res, "x"), loss=stack(res, "loss"),
                 **{"none/x": stack(alone, "x"), "none/loss": stack(alone, "loss")})
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
