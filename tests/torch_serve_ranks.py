"""The port's sharded serving on the ranks of a ``gloo`` group, on the CPU:
the helper that tests/test_torch_serve_tp.py starts once a rank.

    python tests/torch_serve_ranks.py OUT_DIR RANK WORLD MODEL

Every rank joins the group through a file under ``OUT_DIR`` (no port),
lays the ranks out as ``make_host_mesh(WORLD // MODEL, MODEL)``, reads
``OUT_DIR/inputs.npz`` (each case's whole float32 parameters, the
reference's carried across, its prompt, frontend and the tokens fed in,
written by the test) and writes ``OUT_DIR/rank{RANK}.npz``: for each of
``CASES``

  * ``{case}/tokens``: ``serve_traffic(mesh=)``'s greedy tokens (loop mode,
    the whole ``(B, NEW)`` on every rank) and ``{case}/pos``;
  * ``{case}/logits{t}``: this rank's cut of the logits of the prefill
    (``t = 0``) and of each decode step after it with the fed tokens
    (``t = 1 .. NEW``), its rows and vocabulary slice;
  * ``{case}/state0/{path}``, ``{case}/state1/{path}``: this rank's cut of
    every decode-state leaf after the prefill and after the last step;
  * ``{case}/coll/{kind}``, ``{case}/pcoll/{kind}``: (calls, bytes) of
    the collectives of the first decode step and its greedy token, and of
    the prefill and its greedy token (``protomath.collective_counts``).

The models are small because a collective on a busy CPU waits until every
rank is scheduled.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from torch_tp_ranks import _tree as tree_of

S0, NEW = 12, 6  # the prompt and the tokens decoded: 18 slots a ring, cut 9 a rank
CASES = {  # name: (zoo family, ArchConfig overrides, batch, ring headroom of the fed run)
    **{fam: (fam, {}, 4, True) for fam in ("transformer", "jamba", "rwkv", "moe", "swa", "cross", "audio")},
    "flash_model": ("transformer", dict(n_heads=3, n_kv_heads=1), 4, True),  # q heads whole, the slots cut on model
    "batch1": ("transformer", {}, 1, True),  # the slots cut on data
    "wrap": ("transformer", {}, 4, False),  # a 12-slot ring: the writes wrap from rank 0's 6 slots into rank 1's
    "heads": ("audio", dict(n_kv_heads=2), 4, True),  # kv heads cut on model, the cross cache too
    "head_dim": ("transformer", dict(attn_tp="head_dim"), 4, True),
}


def arch_of(scenarios, name: str):
    """``CASES[name]``'s arch from ``scenarios`` (the port's or the
    reference's ``core.scenarios``)."""
    fam, kw, _, _ = CASES[name]
    arch = scenarios.zoo_arch(fam)
    return arch.scaled(name=f"{arch.name}-{name}", **kw) if kw else arch


def capacity_of(name: str) -> int | None:
    """The fed run's prefill capacity: ``S0 + NEW``, or none (the ring
    wraps)."""
    return S0 + NEW if CASES[name][3] else None


def inputs(name: str, vocab: int, encoder) -> dict[str, np.ndarray]:
    """A case's prompt (B, S0), frontend (or none) and the tokens fed to
    its decode steps (B, NEW), from a seed."""
    rng = np.random.default_rng(len(name))
    b = CASES[name][2]
    out = {"prompt": rng.integers(0, vocab, (b, S0)).astype(np.int32),
           "fed": rng.integers(0, vocab, (b, NEW)).astype(np.int32)}
    if encoder is not None:
        out["frontend"] = rng.standard_normal((b, encoder.n_frontend_tokens, encoder.d_frontend)).astype(np.float32)
    return out


def state_arrays(state: dict, prefix: str) -> dict[str, np.ndarray]:
    from repro_torch import pytree

    return {f"{prefix}/{path}": leaf.detach().cpu().numpy().copy() for path, leaf in pytree.paths(state)}


def _counts(prefix: str) -> dict[str, np.ndarray]:
    from repro_torch.core import protomath

    return {f"{prefix}/{k}": np.asarray([v["calls"], v["bytes"]]) for k, v in protomath.collective_counts().items()}


def run_case(name: str, data: dict[str, np.ndarray], mesh) -> dict[str, np.ndarray]:
    """One case on this rank of ``mesh``."""
    from repro_torch import convert
    from repro_torch.core import protomath, scenarios
    from repro_torch.launch import roofline, serve, train
    from repro_torch.models import serving

    arch = arch_of(scenarios, name)
    whole = tree_of({k[len("param/"):]: v for k, v in data.items() if k.startswith("param/")})
    shapes, specs = roofline.param_shapes_and_specs(arch)
    params = convert.lm_params_from_numpy(whole, placements=train.param_pspecs(specs, mesh, shapes), mesh=mesh)
    prompt, fed = torch.from_numpy(data["prompt"]), torch.from_numpy(data["fed"])
    frontend = torch.from_numpy(data["frontend"]) if "frontend" in data else None
    out = {}
    res = serve.serve_traffic(arch, params, specs, prompt, frontend=frontend, new_tokens=NEW, mode="loop",
                              device="cpu", mesh=mesh)
    out.update({"tokens": res["tokens"].numpy(), "pos": np.asarray(res["pos"])})

    # the same tokens fed in: the prefill's and each step's logits, the state after the prefill and the last step
    b = prompt.shape[0]
    shard = serve.serving_shard(arch, b, S0, mesh, capacity=capacity_of(name))
    local = serve.serving_params(params, specs, arch, mesh)
    rows = slice(None)
    if shard.batch_cut:
        n = b // mesh.world
        rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    protomath.reset_collective_counts()
    logits, state = serving.prefill(local, specs, arch, prompt[rows], capacity=capacity_of(name), shard=shard,
                                    frontend=None if frontend is None else frontend[rows])
    serving.greedy_token(logits, arch, shard)
    out.update(_counts("pcoll"))
    out["logits0"] = logits.numpy()
    out.update(state_arrays(state, "state0"))
    for t in range(NEW):
        if t == 0:
            protomath.reset_collective_counts()
        logits, state = serving.decode_step(local, specs, arch, fed[rows, t:t + 1], state, shard=shard)
        if t == 0:  # the step and its greedy token
            serving.greedy_token(logits, arch, shard)
            out.update(_counts("coll"))
        out[f"logits{t + 1}"] = logits.numpy()
    out.update(state_arrays(state, "state1"))
    return {f"{name}/{k}": v for k, v in out.items()}


def spawn(out: Path, world: int = 4, model: int = 2) -> list[subprocess.Popen]:
    """Start ``world`` fresh ranks (one thread each); ``wait`` collects
    them."""
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent.parent / "src"), "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, __file__, str(out), str(r), str(world), str(model)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]


def wait(procs: list[subprocess.Popen], out: Path, timeout: float = 300.0) -> list:
    """Each rank's results; raises where a rank failed or passed ``timeout``
    seconds."""
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, err in zip(procs, errs):
        if p.returncode != 0:
            raise RuntimeError(f"a serving rank exited {p.returncode}: {err[-4000:]}")
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(len(procs))]


def main(out_dir: str, rank: int, world: int, model: int) -> None:
    torch.set_num_threads(1)
    out = Path(out_dir)
    torch.distributed.init_process_group("gloo", init_method=f"file://{out / 'rendezvous'}", world_size=world,
                                         rank=rank)
    try:
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(world // model, model)
        data = np.load(out / "inputs.npz")
        res = {}
        present = {k.split("/")[0] for k in data.files}
        for name in (n for n in CASES if n in present):
            case = {k[len(name) + 1:]: data[k] for k in data.files if k.startswith(name + "/")}
            res.update(run_case(name, case, mesh))
        np.savez(out / f"rank{rank}.npz", **res)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
