"""Render the port's dry-run records (``launch.dryrun``) as markdown tables,
one a mesh.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]

Every time in them is a bound at the published peaks of the device the
records name, not a measurement. A serving row's collectives are those of
one decode step or one prefill, each with its greedy token.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MESH_TITLES = {"pod1": "single pod, 256 ranks", "pod2": "2 pods, 512 ranks"}
_COLUMNS = ("arch", "shape", "status", "params GiB/rank", "moments GiB/rank", "state GiB/rank", "exchange GiB",
            "wire GB/rank", "collectives a step", "compute s", "memory s", "collective s", "dominant")


def load(dir_: str, mesh: str) -> dict[tuple[str, str], dict]:
    recs = {}
    for path in glob.glob(os.path.join(dir_, "*.json")):
        with open(path) as f:
            r = json.load(f)
        if r.get("mesh") == mesh:
            recs[(r["arch"], r["shape"])] = r
    return recs


def _gib(r: dict, key: str) -> str:
    return f"{r[key] / 2**30:.3f}" if key in r else ""


def roofline_table(recs: dict, archs: list[str], mesh: str) -> str:
    devices = sorted({r["device"] for r in recs.values()})
    lines = [f"### Dry run, {mesh} ({MESH_TITLES.get(mesh, mesh)}): bounds at the peaks of {', '.join(devices)}", "",
             "| " + " | ".join(_COLUMNS) + " |", "|" + "---|" * len(_COLUMNS)]
    blank = " |" * (len(_COLUMNS) - 3)
    for arch in archs:
        for shape in SHAPE_ORDER:
            r = recs.get((arch, shape))
            if r is None:
                lines.append(f"| {arch} | {shape} | MISSING |{blank}")
            elif r["status"] != "ok":
                lines.append(f"| {arch} | {shape} | {r['status']} |{blank}")
            else:
                ro = r["roofline"]
                coll = r["collectives"]
                wire = f"{coll['total_wire_bytes'] / 1e9:.2f}"
                calls = coll.get("calls_by_kind")  # a serving step's (the train step's are not counted by call)
                wire += f" | {sum(calls.values())}" if calls is not None else " |"
                sizes = " | ".join(_gib(r, k) for k in ("params_bytes_per_rank", "moments_bytes_per_rank",
                                                        "decode_state_bytes_per_rank", "exchange_transient_bytes"))
                lines.append(f"| {arch} | {shape} | ok | {sizes} | {wire} | {ro['compute_s']:.2e} "
                             f"| {ro['memory_s']:.2e} | {ro['collective_s']:.2e} | **{ro['dominant']}** |")
    return "\n".join(lines)


def summary(recs: dict) -> str:
    ok = sum(1 for r in recs.values() if r["status"] == "ok")
    return f"{ok} ok / {len(recs) - ok} skipped (of {len(recs)})"


def main(argv: list[str] | None = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    from repro_torch.configs.archs import ARCHS

    out = []
    for mesh in ("pod1", "pod2"):
        recs = load(args.dir, mesh)
        if recs:
            out += [f"\n## {mesh}: {summary(recs)}\n", roofline_table(recs, sorted(ARCHS), mesh)]
    text = "\n".join(out)
    print(text)
    return text


if __name__ == "__main__":
    main()
