"""Time CWTM-NNM's mix plan, the split design and where the kernel's time goes, on the card.

``csrc/cwtm.cu`` mixes and sorts CWTM-NNM (13 <= N <= 128) in one kernel
and takes from ``kernels/cwtm.py::mix_plan`` the column tile C and the
threads a block; neither changes the bits, only the time. At the paper's
N = Q = 100, k = 80 neighbours and trim 10, this script calls the C entry
directly at 1 and 4 lanes (the paper grid's NNM buckets) and at 1,000:

  * at the plan, and at other tiles (100 down to 8 columns) and block
    sizes (128 and 256 threads);
  * the split design it is held against (``scripts/cwtm_split_probe.cu``:
    a mix kernel writing the mixed (L, N, Q) stack, then the sort-only
    kernel), at its own tiles and 256 to 1,024 threads a mix block;
  * the kernel built again with its add loop switched off (``csrc/cwtm.cu``
    with the loop's condition made false, the rest as it is): what the
    staging, the table's masks and the sort take alone, so that the loop's
    share is the difference;
  * the CWTM kernel without the mix on the same stack (the sort alone).

It prints the registers and spills ``ptxas`` gave the split design's
kernels, then one JSON line a lane count: the median CUDA-event ms of 20
calls, the L2 (50 MB) flushed before each, every output of the one-kernel
and the split designs held bit for bit to ``cwtm.plain``, and the card's
``nvidia-smi`` name and power limit::

    PYTHONPATH=src python3 scripts/torch_mix_plans.py
"""
from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.core import aggregators
from repro_torch.kernels import _build, cwtm, ops

N, Q, BYZ, TRIM = 100, 100, 20, 10
TILES = (1, 2, 4, 7, 10, 13)  # column tiles a lane: 100, 52, 28, 16, 12 and 8 columns
THREADS = (128, 256)  # a block of the one-kernel design
SPLIT_THREADS = (256, 384, 512, 640)  # a mix block of the split design
SPLIT_SRC = Path(__file__).resolve().parent / "cwtm_split_probe.cu"
FLUSH_BYTES = 1 << 28
LOOP = "for (int w = 0; 32 * w < n; ++w) {"  # the mix's add loop over the ids j, 32 a mask word


def timed(fn, flush: torch.Tensor, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def probe_entry(stem: str, source: str, entry: str, argtypes) -> tuple[ctypes._CFuncPtr, str]:
    """``entry`` of ``source`` built beside copies of ``csrc``'s headers and
    of ``csrc/cwtm.cu`` (which ``source`` may include), and ``ptxas``'s log."""
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    for src in [*_build.CSRC_DIR.glob("*.cuh"), _build.CSRC_DIR / "cwtm.cu"]:
        (out / src.name).write_text(src.read_text())
    (out / f"{stem}.cu").write_text(source)
    lib = out / f"lib{stem}.so"
    done = subprocess.run([_build._nvcc(), *_build._FLAGS, "-o", str(lib), str(out / f"{stem}.cu")],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on {stem}.cu:\n{done.stderr}")
    fn = getattr(ctypes.CDLL(str(lib)), entry)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn, done.stdout + done.stderr


def loopless_entry():
    """``repro_cwtm`` built from ``csrc/cwtm.cu`` with the mix's add loop
    switched off (every mixed value -0.0 times 1/k)."""
    src = (_build.CSRC_DIR / "cwtm.cu").read_text()
    if src.count(LOOP) != 1:
        raise RuntimeError("csrc/cwtm.cu: the mix's add loop was not found once")
    src = src.replace(LOOP, "for (int w = 0; 32 * w < n && inv_mix < 0.f; ++w) {")
    return probe_entry("cwtm_loopless", src, "repro_cwtm", _build._SIGNATURES["cwtm"][1])[0]


def split_entry() -> tuple[ctypes._CFuncPtr, list[dict]]:
    """``repro_cwtm_split`` of ``scripts/cwtm_split_probe.cu`` and its
    kernels' registers and spill bytes."""
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    fn, log = probe_entry("cwtm_split", SPLIT_SRC.read_text(), "repro_cwtm_split",
                          (p, p, i, f, p, p, i, i, i64, i, f, i, i, p))
    ptxas = []
    for part in log.split("Compiling entry function")[1:]:
        name = part.split("'")[1]
        if "cwtm_split_mix_kernel" in name or "cwtm_net_kernelILi128" in name:
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
            ptxas.append({"entry": name, "registers": int(re.search(r"Used (\d+) registers", part).group(1)),
                          "spill_store_bytes": int(spills.group(1)), "spill_load_bytes": int(spills.group(2))})
    return fn, ptxas


def tile_cols(tiles: int) -> int:
    cols = -(-Q // tiles)
    return cols + (-cols) % 4


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    entry, loopless = _build.library("cwtm"), loopless_entry()
    split, split_ptxas = split_entry()
    print(json.dumps({"split_ptxas": split_ptxas, "nvidia_smi": smi}), flush=True)
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for lanes in (1, 4, 1000):
        x = torch.randn((lanes, N, Q), generator=gen, device="cuda")
        table = aggregators.nnm_neighbours(ops.pairwise_sqdist(x), BYZ).to(torch.int32).contiguous()
        k = table.shape[-1]
        plan = cwtm.mix_plan(lanes, N, Q, k)
        want = cwtm.plain(x, TRIM, table)
        mixed, out = torch.empty_like(x), torch.empty((lanes, Q), device="cuda")

        def one_kernel(fn):
            def call(cols, threads):
                return fn(x.data_ptr(), table.data_ptr(), k, 1.0 / k, out.data_ptr(), lanes, N, Q, TRIM,
                          1.0 / (N - 2 * TRIM), cols, threads, stream)
            return call

        def split_call(cols, threads):
            return split(x.data_ptr(), table.data_ptr(), k, 1.0 / k, mixed.data_ptr(), out.data_ptr(), lanes, N, Q,
                         TRIM, 1.0 / (N - 2 * TRIM), cols, threads, stream)

        def ms(call, cols, threads, check: bool = True) -> float:
            out.fill_(float("nan"))

            def run():
                err = call(cols, threads)
                if err:
                    raise RuntimeError(f"cwtm at cols={cols}, threads={threads}: CUDA error {err}")

            t = timed(run, flush)
            if check and not torch.equal(out, want):
                raise AssertionError(f"CWTM-NNM at cols={cols}, threads={threads} differs from cwtm.plain")
            return t

        kernel = one_kernel(entry)
        line = {"lanes": lanes, "n": N, "q": Q, "k": k, "trim": TRIM, "nvidia_smi": smi,
                "plan": plan._asdict(), "ms_at_plan": ms(kernel, plan.cols, plan.threads)}
        tiles = TILES if lanes < 1000 else (1, 2)
        line["ms_by_tiles_threads"] = {f"{tile_cols(t)}x{th}": ms(kernel, tile_cols(t), th)
                                       for t in tiles for th in THREADS}
        split_cols = cwtm.MIX_MAX_COLS if lanes >= 1000 else plan.cols
        split_cols = min(split_cols, tile_cols(1))
        line["split_ms_by_threads"] = {f"{split_cols}x{th}": ms(split_call, split_cols, th) for th in SPLIT_THREADS}
        if lanes < 1000:
            line["split_ms_by_threads"].update({f"{tile_cols(7)}x256": ms(split_call, tile_cols(7), 256)})
        line["ms_without_the_add_loop"] = ms(one_kernel(loopless), plan.cols, plan.threads, check=False)
        line["sort_alone_ms"] = timed(lambda: ops.cwtm(x, TRIM), flush)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
