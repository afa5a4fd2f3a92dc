"""Time the Gram's and the row combine's launch plans on the card.

``csrc/gram.cu`` takes from ``kernels/nnm_dist.py::gram_plan`` the tile
pairs a block and the segment slots (``split``), and ``csrc/row_combine.cu``
takes from ``kernels/coded_combine.py::row_plan`` the groups G the rows are
dealt to and the columns V a thread loads at once. Neither changes the
bits, only the time. This script calls the two C entries directly at the
paper's N = Q = 100 (1 and 1,000 lanes; the row combine also at 20 lanes
and at ``_sum_last``'s (1, 100, 100,000)) under each alternative in
``GRAM_PLANS``, ``ROW_GROUPS`` and ``ROW_VECS``, beside the plan's own
choice and one ``torch.bmm`` computing the same function, and prints one
JSON line a shape: the median CUDA-event ms of 20 launches, the L2 (50 MB)
flushed before each, every output held to the plan's own (the Gram bit
for bit, the row combine bit for bit against its plain version), and the
card's ``nvidia-smi`` name and power limit::

    PYTHONPATH=src python3 scripts/torch_gram_row_plans.py
"""
from __future__ import annotations

import json
import statistics
import subprocess

import torch

from repro_torch.kernels import _build, coded_combine, nnm_dist, ref

# (pairs a block, segment slots) at N = 100: a segment a thread in blocks of
# 128 and 256 threads; a thread every segment in 1 to 11 blocks a lane
GRAM_PLANS = ((32, 4), (64, 4), (325, 1), (176, 1), (112, 1), (88, 1), (64, 1), (32, 1))
ROW_GROUPS = (8, 16)
ROW_VECS = (1, 4)  # columns a thread: 4-byte or 16-byte loads
FLUSH_BYTES = 1 << 28


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


def launched(err: int) -> None:
    if err:
        raise RuntimeError(f"kernel launch failed: CUDA error {err}")


def gram_line(lanes: int, flush: torch.Tensor, gen: torch.Generator) -> dict:
    n = q = 100
    x = torch.randn((lanes, n, q), generator=gen, device="cuda")
    own = nnm_dist.gram_plan(lanes, n, q)
    want, _ = nnm_dist.launch(x)
    gram, sq = torch.empty_like(want), torch.empty((lanes, n), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    fn = _build.library("gram")
    out = {"kernel": "gram", "lanes": lanes, "n": n, "q": q, "plan": own._asdict(), "ms": {}}
    for pairs, split in GRAM_PLANS:
        def call():
            launched(fn(x.data_ptr(), 0, gram.data_ptr(), sq.data_ptr(), lanes, n, q, own.chunk_len, own.chunks,
                        own.width, own.stride, pairs, split, stream))
        call()
        torch.cuda.synchronize()
        if not torch.equal(gram.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"gram at {pairs} pairs a block, split {split}: other bits than the plan's")
        out["ms"][f"pairs{pairs}_split{split}"] = timed(call, flush)
    out["plan_ms"] = timed(lambda: nnm_dist.launch(x), flush)
    out["bmm_ms"] = timed(lambda: torch.bmm(x, x.transpose(1, 2)), flush)
    return out


def row_line(lanes: int, q: int, flush: torch.Tensor, gen: torch.Generator) -> dict:
    r = 100
    x = torch.randn((lanes, r, q), generator=gen, device="cuda")
    w = torch.rand((lanes, r), generator=gen, device="cuda")
    o = torch.empty((lanes, q), device="cuda")
    want = ref.masked_combine_ref(x, w)
    stream = torch.cuda.current_stream().cuda_stream
    fn = _build.library("row_combine")
    groups, vec = coded_combine.row_plan(lanes, r, q, coded_combine.row_aligned(x, o))
    out = {"kernel": "masked_combine", "lanes": lanes, "r": r, "q": q, "plan_groups": groups, "plan_vec": vec,
           "ms": {}}
    for groups in ROW_GROUPS:
        for vec in ROW_VECS:
            def call():
                launched(fn(x.data_ptr(), w.data_ptr(), o.data_ptr(), lanes, r, q, groups, int(vec == 4), stream))
            call()
            torch.cuda.synchronize()
            if not torch.equal(o.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"row combine at G = {groups}, V = {vec}: other bits than the plain version's")
            out["ms"][f"G{groups}_V{vec}"] = timed(call, flush)
    out["plan_ms"] = timed(lambda: coded_combine.rows_launch(x, w, o), flush)
    out["bmm_ms"] = timed(lambda: torch.bmm(w[:, None, :], x), flush)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_gram_row_plans: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for lanes in (1, 1000):
        print(json.dumps({**gram_line(lanes, flush, gen), "nvidia_smi": smi}), flush=True)
    for lanes, q in ((1, 100), (20, 100), (1000, 100), (1, 100_000)):
        print(json.dumps({**row_line(lanes, q, flush, gen), "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
