"""Time the encode and the attack's ALIE on the card at several tile widths.

``csrc/gather_combine.cu`` and ``csrc/attack.cu`` take the width C of the
(N, C) column tile a block stages in shared memory from
``kernels/tiles.py::tile_width``, which aims at ``tiles.TILE_BYTES`` of
shared memory a block. This script sets ``TILE_BYTES`` to each of
``--targets`` in turn, calls the two C entries directly with the width the
plans (``gather_tile``, ``attack_tile``) then give, and prints, for
each shape, target and kernel, C, the blocks launched and the median
CUDA-event ms, the L2 (50 MB) flushed before each launch below
``FLUSH_BELOW`` bytes of stack; every output is held bit for bit to the
plain version's (at the wide shape, on the last 2^20 columns). One JSON line
a shape, and the card's ``nvidia-smi`` name and power limit::

    PYTHONPATH=src python3 scripts/torch_tile_widths.py
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from repro_torch.kernels import _build, attacks, coded_combine, ref, tiles

# (lanes, N, Q, d): the main path at 1 and 1,000 lanes, the wide round
SHAPES = ((1, 100, 100, 10), (1000, 100, 100, 10), (1, 8, 361_821_120, 2))
FLUSH_BELOW = 1 << 30
TAIL = 1 << 20


def timed(fn, flush: torch.Tensor | None, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
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


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--targets", type=int, nargs="+", default=[12 << 10, 24 << 10, 48 << 10, 96 << 10, 227 << 10])
    args = parser.parse_args()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty((1 << 28) // 4, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gather_fn, attack_fn = _build.library("gather_combine"), _build.library("attack")
    for lanes, n, q, d in SHAPES:
        x = torch.randn((lanes, n, q), generator=gen, device="cuda")
        rows = torch.arange(n, device="cuda")
        subsets = ((rows[:, None] + torch.arange(d, device="cuda")) % n).to(torch.int32).expand(lanes, n, d).contiguous()
        w = torch.full((lanes, d), 1.0 / d, device="cuda")
        mask = (rows < max(1, n // 5)).float().expand(lanes, n).contiguous()
        out = torch.empty_like(x)
        small = x.numel() * 4 < FLUSH_BELOW
        iters = 20 if small else 5
        cut = slice(None) if small else slice(q - TAIL, q)
        want_enc = ref.gather_combine_ref(x[..., cut].contiguous(), subsets, w)
        want_alie = ref.attack_ref(x[..., cut].contiguous(), mask, "alie", 1.5)
        line = {"lanes": lanes, "n": n, "q": q, "d": d, "l2_flushed": small, "runs": []}
        for target in args.targets:
            tiles.TILE_BYTES = target
            enc_cols = coded_combine.gather_tile(lanes, n, q, d)
            alie_cols = attacks.attack_tile(lanes, n, q)

            def enc():
                launched(gather_fn(x.data_ptr(), subsets.data_ptr(), w.data_ptr(), out.data_ptr(), lanes, n, d, q,
                                   enc_cols, stream))

            def alie():
                launched(attack_fn(x.data_ptr(), mask.data_ptr(), out.data_ptr(), lanes, n, q, 1, 1.5, alie_cols,
                                   stream))

            enc()
            torch.cuda.synchronize()
            enc_ok = same_bits(out[..., cut], want_enc)
            enc_ms = timed(enc, flush if small else None, iters)
            alie()
            torch.cuda.synchronize()
            alie_ok = same_bits(out[..., cut], want_alie)
            alie_ms = timed(alie, flush if small else None, iters)
            line["runs"].append({
                "target_bytes": target,
                "encode": {"cols": enc_cols, "blocks": lanes * -(-q // enc_cols), "ms": enc_ms, "bitwise": enc_ok},
                "alie": {"cols": alie_cols, "blocks": lanes * -(-q // alie_cols), "ms": alie_ms, "bitwise": alie_ok}})
        print(json.dumps(line), flush=True)
        del x, subsets, w, mask, out, want_enc, want_alie
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
