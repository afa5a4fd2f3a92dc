#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of the protocol round from ``src/repro_torch/csrc``
and prints one JSON line per phase:

  device         the card, its power limit and the kernel build time;
  ptxas          registers and spills of every Gram and CWTM kernel entry,
                 as ``nvcc -Xptxas -v`` reported them when they were built;
  trajectory     the paper's Section-VII trainer on the card (N=100,
                 dim=100, 200 rounds) for every Fig. 4 row (DRACO-d41 at
                 N=82), every Fig. 6 row, and Com-CWTM, Com-LAD-CWTM and
                 Com-LAD-CWTM-NNM under QSGD at 4 levels (``quant:4``);
                 asserts the paper's orderings and holds the
                 LAD-CWTM-NNM-d10 and quant:4 Com-LAD-CWTM loss curves
                 against the same runs on the CPU (the plain versions) under
                 the same randomness;
  section7       the 15 rows of ``section7_grid()`` (plain, LAD-d10 and
                 DRACO-d4 under sign-flip, ALIE and IPM, with and without
                 random sparsification), 200 rounds each as one captured
                 round replayed (``mode="graph"``): final losses, ms per
                 round, and each kernel's launches in the captured round;
  graph          loop against graph mode on the same seed for six rows
                 (LAD-CWTM-NNM-d10, Com-LAD-CWTM under quant:4, DRACO-d41,
                 a markov and an onoff participation row, geomed under the
                 gaussian attack): asserts the final iterate, every metric
                 and the participation state equal bit for bit, and prints
                 ms per round of both;
  grid           ``scenarios.run_grid``, each bucket one captured round of
                 all its lanes replayed 200 times: ``section7_grid()`` (5
                 buckets), Fig. 4, Fig. 6 (``exact=False``), the quant:4
                 rows, ``participation_sweep()``, and
                 ``synthetic_sweep(1000)`` at N=16 (unchunked and in
                 chunks of 64) and at N=100 (100,000 encode rows); every
                 lane checked bit for bit against the standalone run of
                 its row (the earlier phases' runs where they ran it), per
                 bucket its lanes, draw groups, captured launches and
                 replay ms a round, per call its ms, peak memory and, for
                 the sweeps, lanes x rounds a second;
  participation  the K-of-N erasure sweep (N=16, d=4, dim=32, 400 rounds):
                 the erasure decode against the mean at e = 0..3 erased rows;
                 asserts N - e reports every round and that the decode's
                 final loss does not move with e;
  lm             the LM path: ``lm_sweep()``'s 12 rows on ``lm_arch()``
                 (N=10, 2 Byzantine, 4 buckets), 100 rounds, each row alone
                 in graph mode and all through ``run_lm_grid`` in graph
                 mode, every lane bit for bit against its row's run; one
                 row's loop mode bit for bit against its graph mode; one
                 row on the card against the CPU on the same records; per
                 bucket its lanes, replay ms a round and captured launches;
  lm_wide        ``run_lm_scenario`` at smollm-360m's published widths and
                 depth (P = 361,821,120), N=8, LAD d=2, CWTM under ALIE, 3
                 rounds after a warm-up round: per round the subset
                 gradients' ms and each stage's, peak memory, finite losses;
                 one round's aggregate through the kernels against the plain
                 versions, and a subset's vmapped gradient against a plain
                 backward;
  zoo            ``run_zoo_sweep()``: the seven ``ZOO_FAMILIES`` (dense,
                 Jamba's Mamba-MoE hybrid, RWKV-6, MoE, sliding window,
                 cross-attention, whisper) on their ``zoo_arch``, 2 rows
                 each, 50 rounds in graph mode: every lane bit for bit its
                 row's standalone graph run, loop bit for bit graph on the
                 LAD row, and the LAD row's loss curve on the card against
                 the CPU on the same records within 2e-6 (RWKV under the
                 provision of ``zoo_phase``); per family replay ms a round,
                 captured launches, the kernels of a subset-gradient call;
                 the kernels a token adds to the Mamba and RWKV loops;
  zoo_wide       as ``lm_wide``, for whisper-small whole (P = 335,106,048,
                 1500 frames, 1 row a subset), granite-moe-3b-a800m and
                 rwkv6-1.6b at their widths cut to 2 layers (P =
                 352,461,312 and 378,062,848);
  train          the LM train step (``launch.train.build_engine_step``) at
                 ``lm_arch()``, N=10, 4 steps, AdamW: loop bit for bit graph
                 mode under fp32 and bf16 moments and under 2 microbatches
                 with QSGD; warm steps and an equal configuration capture
                 nothing; a checkpoint after step 2, loaded and resumed, bit
                 for bit the uninterrupted run; the card's losses against
                 the CPU's on the same records;
  train_wide     the train step on smollm-360m at its published widths,
                 depth and dtype (bf16 weights, P = 361,821,120) with
                 ``TrainConfig``'s AdamW (bf16 moments), N=8, LAD d=2, CWTM
                 under ALIE: 3 steps in loop mode and 3 in graph mode after a
                 warm-up step, per step the card's and the host's ms, the
                 first graph step's (with the captures), each mode's peak
                 memory, finite losses, loop bit for bit graph, and the
                 optimizer apply alone against its byte bound;
  protomath      the ``"protomath"`` train step (``core/protomath.py``'s
                 per-parameter exchange) at ``lm_arch()`` in fp32, N=8 on
                 one rank under a 1-rank NCCL group, 4 steps, for CWTM
                 under ALIE, CWTM-NNM under sign-flip and CWTM under the
                 gaussian attack with QSGD (``quant:4``): the ``sharded``
                 server (its ``all_to_all``) bit for bit the ``gather``
                 one, the key-free setups' losses on the card against the
                 CPU's, one exchange through the kernels against the plain
                 versions, each kernel's launches in the exchange;
  protomath_wide the ``"protomath"`` step on smollm-360m at its published
                 widths, depth and dtype, ``train_wide``'s settings, under
                 the NCCL group: 3 steps after a warm-up step, card and
                 host ms a step, peak memory beside ``train_wide``'s, the
                 parameters exchanged a step (all P) and the attack and
                 CWTM launches, and the exchange alone against its byte
                 bound (the (8, P) fp32 blocks read once, the result
                 written once) and the bytes the attack and CWTM kernels
                 move as they run it;
  engine_shard   the engine over the ranks of that NCCL group
                 (``shard="shard_map"``): smollm-360m at ``train_wide``'s
                 settings, 3 loop steps sharded and 3 unsharded from one
                 state, bit for bit, with card and host ms a step and peak
                 memory, and a round as 2, 3 and 4 ranks compute it (each
                 share run in turn) against the unsharded round: losses bit
                 for bit, the aggregate's largest difference;
                 ``section7_grid()`` through ``run_grid`` in graph
                 mode, sharded bit for bit unsharded; the audio family's
                 engine step with its ``frontend``, sharded on the card,
                 against the CPU within 2e-6 a step;
  serve          the serving path (prefill, cached decode, ``serve_traffic``)
                 at the zoo's scale in fp32, for the seven ``ZOO_FAMILIES``
                 and a whisper arch whose first block is cross-attention:
                 prefill 13 tokens, decode 7, each step within
                 tests/test_serving.py's 5e-2 of the full forward (``moe``
                 and ``jamba``, whose capacity cut depends on the tokens
                 routed together, reported and held card against CPU
                 instead); the card's logits against the CPU's; loop bit
                 for bit graph mode; the chunked attention at 2,100 tokens
                 against the plain one, forward and backward; and train to
                 serve (``Trainer``, ``save``, ``restore_for_serving`` bit
                 for bit, the same served tokens);
  serve_wide     smollm-360m at its published widths, depth and dtype:
                 ``decode_32k`` at its batch of 128 against a full
                 8,192-slot ring (ms a step beside the byte bound, tokens/s,
                 peak memory, loop bit for bit graph, the bytes a step's
                 copies move, where a step's kernel time goes, one layer's
                 decode attention against its bound and the library call),
                 ``prefill_32k`` at batch 1 (ms beside the FLOP bound, then
                 8 decode steps; one layer's chunked attention likewise),
                 conformance past 4,096 tokens, ``long_500k`` decode, and
                 whisper-small whole through ``serve_traffic``;
  fleet          real fleets of ``python -m repro_torch.launch.fleet``
                 processes on the card at the paper's width (N=100, dim=100,
                 d=20, 10 processes of 10 devices, the server's own block
                 included; 20 rounds): (a) ``identity`` with the gloo
                 identity layer, every device reporting, its losses within
                 2e-6 of the same fleet on the CPU; (b) ``quant:4``, at
                 least ``fleet_comlad_cases()``'s ratio fewer uplink bytes
                 a round, measured frame bytes as predicted, within the
                 erasure-decode envelope of (a); (c) a worker killed at
                 round 5, its rows erased from then on; (d) the
                 ``quant4_chaos_byz`` schedule, its faults tallied as
                 erasures. Per row the final loss, the least report count,
                 ``dead``, ``rejoins``, wire faults, Com-LAD bytes, the
                 server's median ms a round and the start-up seconds apart;
                 ``fleet_launches``: the servers' and the workers' kernel
                 launches, counted in those fleets' processes alone;
  wide_round     protocol rounds at the gradient width of smollm-360m
                 (Q = 361,821,120; N=8, d=2), each after a warm-up round:
                 CWTM-NNM under ALIE and sign-flip, Com-LAD with quant:4
                 under ALIE, the erasure decode with one row erased, DRACO
                 (d=4, one sign-flipping device), and median (ALIE), krum
                 (sign-flip), multi_krum (IPM), geomed (gaussian) and mcc
                 (ALIE); per-stage ms (the CWTM-NNM server split into the
                 Gram distances, the neighbour selection and the one CWTM
                 launch that mixes as it reads), peak memory, finiteness,
                 each round's CWTM and Gram launches, and the decode and
                 DRACO's vote held to the gradients' mean;
  kernels        per kernel: its error against its plain version on the
                 card (at small shapes, and at the wide shape on columns
                 past element 2^31), its time at the wide shape beside the
                 plain version's, a PyTorch library call's where one
                 computes the same function, and the least time the card
                 could take; ``median`` through the CWTM kernel bitwise
                 against the plain version at N = 8, 41 and 100; plus its
                 launches during the phases above, which must all be above
                 0 (``lm_launches``: those of the eight LM phases, counted
                 from 0 before them, where the encode, attack and CWTM
                 kernels must be above 0; ``protomath_launches``: those of
                 the two protomath phases' train steps, the warm-up step
                 included, counted in each step run's own window (not the
                 exchanges held against their plain versions or timed
                 alone), where the attack, CWTM, Gram and QSGD kernels
                 must be above 0; ``engine_shard_launches``: those of the
                 ``engine_shard`` phase's sharded steps and first sharded
                 grid call, never the unsharded runs they are held to, where
                 the encode, attack and CWTM kernels must be above 0;
                 ``fleet_launches``: those of the ``fleet`` phase's card
                 fleets, server and workers summed), and
                 the launches that graph
                 replays ran on the card
                 beside them, which no counter sees (``coded_combine``, which
                 no path of the reference runs, carries ``"on_path": false``
                 and its launches in this phase). The CWTM row is the fused
                 CWTM-NNM server (the CWTM kernel given NNM's neighbour
                 table), with the kernel's time without the mix and the old
                 route's (a cuBLAS mixing product, then the CWTM kernel)
                 beside it;

(``wide_round`` runs before the LM phases, so its peaks are its own), then
the card's name and power limit as ``nvidia-smi`` gives them, and, as
the last line, ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero. Without a CUDA card, or without the
repository's ``src/repro_torch`` beside it, it exits non-zero at once.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed

ROOT = Path(__file__).resolve().parent

WIDE_Q = 361_821_120  # parameters of smollm-360m: the gradient width of one round
WIDE_N = 8
PLAIN_Q = 1 << 26  # the plain versions are timed on this many coordinates
CHECK_SHAPES = ((100, 100), (100, (1 << 20) + 37), (8, 1 << 20))  # (N, Q)
MEDIAN_N = (8, 41, 100)  # the wide round's N, DRACO-d41's groups, the trainer's N
RTOL, ATOL = 1e-5, 1e-6  # kernel against plain, as tests/test_torch_kernels.py
TRAJECTORY_RTOL = 2e-6  # card against CPU over 200 rounds, as tests/test_torch_engine.py
STEPS = 200

# Published peaks by card name (NVIDIA data sheet, SXM part at 700 W): HBM
# bytes/s and fp32 FLOP/s outside the tensor cores. Only the card this
# script has run on is listed; another card needs its own entry.
_PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}
_TENSOR_PEAKS = {"NVIDIA H100 80GB HBM3": 989e12}  # dense bf16 FLOP/s on the tensor cores, the same sheet

TPU_KERNELS = {
    "gather_combine": ("src/repro_torch/csrc/gather_combine.cu", "src/repro/kernels/coded_combine.py:70"),
    "attack": ("src/repro_torch/csrc/attack.cu", "src/repro/kernels/attacks.py:97"),
    "cwtm": ("src/repro_torch/csrc/cwtm.cu", "src/repro/kernels/cwtm.py:71"),
    "gram": ("src/repro_torch/csrc/gram.cu", "src/repro/kernels/nnm_dist.py:42"),
    "quantize": ("src/repro_torch/csrc/quantize.cu", "src/repro/kernels/quantize.py:35"),
    "masked_combine": ("src/repro_torch/csrc/row_combine.cu", "src/repro/kernels/coded_combine.py:132"),
    "coded_combine": ("src/repro_torch/csrc/row_combine.cu", "src/repro/kernels/coded_combine.py:30"),
}
OFF_PATH = ("coded_combine",)  # no path of the reference runs it: checked in the kernels phase
BITWISE = ("cwtm", "quantize", "masked_combine", "coded_combine")  # held to their plain versions bit for bit
QUANT_LEVELS, QUANT_CHUNK = 4, 1024


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peaks(name: str) -> tuple[float, float]:
    if name not in _PEAKS:
        raise RuntimeError(f"no published peak rates for {name!r} in _PEAKS: add the card's own")
    return _PEAKS[name]


def tensor_peak(name: str) -> float:
    if name not in _TENSOR_PEAKS:
        raise RuntimeError(f"no published bf16 tensor-core peak for {name!r} in _TENSOR_PEAKS: add the card's own")
    return _TENSOR_PEAKS[name]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_entries(log: str) -> list[dict]:
    """Registers and spill bytes of each kernel entry in an ``nvcc -Xptxas
    -v`` log."""
    entries = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            m = re.search(r"((?:gram|cwtm)_(?:reg|smem|reduce)_kernel)(?:ILi(\d+)E)?", mangled)
            name = mangled if m is None else m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            entries.append({"entry": name})
        elif entries and "spill stores" in line:
            nums = [int(t) for t in re.findall(r"(\d+) bytes", line)]
            entries[-1].update({"stack_bytes": nums[0], "spill_store_bytes": nums[1], "spill_load_bytes": nums[2]})
        elif entries and "Used" in line and "registers" in line:
            entries[-1]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return entries


def time_ms(fn, iters: int = 5) -> float:
    """Median CUDA-event time of one call after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------- kernels


def kernel_errors(ops, ref, quantize, agg) -> dict[str, float]:
    """Max abs error of every kernel against its plain version on the card,
    over CHECK_SHAPES; raises past the tolerance (for the BITWISE kernels,
    on any difference). CWTM is checked with and without NNM's mix."""
    err = {name: 0.0 for name in TPU_KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, q in CHECK_SHAPES:
        x = torch.randn((n, q), generator=gen, device="cuda") * 3.0
        mask = (torch.arange(n, device="cuda") < max(1, n // 5)).float()
        d = 10 if n >= 10 else 2
        subsets = torch.randint(0, n, (n, d), generator=gen, device="cuda")
        w = torch.full((d,), 1.0 / d, device="cuda")
        pairs = [("gather_combine", ops.gather_combine(x, subsets, w), ref.gather_combine_ref(x, subsets, w), ATOL)]
        for name, param in (("sign_flip", -2.0), ("alie", 1.5), ("ipm", 0.5)):
            pairs.append(("attack", ops.attack(x, mask, name, param), ref.attack_ref(x, mask, name, param), ATOL))
        trim = int(0.1 * n) if n >= 10 else 2
        pairs.append(("cwtm", ops.cwtm(x, trim), ref.cwtm_ref(x, trim), ATOL))
        table = agg.nnm_neighbours(ops.pairwise_sqdist(x), n // 5 if n >= 10 else 2)
        pairs.append(("cwtm", ops.cwtm(x, trim, table), ref.cwtm_ref(ref.nnm_mix_ref(x, table), trim), ATOL))
        gram, sq = ops.gram(x)
        want_gram, want_sq = ref.gram_ref(x)
        # an fp32 dot product's rounding scales with the largest squared row norm
        scale = float(want_sq.max())
        pairs += [("gram", gram, want_gram, ATOL * scale), ("gram", sq, want_sq, ATOL * scale)]
        u = torch.rand((n, q), generator=gen, device="cuda")
        for levels, chunk in ((QUANT_LEVELS, QUANT_CHUNK), (16, 1000), (3, 7)):
            pairs.append(("quantize", ops.stochastic_quantize(x, u, levels, chunk),
                          quantize.plain(x, u, levels, min(chunk, q)), 0.0))
        del u
        # the decode's weights: a mask times a class selection, exact zeros on most rows
        rw = (torch.rand((n,), generator=gen, device="cuda") < 0.5) * torch.rand((n,), generator=gen, device="cuda")
        pairs.append(("masked_combine", ops.masked_combine(x, rw), ref.masked_combine_ref(x, rw), 0.0))
        stack = x[: n - n % 2].reshape(-1, 2, q)  # (N/2, d=2, Q) lanes, as the wide shape's (8, 2, Q)
        cw = torch.rand((stack.shape[0], 2), generator=gen, device="cuda")
        pairs.append(("coded_combine", ops.coded_combine(stack, cw), ref.coded_combine_ref(stack, cw), 0.0))
        hold_pairs(err, pairs, f"N={n} Q={q}")
    for n in MEDIAN_N:  # the median is the CWTM kernel at trim (N - 1) // 2
        x = torch.randn((n, (1 << 16) + 37), generator=gen, device="cuda")
        hold_pairs(err, [("cwtm", agg.coordinate_median(x), ref.cwtm_ref(x, (n - 1) // 2), 0.0)],
                   f"median N={n}")
    return err


def hold_pairs(err: dict[str, float], pairs, where: str) -> None:
    """Hold each (name, kernel output, plain output, atol) pair: bitwise for
    the BITWISE kernels, else within RTOL and atol; track the max error."""
    torch.cuda.synchronize()
    for name, got, want, atol in pairs:
        check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)} at {where}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output at {where}")
        check(torch.equal(got, want) if name in BITWISE else torch.allclose(got, want, rtol=RTOL, atol=atol),
              f"{name} disagrees with its plain version at {where}")
        err[name] = max(err[name], float((got - want).abs().max()))


def kernel_timings(ops, ref, quantize, agg, hbm: float, fp32: float) -> dict[str, dict]:
    """Kernel, plain and library times at the wide shape (N=8, Q=WIDE_Q),
    the least time the card could take, and each kernel's agreement with its
    plain version at that shape.

    The kernels work column by column (the Gram sums over columns), so the
    full-width output's last PLAIN_Q columns are held against the plain
    version of the input's last PLAIN_Q columns; for rows 6 and 7 those lie
    past element 2^31, where a 32-bit offset would read the wrong rows. The
    Gram is held against the plain version summed over blocks of PLAIN_Q
    columns, and QSGD on a window that starts on a block boundary and ends
    in the rows' ragged last block. Raises past the tolerance of
    ``kernel_errors``."""
    n, q = WIDE_N, WIDE_Q
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((n, q), generator=gen, device="cuda")
    # the Byzantine rows are the last two: every element they write lies past 2^31
    mask = (torch.arange(n, device="cuda") >= n - 2).float()
    # the cyclic assignment at d=2, so every row is read
    rows = torch.arange(n, device="cuda")
    subsets = torch.stack([rows, (rows + 1) % n], dim=1)
    w = torch.full((2,), 0.5, device="cuda")
    xp = x[:, :PLAIN_Q].contiguous()
    tail = x[:, q - PLAIN_Q:].contiguous()
    mix = torch.zeros((n, n), device="cuda")
    mix.index_put_((rows[:, None].expand(n, 2), subsets), w.expand(n, 2), accumulate=True)
    f32 = 4
    out = {}

    def entry(name, kernel_ms, kernel_plain_q_ms, plain_ms, library_ms, nbytes, nops):
        bound_bytes, bound_ops = nbytes / hbm * 1e3, nops / fp32 * 1e3
        out[name] = {
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "shape": [n, q], "plain_q": PLAIN_Q, "ms_at_plain_q": kernel_plain_q_ms,
            "max_abs_err_wide": 0.0,
        }

    def hold(name, got, want, atol=ATOL):
        torch.cuda.synchronize()
        where = f"N={n} Q={q}"
        check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)} at {where}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output at {where}")
        check(torch.equal(got, want) if name in BITWISE else torch.allclose(got, want, rtol=RTOL, atol=atol),
              f"{name} disagrees with its plain version at {where}")
        err = out[name]["max_abs_err_wide"]
        out[name]["max_abs_err_wide"] = max(err, float((got - want).abs().max()))

    entry("gather_combine",
          time_ms(lambda: ops.gather_combine(x, subsets, w)),
          time_ms(lambda: ops.gather_combine(xp, subsets, w)),
          time_ms(lambda: ref.gather_combine_ref(xp, subsets, w)),
          time_ms(lambda: torch.mm(mix, x)),
          f32 * 2 * n * q, 2 * 2 * n * q)
    hold("gather_combine", ops.gather_combine(x, subsets, w)[:, q - PLAIN_Q:],
         ref.gather_combine_ref(tail, subsets, w))

    modes = (("sign_flip", -2.0), ("alie", 1.5), ("ipm", 0.5))
    by_mode = {name: time_ms(lambda: ops.attack(x, mask, name, param)) for name, param in modes}
    entry("attack", by_mode["alie"],
          time_ms(lambda: ops.attack(xp, mask, "alie", 1.5)),
          time_ms(lambda: ref.attack_ref(xp, mask, "alie", 1.5)),
          None, f32 * 2 * n * q, 8 * n * q)
    out["attack"]["ms_by_mode"] = by_mode
    for name, param in modes:
        hold("attack", ops.attack(x, mask, name, param)[:, q - PLAIN_Q:],
             ref.attack_ref(tail, mask, name, param))

    # the wide round's server: trim 2, the mix over k = 6 neighbours (2 Byzantine)
    trim = 2
    table = agg.nnm_neighbours(ops.pairwise_sqdist(x), 2)
    k = table.shape[-1]
    # mix (k adds and a product per value), sort, kept-row tree and product per coordinate
    entry("cwtm",
          time_ms(lambda: ops.cwtm(x, trim, table)),
          time_ms(lambda: ops.cwtm(xp, trim, table)),
          time_ms(lambda: ref.cwtm_ref(ref.nnm_mix_ref(xp, table), trim)),
          None, f32 * (n * q + q), (n * (k + 1) + n * (n // 2) * 2 + (n - 2 * trim) + 1) * q)
    # the old route: NNM's (N, N) mixing matrix through cuBLAS in fp32, then the CWTM kernel
    old_mix = torch.zeros((n, n), device="cuda").scatter_(1, table.long(), 1.0 / k)
    out["cwtm"].update({
        "neighbours_k": k, "trim": trim,
        "ms_without_mix": time_ms(lambda: ops.cwtm(x, trim)),
        "old_route_ms": time_ms(lambda: ops.cwtm(torch.matmul(old_mix, x), trim)),
        "old_route": "torch.matmul(mix, X) in fp32 (cuBLAS), then the CWTM kernel without the mix",
    })
    hold("cwtm", ops.cwtm(x, trim, table)[q - PLAIN_Q:], ref.cwtm_ref(ref.nnm_mix_ref(tail, table), trim))
    hold("cwtm", ops.cwtm(x, trim)[q - PLAIN_Q:], ref.cwtm_ref(tail, trim))
    del tail

    entry("gram",
          time_ms(lambda: ops.gram(x)),
          time_ms(lambda: ops.gram(xp)),
          time_ms(lambda: ref.gram_ref(xp)),
          time_ms(lambda: torch.mm(x, x.T)),
          f32 * (n * q + n * n + n), 2 * (n * n + n) * q)
    gram, sq = ops.gram(x)
    want_gram, want_sq = torch.zeros_like(gram), torch.zeros_like(sq)
    for start in range(0, q, PLAIN_Q):
        g_blk, sq_blk = ref.gram_ref(x[:, start:start + PLAIN_Q].contiguous())
        want_gram += g_blk
        want_sq += sq_blk
    # an fp32 dot product's rounding scales with the largest squared row norm
    scale = float(want_sq.max())
    hold("gram", gram, want_gram, ATOL * scale)
    hold("gram", sq, want_sq, ATOL * scale)
    del gram, sq, want_gram, want_sq

    u = torch.rand((n, q), generator=gen, device="cuda")
    up = u[:, :PLAIN_Q].contiguous()
    lv, ch = QUANT_LEVELS, QUANT_CHUNK
    # abs, max, two divisions, two products, floor, subtract, compare, add per coordinate
    entry("quantize",
          time_ms(lambda: ops.stochastic_quantize(x, u, lv, ch)),
          time_ms(lambda: ops.stochastic_quantize(xp, up, lv, ch)),
          time_ms(lambda: quantize.plain(xp, up, lv, ch)),
          None, f32 * 3 * n * q, 10 * n * q)
    # a window from a block boundary to the end: it ends in the ragged last block
    start = ((q - PLAIN_Q) // ch) * ch
    hold("quantize", ops.stochastic_quantize(x, u, lv, ch)[:, start:],
         quantize.plain(x[:, start:].contiguous(), u[:, start:].contiguous(), lv, ch))
    del u, up

    rw = torch.rand((n,), generator=gen, device="cuda")
    entry("masked_combine",
          time_ms(lambda: ops.masked_combine(x, rw)),
          time_ms(lambda: ops.masked_combine(xp, rw)),
          time_ms(lambda: ref.masked_combine_ref(xp, rw)),
          time_ms(lambda: torch.matmul(rw, x)),
          f32 * (n * q + q), 2 * n * q)
    hold("masked_combine", ops.masked_combine(x, rw)[q - PLAIN_Q:],
         ref.masked_combine_ref(x[:, q - PLAIN_Q:].contiguous(), rw))

    # (L=8, d=2, Q): every device's two cyclic subsets, stacked
    stack = torch.stack([x, x[(rows + 1) % n]], dim=1)
    del x, xp
    cw = torch.rand((n, 2), generator=gen, device="cuda")
    sp = stack[:, :, :PLAIN_Q].contiguous()
    entry("coded_combine",
          time_ms(lambda: ops.coded_combine(stack, cw)),
          time_ms(lambda: ops.coded_combine(sp, cw)),
          time_ms(lambda: ref.coded_combine_ref(sp, cw)),
          time_ms(lambda: torch.matmul(cw[:, None, :], stack)),
          f32 * (2 * n * q + n * q), 2 * 2 * n * q)
    out["coded_combine"]["shape"] = [n, 2, q]
    hold("coded_combine", ops.coded_combine(stack, cw)[:, q - PLAIN_Q:],
         ref.coded_combine_ref(stack[:, :, q - PLAIN_Q:].contiguous(), cw))
    return out


# ---------------------------------------------------------------- trajectory


TRAJECTORY_KERNELS = ("gather_combine", "attack", "cwtm", "gram", "quantize")  # what the trainer rows reach


def trajectory_phase(S, byz, ops, gen_problem) -> tuple[dict, dict]:
    """Fig. 4 and Fig. 6 rows on the card, 200 rounds each,
    and three Fig. 6 rows under QSGD at 4 levels (``quant:4``, the fleet's
    wire format) in place of random sparsification.

    Every row trains on one problem drawn from seed 0, as each figure's
    example does (examples/linear_regression_paper.py,
    examples/compressed_training.py). Returns the phase's line and what the
    grid phase reuses: the problem, the rows, their results and the
    CPU-drawn records of the two rows held against the CPU."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    problem = gen_problem(gen, n=100, dim=100, sigma_h=0.3)
    quant = {f"{k}/quant:4": dataclasses.replace(S.PAPER_FIG6[k], name=f"{k}/quant:4", compressor="quant:4")
             for k in ("Com-CWTM", "Com-LAD-CWTM", "Com-LAD-CWTM-NNM")}
    rows = [S.PAPER_FIG4[k] for k in S.PAPER_FIG4] + [S.PAPER_FIG6[k] for k in S.PAPER_FIG6] + list(quant.values())
    nnm = S.PAPER_FIG4["LAD-CWTM-NNM-d10"]
    qlad = quant["Com-LAD-CWTM/quant:4"]
    cpu_gen = torch.Generator().manual_seed(1)
    # one provider per row held against the CPU: records drawn on the CPU, moved to each run's device
    shared = {row.name: [byz.sample_round_randomness(row.protocol(), 100, cpu_gen) for _ in range(STEPS)]
              for row in (nnm, qlad)}
    final, ms_per_round, results = {}, {}, {}
    for scn in rows:
        provider = (lambda t, recs=shared[scn.name]: recs[t]) if scn.name in shared else None
        torch.cuda.synchronize()
        start = time.perf_counter()
        res = S.run_scenario(scn, STEPS, seed=0, problem=problem, randomness=provider, device="cuda")
        torch.cuda.synchronize()
        ms_per_round[scn.name] = (time.perf_counter() - start) * 1e3 / STEPS
        loss = res.metrics["loss"]
        check(loss.shape == (STEPS,) and bool(torch.isfinite(loss).all()), f"{scn.name}: bad loss")
        final[scn.name] = float(loss[-1])
        results[scn.name] = res
    check(final["LAD-CWTM-d10"] < final["CWTM"], "Fig. 4 ordering: LAD-CWTM-d10 must end below CWTM")
    # benchmarks/paper_figures.py::fig4_training_loss's DRACO claim
    check(final["DRACO-d41"] < min(final["LAD-CWTM-d20"], final["CWTM"]),
          "Fig. 4 ordering: DRACO-d41 must end below LAD-CWTM-d20 and CWTM")
    check(final["Com-LAD-CWTM"] < final["Com-CWTM"], "Fig. 6 ordering: Com-LAD-CWTM must end below Com-CWTM")
    check(final["Com-LAD-CWTM-NNM/quant:4"] < final["Com-CWTM/quant:4"],
          "Fig. 6 ordering under quant:4: Com-LAD-CWTM-NNM must end below Com-CWTM")

    rel = {}
    for row in (nnm, qlad):
        cpu = S.run_scenario(row, STEPS, seed=0, problem=tuple(t.cpu() for t in problem),
                             randomness=lambda t, recs=shared[row.name]: recs[t], device="cpu")
        card_loss = results[row.name].metrics["loss"].cpu()
        rel[row.name] = float(((card_loss - cpu.metrics["loss"]).abs() / cpu.metrics["loss"].abs()).max())
        check(rel[row.name] <= TRAJECTORY_RTOL,
              f"{row.name} card vs CPU loss: rel {rel[row.name]} > {TRAJECTORY_RTOL}")
    launches = ops.launch_counts()
    for name in TRAJECTORY_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the trainer")
    check(launches["cwtm_nnm"] > 0, "the CWTM-NNM rows did not take the fused CWTM-NNM launch")
    line = {"phase": "trajectory", "launches": launches, "rounds": STEPS, "n_devices": 100, "dim": 100,
            "final_loss": final, "ms_per_round": ms_per_round,
            "card_vs_cpu_max_rel_loss": rel, "tolerance": TRAJECTORY_RTOL,
            "orderings": {"LAD-CWTM-d10<CWTM": True, "DRACO-d41<min(LAD-CWTM-d20,CWTM)": True,
                          "Com-LAD-CWTM<Com-CWTM": True,
                          "quant:4 Com-LAD-CWTM-NNM<Com-CWTM": True},
            "reported_not_asserted": {"quant:4 Com-LAD-CWTM<Com-CWTM":
                                      final["Com-LAD-CWTM/quant:4"] < final["Com-CWTM/quant:4"]}}
    return line, {"problem": problem, "quant_rows": list(quant.values()), "results": results, "records": shared}


# ------------------------------------------------------- section 7, graph


def section7_phase(S, replayed: dict[str, int]) -> tuple[dict, dict]:
    """The 15 rows of ``section7_grid()``, 200 rounds each in graph mode,
    each on its own problem from seed 0, as the reference's
    ``benchmarks/paper_figures.py::section7_sweep`` runs them. Adds each
    row's replayed launches (captured x replays) to ``replayed``. Returns
    the phase's line and each row's result."""
    final, ms_per_round, replay_ms_per_round, captured, results = {}, {}, {}, {}, {}
    for scn in S.section7_grid():
        torch.cuda.synchronize()
        start = time.perf_counter()
        res = S.run_scenario(scn, STEPS, seed=0, device="cuda", mode="graph")
        torch.cuda.synchronize()
        ms_per_round[scn.name] = (time.perf_counter() - start) * 1e3 / STEPS
        replay_ms_per_round[scn.name] = res.graph.replay_ms() / STEPS
        loss = res.metrics["loss"]
        check(loss.shape == (STEPS,) and bool(torch.isfinite(loss).all()), f"{scn.name}: bad loss")
        check(res.graph.replays == STEPS, f"{scn.name}: {res.graph.replays} replays")
        final[scn.name] = float(loss[-1])
        results[scn.name] = res
        captured[scn.name] = {k: v for k, v in res.graph.captured_launches.items() if v}
        for k, v in res.graph.captured_launches.items():
            replayed[k] += v * res.graph.replays
    check(len(final) == 15, f"section7_grid gave {len(final)} rows")
    return {"phase": "section7", "rows": len(final), "rounds": STEPS, "mode": "graph", "final_loss": final,
            "ms_per_round": ms_per_round, "replay_ms_per_round": replay_ms_per_round,
            "captured_launches_per_round": captured}, results


def graph_rows(S) -> list:
    """The rows whose graph mode is held to loop mode bit for bit."""
    q4 = dataclasses.replace(S.PAPER_FIG6["Com-LAD-CWTM"], name="Com-LAD-CWTM/quant:4", compressor="quant:4")
    markov, onoff = (S.participation_sweep(schedules=(sched,), aggregators=(agg,), n_byz=3)[0]
                     for sched, agg in (("markov", "decode"), ("onoff", "cwtm")))
    geomed = S.Scenario(name="LAD-geomed-d10/gaussian", method="lad", d=10, aggregator="geomed",
                        attack="gaussian", n_byz=20)
    return [S.PAPER_FIG4["LAD-CWTM-NNM-d10"], q4, S.PAPER_FIG4["DRACO-d41"], markov, onoff, geomed]


def same_bits(a, b) -> bool:
    """Two trajectory results agree bit for bit: iterate, every metric and
    the participation state."""
    if not torch.equal(a.x, b.x) or sorted(a.metrics) != sorted(b.metrics):
        return False
    if (a.participation_state is None) != (b.participation_state is None):
        return False
    return all(torch.equal(a.metrics[k], b.metrics[k]) for k in a.metrics) and (
        a.participation_state is None or torch.equal(a.participation_state, b.participation_state))


def graph_phase(S, replayed: dict[str, int]) -> dict:
    """Loop and graph mode on the same seed, 200 rounds, for ``graph_rows``:
    must agree bit for bit. The participation rows run at their sweep's
    dim=32, the others at dim=100."""
    rows = {}
    for scn in graph_rows(S):
        dim = PART_DIM if scn.participation != "full" else 100
        ms, results = {}, {}
        for mode in ("loop", "graph"):
            torch.cuda.synchronize()
            start = time.perf_counter()
            results[mode] = S.run_scenario(scn, STEPS, seed=0, dim=dim, device="cuda", mode=mode)
            torch.cuda.synchronize()
            ms[mode] = (time.perf_counter() - start) * 1e3 / STEPS
        stats = results["graph"].graph
        check(same_bits(results["loop"], results["graph"]), f"{scn.name}: graph mode differs from loop mode")
        for k, v in stats.captured_launches.items():
            replayed[k] += v * stats.replays
        rows[scn.name] = {"loop_ms_per_round": ms["loop"], "graph_ms_per_round": ms["graph"],
                          "graph_replay_ms_per_round": stats.replay_ms() / STEPS, "bitwise": True,
                          "final_loss": float(results["graph"].metrics["loss"][-1]),
                          "captured_launches_per_round": {k: v for k, v in stats.captured_launches.items() if v}}
    return {"phase": "graph", "rounds": STEPS, "rows": rows}


# ---------------------------------------------------------------------- grid

SWEEP_CHUNK = 64  # lanes per chunk of the chunked 1000-lane sweep: 16 chunks, the last one padded


def lanes_equal(grid_res, alone, what: str) -> None:
    """A grid lane and a standalone run agree bit for bit (``same_bits``)."""
    check(same_bits(grid_res, alone), f"grid {what}: differs from its standalone run")


def grid_phase(S, trajectory: dict, section7: dict, replayed: dict[str, int]) -> dict:
    """``scenarios.run_grid`` on the card, each bucket one captured round of
    all its lanes replayed 200 times (``mode="graph"``):

      * ``section7_grid()`` (15 rows, 5 buckets), each lane held bit for bit
        to the ``section7`` phase's graph-mode run of its row;
      * Fig. 4 (``exact=True``) and Fig. 6 (``exact=False``) on the shared
        seed-0 problem, as the examples run them, and the three ``quant:4``
        rows (``exact=False``: the two LAD rows share a bucket), each lane
        held to the ``trajectory`` phase's loop-mode run of its row (the
        rows that phase drew on the CPU read the same records here);
      * ``participation_sweep()`` (iid, onoff and adversarial, decode and
        mean, N=16, dim=32, ``exact=False``: one bucket a schedule), held
        to standalone graph-mode runs of the same rows;
      * ``synthetic_sweep(1000, n_devices=16, n_byz=3)`` at dim=32 (the
        reference's ``grid_sharded`` configuration), unchunked and in chunks
        of 64 lanes, bit for bit, and eight lanes held to standalone runs:
        the first and the last, one of each attack, and the lanes on both
        sides of the first chunk boundary and of the padded last chunk's;
      * ``synthetic_sweep(1000, n_devices=100, n_byz=20)`` at dim=100, the
        paper's width in 1000 lanes (100,000 folded encode rows), three
        lanes held to standalone runs.

    Adds every chunk's replayed launches to ``replayed``."""
    out = {"phase": "grid", "rounds": STEPS, "mode": "graph", "calls": {}}

    def run(name, rows, standalone_replay=None, **kw):
        """One ``run_grid`` call: its host time, and per bucket the lanes,
        draw groups, chunks, captured launches and replay ms a round."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        res = S.run_grid(rows, STEPS, seed=0, device="cuda", **kw)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - start) * 1e3
        buckets = {}
        for row in rows:
            stats = res[row.name].grid
            buckets.setdefault(id(stats), (stats, []))[1].append(row.name)
        lines = []
        for stats, names in buckets.values():
            check(len(stats.graphs) == stats.chunks and all(g.replays == STEPS for g in stats.graphs),
                  f"grid {name}: a chunk was not replayed {STEPS} times")
            for g in stats.graphs:
                for k, v in g.captured_launches.items():
                    replayed[k] += v * g.replays
            alone = None
            if standalone_replay is not None and all(n in standalone_replay for n in names):
                alone = sum(standalone_replay[n] for n in names)
            lines.append({"lanes": stats.lanes, "draw_groups": stats.draw_groups, "chunk": stats.chunk,
                          "chunks": stats.chunks, "branches": stats.branches,
                          "captured_launches_per_round": {k: v for k, v in stats.captured_launches().items() if v},
                          "replay_ms_per_round": stats.replay_ms() / STEPS,
                          "standalone_replay_ms_per_round_sum": alone, "first_row": names[0]})
        for row in rows:
            loss = res[row.name].metrics["loss"]
            check(loss.shape == (STEPS,) and bool(torch.isfinite(loss).all()), f"grid {name}: {row.name} bad loss")
        out["calls"][name] = {"rows": len(rows), "buckets": lines, "call_ms": call_ms,
                              "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        return res

    # section 7: each row on its own seed-0 problem, as the section7 phase ran it
    rows = S.section7_grid()
    res = run("section7", rows, {n: r.graph.replay_ms() / STEPS for n, r in section7.items()})
    check(len(out["calls"]["section7"]["buckets"]) == 5, "section7_grid did not take 5 buckets")
    for row in rows:
        lanes_equal(res[row.name], section7[row.name], row.name)

    # Fig. 4, Fig. 6 and quant:4 on the trajectory phase's problem and records
    problem, records, done = trajectory["problem"], trajectory["records"], trajectory["results"]

    def provider(scn):
        recs = records.get(scn.name)
        return None if recs is None else (lambda t: recs[t])

    for name, rows, exact in (("fig4", list(S.PAPER_FIG4.values()), True),
                              ("fig6", list(S.PAPER_FIG6.values()), False),
                              ("quant4", trajectory["quant_rows"], False)):
        res = run(name, rows, problem=problem, exact=exact, randomness=provider)
        for row in rows:
            lanes_equal(res[row.name], done[row.name], row.name)
    check(len(out["calls"]["fig6"]["buckets"]) == 2, "PAPER_FIG6 did not take 2 buckets under exact=False")

    # the participation sweep, against standalone graph-mode runs
    rows = S.participation_sweep()
    alone = {r.name: S.run_scenario(r, STEPS, seed=0, dim=PART_DIM, device="cuda", mode="graph") for r in rows}
    res = run("participation", rows, {n: r.graph.replay_ms() / STEPS for n, r in alone.items()}, dim=PART_DIM,
              exact=False)
    for row in rows:
        lanes_equal(res[row.name], alone[row.name], row.name)

    # the 1000-lane sweeps
    def sweep(name, rows, dim, picks, **kw):
        res = run(name, rows, dim=dim, **kw)
        info = out["calls"][name]
        info["lanes_rounds_per_s_call"] = len(rows) * STEPS / (info["call_ms"] / 1e3)
        info["lanes_rounds_per_s_replays"] = len(rows) * STEPS / (
            sum(b["replay_ms_per_round"] for b in info["buckets"]) * STEPS / 1e3)
        for i in picks:
            lanes_equal(res[rows[i].name], S.run_scenario(rows[i], STEPS, seed=0, dim=dim, device="cuda",
                                                          mode="graph"), rows[i].name)
        info["lanes_checked_against_standalone"] = sorted(picks)
        return res

    rows = S.synthetic_sweep(1000, n_devices=16, n_byz=3)
    attacks = list(dict.fromkeys(r.attack for r in rows))
    order = sorted(range(len(rows)), key=lambda i: attacks.index(rows[i].attack))  # the lanes' sorted order
    last = (len(rows) // SWEEP_CHUNK) * SWEEP_CHUNK  # the padded last chunk starts here
    picks = {0, len(rows) - 1, order[SWEEP_CHUNK - 1], order[SWEEP_CHUNK], order[last - 1], order[last]}
    picks |= {next(i for i, r in enumerate(rows) if r.attack == a) for a in attacks}
    check(len(picks) == 8, f"sweep lanes picked: {sorted(picks)}")
    whole = sweep("sweep1000_n16", rows, PART_DIM, picks)
    chunked = sweep("sweep1000_n16_chunked", rows, PART_DIM, (), max_lanes_per_device=SWEEP_CHUNK)
    check(out["calls"]["sweep1000_n16_chunked"]["buckets"][0]["chunks"] == -(-len(rows) // SWEEP_CHUNK),
          "the chunked sweep did not take 16 chunks")
    for row in rows:
        lanes_equal(chunked[row.name], whole[row.name], f"{row.name} chunked")
    del whole, chunked
    rows = S.synthetic_sweep(1000, n_devices=100, n_byz=20)
    sweep("sweep1000_n100", rows, 100, {0, len(rows) // 2, len(rows) - 1})
    out["bitwise"] = True
    return out


# ------------------------------------------------------------- participation

PART_N, PART_D, PART_DIM, PART_STEPS = 16, 4, 32, 400
DECODE_SPREAD_MAX = 1e-4  # benchmarks/paper_figures.py::participation_bench's bound


def participation_phase(S) -> dict:
    """The K-of-N erasure sweep of ``participation_bench``: N=16, d=4,
    dim=32, lr 1e-5, no attack, the ``adversarial`` schedule erasing the same
    e = 0..3 rows every round (the margin d - 1 = 3), the erasure decode
    against the mean of the reporting rows, 400 rounds, one run per row
    through ``run_scenario``."""
    rows = [S.Scenario(name=f"e{e}/{agg}", method="lad", d=PART_D, aggregator=agg, attack="none", n_byz=0,
                       n_devices=PART_N, lr=1e-5, sigma_h=0.3, participation="adversarial", p_drop_n=e)
            for e in range(PART_D) for agg in ("decode", "mean")]
    final, ms_per_round = {}, {}
    for scn in rows:
        torch.cuda.synchronize()
        start = time.perf_counter()
        res = S.run_scenario(scn, PART_STEPS, seed=0, dim=PART_DIM, device="cuda")
        torch.cuda.synchronize()
        ms_per_round[scn.name] = (time.perf_counter() - start) * 1e3 / PART_STEPS
        loss = res.metrics["loss"]
        check(loss.shape == (PART_STEPS,) and bool(torch.isfinite(loss).all()), f"{scn.name}: bad loss")
        check(bool((res.metrics["n_report"] == PART_N - scn.p_drop_n).all()),
              f"{scn.name}: not N - e reports every round")
        final[scn.name] = float(loss[-1])

    def spread(agg):
        vals = [final[f"e{e}/{agg}"] for e in range(PART_D)]
        return (max(vals) - min(vals)) / max(vals)

    decode, mean = spread("decode"), spread("mean")
    check(decode <= DECODE_SPREAD_MAX, f"decode final loss moves with erasures: spread {decode}")
    check(mean >= decode, f"mean spread {mean} below the decode's {decode}")
    return {"phase": "participation", "n_devices": PART_N, "d": PART_D, "dim": PART_DIM, "rounds": PART_STEPS,
            "final_loss": final, "ms_per_round": ms_per_round, "decode_rel_spread": decode,
            "mean_rel_spread": mean, "decode_spread_max": DECODE_SPREAD_MAX}


# ------------------------------------------------------------------------ lm

LM_STEPS = 100
LM_KERNELS = ("gather_combine", "attack", "cwtm")  # what lm_sweep's rows reach (lad-d2 encodes, CWTM server)
LM_RTOL = 2e-6  # LM card against CPU: tests/test_torch_lm.py's tolerance of the port against the reference


def lm_phase(S, byz, replayed: dict[str, int]) -> dict:
    """``lm_sweep()``'s 12 rows on ``lm_arch()`` (N=10, 2 Byzantine, 4
    buckets), 100 rounds each:

      * every row alone in graph mode (``run_lm_scenario``), then all rows
        through ``run_lm_grid`` in graph mode, every lane held bit for bit
        to its row's standalone run;
      * the first row in loop mode, bit for bit against its graph mode;
      * one row (ALIE, no compression) on the card and on the CPU from the
        same records (drawn on the CPU), loss, ``agg_dist`` and
        ``grad_norm`` within relative ``LM_RTOL`` every round.

    Per row the standalone replay ms a round; per bucket its lanes, captured
    launches and replay ms a round. Adds the replays' launches to
    ``replayed``."""
    rows = S.lm_sweep()
    out = {"phase": "lm", "rows": len(rows), "rounds": LM_STEPS, "mode": "graph", "n_devices": rows[0].n_devices,
           "n_byz": rows[0].n_byz, "arch": dataclasses.asdict(S.lm_arch())}
    alone, replay_ms = {}, {}
    for row in rows:
        res = S.run_lm_scenario(row, LM_STEPS, seed=0, device="cuda", mode="graph")
        check(res.graph.replays == LM_STEPS, f"{row.name}: {res.graph.replays} replays")
        loss = res.metrics["loss"]
        check(loss.shape == (LM_STEPS,) and bool(torch.isfinite(loss).all()), f"{row.name}: bad loss")
        replay_ms[row.name] = res.graph.replay_ms() / LM_STEPS
        for k, v in res.graph.captured_launches.items():
            replayed[k] += v * res.graph.replays
        alone[row.name] = res
    out["standalone_replay_ms_per_round"] = replay_ms
    out["final_loss"] = {n: float(r.metrics["loss"][-1]) for n, r in alone.items()}
    out["initial_loss"] = {n: float(r.metrics["loss"][0]) for n, r in alone.items()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    grid = S.run_lm_grid(rows, LM_STEPS, seed=0, device="cuda", mode="graph")
    torch.cuda.synchronize()
    out["grid_call_ms"] = (time.perf_counter() - start) * 1e3
    out["grid_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    buckets = {}
    for row in rows:
        stats = grid[row.name].grid
        buckets.setdefault(id(stats), (stats, []))[1].append(row.name)
    lines = []
    for stats, names in buckets.values():
        check(all(g.replays == LM_STEPS for g in stats.graphs), "lm grid: a chunk was not replayed")
        for g in stats.graphs:
            for k, v in g.captured_launches.items():
                replayed[k] += v * g.replays
        lines.append({"first_row": names[0], "lanes": stats.lanes, "replay_ms_per_round": stats.replay_ms() / LM_STEPS,
                      "standalone_replay_ms_per_round_sum": sum(replay_ms[n] for n in names),
                      "captured_launches_per_round": {k: v for k, v in stats.captured_launches().items() if v}})
    check(len(lines) == 4, f"lm_sweep took {len(lines)} buckets, not 4")
    for row in rows:
        lanes_equal(grid[row.name], alone[row.name], row.name)
    out["buckets"] = lines
    out["lanes_bitwise_standalone"] = True

    first = rows[0]
    torch.cuda.synchronize()
    start = time.perf_counter()
    loop = S.run_lm_scenario(first, LM_STEPS, seed=0, device="cuda", mode="loop")
    torch.cuda.synchronize()
    out["loop_ms_per_round"] = {first.name: (time.perf_counter() - start) * 1e3 / LM_STEPS}
    check(same_bits(loop, alone[first.name]), f"{first.name}: LM loop mode differs from graph mode")
    out["loop_bitwise_graph"] = first.name

    row = next(r for r in rows if r.attack == "alie" and r.compressor == "none" and r.method == "lad")
    cpu_gen = torch.Generator().manual_seed(1)
    p = S._lm_fns(S.lm_arch()).x0.numel()
    recs = [byz.sample_round_randomness(row.protocol(), p, cpu_gen) for _ in range(LM_STEPS)]
    card = S.run_lm_scenario(row, LM_STEPS, seed=0, randomness=lambda t: recs[t], device="cuda")
    cpu = S.run_lm_scenario(row, LM_STEPS, seed=0, randomness=lambda t: recs[t], device="cpu")
    rel = {}
    for k in ("loss", "agg_dist", "grad_norm"):
        want = cpu.metrics[k]
        rel[k] = float(((card.metrics[k].cpu() - want).abs() / want.abs()).max())
        check(rel[k] <= LM_RTOL, f"{row.name} card vs CPU {k}: rel {rel[k]} > {LM_RTOL}")
    out["card_vs_cpu"] = {"row": row.name, "max_rel": rel, "tolerance": LM_RTOL}
    return out


LM_WIDE_ROUNDS = 3
LM_WIDE_PEAK_GB = 60.0  # reckoned 45 to 52 GB: the (8, P) stacks of the round, the iterates' rows; the card has 80
SUBSET_GRAD_RTOL = 1e-4  # a leaf's vmapped gradient against a plain backward, relative to the leaf's max


def lm_wide_phase(S, byz, models, coding, pytree, archs) -> dict:
    """``run_lm_scenario`` at smollm-360m's published widths and depth (32
    layers, d_model 960, 15/5 heads of 64, d_ff 2560, vocab 49152, tied; P
    = 361,821,120), N=8, 2 Byzantine, LAD d=2 with CWTM (trim 2 a side)
    under ALIE, 2 rows of 16 tokens a subset, 3 rounds in loop mode after
    one untimed warm-up round: ``wide_lm_run``."""
    return {"phase": "lm_wide", **wide_lm_run(S, byz, models, coding, pytree, archs.ARCHS["smollm-360m"], WIDE_Q,
                                              per_subset=2, peak_gb_max=LM_WIDE_PEAK_GB)}


def wide_lm_run(S, byz, models, coding, pytree, arch, params: int, *, per_subset: int, peak_gb_max: float,
                float64_anchor: bool = False) -> dict:
    """``run_lm_scenario`` of ``arch`` (``params`` parameters), N=8, 2
    Byzantine, LAD d=2 with CWTM (trim 2 a side) under ALIE, ``per_subset``
    rows of 16 tokens a subset, 3 rounds in loop mode after one untimed
    warm-up round. Per round the subset gradients' ms and each stage's
    (CUDA events at ``run_trajectory``'s stage marks) and the peak memory;
    the losses must be finite. Then, on the gradients at the initial
    parameters: their ms and the host's enqueue ms; one round's aggregate
    through the kernels against the same round through the plain versions
    (on the CPU, over the first and the last 2^22 columns; every stage works
    column by column) within rtol 1e-5, atol 1e-6; and subset 0's vmapped
    gradient against a plain ``backward()`` on its rows, each leaf within
    ``SUBSET_GRAD_RTOL`` of the leaf's largest magnitude. Where an MoE arch
    misses that, the plain backward is taken again on the vmapped
    forward's expert and token picks (the two forwards can route a token
    differently at a near-tie of a cut, which every differing pick must
    be, within ``MOE_TIE_TOL``) and held to ``SUBSET_GRAD_RTOL``. Where
    another arch misses it with ``float64_anchor`` (a leaf that float32
    cannot resolve), both evaluations are taken again in float64 on the
    card (``models.precision.float64``; the vmapped one over subsets 0 and
    1), which must agree within ``FLOAT64_RTOL``, and the float32 vmapped
    gradient's largest leaf error from the float64 one may be at most
    ``ANCHOR_FACTOR`` times the float32 plain backward's."""
    row = S.Scenario(name=f"{arch.name}/lad-d2/cwtm/alie", method="lad", d=2, aggregator="cwtm", attack="alie",
                     n_byz=2, n_devices=WIDE_N, trim_frac=0.25, sigma_h=0.5, lr=3e-3)
    start = time.perf_counter()
    x0, spec, subset_grads, _ = S._lm_fns(arch)
    init_s = time.perf_counter() - start
    check(x0.numel() == params, f"{arch.name} has {x0.numel()} parameters, not {params}")
    kw = dict(arch=arch, seed=0, per_subset=per_subset, seq_len=16, device="cuda")
    warm = S.run_lm_scenario(row, 1, **kw)
    check(bool(torch.isfinite(warm.metrics["loss"]).all()), f"{arch.name}: warm-up loss not finite")
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = []

    def hook(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((stage, ev))

    start = time.perf_counter()
    res = S.run_lm_scenario(row, LM_WIDE_ROUNDS, stage_hook=hook, **kw)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - start) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rounds = []
    for i, (stage, ev) in enumerate(marks):
        if stage == "round":
            rounds.append({})
        else:
            rounds[-1][stage] = marks[i - 1][1].elapsed_time(ev)
    check(len(rounds) == LM_WIDE_ROUNDS, f"{arch.name}: {len(rounds)} rounds marked")
    loss = res.metrics["loss"]
    check(loss.shape == (LM_WIDE_ROUNDS,) and bool(torch.isfinite(loss).all()), f"{arch.name}: bad loss")
    check(peak_gb < peak_gb_max, f"{arch.name}: peak {peak_gb:.1f} GB >= {peak_gb_max}")
    out = {"arch": arch.name, "params": params, "n_devices": WIDE_N, "d": 2, "n_byz": 2,
           "aggregator": "cwtm", "trim_frac": 0.25, "attack": "alie", "per_subset": per_subset, "seq_len": 16,
           "rounds": LM_WIDE_ROUNDS, "init_s": init_s, "call_ms": call_ms, "stage_ms_per_round": rounds,
           "peak_gb": peak_gb, "peak_gb_max": peak_gb_max, "loss": loss.tolist(),
           "grad_norm": res.metrics["grad_norm"].tolist(), "agg_dist": res.metrics["agg_dist"].tolist()}
    del res

    # the gradients at x0, one round through the kernels and through the plain versions
    data = S._lm_problem(arch, seed=0, n_subsets=WIDE_N, sigma_h=row.sigma_h, per_subset=per_subset, seq_len=16,
                         device=torch.device("cuda"))
    x = x0.to("cuda")
    grads = subset_grads(data, x)  # once untimed: its allocations
    del grads
    torch.cuda.synchronize()
    start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start_ev.record()
    start = time.perf_counter()
    grads = subset_grads(data, x)
    enqueue_ms = (time.perf_counter() - start) * 1e3  # the host's time to enqueue, no sync inside
    end_ev.record()
    end_ev.synchronize()
    # the card cannot finish before the host has enqueued: equal times mean the host bounds it
    out["subset_grads"] = {"ms": start_ev.elapsed_time(end_ev), "host_enqueue_ms": enqueue_ms}
    cfg = row.protocol()
    rand = byz.sample_round_randomness(cfg, params, torch.Generator(device="cuda").manual_seed(3))
    g = byz.protocol_round(cfg, grads, rand, device="cuda")
    cols = 1 << 22
    err = 0.0
    for sl in (slice(0, cols), slice(params - cols, params)):
        want = byz.protocol_round(cfg, grads[:, sl].cpu(), rand.to("cpu"), device="cpu")
        got = g[sl].cpu()
        check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
              f"{arch.name}: kernel route differs from the plain route")
        err = max(err, float((got - want).abs().max()))
    out["kernel_vs_plain_round"] = {"columns": [[0, cols], [params - cols, params]], "max_abs_err": err,
                                    "rtol": RTOL, "atol": ATOL}
    del g

    # subset 0: a plain backward() on its rows, against its row of the vmapped stack
    rows0 = dict(zip(S._DATA_KEYS, (d[0] for d in data)))
    plain = plain_backward(models, coding, pytree, arch, x, spec, rows0)
    paths = [path for path, _ in pytree.paths(coding.unflatten_pytree(plain, spec))]
    worst, leaf = leaf_error(pytree, coding, spec, grads[0], plain, paths)
    line = {"subset": 0, "max_err_over_leaf_max": worst, "worst_leaf": leaf, "tolerance": SUBSET_GRAD_RTOL,
            "rel_l2": float((grads[0] - plain).norm() / plain.norm())}
    out["vmapped_vs_plain_backward"] = line
    if worst > SUBSET_GRAD_RTOL and any(b.mlp == "moe" for b in arch.period):
        # the two forwards may route a token differently at a near-tie: the plain
        # backward again on the vmapped forward's routes
        routes = moe_routes(S, models, arch, coding.unflatten_pytree(x, spec), data, vmapped=True)
        flip = moe_flip(S, models, arch, coding.unflatten_pytree(x, spec), data, routes)
        pinned = plain_backward(models, coding, pytree, arch, x, spec, rows0, routes=routes)
        worst, leaf = leaf_error(pytree, coding, spec, grads[0], pinned, paths)
        line["routes_pinned"] = {"max_err_over_leaf_max": worst, "worst_leaf": leaf,
                                 "rel_l2": float((grads[0] - pinned).norm() / pinned.norm()), "routing_flip": flip}
        check(flip is None or flip["max_distance_to_cut"] <= MOE_TIE_TOL,
              f"{arch.name}: MoE routes differ away from a tie ({flip})")
        check(worst <= SUBSET_GRAD_RTOL,
              f"{arch.name}: vmapped gradient off a route-pinned plain backward by {worst} of a leaf's max ({leaf})")
    elif worst > SUBSET_GRAD_RTOL and float64_anchor:
        # an ill-conditioned leaf: the same two evaluations in float64 on the card (the vmapped one over
        # subsets 0 and 1), which must agree; and the float32 vmapped gradient held to float64
        # the arch's float32 (and so its params' dtype) computes in float64 inside the block; the frontend,
        # which the model rounds to the arch's dtype first, is rounded so and then widened
        arch64 = dataclasses.replace(arch, param_dtype="float32")
        widened = tuple(d.to(arch.dtype).double() if d.is_floating_point() else d for d in data)
        subset_grads64 = S._lm_fns(arch64).subset_grad_fn
        with models.precision.float64():
            plain64 = plain_backward(models, coding, pytree, arch64, x.double(), spec,
                                     dict(zip(S._DATA_KEYS, (d[0] for d in widened))))
            vmapped64 = subset_grads64(tuple(d[:2] for d in widened), x.double())[0]
        agree, aleaf = leaf_error(pytree, coding, spec, vmapped64, plain64, paths)
        del vmapped64
        vmapped, vleaf = leaf_error(pytree, coding, spec, grads[0].double(), plain64, paths)
        single, sleaf = leaf_error(pytree, coding, spec, plain.double(), plain64, paths)
        line["float64"] = {"vmapped_vs_plain_err_over_leaf_max": agree, "worst_leaf": aleaf,
                           "tolerance": models.precision.FLOAT64_RTOL, "vmapped32_err_over_leaf_max": vmapped,
                           "vmapped32_worst_leaf": vleaf, "plain32_err_over_leaf_max": single,
                           "plain32_worst_leaf": sleaf, "factor": ANCHOR_FACTOR}
        check(agree <= models.precision.FLOAT64_RTOL,
              f"{arch.name}: float64 vmapped gradient off a float64 plain backward by {agree} ({aleaf})")
        check(vmapped <= ANCHOR_FACTOR * single,
              f"{arch.name}: vmapped gradient {vmapped} off float64 against a plain backward's {single}")
    else:
        check(worst <= SUBSET_GRAD_RTOL,
              f"{arch.name}: vmapped gradient off a plain backward by {worst} of a leaf's max ({leaf})")
    return out


def plain_backward(models, coding, pytree, arch, x, spec, rows, routes=None) -> torch.Tensor:
    """The flat gradient of the loss on ``rows`` (one subset's batch) at
    ``x`` by a plain ``backward()``; with ``routes`` (``moe_routes``'),
    every MoE block takes those expert and token picks instead of its own,
    its combine weights from its own probabilities at those experts."""
    tree = pytree.map_tree(lambda a: a.detach().clone().requires_grad_(True), coding.unflatten_pytree(x, spec))
    real, queue = models.moe._route, list(routes or ())

    def pinned(params, xb, top_k, capacity_factor):
        probs = real(params, xb, top_k, capacity_factor)[0]
        _, chosen, token_idx = queue.pop(0)
        return probs, chosen, models.moe._combine_weights(probs, chosen), token_idx

    if routes is not None:
        models.moe._route = pinned
    try:
        models.loss_fn(tree, None, arch, rows)[0].backward()
    finally:
        models.moe._route = real
    check(not queue, f"{arch.name}: {len(queue)} pinned routes left unused")
    return coding.flatten_pytree(pytree.map_tree(lambda a: a.grad, tree))[0]


ANCHOR_FACTOR = 2.0  # float32 from float64 at an ill-conditioned leaf: the vmapped gradient within this times the plain
MOE_TIE_TOL = 1e-6  # a routing pick that differs: its value this close to the cut (the card's fp32 noise there: 1.6e-7)


def moe_routes(S, models, arch, tree, data, vmapped: bool) -> list[tuple[torch.Tensor, ...]]:
    """Subset 0's routing in every MoE block of one forward pass: the
    probabilities ``(1, T, E)``, each token's chosen experts one-hot ``(1,
    T, k, E)`` and each expert's tokens ``(1, E, C)``, from the vmapped
    forward over all subsets (as the engine's gradients run it) or from a
    plain forward of subset 0's rows."""
    real, routes = models.moe._route, []

    def route(params, xb, top_k, capacity_factor):
        out = real(params, xb, top_k, capacity_factor)
        routes.extend((out[0], out[1], out[3]))
        return out

    def forward(p, *d):
        routes.clear()
        models.loss_fn(p, None, arch, dict(zip(S._DATA_KEYS, d)))
        return tuple(routes)

    models.moe._route = route
    try:
        with torch.no_grad():
            if vmapped:
                flat = [t[0] for t in torch.func.vmap(forward, in_dims=(None,) + (0,) * len(data))(
                    models.transformer.unstack_periods(tree), *data)]
            else:
                flat = list(forward(tree, *(d[0] for d in data)))
    finally:
        models.moe._route = real
    return list(zip(flat[0::3], flat[1::3], flat[2::3]))


def moe_flip(S, models, arch, tree, data, vmapped_routes) -> dict | None:
    """Where the vmapped forward (``vmapped_routes``) and the plain forward
    of subset 0 route a token differently: the first MoE block that
    differs, its differing picks, and the largest distance of a differing
    pick's value (the plain forward's) from its cut (the top-k-th
    probability of its token, or the C-th gate weight of its expert);
    ``None`` if every block routes alike. Past that block the inputs
    differ, so later blocks are not compared."""
    for block, ((vp, _, vt), (pp, _, pt)) in enumerate(zip(vmapped_routes,
                                                            moe_routes(S, models, arch, tree, data, False))):
        vp, vt, pp, pt = vp[0], vt[0], pp[0], pt[0]
        k, cap = arch.moe.top_k, pt.shape[-1]
        picked = lambda probs: torch.zeros_like(probs, dtype=torch.bool).scatter_(
            -1, torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k], True)
        vchosen, pchosen = picked(vp), picked(pp)
        experts = vchosen != pchosen  # (T, E)
        tokens = [set(vt[e].tolist()) ^ set(pt[e].tolist()) for e in range(pt.shape[0])]
        if not bool(experts.any()) and not any(tokens):
            continue
        kth = torch.sort(pp, dim=-1, descending=True).values[:, k - 1:k]  # (T, 1)
        gaps = [float((pp[experts] - kth.expand_as(pp)[experts]).abs().max())] if bool(experts.any()) else []
        combine = pp * pchosen / (pp * pchosen).sum(-1, keepdim=True)  # the plain forward's gate weights (T, E)
        for e, diff in enumerate(tokens):
            if diff:
                cut = torch.sort(combine[:, e], descending=True).values[cap - 1]
                gaps.append(max(abs(float(combine[t, e] - cut)) for t in diff))
        return {"block": block, "expert_picks_differ": int(experts.sum()),
                "tokens_in_differing_expert_picks": sum(len(d) for d in tokens), "max_distance_to_cut": max(gaps),
                "tolerance": MOE_TIE_TOL}
    return None


def leaf_error(pytree, coding, spec, got, want, paths) -> tuple[float, str]:
    """The largest ``max|got - want| / max|want|`` over the leaves of two
    flat gradients, and its leaf's path."""
    worst, leaf = 0.0, ""
    for path, w, g in zip(paths, pytree.leaves(coding.unflatten_pytree(want, spec)),
                          pytree.leaves(coding.unflatten_pytree(got, spec))):
        err = float((g - w).abs().max() / w.abs().max())
        if err > worst:
            worst, leaf = err, path
    return worst, leaf


# ----------------------------------------------------------------------- zoo

ZOO_STEPS = 50


def device_kernels(fn) -> int | None:
    """The CUDA kernels ``fn`` launches, as ``torch.profiler`` sees them
    (memory copies and sets not counted); ``None`` if it sees none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset")))
    return n or None


def token_loop_kernels(models, pytree, S) -> dict:
    """Kernels a token adds to one forward and backward of the Mamba and
    the RWKV time mix (the zoo's jamba and rwkv widths, 2 rows): the
    profiled count at 32 tokens less the count at 16, over 16."""
    out = {}
    for fam, kind, fn in (("jamba", "mamba", lambda p, x, a: models.mamba.mamba(p, x, a.mamba.d_state)),
                          ("rwkv", "rwkv", lambda p, x, a: models.rwkv.rwkv_time_mix(p, x, a.rwkv.head_dim))):
        arch = S.zoo_arch(fam)
        params, _ = models.init(torch.Generator(device="cuda").manual_seed(0), arch)
        i = next(i for i, b in enumerate(arch.period) if b.mixer == kind)
        mixer = pytree.map_tree(lambda a: a[0].detach().requires_grad_(True), params["periods"][f"blk{i}"]["mixer"])
        counts = {}
        for s in (16, 32):
            x = torch.randn((2, s, arch.d_model), device="cuda", requires_grad=True)
            fn(mixer, x, arch).sum().backward()  # warm-up
            counts[s] = device_kernels(lambda: fn(mixer, x, arch).sum().backward())
        out[kind] = None if None in counts.values() else (counts[32] - counts[16]) / 16
    return out


def zoo_phase(S, byz, models, pytree, replayed: dict[str, int]) -> dict:
    """``run_zoo_sweep()`` over the seven ``ZOO_FAMILIES`` (each family's
    LAD-d2 and plain rows, N=8, 2 Byzantine, CWTM under sign-flip) on their
    ``zoo_arch``, 50 rounds in graph mode, and per family:

      * every lane bit for bit its row's standalone graph-mode
        ``run_lm_scenario``;
      * the LAD row in loop mode bit for bit its graph mode;
      * the LAD row on the card and on the CPU from the same records (drawn
        on the CPU): the loss curves within relative ``LM_RTOL`` every
        round. Where they part (RWKV, ``precision.PARTING_FAMILIES``), every
        round up to the parting round is held on the CPU's iterate: the
        card's subset gradients against the CPU's, each row within
        ``GRAD_ROW_RTOL`` of its norm, or, at a round where they differ
        more (an ill-conditioned gradient, ``models.precision``), the same
        gradients in float64 on the card and on the CPU within
        ``FLOAT64_RTOL`` of each other and each float32 evaluation within
        ``ILL_ROW_BOUND`` of the CPU's float64 one; the first such round
        no later than the parting round.

    Per family the replay ms a round of each row alone and of each bucket,
    each kernel's launches in the captured round, and the kernels of one
    subset-gradient call as ``torch.profiler`` counts them; and the kernels
    a token adds to the Mamba and RWKV loops. Adds the replays' launches
    to ``replayed``."""
    sweep = S.zoo_sweep()
    torch.cuda.synchronize()
    start = time.perf_counter()
    grid = S.run_zoo_sweep(ZOO_STEPS, sweep=sweep, seed=0, device="cuda", mode="graph")
    torch.cuda.synchronize()
    out = {"phase": "zoo", "rounds": ZOO_STEPS, "mode": "graph", "n_devices": 8, "n_byz": 2,
           "sweep_call_s": time.perf_counter() - start, "families": {}}
    for fam, rows in sweep.items():
        arch = S.zoo_arch(fam)
        x0, _, subset_grads, _ = S._lm_fns(arch)
        line = {"arch": arch.name, "params": x0.numel(), "rows": {}, "buckets": []}
        alone = {}
        for row in rows:
            res = S.run_lm_scenario(row, ZOO_STEPS, arch=arch, seed=0, device="cuda", mode="graph")
            loss = res.metrics["loss"]
            check(res.graph.replays == ZOO_STEPS and bool(torch.isfinite(loss).all()), f"{row.name}: bad run")
            for k, v in res.graph.captured_launches.items():
                replayed[k] += v * res.graph.replays
            lanes_equal(grid[fam][row.name], res, row.name)
            alone[row.name] = res
            line["rows"][row.name] = {
                "replay_ms_per_round": res.graph.replay_ms() / ZOO_STEPS, "final_loss": float(loss[-1]),
                "initial_loss": float(loss[0]),
                "captured_launches_per_round": {k: v for k, v in res.graph.captured_launches.items() if v}}
        seen = set()
        for row in rows:
            stats = grid[fam][row.name].grid
            if id(stats) in seen:
                continue
            seen.add(id(stats))
            for g in stats.graphs:
                for k, v in g.captured_launches.items():
                    replayed[k] += v * g.replays
            line["buckets"].append({"first_row": row.name, "lanes": stats.lanes,
                                    "replay_ms_per_round": stats.replay_ms() / ZOO_STEPS})
        line["lanes_bitwise_standalone"] = True

        lad = rows[0]
        torch.cuda.synchronize()
        start = time.perf_counter()
        loop = S.run_lm_scenario(lad, ZOO_STEPS, arch=arch, seed=0, device="cuda", mode="loop")
        torch.cuda.synchronize()
        line["loop_ms_per_round"] = (time.perf_counter() - start) * 1e3 / ZOO_STEPS
        check(same_bits(loop, alone[lad.name]), f"{lad.name}: loop mode differs from graph mode")
        line["loop_bitwise_graph"] = lad.name
        line["card_vs_cpu"] = zoo_card_vs_cpu(S, byz, models, fam, lad, arch)

        data = S._lm_problem(arch, seed=0, n_subsets=lad.n_devices, sigma_h=lad.sigma_h, per_subset=2, seq_len=16,
                             device=torch.device("cuda"))
        x = x0.to("cuda")
        subset_grads(data, x)
        line["subset_grad_kernels"] = device_kernels(lambda: subset_grads(data, x))
        out["families"][fam] = line
    out["token_loop_kernels_per_token"] = token_loop_kernels(models, pytree, S)
    return out


def zoo_card_vs_cpu(S, byz, models, fam: str, row, arch) -> dict:
    """The row on the card and on the CPU from the same records; see
    ``zoo_phase``."""
    x0 = S._lm_fns(arch).x0
    cpu_gen = torch.Generator().manual_seed(1)
    recs = [byz.sample_round_randomness(row.protocol(), x0.numel(), cpu_gen) for _ in range(ZOO_STEPS)]
    fns = S._lm_fns(arch)
    xs = []

    def recording(d, x):
        xs.append(x.clone())
        return fns.subset_grad_fn(d, x)

    card = S.run_lm_scenario(row, ZOO_STEPS, arch=arch, seed=0, randomness=lambda t: recs[t], device="cuda")
    real = S._lm_fns
    S._lm_fns = lambda a: fns._replace(subset_grad_fn=recording) if a is arch else real(a)
    try:
        cpu = S.run_lm_scenario(row, ZOO_STEPS, arch=arch, seed=0, randomness=lambda t: recs[t], device="cpu")
    finally:
        S._lm_fns = real
    want = cpu.metrics["loss"]
    rel = ((card.metrics["loss"].cpu() - want).abs() / want.abs())
    out = {"row": row.name, "max_rel_loss": float(rel.max()), "tolerance": LM_RTOL}
    if bool((rel <= LM_RTOL).all()):
        return out
    parted = int(torch.nonzero(rel > LM_RTOL)[0])
    check(fam in models.precision.PARTING_FAMILIES, f"{row.name}: card and CPU loss curves part at round {parted}")
    out["parted_at_round"] = parted
    out["max_rel_loss_before"] = float(rel[:parted].max()) if parted else 0.0
    data_cpu = S._lm_problem(arch, seed=0, n_subsets=row.n_devices, sigma_h=row.sigma_h, per_subset=2, seq_len=16,
                             device=torch.device("cpu"))
    data_card = tuple(d.to("cuda") for d in data_cpu)
    row_error, ill = models.precision.row_error, []
    for t in range(parted + 1):  # the loss of round t is at the iterate after its step
        want_g = fns.subset_grad_fn(data_cpu, xs[t])
        got_g = fns.subset_grad_fn(data_card, xs[t].to("cuda")).cpu()
        err = row_error(got_g, want_g)
        if err > models.precision.GRAD_ROW_RTOL:
            with models.precision.float64():
                exact = fns.subset_grad_fn(data_cpu, xs[t].double())
                card64 = fns.subset_grad_fn(data_card, xs[t].to("cuda").double()).cpu()
            agree, cpu_err, card_err = row_error(card64, exact), row_error(want_g, exact), row_error(got_g, exact)
            check(agree <= models.precision.FLOAT64_RTOL, f"{row.name} round {t}: float64 card {agree} off float64 CPU")
            bound = models.precision.ILL_ROW_BOUND
            check(max(card_err, cpu_err) <= bound,
                  f"{row.name} round {t}: card {card_err}, CPU {cpu_err} off float64 (bound {bound})")
            ill.append({"round": t, "card_vs_cpu": err, "float64_card_vs_cpu": agree, "card_vs_float64": card_err,
                        "cpu_vs_float64": cpu_err})
    check(bool(ill), f"{row.name}: the curves part at round {parted} with no ill-conditioned round before it")
    out["ill_conditioned_rounds"] = ill
    return out


ZOO_WIDE = (  # (arch, cut, parameters, rows of 16 tokens a subset)
    ("whisper-small", {}, 335_106_048, 1),
    ("granite-moe-3b-a800m", {"n_layers": 2}, 352_461_312, 2),
    ("rwkv6-1.6b", {"n_layers": 2}, 378_062_848, 2),
)
ZOO_WIDE_PEAK_GB = 70.0  # reckoned 45 to 60 GB (PERF.md §6); the card has 80


def zoo_wide_phase(S, byz, models, coding, pytree, archs) -> dict:
    """``wide_lm_run`` (as ``lm_wide``) for three configurations at their
    published widths, in fp32: whisper-small whole (12 encoder layers over
    1500 frames of 768, 12 decoder periods of self- and cross-attention,
    d_model 768, 12 heads of 64, d_ff 3072, vocab 51865, untied; 1 row a
    subset), and granite-moe-3b-a800m (d_model 1536, 24/8 heads of 64, 40
    experts top-8 of d_ff 512, vocab 49155) and rwkv6-1.6b (d_model 2048,
    wkv heads of 64, decay LoRA 64, d_ff 7168, vocab 65536) cut from 32 and
    24 layers to 2 (2 rows a subset). A subset's vmapped gradient that is
    off its plain backward by more than ``SUBSET_GRAD_RTOL`` of a leaf's
    largest value is held to a float64 backward (whisper's 1500-frame
    attention gradients are ill-conditioned in float32; PERF.md §6). Each
    configuration's problem is released before the next."""
    out = {"phase": "zoo_wide", "configs": {}}
    for name, cut, params, rows in ZOO_WIDE:
        arch = archs.ARCHS[name].scaled(**cut)
        out["configs"][name] = {"cut": cut, **wide_lm_run(S, byz, models, coding, pytree, arch, params,
                                                           per_subset=rows, peak_gb_max=ZOO_WIDE_PEAK_GB,
                                                           float64_anchor=True)}
        S._lm_fns.cache_clear()
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- train

TRAIN_STEPS = 4
TRAIN_RTOL = 2e-6  # the step's loss, card against CPU: tests/test_torch_train.py's standard against the reference


def train_tcfg(T, arch, **kw):
    """tests/test_train_engine_shard.py's ``_tcfg`` at N=10: LAD d=2, CWTM
    trim 0.2, 2 sign-flipping devices, AdamW (lr 3e-3, a 4-step schedule)."""
    base = dict(arch=arch.name, protocol="lad", protocol_impl="engine", n_subsets=10, d=2, aggregator="cwtm",
                trim_frac=0.2, n_byz=2, attack="sign_flip", optimizer="adamw", lr=3e-3, steps=TRAIN_STEPS)
    base.update(kw)
    return T.TrainConfig(**base)


def train_batches(synthetic, arch, n: int, rows: int, steps: int, seq_len: int = 16, seed: int = 42):
    """``steps`` batches of ``n`` subsets of ``rows`` rows each, ``(n * rows,
    seq_len)`` tokens and labels, from CPU generators seeded ``(seed, i)``."""
    out = []
    for i in range(steps):
        b = synthetic.lm_batch_for_devices(torch.Generator().manual_seed(seed * 1000 + i), arch.vocab, n_subsets=n,
                                           per_subset=rows, seq_len=seq_len, sigma_h=0.5)
        out.append({k: v.reshape(-1, seq_len) for k, v in b.items()})
    return out


def tree_equal(a, b, pytree) -> bool:
    """Two trees (optimizer states included) agree in paths, dtypes and bits."""
    pa, pb = list(pytree.paths(a)), list(pytree.paths(b))
    return [k for k, _ in pa] == [k for k, _ in pb] and all(
        x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y) in zip(pa, pb))


def drive(step, params, state, batches, start: int = 0):
    """``step`` over ``batches`` from ``step_idx = start``; returns the last
    params and state and every loss."""
    losses = []
    for i, b in enumerate(batches, start=start):
        params, state, loss, _ = step(params, state, b, i)
        losses.append(loss)
    return params, state, torch.stack(losses)


def train_phase(T, models, pytree, ops, byz, checkpoint, synthetic, arch, tmp: Path) -> dict:
    """The LM train step (``launch.train.build_engine_step``) at ``lm_arch()``,
    N=10, 4 steps, batches of 1 row of 16 tokens a subset:

      * loop against graph mode, bit for bit (params, optimizer state,
        losses), under AdamW with fp32 and with bf16 moments, and with
        ``microbatches=2`` under ``compression="quant"`` (QSGD on the LM
        path; 2 rows a subset);
      * the captures made once: warm steps and a second step built from an
        equal configuration capture nothing (``engine_program_cache_info``);
      * a checkpoint after step 2 (params and optimizer state), loaded and
        resumed to step 4 in graph mode, bit for bit the uninterrupted run;
      * the card against the CPU in loop mode on the same records (drawn on
        the CPU): every step's loss within relative ``TRAIN_RTOL``, the
        params' largest difference reported."""
    out = {"phase": "train", "arch": dataclasses.asdict(arch), "n_devices": 10, "steps": TRAIN_STEPS}
    params0, specs = models.init(torch.Generator().manual_seed(0), arch)
    params0 = pytree.map_tree(lambda a: a.to("cuda"), params0)
    batches = train_batches(synthetic, arch, 10, 1, TRAIN_STEPS)
    runs = {}
    for name, kw, rows in (("adamw_fp32", dict(momentum_dtype="float32"), 1),
                           ("adamw_bf16", dict(momentum_dtype="bfloat16"), 1),
                           ("adamw_bf16_mb2_quant", dict(microbatches=2, compression="quant", quant_levels=4), 2)):
        tcfg = train_tcfg(T, arch, **kw)
        data = batches if rows == 1 else train_batches(synthetic, arch, 10, rows, TRAIN_STEPS)
        res = {}
        for mode in ("loop", "graph"):
            step, opt = T.build_train_step(arch, tcfg, specs, device="cuda", mode=mode)
            if mode == "loop":  # untimed: first-use set-up of the libraries
                step(params0, opt.init(params0), data[0], 0)
            before = ops.launch_counts()["quantize"]
            start = time.perf_counter()
            first = drive(step, params0, opt.init(params0), data[:1])  # in graph mode, with the captures
            torch.cuda.synchronize()
            mid = time.perf_counter()
            rest = drive(step, first[0], first[1], data[1:], start=1)
            torch.cuda.synchronize()
            res[mode] = (rest[0], rest[1], torch.cat([first[2], rest[2]]))
            res[mode + "_ms"] = ((mid - start) * 1e3, (time.perf_counter() - mid) * 1e3 / (TRAIN_STEPS - 1))
            res[mode + "_quantize_launches"] = ops.launch_counts()["quantize"] - before
        (lp, ls, ll), (gp, gs, gl) = res["loop"], res["graph"]
        check(bool(torch.isfinite(ll).all()), f"train {name}: loss not finite")
        check(tree_equal((lp, ls), (gp, gs), pytree) and torch.equal(ll, gl),
              f"train {name}: graph mode differs from loop mode")
        if "quant" in name:
            check(res["loop_quantize_launches"] > 0, "train: QSGD was not launched on the LM path")
        runs[name] = {"loss": ll.tolist(), "loop_ms_per_step": res["loop_ms"][1],
                      "graph_first_step_ms_incl_captures": res["graph_ms"][0],
                      "graph_ms_per_warm_step": res["graph_ms"][1], "loop_bitwise_graph": True,
                      "quantize_launches_loop": res["loop_quantize_launches"]}
    out["runs"] = runs

    # warm steps and an equal configuration capture nothing
    tcfg = train_tcfg(T, arch, momentum_dtype="float32")
    step, opt = T.build_train_step(arch, tcfg, specs, device="cuda", mode="graph")
    state = opt.init(params0)
    step(params0, state, batches[0], 0)
    info = T.engine_program_cache_info()
    for i in (1, 2):
        step(params0, state, batches[i], i)
    step2, _ = T.build_train_step(arch, train_tcfg(T, arch, momentum_dtype="float32"), specs, device="cuda",
                                  mode="graph")
    step2(params0, state, batches[3], 3)
    check(T.engine_program_cache_info() == info, "train: a warm step captured again")
    out["captures"] = info

    # save after step 2, load, resume to step 4: bit for bit the uninterrupted run
    whole = drive(step, params0, opt.init(params0), batches)
    p_mid, s_mid, _ = drive(step, params0, opt.init(params0), batches[:2])
    ck = str(tmp / "train_ck")
    checkpoint.save_checkpoint(ck, {"params": p_mid, "opt": s_mid}, step=2)
    like = {"params": params0, "opt": opt.init(params0)}
    restored, at = checkpoint.load_checkpoint(ck, like)
    check(at == 2 and tree_equal(restored, {"params": p_mid, "opt": s_mid}, pytree),
          "train: the checkpoint did not restore bit for bit")
    p_fin, s_fin, _ = drive(step, restored["params"], restored["opt"], batches[2:], start=2)
    check(tree_equal((p_fin, s_fin), whole[:2], pytree),
          "train: the resumed run differs from the uninterrupted one")
    out["resume_bitwise"] = True

    # the card against the CPU, loop mode, on records drawn on the CPU
    pcfg = T.make_round_config(tcfg, 10)
    q = sum(v.numel() for v in pytree.leaves(params0))
    gen = torch.Generator().manual_seed(7)
    recs = {(i, 0): byz.sample_round_randomness(pcfg, q, gen) for i in range(TRAIN_STEPS)}
    side = {}
    for dev in ("cuda", "cpu"):
        step, opt = T.build_train_step(arch, tcfg, specs, device=dev, randomness=lambda i, j: recs[(i, j)])
        p = pytree.map_tree(lambda a: a.to(dev), params0)
        side[dev] = drive(step, p, opt.init(p), batches)
    card_loss, cpu_loss = side["cuda"][2].cpu(), side["cpu"][2]
    rel = float(((card_loss - cpu_loss).abs() / cpu_loss.abs()).max())
    check(rel <= TRAIN_RTOL, f"train card vs CPU loss: rel {rel} > {TRAIN_RTOL}")
    worst = max(float((a.cpu() - b).abs().max()) for a, b in zip(pytree.leaves(side["cuda"][0]),
                                                                 pytree.leaves(side["cpu"][0])))
    out["card_vs_cpu"] = {"max_rel_loss": rel, "tolerance": TRAIN_RTOL, "params_max_abs_diff": worst,
                          "loss_card": card_loss.tolist()}
    T.engine_program_cache_clear()
    return out


TRAIN_WIDE_STEPS = 3
TRAIN_WIDE_PEAK_GB = 76.0  # the card has 80


def train_wide_phase(T, models, pytree, archs, synthetic, hbm: float, fp32: float) -> dict:
    """smollm-360m at its published widths, depth and dtype (bf16 weights,
    fp32 norm scales, P = 361,821,120) through the train step, with
    ``TrainConfig``'s optimizer (AdamW, bf16 moments, weight decay 0.01, lr
    3e-4 on a 100-step schedule), N=8, LAD d=2, CWTM (trim 0.25) under ALIE
    with 2 Byzantine, 2 rows of 16 tokens a subset: one untimed warm-up
    step, then 3 steps in loop mode and 3 in graph mode from the same
    state. Per step the card's ms (CUDA events) and the host's; the apply
    alone (eager) against its byte bound; the first graph step's time (the
    warm-up run and both captures); each mode's peak memory; finite losses;
    the final params and state bit for bit equal across the modes."""
    arch = archs.ARCHS["smollm-360m"]
    tcfg = T.TrainConfig(arch=arch.name, protocol="lad", protocol_impl="engine", n_subsets=WIDE_N, d=2,
                         aggregator="cwtm", trim_frac=0.25, n_byz=2, attack="alie")
    start = time.perf_counter()
    params, specs = models.init(torch.Generator().manual_seed(0), arch)
    params = pytree.map_tree(lambda a: a.to("cuda"), params)
    init_s = time.perf_counter() - start
    q = sum(v.numel() for v in pytree.leaves(params))
    check(q == WIDE_Q, f"smollm-360m has {q} parameters, not {WIDE_Q}")
    check({v.dtype for v in pytree.leaves(params)} == {torch.bfloat16, torch.float32}, "train_wide: not bf16/fp32")
    batches = train_batches(synthetic, arch, WIDE_N, 2, 1 + TRAIN_WIDE_STEPS)
    out = {"phase": "train_wide", "arch": arch.name, "params": q, "n_devices": WIDE_N, "d": 2, "n_byz": 2,
           "aggregator": "cwtm", "trim_frac": 0.25, "attack": "alie", "per_subset": 2, "seq_len": 16,
           "optimizer": tcfg.optimizer, "momentum_dtype": tcfg.momentum_dtype, "lr": tcfg.lr,
           "weight_decay": tcfg.weight_decay, "schedule_steps": tcfg.steps, "init_s": init_s}
    loop_step, opt = T.build_train_step(arch, tcfg, specs, device="cuda", mode="loop")
    state = opt.init(params)
    params, state, loss, _ = loop_step(params, state, batches[0], 0)  # the untimed warm-up step
    check(bool(torch.isfinite(loss)), "train_wide: warm-up loss not finite")

    def timed(step, name):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        p, s, rows, losses = params, state, [], []
        for i, b in enumerate(batches[1:], start=1):
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            ev[0].record()
            p, s, loss, _ = step(p, s, b, i)
            ev[1].record()
            host_ms = (time.perf_counter() - t0) * 1e3
            ev[1].synchronize()
            rows.append({"card_ms": ev[0].elapsed_time(ev[1]), "host_ms": host_ms,
                         "wall_ms": (time.perf_counter() - t0) * 1e3})
            losses.append(float(loss))
        check(all(map(math.isfinite, losses)), f"train_wide {name}: loss not finite")
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(peak < TRAIN_WIDE_PEAK_GB, f"train_wide {name}: peak {peak:.1f} GB >= {TRAIN_WIDE_PEAK_GB}")
        out[name] = {"steps": rows, "loss": losses, "peak_gb": peak}
        return p, s

    loop_p, loop_s = timed(loop_step, "loop")
    torch.cuda.empty_cache()  # the loop's cached blocks would sit beside the captures' pools
    graph_step, _ = T.build_train_step(arch, tcfg, specs, device="cuda", mode="graph")
    before = T.engine_program_cache_info()
    graph_p, graph_s = timed(graph_step, "graph")
    out["graph"]["first_step_incl_captures_ms"] = out["graph"]["steps"][0]["wall_ms"]
    after = T.engine_program_cache_info()
    out["captures"] = {k: after[k] - before[k] for k in ("round", "apply")}
    check(out["captures"] == {"round": 1, "apply": 1}, f"train_wide: captures {out['captures']}, not one each")
    check(tree_equal((loop_p, loop_s), (graph_p, graph_s), pytree),
          "train_wide: graph mode differs from loop mode")
    out["loop_bitwise_graph"] = True
    del loop_p, loop_s, graph_p, graph_s
    T.engine_program_cache_clear()
    torch.cuda.empty_cache()

    # the optimizer apply alone, eager, on an aggregate of the params' width
    from repro_torch.core.coding import tree_spec, unflatten_pytree
    from repro_torch.optim import linear_warmup_cosine
    g = torch.randn((q,), generator=torch.Generator(device="cuda").manual_seed(4), device="cuda") * 1e-3
    schedule = linear_warmup_cosine(tcfg.lr, warmup=max(tcfg.steps // 20, 1), total_steps=tcfg.steps)
    idx = torch.tensor(7, dtype=torch.int32, device="cuda")
    spec = tree_spec(params)
    apply_ms = time_ms(lambda: opt.update(params, unflatten_pytree(g, spec), state, schedule(idx),
                                          weight_decay=tcfg.weight_decay))
    # each input read once, each output written once: params, the fp32 aggregate, both moments in; params, moments out
    nbytes = sum(p.numel() * (2 * p.element_size() + 4 + 4 * m.element_size())
                 for p, m in zip(pytree.leaves(params), pytree.leaves(state.mu)))
    nops = 17 * q  # AdamW's products, sums, two divisions and a root per parameter (fp32, off the tensor cores)
    bound_bytes, bound_ops = nbytes / hbm * 1e3, nops / fp32 * 1e3
    out["apply"] = {"ms": apply_ms, "bound_ms": max(bound_bytes, bound_ops),
                    "bound_by": "bytes" if bound_bytes >= bound_ops else "operations", "bytes": nbytes,
                    "operations": nops, "route": "eager PyTorch elementwise ops, leaf by leaf"}
    return out


# ---------------------------------------------------------------- protomath

PROTOMATH_STEPS = 4
PROTOMATH_SETUPS = {  # LAD d=2, 2 Byzantine of N=8, CWTM trim 0.25: two key-free setups and Com-LAD under QSGD
    "cwtm-alie": dict(aggregator="cwtm", attack="alie"),
    "cwtm_nnm-sign_flip": dict(aggregator="cwtm-nnm", attack="sign_flip"),
    "cwtm-gaussian-quant4": dict(aggregator="cwtm", attack="gaussian", compression="quant", quant_levels=4),
}
PROTOMATH_KERNELS = ("attack", "cwtm", "gram", "quantize")  # the exchange's server and Com-LAD


def protomath_tcfg(T, arch, **kw):
    base = dict(arch=arch.name, protocol="lad", protocol_impl="protomath", d=2, trim_frac=0.25, n_byz=2,
                optimizer="adamw", momentum_dtype="float32", lr=3e-3, steps=PROTOMATH_STEPS)
    base.update(kw)
    return T.TrainConfig(**base)


def exchange_against_plain(protomath, comp_lib, protocol, shape) -> float:
    """One exchange of an (N, *shape) stack through the kernels against the
    same exchange on the CPU (the plain versions); returns the largest
    error as a share of the allowance (rtol 1e-5, atol 1e-6 of the largest
    value). A protocol with draws (compression, the gaussian attack) draws
    them on its device, so there the QSGD kernel is held instead, bit for
    bit its plain version on the same rows and uniforms."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((WIDE_N,) + tuple(shape), generator=gen, device="cuda")
    if protocol.compression.name != "none":
        rows, u = x.reshape(WIDE_N, -1), torch.rand((WIDE_N, math.prod(shape)), generator=gen, device="cuda")
        got = comp_lib.compress_rows(protocol.compression, rows, quant_u=u).cpu()
        check(torch.equal(got, comp_lib.compress_rows(protocol.compression, rows.cpu(), quant_u=u.cpu())),
              "protomath: QSGD of the exchange's rows differs from its plain version")
        return 0.0
    got = protomath.robust_combine(protocol, x, ("fsdp", None)).cpu()
    want = protomath.robust_combine(protocol, x.cpu(), ("fsdp", None))
    atol = ATOL * float(want.abs().max())
    check(torch.allclose(got, want, rtol=RTOL, atol=atol), "protomath: an exchange disagrees with its plain version")
    return float(((got - want).abs() / (atol + RTOL * want.abs())).max())


def protomath_phase(T, mesh_lib, protomath, comp_lib, models, pytree, ops, synthetic, arch, group) -> dict:
    """The ``"protomath"`` train step at ``lm_arch()`` (fp32), N=8 on one
    rank, 4 steps of 1 row of 16 tokens a block, AdamW (fp32 moments), for
    each of ``PROTOMATH_SETUPS``:

      * under the 1-rank NCCL ``group``, the ``sharded`` server (its
        ``all_to_all``) bit for bit the ``gather`` one (its
        ``all_gather``), params, state and losses; the exchange counts of
        each and the kernels' launches in the step;
      * the key-free setups on the card against the same steps on the CPU
        (no group, the plain versions): every loss within relative
        ``TRAIN_RTOL``; the quant setup's draws are on the step's device,
        so its losses are only held finite;
      * one exchange of an (8, 960, 2560) stack through the kernels against
        the plain versions on the CPU (rtol 1e-5, atol 1e-6 of its largest
        value; for the quant setup its QSGD, bit for bit)."""
    out = {"phase": "protomath", "arch": arch.name, "n_devices": WIDE_N, "ranks": 1, "steps": PROTOMATH_STEPS,
           "setups": {}}
    params0, specs = models.init(torch.Generator().manual_seed(0), arch)
    batches = train_batches(synthetic, arch, WIDE_N, 1, PROTOMATH_STEPS)
    card_mesh = mesh_lib.make_host_mesh(WIDE_N, group=group)
    cpu_mesh = mesh_lib.Mesh(data=WIDE_N, group=None, world=1, rank=0)
    for name, kw in PROTOMATH_SETUPS.items():
        res = {}
        for server in ("sharded", "gather"):
            tcfg = protomath_tcfg(T, arch, server=server, **kw)
            step, opt = T.build_train_step(arch, tcfg, specs, mesh=card_mesh, device="cuda")
            p = pytree.map_tree(lambda a: a.to("cuda"), params0)
            before = ops.launch_counts()
            protomath.reset_exchange_counts()
            start = time.perf_counter()
            run = drive(step, p, opt.init(p), batches)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - start) * 1e3 / PROTOMATH_STEPS
            after = ops.launch_counts()
            res[server] = run
            res[server + "_info"] = {"ms_per_step": ms, "exchanges": protomath.exchange_counts(),
                                     "launches": {k: after[k] - before[k] for k in PROTOMATH_KERNELS}}
        check(bool(torch.isfinite(res["sharded"][2]).all()), f"protomath {name}: loss not finite")
        check(tree_equal(res["sharded"][:2], res["gather"][:2], pytree) and torch.equal(res["sharded"][2],
                                                                                        res["gather"][2]),
              f"protomath {name}: the sharded server differs from the gather server")
        check(res["sharded_info"]["exchanges"]["sharded_calls"] > 0, f"protomath {name}: no all_to_all exchange")
        line = {"loss": res["sharded"][2].tolist(), "sharded_bitwise_gather": True,
                "sharded": res["sharded_info"], "gather": res["gather_info"]}
        if "compression" not in kw:
            tcfg = protomath_tcfg(T, arch, **kw)
            step, opt = T.build_train_step(arch, tcfg, specs, mesh=cpu_mesh, device="cpu")
            cpu_loss = drive(step, params0, opt.init(params0), batches)[2]
            card_loss = res["sharded"][2].cpu()
            rel = float(((card_loss - cpu_loss) / cpu_loss).abs().max())
            check(rel <= TRAIN_RTOL, f"protomath {name} card vs CPU loss: rel {rel} > {TRAIN_RTOL}")
            line["card_vs_cpu"] = {"max_rel_loss": rel, "tolerance": TRAIN_RTOL}
        line["exchange_vs_plain_share"] = exchange_against_plain(
            protomath, comp_lib, T.make_protocol(protomath_tcfg(T, arch, **kw), cpu_mesh), (960, 2560))
        out["setups"][name] = line
    for kernel in PROTOMATH_KERNELS:
        check(any(s[srv]["launches"][kernel] > 0 for s in out["setups"].values() for srv in ("sharded", "gather")),
              f"protomath: kernel {kernel} was not launched in the exchange")
    return out


PROTOMATH_WIDE_STEPS = 3


def leaves_with_specs(params, specs, prefix: str = ""):
    """(path, tensor, logical axes) of every leaf, in ``pytree``'s order."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from leaves_with_specs(params[k], specs[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], params, tuple(specs)
EXCHANGE_ROWS = 8 + 1  # the exchange as a function: the (8, P) fp32 blocks read once, the (P,) result written once
KERNEL_ROWS = 8 + 8 + 8 + 1  # as the kernels run it: the attack reads 8 rows and writes 8, CWTM reads 8 and writes 1


def protomath_wide_phase(T, mesh_lib, protomath, models, pytree, ops, archs, synthetic, hbm: float, group,
                         train_wide: dict) -> dict:
    """smollm-360m at its published widths, depth and dtype (bf16 weights,
    P = 361,821,120) through the ``"protomath"`` step under the 1-rank NCCL
    ``group``, ``train_wide``'s settings: AdamW with bf16 moments, N=8, LAD
    d=2, 2 Byzantine, CWTM trim 0.25 under ALIE, 2 rows of 16 tokens a
    block, the sharded server. One untimed warm-up step, then 3: per step
    the card's ms (CUDA events) and the host's, peak memory beside
    ``train_wide``'s, finite losses, the parameters each step exchanges
    (all P, the tied table once, through the head) and the attack and CWTM
    launches; then the exchange alone (every leaf's (8, *w) fp32 block
    through ``robust_combine``) against its byte bound."""
    arch = archs.ARCHS["smollm-360m"]
    tcfg = T.TrainConfig(arch=arch.name, protocol="lad", protocol_impl="protomath", d=2, aggregator="cwtm",
                         trim_frac=0.25, n_byz=2, attack="alie")
    params, specs = models.init(torch.Generator().manual_seed(0), arch)
    params = pytree.map_tree(lambda a: a.to("cuda"), params)
    q = sum(v.numel() for v in pytree.leaves(params))
    check(q == WIDE_Q, f"smollm-360m has {q} parameters, not {WIDE_Q}")
    batches = train_batches(synthetic, arch, WIDE_N, 2, 1 + PROTOMATH_WIDE_STEPS)
    mesh = mesh_lib.make_host_mesh(WIDE_N, group=group)
    step, opt = T.build_train_step(arch, tcfg, specs, mesh=mesh, device="cuda")
    out = {"phase": "protomath_wide", "arch": arch.name, "params": q, "n_devices": WIDE_N, "ranks": mesh.world,
           "backend": torch.distributed.get_backend(group), "d": 2, "n_byz": 2, "aggregator": "cwtm",
           "trim_frac": 0.25, "attack": "alie", "server": tcfg.server, "per_block_rows": 2, "seq_len": 16,
           "optimizer": tcfg.optimizer, "momentum_dtype": tcfg.momentum_dtype}
    state = opt.init(params)
    warm = ops.launch_counts()
    params, state, loss, _ = step(params, state, batches[0], 0)  # the untimed warm-up step
    warm = {k: v - warm[k] for k, v in ops.launch_counts().items()}
    check(bool(torch.isfinite(loss)), "protomath_wide: warm-up loss not finite")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, losses = [], []
    before = ops.launch_counts()
    protomath.reset_exchange_counts()
    for i, b in enumerate(batches[1:], start=1):
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev[0].record()
        params, state, loss, _ = step(params, state, b, i)
        ev[1].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[1].synchronize()
        rows.append({"card_ms": ev[0].elapsed_time(ev[1]), "host_ms": host_ms,
                     "wall_ms": (time.perf_counter() - t0) * 1e3})
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated() / 1e9
    after = ops.launch_counts()
    ex = protomath.exchange_counts()
    check(all(map(math.isfinite, losses)), "protomath_wide: loss not finite")
    check(ex["elements"] == PROTOMATH_WIDE_STEPS * WIDE_Q,
          f"protomath_wide: {ex['elements']} parameters exchanged in {PROTOMATH_WIDE_STEPS} steps, not P each")
    launches = {k: after[k] - before[k] for k in ("attack", "cwtm")}
    check(all(v > 0 for v in launches.values()), f"protomath_wide: exchange kernels not launched: {launches}")
    out.update({"steps": rows, "loss": losses, "peak_gb": peak, "exchanges_a_step": {
        k: v // PROTOMATH_WIDE_STEPS for k, v in ex.items()}, "launches_a_step": {
        k: v // PROTOMATH_WIDE_STEPS for k, v in launches.items()},
        # the path's launches: the warm-up step's and the timed steps', not the exchange timed alone below
        "path_launches": {k: warm[k] + after[k] - before[k] for k in after}})
    out["train_wide"] = {"loop_card_ms": [r["card_ms"] for r in train_wide["loop"]["steps"]],
                         "graph_card_ms": [r["card_ms"] for r in train_wide["graph"]["steps"]],
                         "loop_peak_gb": train_wide["loop"]["peak_gb"], "graph_peak_gb": train_wide["graph"]["peak_gb"]}
    del state
    torch.cuda.empty_cache()

    # the exchange alone: every leaf's (8, *w) fp32 blocks, one robust_combine a leaf (each period's its own)
    protocol = T.make_protocol(tcfg, mesh)
    leaves = []  # (block shape, logical axes)
    for path, v, spec in leaves_with_specs(params, specs):
        stacked = path.startswith("periods/")
        leaves += [(tuple(v.shape[1:]), tuple(spec[1:]))] * v.shape[0] if stacked else [(tuple(v.shape), spec)]
    shapes = [s for s, _ in leaves]
    gen = torch.Generator(device="cuda").manual_seed(3)
    biggest = max(math.prod(s) for s in shapes)
    pool = torch.randn((WIDE_N * biggest,), generator=gen, device="cuda") * 1e-3

    def exchange_all():
        for s, spec in leaves:
            protomath.robust_combine(protocol, pool[:WIDE_N * math.prod(s)].view((WIDE_N,) + s), spec, group=group)

    check(sum(math.prod(s) for s in shapes) == WIDE_Q, "protomath_wide: the exchanged leaves are not all of P")
    ex_ms = time_ms(exchange_all, iters=3)
    nbytes, kernel_bytes = EXCHANGE_ROWS * 4 * WIDE_Q, KERNEL_ROWS * 4 * WIDE_Q
    out["exchange_alone"] = {"ms": ex_ms, "leaves": len(shapes), "bound_ms": nbytes / hbm * 1e3, "bytes": nbytes,
                             "bound_by": "bytes", "rows": "fp32 (8, P) read once, (P,) written once",
                             "kernels_bound_ms": kernel_bytes / hbm * 1e3, "kernels_bytes": kernel_bytes,
                             "kernels_rows": "attack reads 8 rows and writes 8, CWTM reads 8 and writes 1"}
    del pool
    return out


# ------------------------------------------------------------- engine_shard

ENGINE_SHARD_STEPS = 3
ENGINE_SHARD_PEAK_GB = 76.0  # reckoned 52 to 54: train_wide's 41 to 42 GB and the gathered (8, P) fp32 stack; of 80
ENGINE_SHARD_KERNELS = ("gather_combine", "attack", "cwtm")  # LAD's encode, ALIE and sign-flip, the CWTM server
AUDIO_N = 10
ENGINE_SHARD_WORLDS = (2, 3, 4)  # N=8 over 3 pads to 9


def rank_split_round(T, engine, arch, pcfg, dev, params, blocks, rand, worlds) -> dict[int, dict]:
    """For each ``world``: the engine step's round as ``world`` ranks
    compute it, held against the unsharded round (``(loss, metrics, g)``
    of ``T._Round``), every rank's share run in turn on this one device.
    A share is the vmapped gradient over that rank's ``N_pad / world``
    blocks, so the batch count the device's kernels see differs from N.
    ``engine.gather_ranks`` is stood in for: the first pass keeps each
    rank's local gradient rows and loss columns and stops at the second
    gather; the second pass, as rank 0, receives their concatenation in
    rank order and runs the round on it.

    Returns ``{world: {bitwise, loss_bitwise, metrics_bitwise,
    g_max_abs_diff, g_max_abs}}``."""
    real = engine.gather_ranks

    class Gathered(Exception):
        pass

    def share(world: int, rank: int) -> list[torch.Tensor]:
        mine = []

        def record(x, group, w):
            mine.append(x)
            if len(mine) == 2:  # the gradient rows, then the losses and metrics
                raise Gathered
            return x[:1].expand((x.shape[0] * w,) + tuple(x.shape[1:]))  # the shape only: no copy

        engine.gather_ranks = record
        try:
            T._Round(arch, pcfg, dev, (None, world, rank))(params, blocks, rand)
        except Gathered:
            return mine
        raise AssertionError("the sharded round did not gather")

    want = T._Round(arch, pcfg, dev, None)(params, blocks, rand)
    out = {}
    try:
        for world in worlds:
            shares = [share(world, r) for r in range(world)]
            feed = iter([torch.cat([s[i] for s in shares]) for i in range(2)])
            del shares
            engine.gather_ranks = lambda x, group, w: next(feed)
            loss, metrics, g = T._Round(arch, pcfg, dev, (None, world, 0))(params, blocks, rand)
            engine.gather_ranks = real
            same = {"loss_bitwise": torch.equal(loss, want[0]),
                    "metrics_bitwise": all(torch.equal(metrics[k], want[1][k]) for k in want[1]),
                    "g_bitwise": torch.equal(g, want[2])}
            out[world] = {"bitwise": all(same.values()), **same,
                          "g_max_abs_diff": float((g - want[2]).abs().max()), "g_max_abs": float(want[2].abs().max())}
            del loss, metrics, g, feed
    finally:
        engine.gather_ranks = real
    return out


def with_frontend(arch, batches: list[dict], seed: int) -> list[dict]:
    """``batches`` with the audio family's stub ``frontend`` embeddings,
    standard normals from a CPU generator seeded ``seed``, one a row."""
    gen = torch.Generator().manual_seed(seed)
    enc = arch.encoder
    return [{**b, "frontend": torch.randn((b["tokens"].shape[0], enc.n_frontend_tokens, enc.d_frontend),
                                          generator=gen)} for b in batches]


def engine_shard_phase(T, S, engine, models, pytree, ops, byz, archs, synthetic, smi: str,
                       replayed: dict[str, int]) -> dict:
    """The engine over the ranks of the 1-rank NCCL group ``main`` opens
    (``shard="shard_map"``: the fan-out, the NCCL all-gather of the
    gradient rows, losses and metrics, the replicated round; NCCL takes
    one rank a card, so agreement across ranks is the CPU tests'):

      (a) smollm-360m at its published widths, depth and dtype with
          ``train_wide``'s settings (bf16, AdamW with bf16 moments, N=8,
          LAD d=2, CWTM trim 0.25 under ALIE with 2 Byzantine, 2 rows of 16
          tokens a subset): one untimed unsharded warm-up step, then 3 loop
          steps unsharded and 3 sharded from its state, on the same
          batches. Per step card ms (CUDA events) and host ms, each run's
          peak memory; params, optimizer state and losses bit for bit.
          Then one round as 2, 3 and 4 ranks compute it, each rank's
          share run in turn on this card (``rank_split_round``): the
          losses and metrics bit for bit the unsharded round's, the
          aggregate's largest difference from it (at this width a rank's
          backward rounds differently from the whole batch's: ROADMAP
          C.12);
      (b) ``section7_grid()`` through ``scenarios.run_grid`` in graph mode,
          unsharded, sharded, sharded, unsharded (each mode once first and
          once second, since each call captures its own graphs): every
          lane bit for bit, the grid spread over the group's devices;
      (c) C.10 on the card: ``zoo_arch("audio")``'s engine step with its
          ``frontend`` leaf, sharded, N=10, AdamW, 3 steps, on records drawn
          on the CPU; the same steps on the CPU (unsharded: a CPU tensor
          cannot take the NCCL gather, and the CPU tests hold sharded bit
          for bit unsharded): every loss within relative ``TRAIN_RTOL``.

    The kernels' launches are counted in the windows of the sharded steps,
    the first sharded grid call and the sharded audio steps only
    (``path_launches``): never the unsharded runs they are held to."""
    group = torch.distributed.group.WORLD
    out = {"phase": "engine_shard", "shard": "shard_map", "ranks": torch.distributed.get_world_size(group),
           "backend": torch.distributed.get_backend(group), "nvidia_smi": smi}
    launches = {k: 0 for k in ops.KERNELS}

    def window(fn):
        before = ops.launch_counts()
        res = fn()
        after = ops.launch_counts()
        for k in launches:
            launches[k] += after[k] - before[k]
        return res

    # (a) the full-width step, sharded against unsharded
    arch = archs.ARCHS["smollm-360m"]
    base = dict(arch=arch.name, protocol="lad", protocol_impl="engine", n_subsets=WIDE_N, d=2, aggregator="cwtm",
                trim_frac=0.25, n_byz=2, attack="alie")
    params, specs = models.init(torch.Generator().manual_seed(0), arch)
    params = pytree.map_tree(lambda a: a.to("cuda"), params)
    q = sum(v.numel() for v in pytree.leaves(params))
    check(q == WIDE_Q, f"smollm-360m has {q} parameters, not {WIDE_Q}")
    batches = train_batches(synthetic, arch, WIDE_N, 2, 1 + ENGINE_SHARD_STEPS)
    step, opt = T.build_train_step(arch, T.TrainConfig(**base), specs, device="cuda")
    state = opt.init(params)
    params, state, loss, _ = step(params, state, batches[0], 0)  # the untimed warm-up step, unsharded
    check(bool(torch.isfinite(loss)), "engine_shard: warm-up loss not finite")
    wide = {"arch": arch.name, "params": q, "n_devices": WIDE_N, "d": 2, "n_byz": 2, "aggregator": "cwtm",
            "trim_frac": 0.25, "attack": "alie", "per_subset": 2, "seq_len": 16, "optimizer": "adamw",
            "momentum_dtype": T.TrainConfig(**base).momentum_dtype}
    ends = {}
    for shard in ("none", "shard_map"):
        step, _ = T.build_train_step(arch, T.TrainConfig(**base, shard=shard), specs, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        p, s, rows, losses = params, state, [], []
        for i, b in enumerate(batches[1:], start=1):
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            ev[0].record()
            p, s, loss, _ = window(lambda: step(p, s, b, i)) if shard != "none" else step(p, s, b, i)
            ev[1].record()
            host_ms = (time.perf_counter() - t0) * 1e3
            ev[1].synchronize()
            rows.append({"card_ms": ev[0].elapsed_time(ev[1]), "host_ms": host_ms,
                         "wall_ms": (time.perf_counter() - t0) * 1e3})
            losses.append(loss)
        peak = torch.cuda.max_memory_allocated() / 1e9
        losses = torch.stack(losses)
        check(bool(torch.isfinite(losses).all()), f"engine_shard {shard}: loss not finite")
        check(peak < ENGINE_SHARD_PEAK_GB, f"engine_shard {shard}: peak {peak:.1f} GB >= {ENGINE_SHARD_PEAK_GB}")
        wide[shard] = {"steps": rows, "loss": losses.tolist(), "peak_gb": peak}
        ends[shard] = (p, s, losses)
        del p, s
    check(tree_equal(ends["none"][:2], ends["shard_map"][:2], pytree) and torch.equal(ends["none"][2],
                                                                                     ends["shard_map"][2]),
          "engine_shard: the sharded step differs from the unsharded one")
    wide["sharded_bitwise_unsharded"] = True
    wide["gathered_stack_gb"] = WIDE_N * q * 4 / 1e9
    p_end = ends["none"][0]
    del ends, params, state
    T.engine_program_cache_clear()
    torch.cuda.empty_cache()
    # each rank's share of 2 to 4 ranks at this width, on this card: a round bit for bit the unsharded one
    tcfg = T.TrainConfig(**base)
    pcfg = T.make_round_config(tcfg, WIDE_N)
    blocks = T.block_batch({k: v.to("cuda") for k, v in batches[1].items()}, WIDE_N)
    rand = byz.sample_round_randomness(pcfg, q, torch.Generator(device="cuda").manual_seed(
        T.round_seed(tcfg.seed, 1, 0)))
    worlds = rank_split_round(T, engine, arch, pcfg, torch.device("cuda"), p_end, blocks, rand, ENGINE_SHARD_WORLDS)
    for w, r in worlds.items():  # the forward is the same at every split; the backward's last bits are not (C.12)
        check(r["loss_bitwise"] and r["metrics_bitwise"], f"engine_shard: the {w}-rank split changes the loss")
        check(math.isfinite(r["g_max_abs_diff"]), f"engine_shard: the {w}-rank split's aggregate is not finite")
    wide["rank_split"] = {str(w): r for w, r in worlds.items()}
    out["wide"] = wide
    del p_end, blocks, rand
    torch.cuda.empty_cache()

    # (b) section7_grid() in graph mode, sharded against unsharded
    rows = S.section7_grid()
    grid, call_ms = {}, {"none": [], "shard_map": []}
    for shard in ("none", "shard_map", "shard_map", "none"):  # each mode first once and second once
        torch.cuda.synchronize()
        start = time.perf_counter()
        run = lambda: S.run_grid(rows, STEPS, seed=0, device="cuda", shard=shard)  # noqa: E731
        res = window(run) if shard != "none" and shard not in grid else run()  # the first sharded call counts
        torch.cuda.synchronize()
        call_ms[shard].append((time.perf_counter() - start) * 1e3)
        if shard in grid:
            check(all(same_bits(res[r.name], grid[shard][0][r.name]) for r in rows),
                  f"engine_shard grid: {shard} differs between its two calls")
        else:
            grid[shard] = (res, engine.last_grid_chunk_info()["devices"])
    res, none = grid["shard_map"][0], grid["none"][0]
    for row in rows:
        check(same_bits(res[row.name], none[row.name]), f"engine_shard grid: {row.name} differs from unsharded")
    seen = set()
    for row in rows:
        stats = res[row.name].grid
        if id(stats) not in seen:
            seen.add(id(stats))
            for g in stats.graphs:
                for k, v in g.captured_launches.items():
                    replayed[k] += v * g.replays
    check(grid["shard_map"][1] == out["ranks"], "engine_shard grid: not spread over the group")
    out["grid"] = {"rows": len(rows), "rounds": STEPS, "mode": "graph", "buckets": len(seen),
                   "devices": grid["shard_map"][1], "order": "none, shard_map, shard_map, none",
                   "call_ms": call_ms, "sharded_bitwise_unsharded": True}
    del grid, res, none

    # (c) C.10 on the card: the audio family's frontend through the sharded step
    arch = S.zoo_arch("audio")
    params0, specs = models.init(torch.Generator().manual_seed(0), arch)
    audio = with_frontend(arch, train_batches(synthetic, arch, AUDIO_N, 1, TRAIN_STEPS), seed=3)
    tcfg = train_tcfg(T, arch)
    pcfg = T.make_round_config(tcfg, AUDIO_N)
    qa = sum(v.numel() for v in pytree.leaves(params0))
    gen = torch.Generator().manual_seed(7)
    recs = {(i, 0): byz.sample_round_randomness(pcfg, qa, gen) for i in range(TRAIN_STEPS)}
    side = {}
    for dev, shard in (("cuda", "shard_map"), ("cpu", "none")):
        step, opt = T.build_train_step(arch, dataclasses.replace(tcfg, shard=shard), specs, device=dev,
                                       randomness=lambda i, j: recs[(i, j)])
        p = pytree.map_tree(lambda a: a.to(dev), params0)
        side[dev] = window(lambda: drive(step, p, opt.init(p), audio)) if dev == "cuda" else drive(
            step, p, opt.init(p), audio)
    card_loss, cpu_loss = side["cuda"][2].cpu(), side["cpu"][2]
    check(bool(torch.isfinite(card_loss).all()), "engine_shard audio: loss not finite")
    rel = float(((card_loss - cpu_loss).abs() / cpu_loss.abs()).max())
    check(rel <= TRAIN_RTOL, f"engine_shard audio card vs CPU loss: rel {rel} > {TRAIN_RTOL}")
    out["audio"] = {"arch": arch.name, "n_devices": AUDIO_N, "steps": TRAIN_STEPS, "frontend": list(
        audio[0]["frontend"].shape), "loss_card": card_loss.tolist(), "max_rel_loss": rel, "tolerance": TRAIN_RTOL}
    T.engine_program_cache_clear()

    for kernel in ENGINE_SHARD_KERNELS:
        check(launches[kernel] > 0, f"engine_shard: kernel {kernel} was not launched")
    out["path_launches"] = launches
    return out


# ------------------------------------------------------------------ serving


SERVE_S0, SERVE_TOTAL = 13, 20  # prompt, and prompt plus decoded tokens, as tests/test_serving.py
SERVE_CONFORMANCE = {"jamba": 2e-1, "moe": 1e-1}  # tests/test_serving.py's bounds; 5e-2 for the rest
SERVE_ROUTED = ("moe", "jamba")  # an expert's capacity is a function of the tokens routed together
SERVE_FLASH_S = 2100  # past PLAIN_THRESHOLD, a multiple of neither chunk


def cross_first_audio(archs, base):
    """tests/test_serving.py's audio arch whose first block is
    cross-attention: its cache length never advances in decode."""
    return archs.reduced(archs.ARCHS["whisper-small"]).scaled(
        name="audio-cross-first", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64, vocab=64,
        period=(base.BlockSpec(mixer="cross", mlp="dense"), base.BlockSpec(mixer="attn_nope", mlp="none")),
        encoder=base.EncoderConfig(n_frontend_tokens=8, d_frontend=16, n_encoder_layers=1))


def serve_inputs(arch, seed: int, b: int, t: int):
    """(tokens (b, t) int32, frontend or None), drawn on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, arch.vocab, (b, t), generator=gen, dtype=torch.int32)
    frontend = None
    if arch.family in ("vlm", "audio"):
        enc = arch.encoder
        frontend = torch.randn((b, enc.n_frontend_tokens, enc.d_frontend), generator=gen)
    return tokens, frontend


def teacher_forced(models, params, arch, tokens, frontend, s0: int, capacity: int):
    """The prefill's logits on ``tokens[:, :s0]`` and each decode step's on
    the rest, fed in order: (B, T - s0 + 1, V) float32, and the last state."""
    logits, state = models.prefill(params, None, arch, tokens[:, :s0], frontend=frontend, capacity=capacity)
    out = [logits]
    for t in range(s0, tokens.shape[1]):
        logits, state = models.decode_step(params, None, arch, tokens[:, t:t + 1], state)
        out.append(logits)
    return torch.stack(out, dim=1), state


def bound_share(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """The largest ``|got - want| / (atol + rtol |want|)``: at most 1 where
    ``allclose(rtol, atol)`` holds."""
    return float(((got.float() - want.float()).abs() / (atol + rtol * want.float().abs())).max())


def flash_against_plain(attn) -> dict:
    """The chunked path (padded as ``multihead_attention`` pads) against the
    plain attention at ``SERVE_FLASH_S`` tokens on the card, forward and
    the gradients of q, k and v under one cotangent, float32."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    s = SERVE_FLASH_S
    q = torch.randn((1, s, 1, 2, 16), generator=gen, device="cuda").requires_grad_()
    k, v = (torch.randn((1, s, 1, 16), generator=gen, device="cuda").requires_grad_() for _ in range(2))
    ct = torch.randn((1, s, 1, 2, 16), generator=gen, device="cuda")
    pos = torch.arange(s, device="cuda")[None]
    pad = torch.nn.functional.pad
    pq, pk = (-s) % attn.Q_CHUNK, (-s) % attn.KV_CHUNK
    flash = attn._flash_attention(pad(q, (0, 0, 0, 0, 0, 0, 0, pq)), pad(k, (0, 0, 0, 0, 0, pk)),
                                  pad(v, (0, 0, 0, 0, 0, pk)), pad(pos, (0, pq)), pad(pos, (0, pk), value=-1), True,
                                  None)[:, :s]
    plain = attn._plain_attention(q, k, v, pos, pos, True, None)
    shares = {"out": bound_share(flash, plain, RTOL, ATOL)}
    for name, a, b in zip(("dq", "dk", "dv"), torch.autograd.grad(flash, (q, k, v), ct),
                          torch.autograd.grad(plain, (q, k, v), ct)):
        shares[name] = bound_share(a, b, RTOL, ATOL)
    for name, share in shares.items():
        check(share <= 1.0, f"serve: flash {name} against plain at {s} tokens, {share:.3g} of rtol {RTOL}/atol {ATOL}")
    return {"tokens": s, "rtol": RTOL, "atol": ATOL, "allowance_share": shares}


def serve_phase(S, models, pytree, archs, base, serve, checkpoint, T, synthetic, tmp: Path) -> dict:
    """The serving path at the zoo's scale, float32: the seven
    ``ZOO_FAMILIES`` and the cross-first audio arch of tests/test_serving.py.

      * prefill 13 tokens (capacity 22), then decode 7 fed in order: every
        step's logits against the full forward's at that position, within
        tests/test_serving.py's bounds (5e-2) for the families that do not
        route; for ``moe`` and ``jamba`` the gap is reported, not held (an
        expert's capacity depends on the tokens routed together, so a
        13-token prefill and one-token steps drop other tokens than a
        20-token forward; the reference's own ``moe`` case misses its
        1e-1 at its seed, 0.95);
      * the card's prefill and decode logits against the CPU's on the same
        weights: rtol 1e-5 / atol 1e-6 where nothing routes, the
        conformance bound for ``moe`` and ``jamba``;
      * ``serve_traffic`` loop against graph mode, bit for bit, tokens and
        the final decode state, and their times;
      * the chunked attention at 2,100 tokens against the plain one;
      * train to serve at ``lm_arch()``: the port's ``Trainer`` (N=10, LAD
        d=2, CWTM, 2 sign-flipping devices, AdamW) 4 steps, ``save``,
        ``restore_for_serving`` bit for bit its params, and
        ``serve_traffic`` on them giving the tokens of serving the
        trainer's own params."""
    out = {"phase": "serve", "s0": SERVE_S0, "decoded": SERVE_TOTAL - SERVE_S0, "capacity": SERVE_TOTAL + 2,
           "families": {}}
    for name in list(S.ZOO_FAMILIES) + ["audio-cross-first"]:
        arch = cross_first_audio(archs, base) if name == "audio-cross-first" else S.zoo_arch(name)
        params, _ = models.init(torch.Generator().manual_seed(0), arch)
        tokens, frontend = serve_inputs(arch, 1, 2, SERVE_TOTAL)
        side = {}
        for dev in ("cuda", "cpu"):
            p = pytree.map_tree(lambda a: a.to(dev), params)
            f = None if frontend is None else frontend.to(dev)
            full, _ = models.forward(p, None, arch, tokens.to(dev), frontend=f)
            steps, state = teacher_forced(models, p, arch, tokens.to(dev), f, SERVE_S0, SERVE_TOTAL + 2)
            check(int(state["pos"]) == SERVE_TOTAL, f"serve {name}: pos {int(state['pos'])}")
            side[dev] = (full[:, SERVE_S0 - 1:].cpu(), steps.cpu())
        (full, steps), (_, cpu_steps) = side["cuda"], side["cpu"]
        tol = SERVE_CONFORMANCE.get(name, 5e-2)
        row = {"conformance_share": bound_share(steps, full, tol, tol), "conformance_bound": tol,
               "conformance_max_abs": float((steps - full).abs().max())}
        if name in SERVE_ROUTED:
            row["conformance_held"] = False
            row["card_vs_cpu_share"] = bound_share(steps, cpu_steps, tol, tol)
            row["card_vs_cpu_bound"] = tol
        else:
            check(row["conformance_share"] <= 1.0, f"serve {name}: decode parts from the full forward ({row})")
            row["card_vs_cpu_share"] = bound_share(steps, cpu_steps, RTOL, ATOL)
            row["card_vs_cpu_bound"] = [RTOL, ATOL]
        row["card_vs_cpu_max_abs"] = float((steps - cpu_steps).abs().max())
        check(row["card_vs_cpu_share"] <= 1.0, f"serve {name}: card against CPU ({row})")
        p = pytree.map_tree(lambda a: a.to("cuda"), params)
        res = {mode: serve.serve_traffic(arch, p, None, tokens[:, :SERVE_S0], frontend=frontend,
                                         new_tokens=SERVE_TOTAL - SERVE_S0, mode=mode, device="cuda")
               for mode in ("loop", "graph")}
        check(torch.equal(res["loop"]["tokens"], res["graph"]["tokens"])
              and tree_equal(res["loop"]["state"], res["graph"]["state"], pytree),
              f"serve {name}: graph mode differs from loop mode")
        row["loop_bitwise_graph"] = True
        for mode, r in res.items():
            row[mode] = {"prefill_ms": r["prefill_s"] * 1e3, "decode_ms_per_token": r["decode_s"] * 1e3 / 7,
                         "decode_host_ms_per_token": r["decode_host_s"] * 1e3 / 7}
        out["families"][name] = row
    out["flash"] = flash_against_plain(models.attention)

    arch = S.lm_arch()
    tcfg = train_tcfg(T, arch)
    trainer = T.Trainer(arch, tcfg, device="cuda")
    trainer.run(train_batches(synthetic, arch, 10, 1, TRAIN_STEPS))
    ck = str(tmp / "serve_ck")
    trainer.save(ck)
    restored, specs, step = checkpoint.restore_for_serving(ck, arch, device="cuda")
    check(step == TRAIN_STEPS and specs == trainer.specs and tree_equal(restored, trainer.params, pytree),
          "serve: restore_for_serving is not the trainer's params bit for bit")
    tokens, _ = serve_inputs(arch, 2, 4, 12)
    served = [serve.serve_traffic(arch, p, specs, tokens, new_tokens=8, device="cuda")["tokens"]
              for p in (restored, trainer.params)]
    check(torch.equal(*served), "serve: the restored params serve other tokens than the trainer's")
    out["train_to_serve"] = {"steps": step, "restore_bitwise": True, "tokens_equal": True,
                             "tokens": served[0].tolist()}
    return out


SERVE_WIDE_PEAK_GB = 76.0  # the card has 80
DECODE_LOOP_STEPS, DECODE_GRAPH_STEPS, LONG_STEPS = 4, 16, 16
PREFILL_32K_BATCH = 1  # cut from prefill_32k's 32: the chunked path's eager chunk pairs (PERF.md §5)
CONFORMANCE_S0, CONFORMANCE_DECODE = 4100, 8
WHISPER_PROMPT, WHISPER_DECODE, WHISPER_BATCH = 16, 16, 4


def refill(state: dict, filled: int, seed: int) -> None:
    """The caches' K/V drawn anew from ``seed`` (standard normal), every
    ``length`` and ``pos`` set to ``filled``: the same state on every call."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, c in state.items():
        if name != "pos":
            c.k.normal_(generator=gen)
            c.v.normal_(generator=gen)
            c.length.fill_(filled)
    state["pos"].fill_(filled)


def state_digest(state: dict, slots: int) -> dict:
    """What two decodes from one state must agree on bit for bit: ``pos``,
    every ``length``, the first ``slots`` ring slots of every cache, and
    each period's int64 sum of the bit patterns of its whole K and V."""
    out = {"pos": state["pos"].clone()}
    for name, c in state.items():
        if name == "pos":
            continue
        out[name + "/length"] = c.length.clone()
        for f in ("k", "v"):
            t = getattr(c, f)
            out[f"{name}/{f}/slots"] = t[:, :, :slots].clone()
            out[f"{name}/{f}/bits"] = torch.stack([torch.sum(t[p].view(torch.int16), dtype=torch.int64)
                                                   for p in range(t.shape[0])])
    return out


def copy_bytes(fn) -> dict:
    """The bytes ``fn``'s copies move (``aten.clone``, ``copy_`` and
    ``_to_copy``: each output written and its input read once), found by
    a dispatch mode that sees every aten op, and the largest of them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Copies(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.moved, self.largest = 0, (0, None)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            if func.overloadpacket in (torch.ops.aten.clone, torch.ops.aten.copy_, torch.ops.aten._to_copy):
                nbytes = 2 * res.numel() * res.element_size()
                self.moved += nbytes
                self.largest = max(self.largest, (nbytes, f"{func} {tuple(res.shape)} {res.dtype}"),
                                   key=lambda x: x[0])
            return res

    with Copies() as mode:
        fn()
    torch.cuda.synchronize()
    return {"bytes": mode.moved, "largest": mode.largest[1], "largest_bytes": mode.largest[0]}


def kernel_split(fn, top: int = 6) -> dict | None:
    """Where one call of ``fn`` spends the card's time, as ``torch.profiler``
    sees its kernels: their summed ms, that sum's share of the call's
    CUDA-event ms (1 less it is the idle share), and the ``top`` kernels by
    ms; ``None`` if the profiler sees no kernel."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
    ms = Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(("Memcpy", "Memset")):
            ms[e.name[:100]] += e.time_range.elapsed_us() / 1e3
    if not ms:
        return None
    busy, wall = sum(ms.values()), ev[0].elapsed_time(ev[1])
    return {"kernel_ms": busy, "call_ms": wall, "busy_share": busy / wall, "kernels": len(ms),
            "top": [[name, t] for name, t in ms.most_common(top)]}


def step_times(step, n: int) -> list[float]:
    """CUDA-event ms of each of ``n`` calls of ``step``."""
    times = []
    for _ in range(n):
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        step()
        ev[1].record()
        ev[1].synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    return times


def sdpa_ms(q, k, v, causal: bool) -> float:
    """``scaled_dot_product_attention`` on (B, H, S, D) inputs, K and V
    repeated to the query heads beforehand, its fused backends only (the
    math one would hold the (H, S, S) scores): the library call that
    computes what the port's eager attention does, timed and used nowhere
    in the port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    rep = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal))


def smollm_flops(arch, s: int, causal_pairs: float) -> float:
    """Tensor-core products of a prefill of ``s`` tokens a row: the
    projections, the MLP and ``causal_pairs`` (query, key) pairs of QK and
    PV in every layer, and the head at the last position."""
    hd, h, kv = arch.resolved_head_dim, arch.n_heads, arch.n_kv_heads
    proj = 2 * s * arch.d_model * hd * (2 * h + 2 * kv)
    mlp = 2 * s * 3 * arch.d_model * arch.d_ff
    attn = 2 * 2 * causal_pairs * h * hd
    return arch.n_layers * (proj + mlp + attn) + 2 * arch.d_model * arch.vocab


def serve_wide_phase(models, pytree, archs, base, serve, hbm: float, tensor: float) -> dict:
    """smollm-360m at its published widths, depth and dtype (bf16, P =
    361,821,120), shapes from ``configs.base.INPUT_SHAPES``, and
    whisper-small whole:

      (a) ``decode_32k`` at its batch of 128 against a full cache
          (``init_decode_state(cfg, 128, 32768)``: 8,192 ``long_window``
          slots a layer, K/V drawn from a seed): 4 loop steps and 16 graph
          steps from the same state, ms a step by CUDA events beside the
          byte bound, tokens/s, peak GB, loop bit for bit graph
          (``state_digest``); the bytes one step's copies move; one layer's
          decode attention alone against its byte bound;
      (b) ``prefill_32k`` at batch ``PREFILL_32K_BATCH`` (cut from 32), the
          chunked path at 32,768 tokens: ms, tokens/s, peak GB and the
          FLOP bound, then 8 graph decode steps from its rolled ring; one
          layer's chunked attention alone against its FLOP bound;
      (c) conformance at full width: batch 2, a 4,100-token prompt, 8
          steps fed in order, each within 5e-2 of the full forward over
          4,108 tokens;
      (d) ``long_500k``: batch 1, 524,288 tokens filled, 16 graph steps
          against its 8,192-slot ring;
      (e) whisper-small whole: 1,500 frames, a 16-token prompt, batch 4,
          16 decoded tokens through ``serve_traffic`` (graph), and its
          teacher-forced steps within 5e-2 of its forward."""
    arch = archs.ARCHS["smollm-360m"]
    start = time.perf_counter()
    params, specs = models.init(torch.Generator().manual_seed(0), arch)
    params = pytree.map_tree(lambda a: a.to("cuda"), params)
    q = sum(v.numel() for v in pytree.leaves(params))
    check(q == WIDE_Q, f"smollm-360m has {q} parameters, not {WIDE_Q}")
    weight_bytes = sum(v.numel() * v.element_size() for v in pytree.leaves(params))
    out = {"phase": "serve_wide", "arch": arch.name, "params": q, "dtype": arch.param_dtype,
           "init_s": time.perf_counter() - start, "weight_bytes": weight_bytes}
    decode_fn = serve.build_decode_fn(arch, specs)
    gen = torch.Generator(device="cuda").manual_seed(3)

    # (a) decode_32k
    shape = base.INPUT_SHAPES["decode_32k"]
    b, filled = shape.global_batch, shape.seq_len
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = models.init_decode_state(arch, b, filled, device="cuda")
    cache_bytes = sum(c.k.numel() * c.k.element_size() * 2 for n, c in state.items() if n != "pos")
    cap = state["blk0"].capacity
    tok = torch.randint(0, arch.vocab, (b, 1), generator=gen, device="cuda", dtype=torch.int32)
    refill(state, filled, 11)
    loop = serve.GreedyDecoder(decode_fn, params, tok, state, DECODE_LOOP_STEPS, "loop")
    loop_ms = step_times(loop, DECODE_LOOP_STEPS)
    loop_tokens, loop_digest = loop.bufs["out"].clone(), state_digest(state, DECODE_LOOP_STEPS)
    del loop
    refill(state, filled, 11)
    graph = serve.GreedyDecoder(decode_fn, params, tok, state, DECODE_GRAPH_STEPS, "graph")
    graph_ms = step_times(graph, DECODE_LOOP_STEPS)
    digest = state_digest(state, DECODE_LOOP_STEPS)
    check(torch.equal(graph.bufs["out"][:, :DECODE_LOOP_STEPS], loop_tokens)
          and all(torch.equal(digest[k], loop_digest[k]) for k in digest),
          "serve_wide decode_32k: graph mode differs from loop mode")
    graph_ms += step_times(graph, DECODE_GRAPH_STEPS - DECODE_LOOP_STEPS - 1)
    split = {"graph_replay": kernel_split(graph)}  # the last step, profiled
    check(int(state["pos"]) == filled + DECODE_GRAPH_STEPS, "serve_wide decode_32k: pos did not advance")
    peak = torch.cuda.max_memory_allocated() / 1e9
    split["eager_step"] = kernel_split(lambda: decode_fn(params, tok, state))
    del graph
    nbytes = cache_bytes + weight_bytes
    ms = statistics.median(graph_ms)
    copies = copy_bytes(lambda: decode_fn(params, tok, state))
    mixer = pytree.map_tree(lambda a: a[0], params["periods"]["blk0"]["mixer"])
    c0 = models.attention.KVCache(k=state["blk0"].k[0], v=state["blk0"].v[0], length=state["blk0"].length[0])
    x = torch.randn((b, 1, arch.d_model), generator=gen, device="cuda", dtype=arch.dtype)
    attend = lambda: models.attention.decode_attention(mixer, x, c0, n_heads=arch.n_heads,  # noqa: E731
                                                       n_kv_heads=arch.n_kv_heads, rope_theta=arch.rope_theta)
    layer_bytes = 2 * c0.k.numel() * c0.k.element_size()
    q_heads = torch.randn((b, arch.n_heads, 1, arch.resolved_head_dim), generator=gen, device="cuda", dtype=arch.dtype)
    library_ms = sdpa_ms(q_heads, c0.k.transpose(1, 2), c0.v.transpose(1, 2), False)
    out["decode_32k"] = {
        "batch": b, "filled": filled, "capacity": cap, "cache_gb": cache_bytes / 1e9,
        "graph_ms_per_step": ms, "graph_ms": graph_ms, "loop_ms": loop_ms, "tokens_per_s": b / ms * 1e3,
        "bound_ms": nbytes / hbm * 1e3, "bound_by": "bytes", "bound_bytes": nbytes, "peak_gb": peak,
        "loop_bitwise_graph": True, "copies_a_step": copies, "where_the_time_goes": split,
        "decode_attention_layer": {"ms": time_ms(attend), "bound_ms": layer_bytes / hbm * 1e3, "bound_by": "bytes",
                                   "calls_a_step": arch.n_layers, "kernels_a_call": device_kernels(attend),
                                   "copies": copy_bytes(attend), "library_ms": library_ms,
                                   "library": "scaled_dot_product_attention, K/V repeated to 15 heads"}}
    check(peak < SERVE_WIDE_PEAK_GB, f"serve_wide decode_32k: peak {peak:.1f} GB")
    del state, c0, q_heads
    torch.cuda.empty_cache()

    # (b) prefill_32k, batch cut
    s = base.INPUT_SHAPES["prefill_32k"].seq_len
    tokens = torch.randint(0, arch.vocab, (PREFILL_32K_BATCH, s), generator=gen, device="cuda", dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host = time.perf_counter()
    ev[0].record()
    logits, state = models.prefill(params, specs, arch, tokens)
    ev[1].record()
    ev[1].synchronize()
    host = time.perf_counter() - host
    pre_ms, peak = ev[0].elapsed_time(ev[1]), torch.cuda.max_memory_allocated() / 1e9
    check(bool(torch.isfinite(logits).all()) and int(state["pos"]) == s and state["blk0"].capacity == cap,
          "serve_wide prefill_32k: bad logits or state")
    flops = PREFILL_32K_BATCH * smollm_flops(arch, s, s * (s + 1) / 2)
    dec = serve.GreedyDecoder(decode_fn, params, torch.argmax(logits, dim=-1).to(torch.int32)[:, None], state, 8,
                              "graph")
    after_ms = step_times(dec, 8)
    check(int(state["pos"]) == s + 8, "serve_wide prefill_32k: decode did not advance")
    del dec, state
    qg = torch.randn((1, s, arch.n_kv_heads, arch.n_heads // arch.n_kv_heads, arch.resolved_head_dim),
                     generator=gen, device="cuda", dtype=arch.dtype)
    kv = torch.randn((1, s, arch.n_kv_heads, arch.resolved_head_dim), generator=gen, device="cuda",
                     dtype=arch.dtype)
    pos = torch.arange(s, device="cuda")[None]
    ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev[0].record()
    with torch.no_grad():
        models.attention._flash_attention(qg, kv, kv, pos, pos, True, None)
    ev[1].record()
    ev[1].synchronize()
    small = 4096
    kernels = device_kernels(lambda: models.attention._flash_attention(qg[:, :small], kv[:, :small], kv[:, :small],
                                                                       pos[:, :small], pos[:, :small], True, None))
    layer_flops = 2 * 2 * (s * (s + 1) / 2) * arch.n_heads * arch.resolved_head_dim
    library_ms = sdpa_ms(qg.reshape(1, s, arch.n_heads, -1).transpose(1, 2), kv.transpose(1, 2), kv.transpose(1, 2),
                         True)
    out["prefill_32k"] = {
        "batch": PREFILL_32K_BATCH, "batch_published": base.INPUT_SHAPES["prefill_32k"].global_batch,
        "batch_cut": "the chunked path computes every (query, key) chunk pair, masked ones too, in eager ops "
                     "(64 x 32 pairs a layer): one row takes the ms below; 32 would take about 32 times that",
        "seq_len": s, "ms": pre_ms, "host_ms": host * 1e3, "tokens_per_s": PREFILL_32K_BATCH * s / pre_ms * 1e3,
        "bound_ms": flops / tensor * 1e3, "bound_by": "operations", "flops_causal": flops, "peak_gb": peak,
        "decode_after_ms": after_ms, "ring": cap,
        "flash_attention_layer": {"ms": ev[0].elapsed_time(ev[1]), "bound_ms": layer_flops / tensor * 1e3,
                                  "bound_by": "operations", "calls_a_prefill": arch.n_layers,
                                  "chunk_pairs_a_call": (s // 512) * (s // 1024),
                                  f"kernels_a_call_at_{small}_tokens": kernels,
                                  f"chunk_pairs_at_{small}_tokens": (small // 512) * (small // 1024),
                                  "library_ms": library_ms,
                                  "library": "scaled_dot_product_attention, causal, K/V repeated to 15 heads"}}
    del logits, qg, kv
    torch.cuda.empty_cache()

    # (c) conformance at full width past the plain threshold
    tokens = torch.randint(0, arch.vocab, (2, CONFORMANCE_S0 + CONFORMANCE_DECODE), generator=gen, device="cuda",
                           dtype=torch.int32)
    with torch.no_grad():
        full, _ = models.forward(params, specs, arch, tokens)
    full = full[:, CONFORMANCE_S0 - 1:]
    steps, state = teacher_forced(models, params, arch, tokens, None, CONFORMANCE_S0, tokens.shape[1])
    share = bound_share(steps, full, 5e-2, 5e-2)
    check(share <= 1.0, f"serve_wide: decode at {CONFORMANCE_S0} tokens parts from the full forward ({share:.3g})")
    out["conformance_4100"] = {"batch": 2, "prompt": CONFORMANCE_S0, "decoded": CONFORMANCE_DECODE,
                               "bound": 5e-2, "share": share, "max_abs": float((steps - full).abs().max()),
                               "largest_logit": float(full.abs().max())}
    del full, steps, state
    torch.cuda.empty_cache()

    # (d) long_500k
    shape = base.INPUT_SHAPES["long_500k"]
    state = models.init_decode_state(arch, shape.global_batch, shape.seq_len, device="cuda")
    refill(state, shape.seq_len, 12)
    tok = torch.randint(0, arch.vocab, (shape.global_batch, 1), generator=gen, device="cuda", dtype=torch.int32)
    dec = serve.GreedyDecoder(decode_fn, params, tok, state, LONG_STEPS, "graph")
    long_ms = step_times(dec, LONG_STEPS)
    check(int(state["pos"]) == shape.seq_len + LONG_STEPS, "serve_wide long_500k: pos did not advance")
    nbytes = weight_bytes + sum(c.k.numel() * c.k.element_size() * 2 for n, c in state.items() if n != "pos")
    out["long_500k"] = {"batch": shape.global_batch, "filled": shape.seq_len, "capacity": state["blk0"].capacity,
                        "graph_ms_per_step": statistics.median(long_ms), "graph_ms": long_ms,
                        "bound_ms": nbytes / hbm * 1e3, "bound_by": "bytes"}
    del dec, state, params
    torch.cuda.empty_cache()

    # (e) whisper-small whole
    arch = archs.ARCHS["whisper-small"]
    params, specs = models.init(torch.Generator().manual_seed(0), arch)
    params = pytree.map_tree(lambda a: a.to("cuda"), params)
    tokens, frontend = serve_inputs(arch, 6, WHISPER_BATCH, WHISPER_PROMPT + WHISPER_DECODE)
    tokens, frontend = tokens.cuda(), frontend.cuda()
    torch.cuda.reset_peak_memory_stats()
    res = serve.serve_traffic(arch, params, specs, tokens[:, :WHISPER_PROMPT], frontend=frontend,
                              new_tokens=WHISPER_DECODE, device="cuda")
    peak = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        full, _ = models.forward(params, specs, arch, tokens, frontend=frontend)
    full = full[:, WHISPER_PROMPT - 1:]
    steps, _ = teacher_forced(models, params, arch, tokens, frontend, WHISPER_PROMPT, tokens.shape[1])
    share = bound_share(steps, full, 5e-2, 5e-2)
    check(share <= 1.0, f"serve_wide whisper-small: decode parts from the full forward ({share:.3g})")
    out["whisper_small"] = {"params": sum(v.numel() for v in pytree.leaves(params)), "frames": arch.encoder.n_frontend_tokens,
                            "batch": WHISPER_BATCH, "prompt": WHISPER_PROMPT, "decoded": WHISPER_DECODE,
                            "prefill_ms": res["prefill_s"] * 1e3, "decode_ms_per_token": res["decode_s"] * 1e3 /
                            WHISPER_DECODE, "decode_tokens_per_s": res["decode_tokens_per_s"], "peak_gb": peak,
                            "conformance_share": share, "conformance_bound": 5e-2}
    return out


# ---------------------------------------------------------------- wide round


# --------------------------------------------------------------------- fleet

FLEET = dict(procs=10, n_devices=100, d=20, dim=100, steps=20)  # Section VII's N and Q; 10 devices a process
FLEET_KILLED, FLEET_KILL_ROUND = 9, 5  # (c): the last worker dies when it sees round 5
FLEET_RTOL = 2e-6  # card against CPU, as the trajectory phase
FLEET_ENVELOPE_RTOL = 1e-3  # benchmarks/fleet_bench.py's erasure-decode envelope
FLEET_TIMEOUT_S = 90.0  # one fleet, start-up included


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tagged(out: str, tag: str) -> dict:
    found = [ln for ln in out.splitlines() if ln.startswith(tag + "::")]
    check(len(found) == 1, f"fleet: no {tag}:: line in {out[-2000:]!r}")
    return json.loads(found[0][len(tag) + 2:])


def run_fleet(fleet_lib, cfg, extra: dict[int, list[str]] | None = None, dies: tuple[int, ...] = ()) -> dict:
    """One fleet, a fresh interpreter a process (never a fork of this one,
    which holds the card) with its share of the host's cores, each given
    ``FLEET_TIMEOUT_S``; the rest are killed
    when one fails. The server must exit 0, every worker 0 but those in
    ``dies`` (17, the kill hook). Returns the server's RESULT, the workers'
    reports, and the start-up seconds (spawn to every worker joined) apart
    from the rounds."""
    # the processes share this host's cores: each gets its share of
    # intra-op threads (with a full pool each, their threads spin against
    # each other and a round slows many times over on the host)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1) // cfg.procs))}
    spawned = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.fleet",
                               *dataclasses.replace(cfg, proc_id=pid).to_argv(), *(extra or {}).get(pid, [])],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in range(cfg.procs)]
    try:
        outs = [p.communicate(timeout=FLEET_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, (_, err)) in enumerate(zip(procs, outs)):
        want = 17 if pid in dies else 0
        check(p.returncode == want, f"fleet process {pid} exited {p.returncode}, not {want}: {err[-3000:]}")
        check("torch.distributed unavailable" not in err, f"fleet process {pid}: {err[-2000:]}")
    res, times = tagged(outs[0][0], "RESULT"), tagged(outs[0][0], "TIMES")
    workers = [tagged(out, "RESULT") for pid, (out, _) in enumerate(outs) if pid and pid not in dies]
    return {"result": res, "workers": workers, "startup_s": times["ready_at"] - spawned,
            "round_ms_median": statistics.median(times["round_ms"]), "round_ms": times["round_ms"]}


def fleet_row(run: dict) -> dict:
    res = run["result"]
    return {"final_loss": res["final_loss"], "first_loss": res["losses"][0], "n_report_min": min(res["n_report"]),
            "dead": res["dead"], "rejoins": res["rejoins"],
            "faults": {k: v for k, v in res["wire"]["faults"].items() if v}, "comlad": res["comlad"],
            "server_round_ms_median": run["round_ms_median"], "startup_s": run["startup_s"],
            "server_launches": {k: v for k, v in res["launches"].items() if v},
            "worker_launches": {k: sum(w["launches"][k] for w in run["workers"])
                                for k in res["launches"] if any(w["launches"][k] for w in run["workers"])}}


def fleet_phase(fleet_lib, S) -> dict:
    """The fleet on the card at the paper's width: rows (a) to (d) (see the
    module docstring), each held to its checks. Counts the kernels the card
    fleets' processes launched (their own counters, reset after each
    process's warm-up), never the CPU fleet's."""
    lr = S.PAPER_FIG6["Com-LAD-CWTM"].lr  # the paper's Com-LAD rate: quant:4's noise stays inside the envelope
    base = fleet_lib.FleetConfig(**FLEET, lr=lr, distributed=False, device="cuda")
    out = {"phase": "fleet", **FLEET, "lr": lr, "rows": {}}
    runs = {}

    def card(name: str, cfg, **kw) -> dict:
        runs[name] = run_fleet(fleet_lib, dataclasses.replace(cfg, port=free_port()), **kw)
        out["rows"][name] = fleet_row(runs[name])
        return runs[name]["result"]

    ident_cfg = dataclasses.replace(base, distributed=True)
    a = card("identity", dataclasses.replace(ident_cfg, coordinator=f"127.0.0.1:{free_port()}"))
    cpu = run_fleet(fleet_lib, dataclasses.replace(ident_cfg, device="cpu", port=free_port(),
                                                   coordinator=f"127.0.0.1:{free_port()}"))["result"]
    check(a["losses"][-1] < a["losses"][0], "fleet (a): the loss did not fall")
    check(a["n_report"] == [FLEET["n_devices"]] * FLEET["steps"] and a["dead"] == [], "fleet (a): a device missed")
    rel = max(abs(g - w) / abs(w) for g, w in zip(a["losses"], cpu["losses"]))
    check(rel <= FLEET_RTOL, f"fleet (a): card against CPU {rel:.3g} > {FLEET_RTOL}")
    check(a["launches"]["masked_combine"] >= FLEET["steps"], "fleet (a): the decode did not launch every round")
    out["rows"]["identity"]["card_vs_cpu_rel"] = rel

    case = {c["name"]: c for c in S.fleet_comlad_cases(FLEET["procs"], FLEET["steps"])}
    b = card("quant4", dataclasses.replace(base, compress=case["quant4"]["compress"]))
    ratio = a["comlad"]["uplink_bytes_per_round"] / b["comlad"]["uplink_bytes_per_round"]
    check(ratio >= case["quant4"]["min_ratio"], f"fleet (b): uplink only {ratio:.3g}x fewer bytes")
    check(b["comlad"]["frame_bytes_measured"] == b["comlad"]["frame_bytes_predicted"],
          f"fleet (b): frame bytes {b['comlad']}")
    dev_b = abs(b["final_loss"] - a["final_loss"]) / abs(a["final_loss"])
    check(dev_b <= FLEET_ENVELOPE_RTOL, f"fleet (b): {dev_b:.3g} outside the envelope")
    for w in runs["quant4"]["workers"]:
        check(w["rounds"] == FLEET["steps"] and w["launches"]["quantize"] == FLEET["steps"],
              f"fleet (b): worker {w['proc']} rounds {w['rounds']}, quantize launches {w['launches']['quantize']}")
    out["rows"]["quant4"].update(uplink_ratio=ratio, rel_dev=dev_b)

    c = card("kill", base, extra={FLEET_KILLED: ["--die-after-round", str(FLEET_KILL_ROUND)]}, dies=(FLEET_KILLED,))
    block = FLEET["n_devices"] // FLEET["procs"]
    lo = FLEET_KILLED * block
    check(c["dead"] == [FLEET_KILLED], f"fleet (c): dead {c['dead']}")
    for t, mask in enumerate(c["mask_hist"]):
        want = 0 if t >= FLEET_KILL_ROUND else 1
        check(mask[lo:lo + block] == [want] * block and sum(mask) == FLEET["n_devices"] - (1 - want) * block,
              f"fleet (c): round {t} mask {mask}")
    dev_c = abs(c["final_loss"] - a["final_loss"]) / abs(a["final_loss"])
    check(dev_c <= FLEET_ENVELOPE_RTOL, f"fleet (c): {dev_c:.3g} outside the envelope")
    out["rows"]["kill"]["rel_dev"] = dev_c

    byz = case["quant4_chaos_byz"]
    chaos = json.dumps(byz["chaos"], sort_keys=True)
    d = card("quant4_chaos_byz", dataclasses.replace(base, compress=byz["compress"]),
             extra={pid: ["--chaos", chaos] for pid in range(1, FLEET["procs"])})
    faults = d["wire"]["faults"]
    injected = sum(len(f["rounds"]) for f in byz["chaos"]["faults"])
    check(sum(faults.values()) >= injected and faults["wrong_shape"] + faults["bad_payload"] >= 1,
          f"fleet (d): faults {faults}")
    check(min(d["n_report"]) < FLEET["n_devices"], "fleet (d): no round erased")

    out["fleet_launches"] = {
        "server": {k: sum(r["result"]["launches"][k] for r in runs.values()) for k in a["launches"]},
        "workers": {k: sum(w["launches"][k] for r in runs.values() for w in r["workers"]) for k in a["launches"]}}
    check(out["fleet_launches"]["server"]["masked_combine"] > 0 and out["fleet_launches"]["workers"]["quantize"] > 0,
          f"fleet: kernels not launched: {out['fleet_launches']}")
    return out


def _marked_round(byz, cfg, grads, rand, *, server=None, participation_mask=None):
    """A warm-up round with the default server (so no stage pays for
    cudaMalloc), then the timed round with CUDA events after each stage
    (``server`` may add marks of its own). Returns (aggregate, stage ms,
    peak GB of the timed round, the warm-up's aggregate)."""
    want = byz.protocol_round(cfg, grads, rand, device="cuda", participation_mask=participation_mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [("start", torch.cuda.Event(enable_timing=True))]
    events[0][1].record()

    def hook(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((stage, ev))

    servers = (byz.LaneBranch(0, 1, server(hook)),) if server else None
    g = byz.protocol_round(cfg, grads, rand, device="cuda", stage_hook=hook, server_branches=servers,
                           participation_mask=participation_mask)
    torch.cuda.synchronize()
    stages = {events[i][0]: events[i - 1][1].elapsed_time(events[i][1]) for i in range(1, len(events))}
    return g, stages, torch.cuda.max_memory_allocated() / 1e9, want


def wide_round_phase(byz, attacks, compression, participation, agg, ops, numerics) -> dict:
    """Rounds at Q = WIDE_Q, N=8, d=2, each timed after a warm-up round:

      * CWTM-NNM, trim 0.25, 2 Byzantine, under ALIE and sign-flip;
      * Com-LAD: the same under ALIE with QSGD at 4 levels (``quant:4``),
        the rounding draws one ``torch.rand((8, Q))`` on the card;
      * the erasure decode: no attack, no Byzantine device, the
        ``adversarial`` schedule erasing one row (the margin d - 1), the
        decoded vector held to the gradients' mean;
      * DRACO at d=4 (two groups), one sign-flipping device, the vote held
        to the gradients' mean;
      * median under ALIE, krum under sign-flip, multi_krum under IPM,
        geomed under gaussian noise (one ``torch.randn((8, Q))``) and mcc
        under ALIE, 2 Byzantine, each round's CWTM, Gram and attack
        launches checked.

    The CWTM-NNM servers are composed by hand with a mark after the Gram
    distances and after the neighbour selection, and must give the warm-up's
    bits; both rounds must have launched the fused CWTM-NNM kernel."""
    resident_gb = torch.cuda.memory_allocated() / 1e9  # what earlier phases left allocated
    gen = torch.Generator(device="cuda").manual_seed(2)
    grads = torch.randn((WIDE_N, WIDE_Q), generator=gen, device="cuda")
    out = {"phase": "wide_round", "q": WIDE_Q, "n_devices": WIDE_N, "d": 2,
           "aggregator": "cwtm-nnm", "trim_frac": 0.25, "n_byz": 2, "attacks": {},
           "resident_gb_at_start": resident_gb}
    stack_gb = WIDE_N * WIDE_Q * 4 / 1e9
    q_gb = WIDE_Q * 4 / 1e9

    def nnm_server(cfg):
        def make(hook):
            def server(msgs):
                # what make_server_fn(cfg) builds for cwtm-nnm, with marks
                d2 = ops.pairwise_sqdist(msgs)
                hook("server_gram")
                table = agg.nnm_neighbours(d2, cfg.n_byz)
                hook("server_select")
                return agg.cwtm(msgs, cfg.trim_frac, table)
            return server
        return make

    def fused_round(name, cfg, rand):
        """The warm-up and the marked round; both must take the fused launch."""
        before = ops.launch_counts()
        g, stages, peak_gb, want = _marked_round(byz, cfg, grads, rand, server=nnm_server(cfg))
        after = ops.launch_counts()
        fused = after["cwtm_nnm"] - before["cwtm_nnm"]
        check(fused == 2 and after["cwtm"] - before["cwtm"] == 2,
              f"wide round ({name}): {fused} fused CWTM-NNM launches in two rounds")
        stages["server_nnm_cwtm"] = stages.pop("server")
        check(torch.equal(g, want), f"wide round ({name}): marked server differs from make_server_fn")
        return g, stages, peak_gb, want

    def record(name, g, stages, peak_gb, peak_max_gb, **extra):
        finite = bool(torch.isfinite(g).all())
        check(g.shape == (WIDE_Q,) and finite, f"wide round ({name}): bad aggregate")
        check(peak_gb < peak_max_gb, f"wide round ({name}): peak {peak_gb:.1f} GB >= {peak_max_gb} GB")
        return {"stage_ms": stages, "total_ms": sum(stages.values()), "peak_gb": peak_gb,
                "peak_gb_max": peak_max_gb, "finite": finite, "aggregate_norm": float(g.norm()), **extra}

    for attack in ("alie", "sign_flip"):
        cfg = byz.ProtocolConfig(n_devices=WIDE_N, d=2, method="lad", aggregator="cwtm-nnm",
                                 trim_frac=0.25, n_byz=2, attack=attacks.AttackSpec(attack),
                                 compression=compression.CompressionSpec())
        rand = byz.sample_round_randomness(cfg, WIDE_Q, gen)
        g, stages, peak_gb, want = fused_round(attack, cfg, rand)
        out["attacks"][attack] = record(attack, g, stages, peak_gb, 50.0)
        del g, want

    # Com-LAD with quant:4. Held at once: the gradients, the rounding draws,
    # and two (8, Q) stacks (the coded and quantized ones, then the
    # quantized and attacked ones), 4 x 11.58 GB, plus the warm-up's and the
    # CWTM's (Q,) outputs, 2 x 1.45 GB: 49.2 GB. The limit leaves 3 GB above
    # that.
    cfg = byz.ProtocolConfig(n_devices=WIDE_N, d=2, method="lad", aggregator="cwtm-nnm", trim_frac=0.25,
                             n_byz=2, attack=attacks.AttackSpec("alie"),
                             compression=compression.CompressionSpec.parse("quant:4"))
    rand = byz.sample_round_randomness(cfg, WIDE_Q, gen)
    g, stages, peak_gb, want = fused_round("quant:4", cfg, rand)
    out["com_lad_quant4_alie"] = record("quant:4", g, stages, peak_gb, 4 * stack_gb + 2 * WIDE_Q * 4 / 1e9 + 3.0)
    del g, want, rand

    # the erasure decode, one row erased: the gradients, the coded stack and
    # the erased copy, 3 x 11.58 GB, plus (Q,) outputs
    cfg = byz.ProtocolConfig(n_devices=WIDE_N, d=2, method="lad", aggregator="decode", n_byz=0,
                             attack=attacks.AttackSpec("none"), compression=compression.CompressionSpec(),
                             participation=participation.ParticipationSpec("adversarial", n_drop=1))
    rand = byz.sample_round_randomness(cfg, WIDE_Q, gen)
    pm, _ = participation.sample_participation(cfg.participation, rand.part_u, 0, WIDE_N,
                                               participation.init_participation_state(cfg.participation, WIDE_N,
                                                                                      device="cuda"))
    g, stages, peak_gb, want = _marked_round(byz, cfg, grads, rand, participation_mask=pm)
    check(torch.equal(g, want), "wide round (decode): the timed round differs from the warm-up")
    tail = numerics.stable_mean0(grads[:, WIDE_Q - PLAIN_Q:].contiguous())
    got = g[WIDE_Q - PLAIN_Q:]
    check(torch.allclose(got, tail, rtol=RTOL, atol=ATOL), "wide round (decode): not the gradients' mean")
    out["erasure_decode"] = record("decode", g, stages, peak_gb, 3 * stack_gb + 3.0,
                                   erased=int(WIDE_N - pm.sum()), n_drop=1, n_byz=0, attack="none",
                                   max_abs_err_vs_mean_last_2_26=float((got - tail).abs().max()))
    del g, want, rand, got  # got is a view: it would keep the decode's (Q,) aggregate

    def counted_round(name, cfg, expect):
        """The warm-up and the timed round of ``cfg``; each launches the
        CWTM and Gram kernels ``expect[kernel]`` times a round."""
        rand = byz.sample_round_randomness(cfg, WIDE_Q, gen)
        before = ops.launch_counts()
        g, stages, peak_gb, want = _marked_round(byz, cfg, grads, rand)
        after = ops.launch_counts()
        launches = {k: after[k] - before[k] for k in ("cwtm", "gram", "attack")}
        for k, n in expect.items():
            check(launches[k] == 2 * n, f"wide round ({name}): {launches[k]} {k} launches in two rounds, not {2 * n}")
        check(torch.equal(g, want), f"wide round ({name}): the timed round differs from the warm-up")
        return g, stages, peak_gb, {k: v // 2 for k, v in launches.items()}

    # DRACO, two groups of d=4, device 0 sign-flips: each group keeps an
    # honest majority, so the vote is exact. The gradients, the coded stack
    # and the attacked one, 3 x 11.58 GB, plus (Q,)-sized group medians.
    cfg = byz.ProtocolConfig(n_devices=WIDE_N, d=4, method="draco", n_byz=1,
                             attack=attacks.AttackSpec("sign_flip"), compression=compression.CompressionSpec())
    g, stages, peak_gb, launches = counted_round("draco", cfg, {"cwtm": 1, "gram": 0, "attack": 1})
    got = g[WIDE_Q - PLAIN_Q:]
    check(torch.allclose(got, tail, rtol=RTOL, atol=ATOL), "wide round (draco): not the gradients' mean")
    out["draco_d4"] = record("draco", g, stages, peak_gb, 3 * stack_gb + 3.0, d=4, n_byz=1, attack="sign_flip",
                             launches_per_round=launches,
                             max_abs_err_vs_mean_last_2_26=float((got - tail).abs().max()))
    del g, got, tail

    # the other rules at LAD d=2 with 2 Byzantine devices. Held at once:
    # the gradients, the coded stack and the attacked one (3 x 11.58 GB),
    # then the server's one (N, Q) temporary in place of the coded stack;
    # under gaussian also the round's noise (4 stacks), plus a few
    # (Q,)-sized vectors (1.45 GB each: the warm-up's aggregate, the
    # iterates of geomed and mcc)
    rules = (("median", "alie", {"cwtm": 1, "gram": 0, "attack": 1}, 3),
             ("krum", "sign_flip", {"cwtm": 0, "gram": 1, "attack": 1}, 3),
             ("multi_krum", "ipm", {"cwtm": 0, "gram": 1, "attack": 1}, 3),
             ("geomed", "gaussian", {"cwtm": 0, "gram": 0, "attack": 0}, 4),
             ("mcc", "alie", {"cwtm": 1, "gram": 0, "attack": 1}, 3))
    out["rules"] = {}
    for agg_name, attack, expect, stacks in rules:
        cfg = byz.ProtocolConfig(n_devices=WIDE_N, d=2, method="lad", aggregator=agg_name, n_byz=2,
                                 attack=attacks.AttackSpec(attack), compression=compression.CompressionSpec())
        g, stages, peak_gb, launches = counted_round(agg_name, cfg, expect)
        out["rules"][agg_name] = record(agg_name, g, stages, peak_gb, stacks * stack_gb + 4 * q_gb + 3.0,
                                        attack=attack, n_byz=2, launches_per_round=launches)
        del g
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import checkpoint, models, numerics, pytree
    from repro_torch.configs import archs
    from repro_torch.core import aggregators, attacks, byzantine, coding, compression, engine, participation, scenarios
    from repro_torch.data import synthetic
    from repro_torch.data.synthetic import linear_regression_problem
    from repro_torch.kernels import _build, ops, quantize, ref
    from repro_torch.configs import base
    from repro_torch.core import protomath
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import fleet as fleet_lib
    from repro_torch.launch import serve, train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    hbm, fp32 = peaks(kind)
    build_s = _build.build_all()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda, "kernel_build_s": build_s,
          "peak_hbm_bytes_per_s": hbm, "peak_fp32_flops": fp32})
    emit({"phase": "ptxas", **{name: ptxas_entries(_build.ptxas_log(name)) for name in ("gram", "cwtm")}})

    ops.reset_launch_counts()
    errors = kernel_errors(ops, ref, quantize, aggregators)
    timings = kernel_timings(ops, ref, quantize, aggregators, hbm, fp32)
    checked = ops.launch_counts()
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    replayed = {name: 0 for name in ops.KERNELS}  # launches of graph replays, which no counter sees
    line, trajectory = trajectory_phase(scenarios, byzantine, ops, linear_regression_problem)
    emit(line)
    line, section7 = section7_phase(scenarios, replayed)
    emit(line)
    emit(graph_phase(scenarios, replayed))
    emit(grid_phase(scenarios, trajectory, section7, replayed))
    emit(participation_phase(scenarios))
    linear = ops.launch_counts()
    del trajectory, section7
    torch.cuda.empty_cache()

    # the wide rounds before the LM phases: their peaks are the rounds' own,
    # not raised by what the LM phases' captures leave resident (PERF.md §7)
    ops.reset_launch_counts()
    emit(wide_round_phase(byzantine, attacks, compression, participation, aggregators, ops, numerics))
    wide = ops.launch_counts()
    torch.cuda.empty_cache()

    # the LM path, the train step's phases with it: its own counts, from 0
    ops.reset_launch_counts()
    tmp = ROOT / "build" / "chip_smoke"
    tmp.mkdir(parents=True, exist_ok=True)
    lines = {}

    def run_phases(phases) -> None:
        for name, phase in phases:
            start = time.perf_counter()
            line = phase()
            line["phase_s"] = time.perf_counter() - start
            emit(line)
            lines[name] = line
            torch.cuda.empty_cache()

    run_phases([("lm", lambda: lm_phase(scenarios, byzantine, replayed)),
                ("lm_wide", lambda: lm_wide_phase(scenarios, byzantine, models, coding, pytree, archs)),
                ("zoo", lambda: zoo_phase(scenarios, byzantine, models, pytree, replayed)),
                ("zoo_wide", lambda: zoo_wide_phase(scenarios, byzantine, models, coding, pytree, archs)),
                ("train", lambda: train_phase(train, models, pytree, ops, byzantine, checkpoint, synthetic,
                                              scenarios.lm_arch(), tmp)),
                ("train_wide", lambda: train_wide_phase(train, models, pytree, archs, synthetic, hbm, fp32))])
    lm = ops.launch_counts()

    # the protomath step, under a 1-rank NCCL group: its own counts, from 0
    ops.reset_launch_counts()
    rendezvous = tmp / "nccl_rendezvous"
    rendezvous.unlink(missing_ok=True)
    torch.distributed.init_process_group("nccl", init_method=f"file://{rendezvous}", world_size=1, rank=0)
    try:
        group = torch.distributed.group.WORLD
        run_phases([("protomath", lambda: protomath_phase(train, mesh_lib, protomath, compression, models, pytree, ops,
                                                          synthetic, scenarios.lm_arch(), group)),
                    ("protomath_wide", lambda: protomath_wide_phase(train, mesh_lib, protomath, models, pytree, ops,
                                                                    archs, synthetic, hbm, group,
                                                                    lines["train_wide"]))])
        # the engine over the group's ranks: its own counts, from 0
        ops.reset_launch_counts()
        run_phases([("engine_shard", lambda: engine_shard_phase(train, scenarios, engine, models, pytree, ops,
                                                                byzantine, archs, synthetic, smi, replayed))])
    finally:
        torch.distributed.destroy_process_group()
    # the path's launches are the steps' own windows: not the exchanges held
    # against their plain versions, nor the exchange timed alone
    pm = dict(lines["protomath_wide"]["path_launches"])
    for setup in lines["protomath"]["setups"].values():
        for server in ("sharded", "gather"):
            for name, n in setup[server]["launches"].items():
                pm[name] += n
    for name in PROTOMATH_KERNELS:
        check(pm[name] > 0, f"kernel {name} was not launched on the protomath path")
    es = lines["engine_shard"]["path_launches"]

    ops.reset_launch_counts()
    run_phases([("serve", lambda: serve_phase(scenarios, models, pytree, archs, base, serve, checkpoint, train,
                                              synthetic, tmp)),
                ("serve_wide", lambda: serve_wide_phase(models, pytree, archs, base, serve, hbm, tensor_peak(kind)))])
    lm = {name: lm[name] + n for name, n in ops.launch_counts().items()}
    for name in LM_KERNELS:
        check(lm[name] > 0, f"kernel {name} was not launched on the LM path")

    # the fleet: processes of their own, each counting its own launches
    run_phases([("fleet", lambda: fleet_phase(fleet_lib, scenarios))])
    fl = {name: sum(lines["fleet"]["fleet_launches"][side][name] for side in ("server", "workers"))
          for name in ops.KERNELS}

    launches = {name: linear[name] + lm[name] + wide[name] + pm[name] + es[name] + fl[name] for name in ops.KERNELS}
    for name in TPU_KERNELS:
        if name in OFF_PATH:
            check(checked[name] > 0, f"kernel {name} was not launched in the kernels phase")
            launches[name] = checked[name]
        else:
            check(launches[name] > 0, f"kernel {name} was not launched on the main path")

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": TPU_KERNELS[name][0],
         "replaces": TPU_KERNELS[name][1], "launches": launches[name], "on_path": name not in OFF_PATH,
         "lm_launches": lm[name], "protomath_launches": pm[name], "engine_shard_launches": es[name],
         "fleet_launches": fl[name],
         "graph_replay_launches": replayed[name],
         "max_abs_err": max(errors[name], timings[name]["max_abs_err_wide"]), **timings[name]}
        for name in TPU_KERNELS
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
