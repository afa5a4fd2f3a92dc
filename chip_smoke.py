#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --main-shape   # device, ptxas, main_shape, the kernels' timings and checks only
    python3 chip_smoke.py --main-shape --parent DIR   # also time the kernels of DIR's sources

With ``--parent DIR`` (DIR an earlier tree's ``src/repro_torch/csrc``, e.g.
unpacked from ``git archive <commit>``, holding ``gather_combine.cu``,
``attack.cu``, ``cwtm.cu``, ``gram.cu``, ``quantize.cu``,
``row_combine.cu`` and ``tile.cuh`` with the C entries they had at commit
c93a085), those six sources are built as the port builds its own and
timed beside the tree's kernels in ``main_shape`` and at the wide shape
(``parent_ms``); without it ``parent_ms`` is null.

Builds the CUDA kernels of the protocol round from ``src/repro_torch/csrc``
and prints one JSON line per phase:

  device         the card, its power limit and the kernel build time;
  ptxas          registers and spills of every Gram, CWTM, encode, attack,
                 row-combine and QSGD kernel entry, as ``nvcc -Xptxas -v``
                 reported them when they were built (CWTM:
                 ``cwtm_reg_kernel<N>`` for N <= 12, ``cwtm_net_kernel<P>``
                 for P = 16 to 128 slots and ``cwtm_mix_net_kernel<P>``
                 with a table, ``cwtm_wide_kernel`` past 128; QSGD:
                 ``quantize_warp_kernel<16-byte loads a thread, vec>`` and
                 ``quantize_block_kernel``;
                 the Gram: ``gram_reg_kernel<N>`` up to N = 12,
                 ``gram_tile_kernel<split>`` and ``gram_sum_kernel`` above;
                 ``row_combine_kernel<rows a thread, columns a thread>``);
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
                 chunks of 64) and at N=100 (100,000 encode rows), and
                 the latter under quant:4 (100,000 rows quantized); every
                 lane checked bit for bit against the standalone run of
                 its row (the earlier phases' runs where they ran it), per
                 bucket its lanes, draw groups, captured launches and
                 replay ms a round, per call its ms, peak memory and, for
                 the sweeps, lanes x rounds a second;
  main_shape     the trajectory kernels (encode at d=10, ALIE and
                 sign-flip, CWTM with and without NNM's mix at trim 10 and
                 k = 80, the Gram, QSGD at quant:4's levels) and the
                 erasure decode's ``masked_combine`` at N=100, Q=100 and 1
                 and 1000 lanes, the L2 flushed before each timed launch:
                 CUDA-event ms (each beside the ``--parent`` tree's),
                 the plain version's, a
                 library call's where one computes the function,
                 ``launch_work``'s bound and what bounds it, CWTM beside
                 ``torch.sort`` over the same stack and CWTM-NNM beside
                 ``torch.bmm`` of the neighbour matrix then CWTM, QSGD's
                 launches a call and its layout; CWTM, CWTM-NNM and QSGD
                 held bit for bit to their plain versions at both lane
                 counts; each kernel's
                 launches in the ``section7`` phase's replays, and the
                 replay ms a round of ``section7_grid()`` (its rows alone
                 summed, and the grid's 5 buckets) and of
                 ``synthetic_sweep(1000)`` at N=100;
  tuner          ``max_lanes_per_device="auto"`` (``launch.tuner``, its
                 store a fresh file under ``build/chip_smoke``): (a)
                 ``synthetic_sweep(1000)`` at N=100, dim=100, 200 rounds in
                 graph mode, bit for bit the unchunked sweep, and a warm
                 call that probes nothing; (b) ``run_lm_grid`` on
                 smollm-360m at full width (3 lanes of LAD d=2 CWTM under
                 the three attacks, N=8, 2 rounds, graph mode), bit for bit
                 ``max_lanes_per_device=1``, a warm call that probes
                 nothing, its peak memory, and the allocated memory after
                 the phase back at its level before; every probe's capacity
                 and seconds a lane (``null``: out of memory), the phase's
                 launches and the roofline of one captured round of (a)
                 (``grid_launch_list``, ``roofline.analyze_launches``);
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
  protomath_tp   the ``"protomath"`` step over data 2 x model 2: four fresh
                 interpreters on the card joined over ``gloo`` (NCCL takes one
                 rank a card), every collective on the CUDA tensors; (a)
                 ``lm_arch()`` with 4 heads over 2 kv heads in fp32, N=4, 3
                 steps of each protomath setup under both servers: losses
                 within 2e-6 of this process's model-1 run on the card,
                 ``sharded`` bit for bit ``gather``, the gathered
                 parameters equal on every rank; (b) smollm-360m at full
                 width in bf16 (``protomath_wide``'s settings), N=8: each
                 rank's param and moment bytes against the whole, peak
                 memory, card ms a step, exchanges and kernel launches, the
                 first loss against this process's model-1 step, one
                 exchange of a tp slice against the plain versions; (c)
                 every family the model axis cuts (``lm_arch()`` with its
                 one kv head whole, ``zoo_arch``'s moe, jamba, rwkv, cross
                 and audio, and ``attn_tp="head_dim"``) in fp32, N=4, 3
                 steps of CWTM under ALIE under both servers: losses
                 within 2e-6 of this process's model-1 run, ``sharded``
                 bit for bit ``gather``, the ranks equal; (d)
                 granite-moe-3b-a800m at its published widths cut to 2
                 layers in bf16 (``protomath_wide``'s settings), N=8, its
                 40 experts 20 a rank: as (b), and one exchange of an
                 expert slice (``w_gate``'s) against the plain versions;
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
                 against the plain version at N = 8, 41 and 100; CWTM
                 bitwise at N = 13 to 256 on 3 lanes (``CWTM_N``), and on a
                 stack with NaN, +-inf and +-0 in its Byzantine rows at
                 N = 8 and 100 (NaN at the same places, NaN sorted last);
                 each kernel's ``main_shape`` rows; plus its
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
                 ``protomath_tp_launches``: those of the ``protomath_tp``
                 phase's four ranks, their steps alone, where the attack,
                 CWTM, Gram and QSGD kernels must be above 0;
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
import gc
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

import numpy as np
import torch
import torch.distributed

ROOT = Path(__file__).resolve().parent

WIDE_Q = 361_821_120  # parameters of smollm-360m: the gradient width of one round
WIDE_N = 8
PLAIN_Q = 1 << 26  # the plain versions are timed on this many coordinates
CHECK_SHAPES = ((100, 100), (100, (1 << 20) + 37), (8, 1 << 20))  # (N, Q)
MEDIAN_N = (8, 41, 100)  # the wide round's N, DRACO-d41's groups, the trainer's N
# CWTM's N around each padded size of its sorting network (16 to 256 slots), held at 3 lanes of Q = 4097
CWTM_N = (13, 41, 64, 65, 100, 128, 129, 256)
MAIN_N, MAIN_Q = 100, 100  # Section VII's N and Q = dim
MAIN_LANES = (1, 1000)  # one trajectory; synthetic_sweep(1000)'s lanes
MAIN_D, MAIN_TRIM, MAIN_BYZ = 10, 10, 20  # LAD-d10's subsets a device, CWTM's int(0.1 N), NNM's b = N // 5
MAIN_ITERS = 20
L2_FLUSH_BYTES = 1 << 28  # written between timed launches: more than the card's 50 MB of L2
RTOL, ATOL = 1e-5, 1e-6  # kernel against plain, as tests/test_torch_kernels.py
TRAJECTORY_RTOL = 2e-6  # card against CPU over 200 rounds, as tests/test_torch_engine.py
STEPS = 200

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
BITWISE = ("gather_combine", "attack", "cwtm", "quantize", "masked_combine",
           "coded_combine")  # held to their plain versions bit for bit
QUANT_LEVELS, QUANT_CHUNK = 4, 1024


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
            m = re.search(r"((?:gram|cwtm)_(?:reg|smem|reduce|net|wide|tile|sum|mix_net)_kernel|gather_(?:tile|rows)_kernel|"
                          r"stats_kernel|sign_flip_kernel|row_combine_kernel|quantize_(?:warp|block)_kernel)"
                          r"(I(?:L[a-z]\d+E)+E)?", mangled)
            args = [("true" if v == "1" else "false") if t == "b" else v
                    for t, v in re.findall(r"L([a-z])(\d+)E", (m and m.group(2)) or "")]
            name = mangled if m is None else m.group(1) + (f"<{', '.join(args)}>" if args else "")
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
    for n in CWTM_N:
        x = torch.randn((3, n, 4097), generator=gen, device="cuda") * 3.0
        table = random_table(gen, 3, n, n - n // 5)
        pairs = []
        for trim in sorted({0, n // 10, (n - 1) // 2}):
            pairs += [("cwtm", ops.cwtm(x, trim), ref.cwtm_ref(x, trim), 0.0),
                      ("cwtm", ops.cwtm(x, trim, table), ref.cwtm_ref(ref.nnm_mix_ref(x, table), trim), 0.0)]
        hold_pairs(err, pairs, f"CWTM N={n} at 3 lanes")
    for n in (8, MAIN_N):  # NaN, +-inf and +-0 in the Byzantine rows: NaN sorts last, as torch.sort puts it
        x = special_stack(gen, n, MAIN_Q)
        table = random_table(gen, 1, n, 2)[0]  # two rows a mix: most mixed values stay finite
        for trim in sorted({1, max(1, n // 10)}):
            for nb in (None, table):
                got = ops.cwtm(x, trim, nb)
                want = ref.cwtm_ref(x if nb is None else ref.nnm_mix_ref(x, nb), trim)
                torch.cuda.synchronize()
                check(same_with_nan(got, want),
                      f"cwtm disagrees with its plain version on the NaN/inf/0 stack at N={n} trim={trim}"
                      f"{'' if nb is None else ' with the mix'}")
                nan = torch.isnan(want)
                check(nb is not None or trim != 1 or (bool(nan[0]) and not bool(nan[1])),
                      f"the NaN/inf/0 stack at N={n}: column 0 must come out NaN, column 1 not")
                err["cwtm"] = max(err["cwtm"], float((got[~nan] - want[~nan]).abs().max()))
    return err


def random_table(gen, lanes: int, n: int, k: int) -> torch.Tensor:
    """(lanes, n, k) int32 neighbour tables: k distinct ids of [0, n) a row, ascending."""
    pick = torch.rand((lanes, n, n), generator=gen, device="cuda").argsort(dim=-1)[..., :k]
    return pick.sort(dim=-1).values.to(torch.int32).contiguous()


def special_stack(gen, n: int, q: int) -> torch.Tensor:
    """An (n, q) normal stack whose first max(2, n // 5) rows (the Byzantine
    ones) carry NaN, NaN with its sign bit set, +inf, -inf, +0 or -0 in a
    quarter of their entries; column 0 is NaN in all of them (a NaN
    outlasts a trim of 1), column 1 a negative NaN in its first row alone
    (a trim of 1 drops it: every NaN sorts last)."""
    x = torch.randn((n, q), generator=gen, device="cuda")
    byz = max(2, n // 5)
    nan = math.copysign(math.nan, -1.0)
    specials = torch.tensor([math.nan, nan, math.inf, -math.inf, 0.0, -0.0], device="cuda")
    pick = torch.randint(0, 24, (byz, q), generator=gen, device="cuda")
    x[:byz] = torch.where(pick < 6, specials[pick.clamp(max=5)], x[:byz])
    x[:byz, :2] = torch.randn((byz, 2), generator=gen, device="cuda")
    x[:byz, 0] = math.nan
    x[0, :2] = nan
    return x


def same_with_nan(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN at the same places, every other value equal (+0 equals -0)."""
    nan = torch.isnan(want)
    return got.shape == want.shape and torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], want[~nan])


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


def kernel_timings(ops, ref, quantize, agg, hbm: float, fp32: float,
                   parent: ParentKernels | None = None) -> dict[str, dict]:
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
    ``kernel_errors``. The bound is the bytes and operations of
    ``ops.launch_work`` at the wide shape. With ``parent``, every kernel is timed again beside the parent
    tree's, parent, kernel, kernel, parent: ``parent_ms`` and
    ``ms_beside_parent`` (``_alie``, ``_sign_flip`` for the attack,
    ``_without_mix`` for CWTM without NNM's mix)."""
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
    out = {}

    def entry(name, kernel_ms, kernel_plain_q_ms, plain_ms, library_ms, work):
        nbytes, nops = work
        bound_bytes, bound_ops = nbytes / hbm * 1e3, nops / fp32 * 1e3
        out[name] = {
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "shape": [n, q], "plain_q": PLAIN_Q, "ms_at_plain_q": kernel_plain_q_ms,
            "max_abs_err_wide": 0.0,
        }

    def beside(name, kernel, old, key=""):
        """The tree's kernel and the parent's timed parent, kernel, kernel,
        parent: ``parent_ms`` and ``ms_beside_parent`` each the smaller of
        its two medians."""
        first = time_ms(old)
        out[name]["ms_beside_parent" + key] = min(time_ms(kernel), time_ms(kernel))
        out[name]["parent_ms" + key] = min(first, time_ms(old))

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
          ops.launch_work("gather_combine", 1, n, q, d=2))
    hold("gather_combine", ops.gather_combine(x, subsets, w)[:, q - PLAIN_Q:],
         ref.gather_combine_ref(tail, subsets, w))
    if parent is not None:
        old_out = torch.empty_like(x)
        ids, wl = subsets[None].to(torch.int32), w[None].contiguous()
        beside("gather_combine", lambda: ops.gather_combine(x, subsets, w),
               lambda: parent.gather_combine(x[None], ids, wl, old_out[None]))

    modes = (("sign_flip", -2.0), ("alie", 1.5), ("ipm", 0.5))
    by_mode = {name: time_ms(lambda: ops.attack(x, mask, name, param)) for name, param in modes}
    entry("attack", by_mode["alie"],
          time_ms(lambda: ops.attack(xp, mask, "alie", 1.5)),
          time_ms(lambda: ref.attack_ref(xp, mask, "alie", 1.5)),
          None, ops.launch_work("attack", 1, n, q))
    out["attack"]["ms_by_mode"] = by_mode
    if parent is not None:
        for name, param in modes[:2]:
            beside("attack", lambda: ops.attack(x, mask, name, param),
                   lambda: parent.attack(x[None], mask[None], name, param, old_out[None]), "_" + name)
        out["attack"]["parent_ms"] = out["attack"]["parent_ms_alie"]
        del old_out
    for name, param in modes:
        hold("attack", ops.attack(x, mask, name, param)[:, q - PLAIN_Q:],
             ref.attack_ref(tail, mask, name, param))

    # the wide round's server: trim 2, the mix over k = 6 neighbours (2 Byzantine)
    trim = 2
    table = agg.nnm_neighbours(ops.pairwise_sqdist(x), 2)
    k = table.shape[-1]
    entry("cwtm",
          time_ms(lambda: ops.cwtm(x, trim, table)),
          time_ms(lambda: ops.cwtm(xp, trim, table)),
          time_ms(lambda: ref.cwtm_ref(ref.nnm_mix_ref(xp, table), trim)),
          None, ops.launch_work("cwtm", 1, n, q, trim=trim, k=k))
    # the old route: NNM's (N, N) mixing matrix through cuBLAS in fp32, then the CWTM kernel
    old_mix = torch.zeros((n, n), device="cuda").scatter_(1, table.long(), 1.0 / k)
    out["cwtm"].update({
        "neighbours_k": k, "trim": trim,
        "ms_without_mix": time_ms(lambda: ops.cwtm(x, trim)),
        "old_route_ms": time_ms(lambda: ops.cwtm(torch.matmul(old_mix, x), trim)),
        "old_route": "torch.matmul(mix, X) in fp32 (cuBLAS), then the CWTM kernel without the mix",
    })
    if parent is not None:
        old_cw, table1 = torch.empty((1, q), device="cuda"), table[None].to(torch.int32).contiguous()
        beside("cwtm", lambda: ops.cwtm(x, trim, table), lambda: parent.cwtm(x[None], trim, table1, old_cw))
        beside("cwtm", lambda: ops.cwtm(x, trim), lambda: parent.cwtm(x[None], trim, None, old_cw), "_without_mix")
        del old_cw
    hold("cwtm", ops.cwtm(x, trim, table)[q - PLAIN_Q:], ref.cwtm_ref(ref.nnm_mix_ref(tail, table), trim))
    hold("cwtm", ops.cwtm(x, trim)[q - PLAIN_Q:], ref.cwtm_ref(tail, trim))
    del tail

    entry("gram",
          time_ms(lambda: ops.gram(x)),
          time_ms(lambda: ops.gram(xp)),
          time_ms(lambda: ref.gram_ref(xp)),
          time_ms(lambda: torch.mm(x, x.T)),
          ops.launch_work("gram", 1, n, q))
    if parent is not None:
        beside("gram", lambda: ops.gram(x), lambda: parent.gram(x[None]))
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
    entry("quantize",
          time_ms(lambda: ops.stochastic_quantize(x, u, lv, ch)),
          time_ms(lambda: ops.stochastic_quantize(xp, up, lv, ch)),
          time_ms(lambda: quantize.plain(xp, up, lv, ch)),
          None, ops.launch_work("quantize", n, 1, q))
    old_q = torch.empty_like(x)
    if parent is not None:
        beside("quantize", lambda: ops.stochastic_quantize(x, u, lv, ch), lambda: parent.quantize(x, u, lv, ch, old_q))
    del old_q
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
          ops.launch_work("masked_combine", 1, n, q))
    if parent is not None:
        old_row = torch.empty((1, q), device="cuda")
        beside("masked_combine", lambda: ops.masked_combine(x, rw),
               lambda: parent.row_combine(x[None], rw[None], old_row))
        del old_row
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
          ops.launch_work("coded_combine", n, 2, q))
    out["coded_combine"]["shape"] = [n, 2, q]
    if parent is not None:
        old_rows = torch.empty((n, q), device="cuda")
        beside("coded_combine", lambda: ops.coded_combine(stack, cw), lambda: parent.row_combine(stack, cw, old_rows))
        del old_rows
    hold("coded_combine", ops.coded_combine(stack, cw)[:, q - PLAIN_Q:],
         ref.coded_combine_ref(stack[:, :, q - PLAIN_Q:].contiguous(), cw))
    return out


PARENT_GRID_Y = 65535  # the parent's CWTM and QSGD hold their lanes on the grid's y axis


class ParentKernels:
    """The parent tree's six kernel sources (``--parent DIR``, DIR holding
    its ``gather_combine.cu``, ``attack.cu``, ``cwtm.cu``, ``gram.cu``,
    ``quantize.cu``, ``row_combine.cu`` and ``tile.cuh``), built with the
    port's nvcc flags and called through the C entries they had at commit
    c93a085, as its wrappers called them: the encode and the attack with
    the tile widths of ``kernels/coded_combine.gather_tile`` and
    ``kernels/attacks.attack_tile``, the Gram with ``gram_plan`` and the row
    combine with ``row_plan`` (the plans of that commit, unchanged since),
    each in one launch; CWTM (the NNM mix fused into its sort) and QSGD
    65535 lanes a launch. Timed beside the tree's kernels; used nowhere
    else."""

    SIGNATURES = {"gather_combine": ("repro_gather_combine", ("p", "p", "p", "p", "i", "i", "i", "q", "i", "p")),
                  "attack": ("repro_attack", ("p", "p", "p", "i", "i", "q", "i", "f", "i", "p")),
                  "cwtm": ("repro_cwtm", ("p", "p", "i", "f", "p", "i", "i", "q", "i", "f", "p")),
                  "gram": ("repro_gram", ("p", "p", "p", "p", "i", "i", "q", "q", "i", "i", "i", "i", "i", "p")),
                  "quantize": ("repro_quantize", ("p", "p", "p", "i", "q", "q", "i", "p")),
                  "row_combine": ("repro_row_combine", ("p", "p", "p", "i", "i", "q", "i", "i", "p"))}
    MODES = {"sign_flip": 0, "alie": 1, "ipm": 2}

    def __init__(self, src_dir: Path, build):
        import ctypes

        types = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_int64, "f": ctypes.c_float}
        out_dir = ROOT / "build" / "chip_smoke" / "parent"
        out_dir.mkdir(parents=True, exist_ok=True)
        build.build_all()  # the tree's own kernels first: the parent's nvcc runs beside nothing else
        procs = {name: subprocess.Popen([build._nvcc(), *build._FLAGS, "-o", str(out_dir / f"lib{name}.so"),
                                         str(Path(src_dir) / f"{name}.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for name in self.SIGNATURES}
        self.fns, self.ptxas = {}, {}
        for name, proc in procs.items():
            log, _ = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"the parent's {name}.cu did not build:\n{log}")
            self.ptxas[name] = log
            symbol, argtypes = self.SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(out_dir / f"lib{name}.so")), symbol)
            fn.argtypes = [types[t] for t in argtypes]
            fn.restype = ctypes.c_int
            self.fns[name] = fn

    def _call(self, name: str, *args) -> None:
        err = self.fns[name](*args, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the parent's {name} failed: CUDA error {err}")

    def gather_combine(self, x: torch.Tensor, subsets: torch.Tensor, w: torch.Tensor, out: torch.Tensor):
        """x (L, N, Q), subsets (L, N, d) int32, w (L, d), out (L, N, Q)."""
        from repro_torch.kernels.coded_combine import gather_tile

        lanes, n, q = x.shape
        d = subsets.shape[-1]
        self._call("gather_combine", x.data_ptr(), subsets.data_ptr(), w.data_ptr(), out.data_ptr(), lanes, n, d, q,
                   gather_tile(lanes, n, q, d))
        return out

    def attack(self, x: torch.Tensor, mask: torch.Tensor, name: str, param: float, out: torch.Tensor):
        """x (L, N, Q), mask (L, N), out (L, N, Q)."""
        from repro_torch.kernels.attacks import attack_tile

        lanes, n, q = x.shape
        cols = 0 if name == "sign_flip" else attack_tile(lanes, n, q)
        self._call("attack", x.data_ptr(), mask.data_ptr(), out.data_ptr(), lanes, n, q, self.MODES[name],
                   float(param), cols)
        return out

    def cwtm(self, x: torch.Tensor, trim: int, table: torch.Tensor | None, out: torch.Tensor):
        """x (L, N, Q), table None or (L, N, k) int32, out (L, Q)."""
        lanes, n, q = x.shape
        k = 0 if table is None else table.shape[-1]
        for a in range(0, lanes, PARENT_GRID_Y):
            b = min(lanes, a + PARENT_GRID_Y)
            self._call("cwtm", x[a:b].data_ptr(), None if table is None else table[a:b].data_ptr(), k,
                       1.0 / k if k else 0.0, out[a:b].data_ptr(), b - a, n, q, trim, 1.0 / (n - 2 * trim))
        return out

    def gram(self, x: torch.Tensor):
        """x (L, N, Q) -> (gram (L, N, N), sq (L, N)), scratch and outputs
        allocated in the call, as the parent's wrapper did."""
        from repro_torch.kernels.nnm_dist import REG_MAX_N, gram_plan

        lanes, n, q = x.shape
        plan = gram_plan(lanes, n, q)
        scratch = plan.chunks > 1 or n <= REG_MAX_N
        partial = torch.empty(lanes * plan.chunks * (n * (n + 1) // 2) if scratch else 0, device=x.device)
        gram = torch.empty((lanes, n, n), device=x.device)
        sq = torch.empty((lanes, n), device=x.device)
        self._call("gram", x.data_ptr(), partial.data_ptr(), gram.data_ptr(), sq.data_ptr(), lanes, n, q,
                   plan.chunk_len, plan.chunks, plan.width, plan.stride, plan.pairs, plan.split)
        return gram, sq

    def quantize(self, g: torch.Tensor, u: torch.Tensor, levels: int, chunk: int, out: torch.Tensor):
        """g, u, out (rows, Q); blocks of min(chunk, Q)."""
        rows, q = g.shape
        for a in range(0, rows, PARENT_GRID_Y):
            b = min(rows, a + PARENT_GRID_Y)
            self._call("quantize", g[a:b].data_ptr(), u[a:b].data_ptr(), out[a:b].data_ptr(), b - a, q,
                       min(chunk, q), levels)
        return out

    def row_combine(self, x: torch.Tensor, w: torch.Tensor, out: torch.Tensor):
        """x (L, R, Q), w (L, R), out (L, Q)."""
        from repro_torch.kernels.coded_combine import row_aligned, row_plan

        lanes, r, q = x.shape
        groups, vec = row_plan(lanes, r, q, row_aligned(x, out))
        self._call("row_combine", x.data_ptr(), w.data_ptr(), out.data_ptr(), lanes, r, q, groups, int(vec == 4))
        return out


def flushed_ms(fn, flush: torch.Tensor, iters: int = MAIN_ITERS) -> float:
    """Median CUDA-event time of one call of ``fn`` after one warm-up call,
    the L2 flushed (``flush`` written) before each; the card is kept busy
    while the host enqueues the call, so the events time the card alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)  # about half a millisecond: more than a wrapper call takes to enqueue
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main_shape_timings(ops, ref, quantize, agg, hbm: float, fp32: float,
                       parent: ParentKernels | None = None) -> dict[str, dict]:
    """The trajectory kernels and the erasure decode's ``masked_combine`` at
    the main path's shapes: N=100, Q=100, at 1 and 1000 lanes (a
    trajectory; ``synthetic_sweep(1000)``), the L2 flushed before every
    timed launch (``flushed_ms``). Per kernel and lane count its ms, the
    plain version's, a library call's where one computes the same function,
    and ``launch_work``'s bound and what bounds it; every kernel beside the
    ``parent`` tree's (``parent_ms``: timed parent, kernel, kernel, parent;
    ``ms`` and ``parent_ms`` each the smaller median of its two runs); for
    CWTM, with and without NNM's mix (b = N // 5: k = 80 neighbours, trim
    10), ``torch.sort`` over the same stack (the sort alone) and, for
    CWTM-NNM, ``torch.bmm`` of the neighbour matrix then the CWTM kernel
    (the mix alone as a product, not bit for bit): yardsticks, not
    ``library_ms``; for QSGD its launches a call (1 at 100,000 rows) and
    the layout ``quantize.quant_plan`` picks. CWTM (with and without the
    mix) and QSGD are held bit for bit to their plain versions on the timed
    inputs at every lane count: the plans, and so the kernels, differ
    between 1 and 1,000 lanes."""
    from repro_torch.kernels import cwtm

    n, q, d, trim = MAIN_N, MAIN_Q, MAIN_D, MAIN_TRIM
    gen = torch.Generator(device="cuda").manual_seed(2)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    out = {name: {} for name in MAIN_SHAPE_KERNELS}

    def paired(kernel, old):
        """(ms, parent ms): parent, kernel, kernel, parent."""
        if old is None:
            return flushed_ms(kernel, flush), None
        first = flushed_ms(old, flush)
        ms = min(flushed_ms(kernel, flush), flushed_ms(kernel, flush))
        return ms, min(first, flushed_ms(old, flush))

    def row(name, lanes, kernel, plain, library, work, old=None, **extra):
        nbytes, nops = work
        bound_bytes, bound_ops = nbytes / hbm * 1e3, nops / fp32 * 1e3
        ms, parent_ms = paired(kernel, old)
        out[name][f"L{lanes}"] = {
            "ms": ms, "parent_ms": parent_ms, "plain_ms": flushed_ms(plain, flush),
            "library_ms": None if library is None else flushed_ms(library, flush),
            "bound_ms": max(bound_bytes, bound_ops), "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "bytes": nbytes, "operations": nops, **extra}

    for lanes in MAIN_LANES:
        x = torch.randn((lanes, n, q), generator=gen, device="cuda")
        rows = torch.arange(n, device="cuda")
        subsets = ((rows[:, None] + torch.arange(d, device="cuda")) % n).expand(lanes, n, d).contiguous()
        w = torch.full((d,), 1.0 / d, device="cuda")
        mix = torch.zeros((n, n), device="cuda").index_put_(
            (rows[:, None].expand(n, d), subsets[0]), w.expand(n, d), accumulate=True).expand(lanes, n, n).contiguous()
        old_out = torch.empty_like(x)
        # the parent as its wrapper ran it: the ids to int32 and the weights to (L, d) in the timed call
        row("gather_combine", lanes, lambda: ops.gather_combine(x, subsets, w),
            lambda: ref.gather_combine_ref(x, subsets, w), lambda: torch.bmm(mix, x),
            ops.launch_work("gather_combine", lanes, n, q, d=d),
            old=None if parent is None else (lambda: parent.gather_combine(
                x, subsets.to(torch.int32), w.expand(lanes, d).contiguous(), old_out)))
        mask = (rows < MAIN_BYZ).float().expand(lanes, n).contiguous()
        flip_ms, flip_parent_ms = paired(
            lambda: ops.attack(x, mask, "sign_flip", -2.0),
            None if parent is None else (lambda: parent.attack(x, mask, "sign_flip", -2.0, old_out)))
        row("attack", lanes, lambda: ops.attack(x, mask, "alie", 1.5), lambda: ref.attack_ref(x, mask, "alie", 1.5),
            None, ops.launch_work("attack", lanes, n, q),
            old=None if parent is None else (lambda: parent.attack(x, mask, "alie", 1.5, old_out)),
            sign_flip_ms=flip_ms, sign_flip_parent_ms=flip_parent_ms)
        # the erasure decode's weights: a mask times a class selection, exact zeros on most rows
        rw = ((torch.rand((lanes, n), generator=gen, device="cuda") < 0.5)
              * torch.rand((lanes, n), generator=gen, device="cuda"))
        old_row = torch.empty((lanes, q), device="cuda")
        row("masked_combine", lanes, lambda: ops.masked_combine(x, rw), lambda: ref.masked_combine_ref(x, rw),
            lambda: torch.bmm(rw[:, None, :], x), ops.launch_work("masked_combine", lanes, n, q),
            old=None if parent is None else (lambda: parent.row_combine(x, rw, old_row)))
        table = agg.nnm_neighbours(ops.pairwise_sqdist(x), MAIN_BYZ)
        k = table.shape[-1]
        table32, old_cw = table.to(torch.int32).contiguous(), torch.empty((lanes, q), device="cuda")
        row("cwtm", lanes, lambda: ops.cwtm(x, trim), lambda: ref.cwtm_ref(x, trim), None,
            ops.launch_work("cwtm", lanes, n, q, trim=trim),
            old=None if parent is None else (lambda: parent.cwtm(x, trim, None, old_cw)),
            sort_ms=flushed_ms(lambda: torch.sort(x, dim=-2), flush))
        # the yardstick: the mix as one batched product with the neighbour matrix (1/k at each of a row's
        # neighbours) in fp32, then the CWTM kernel without the mix; not the function bit for bit
        nbm = torch.zeros((lanes, n, n), device="cuda").scatter_(2, table.long(), 1.0 / k)
        mixed = {"trim": trim, "neighbours_k": k, "mix_plan": list(cwtm.mix_plan(lanes, n, q, k)),
                 "bmm_then_cwtm_ms": flushed_ms(lambda: ops.cwtm(torch.bmm(nbm, x), trim), flush)}
        row("cwtm", f"{lanes}_mix", lambda: ops.cwtm(x, trim, table),
            lambda: ref.cwtm_ref(ref.nnm_mix_ref(x, table), trim), None,
            ops.launch_work("cwtm", lanes, n, q, trim=trim, k=k),
            old=None if parent is None else (lambda: parent.cwtm(x, trim, table32, old_cw)), **mixed)
        for nb in (None, table):  # the timed calls' plans, bit for bit
            check(torch.equal(ops.cwtm(x, trim, nb), ref.cwtm_ref(x if nb is None else ref.nnm_mix_ref(x, nb), trim)),
                  f"CWTM{'' if nb is None else '-NNM'} at {lanes} lanes differs from its plain version")
        row("gram", lanes, lambda: ops.gram(x), lambda: ref.gram_ref(x), lambda: torch.bmm(x, x.transpose(1, 2)),
            ops.launch_work("gram", lanes, n, q), old=None if parent is None else (lambda: parent.gram(x)))
        g, u = x.reshape(lanes * n, q), torch.rand((lanes * n, q), generator=gen, device="cuda")
        old_q = torch.empty_like(g)
        before = ops.launch_counts()["quantize"]
        ops.stochastic_quantize(g, u, QUANT_LEVELS, QUANT_CHUNK)
        launches = ops.launch_counts()["quantize"] - before
        check(launches == 1, f"QSGD over {lanes * n} rows took {launches} launches")
        chunk = min(QUANT_CHUNK, q)
        row("quantize", lanes, lambda: ops.stochastic_quantize(g, u, QUANT_LEVELS, QUANT_CHUNK),
            lambda: quantize.plain(g, u, QUANT_LEVELS, chunk), None,
            ops.launch_work("quantize", lanes * n, 1, q),
            old=None if parent is None else (lambda: parent.quantize(g, u, QUANT_LEVELS, QUANT_CHUNK, old_q)),
            levels=QUANT_LEVELS, chunk=chunk, launches_a_call=launches,
            layout="warp" if quantize.quant_plan(lanes * n, q, chunk) else "block")
        check(torch.equal(ops.stochastic_quantize(g, u, QUANT_LEVELS, QUANT_CHUNK),
                          quantize.plain(g, u, QUANT_LEVELS, chunk)),
              f"QSGD over {lanes * n} rows differs from its plain version")
        del x, subsets, mix, mask, table, table32, old_cw, nbm, g, u, old_q, old_out, rw, old_row
    del flush
    return out


def section7_launches(section7_line: dict) -> dict[str, int]:
    """Each kernel's launches over the ``section7`` phase's replays: the
    captured round's launches times the rounds, summed over the 15 rows."""
    out = {name: 0 for name in MAIN_SHAPE_KERNELS}
    for captured in section7_line["captured_launches_per_round"].values():
        for name in out:
            out[name] += captured.get(name, 0) * section7_line["rounds"]
    return out


def grid_replays(S) -> dict[str, float]:
    """Replay ms a round of ``section7_grid()`` (5 buckets) and of
    ``synthetic_sweep(1000)`` at N=100, dim=100, each through ``run_grid``
    in graph mode for 200 rounds, summed over the buckets: the grid phase's
    ``section7`` and ``sweep1000_n100`` calls, without their bitwise checks."""
    out = {}
    for name, rows, dim in (("section7", S.section7_grid(), 100),
                            ("sweep1000_n100", S.synthetic_sweep(1000, n_devices=100, n_byz=20), 100)):
        res = S.run_grid(rows, STEPS, seed=0, dim=dim, device="cuda", mode="graph")
        buckets = {id(res[r.name].grid): res[r.name].grid for r in rows}.values()
        out[name] = sum(b.replay_ms() for b in buckets) / STEPS
    return out


def main_shape_line(timings: dict, section7_line: dict, grid_replay_ms: dict[str, float]) -> dict:
    """The ``main_shape`` line: the timings, each kernel's launches in the
    ``section7`` phase's replays, and the replay ms a round of
    ``section7_grid()`` (its 15 rows alone, summed; and as 5 grid buckets)
    and of ``synthetic_sweep(1000)`` at N=100."""
    launches = section7_launches(section7_line)
    return {"phase": "main_shape", "n": MAIN_N, "q": MAIN_Q, "lanes": list(MAIN_LANES), "l2_flushed": True,
            "kernels": {name: {"section7_replayed_launches": launches[name], **t} for name, t in timings.items()},
            "section7_rows_replay_ms_per_round_sum": sum(section7_line["replay_ms_per_round"].values()),
            "grid_replay_ms_per_round": grid_replay_ms}


# ---------------------------------------------------------------- trajectory


TRAJECTORY_KERNELS = ("gather_combine", "attack", "cwtm", "gram", "quantize")  # what the trainer rows reach
MAIN_SHAPE_KERNELS = TRAJECTORY_KERNELS + ("masked_combine",)  # and the erasure decode's, timed in main_shape


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
        lanes held to standalone runs; the same sweep under ``quant:4``
        (100,000 rows quantized in one launch, QSGD's warp layout), three
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
    rows = S.synthetic_sweep(1000, n_devices=100, n_byz=20, compressor="quant:4")
    sweep("sweep1000_n100_quant4", rows, 100, {0, len(rows) // 2, len(rows) - 1})
    check(out["calls"]["sweep1000_n100_quant4"]["buckets"][0]["captured_launches_per_round"].get("quantize") == 1,
          "the quant:4 sweep's round did not quantize its 100,000 rows in one launch")
    out["bitwise"] = True
    return out


# --------------------------------------------------------------------- tuner

TUNER_WIDE_ROUNDS = 2
# bytes the phase may leave allocated: its probes, captures and sweeps keep nothing (the sound runs on the
# H100 read the same bytes before and after), so only a small cache of the allocator's may stay
TUNER_MEM_SLACK = 4 << 20


def settled_allocation() -> int:
    """Bytes allocated once cyclic garbage is collected, cuBLAS's per-stream
    workspaces are dropped (where the build can) and the cache emptied."""
    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def tuner_phase(S, engine, tuner, roofline, archs, ops, tmp: Path, replayed: dict[str, int]) -> dict:
    """``max_lanes_per_device="auto"``, the tuner's store a fresh file
    under ``tmp`` for each part. (a) ``synthetic_sweep(1000, n_devices=100,
    n_byz=20)`` at dim=100, 200 rounds in graph mode: bit for bit the
    unchunked sweep, and a warm call that makes 0 probes with the same bits;
    the bound of the hand-written kernels of one captured round at the
    chosen capacity, and that bound as a share of the round's replay time
    (which also runs PyTorch's own kernels). (b)
    ``run_lm_grid`` on smollm-360m at full width: LAD d=2 CWTM (trim 2 a
    side) under sign-flip, ALIE and IPM in one bucket of 3 lanes, N=8, 2
    rounds in graph mode: bit for bit ``max_lanes_per_device=1``, a warm
    call that makes 0 probes (its peak memory is the chosen capacity's).
    The allocated memory after the phase is back at its level before it.
    Prints every probe's capacity and seconds a lane (``None``: out of
    memory) and the phase's launches; adds the replays of every sweep
    (not of the probes, whose results are dropped) to ``replayed``."""
    start = time.perf_counter()
    counts0 = ops.launch_counts()
    replayed0 = dict(replayed)
    out = {"phase": "tuner"}

    def fresh_store(name):
        path = tmp / name
        path.unlink(missing_ok=True)
        return tuner.set_store_path(str(path))

    def probes(store) -> tuple[int, dict]:
        (rec,) = store.data["lane_capacity"].values()  # one bucket, one signature
        return rec["capacity"], rec["per_lane_s"]

    def replays(results) -> None:
        for stats in {id(r.grid): r.grid for r in results.values()}.values():
            for g in stats.graphs:
                for k, v in g.captured_launches.items():
                    replayed[k] += v * g.replays

    # (a) the paper's width
    mem0 = settled_allocation()
    store = fresh_store("tuner_paper.json")
    rows = S.synthetic_sweep(1000, n_devices=100, n_byz=20)
    kw = dict(seed=0, dim=100, device="cuda", mode="graph")
    t0 = time.perf_counter()
    auto = S.run_grid(rows, STEPS, max_lanes_per_device="auto", **kw)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    info = engine.last_grid_chunk_info()
    stats = tuner.tuner_stats()
    capacity, per_lane = probes(store)
    check(info["auto"] and info["max_lanes_per_device"] == capacity, f"tuner (a): chunk info {info}")
    check(stats["probes"] == len(per_lane) and stats["misses"] == 1, f"tuner (a): stats {stats}")
    whole = S.run_grid(rows, STEPS, max_lanes_per_device=None, **kw)
    for row in rows:
        lanes_equal(auto[row.name], whole[row.name], f"{row.name} auto")
    replays(auto)
    replays(whole)
    del auto
    tuner.reset_tuner_stats()
    t0 = time.perf_counter()
    warm = S.run_grid(rows, STEPS, max_lanes_per_device="auto", **kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(tuner.tuner_stats()["probes"] == 0, f"tuner (a): the warm call probed: {tuner.tuner_stats()}")
    for row in rows:
        lanes_equal(warm[row.name], whole[row.name], f"{row.name} warm auto")
    replays(warm)
    stats_w = warm[rows[0].name].grid
    replay_s = stats_w.replay_ms() / 1e3
    work = S.grid_launch_list(rows, STEPS, max_lanes_per_device="auto", **kw)
    roof = roofline.analyze_launches(work, "cuda")
    first = stats_w.graphs[0]
    check({k: len(v) for k, v in work.items()} == {k: first.captured_launches[k] for k in work},
          f"tuner (a): launch list {[(k, len(v)) for k, v in work.items()]} vs {first.captured_launches}")
    del warm, whole
    out["paper"] = {"rows": len(rows), "n_devices": 100, "dim": 100, "rounds": STEPS, "capacity": capacity,
                    "chunks": stats_w.chunks, "probes": stats["probes"], "per_lane_s": per_lane,
                    "cold_call_s": cold_s, "warm_call_s": warm_s, "warm_probes": 0, "bitwise": True,
                    "round_launches": roof["launches"], "round_bound_ms": roof["predicted_s"] * 1e3,
                    "round_bound_by": roof["dominant"],
                    "replay_ms_per_round": replay_s * 1e3 / STEPS,
                    "kernel_bound_share_of_round": roofline.percent_of_peak(roof, replay_s, calls=STEPS * stats_w.chunks)}

    # (b) smollm-360m at full width
    mem_a = settled_allocation()
    store = fresh_store("tuner_wide.json")
    arch = archs.ARCHS["smollm-360m"]
    rows = S.lm_sweep((("lad", 2),), compressors=("none",), n_devices=WIDE_N, n_byz=2, trim_frac=0.25)
    check(len(rows) == 3 and len({S._bucket_signature(r) for r in rows}) == 1, "tuner (b): not one bucket of 3")
    kw = dict(arch=arch, seed=0, per_subset=2, seq_len=16, device="cuda", mode="graph")
    def on_host(results) -> dict:
        """Each lane's final iterate and metrics on the host: a card holds
        one full-width result at a time."""
        replays(results)
        return {name: (r.x.cpu(), {k: v.cpu() for k, v in r.metrics.items()}) for name, r in results.items()}

    def host_equal(a, b, what) -> None:
        for name, (x, metrics) in b.items():
            check(torch.equal(a[name][0], x) and all(torch.equal(a[name][1][k], v) for k, v in metrics.items()),
                  f"tuner (b): {name} {what} differs")

    t0 = time.perf_counter()
    auto = on_host(S.run_lm_grid(rows, TUNER_WIDE_ROUNDS, max_lanes_per_device="auto", **kw))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    stats = tuner.tuner_stats()
    capacity, per_lane = probes(store)
    check(engine.last_grid_chunk_info()["auto"], "tuner (b): not an auto call")
    check(stats["probes"] == len(per_lane), f"tuner (b): stats {stats}")
    torch.cuda.empty_cache()
    one = on_host(S.run_lm_grid(rows, TUNER_WIDE_ROUNDS, max_lanes_per_device=1, **kw))
    host_equal(auto, one, "auto against max_lanes_per_device=1")
    for name, (_, metrics) in one.items():
        loss = metrics["loss"]
        check(loss.shape == (TUNER_WIDE_ROUNDS,) and bool(torch.isfinite(loss).all()), f"{name}: bad loss")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tuner.reset_tuner_stats()
    t0 = time.perf_counter()
    warm = on_host(S.run_lm_grid(rows, TUNER_WIDE_ROUNDS, max_lanes_per_device="auto", **kw))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(tuner.tuner_stats()["probes"] == 0, f"tuner (b): the warm call probed: {tuner.tuner_stats()}")
    host_equal(warm, one, "warm auto against max_lanes_per_device=1")
    losses = {name: metrics["loss"].tolist() for name, (_, metrics) in one.items()}
    del auto, one, warm
    mem1 = settled_allocation()
    check(mem1 <= mem0 + TUNER_MEM_SLACK,
          f"tuner: {mem1} bytes allocated after the phase ({mem_a} after part (a)), {mem0} before")
    out["wide"] = {"arch": arch.name, "params": WIDE_Q, "lanes": len(rows), "n_devices": WIDE_N, "d": 2,
                   "rounds": TUNER_WIDE_ROUNDS, "capacity": capacity, "probes": stats["probes"],
                   "per_lane_s": per_lane, "cold_call_s": cold_s, "warm_call_s": warm_s, "warm_probes": 0,
                   "bitwise": True, "peak_gb_at_capacity": peak_gb, "loss": losses}
    out["allocated"] = {"before": mem0, "after_paper": mem_a, "after": mem1}
    counts = ops.launch_counts()
    out["launches"] = {k: counts[k] - counts0[k] for k in counts}
    out["replayed_launches"] = {k: replayed[k] - replayed0[k] for k in replayed}
    out["phase_s"] = time.perf_counter() - start
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


# ------------------------------------------------------------- protomath_tp

TP_WORLD, TP_MODEL = 4, 2  # data 2 x model 2 on the one card
TP_N = 4  # (a)'s logical devices: 2 blocks a data rank
TP_STEPS = 3
TP_TIMEOUT_S = 300.0  # the four ranks, start-up included
TP_WIDE_LOSS_RTOL = 1e-3  # (b)'s first loss, bf16, against the one-process step: set in PERF.md before the first run


TP_FAMILY_SETUP = "cwtm-alie"  # (c)'s setup of PROTOMATH_SETUPS, under both servers
TP_MOE = ("granite-moe-3b-a800m", {"n_layers": 2}, 352_461_312)  # (d): cut to 2 layers as zoo_wide cuts it


def tp_arch(scenarios):
    """``lm_arch()`` with 4 heads over 2 kv heads: every weight but the
    norms cut over 2 model ranks."""
    return scenarios.lm_arch().scaled(n_heads=4, n_kv_heads=2)


def tp_families(scenarios) -> dict:
    """(c)'s archs: every family the model axis cuts, at ``zoo_arch``
    widths in fp32."""
    out = {"lm": scenarios.lm_arch()}
    out.update({fam: scenarios.zoo_arch(fam) for fam in ("moe", "jamba", "rwkv", "cross", "audio")})
    out["head_dim"] = scenarios.lm_arch().scaled(attn_tp="head_dim")
    return out


def tp_family_batches(synthetic, arch) -> list[dict]:
    """(c)'s batches: 1 row of 16 tokens a block, a seeded ``frontend``
    where the family takes one."""
    batches = train_batches(synthetic, arch, TP_N, 1, TP_STEPS)
    return with_frontend(arch, batches, seed=7) if arch.encoder is not None else batches


def tp_wide_rank(T, protomath, models, pytree, synthetic, wide, wmesh, counted, rank: int) -> dict:
    """One rank's wide run over data 2 x model 2 (``protomath_wide``'s
    settings, N=8): its stored bytes, an untimed first step, then
    ``TP_STEPS`` timed steps (card and wall ms), peak memory and the
    exchanges a step."""
    from repro_torch.models.module import tree_bytes

    tcfg = tp_wide_tcfg(T, wide)
    whole0, wspecs = models.init(torch.Generator().manual_seed(0), wide)
    step, opt = T.build_train_step(wide, tcfg, wspecs, mesh=wmesh, device="cuda")
    params = pytree.map_tree(lambda a: a.to("cuda"), T.shard_tree(whole0, step.placements, wmesh))
    whole_bytes = tree_bytes(whole0)
    n_params = sum(a.numel() for a in pytree.leaves(whole0))
    del whole0
    state = opt.init(params)
    moments = tree_bytes(state.mu) + tree_bytes(state.nu)
    line = {"param_bytes": tree_bytes(params), "param_bytes_whole": whole_bytes, "moment_bytes": moments,
            "moment_bytes_whole": 2 * n_params * 2, "n_local": wmesh.local_devices}
    batches = train_batches(synthetic, wide, WIDE_N, 2, 1 + TP_STEPS)
    params, state, loss, _ = counted(lambda: step(params, state, batches[0], 0))  # the first step, untimed
    line["first_loss"] = float(loss)
    torch.cuda.reset_peak_memory_stats()
    protomath.reset_exchange_counts()
    rows, losses = [], []
    for i, b in enumerate(batches[1:], start=1):
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev[0].record()
        params, state, loss, _ = counted(lambda: step(params, state, b, i))
        ev[1].record()
        ev[1].synchronize()
        rows.append({"card_ms": ev[0].elapsed_time(ev[1]), "wall_ms": (time.perf_counter() - t0) * 1e3})
        losses.append(float(loss))
    check(all(map(math.isfinite, losses)), f"protomath_tp rank {rank} {wide.name}: a loss is not finite")
    ex = protomath.exchange_counts()
    line.update(steps=rows, loss=losses, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                exchanges_a_step={k: v // TP_STEPS for k, v in ex.items()})
    del params, state
    torch.cuda.empty_cache()
    return line


def tp_exchange_vs_plain(T, protomath, tcfg, wmesh, shape, w_spec, cut, rank: int) -> float:
    """One exchange of this rank's ``(n_local, *shape)`` tp slice through
    the kernels against the same exchange on the CPU (the plain versions):
    the largest error as a share of the allowance; fails past it."""
    protocol = T.make_protocol(tcfg, wmesh)
    gen = torch.Generator(device="cuda").manual_seed(13 + rank)
    block = torch.randn((wmesh.local_devices,) + shape, generator=gen, device="cuda") * 1e-3

    def combine(x):
        return protomath.robust_combine(protocol, x, w_spec, seed=5, group=wmesh.group,
                                        model_group=wmesh.model_group, cut=cut)

    got, want = combine(block).cpu(), combine(block.cpu())
    atol = ATOL * float(want.abs().max())
    check(torch.allclose(got, want, rtol=RTOL, atol=atol),
          f"protomath_tp rank {rank}: an exchange of a {shape} tp slice disagrees with its plain version")
    return float(((got - want).abs() / (atol + RTOL * want.abs())).max())


def tp_wide_tcfg(T, arch):
    """``protomath_wide``'s settings: AdamW with bf16 moments, LAD d=2, 2
    Byzantine of N=8, CWTM trim 0.25 under ALIE, the sharded server."""
    return T.TrainConfig(arch=arch.name, protocol="lad", protocol_impl="protomath", d=2, aggregator="cwtm",
                         trim_frac=0.25, n_byz=2, attack="alie")


TP_SERVE_STEPS = {"decode_32k": 4, "long_500k": 8}  # timed fed steps, after an untimed first one
TP_PREFILL = (4, 1024, 8)  # (e)'s prefill: batch and prompt cut from prefill_32k's 32 x 32,768; tokens decoded
TP_SERVE_CACHE_BYTES = 10_737_418_240  # a rank's cut of decode_32k's 42,949,672,960 cache bytes over 2 x 2
TP_SERVE_CONFORMANCE = 5e-2  # tests/test_torch_serving.py's CONFORMANCE: rtol and atol against one process


def tp_serve_inputs(arch, key: str, b: int, t: int):
    """(e)'s tokens (b, t) int32 (and a frontend where the family takes
    one), from a seed of its own, on the CPU: the same on every rank and in
    the one-process check."""
    return serve_inputs(arch, 17 + len(key), b, t)


def tp_serve_rank(models, pytree, archs, base, serve, protomath, T, mesh, work: Path, rank: int) -> dict:
    """Part (e) on one rank of the 2 x 2 mesh: sharded serving through the
    user's entry points (``serve.serve_traffic(mesh=)``, and
    ``build_decode_fn``/``build_prefill_fn`` on a ``serving_shard``), each
    rank holding its ``param_pspecs`` cut of the weights (the data cut
    gathered once) and its ``decode_state_pspecs`` cut of the state:

      * smollm-360m ``decode_32k`` (batch 128, 8,192 slots) and
        ``long_500k`` (batch 1, 524,288 filled) on a state born cut and
        filled by ``refill``'s keyed rule: ``TP_SERVE_STEPS`` timed steps
        after an untimed one, teacher-forced with seeded tokens;
      * ``TP_PREFILL``: a 1,024-token prompt at batch 4 through
        ``serve_traffic(mesh=)`` (8 tokens), and its prefill's logits;
      * whisper-small whole: ``serve_wide`` (e)'s traffic through
        ``serve_traffic(mesh=)``, and its prefill's logits.

    Writes each step's logits (this rank's rows and vocabulary slice) and
    greedy tokens to ``serve_rank{rank}.npz``; returns card ms a step, the
    state's bytes against its placement, peak GB and collectives a step."""
    from repro_torch.models import serving
    from repro_torch.models.module import tree_bytes

    arrays, line = {}, {}

    def placed_bytes(shard) -> int:
        return sum(t.numel() // math.prod(shard.along(e)[0] for e in pl) * t.element_size()
                   for (_, t), pl in zip(pytree.paths(shard.state_shapes), state_placements(shard.state)))

    def cache_bytes(state) -> int:
        return sum(getattr(c, f).numel() * getattr(c, f).element_size() for n, c in state.items() if n != "pos"
                   for f in ("k", "v"))

    arch = archs.ARCHS["smollm-360m"]
    whole0, specs = models.init(torch.Generator().manual_seed(0), arch)
    params = pytree.map_tree(lambda a: a.to("cuda"), T.shard_tree(whole0, T.param_pspecs(specs, mesh, whole0), mesh))
    del whole0
    local = serve.serving_params(params, specs, arch, mesh)  # the data cut gathered once
    line["smollm_param_bytes"], line["smollm_serving_param_bytes"] = tree_bytes(params), tree_bytes(local)
    for key, steps in TP_SERVE_STEPS.items():
        shape = base.INPUT_SHAPES[key]
        b, filled = shape.global_batch, shape.seq_len
        shard = serve.serving_shard(arch, b, filled, mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = serve.init_state_cut(arch, b, filled, mesh, device="cuda")
        refill(state, filled, 11, shard)
        fed = tp_serve_inputs(arch, key, b, steps + 1)[0].cuda()
        n = b // mesh.world if shard.batch_cut else b
        rows = slice(mesh.rank * n, (mesh.rank + 1) * n) if shard.batch_cut else slice(None)
        decode = serve.build_decode_fn(arch, specs, shard)
        ms = []
        for t in range(steps + 1):
            if t == 0:
                protomath.reset_collective_counts()
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
            logits, state = decode(local, fed[rows, t:t + 1], state)
            tok = serving.greedy_token(logits, arch, shard)
            ev[1].record()
            ev[1].synchronize()
            if t == 0:
                coll = protomath.collective_counts()
            else:
                ms.append(ev[0].elapsed_time(ev[1]))
            arrays[f"{key}/logits{t}"] = logits.float().cpu().numpy()
            arrays[f"{key}/tokens{t}"] = tok.cpu().numpy()
        check(int(state["pos"]) == filled + steps + 1, f"protomath_tp (e) {key}: pos did not advance")
        line[key] = {"batch": b, "filled": filled, "rows": n, "card_ms": ms, "peak_gb":
                     torch.cuda.max_memory_allocated() / 1e9, "cache_bytes": cache_bytes(state),
                     "state_bytes": sum(v.numel() * v.element_size() for _, v in pytree.paths(state)),
                     "state_bytes_placed": placed_bytes(shard), "collectives_a_step": coll,
                     "slots_a_rank": state["blk0"].k.shape[2], "cut": state_cut_line(shard)}
        del state, logits
    del local

    def traffic(key, arch_, params_, specs_, tokens, frontend, new):
        b, s = tokens.shape
        shard = serve.serving_shard(arch_, b, s, mesh, capacity=s + new)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        protomath.reset_collective_counts()
        res = serve.serve_traffic(arch_, params_, specs_, tokens, frontend=frontend, new_tokens=new, mode="loop",
                                  device="cuda", mesh=mesh)
        coll = protomath.collective_counts()
        n = b // mesh.world if shard.batch_cut else b
        rows = slice(mesh.rank * n, (mesh.rank + 1) * n) if shard.batch_cut else slice(None)
        logits, _ = serve.build_prefill_fn(arch_, specs_, capacity=s + new, shard=shard)(
            serve.serving_params(params_, specs_, arch_, mesh), tokens[rows].cuda(),
            None if frontend is None else frontend[rows].cuda())
        arrays[f"{key}/prefill_logits"] = logits.float().cpu().numpy()
        arrays[f"{key}/prefill_token"] = serving.greedy_token(logits, arch_, shard).cpu().numpy()  # its rows'
        arrays[f"{key}/tokens"] = res["tokens"].cpu().numpy()
        line[key] = {"batch": b, "prompt": s, "decoded": new, "rows": n, "prefill_ms": res["prefill_s"] * 1e3,
                     "decode_ms_per_token": res["decode_s"] * 1e3 / new, "peak_gb": torch.cuda.max_memory_allocated()
                     / 1e9, "state_bytes": sum(v.numel() * v.element_size() for _, v in pytree.paths(res["state"])),
                     "state_bytes_placed": placed_bytes(shard),
                     "collectives_serve_traffic": coll, "cut": state_cut_line(shard)}

    b, s, new = TP_PREFILL
    tokens = tp_serve_inputs(arch, "prefill", b, s)[0]
    traffic("prefill_1024", arch, params, specs, tokens, None, new)
    del params
    arch = archs.ARCHS["whisper-small"]
    whole0, specs = models.init(torch.Generator().manual_seed(0), arch)
    params = pytree.map_tree(lambda a: a.to("cuda"), T.shard_tree(whole0, T.param_pspecs(specs, mesh, whole0), mesh))
    del whole0
    tokens, frontend = serve_inputs(arch, 6, WHISPER_BATCH, WHISPER_PROMPT)
    traffic("whisper_small", arch, params, specs, tokens, frontend, WHISPER_DECODE)
    del params
    torch.cuda.empty_cache()
    np.savez(work / f"serve_rank{rank}.npz", **arrays)
    return line


def state_placements(tree) -> list[tuple]:
    """The placement tuples of a ``decode_state_pspecs`` tree, in
    ``pytree.paths``' order of the state."""
    out = []
    for name in sorted(tree):
        if name == "pos":
            out.append(tree[name])
        else:
            out.extend(getattr(tree[name], f.name) for f in dataclasses.fields(tree[name]))
    return out


def state_cut_line(shard) -> dict:
    """Each cache field's placement of a serving shard's first block."""
    blk = shard.state["blk0"]
    return {f.name: list(getattr(blk, f.name)) for f in dataclasses.fields(blk)}


def tp_serve_check(models, pytree, archs, base, serve, work: Path, lines: list[dict]) -> dict:
    """Part (e) against one process on the card, after the ranks exited
    (never the whole 42.95 GB state and the four cuts at once): every
    step's logits, joined over the ranks (rows over data, vocabulary over
    model), within ``TP_SERVE_CONFORMANCE`` (rtol and atol 5e-2) of the
    one-process step on the same inputs; each rank's greedy tokens equal to
    the one-process argmax wherever its top-two margin exceeds 5e-2, or
    twice the row's largest measured logit difference where the ranks'
    logits are recorded (``serve_traffic``'s tokens teacher-forced with the
    ranks' own, the prefill's token first); each rank's ``decode_32k`` cache
    ``TP_SERVE_CACHE_BYTES`` and every state its placement's bytes."""
    ranks = [dict(np.load(work / f"serve_rank{r}.npz")) for r in range(TP_WORLD)]
    bound = TP_SERVE_CONFORMANCE
    out = {"conformance": bound}

    def joined(key: str, want: torch.Tensor) -> torch.Tensor:
        """The whole (B, V) of the ranks' cuts (rank = 2 * data rank + model
        rank): the vocabulary over the model ranks, the rows over the data
        ranks, where each is cut."""
        parts = [torch.from_numpy(r[key]) for r in ranks]
        cut = parts[0].shape[-1] < want.shape[-1]
        rows = [torch.cat(parts[2 * d:2 * d + 2], -1) if cut else parts[2 * d] for d in range(2)]
        return torch.cat(rows, 0) if rows[0].shape[0] < want.shape[0] else rows[0]

    def margins_hold(want: torch.Tensor, tok: torch.Tensor, got: torch.Tensor | None = None) -> tuple[int, int]:
        """(rows whose top-two margin exceeds the bound, or twice the row's
        largest difference from the ranks' logits ``got`` where given (then
        no order of the sums can move the argmax), and of them those whose
        token is not the one-process argmax)."""
        want = want.float().cpu()
        top = torch.topk(want, 2, dim=-1).values
        gap = torch.full_like(top[:, 0], bound) if got is None else torch.minimum(
            torch.full_like(top[:, 0], bound), 2 * (got - want).abs().amax(dim=-1))
        clear = (top[:, 0] - top[:, 1]) > gap
        return int(clear.sum()), int((clear & (torch.argmax(want, dim=-1).to(torch.int32) != tok)).sum())

    for ln in lines:
        for key in ("decode_32k", "long_500k", "prefill_1024", "whisper_small"):
            e = ln["e"][key]
            check(e["state_bytes"] == e["state_bytes_placed"],
                  f"protomath_tp (e) {key} rank {ln['rank']}: {e['state_bytes']} state bytes, placed "
                  f"{e['state_bytes_placed']}")
        check(ln["e"]["decode_32k"]["cache_bytes"] == TP_SERVE_CACHE_BYTES,
              f"protomath_tp (e) decode_32k rank {ln['rank']}: {ln['e']['decode_32k']['cache_bytes']} cache bytes")
    arch = archs.ARCHS["smollm-360m"]
    params, specs = models.init(torch.Generator().manual_seed(0), arch)
    params = pytree.map_tree(lambda a: a.to("cuda"), params)
    decode = serve.build_decode_fn(arch, specs)
    for key, steps in TP_SERVE_STEPS.items():
        shape = base.INPUT_SHAPES[key]
        b, filled = shape.global_batch, shape.seq_len
        state = models.init_decode_state(arch, b, filled, device="cuda")
        refill(state, filled, 11)
        fed = tp_serve_inputs(arch, key, b, steps + 1)[0].cuda()
        shares, clear, wrong = [], 0, 0
        for t in range(steps + 1):
            want, state = decode(params, fed[:, t:t + 1], state)
            got = joined(f"{key}/logits{t}", want)
            shares.append(bound_share(got, want.cpu(), bound, bound))
            tok = torch.cat([torch.from_numpy(ranks[2 * d][f"{key}/tokens{t}"]) for d in range(2)])[:b, 0]
            c, w = margins_hold(want, tok, got)
            clear, wrong = clear + c, wrong + w
        check(max(shares) <= 1.0, f"protomath_tp (e) {key}: logits {max(shares):.3g} of the bound from one process")
        check(wrong == 0, f"protomath_tp (e) {key}: {wrong} of {clear} clear tokens differ from one process")
        out[key] = {"allowance_share": shares, "clear_tokens": clear, "tokens_differing": wrong}
        del state
        torch.cuda.empty_cache()
    for key, arch_ in (("prefill_1024", arch), ("whisper_small", archs.ARCHS["whisper-small"])):
        if key == "whisper_small":
            del params
            params, specs = models.init(torch.Generator().manual_seed(0), arch_)
            params = pytree.map_tree(lambda a: a.to("cuda"), params)
            tokens, frontend = serve_inputs(arch_, 6, WHISPER_BATCH, WHISPER_PROMPT)
            frontend = frontend.cuda()
        else:
            b, s, _ = TP_PREFILL
            tokens, frontend = tp_serve_inputs(arch_, "prefill", b, s)[0], None
        got = ranks[0][f"{key}/tokens"]
        check(all(np.array_equal(r[f"{key}/tokens"], got) for r in ranks), f"protomath_tp (e) {key}: ranks differ")
        got = torch.from_numpy(got)
        s, new = tokens.shape[1], got.shape[1]
        want, state = models.prefill(params, specs, arch_, tokens.cuda(), frontend=frontend, capacity=s + new)
        got_logits = joined(f"{key}/prefill_logits", want)
        shares = [bound_share(got_logits, want.cpu(), bound, bound)]
        # teacher-forced with the ranks' tokens: the prefill's, then each step's (serve_traffic's columns)
        fed = torch.cat([torch.from_numpy(ranks[2 * d][f"{key}/prefill_token"]) for d in range(2)])[:tokens.shape[0]]
        clear, wrong = margins_hold(want, fed[:, 0], got_logits)
        for t in range(new):
            want, state = models.decode_step(params, specs, arch_, fed.cuda(), state)
            c, w = margins_hold(want, got[:, t])
            clear, wrong = clear + c, wrong + w
            fed = got[:, t:t + 1]
        check(shares[0] <= 1.0, f"protomath_tp (e) {key}: prefill logits {shares[0]:.3g} of the bound")
        check(wrong == 0, f"protomath_tp (e) {key}: {wrong} of {clear} clear tokens differ from one process")
        out[key] = {"prefill_allowance_share": shares[0], "clear_tokens": clear, "tokens_differing": wrong}
        if key == "prefill_1024":  # both cuts of the published shape
            shape = base.INPUT_SHAPES["prefill_32k"]
            out[key]["cut_from"] = {"shape": shape.name, "batch": [shape.global_batch, tokens.shape[0]],
                                    "seq_len": [shape.seq_len, s]}
        del state
    del params
    torch.cuda.empty_cache()
    out["ranks"] = [{"rank": ln["rank"], "data_rank": ln["data_rank"], "model_rank": ln["model_rank"], **ln["e"]}
                    for ln in lines]
    return out


def tp_rank(out: Path, rank: int) -> int:
    """One rank of ``protomath_tp_phase``: a fresh interpreter on the card,
    joined to the others over a ``gloo`` group (NCCL refuses two ranks on
    one card) through a file under ``out``. Writes ``rank{rank}.json``
    (its line) and ``rank{rank}.npz`` ((a)'s and (c)'s losses and
    gathered parameters)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import models, pytree
    from repro_torch.configs import archs
    from repro_torch.core import protomath, scenarios
    from repro_torch.core.coding import flatten_pytree
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.configs import base
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve
    from repro_torch.launch import train as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.distributed.init_process_group("gloo", init_method=f"file://{out / 'rendezvous'}", world_size=TP_WORLD,
                                         rank=rank)
    try:
        mesh = mesh_lib.make_host_mesh(TP_N, TP_MODEL)
        line = {"rank": rank, "data_rank": mesh.rank, "model_rank": mesh.model_rank, "a": {}}
        arrays = {}
        path_launches = dict.fromkeys(ops.KERNELS, 0)

        def counted(fn):
            before = ops.launch_counts()
            result = fn()
            torch.cuda.synchronize()
            for k, v in ops.launch_counts().items():
                path_launches[k] += v - before[k]
            return result

        started = time.perf_counter()

        def part_done(part: str) -> None:  # each part's seconds, in the line and on stderr as it goes
            line[f"{part}_s"] = time.perf_counter() - started - sum(v for k, v in line.items() if k.endswith("_s"))
            print(f"protomath_tp rank {rank}: ({part}) done, {line[f'{part}_s']:.1f} s", file=sys.stderr, flush=True)

        # (a) fp32 parity at lm_arch() with cut heads
        arch = tp_arch(scenarios)
        params0, specs = models.init(torch.Generator().manual_seed(0), arch)
        batches = train_batches(synthetic, arch, TP_N, 1, TP_STEPS)
        for name, kw in PROTOMATH_SETUPS.items():
            for server in ("sharded", "gather"):
                step, opt = T.build_train_step(arch, protomath_tcfg(T, arch, server=server, **kw), specs, mesh=mesh,
                                               device="cuda")
                p = pytree.map_tree(lambda a: a.to("cuda"), T.shard_tree(params0, step.placements, mesh))
                params, _, losses = counted(lambda: drive(step, p, opt.init(p), batches))
                whole = T.gather_tree(params, step.placements, mesh)
                arrays[f"{name}/{server}/loss"] = losses.cpu().numpy()
                arrays[f"{name}/{server}/params"] = flatten_pytree(pytree.map_tree(lambda a: a.cpu(), whole))[0].numpy()

        part_done("a")

        # (b) smollm-360m at its published widths, depth and dtype
        wide = archs.ARCHS["smollm-360m"]
        wmesh = dataclasses.replace(mesh, data=WIDE_N)
        line["b"] = tp_wide_rank(T, protomath, models, pytree, synthetic, wide, wmesh, counted, rank)
        # one exchange of a tp slice (w_gate's: (960, 2560 / 2)) through the kernels against the plain versions
        line["b"]["exchange_vs_plain_share"] = tp_exchange_vs_plain(
            T, protomath, tp_wide_tcfg(T, wide), wmesh, (960, 2560 // TP_MODEL), ("fsdp", "tp"), (None, "model"),
            rank)

        part_done("b")

        # (c) every family the model axis cuts, fp32 parity against the one-process run
        for fam, farch in tp_families(scenarios).items():
            fparams0, fspecs = models.init(torch.Generator().manual_seed(0), farch)
            fbatches = tp_family_batches(synthetic, farch)
            for server in ("sharded", "gather"):
                step, opt = T.build_train_step(farch, protomath_tcfg(T, farch, server=server,
                                                                      **PROTOMATH_SETUPS[TP_FAMILY_SETUP]),
                                               fspecs, mesh=mesh, device="cuda")
                p = pytree.map_tree(lambda a: a.to("cuda"), T.shard_tree(fparams0, step.placements, mesh))
                params, _, losses = counted(lambda: drive(step, p, opt.init(p), fbatches))
                whole = T.gather_tree(params, step.placements, mesh)
                arrays[f"c/{fam}/{server}/loss"] = losses.cpu().numpy()
                arrays[f"c/{fam}/{server}/params"] = flatten_pytree(pytree.map_tree(lambda a: a.cpu(),
                                                                                    whole))[0].numpy()

        part_done("c")

        # (d) granite-moe-3b-a800m at its published widths, 2 layers, bf16: experts cut over the model ranks
        moe_name, cut, _ = TP_MOE
        moe_arch = archs.ARCHS[moe_name].scaled(**cut)
        line["d"] = tp_wide_rank(T, protomath, models, pytree, synthetic, moe_arch, wmesh, counted, rank)
        e, dm, ff = moe_arch.moe.n_experts, moe_arch.d_model, moe_arch.moe.d_ff_expert
        # one exchange of an expert slice (w_gate's: this rank's 20 of 40 experts) against the plain versions
        line["d"]["exchange_vs_plain_share"] = tp_exchange_vs_plain(
            T, protomath, tp_wide_tcfg(T, moe_arch), wmesh, (e // TP_MODEL, dm, ff), ("tp", "fsdp", None),
            ("model", "data", None), rank)
        part_done("d")

        # (e) sharded serving: smollm-360m at decode_32k, long_500k and a cut prefill_32k; whisper-small whole
        line["e"] = tp_serve_rank(models, pytree, archs, base, serve, protomath, T, mesh, out, rank)
        part_done("e")
        line["launches"] = path_launches
        np.savez(out / f"rank{rank}.npz", **arrays)
        (out / f"rank{rank}.json").write_text(json.dumps(line))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def protomath_tp_phase(T, mesh_lib, models, pytree, synthetic, scenarios, archs, base, serve, tmp: Path) -> dict:
    """The ``"protomath"`` step over data 2 x model 2: four fresh
    interpreters on the one card (``tp_rank``; never a fork of this
    process, which holds the card), one ``gloo`` group, each with its
    share of the host's cores and ``TP_TIMEOUT_S``; every collective of
    the step runs on the CUDA tensors (gloo's CUDA path, no host staging).

      (a) ``tp_arch()`` in fp32, N=4, 3 steps, each of
          ``PROTOMATH_SETUPS`` under both servers: losses within relative
          ``TRAIN_RTOL`` of the same steps in this process at model 1 on
          the card, ``sharded`` bit for bit ``gather``, the gathered
          parameters equal on every rank;
      (b) smollm-360m at full width in bf16 (``protomath_wide``'s
          settings), N=8, 3 steps after an untimed first step: each
          rank's param and moment bytes against the whole, peak GB, card
          ms a step, exchanges and kernel launches; the first step's loss
          within ``TP_WIDE_LOSS_RTOL`` of this process's model-1 step; one
          exchange of a tp slice against the plain versions;
      (c) every family of ``tp_families`` in fp32, N=4, 3 steps of
          ``TP_FAMILY_SETUP`` under both servers: losses within
          ``TRAIN_RTOL`` of the same steps in this process at model 1,
          ``sharded`` bit for bit ``gather``, the ranks equal;
      (d) ``TP_MOE`` (granite-moe-3b-a800m, 2 layers, bf16) as (b), its
          exchange of an expert slice (``w_gate``'s) against the plain
          versions;
      (e) sharded serving (``tp_serve_rank``): smollm-360m at its
          published widths in bf16 at ``decode_32k`` (each rank
          ``TP_SERVE_CACHE_BYTES`` of cache: the batch over data, the slots
          over model, the flash-decode cut), ``long_500k`` (the slots over
          data), a 1,024-token prompt at batch 4 (``prefill_32k`` cut in
          sequence and batch) and whisper-small whole (its heads and the
          cross cache's cut over model), held after the ranks exit against
          this process on the card (``tp_serve_check``).

    Every kernel of ``PROTOMATH_KERNELS`` must launch on some rank."""
    out = {"phase": "protomath_tp", "ranks": TP_WORLD, "data": TP_WORLD // TP_MODEL, "model": TP_MODEL,
           "backend": "gloo", "host_staged_collectives": [], "steps": TP_STEPS}
    arch = tp_arch(scenarios)
    params0, specs = models.init(torch.Generator().manual_seed(0), arch)
    batches = train_batches(synthetic, arch, TP_N, 1, TP_STEPS)
    one_mesh = mesh_lib.Mesh(data=TP_N, group=None, world=1, rank=0)
    one = {}
    for name, kw in PROTOMATH_SETUPS.items():
        step, opt = T.build_train_step(arch, protomath_tcfg(T, arch, **kw), specs, mesh=one_mesh, device="cuda")
        p = pytree.map_tree(lambda a: a.to("cuda"), params0)
        one[name] = drive(step, p, opt.init(p), batches)[2].cpu().numpy()
    families = tp_families(scenarios)
    for fam, farch in families.items():
        fparams0, fspecs = models.init(torch.Generator().manual_seed(0), farch)
        step, opt = T.build_train_step(farch, protomath_tcfg(T, farch, **PROTOMATH_SETUPS[TP_FAMILY_SETUP]), fspecs,
                                       mesh=one_mesh, device="cuda")
        p = pytree.map_tree(lambda a: a.to("cuda"), fparams0)
        one[f"c/{fam}"] = drive(step, p, opt.init(p), tp_family_batches(synthetic, farch))[2].cpu().numpy()
    moe_name, cut, moe_params = TP_MOE
    first = {}
    for key, wide in (("b", archs.ARCHS["smollm-360m"]), ("d", archs.ARCHS[moe_name].scaled(**cut))):
        whole0, wspecs = models.init(torch.Generator().manual_seed(0), wide)
        step, opt = T.build_train_step(wide, tp_wide_tcfg(T, wide), wspecs,
                                       mesh=dataclasses.replace(one_mesh, data=WIDE_N), device="cuda")
        p = pytree.map_tree(lambda a: a.to("cuda"), whole0)
        first[key] = float(step(p, opt.init(p), train_batches(synthetic, wide, WIDE_N, 2, 1)[0], 0)[2])
        del whole0, p, step, opt
        torch.cuda.empty_cache()

    work = tmp / "protomath_tp"
    if work.exists():
        for f in work.iterdir():
            f.unlink()
    work.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1) // TP_WORLD))}
    started = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--tp-rank", str(work), str(r)], env=env,
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(TP_WORLD)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=max(1.0, started + TP_TIMEOUT_S - time.perf_counter()))[1])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = [p.communicate()[1][-600:] for p in procs[len(errs):]]
        check(False, f"protomath_tp: ranks {len(errs)} to {TP_WORLD - 1} passed {TP_TIMEOUT_S} s: {tails}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, err) in enumerate(zip(procs, errs)):
        check(p.returncode == 0, f"protomath_tp rank {r} exited {p.returncode}: {err[-3000:]}")
    out["ranks_s"] = time.perf_counter() - started
    lines = [json.loads((work / f"rank{r}.json").read_text()) for r in range(TP_WORLD)]
    arrays = [np.load(work / f"rank{r}.npz") for r in range(TP_WORLD)]
    out["a"] = {}
    for name in PROTOMATH_SETUPS:
        for key in arrays[0].files:
            if key.startswith(name + "/"):
                check(all(np.array_equal(a[key], arrays[0][key]) for a in arrays[1:]),
                      f"protomath_tp (a) {key}: the ranks disagree")
        for what in ("loss", "params"):
            check(np.array_equal(arrays[0][f"{name}/sharded/{what}"], arrays[0][f"{name}/gather/{what}"]),
                  f"protomath_tp (a) {name}: the sharded server's {what} differ from the gather server's")
        loss = arrays[0][f"{name}/sharded/loss"]
        rel = float((np.abs(loss - one[name]) / np.abs(one[name])).max())
        check(rel <= TRAIN_RTOL, f"protomath_tp (a) {name}: losses {rel:.3g} from the one-process run")
        out["a"][name] = {"loss": loss.tolist(), "one_process_loss": one[name].tolist(), "max_rel_loss": rel,
                          "sharded_bitwise_gather": True, "ranks_equal": True}
    out["c"] = {}
    for fam in families:
        for key in arrays[0].files:
            if key.startswith(f"c/{fam}/"):
                check(all(np.array_equal(a[key], arrays[0][key]) for a in arrays[1:]),
                      f"protomath_tp (c) {key}: the ranks disagree")
        for what in ("loss", "params"):
            check(np.array_equal(arrays[0][f"c/{fam}/sharded/{what}"], arrays[0][f"c/{fam}/gather/{what}"]),
                  f"protomath_tp (c) {fam}: the sharded server's {what} differ from the gather server's")
        loss, want = arrays[0][f"c/{fam}/sharded/loss"], one[f"c/{fam}"]
        rel = float((np.abs(loss - want) / np.abs(want)).max())
        check(rel <= TRAIN_RTOL, f"protomath_tp (c) {fam}: losses {rel:.3g} from the one-process run")
        out["c"][fam] = {"arch": families[fam].name, "setup": TP_FAMILY_SETUP, "loss": loss.tolist(),
                         "one_process_loss": want.tolist(), "max_rel_loss": rel, "sharded_bitwise_gather": True,
                         "ranks_equal": True}
    for key, name, n_params in (("b", "smollm-360m", WIDE_Q), ("d", f"{moe_name} ({cut})", moe_params)):
        rel = max(abs(ln[key]["first_loss"] - first[key]) / abs(first[key]) for ln in lines)
        check(rel <= TP_WIDE_LOSS_RTOL, f"protomath_tp ({key}): first loss {rel:.3g} from the one-process step")
        for ln in lines:
            check(ln[key]["moment_bytes_whole"] == 2 * n_params * 2, f"protomath_tp ({key}): {n_params} parameters")
        out[key] = {"arch": name, "params": n_params, "n_devices": WIDE_N, "one_process_first_loss": first[key],
                    "first_loss_max_rel": rel, "tolerance": TP_WIDE_LOSS_RTOL,
                    "ranks": [{"rank": ln["rank"], "data_rank": ln["data_rank"], "model_rank": ln["model_rank"],
                               **ln[key]} for ln in lines]}
    start = time.perf_counter()
    out["e"] = tp_serve_check(models, pytree, archs, base, serve, work, lines)
    out["e"]["check_s"] = time.perf_counter() - start
    out["rank_launches"] = [{k: v for k, v in ln["launches"].items() if v} for ln in lines]
    out["rank_part_s"] = [{k: ln[k] for k in ("a_s", "b_s", "c_s", "d_s", "e_s")} for ln in lines]
    launches = {k: sum(ln["launches"][k] for ln in lines) for k in lines[0]["launches"]}
    for kernel in PROTOMATH_KERNELS:
        check(launches[kernel] > 0, f"protomath_tp: kernel {kernel} was not launched on any rank")
    out["protomath_tp_launches"] = launches
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


def refill(state: dict, filled: int, seed: int, cut=None) -> None:
    """The caches' K/V drawn anew from ``seed`` (standard normal), every
    ``length`` and ``pos`` set to ``filled``: the same state on every call.
    Each (block, period, field, batch row) is drawn whole from its own
    generator, seeded by those indices, so a rank of a serving mesh fills
    its cut (``cut``: the ``serving.Shard`` whose ``state_shapes`` and
    placements it holds) with the values the whole state holds there."""
    from repro_torch.core.protomath import fold_seed

    gen = torch.Generator(device="cuda")
    for i, name in enumerate(sorted(k for k in state if k != "pos")):
        c = state[name]
        for j, f in enumerate(("k", "v")):
            t = getattr(c, f)  # (P, B, C, H, D), this rank's cut of it
            whole = tuple(getattr((cut.state_shapes if cut else state)[name], f).shape)
            place = getattr(cut.state[name], f) if cut else (None,) * t.ndim
            first = [cut.along(e)[1] * t.shape[d] if cut else 0 for d, e in enumerate(place)]
            for p in range(t.shape[0]):
                for r in range(t.shape[1]):
                    gen.manual_seed(fold_seed(seed, i, p, j, first[1] + r))
                    row = torch.randn(whole[2:], generator=gen, device="cuda", dtype=t.dtype)
                    t[p, r].copy_(row[first[2]:first[2] + t.shape[2], first[3]:first[3] + t.shape[3]])
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


def main(main_shape_only: bool = False, parent_dir: Path | None = None) -> int:
    """Every phase; with ``main_shape_only`` (``--main-shape``) only the
    build, the ``ptxas`` line, the ``main_shape`` block with the
    ``section7`` phase and the grid replays it reads, the kernels at the
    wide shape (``kernel_timings``), and then the kernels against their
    plain versions (``kernel_errors``). With ``parent_dir`` (``--parent
    DIR``) the six kernel sources of DIR are timed beside the tree's
    (``ParentKernels``)."""
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
    from repro_torch.launch import roofline, serve, train, tuner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    card_peaks = roofline.platform_peaks(0)  # raises for a card without its data sheet's rates
    hbm, fp32 = card_peaks["mem_bw"], card_peaks["peak_flops"]
    build_s = _build.build_all()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda, "kernel_build_s": build_s,
          "peak_hbm_bytes_per_s": hbm, "peak_fp32_flops": fp32})
    emit({"phase": "ptxas", **{name: ptxas_entries(_build.ptxas_log(name))
                               for name in ("gram", "cwtm", "gather_combine", "attack", "row_combine", "quantize")}})
    parent = None
    if parent_dir is not None:
        parent = ParentKernels(parent_dir, _build)
        emit({"phase": "ptxas_parent", "dir": str(parent_dir),
              **{name: ptxas_entries(log) for name, log in parent.ptxas.items()}})
    if main_shape_only:
        main_shape = main_shape_timings(ops, ref, quantize, aggregators, hbm, fp32, parent)
        line, _ = section7_phase(scenarios, {name: 0 for name in ops.KERNELS})
        emit(line)
        emit(main_shape_line(main_shape, line, grid_replays(scenarios)))
        emit({"phase": "kernel_timings", **kernel_timings(ops, ref, quantize, aggregators, hbm, fp32, parent)})
        emit({"phase": "kernel_errors", "max_abs_err": kernel_errors(ops, ref, quantize, aggregators)})
        print(smi, flush=True)
        return 0

    ops.reset_launch_counts()
    errors = kernel_errors(ops, ref, quantize, aggregators)
    timings = kernel_timings(ops, ref, quantize, aggregators, hbm, fp32, parent)
    main_shape = main_shape_timings(ops, ref, quantize, aggregators, hbm, fp32, parent)
    checked = ops.launch_counts()
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    replayed = {name: 0 for name in ops.KERNELS}  # launches of graph replays, which no counter sees
    line, trajectory = trajectory_phase(scenarios, byzantine, ops, linear_regression_problem)
    emit(line)
    section7_line, section7 = section7_phase(scenarios, replayed)
    emit(section7_line)
    emit(graph_phase(scenarios, replayed))
    grid = grid_phase(scenarios, trajectory, section7, replayed)
    emit(grid)
    emit(main_shape_line(main_shape, section7_line, {
        name: sum(b["replay_ms_per_round"] for b in grid["calls"][name]["buckets"])
        for name in ("section7", "sweep1000_n100")}))
    emit(tuner_phase(scenarios, engine, tuner, roofline, archs, ops, ROOT / "build" / "chip_smoke", replayed))
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
    # the step over data 2 x model 2: four processes of their own, each counting its own launches
    run_phases([("protomath_tp", lambda: protomath_tp_phase(train, mesh_lib, models, pytree, synthetic, scenarios,
                                                            archs, base, serve, tmp))])
    tp = lines["protomath_tp"]["protomath_tp_launches"]
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
                ("serve_wide", lambda: serve_wide_phase(models, pytree, archs, base, serve, hbm,
                                                        card_peaks["tensor_flops"]))])
    lm = {name: lm[name] + n for name, n in ops.launch_counts().items()}
    for name in LM_KERNELS:
        check(lm[name] > 0, f"kernel {name} was not launched on the LM path")

    # the fleet: processes of their own, each counting its own launches
    run_phases([("fleet", lambda: fleet_phase(fleet_lib, scenarios))])
    fl = {name: sum(lines["fleet"]["fleet_launches"][side][name] for side in ("server", "workers"))
          for name in ops.KERNELS}

    launches = {name: linear[name] + lm[name] + wide[name] + pm[name] + es[name] + tp[name] + fl[name]
                for name in ops.KERNELS}
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
         "protomath_tp_launches": tp[name],
         "fleet_launches": fl[name],
         "graph_replay_launches": replayed[name],
         "max_abs_err": max(errors[name], timings[name]["max_abs_err_wide"]), **timings[name],
         "main_shape": main_shape.get(name)}
        for name in TPU_KERNELS
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-rank"]:  # one rank of the protomath_tp phase
        sys.exit(tp_rank(Path(sys.argv[2]), int(sys.argv[3])))
    args = sys.argv[1:]
    parent_arg = None
    if args[-2:-1] == ["--parent"]:
        parent_arg, args = Path(args[-1]).resolve(), args[:-2]
    if args not in ([], ["--main-shape"]):
        sys.exit(f"usage: {sys.argv[0]} [--main-shape] [--parent DIR]")
    sys.exit(main(main_shape_only=args == ["--main-shape"], parent_dir=parent_arg))
