"""Public wrappers over the kernels of the protocol round.

Each wrapper takes any Q and any number of leading lane axes, folds the
lanes into one axis, and then:

  * for a tensor on a CUDA device, launches its hand-written kernel (and
    adds one to its launch count) — there is no fallback;
  * for a tensor on the CPU, runs the plain PyTorch version.

The kernels take fp32, contiguous tensors; anything else raises. The CUDA
kernels mask their ragged Q edge themselves, so nothing is padded here.
A kernel's grid spans its folded lanes in one dimension of at most 65535
blocks, so a wrapper launches a larger fold in consecutive slices of lanes;
lanes are independent, so the bits do not change, and each launch counts.
The grids of the encode (lanes x column tiles), of the row combines
(lanes x columns) and of QSGD (rows x quantization blocks) are flat: one
launch covers any lane count.

Inside a ``crossover(dispatch)`` block, a crossover table the caller passes
in (``functools.partial(tuner.lane_dispatch, store=store)`` over a store
whose pairs were measured) may steer a kernel at a lane count to a loop of
single-lane launches instead (``_lane_launch``): a single-lane launch is the
``L = 1`` batched launch, so the bits are the same either way. Outside such
a block, and wherever the table answers ``"batched"``, a kernel launches
its lanes batched; the wrappers read no store of their own.

``launch_work`` reckons a launch's bytes and fp32 operations from its shapes
alone, whichever implementation runs: each fp32 stack read once and each
output written once, and the operations a coordinate takes in the kernel's
arithmetic. ``record_launches`` logs every launch with its work (on the CPU,
the launches the card would make), which ``engine`` keeps for a captured
round and ``launch.roofline.analyze_launches`` turns into a bound.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch.kernels import attacks as _attacks
from repro_torch.kernels import coded_combine as _coded_combine
from repro_torch.kernels import cwtm as _cwtm
from repro_torch.kernels import nnm_dist as _nnm_dist
from repro_torch.kernels import quantize as _quantize
from repro_torch.kernels.ref import sqdist_from_gram

__all__ = [
    "gather_combine",
    "attack",
    "cwtm",
    "gram",
    "pairwise_sqdist",
    "stochastic_quantize",
    "masked_combine",
    "coded_combine",
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
    "launch_work",
    "record_launches",
    "crossover",
]

# counter name -> launches in this process: one counter per CUDA kernel,
# and "cwtm_nnm", the CWTM kernel's launches with the NNM mix (each also
# counted under "cwtm")
_launches = {"gather_combine": 0, "attack": 0, "cwtm": 0, "gram": 0,
             "quantize": 0, "masked_combine": 0, "coded_combine": 0, "cwtm_nnm": 0}
KERNELS = tuple(_launches)

_MAX_GRID_Y = 65535

# past this many lanes a per-lane loop costs more launches than any
# crossover saves; the reference's bound on its unrolled loop
_LOOP_UNROLL_MAX = 64

_F32 = 4
_recorders: list[list[dict]] = []
# (kernel, lanes) -> "batched" or "loop", while a ``crossover`` block runs
_dispatch: Callable[[str, int], str] | None = None


def launch_counts() -> dict[str, int]:
    """A copy of the per-kernel launch counts."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """Validate the operands of kernel ``name``; True when they lie on a CUDA
    device (launch the kernel), False on the CPU (run the plain version)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if tensors[0].dtype != torch.float32:
        raise TypeError(f"{name}: float32 only, got {tensors[0].dtype}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel and no plain path for device {dev}")


def launch_work(name: str, lanes: int, rows: int, q: int, *, d: int = 0, trim: int = 0,
                k: int = 0) -> tuple[float, float]:
    """(bytes, fp32 operations) of one launch of kernel ``name`` over
    ``lanes`` lanes of ``rows`` x ``q`` fp32 values: each stack read once
    and each output written once (index tables and weights not counted),
    and per coordinate the operations of the kernel's arithmetic. ``d`` is
    the encode's subsets per device; ``trim`` and ``k`` (0: no NNM mix) the
    CWTM's trim and neighbours. ``quantize`` takes ``rows=1`` a lane.

    CWTM's sort counts a min and a max for each compare-exchange of
    Batcher's odd-even merge sort on ``pow2_ceil(rows)`` slots
    (``cwtm.network``): the fewest compare-exchanges of the networks the
    kernel may run, so the bound is the same work whichever of them runs."""
    per_lane = {
        # read the stack, write the coded stack; a product and an add per subset
        "gather_combine": (2 * rows * q, 2 * d * rows * q),
        "attack": (2 * rows * q, 8 * rows * q),
        # the mix (k adds and a product per value), the sort network, the kept-row tree and its product
        "cwtm": (rows * q + q, (rows * (k + 1) if k else 0) + 2 * len(_cwtm.network(1 << (rows - 1).bit_length()))
                 + (rows - 2 * trim) + 1),
        # read the stack, write the Gram and the norms; an FMA for each of the N (N + 1) / 2 pairs a column
        "gram": (rows * q + rows * rows + rows, rows * (rows + 1) * q),
        # read g and u, write the result; abs, max, two divisions, two products, floor, subtract, compare, add
        "quantize": (3 * rows * q, 10 * rows * q),
        "masked_combine": (rows * q + q, 2 * rows * q),
        "coded_combine": (rows * q + q, 2 * rows * q),
    }
    if name not in per_lane:
        raise KeyError(f"no kernel {name!r}")
    values, ops = per_lane[name]
    if name == "cwtm":
        ops *= q
    return float(_F32 * values * lanes), float(ops * lanes)


@contextlib.contextmanager
def record_launches():
    """Log every kernel launch the wrappers make while the block runs, on
    the card, or on the CPU the launches the card would make: a list of
    ``{"kernel", "lanes", "rows", "q", "bytes", "flops", ...}`` (the
    ``launch_work`` of each launch and its shape arguments)."""
    log: list[dict] = []
    _recorders.append(log)
    try:
        yield log
    finally:
        _recorders.remove(log)


@contextlib.contextmanager
def crossover(dispatch: Callable[[str, int], str]):
    """Dispatch the wrappers' launches by ``dispatch(kernel, lanes)`` ->
    ``"batched"`` or ``"loop"`` while the block runs (a CUDA graph captured
    inside keeps the launches it captured). Blocks nest; the outer table
    comes back when the block ends."""
    global _dispatch
    outer, _dispatch = _dispatch, dispatch
    try:
        yield
    finally:
        _dispatch = outer


def _use_loop(name: str, lanes: int) -> bool:
    """Whether the crossover table of the active ``crossover`` block says
    single-lane launches beat one batched launch for kernel ``name`` at
    ``lanes`` lanes."""
    return _dispatch is not None and 2 <= lanes <= _LOOP_UNROLL_MAX and _dispatch(name, lanes) == "loop"


def _slices(name: str, lanes: int, per: int, **shape) -> list[tuple[int, int]]:
    """The ``[start, stop)`` lane slices kernel ``name`` launches over
    ``lanes`` folded lanes (one a lane where the crossover table says so,
    else consecutive slices of at most ``per``), each logged with its work
    to the active ``record_launches`` logs."""
    step = 1 if _use_loop(name, lanes) else per
    slices = [(a, min(lanes, a + step)) for a in range(0, lanes, step)]
    for log in _recorders:
        for a, b in slices:
            nbytes, flops = launch_work(name, b - a, **shape)
            log.append({"kernel": name, "lanes": b - a, **shape, "bytes": nbytes, "flops": flops})
    return slices


def _lane_launch(name: str, launch, out: torch.Tensor, slices: list[tuple[int, int]],
                 *operands: torch.Tensor) -> torch.Tensor:
    """Launch ``launch(*operand slices, out=out slice)`` over ``slices`` of
    the lanes (the leading axis of every operand and of ``out``), counting
    each launch under ``name``."""
    for a, b in slices:
        _launches[name] += 1
        launch(*(t[a:b] for t in operands), out=out[a:b])
    return out


def _lanes(x: torch.Tensor, event_ndim: int) -> tuple[torch.Tensor, tuple[int, ...]]:
    """Fold all leading lane axes of ``x`` into one."""
    if not x.is_contiguous():
        raise ValueError("kernel operands must be contiguous")
    lead = tuple(x.shape[: x.ndim - event_ndim])
    return x.reshape((-1,) + tuple(x.shape[x.ndim - event_ndim :])), lead


def gather_combine(
    grads: torch.Tensor, subsets: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """eq.-(5) encode. grads: (..., N, Q) f32, subsets: (..., N, d) ids in
    [0, N), weights: (d,) or (..., d) -> (..., N, Q) coded vectors.

    On the CPU an id outside [0, N) raises. On the card the ids are not
    read back (that would stall the host every round); the kernel reads no
    row outside the stack and writes NaN over a device row whose ids are out
    of range. Records of randomness are checked where they enter a round
    (``RoundRandomness.validate``)."""
    n = grads.shape[-2]
    if subsets.shape[:-1] != grads.shape[:-1]:
        raise ValueError(f"gather_combine: subsets {tuple(subsets.shape)} vs grads {tuple(grads.shape)}")
    flat, lead = _lanes(grads, 2)
    s = subsets.reshape(flat.shape[:2] + subsets.shape[-1:]).to(torch.int32).contiguous()
    w = weights.to(torch.float32).expand(lead + weights.shape[-1:]).reshape(
        flat.shape[:1] + weights.shape[-1:]).contiguous()
    on_card = _on_card("gather_combine", flat, s, w)
    slices = _slices("gather_combine", flat.shape[0], max(1, flat.shape[0]), rows=n, q=flat.shape[-1],
                     d=s.shape[-1])
    if not on_card:
        if s.numel() and (int(s.min()) < 0 or int(s.max()) >= n):
            raise IndexError(f"gather_combine: subset ids outside [0, {n})")
        return _coded_combine.gather_plain(flat, s, w).reshape(grads.shape)
    return _lane_launch("gather_combine", _coded_combine.gather_launch, torch.empty_like(flat), slices,
                        flat, s, w).reshape(grads.shape)


def attack(msgs: torch.Tensor, mask: torch.Tensor, name: str, param: float) -> torch.Tensor:
    """Byzantine attack (sign_flip / alie / ipm). msgs: (..., N, Q) f32,
    mask: (..., N) 0/1 -> (..., N, Q) transmitted; ``param`` is the attack's
    scalar (coeff / z / eps)."""
    if name not in _attacks.KERNEL_ATTACK_PARAMS:
        raise KeyError(f"no kernel attack {name!r}")
    if mask.shape != msgs.shape[:-1]:
        raise ValueError(f"attack: mask {tuple(mask.shape)} vs msgs {tuple(msgs.shape)}")
    flat, _ = _lanes(msgs, 2)
    flat_mask = mask.to(torch.float32).reshape(flat.shape[:2]).contiguous()
    on_card = _on_card("attack", flat, flat_mask)
    if on_card and name != "sign_flip" and not _attacks.attack_tile(1, flat.shape[1], flat.shape[-1]):
        raise ValueError(f"attack kernel: N = {flat.shape[1]} leaves no column tile in shared memory")
    slices = _slices("attack", flat.shape[0], _MAX_GRID_Y, rows=flat.shape[1], q=flat.shape[-1])
    if not on_card:
        return _attacks.plain(flat, flat_mask, name, param).reshape(msgs.shape)
    return _lane_launch("attack", lambda m, k, out: _attacks.launch(m, k, name, param, out=out),
                        torch.empty_like(flat), slices, flat, flat_mask).reshape(msgs.shape)


def cwtm(msgs: torch.Tensor, trim: int, neighbours: torch.Tensor | None = None) -> torch.Tensor:
    """Coordinate-wise trimmed mean. msgs: (..., N, Q) f32 -> (..., Q).

    With ``neighbours`` ((..., N, k) ids, each row strictly ascending in
    [0, N)), the NNM mix of ``ref.nnm_mix_ref`` comes first, in the same
    kernel: the mixed stack is never stored. On the CPU a table out of range
    or out of order raises; on the card it is not read back, and the kernel
    writes NaN over every lane whose table is out of range or order."""
    n = msgs.shape[-2]
    if trim < 0 or 2 * trim >= n:
        raise ValueError(f"trim={trim} too large for N={n}")
    flat, lead = _lanes(msgs, 2)
    nb = None
    if neighbours is not None:
        k = neighbours.shape[-1]
        if neighbours.shape[:-1] != msgs.shape[:-1] or not 1 <= k <= n:
            raise ValueError(f"cwtm: neighbours {tuple(neighbours.shape)} vs msgs {tuple(msgs.shape)}")
        nb = neighbours.to(torch.int32).reshape(flat.shape[:2] + (k,)).contiguous()
    on_card = _on_card("cwtm", flat, *(() if nb is None else (nb,)))
    if on_card and n > _cwtm.MAX_N:
        raise ValueError(f"cwtm kernel takes N <= {_cwtm.MAX_N}, got {n}")
    slices = _slices("cwtm", flat.shape[0], _MAX_GRID_Y, rows=n, q=flat.shape[-1], trim=trim,
                     k=0 if nb is None else nb.shape[-1])
    if not on_card:
        if nb is not None and nb.numel() and (
                int(nb.min()) < 0 or int(nb.max()) >= n or bool((nb[..., 1:] <= nb[..., :-1]).any())):
            raise IndexError(f"cwtm: neighbour rows must be strictly ascending ids in [0, {n})")
        return _cwtm.plain(flat, trim, nb).reshape(lead + msgs.shape[-1:])
    out = torch.empty((flat.shape[0], flat.shape[-1]), dtype=flat.dtype, device=flat.device)
    before = _launches["cwtm"]
    _lane_launch("cwtm", lambda m, *t, out: _cwtm.launch(m, trim, *t, out=out), out, slices,
                 flat, *(() if nb is None else (nb,)))
    if nb is not None:
        _launches["cwtm_nnm"] += _launches["cwtm"] - before
    return out.reshape(lead + msgs.shape[-1:])


def gram(msgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gram matrix and row norms. msgs: (..., N, Q) f32 -> (gram (..., N, N),
    sq (..., N))."""
    n = msgs.shape[-2]
    flat, lead = _lanes(msgs, 2)
    on_card = _on_card("gram", flat)
    if on_card and n > _nnm_dist.MAX_N:
        raise ValueError(f"gram kernel takes N <= {_nnm_dist.MAX_N}, got {n}")
    slices = _slices("gram", flat.shape[0], _MAX_GRID_Y, rows=n, q=flat.shape[-1])
    if not on_card:
        g, sq = _nnm_dist.plain(flat)
    else:
        parts = [_nnm_dist.launch(flat[a:b]) for a, b in slices]
        _launches["gram"] += len(parts)
        g, sq = (parts[0] if len(parts) == 1 else
                 (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])))
    return g.reshape(lead + (n, n)), sq.reshape(lead + (n,))


def pairwise_sqdist(msgs: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances. msgs: (..., N, Q) -> (..., N, N), as
    ``max(sq_i + sq_j - 2 G_ij, 0)`` around the Gram kernel."""
    return sqdist_from_gram(*gram(msgs))


def _row_combine(name: str, plain, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``out[..., q] = sum_r w[..., r] x[..., r, q]`` for kernel ``name``;
    weights broadcast over x's leading axes."""
    r = x.shape[-2]
    flat, lead = _lanes(x, 2)
    w = weights.to(torch.float32).expand(x.shape[:-1]).reshape(flat.shape[:2]).contiguous()
    on_card = _on_card(name, flat, w)
    if on_card and r > _coded_combine.MAX_ROWS:
        raise ValueError(f"{name} kernel takes at most {_coded_combine.MAX_ROWS} rows, got {r}")
    slices = _slices(name, flat.shape[0], max(1, flat.shape[0]), rows=r, q=flat.shape[-1])
    if not on_card:
        return plain(flat, w).reshape(lead + x.shape[-1:])
    out = torch.empty((flat.shape[0], flat.shape[-1]), dtype=flat.dtype, device=flat.device)
    return _lane_launch(name, _coded_combine.rows_launch, out, slices, flat, w).reshape(lead + x.shape[-1:])


def masked_combine(msgs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted row-combine over the device axis, the K-of-N erasure
    decode's surviving-class sum. msgs: (..., N, Q) f32, weights: (..., N)
    row weights (exact 0.0 on rows outside the class) -> (..., Q)."""
    if weights.shape[-1] != msgs.shape[-2]:
        raise ValueError(f"masked_combine: weights {tuple(weights.shape)} vs msgs {tuple(msgs.shape)}")
    return _row_combine("masked_combine", _coded_combine.masked_plain, msgs, weights)


def coded_combine(grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """eq.-(5) combine of stacked subset gradients. grads: (..., d, Q) f32,
    weights: (d,) or (..., d) -> (..., Q)."""
    if weights.shape[-1] != grads.shape[-2]:
        raise ValueError(f"coded_combine: weights {tuple(weights.shape)} vs grads {tuple(grads.shape)}")
    return _row_combine("coded_combine", _coded_combine.coded_plain, grads, weights)


def stochastic_quantize(g: torch.Tensor, u: torch.Tensor, levels: int = 16, block: int = 1024) -> torch.Tensor:
    """QSGD quantize-dequantize per block of ``min(block, Q)`` coordinates
    along the last axis. g, u: (..., Q) f32, u in [0, 1) -> (..., Q)."""
    if u.shape != g.shape or u.dtype != g.dtype:
        raise ValueError(f"stochastic_quantize: u {u.dtype}{tuple(u.shape)} vs g {g.dtype}{tuple(g.shape)}")
    if levels < 1 or block < 1:
        raise ValueError(f"stochastic_quantize: levels={levels} and block={block} must be >= 1")
    qb = min(block, g.shape[-1])
    gf, _ = _lanes(g, 1)
    uf, _ = _lanes(u, 1)
    on_card = _on_card("quantize", gf, uf)
    slices = _slices("quantize", gf.shape[0], max(1, gf.shape[0]), rows=1, q=gf.shape[-1])
    if not on_card:
        return _quantize.plain(gf, uf, levels, qb).reshape(g.shape)
    return _lane_launch("quantize", lambda a, b, out: _quantize.launch(a, b, levels, qb, out=out),
                        torch.empty_like(gf), slices, gf, uf).reshape(g.shape)
