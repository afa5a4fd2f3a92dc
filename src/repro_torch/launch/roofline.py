"""Roofline terms for the port: one table of peak rates, the reference's
pure roofline arithmetic, and the bound of a captured round's kernels.

``PLATFORM_PEAKS`` keeps the reference's ``tpu`` (TPU v5e: 197 TFLOP/s
bf16, 819 GB/s HBM, about 50 GB/s a link of ICI) and ``cpu`` entries and
adds the card the port runs on, ``NVIDIA H100 80GB HBM3`` (the SXM part's
data sheet at 700 W): 3.35 TB/s HBM, 67 TFLOP/s fp32 outside the tensor
cores, 989 TFLOP/s dense bf16 on them, and NVLink at 450 GB/s a
direction. ``platform_peaks`` raises for a CUDA card that has no entry,
where the reference falls back to the CPU's figures for a GPU.

``RooflineTerms``, ``derive_terms`` and ``percent_of_peak`` are the
reference's, copied as they are, but for one change: ``derive_terms`` takes
its peaks from ``platform_peaks(device)`` for a device its caller must
name, where the reference's divides by the TPU v5e constants, so it gives
no TPU times for a card. ``active_params`` and ``model_flops`` are the
reference's on the port's models, their parameter shapes built on the
``meta`` device, so the zoo's largest archs need no memory. These four wait
for their callers in the port, the dry run and the report of the
production mesh; the tests hold them to the reference's. ``analyze_launches`` is the counterpart of
``analyze_compiled``: it reads the launch list of a captured round
(``core.scenarios.grid_launch_list``). The reference's HLO parsers
(``parse_collectives``, ``analyze_hlo``, ``analyze_compiled``) read XLA's
optimized HLO text and have no counterpart here: a CUDA graph of
hand-written kernels has no such text, and the launch list takes its place.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "PLATFORM_PEAKS", "H100", "RooflineTerms", "derive_terms",
           "platform_peaks", "percent_of_peak", "analyze_launches", "param_shapes_and_specs", "active_params",
           "model_flops"]

# the reference's dry-run constants: TPU v5e
PEAK_FLOPS = 197e12
HBM_BW = 819e9
LINK_BW = 50e9

H100 = "NVIDIA H100 80GB HBM3"

PLATFORM_PEAKS = {
    "tpu": {"peak_flops": PEAK_FLOPS, "mem_bw": HBM_BW, "link_bw": LINK_BW},
    "cpu": {"peak_flops": 8e9, "mem_bw": 10e9, "link_bw": 10e9},
    # peak_flops: fp32 outside the tensor cores, the rate of the hand-written kernels' arithmetic
    H100: {"peak_flops": 67e12, "tensor_flops": 989e12, "mem_bw": 3.35e12, "link_bw": 450e9},
}


@dataclasses.dataclass
class RooflineTerms:
    flops_per_chip: float
    bytes_per_chip: float
    wire_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_per_chip: float = 0.0
    useful_ratio: float = 0.0

    def as_dict(self):
        return dataclasses.asdict(self)


def derive_terms(
    cost: dict, collectives: dict, model_flops_total: float = 0.0, chips: int = 1, *,
    device: torch.device | str,
) -> RooflineTerms:
    """The roofline terms of one chip's ``cost`` (``flops``, ``bytes
    accessed``) and ``collectives`` (``total_wire_bytes``) at the peaks of
    ``device`` (``platform_peaks``; ``"tpu"`` gives the reference's terms)."""
    peaks = platform_peaks(device)
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    wire = float(collectives.get("total_wire_bytes", 0.0))
    compute_s = flops / peaks["peak_flops"]
    memory_s = byts / peaks["mem_bw"]
    collective_s = wire / peaks["link_bw"]
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf_chip = model_flops_total / max(chips, 1)
    return RooflineTerms(
        flops_per_chip=flops,
        bytes_per_chip=byts,
        wire_bytes_per_chip=wire,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops_per_chip=mf_chip,
        useful_ratio=(mf_chip / flops) if flops > 0 else 0.0,
    )


def platform_peaks(device: torch.device | str | None = None) -> dict:
    """``{peak_flops, mem_bw, link_bw}`` (and ``tensor_flops`` for a card)
    of ``device``: a CUDA device by its name (``torch.cuda.
    get_device_name``), else a key of ``PLATFORM_PEAKS`` (``"cpu"``,
    ``"tpu"``, a card's name). ``None`` is the first card when one is
    present, else the CPU. A card without an entry raises: its own data
    sheet's rates must be added."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if isinstance(device, str) and device in PLATFORM_PEAKS:
        return PLATFORM_PEAKS[device]
    try:
        dev = torch.device(device)
    except RuntimeError:  # a name that is neither a key nor a device
        dev, name = None, str(device)
    if dev is not None:
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    if name not in PLATFORM_PEAKS:
        raise KeyError(f"no peak rates for {name!r} in PLATFORM_PEAKS: add the card's own data-sheet figures")
    return PLATFORM_PEAKS[name]


def analyze_launches(launch_list: dict[str, list[dict]], device: torch.device | str | None = None) -> dict:
    """The roofline bound of the hand-written kernels' launches in a launch
    list (``grid_launch_list``: one captured round), and of nothing else:
    the round's other card work (PyTorch's own kernels: the gradients, the
    optimizer step, copies) is not counted. ``{flops, bytes_hbm, compute_s,
    memory_s, predicted_s, dominant, launches}`` on ``device``'s peaks
    (``platform_peaks``), fp32 operations at the fp32 rate; ``predicted_s``
    is the larger term, the least time the card could take for these
    launches."""
    peaks = platform_peaks(device)
    launches = [launch for per_kernel in launch_list.values() for launch in per_kernel]
    flops = float(sum(launch["flops"] for launch in launches))
    nbytes = float(sum(launch["bytes"] for launch in launches))
    compute_s = flops / peaks["peak_flops"]
    memory_s = nbytes / peaks["mem_bw"]
    return {
        "flops": flops,
        "bytes_hbm": nbytes,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "predicted_s": max(compute_s, memory_s),
        "dominant": "compute" if compute_s > memory_s else "memory",
        "launches": len(launches),
    }


def percent_of_peak(
    analysis: dict, measured_s: float, calls: float = 1.0
) -> float:
    """Roofline utilization of a measured wall clock: 100 x predicted / actual
    for ``calls`` executions of the analyzed module.

    100 means the run hit the platform's roofline (never in practice; the
    peaks are marketing numbers and the analysis undercounts overheads);
    the value is a *relative* efficiency tracked across PRs — a warm sweep
    whose %-of-peak halves got slower in a way wall clock alone can't
    attribute.  Clamped below at 0; not clamped above (a >100 reading means
    the platform peaks in ``PLATFORM_PEAKS`` are stale for this machine —
    visible is better than silently capped).
    """
    if measured_s <= 0:
        raise ValueError(f"measured_s must be > 0, got {measured_s}")
    return max(0.0, 100.0 * analysis["predicted_s"] * calls / measured_s)


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS (the 6ND / 2ND yardstick)
# ---------------------------------------------------------------------------


class _OnMeta(TorchFunctionMode):
    """Every call that names a device gets the ``meta`` device instead: the
    initializers' factories take their device from their generator."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if "device" in kwargs:
            kwargs = {**kwargs, "device": "meta"}
        return func(*args, **kwargs)


def _param_shapes(cfg):
    """The parameters of ``cfg`` as tensors on the ``meta`` device."""
    return param_shapes_and_specs(cfg)[0]


def param_shapes_and_specs(cfg):
    """``models.init(cfg)``'s (params, specs), the params on the ``meta``
    device: shapes and dtypes with no memory."""
    from repro_torch import models

    with torch.device("meta"), _OnMeta():
        return models.init(torch.Generator(), cfg)


def active_params(cfg, shapes=None) -> int:
    """Total params counted with only top_k of n_experts active per MoE layer
    (``shapes``: ``cfg``'s parameters, built on ``meta`` when not given)."""
    from repro_torch import pytree

    shapes = _param_shapes(cfg) if shapes is None else shapes
    total = sum(leaf.numel() for leaf in pytree.leaves(shapes))
    if cfg.moe is None:
        return total
    # subtract the inactive expert fraction of expert weights
    expert = 0
    for path, leaf in pytree.paths(shapes):
        if any(k in ("w_gate", "w_up", "w_down") for k in path.split("/")) and leaf.ndim >= 3:
            expert += int(leaf.numel())
    inactive_frac = 1.0 - cfg.moe.top_k / cfg.moe.n_experts
    return int(total - expert * inactive_frac)


def model_flops(cfg, shape, n_active: int | None = None, d_redundancy: int = 1) -> float:
    """6*N*D for a train step (x d for LAD redundancy), 2*N*D per served token."""
    n_act = n_active if n_active is not None else active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * tokens * d_redundancy
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_act * tokens
    # decode: one token per sequence
    return 2.0 * n_act * shape.global_batch
