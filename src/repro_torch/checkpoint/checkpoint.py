"""Tree checkpoints in the reference's file format.

A checkpoint is two files: ``<path>.npz``, every leaf as a numpy array keyed
by its path in the tree, and ``<path>.json``, the sidecar with ``step``,
``keys`` (sorted), each leaf's ``dtypes`` and ``shapes`` in leaf order, and,
when given, the logical axis ``specs``. A path is the reference's: dict keys
(sorted) and sequence indices joined by ``/``, a dataclass field written
``.name`` (``opt/.mu/embed/table`` for the ``mu`` moment of an ``OptState``
under the key ``opt``); ``None`` and ``()`` hold no leaf. bfloat16 leaves
are stored as float32 (exact) and narrowed back on load. So a file written
by either package loads in the other bit for bit.

Each file is written to a temporary name and moved into place with
``os.replace``: a process killed mid-save leaves the previous complete file,
never a half-written one.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.device import resolve_device
from repro_torch.models import init

__all__ = ["save_checkpoint", "load_checkpoint", "restore_for_serving"]


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    """The leaf as stored: bfloat16 widened to float32."""
    leaf = leaf.detach()
    return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).cpu().numpy()


def save_checkpoint(path: str, tree: Any, step: int = 0, specs: Any = None) -> None:
    """Write ``tree`` (nested dicts, lists and dataclasses of tensors, as
    ``pytree.paths`` walks them) and
    ``step`` to ``path.npz`` and ``path.json``; ``specs`` is a tree of
    logical-axis tuples of the same structure."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = dict(pytree.paths(tree))
    tmp_npz = path + ".tmp.npz"
    np.savez(tmp_npz, **{k: _to_numpy(v) for k, v in flat.items()})
    os.replace(tmp_npz, path + ".npz")
    meta = {
        "step": int(step),
        "keys": sorted(flat),
        "dtypes": {k: str(v.dtype).removeprefix("torch.") for k, v in flat.items()},
        "shapes": {k: list(v.shape) for k, v in flat.items()},
    }
    if specs is not None:
        meta["specs"] = dict(pytree.paths(specs))
    tmp_json = path + ".tmp.json"
    with open(tmp_json, "w") as f:
        json.dump(meta, f, indent=1, default=str)
    os.replace(tmp_json, path + ".json")


def load_checkpoint(path: str, like: Any, device: torch.device | str | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``like``: each leaf a tensor of the
    stored dtype, on ``device`` where given, else on the device of
    ``like``'s leaf at that path (the CPU where that leaf is not a tensor).
    Returns ``(tree, step)``; raises ``ValueError`` when the file's keys are
    not ``like``'s."""
    with np.load(path + ".npz") as data, open(path + ".json") as f:
        meta = json.load(f)
        like_flat = dict(pytree.paths(like))
        missing = set(like_flat) - set(data.files)
        extra = set(data.files) - set(like_flat)
        if missing or extra:
            raise ValueError(f"checkpoint mismatch: missing={missing} extra={extra}")
        flat = {}
        for k, ref in like_flat.items():
            dev = device if device is not None else ref.device if isinstance(ref, torch.Tensor) else "cpu"
            dtype = getattr(torch, meta["dtypes"][k])
            flat[k] = torch.from_numpy(np.array(data[k])).to(device=dev, dtype=dtype)
    return pytree.with_paths(like, flat), int(meta["step"])


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device: ``models.init``
    with it builds the parameter tree's shapes, dtypes and specs and
    allocates no weight."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def restore_for_serving(path: str, cfg, *, device: torch.device | str | None = None) -> tuple[Any, Any, int]:
    """A training checkpoint straight into the serving path: the parameter
    structure of ``cfg`` built on the ``meta`` device (no weight allocated),
    the file loaded into it on ``device`` (the card unless the caller names
    another). Returns ``(params, specs, step)``, ``specs`` as ``models.init``
    gives them, ready for ``launch.serve``. A trainer saves with
    ``save_checkpoint``; a serving process needs only the ``ArchConfig`` and
    this path."""
    like, specs = init(_MetaGenerator(), cfg)
    params, step = load_checkpoint(path, like, device=resolve_device(device))
    return params, specs, step
