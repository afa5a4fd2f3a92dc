"""The mesh of the ``"protomath"`` train step: ``N`` logical LAD devices
over the ranks of a ``torch.distributed`` data group.

The reference lays its ``("data", "model")`` GSPMD mesh over real or
virtual devices. Here ``make_host_mesh(data)`` lays ``data`` logical
devices rank-major over the ``W`` ranks of the default process group (one
rank, and no collective call, when none is initialised): rank ``r`` holds
devices ``r * data/W .. (r + 1) * data/W - 1``, so ``data=8`` on one card is
eight logical devices on one rank. A process sets up the group itself
(``torch.distributed.init_process_group`` with its address, world size and
rank); nothing here reads a cluster's environment.

The tensor-parallel ``model`` axis and the production pods wait for
ROADMAP A.9c.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch.distributed as dist

__all__ = ["Mesh", "make_host_mesh", "make_production_mesh", "data_axes", "n_data_devices"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` logical LAD devices over a data ``group`` of ``world``
    ranks, this process being ``rank``; ``group`` is ``None`` for one
    process with no group."""

    data: int
    group: Any
    world: int
    rank: int

    @property
    def local_devices(self) -> int:
        """The logical devices (batch blocks) this rank holds."""
        return self.data // self.world


def make_host_mesh(data: int = 2, model: int = 1, pod: int | None = None, *, group: Any = None) -> Mesh:
    """``data`` logical devices over ``group`` (the default process group
    when one is initialised and ``group`` is not given); ``data`` must
    divide by its ranks."""
    if model != 1 or pod:
        raise ValueError(f"model={model}, pod={pod}: the model and pod axes wait for ROADMAP A.9c")
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    if data < 1 or data % world != 0:
        raise ValueError(f"{data} logical devices do not split over {world} ranks")
    return Mesh(data=data, group=group, world=world, rank=rank)


def make_production_mesh(*, multi_pod: bool = False):
    raise ValueError("the production (pod x data x model) mesh waits for ROADMAP A.9c")


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    return ("data",)


def n_data_devices(mesh: Mesh) -> int:
    return mesh.data
