"""The mesh of the ``"protomath"`` train step: ``N`` logical LAD devices
over the data ranks of a ``torch.distributed`` group, each leaf's
tensor-parallel dim over its model ranks.

The reference lays its ``("data", "model")`` (or ``("pod", "data",
"model")``) GSPMD mesh over real or virtual devices. Here
``make_host_mesh(data, model, pod)`` lays the ``W`` ranks of the default
process group (or of ``group``) out as ``jax.make_mesh``'s device order
does: pod-major, then data, model-minor, so that ``rank = data_rank *
model + model_rank`` (the data rank counting over the pods too). The
``pod * data`` logical devices split over the ``W / model`` data ranks:
data rank ``r`` holds devices ``r * n_local .. (r + 1) * n_local - 1``,
so ``data=8`` on one card is eight logical devices on one rank. Every rank
builds its model group (the ranks of its data rank) and its data group
(the ranks of its model rank) with ``dist.new_group``, in the same order.
One process with no group holds every device, and makes no collective
call. A process sets up the group itself (``init_process_group`` with its
address, world size and rank); nothing here reads a cluster's environment.

``make_production_mesh`` gives the reference's 16 x 16 and 2 x 16 x 16
shapes as a mesh with no ranks (``abstract_mesh``), as jax's
``AbstractMesh``: the placements and the dry run read it, and a step on it
raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch.distributed as dist

__all__ = ["Mesh", "make_host_mesh", "abstract_mesh", "make_production_mesh", "data_axes", "n_data_devices"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` logical LAD devices a pod (``pod`` pods, ``None`` for the
    2-axis mesh) over a data ``group`` of ``world`` ranks, this process
    being ``rank`` in it; each leaf's tp dim over a ``model_group`` of
    ``model`` ranks, this process being ``model_rank`` in it. A group is
    ``None`` where it would hold one rank. ``abstract``: the mesh has no
    ranks (``abstract_mesh``)."""

    data: int
    group: Any
    world: int
    rank: int
    model: int = 1
    model_group: Any = None
    model_rank: int = 0
    pod: int | None = None
    abstract: bool = False

    @property
    def local_devices(self) -> int:
        """The logical devices (batch blocks) this rank holds."""
        return n_data_devices(self) // self.world

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.pod else ("data", "model")

    @property
    def shape(self) -> dict[str, int]:
        """Ranks along each axis, the placements' divisors (jax's
        ``mesh.shape``): the data ranks split over the pods."""
        ranks = {"data": self.world // (self.pod or 1), "model": self.model}
        return {"pod": self.pod, **ranks} if self.pod else ranks

    @property
    def size(self) -> int:
        return self.world * self.model


def _global_ranks(group: Any, world: int) -> list[int]:
    if group is dist.group.WORLD:
        return list(range(world))
    return [dist.get_global_rank(group, r) for r in range(world)]


def make_host_mesh(data: int = 2, model: int = 1, pod: int | None = None, *, group: Any = None) -> Mesh:
    """``pod * data`` logical devices over the ranks of ``group`` (the
    default process group when one is initialised and ``group`` is not
    given), ``model`` of them a data rank; every rank of ``group`` must
    call it, with the same arguments."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    size = 1 if group is None else dist.get_world_size(group)
    me = 0 if group is None else dist.get_rank(group)
    if model < 1 or size % model != 0:
        raise ValueError(f"{size} ranks do not split into data ranks of model={model}")
    world = size // model
    if pod is not None and (pod < 1 or world % pod != 0):
        raise ValueError(f"{world} data ranks do not split over pod={pod}")
    n = data * (pod or 1)
    if data < 1 or n % world != 0:
        raise ValueError(f"{n} logical devices do not split over {world} data ranks")
    if model == 1:
        return Mesh(data=data, group=group, world=world, rank=me, pod=pod)
    ranks = _global_ranks(group, size)
    data_group = model_group = None
    for m in range(model):  # every rank creates every group, in the same order
        g = dist.new_group([ranks[r * model + m] for r in range(world)])
        if m == me % model:
            data_group = g
    for r in range(world):
        g = dist.new_group([ranks[r * model + m] for m in range(model)])
        if r == me // model:
            model_group = g
    return Mesh(data=data, group=data_group if world > 1 else None, world=world, rank=me // model, model=model,
                model_group=model_group, model_rank=me % model, pod=pod)


def abstract_mesh(data: int, model: int = 1, pod: int | None = None) -> Mesh:
    """A ``(pod x) data x model`` mesh with no ranks, one logical device a
    data position: its placements and counts, and no step."""
    return Mesh(data=data, group=None, world=data * (pod or 1), rank=0, model=model, pod=pod, abstract=True)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes: 16 x 16 (one pod, 256 chips) and
    2 x 16 x 16 (two pods, 512), with no ranks."""
    return abstract_mesh(16, 16, 2 if multi_pod else None)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    return ("pod", "data") if mesh.pod else ("data",)


def n_data_devices(mesh: Mesh) -> int:
    return mesh.data * (mesh.pod or 1)

