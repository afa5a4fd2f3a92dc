"""The port's mesh and placements against the reference's, on the CPU.

For every arch of ``configs/archs.py`` on the production meshes (16 x 16
and 2 x 16 x 16) and a 2 x 2 host mesh, the port's partition specs equal
the reference's, entry for entry: the reference's run on a jax
``AbstractMesh`` of the same shape (no devices), the port's on
``launch.mesh.abstract_mesh``:

  * ``launch.train.param_pspecs`` (each leaf, its dims that do not divide
    replicated);
  * ``launch.serve.decode_state_pspecs`` at ``decode_32k`` and
    ``long_500k``;
  * ``batch_dim_pspec`` at every shape's batch;
  * ``serve_input_specs`` at every serving shape: shapes, dtypes and
    placements.

And ``make_host_mesh``'s rank layout and groups on 4 ``gloo`` ranks
(tests/torch_tp_ranks.py ``layout``): ``rank = data_rank * model +
model_rank``, the data group the ranks of one model rank, the model group
those of one data rank; ``make_production_mesh`` places but refuses a
step.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

import torch_tp_ranks as ranks
from repro import models as jmodels
from repro.configs.archs import ARCHS as JARCHS
from repro.configs.base import INPUT_SHAPES as JSHAPES
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro_torch import pytree
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline, serve, train

MESHES = {"pod1": ((16, 16), ("data", "model")), "pod2": ((2, 16, 16), ("pod", "data", "model")),
          "host2x2": ((2, 2), ("data", "model"))}


def _meshes(name: str):
    sizes, names = MESHES[name]
    port = mesh_lib.abstract_mesh(sizes[-2], sizes[-1], sizes[0] if len(sizes) == 3 else None)
    return AbstractMesh(sizes, names), port


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))


def _ref_flat(tree) -> dict[str, tuple]:
    """{path: spec entries} of a reference tree of PartitionSpecs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {"/".join(_key(k) for k in path): tuple(spec) for path, spec in flat}


def _port_flat(tree, prefix: str = "") -> dict[str, tuple]:
    """{path: spec} of a port tree of placements (dicts and dataclasses
    holding tuples)."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _port_flat(tree[key], f"{prefix}{key}/").items()}
    if hasattr(tree, "__dataclass_fields__"):
        return {k: v for f in tree.__dataclass_fields__
                for k, v in _port_flat(getattr(tree, f), f"{prefix}{f}/").items()}
    return {prefix[:-1]: tuple(tree)}


@functools.lru_cache(maxsize=None)
def _ref_shapes_and_specs(arch: str):
    captured = {}

    def only_params(k):
        p, s = jmodels.init(k, JARCHS[arch])
        captured["specs"] = s
        return p

    return jax.eval_shape(only_params, jax.random.PRNGKey(0)), captured["specs"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_placements_equal_the_references(arch, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    jshapes, jspecs = _ref_shapes_and_specs(arch)
    shapes, specs = roofline.param_shapes_and_specs(ARCHS[arch])
    want = _ref_flat(jtrain.param_pspecs(jspecs, jmesh, jshapes))
    got = _port_flat(train.param_pspecs(specs, mesh, shapes))
    assert got == want
    assert tuple(train.batch_pspec(mesh)) == tuple(jtrain.batch_pspec(jmesh))
    for name, shape in INPUT_SHAPES.items():
        jshape = JSHAPES[name]
        assert serve.batch_dim_pspec(shape.global_batch, mesh) == tuple(jserve.batch_dim_pspec(jshape.global_batch,
                                                                                                 jmesh))
        if name in ("decode_32k", "long_500k"):
            jstate = jax.eval_shape(lambda: jmodels.init_decode_state(JARCHS[arch], jshape.global_batch,
                                                                      jshape.seq_len))
            state = serve.serve_input_specs(ARCHS[arch], shape, mesh)["state"].value
            assert (_port_flat(serve.decode_state_pspecs(state, mesh))
                    == _ref_flat(jserve.decode_state_pspecs(jstate, jmesh))), name


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_inputs_equal_the_references(arch, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    for name, shape in INPUT_SHAPES.items():
        if shape.kind == "train":  # no serve inputs, on either side
            with pytest.raises(ValueError, match="train"):
                serve.serve_input_specs(ARCHS[arch], shape, mesh)
            continue
        want = jserve.serve_input_specs(JARCHS[arch], JSHAPES[name], jmesh)
        got = serve.serve_input_specs(ARCHS[arch], shape, mesh)
        assert sorted(got) == sorted(want), name
        for key, placed in got.items():
            leaves = {p: t for p, t in pytree.paths(placed.value)}
            ref, _ = jax.tree_util.tree_flatten_with_path(want[key])
            ref = {"/".join(_key(k).lstrip(".") for k in path): s for path, s in ref}
            placements = _port_flat(placed.placement) if key == "state" else {"": placed.placement}
            assert len(leaves) == len(ref), (name, key)
            for path, t in leaves.items():
                rpath = "/".join(part.lstrip(".") for part in path.split("/")) if path else ""
                s = ref[rpath]
                assert tuple(t.shape) == tuple(s.shape) and t.device.type == "meta", (name, key, path)
                assert str(t.dtype).split(".")[-1] == str(np.dtype(s.dtype)) or (
                    t.dtype == torch.bfloat16 and str(s.dtype) == "bfloat16"), (name, key, path, t.dtype, s.dtype)
                assert placements[rpath] == tuple(s.sharding.spec), (name, key, path)


def test_make_host_mesh_lays_ranks_out_data_major(tmp_path):
    res = ranks.spawn("layout", 4, 1, tmp_path)
    for r, out in enumerate(res):
        world, rank, model, model_rank, local = out["2x2/shape"]
        assert (world, rank, model, model_rank, local) == (2, r // 2, 2, r % 2, 1)
        assert list(out["2x2/data_group"]) == [r % 2, r % 2 + 2]
        assert list(out["2x2/model_group"]) == [2 * (r // 2), 2 * (r // 2) + 1]
        # pod 2 x data 1 x model 2: two data ranks (one a pod), each holding one of the 2 logical devices
        assert list(out["pod2x1x2/shape"]) == [2, r // 2, 2, r % 2, 1]
        assert list(out["pod2x1x2/data_group"]) == [r % 2, r % 2 + 2]
        # pod 2 x data 2 x model 1: four data ranks over the default group, one device each
        assert list(out["pod2x2x1/shape"]) == [4, r, 1, 0, 1]
        assert list(out["pod2x2x1/data_group"]) == [0, 1, 2, 3]
        assert list(out["pod2x2x1/model_group"]) == [-1]


def test_production_mesh_places_but_refuses_a_step():
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import scenarios

    for multi_pod, shape in ((False, {"data": 16, "model": 16}), (True, {"pod": 2, "data": 16, "model": 16})):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        assert mesh.shape == shape and mesh.abstract and mesh_lib.n_data_devices(mesh) == 16 * (2 if multi_pod else 1)
        assert mesh_lib.data_axes(mesh) == (("pod", "data") if multi_pod else ("data",))
        with pytest.raises(ValueError, match="no ranks"):
            train.build_train_step(scenarios.lm_arch(), TrainConfig(), None, mesh=mesh, device="cpu")
    arch = scenarios.lm_arch()
    with pytest.raises(ValueError, match="no ranks"):
        serve.serve_traffic(arch, None, None, torch.zeros((1, 4), dtype=torch.int32), device="cpu",
                            mesh=mesh_lib.make_production_mesh())
