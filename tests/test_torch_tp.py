"""The tensor-parallel model axis of the port's ``"protomath"`` step, on the
ranks of a ``gloo`` group on the CPU (tests/torch_tp_ranks.py, one process
a rank, joined through a file under the test's temporary directory, one
world at a time).

(a) On 2 model ranks: ``pmm`` column-parallel (its output cut, ``dx``
    all-reduced) and row-parallel (its output all-reduced, ``dx`` cut),
    and the vocabulary-parallel ``plookup`` (plain and robust), forward
    and backward, against the whole op in one process: rtol 1e-5, atol
    1e-6 of the largest value; the weight's cotangent is its cut of the
    whole op's aggregate.
(b) One exchange on a tp slice, for ``none``, ``rand_sparse``, ``quant``
    and the gaussian attack: bit for bit the whole leaf's exchange at one
    model rank, on the slice's coordinates (the rows are gathered over the
    model ranks for the transforms that draw or read across a row).
(c) The step on data x model = 1 x 2 and 2 x 2 at N=4, ``lm_arch()`` with
    4 heads over 2 kv heads (every weight but the norms cut over the model
    ranks) against the one-rank step: every rank ends with the same
    gathered parameters; losses within relative 2e-6; the parameters
    within 1e-6 of their largest magnitude. Two provisions, from measured
    causes: under QSGD a rounding difference can move one stochastic
    rounding by a level (tests/test_torch_protomath_step.py (b)); and
    AdamW divides each gradient by its running RMS, so a coordinate whose
    gradient nearly cancels carries the model all-reduce's different
    summation order (about 1e-7 of the gradients' scale) into its step at
    full weight: under AdamW at most 8 parameters lie farther, none farther
    than 1e-5 of the largest magnitude, while the same run under SGD with
    momentum lies within 1e-6 everywhere. Each rank stores exactly its cut
    of the parameters and moments; ``sharded`` is bit for bit ``gather``.
(d) The dry run and its report over every arch x shape on ``pod1`` and
    ``pod2``, on ``meta`` tensors: per-rank parameter bytes the sum of the
    cuts the reference's partition specs imply (on a jax ``AbstractMesh``);
    the dense family's train step with its collectives, every other
    family and the serving shapes without, naming ROADMAP A.9d.
"""
from __future__ import annotations

import functools
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

import torch_tp_ranks as ranks

LOSS_RTOL = 2e-6
PARAM_RTOL = 1e-6
ADAMW_FAR, ADAMW_RTOL = 8, 1e-5


@pytest.fixture(scope="module")
def ops_run(tmp_path_factory):
    return ranks.spawn("ops", 2, 2, tmp_path_factory.mktemp("tp_ops"))


# how a whole output comes back from the two model ranks' parts: the axis they are cut on, or None (equal)
_JOIN = {"col/out": -1, "col/dx": None, "col/dw": 1, "row/out": None, "row/dx": -1, "row/dw": 0,
         "lookup/out": None, "lookup/dw": 0}


@pytest.mark.parametrize("robust", [False, True], ids=["plain", "robust"])
@pytest.mark.parametrize("op", ["col", "row", "lookup"])
def test_tp_ops_match_the_whole_op(ops_run, op, robust):
    whole = ranks.run_ops(ranks.op_protocol(1), None, 0, lambda name, a: (a, None), robust)
    pre = "robust" if robust else "plain"
    for key, want in whole.items():
        if not key.startswith(op + "/"):
            continue
        parts = [r[f"{pre}/{key}"] for r in ops_run]
        if _JOIN[key] is None:
            assert np.array_equal(parts[0], parts[1]), (key, "the model ranks disagree")
            got = parts[0]
        else:
            got = np.concatenate(parts, axis=_JOIN[key])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max(), err_msg=f"{pre} {key}")


@pytest.mark.parametrize("name", list(ranks.EXCHANGES))
def test_exchange_on_a_tp_slice_is_bitwise_the_whole_leafs(ops_run, name):
    from repro_torch.core import protomath

    want = protomath.robust_combine(ranks.exchange_protocol(name), torch.tensor(ranks.exchange_inputs()),
                                    ("tp", "fsdp"), seed=9).numpy()
    got = np.concatenate([r[f"exchange/{name}"] for r in ops_run], axis=0)
    assert np.array_equal(got, want), (name, np.abs(got - want).max())


@pytest.fixture(scope="module")
def one_rank():
    from repro_torch.launch.mesh import make_host_mesh

    return ranks.run_configs(make_host_mesh(ranks.N))


@pytest.fixture(scope="module", params=[(2, 2), (4, 2)], ids=["1x2", "2x2"])
def tp_run(request, tmp_path_factory):
    world, model = request.param
    return world, model, ranks.spawn("step", world, model, tmp_path_factory.mktemp(f"tp{world}"))


@pytest.mark.parametrize("name", list(ranks.CONFIGS))
def test_tp_step_matches_one_rank(tp_run, one_rank, name):
    world, model, res = tp_run
    params = res[0][f"{name}/params"]
    for r in res[1:]:  # every rank gathers the same parameters
        assert np.array_equal(r[f"{name}/params"], params), (world, name)
        assert np.array_equal(r[f"{name}/loss"], res[0][f"{name}/loss"]), (world, name)
    want_loss, want = one_rank[name]["loss"], one_rank[name]["params"]
    rel = np.abs(res[0][f"{name}/loss"] - want_loss) / np.abs(want_loss)
    assert rel.max() <= LOSS_RTOL, (world, name, rel)
    scale = np.abs(want).max()
    diff = np.abs(params - want)
    far = int((diff > PARAM_RTOL * scale).sum())
    if "quant" in name:
        assert far <= 8, (world, name, far)
    elif ranks.CONFIGS[name].get("optimizer", ranks._BASE["optimizer"]) == "adamw":
        assert far <= ADAMW_FAR and diff.max() <= ADAMW_RTOL * scale, (world, name, far, diff.max() / scale)
    else:
        assert far == 0, (world, name, far, diff.max() / scale)


def _cut_bytes(arch, mesh, placements_of) -> int:
    """Bytes of one rank's cut of the params and the AdamW moments (bf16,
    ``TrainConfig``'s default), by the placements."""
    import math

    from repro_torch.launch import roofline

    shapes, specs = roofline.param_shapes_and_specs(arch)
    placements = placements_of(specs, mesh, shapes)
    total = 0

    def walk(s, pl):
        nonlocal total
        if isinstance(s, dict):
            for k in s:
                walk(s[k], pl[k])
            return
        n = math.prod(s.shape) // math.prod(mesh.shape[e] if isinstance(e, str) else 1 for e in pl if e)
        total += n * s.element_size() + 2 * n * 2  # the leaf, then mu and nu in bf16
    walk(shapes, placements)
    return total


def test_tp_ranks_store_their_cut(tp_run):
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train

    world, model, res = tp_run
    want = _cut_bytes(ranks.ARCH(), mesh_lib.abstract_mesh(world // model, model), train.param_pspecs)
    for name in ranks.CONFIGS:
        if ranks.CONFIGS[name].get("optimizer") == "sgd_momentum":
            continue  # one moment
        for r in res:
            assert int(r[f"{name}/stored"]) == want, (world, name, int(r[f"{name}/stored"]), want)
    whole = _cut_bytes(ranks.ARCH(), mesh_lib.abstract_mesh(1, 1), train.param_pspecs)
    assert want < whole


@pytest.mark.parametrize("pair", [("cwtm-alie-sharded-mb2", "cwtm-alie-gather-mb2"),
                                  ("nnm-sign_flip-sharded", "nnm-sign_flip-gather"),
                                  ("quant-gaussian-sharded", "quant-gaussian-gather")], ids=["cwtm", "nnm", "quant"])
def test_tp_sharded_server_is_bitwise_gather(tp_run, pair):
    world, _, res = tp_run
    for key in ("params", "loss"):
        assert np.array_equal(res[0][f"{pair[0]}/{key}"], res[0][f"{pair[1]}/{key}"]), (world, pair, key)


@functools.lru_cache(maxsize=None)
def _ref_param_cut_bytes(arch: str, multi_pod: bool) -> int:
    """One rank's bytes of ``arch``'s parameters by the reference's
    partition specs on its production mesh (a jax ``AbstractMesh``)."""
    from repro import models as jmodels
    from repro.configs.archs import ARCHS as JARCHS
    from repro.launch import train as jtrain

    captured = {}

    def only_params(k):
        p, specs = jmodels.init(k, JARCHS[arch])
        captured["specs"] = specs
        return p

    shapes = jax.eval_shape(only_params, jax.random.PRNGKey(0))
    mesh = AbstractMesh((2, 16, 16) if multi_pod else (16, 16),
                        ("pod", "data", "model") if multi_pod else ("data", "model"))
    pspecs = jtrain.param_pspecs(captured["specs"], mesh, shapes)
    total = 0
    for leaf, spec in zip(jax.tree.leaves(shapes), jax.tree.leaves(pspecs, is_leaf=lambda x: isinstance(x,
                                                                                                      PartitionSpec))):
        parts = math.prod(math.prod(mesh.shape[a] for a in (e if isinstance(e, tuple) else (e,))) for e in spec if e)
        total += math.prod(leaf.shape) // parts * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("mesh_name", ["pod1", "pod2"])
def test_dryrun_and_report_over_every_case(tmp_path, mesh_name):
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch import dryrun, report

    recs = dryrun.main(["--all", "--multi-pod", mesh_name, "--out-dir", str(tmp_path)])
    assert len(recs) == len(ARCHS) * len(INPUT_SHAPES) and len(list(tmp_path.glob("*.json"))) == len(recs)
    assert {(r["arch"], r["shape"]) for r in recs if r["status"] == "skipped"} == {("whisper-small", "long_500k")}
    for r in recs:
        if r["status"] != "ok":
            continue
        assert r["params_bytes_per_rank"] == _ref_param_cut_bytes(r["arch"], mesh_name == "pod2"), r["arch"]
        assert r["device"] == "NVIDIA H100 80GB HBM3" and r["ranks"] == (512 if mesh_name == "pod2" else 256)
        dense_train = ARCHS[r["arch"]].family == "dense" and r["shape"] == "train_4k"
        assert (r["collectives"] is not None) == dense_train, (r["arch"], r["shape"])
        if r["collectives"] is None:
            assert "A.9d" in r["collectives_reason"]
        else:
            kinds = r["collectives"]["bytes_by_kind"]
            assert kinds["tp_all_reduce"] > 0 and kinds["exchange_all_to_all"] > 0 and kinds["fsdp_all_gather"] > 0
        if r["shape"] == "train_4k":
            assert 0 < r["exchange_transient_bytes"] and r["moments_bytes_per_rank"] > 0
        if r["shape"] in ("decode_32k", "long_500k"):
            assert r["decode_state_bytes_per_rank"] > 0
    text = report.main(["--dir", str(tmp_path)])
    assert f"## {mesh_name}: {len(recs) - 1} ok / 1 skipped" in text and "MISSING" not in text
