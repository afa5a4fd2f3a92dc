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
    every family's train step with its collectives (the MoE's expert
    gathers and the logits' all-reduce of ``attn_tp="head_dim"`` among
    them), and every serving shape's (a decode step or a prefill and its
    greedy token, by kind, with the weights' one-time gather).
(e) The other families' ops on 2 model ranks against the whole op in one
    process (``torch_tp_ranks.run_tp_ops``), forward and backward, rtol
    1e-5 and atol 1e-6 of the largest value, every output and cotangent
    joined whole over the ranks (the two ranks' joins equal): the
    expert-parallel ``pmm`` (a whole input and a cut one), the cut-aware
    ``pscale``/``pbias``/``block_tap`` (a cut vector, a row of a cut leaf,
    a tensor derived from a cut leaf), a whole leaf on a cut input,
    attention with the q heads alone cut, attention with ``head_dim`` cut
    and RoPE on the plain path and the chunked one, and the MoE, Mamba and
    RWKV layers; and an exchange on each new slice kind (experts, a
    ``d_inner`` vector, RWKV's heads) bit for bit the whole leaf's under
    ``none``, ``rand_sparse``, ``quant`` and the gaussian attack.
(f) Every family's step (``torch_tp_ranks.FAMILIES``) on 1 x 2 and 2 x 2
    against the one-rank step, as (c): the ranks' gathered parameters
    equal, losses within relative 2e-6, ``sharded`` bit for bit
    ``gather``, each rank storing exactly its cut. The SGD run's
    parameters lie within 1e-6 of their largest magnitude everywhere;
    under AdamW (the measured cause of (c), over up to 135,264 parameters
    at jamba) at most 0.1 % of them lie farther, none farther than 1e-5.
(g) ``convert.lm_params_from_numpy`` cuts the reference's MoE, Mamba
    (jamba), RWKV, vlm and audio trees over a 2 x 2 mesh: each rank's leaf
    is the slice the reference's partition spec gives it, bit for bit.
"""
from __future__ import annotations

import dataclasses
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


@functools.lru_cache(maxsize=None)
def _whole_tp_ops() -> dict:
    return ranks.run_tp_ops(ranks.op_protocol(1))


@pytest.mark.parametrize("name", ranks.TP_OPS)
def test_tp_family_ops_match_the_whole_op(ops_run, name):
    whole = _whole_tp_ops()
    keys = [k for k in whole if k.split("/")[0] == name]
    assert keys, name
    for key in keys:
        got, want = ops_run[0][f"tp/{key}"], whole[key]
        assert np.array_equal(got, ops_run[1][f"tp/{key}"]), (key, "the model ranks' joins differ")
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max(), err_msg=key)


@pytest.mark.parametrize("name", list(ranks.EXCHANGES))
@pytest.mark.parametrize("kind", [k for k in ranks.SLICES if k != "column"])
def test_exchange_on_each_slice_kind_is_bitwise_the_whole_leafs(ops_run, kind, name):
    from repro_torch.core import protomath

    _, w_spec, dim = ranks.SLICES[kind]
    want = protomath.robust_combine(ranks.exchange_protocol(name), torch.tensor(ranks.slice_inputs(kind)), w_spec,
                                    seed=9).numpy()
    got = np.concatenate([r[f"exchange/{kind}/{name}"] for r in ops_run], axis=dim)
    assert np.array_equal(got, want), (kind, name, np.abs(got - want).max())


@pytest.fixture(scope="module")
def one_rank_families():
    from repro_torch.launch.mesh import make_host_mesh

    return {fam: ranks.run_configs(make_host_mesh(ranks.N), arch, ranks.FAMILY_CONFIGS)
            for fam, arch in ranks.FAMILIES().items()}


@pytest.fixture(scope="module", params=[(2, 2), (4, 2)], ids=["1x2", "2x2"])
def families_run(request, tmp_path_factory):
    world, model = request.param
    return world, model, ranks.spawn("families", world, model, tmp_path_factory.mktemp(f"families{world}"))


FAMILY_ADAMW_SHARE = 1e-3


@pytest.mark.parametrize("name", list(ranks.FAMILY_CONFIGS))
@pytest.mark.parametrize("family", list(ranks.FAMILIES()))
def test_tp_family_step_matches_one_rank(families_run, one_rank_families, family, name):
    world, model, res = families_run
    key = f"{family}/{name}"
    params = res[0][f"{key}/params"]
    for r in res[1:]:
        assert np.array_equal(r[f"{key}/params"], params), (world, key)
        assert np.array_equal(r[f"{key}/loss"], res[0][f"{key}/loss"]), (world, key)
    want_loss, want = one_rank_families[family][name]["loss"], one_rank_families[family][name]["params"]
    rel = np.abs(res[0][f"{key}/loss"] - want_loss) / np.abs(want_loss)
    assert rel.max() <= LOSS_RTOL, (world, key, rel)
    scale = np.abs(want).max()
    diff = np.abs(params - want)
    far = int((diff > PARAM_RTOL * scale).sum())
    if ranks.FAMILY_CONFIGS[name].get("optimizer", ranks._BASE["optimizer"]) == "adamw":
        assert far <= FAMILY_ADAMW_SHARE * params.size and diff.max() <= ADAMW_RTOL * scale, \
            (world, key, far, diff.max() / scale)
    else:
        assert far == 0, (world, key, far, diff.max() / scale)


@pytest.mark.parametrize("family", list(ranks.FAMILIES()))
def test_tp_family_sharded_is_bitwise_gather_and_stores_its_cut(families_run, family):
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train

    world, model, res = families_run
    for pair in (("nnm-sign_flip-sharded", "nnm-sign_flip-gather"), ("quant-gaussian-sharded", "quant-gaussian-gather")):
        for what in ("params", "loss"):
            assert np.array_equal(res[0][f"{family}/{pair[0]}/{what}"], res[0][f"{family}/{pair[1]}/{what}"]), \
                (world, family, pair, what)
    arch = ranks.FAMILIES()[family]
    want = _cut_bytes(arch, mesh_lib.abstract_mesh(world // model, model), train.param_pspecs)
    for r in res:
        assert int(r[f"{family}/nnm-sign_flip-sharded/stored"]) == want, (world, family)
    assert want < _cut_bytes(arch, mesh_lib.abstract_mesh(1, 1), train.param_pspecs)


@pytest.mark.parametrize("family", ["moe", "jamba", "rwkv", "cross", "audio"])
def test_lm_params_from_numpy_cuts_every_family_over_2x2(family):
    from repro import models as jmodels
    from repro.core.scenarios import zoo_arch as jzoo_arch
    from repro.launch import train as jtrain

    from repro_torch import convert, pytree
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import roofline, train

    jarch = jzoo_arch(family)
    params, specs = jmodels.init(jax.random.PRNGKey(0), jarch)
    whole = jax.tree.map(np.asarray, params)
    ref_pspecs = jtrain.param_pspecs(specs, AbstractMesh((2, 2), ("data", "model")), params)
    flat_ref = {"/".join(str(getattr(k, "key", k)) for k in path): spec for path, spec in
                jax.tree_util.tree_flatten_with_path(ref_pspecs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}
    shapes, tspecs = roofline.param_shapes_and_specs(ranks.FAMILIES()[family])
    base = mesh_lib.abstract_mesh(2, 2)
    placements = train.param_pspecs(tspecs, base, shapes)
    for d in range(2):
        for m in range(2):
            cut = convert.lm_params_from_numpy(whole, placements=placements,
                                               mesh=dataclasses.replace(base, rank=d, model_rank=m))
            for path, leaf in pytree.paths(cut):
                want = np.asarray(_at(whole, path))
                for dim, entry in enumerate(flat_ref[path]):
                    if entry is not None:
                        i, n = (m, 2) if entry == "model" else (d, 2)
                        size = want.shape[dim] // n
                        want = np.take(want, range(i * size, (i + 1) * size), axis=dim)
                assert np.array_equal(leaf.float().numpy(), want.astype(np.float32)), (family, path, d, m)


def _at(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


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


def _ref_param_cut_bytes_data_only(arch: str, multi_pod: bool) -> int:
    """One rank's parameter bytes were nothing cut over the model ranks."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import roofline, train

    shapes, specs = roofline.param_shapes_and_specs(ARCHS[arch])
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    placements = train.param_pspecs(specs, mesh, shapes)
    total = 0

    def walk(t, pl):
        nonlocal total
        if isinstance(t, dict):
            for k in t:
                walk(t[k], pl[k])
            return
        parts = math.prod(mesh.shape[e] if isinstance(e, str) else math.prod(mesh.shape[a] for a in e)
                          for e in pl if e and e != "model")
        total += t.numel() // parts * t.element_size()
    walk(shapes, placements)
    return total


def test_dryrun_counts_the_logits_all_reduce_of_a_cut_head_dim():
    """``attn_tp="head_dim"`` (smollm-360m with 16 heads of 64, cut on
    ``head_dim`` over the 16 model ranks of ``pod1``): the logits' partial
    sums, forward and backward, and RoPE's gathered ``head_dim``."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import INPUT_SHAPES, TrainConfig
    from repro_torch.launch import dryrun, roofline, train
    from repro_torch.launch.mesh import make_production_mesh

    cfg = ARCHS["smollm-360m"].scaled(attn_tp="head_dim", n_heads=16, n_kv_heads=16, head_dim=64)
    shapes, specs = roofline.param_shapes_and_specs(cfg)
    mesh = make_production_mesh()
    leaves = dryrun._placed(shapes, train.param_pspecs(specs, mesh, shapes))
    kinds = dryrun._train_wire(cfg, INPUT_SHAPES["train_4k"], mesh, TrainConfig(), leaves)
    shape, rows = INPUT_SHAPES["train_4k"], 256 // 16 * 2  # a rank's sequences: d = 2
    # 5 times the logits past the plain threshold, and dout . out once, a layer, 2(r-1)/r of each on the wire
    want = 2 * 15 / 16 * cfg.n_layers * (5 * rows * 16 * shape.seq_len ** 2 * 4 + rows * 16 * shape.seq_len * 4)
    assert kinds["tp_logits_all_reduce"] == pytest.approx(want)
    assert kinds["tp_all_gather"] > 0


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
        train_shape = r["shape"] == "train_4k"
        assert r["collectives"] is not None and "collectives_reason" not in r, (r["arch"], r["shape"])
        if not train_shape:  # a serving rank's step: by kind, calls and bytes put in, and the weights' one gather
            c = r["collectives"]
            assert set(c["bytes_by_kind"]) == set(c["calls_by_kind"]) == set(c["payload_bytes_by_kind"])
            assert c["total_wire_bytes"] == pytest.approx(sum(c["bytes_by_kind"].values()))
            assert c["weights_gather_once"]["calls"] > 0 and c["weights_gather_once"]["wire_bytes"] > 0
            assert sum(c["calls_by_kind"].values()) > 0, (r["arch"], r["shape"])
        else:
            kinds = r["collectives"]["bytes_by_kind"]
            assert kinds["exchange_all_to_all"] > 0 and kinds["fsdp_all_gather"] > 0, r["arch"]
            model_cut = r["params_bytes_per_rank"] < _ref_param_cut_bytes_data_only(r["arch"], mesh_name == "pod2")
            assert (kinds["tp_all_reduce"] > 0) == model_cut, (r["arch"], kinds)
            # the families whose cut runs model-rank gathers: experts (qwen3's 128, jamba's 16 over 16 ranks),
            # Mamba's in_proj halves, RWKV's receptance
            gathers = r["arch"] in ("qwen3-moe-235b-a22b", "jamba-1.5-large-398b", "rwkv6-1.6b")
            assert (kinds["tp_all_gather"] > 0) == gathers, (r["arch"], kinds)
            assert kinds["tp_logits_all_reduce"] == 0  # no arch of the catalog takes attn_tp="head_dim"
        if r["shape"] == "train_4k":
            assert 0 < r["exchange_transient_bytes"] and r["moments_bytes_per_rank"] > 0
        if r["shape"] in ("decode_32k", "long_500k"):
            assert r["decode_state_bytes_per_rank"] > 0
    text = report.main(["--dir", str(tmp_path)])
    assert f"## {mesh_name}: {len(recs) - 1} ok / 1 skipped" in text and "MISSING" not in text
