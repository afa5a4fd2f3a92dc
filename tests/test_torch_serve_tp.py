"""Sharded serving (``serve_traffic(mesh=)``, ``models.serving``'s ``shard``)
on a ``gloo`` world of data 2 x model 2 on the CPU, against the JAX
reference and the port's one-rank serving.

The world (tests/torch_serve_ranks.py, four processes of one thread each)
is started once for the module, on the reference's ``PRNGKey(0)``
parameters of each case carried across (float32, ``zoo_arch`` widths),
each rank holding its ``train.param_pspecs`` cut; the reference and the
one-rank port run in this process meanwhile. The cases
(``torch_serve_ranks.CASES``) are every family of ``ZOO_FAMILIES``
(their q heads cut over the model ranks, the one kv head whole, so the
slots of every cache, the cross-attention's included, are cut over
``model``: the flash-decode cut), ``lm_arch()`` with 3 heads over 1 kv
head (no head cut at all), batch 1 (the slots cut over the data ranks), a
12-slot ring whose writes wrap from rank 0's range into rank 1's, the
``swa`` window of 6 (a 6-slot ring, 3 a rank, the window straddling the
two), kv heads cut over ``model`` (the audio family with 2 kv heads, its
cross cache cut on heads) and ``attn_tp="head_dim"``. Held per case:

  * the greedy tokens of ``serve_traffic(mesh=)`` on every rank equal to
    the reference's ``serve_traffic`` on ``make_host_mesh(1, 1)``;
  * with the same tokens fed in, the logits of the prefill and of each
    decode step, joined over the ranks (rows over data, vocabulary over
    model), within rtol 1e-5 and atol 1e-6 of the largest value of the
    port's one-rank ``decode_step`` and of the reference's;
  * each rank's decode-state leaves after the prefill and after the last
    step: the shape of their ``decode_state_pspecs`` cut, and within the
    same tolerance of that cut of the one-rank state (``shard_state``).
    The MoE families (``moe``, ``jamba``) route by each expert's top-C
    tokens at near-ties of the gate weights; their states are held to
    atol 1e-5 of the largest value, as tests/test_torch_serving.py holds
    them against the reference;
  * the collectives of one decode step and its greedy token, by kind, the
    calls and the bytes a rank puts in, equal to the dry run's per-step
    figure for the same arch and shape on an abstract 2 x 2 mesh.

Without ranks: ``init_state_cut`` is born cut (``decode_32k`` of
smollm-360m on ``meta``: 10,737,418,240 cache bytes a rank of 2 x 2, a
quarter of the whole), and what sharded serving refuses.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_serve_ranks as ranks
from repro import models as jmodels
from repro.core import scenarios as jscn
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import serve_traffic as jserve
from repro_torch import convert, models, pytree
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import INPUT_SHAPES, ShapeConfig
from repro_torch.core import scenarios as tscn
from repro_torch.launch import dryrun, serve
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import serving

RTOL, ATOL = 1e-5, 1e-6
ROUTED = ("moe", "jamba")


def _reference(name: str, params, specs) -> dict:
    """The reference's greedy tokens and fed logits (its prefill and
    decode step jitted, as its ``serve_traffic`` runs them), and the
    one-rank port's fed logits and states, for a case."""
    jarch, tarch = ranks.arch_of(jscn, name), ranks.arch_of(tscn, name)
    whole = jax.device_get(params)
    data = ranks.inputs(name, tarch.vocab, tarch.encoder)
    prompt, fed, frontend = data["prompt"], data["fed"], data.get("frontend")
    jfront = None if frontend is None else jnp.asarray(frontend)
    out = {"whole": whole, "data": data}
    out["tokens"] = np.asarray(jserve(jarch, params, specs, make_host_mesh(1, 1), jnp.asarray(prompt),
                                      frontend=jfront, new_tokens=ranks.NEW)["tokens"])
    cap = ranks.capacity_of(name)
    jprefill = jax.jit(lambda p, t, f: jmodels.prefill(p, specs, jarch, t, frontend=f, capacity=cap))
    jdecode = jax.jit(lambda p, t, st: jmodels.decode_step(p, specs, jarch, t, st))
    want, jstate = jprefill(params, jnp.asarray(prompt), jfront)
    ref = [np.asarray(want)]
    for t in range(ranks.NEW):
        want, jstate = jdecode(params, jnp.asarray(fed[:, t:t + 1]), jstate)
        ref.append(np.asarray(want))
    tparams = convert.lm_params_from_numpy(whole)
    tfront = None if frontend is None else torch.from_numpy(frontend)
    logits, state = models.prefill(tparams, None, tarch, torch.from_numpy(prompt), frontend=tfront, capacity=cap)
    port, states = [logits.numpy()], [_clone(state)]  # a copy: decode writes in place
    for t in range(ranks.NEW):
        logits, state = models.decode_step(tparams, None, tarch, torch.from_numpy(fed[:, t:t + 1]), state)
        port.append(logits.numpy())
    states.append(state)
    out.update(ref=ref, port=port, states=states, arch=tarch)
    return out


def _abstract(rank: int = 0):
    return dataclasses.replace(abstract_mesh(2, 2), rank=rank // 2, model_rank=rank % 2)


def _clone(state: dict) -> dict:
    return {k: v.clone() if k == "pos" else type(v)(**{f.name: getattr(v, f.name).clone()
                                                       for f in dataclasses.fields(v)})
            for k, v in state.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Each rank's results and each case's reference, computed while the
    ranks run."""
    out = tmp_path_factory.mktemp("serve_tp")
    refs, arrays, inits = {}, {}, {}
    for name in ranks.CASES:
        inits[name] = params, _ = jmodels.init(jax.random.PRNGKey(0), ranks.arch_of(jscn, name))
        for path, leaf in pytree.paths(convert.lm_params_from_numpy(jax.device_get(params))):
            arrays[f"{name}/param/{path}"] = leaf.numpy()
        tarch = ranks.arch_of(tscn, name)
        arrays.update({f"{name}/{k}": v for k, v in ranks.inputs(name, tarch.vocab, tarch.encoder).items()})
    np.savez(out / "inputs.npz", **arrays)
    procs = ranks.spawn(out)
    try:
        for name in ranks.CASES:
            refs[name] = _reference(name, *inits[name])
    finally:
        res = ranks.wait(procs, out)
    return res, refs


def _join(parts: list[np.ndarray], vocab: int, batch: int) -> np.ndarray:
    """The whole (B, V) from the four ranks' cuts (rank = 2 * data rank +
    model rank): the vocabulary over the model ranks where it is cut, the
    rows over the data ranks where they are."""
    rows = [np.concatenate(parts[2 * d:2 * d + 2], -1) if parts[2 * d].shape[-1] < vocab else parts[2 * d]
            for d in range(2)]
    return np.concatenate(rows, 0) if rows[0].shape[0] < batch else rows[0]


@pytest.mark.parametrize("name", list(ranks.CASES))
def test_sharded_greedy_tokens_match_reference(world, name):
    res, refs = world
    for r in res:
        np.testing.assert_array_equal(r[f"{name}/tokens"], refs[name]["tokens"], err_msg=name)
        assert int(r[f"{name}/pos"]) == ranks.S0 + ranks.NEW


@pytest.mark.parametrize("name", list(ranks.CASES))
def test_sharded_logits_match_one_rank_and_reference(world, name):
    res, refs = world
    ref = refs[name]
    b = ranks.CASES[name][2]
    for t in range(ranks.NEW + 1):
        parts = [r[f"{name}/logits{t}"] for r in res]
        got = _join(parts, ref["arch"].vocab, b)
        for want, who in ((ref["port"][t], "one-rank port"), (ref["ref"][t], "reference")):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * float(np.abs(want).max()),
                                       err_msg=f"{name} step {t} against the {who}")


@pytest.mark.parametrize("name", list(ranks.CASES))
def test_each_rank_stores_its_decode_state_cut(world, name):
    res, refs = world
    for tag, whole in zip(("state0", "state1"), refs[name]["states"]):
        for r, got in enumerate(res):
            cut = serve.shard_state(whole, _abstract(r))
            specs = serve._state_specs(whole, _abstract(r))
            for path, leaf in pytree.paths(cut):
                g = got[f"{name}/{tag}/{path}"]
                want_shape = tuple(n // (2 if e else 1) for n, e in zip(pytree_shape(whole, path), specs[path]))
                assert g.shape == tuple(leaf.shape) == want_shape, (name, tag, r, path)
                w = leaf.numpy()
                if w.dtype.kind in "iu":
                    np.testing.assert_array_equal(g, w, err_msg=f"{name} {tag} rank {r} {path}")
                    continue
                scale = float(np.abs(w).max())
                atol = (1e-5 if name in ROUTED else ATOL) * scale
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol, err_msg=f"{name} {tag} rank {r} {path}")


def pytree_shape(tree, path: str) -> tuple:
    return dict((p, tuple(leaf.shape)) for p, leaf in pytree.paths(tree))[path]


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("name", list(ranks.CASES))
def test_dryrun_counts_the_sharded_step(world, name, kind):
    """The collectives a rank counted (``protomath.collective_counts``)
    in one decode step or the prefill, each with its greedy token, equal
    the dry run's figure for that arch and shape on a 2 x 2 mesh."""
    res, refs = world
    cfg, b = refs[name]["arch"], ranks.CASES[name][2]
    if kind == "decode":
        shape = ShapeConfig("fed", ranks.capacity_of(name) or ranks.S0, b, "decode")
    else:
        shape = ShapeConfig("prompt", ranks.S0, b, "prefill")
    want = {k: (v["calls"], v["bytes"]) for k, v in dryrun.serve_collectives(cfg, shape, _abstract()).items()}
    tag = "coll" if kind == "decode" else "pcoll"
    for r in res:
        got = {k.split("/")[-1]: tuple(int(x) for x in v) for k, v in r.items() if k.startswith(f"{name}/{tag}/")}
        assert got == want, (name, kind, got, want)


def test_init_state_cut_is_born_cut():
    """smollm-360m's ``decode_32k`` state on a 2 x 2 mesh, on ``meta``:
    each rank's cut is 10,737,418,240 cache bytes, a quarter of the whole
    42,949,672,960, and every leaf the shape ``shard_state`` gives."""
    arch, shape = ARCHS["smollm-360m"], INPUT_SHAPES["decode_32k"]
    whole = serving.init_decode_state(arch, shape.global_batch, shape.seq_len, device="meta")
    cache = sum(leaf.numel() * leaf.element_size() for p, leaf in pytree.paths(whole) if p.endswith((".k", ".v")))
    assert cache == 42_949_672_960
    for r in range(4):
        cut = serve.init_state_cut(arch, shape.global_batch, shape.seq_len, _abstract(r), device="meta")
        mine = sum(leaf.numel() * leaf.element_size() for p, leaf in pytree.paths(cut) if p.endswith((".k", ".v")))
        assert mine == 10_737_418_240 == cache // 4
        specs = serve._state_specs(whole, _abstract(r))
        for path, leaf in pytree.paths(cut):
            want = tuple(n // (2 if e else 1) for n, e in zip(tuple(dict(pytree.paths(whole))[path].shape),
                                                               specs[path]))
            assert tuple(leaf.shape) == want, path
    small = serve.init_state_cut(ARCHS["smollm-360m"].scaled(n_layers=2, d_model=30, n_heads=3, n_kv_heads=1,
                                                             head_dim=10, d_ff=64, vocab=64), 4, 16, _abstract(3),
                                 filled=7)
    assert int(small["pos"]) == 7 and bool((small["blk0"].length == 7).all())
    assert small["blk0"].k.shape == (2, 2, 8, 1, 10)  # (periods, rows, slots, kv heads, head_dim): B and C halved


def test_sharded_serving_refuses_graph_mode_and_a_mesh_without_ranks():
    """Over more than one rank, graph mode raises naming A.14 (gloo's
    collectives do not capture); a mesh with no ranks raises "no ranks";
    neither falls back to one rank."""
    arch = tscn.lm_arch()
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="no ranks"):
        serve.serve_traffic(arch, None, None, tokens, mode="loop", device="cpu", mesh=abstract_mesh(2, 2))
    ranked = dataclasses.replace(abstract_mesh(2, 2), abstract=False)  # the check precedes any collective
    with pytest.raises(ValueError, match="A.14"):
        serve.serve_traffic(arch, None, None, tokens, mode="graph", device="cpu", mesh=ranked)
