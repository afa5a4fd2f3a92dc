"""The port's transformer LM against the JAX reference's, op by op, on the CPU.

Both sides run on the reference's ``PRNGKey(0)`` parameters (widened to
float32, as the reference's ``_lm_fns`` does), carried across leaf for leaf
by ``convert.lm_params_from_numpy``, and on the same inputs, drawn with
numpy. Two architectures: ``lm_arch()`` (1 layer, d_model 32, 2:1 GQA) and
``reduced(ARCHS["smollm-360m"])`` (2 layers, d_model 256, 3 query heads on
1 KV head, vocab 512).

Tolerance: rtol 1e-5, atol 1e-6 per op (as tests/test_kernels.py) for the
norms, RoPE, the MLP, attention's keys and values, the loss and every leaf
of the per-subset gradients; measured, every gradient leaf sits within 0.14
of that allowance. The logits, the hidden states and attention's output
are sums of many terms that can cancel, so a value near zero carries the
rounding of the values' own scale: they are held to rtol 1e-5 with atol
1e-5 times their largest magnitude (measured: the logits 1.7e-6 off at a
largest logit of 2.46, about 15 times inside; attention's output 3.1e-6
at a largest value near 8). The flat parameter vector is bitwise the
reference's ``flatten_pytree``.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs.archs import ARCHS as JARCHS
from repro.configs.archs import reduced as jreduced
from repro.core import scenarios as jscn
from repro.core.coding import flatten_pytree as jflatten
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtrans
from repro_torch import convert, models, pytree
from repro_torch.configs.archs import ARCHS as TARCHS
from repro_torch.configs.archs import reduced as treduced
from repro_torch.core import scenarios as tscn
from repro_torch.core.coding import flatten_pytree, unflatten_pytree
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import module as tmodule
from repro_torch.models import transformer as ttrans

RTOL, ATOL = 1e-5, 1e-6
ARCH_PAIRS = {
    "lm_arch": (jscn.lm_arch, tscn.lm_arch),
    "reduced-smollm": (lambda: jreduced(JARCHS["smollm-360m"]), lambda: treduced(TARCHS["smollm-360m"])),
}


def close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module", params=list(ARCH_PAIRS))
def carried(request):
    """(reference arch, port arch, reference params, specs, port params)."""
    jarch_of, tarch_of = ARCH_PAIRS[request.param]
    jarch, tarch = jarch_of(), tarch_of()
    params, specs = jmodels.init(jax.random.PRNGKey(0), jarch)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return jarch, tarch, params, specs, convert.lm_params_from_numpy(jax.tree.map(np.asarray, params))


def _tokens(arch, n=4, b=2, s=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, arch.vocab, (n, b, s + 1))
    return toks[..., :-1], toks[..., 1:]


def test_archs_match_reference():
    """Every architecture of the table, entry for entry, and ``reduced``."""
    assert sorted(TARCHS) == sorted(JARCHS)
    for name in JARCHS:
        for j, t in ((JARCHS[name], TARCHS[name]), (jreduced(JARCHS[name]), treduced(TARCHS[name]))):
            assert repr(t) == repr(j), name
            assert t.n_periods == j.n_periods and t.resolved_head_dim == j.resolved_head_dim
            assert t.dtype == getattr(torch, j.param_dtype)
    assert tscn.lm_arch() == tscn.lm_arch() and repr(tscn.lm_arch()) == repr(jscn.lm_arch())


def test_smollm_360m_parameter_count():
    """The port's model at smollm-360m's published widths has the
    reference's leaf shapes (built at one layer, to keep the test's memory
    small: every stacked leaf leads with the layer count) and P =
    361,821,120 parameters at its 32 layers."""
    jarch = JARCHS["smollm-360m"]
    shapes = jax.eval_shape(lambda k: jmodels.init(k, jarch)[0], jax.random.PRNGKey(0))
    want = [tuple(leaf.shape) for leaf in jax.tree.leaves(shapes)]
    params, _ = models.init(torch.Generator().manual_seed(0), TARCHS["smollm-360m"].scaled(n_layers=1))
    top = [params["embed"]["table"], params["ln_f"]]
    stacked = pytree.leaves(params["periods"])
    assert [tuple(t.shape) for t in top] + [(jarch.n_layers,) + tuple(t.shape[1:]) for t in stacked] == want
    assert top[0].dtype == torch.bfloat16
    count = sum(t.numel() for t in top) + jarch.n_layers * sum(t.numel() for t in stacked)
    assert count == 361_821_120 == sum(math.prod(s) for s in want)


@pytest.mark.parametrize("name", list(ARCH_PAIRS))
def test_init_tree_specs_and_ranges(name):
    """The port's own initialisation: the reference's tree, shapes and
    logical-axis specs; truncated normals within 2 standard deviations of
    scale / sqrt(fan_in), norm scales at 1."""
    jarch, tarch = (f() for f in ARCH_PAIRS[name])
    jparams, jspecs = jmodels.init(jax.random.PRNGKey(0), jarch)
    params, specs = models.init(torch.Generator().manual_seed(0), tarch)
    assert [tuple(p.shape) for p in pytree.leaves(params)] == [p.shape for p in jax.tree.leaves(jparams)]
    assert specs == jax.tree.map(tuple, jspecs, is_leaf=lambda x: isinstance(x, tuple))
    table = params["embed"]["table"]
    assert table.dtype == tarch.dtype and float(table.abs().max()) <= 2.0 / math.sqrt(tarch.vocab) * (1 + 1e-6)
    # a normal truncated at 2 sigma has standard deviation 0.8796 sigma
    assert float(table.std()) == pytest.approx(0.8796 / math.sqrt(tarch.vocab), rel=0.05)
    assert torch.equal(params["ln_f"], torch.ones(tarch.d_model))
    again, _ = models.init(torch.Generator().manual_seed(0), tarch)
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(params), pytree.leaves(again)))


def test_module_helpers_match_reference(carried):
    """``tree_size``/``tree_bytes`` of the carried tree, and the constant
    initializers' values, dtypes and specs, are the reference's."""
    from repro.models import module as jmodule

    _, _, params, _, tparams = carried
    assert tmodule.tree_size(tparams) == jmodule.tree_size(params)
    assert tmodule.tree_bytes(tparams) == jmodule.tree_bytes(params)
    for tfn, jfn, dtype in ((tmodule.zeros_param, jmodule.zeros_param, torch.bfloat16),
                            (tmodule.scale_param, jmodule.scale_param, torch.float32)):
        got, gspec = tfn((3, 4), ("tp", None))
        want, wspec = jfn((3, 4), ("tp", None))
        assert gspec == wspec and got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    with pytest.raises(ValueError):
        tmodule.dense_param(torch.Generator(), (3, 4), ("tp",))


def test_flatten_order_and_round_trip_are_the_reference(carried):
    """The flat vector is the reference's bit for bit, in
    ``jax.tree.flatten``'s leaf order; ``unflatten_pytree`` gives views of
    it that flatten back to the same bits."""
    _, _, params, _, tparams = carried
    want, _ = jflatten(params)
    flat, spec = flatten_pytree(tparams)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    for (p, leaf), tleaf in zip(jax.tree_util.tree_leaves_with_path(params), pytree.leaves(tparams)):
        np.testing.assert_array_equal(tleaf.numpy(), np.asarray(leaf), err_msg=jax.tree_util.keystr(p))
    back = unflatten_pytree(flat, spec)
    base = flat.data_ptr()
    for leaf in pytree.leaves(back):
        assert base <= leaf.data_ptr() < base + flat.numel() * 4  # a view, nothing copied
    again, _ = flatten_pytree(back)
    assert torch.equal(again, flat)
    stacked = unflatten_pytree(torch.stack([flat, 2 * flat]), spec)
    assert torch.equal(pytree.leaves(stacked)[-1][1], 2 * pytree.leaves(back)[-1])


def test_unflatten_checks_the_size():
    flat, spec = flatten_pytree({"a": torch.zeros(3), "b": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="7"):
        unflatten_pytree(torch.zeros(8), spec)


def test_bfloat16_leaves_carry_across_exactly():
    """A bf16 parameter tree (the published configs' dtype) carries across
    as bf16, and widened to float32 flattens to the reference's vector."""
    jarch = jreduced(JARCHS["smollm-360m"]).scaled(param_dtype="bfloat16", n_layers=1)
    params, _ = jmodels.init(jax.random.PRNGKey(1), jarch)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params))
    assert pytree.leaves(tparams)[0].dtype == torch.bfloat16
    want, _ = jflatten(jax.tree.map(lambda a: a.astype(jnp.float32), params))
    got, _ = flatten_pytree(pytree.map_tree(lambda a: a.to(torch.float32), tparams))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rmsnorm_matches(carried):
    jarch, _, params, _, tparams = carried
    x = np.random.default_rng(1).standard_normal((2, 16, jarch.d_model)).astype(np.float32) * 3
    scale = params["periods"]["blk0"]["ln1"][0]
    want = jlayers.rmsnorm({"scale": scale}, jnp.asarray(x), jarch.norm_eps)
    got = tlayers.rmsnorm({"scale": tparams["periods"]["blk0"]["ln1"][0]}, torch.from_numpy(x), jarch.norm_eps)
    close(got, want)


@pytest.mark.parametrize("head_dim,theta", [(16, 500000.0), (64, 500000.0), (64, 10000.0)])
def test_apply_rope_matches(head_dim, theta):
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 24, 3, head_dim)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    close(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), theta),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    close(tlayers.rope_frequencies(head_dim, theta), jlayers.rope_frequencies(head_dim, theta))


@pytest.mark.parametrize("d_model", [8, 9])
def test_sinusoidal_positions_match(d_model):
    close(tlayers.sinusoidal_positions(12, d_model), jlayers.sinusoidal_positions(12, d_model))


def test_mlp_matches(carried):
    jarch, _, params, _, tparams = carried
    x = np.random.default_rng(2).standard_normal((2, 16, jarch.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], params["periods"]["blk0"]["mlp"])
    tp = pytree.map_tree(lambda a: a[0], tparams["periods"]["blk0"]["mlp"])
    close(tlayers.mlp(tp, torch.from_numpy(x)), jlayers.mlp(jp, jnp.asarray(x)))


def test_lookup_is_the_gather_exactly(carried):
    """The one-hot product equals the gather bit for bit, forward."""
    _, tarch, _, _, tparams = carried
    table = tparams["embed"]["table"]
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, tarch.vocab, (3, 7)))
    assert torch.equal(tlayers.lookup(table, ids), table[ids])


@pytest.mark.parametrize("window", [None, 5, "cross"])
def test_multihead_attention_matches(carried, window):
    """Causal self-attention with RoPE, with a sliding window, and
    cross-attention to 8 other positions (no RoPE, not causal)."""
    jarch, tarch, params, _, tparams = carried
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, jarch.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    jp = jax.tree.map(lambda a: a[0], params["periods"]["blk0"]["mixer"])
    tp = pytree.map_tree(lambda a: a[0], tparams["periods"]["blk0"]["mixer"])
    kw = dict(n_heads=jarch.n_heads, n_kv_heads=jarch.n_kv_heads, rope_theta=jarch.rope_theta, window=window)
    jkw, tkw = {}, {}
    if window == "cross":
        src = rng.standard_normal((2, 8, jarch.d_model)).astype(np.float32)
        kpos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8)).copy()
        kw.update(rope_theta=None, window=None, causal=False)
        jkw = dict(kv_override=jnp.asarray(src), kv_positions=jnp.asarray(kpos))
        tkw = dict(kv_override=torch.from_numpy(src), kv_positions=torch.from_numpy(kpos))
    want = jattn.multihead_attention(jp, jnp.asarray(x), jnp.asarray(pos), **kw, **jkw)
    got = tattn.multihead_attention(tp, torch.from_numpy(x), torch.from_numpy(pos), **kw, **tkw)
    close(got[0], want[0], atol=1e-5 * float(np.abs(np.asarray(want[0])).max()), what="out")
    for g, w, what in zip(got[1:], want[1:], ("k", "v")):
        close(g, w, what=what)


def test_long_sequences_and_other_families_raise():
    """The reference's flash path (sequences over 2048) waits for A.8. The
    other families are ported (tests/test_torch_zoo_ops.py): they build,
    and the frontend families refuse a batch without their frontend."""
    arch = tscn.lm_arch()
    params, _ = models.init(torch.Generator().manual_seed(0), arch)
    x = torch.zeros((1, tattn.PLAIN_THRESHOLD + 1, arch.d_model))
    pos = torch.arange(tattn.PLAIN_THRESHOLD + 1)[None]
    mixer = pytree.map_tree(lambda a: a[0], params["periods"]["blk0"]["mixer"])
    with pytest.raises(ValueError, match="A.8"):
        tattn.multihead_attention(mixer, x, pos, n_heads=arch.n_heads, n_kv_heads=arch.n_kv_heads, rope_theta=1e4)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    for name in ("granite-moe-3b-a800m", "rwkv6-1.6b", "whisper-small", "jamba-1.5-large-398b"):
        arch = treduced(TARCHS[name])
        params, _ = models.init(torch.Generator().manual_seed(0), arch)
        if arch.family == "audio":
            with pytest.raises(ValueError, match="frontend"):
                models.forward(params, None, arch, tokens)
        else:
            assert models.forward(params, None, arch, tokens)[0].shape == (1, 8, arch.vocab)


def test_forward_matches(carried):
    jarch, tarch, params, specs, tparams = carried
    tok, _ = _tokens(jarch)
    want, _ = jmodels.forward(params, specs, jarch, jnp.asarray(tok[0]), remat=False)
    got, aux = models.forward(tparams, None, tarch, torch.from_numpy(tok[0]))
    close(got, want, atol=1e-5 * float(np.abs(np.asarray(want)).max()))
    assert float(aux) == 0.0
    hidden, _, _ = ttrans.hidden_states(tparams, None, tarch, torch.from_numpy(tok[0]))
    jhidden, _, _ = jtrans.hidden_states(params, specs, jarch, jnp.asarray(tok[0]), remat=False)
    close(hidden, jhidden, atol=1e-5 * float(np.abs(np.asarray(jhidden)).max()))


@pytest.mark.parametrize("chunk", [512, 4])
def test_chunked_ce_matches(carried, monkeypatch, chunk):
    """One chunk (the default CE_CHUNK covers 16 positions) and four."""
    jarch, _, params, _, tparams = carried
    monkeypatch.setattr(jtrans, "CE_CHUNK", chunk)
    monkeypatch.setattr(ttrans, "CE_CHUNK", chunk)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, jarch.d_model)).astype(np.float32)
    _, lab = _tokens(jarch, seed=5)
    head = params["embed"]["table"]
    want = jtrans._chunked_ce(jnp.asarray(x), head, jnp.asarray(lab[0]))
    got = ttrans._chunked_ce(torch.from_numpy(x), tparams["embed"]["table"], torch.from_numpy(lab[0]))
    close(got, want)


def test_loss_fn_matches(carried):
    jarch, tarch, params, specs, tparams = carried
    tok, lab = _tokens(jarch, seed=6)
    (want, wparts) = jmodels.loss_fn(params, specs, jarch, {"tokens": jnp.asarray(tok[1]),
                                                            "labels": jnp.asarray(lab[1])}, remat=False)
    got, parts = models.loss_fn(tparams, None, tarch, {"tokens": torch.from_numpy(tok[1]),
                                                       "labels": torch.from_numpy(lab[1])})
    close(got, want)
    close(parts["nll"], wparts["nll"])


def test_per_subset_gradients_match(carried):
    """``vmap(grad)`` of the loss over 4 subsets, leaf by leaf, against
    ``jax.vmap(jax.grad)``; and the engine's flat ``(N, P)`` stack
    (``_lm_fns``' subset gradients: ``vmap`` of the loss's ``vjp`` pulled
    back with ``create_graph=False``, through the per-period views) is
    those leaves flattened, to the same tolerance, and bit for bit the
    same ``vjp`` taken on the tree's own leaves."""
    jarch, tarch, params, specs, tparams = carried
    tok, lab = _tokens(jarch, seed=7)

    def jloss(p, t, l):
        return jmodels.loss_fn(p, specs, jarch, {"tokens": t, "labels": l}, remat=False)[0]

    want = jax.vmap(jax.grad(jloss), in_axes=(None, 0, 0))(params, jnp.asarray(tok), jnp.asarray(lab))
    got = torch.func.vmap(torch.func.grad(lambda p, t, l: models.loss_fn(p, None, tarch, {"tokens": t,
                                                                                          "labels": l})[0]),
                          in_dims=(None, 0, 0))(tparams, torch.from_numpy(tok), torch.from_numpy(lab))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), pytree.leaves(got)):
        close(g, w, what=jax.tree_util.keystr(path))
    _, spec, subset_grads, _ = tscn._lm_fns(tarch)
    flat, _ = flatten_pytree(tparams)
    stack = subset_grads((torch.from_numpy(tok), torch.from_numpy(lab)), flat)
    assert stack.shape == (4, flat.numel())

    def pulled_back(p, t, l):
        loss, pullback = torch.func.vjp(lambda q: models.loss_fn(q, None, tarch, {"tokens": t, "labels": l})[0], p)
        return pullback(torch.ones_like(loss), retain_graph=False, create_graph=False)[0]

    same = torch.func.vmap(pulled_back, in_dims=(None, 0, 0))(ttrans.unstack_periods(tparams), torch.from_numpy(tok),
                                                              torch.from_numpy(lab))
    for n in range(4):
        row, _ = flatten_pytree(pytree.map_tree(lambda a: a[n], got))
        np.testing.assert_allclose(stack[n].numpy(), row.numpy(), rtol=RTOL, atol=ATOL)
        assert torch.equal(stack[n], _per_period_flat(same, n, spec))


def _per_period_flat(grads, n: int, spec) -> torch.Tensor:
    """Subset ``n``'s gradient, given per period, as one flat vector."""
    flat = torch.empty(sum(math.prod(shape) for shape in spec[1]))
    for g, dst in zip(pytree.leaves(grads), pytree.leaves(ttrans.unstack_periods(unflatten_pytree(flat, spec)))):
        dst.copy_(g[n])
    return flat


def test_vmapped_gradient_is_a_plain_backward():
    """On the CPU a subset's row of the stack equals a plain ``backward()``
    on its rows to a few ulps (the card's bound is tests/test_torch_card.py's)."""
    arch = treduced(TARCHS["smollm-360m"])
    x0, spec, subset_grads, _ = tscn._lm_fns(arch)
    tok, lab = (torch.from_numpy(a) for a in _tokens(arch, n=3, seed=8))
    stack = subset_grads((tok, lab), x0)
    tree = pytree.map_tree(lambda a: a.detach().clone().requires_grad_(True), unflatten_pytree(x0, spec))
    models.loss_fn(tree, None, arch, {"tokens": tok[1], "labels": lab[1]})[0].backward()
    plain, _ = flatten_pytree(pytree.map_tree(lambda a: a.grad, tree))
    for want, got in zip(pytree.leaves(unflatten_pytree(plain, spec)), pytree.leaves(unflatten_pytree(stack[1], spec))):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_lane_gradients_do_not_depend_on_the_lane_count():
    """Lane i of an (l, P) call equals the one-lane call at that iterate."""
    arch = tscn.lm_arch()
    x0, _, subset_grads, _ = tscn._lm_fns(arch)
    tok, lab = (torch.from_numpy(a) for a in _tokens(arch, n=5, seed=9))
    xs = torch.stack([x0, x0 * 0.5, x0 + 0.01])
    lanes = subset_grads((tok, lab), xs)
    for i in range(3):
        assert torch.equal(lanes[i], subset_grads((tok, lab), xs[i].clone()))
