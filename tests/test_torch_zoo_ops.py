"""The port's model zoo against the JAX reference, op by op, on the CPU
(each family's parameters, loss and subset gradients are in
tests/test_torch_zoo_grads.py, held to the tolerances stated here).

Both sides run on the reference's ``PRNGKey(0)`` parameters (widened to
float32, as the reference's ``_lm_fns`` does), carried across leaf for leaf
by ``convert.lm_params_from_numpy``, and on the same inputs, drawn with
numpy. Twelve architectures: every ``zoo_arch`` family (the ``lm_arch``
scale, d_model 32) and ``reduced(ARCHS[...])`` of Jamba, RWKV-6,
granite-moe, Llama-3.2-Vision and whisper-small (d_model 256).

Tolerance: rtol 1e-5, atol 1e-6 for the MoE's aux loss, the group norm, the
frontend projection and each family's loss. The MoE's ``token_idx`` (every
expert's top-C tokens, ties to the lower index) is equal, ties included.
The outputs of MoE, Mamba, the RWKV mixes and the whisper encoder, and
every gradient leaf, are sums of many terms that can cancel: they are held
to rtol 1e-5 with atol 1e-5 times their largest magnitude. Measured, the
outputs sit within 0.3 of that allowance and the gradient leaves of the
zoo archs within 0.5 (RWKV's embedding, 4.3e-6 of its largest value).

The float32 gradients of ``reduced(rwkv6-1.6b)``, ``reduced(jamba)`` and
``reduced(whisper-small)`` are not that accurate on either side, and the
two frameworks differ by up to 1.74, 1.22 and 1.22 times the allowance
above. For those three the test takes both frameworks' gradients in
float64 as well (the reference under ``reference_float64``, the port under
``repro_torch.models.precision.float64``, each checked to compute in
float64 throughout) and holds them in two parts: the two float64
gradients agree to 1e-9 of each leaf's largest value (measured 1.6e-13 on
RWKV), so the port computes the reference's gradient; and each float32
gradient lies within 2.5e-4 of each leaf's largest value of the
reference's float64 one. That bound is the spread of float32 rounding:
the same gradient in the port, with the contraction order of the RWKV
time mix's projections permuted (16 orders, mathematically the same),
lands from 3.0e-5 to 1.2e-4 away; the reference's own float32 gradient
lands 4.5e-5 away and the port's 5.6e-5 (ROADMAP C.7, PERF.md §6).
"""
from __future__ import annotations

import contextlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs.archs import ARCHS as JARCHS
from repro.configs.archs import reduced as jreduced
from repro.core import scenarios as jscn
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import rwkv as jrwkv
from repro.models import transformer as jtrans
from repro_torch import convert, models, pytree
from repro_torch.configs.archs import ARCHS as TARCHS
from repro_torch.configs.archs import reduced as treduced
from repro_torch.core import scenarios as tscn
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as ttrans

RTOL, ATOL = 1e-5, 1e-6
REDUCED = ("jamba-1.5-large-398b", "rwkv6-1.6b", "granite-moe-3b-a800m", "llama-3.2-vision-90b", "whisper-small")
ARCHS = [f"zoo-{f}" for f in jscn.ZOO_FAMILIES] + [f"reduced-{n}" for n in REDUCED]
FLOAT64_ANCHORED = ("reduced-rwkv6-1.6b", "reduced-jamba-1.5-large-398b", "reduced-whisper-small")


@contextlib.contextmanager
def reference_float64():
    """The reference computing in float64, as
    ``repro_torch.models.precision.float64`` makes the port: x64 on, and
    ``jnp.float32``, the name its model casts and accumulates in, bound to
    ``jnp.float64``. Give it an arch of ``param_dtype="float64"`` and
    float64 parameters and inputs, and evaluate through
    ``float64_jit``."""
    f32 = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        try:
            yield
        finally:
            jnp.float32 = f32


def float64_jit(fn, *args):
    """``jax.jit(fn)``, to call inside ``reference_float64``, once its
    jaxpr on ``args`` is found to hold no floating-point value narrower
    than float64."""
    narrow = re.findall(r"\b(?:f32|bf16|f16)\[", str(jax.make_jaxpr(fn)(*args)))
    assert not narrow, f"the reference computes {len(narrow)} values below float64"
    return jax.jit(fn)


def arch_pair(name: str):
    if name.startswith("zoo-"):
        return jscn.zoo_arch(name[4:]), tscn.zoo_arch(name[4:])
    base = name[len("reduced-"):]
    return jreduced(JARCHS[base]), treduced(TARCHS[base])


def close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def close_sum(got: torch.Tensor, want, what=""):
    """A sum that can cancel: atol 1e-5 of its largest magnitude."""
    close(got, want, atol=1e-5 * float(np.abs(np.asarray(want)).max()), what=what)


def _block(params, tparams, mixer_or_mlp: str, kind: str, cfg):
    """The first period's first block whose mixer (or MLP) is ``kind``:
    (reference leaves, port leaves) of that part."""
    i = next(i for i, s in enumerate(cfg.period) if getattr(s, mixer_or_mlp) == kind)
    jp = jax.tree.map(lambda a: a[0], params["periods"][f"blk{i}"][mixer_or_mlp])
    tp = pytree.map_tree(lambda a: a[0], tparams["periods"][f"blk{i}"][mixer_or_mlp])
    return jp, tp


def _x(cfg, seed: int, b: int = 2, s: int = 16) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _batch(cfg, seed: int, n: int = 3, b: int = 2, s: int = 16):
    """(reference batch, port batch) of ``n`` subsets."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (n, b, s + 1))
    data = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.family in ("vlm", "audio"):
        enc = cfg.encoder
        data["frontend"] = rng.standard_normal((n, b, enc.n_frontend_tokens, enc.d_frontend)).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in data.items()}, {k: torch.from_numpy(v) for k, v in data.items()}


@pytest.mark.parametrize("family", jscn.ZOO_FAMILIES)
def test_zoo_arch_is_the_reference_config(family):
    """Field for field, nested configs by value."""
    j, t = jscn.zoo_arch(family), tscn.zoo_arch(family)
    assert [f.name for f in type(t).__dataclass_fields__.values()] == list(type(j).__dataclass_fields__)
    for name in type(j).__dataclass_fields__:
        assert repr(getattr(t, name)) == repr(getattr(j, name)), name
    assert tscn.zoo_arch(family) is t
    assert tscn.zoo_arch("transformer") is tscn.lm_arch()
    with pytest.raises(ValueError, match="unknown zoo family"):
        tscn.zoo_arch("nope")


@pytest.mark.parametrize("kw", [{}, dict(families=("moe", "audio"), attacks=("alie", "ipm"), n_devices=10, n_byz=3)],
                         ids=["default", "custom"])
def test_zoo_sweep_rows_are_the_reference_rows(kw):
    def fields(row):
        return {k: v for k, v in row.__dict__.items() if k != "backend"}

    got, want = tscn.zoo_sweep(**kw), jscn.zoo_sweep(**kw)
    assert list(got) == list(want) and tuple(tscn.ZOO_FAMILIES) == tuple(jscn.ZOO_FAMILIES)
    for fam in want:
        assert [fields(r) for r in got[fam]] == [fields(r) for r in want[fam]], fam
        assert all(r.name.startswith(f"zoo/{fam}/") for r in got[fam])


MOE_ARCHS = ("zoo-moe", "zoo-jamba", "reduced-granite-moe-3b-a800m", "reduced-jamba-1.5-large-398b")


def _jax_token_idx(params, x, top_k: int):
    """The reference's routing (``models/moe.py:58-73``) to ``token_idx``."""
    b, s, d = x.shape
    n_experts = params["router"].shape[1]
    xb = x.reshape(1, b * s, d)
    probs = jax.nn.softmax(jnp.einsum("ntd,de->nte", xb.astype(jnp.float32), params["router"]), axis=-1)
    gate_vals, idx = jax.lax.top_k(probs, top_k)
    gate_vals = gate_vals / jnp.maximum(jnp.sum(gate_vals, axis=-1, keepdims=True), 1e-9)
    combine = jnp.sum(jax.nn.one_hot(idx, n_experts, dtype=jnp.float32) * gate_vals[..., None], axis=2)
    cap = jmoe.expert_capacity(b * s, n_experts, top_k)
    return jax.lax.top_k(combine.swapaxes(1, 2), cap)[1]


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "repeated-tokens"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_matches(name, ties):
    """Output, aux loss and every expert's token indices; with repeated
    tokens (rows 1 and 3 copies of row 0) every gate weight ties three
    ways, and both sides keep the lowest index first."""
    jarch, tarch = arch_pair(name)
    params, _ = jmodels.init(jax.random.PRNGKey(0), jarch)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params))
    jp, tp = _block(params, tparams, "mlp", "moe", jarch)
    x = _x(jarch, 11, b=4)
    if ties:
        x[1], x[3] = x[0], x[0]
    top_k = jarch.moe.top_k
    want, waux = jmoe.moe(jp, jnp.asarray(x), top_k=top_k, aux_coef=jarch.moe.router_aux_coef)
    got, aux = tmoe.moe(tp, torch.from_numpy(x), top_k=top_k, aux_coef=tarch.moe.router_aux_coef)
    close_sum(got, want, "out")
    close(aux, waux, what="aux")
    _, _, _, token_idx = tmoe._route(tp, torch.from_numpy(x).reshape(1, -1, x.shape[-1]), top_k, 1.25)
    np.testing.assert_array_equal(token_idx.numpy(), np.asarray(_jax_token_idx(jp, jnp.asarray(x), top_k)))


@pytest.mark.parametrize("n,e,k", [(32, 4, 2), (32, 40, 8), (7, 4, 1), (4096, 16, 2), (100, 128, 8)])
def test_expert_capacity_is_the_reference(n, e, k):
    assert tmoe.expert_capacity(n, e, k) == jmoe.expert_capacity(n, e, k)
    assert tmoe.expert_capacity(n, e, k, 2.0) == jmoe.expert_capacity(n, e, k, 2.0)


def test_moe_backward_has_no_scatter():
    """The MoE's backward on a deterministic path: its autograd graph holds
    no scatter or index_add (whose CUDA atomics add in a varying order)."""
    arch = tscn.zoo_arch("moe")
    params, _ = models.init(torch.Generator().manual_seed(0), arch)
    mlp = pytree.map_tree(lambda a: a[0].detach().requires_grad_(True), params["periods"]["blk0"]["mlp"])
    x = torch.randn(2, 16, arch.d_model, generator=torch.Generator().manual_seed(1), requires_grad=True)
    out, aux = tmoe.moe(mlp, x, top_k=arch.moe.top_k)
    seen, stack = set(), [(out.sum() + aux).grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    names = {type(fn).__name__ for fn in seen}
    assert not any(("Scatter" in n or "IndexAdd" in n or "Gather" in n or "Index" in n) for n in names), names


@pytest.mark.parametrize("name", ("zoo-jamba", "reduced-jamba-1.5-large-398b"))
def test_mamba_matches(name):
    jarch, tarch = arch_pair(name)
    params, _ = jmodels.init(jax.random.PRNGKey(0), jarch)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params))
    jp, tp = _block(params, tparams, "mixer", "mamba", jarch)
    x = _x(jarch, 12)
    want = jmamba.mamba(jp, jnp.asarray(x), jarch.mamba.d_state)
    close_sum(tmamba.mamba(tp, torch.from_numpy(x), tarch.mamba.d_state), want)
    xi = np.random.default_rng(13).standard_normal((2, 16, 2 * jarch.d_model)).astype(np.float32)
    close(tmamba._causal_depthwise_conv(torch.from_numpy(xi), tp["conv_w"], tp["conv_b"]),
          jmamba._causal_depthwise_conv(jnp.asarray(xi), jp["conv_w"], jp["conv_b"]))
    dt, b_sel, c_sel = tmamba._selection(tp, torch.from_numpy(xi), tarch.mamba.d_state)
    for g, w, what in zip((dt, b_sel, c_sel), jmamba._selection(jp, jnp.asarray(xi), jarch.mamba.d_state, "bs"),
                          ("dt", "B", "C")):
        close_sum(g, w, what)


def test_softplus_is_jax_softplus_past_the_cut_off():
    x = np.concatenate([np.linspace(-60, 60, 1201), [0.0, -0.0, 19.99, 20.0, 20.01, 88.0, -104.0]]).astype(np.float32)
    close(tmamba.softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)), rtol=2e-7, atol=0)


RWKV_ARCHS = ("zoo-rwkv", "reduced-rwkv6-1.6b")


@pytest.mark.parametrize("name", RWKV_ARCHS)
def test_rwkv_time_and_channel_mix_match(name):
    """Both mixes on random inputs with the time mix's ``bonus_u`` and
    ``w0`` drawn away from their zero init, so the bonus and the decay both
    act."""
    jarch, tarch = arch_pair(name)
    params, _ = jmodels.init(jax.random.PRNGKey(0), jarch)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    rng = np.random.default_rng(14)
    mixer = params["periods"]["blk0"]["mixer"]
    mixer["bonus_u"] = jnp.asarray(rng.standard_normal(mixer["bonus_u"].shape).astype(np.float32) * 0.5)
    mixer["w0"] = jnp.asarray(rng.standard_normal(mixer["w0"].shape).astype(np.float32) * 0.5)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params))
    x = _x(jarch, 15)
    jp, tp = _block(params, tparams, "mixer", "rwkv", jarch)
    want, _, _ = jrwkv.rwkv_time_mix(jp, jnp.asarray(x), jarch.rwkv.head_dim)
    close_sum(trwkv.rwkv_time_mix(tp, torch.from_numpy(x), tarch.rwkv.head_dim), want, "time mix")
    jp, tp = _block(params, tparams, "mlp", "rwkv_ffn", jarch)
    want, _ = jrwkv.rwkv_channel_mix(jp, jnp.asarray(x))
    close_sum(trwkv.rwkv_channel_mix(tp, torch.from_numpy(x)), want, "channel mix")


@pytest.mark.parametrize("name", RWKV_ARCHS)
def test_group_norm_matches(name):
    """The population variance, as ``jnp.var``; one head's values constant
    (variance 0: the norm is the eps's alone)."""
    jarch, _ = arch_pair(name)
    hd = jarch.rwkv.head_dim
    h = jarch.d_model // hd
    y = np.random.default_rng(16).standard_normal((2, 16, h, hd)).astype(np.float32)
    y[:, :, 0] = 0.25
    scale = np.random.default_rng(17).standard_normal(jarch.d_model).astype(np.float32)
    close(trwkv._group_norm(torch.from_numpy(y), torch.from_numpy(scale)),
          jrwkv._group_norm(jnp.asarray(y), jnp.asarray(scale), hd))


FRONTEND_ARCHS = ("zoo-cross", "zoo-audio", "reduced-llama-3.2-vision-90b", "reduced-whisper-small")


@pytest.mark.parametrize("name", FRONTEND_ARCHS)
def test_encode_frontend_matches(name):
    """The projection (vlm) and the whisper encoder with its positions
    (audio)."""
    jarch, tarch = arch_pair(name)
    params, _ = jmodels.init(jax.random.PRNGKey(0), jarch)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params))
    enc = jarch.encoder
    f = np.random.default_rng(18).standard_normal((2, enc.n_frontend_tokens, enc.d_frontend)).astype(np.float32)
    want = jtrans._encode_frontend(params, jarch, jnp.asarray(f))
    got = ttrans._encode_frontend(tparams, tarch, torch.from_numpy(f))
    if jarch.family == "vlm":
        close(got, want)
    else:
        close_sum(got, want)
    assert got.shape == (2, enc.n_frontend_tokens, jarch.d_model)


def test_bfloat16_frontend_rounds_as_the_reference():
    """An arch in bf16: the frontend is rounded to bf16 before the float32
    projection (the reference's ``astype(cfg.dtype)`` then promotion)."""
    jarch = jreduced(JARCHS["llama-3.2-vision-90b"]).scaled(param_dtype="bfloat16")
    tarch = treduced(TARCHS["llama-3.2-vision-90b"]).scaled(param_dtype="bfloat16")
    params, _ = jmodels.init(jax.random.PRNGKey(2), jarch)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params))
    f = np.random.default_rng(19).standard_normal((2, 16, 64)).astype(np.float32)
    close(ttrans._encode_frontend(tparams, tarch, torch.from_numpy(f)),
          jtrans._encode_frontend(params, jarch, jnp.asarray(f)))




def test_float64_block_widens_the_model_and_refuses_to_narrow():
    """``precision.float64()``: the model's float32 (and a float32 arch's
    dtype) is float64 inside the block and float32 again after it, also
    when the block raises; a float64 value cast or written into a
    narrower dtype bound before the block raises; a constant in the
    default dtype is let through."""
    from repro_torch.models import precision

    f32, x = torch.float32, torch.ones(3, dtype=torch.float64)
    with precision.float64():
        assert torch.float32 is torch.float64 and tscn.zoo_arch("rwkv").dtype == torch.float64
        assert (x + torch.where(x > 0, 0.0, -1e30)).dtype == torch.float64
        for narrowing in (lambda: x.to(f32), lambda: torch.zeros(3, dtype=f32).copy_(x),
                          lambda: torch.zeros(3, dtype=f32).__setitem__(0, x[0]),
                          lambda: x.to(torch.bfloat16)):
            with pytest.raises(TypeError, match="narrowed float64"):
                narrowing()
    assert torch.float32 is f32 and torch.float32 is not torch.float64
    with pytest.raises(RuntimeError), precision.float64():
        raise RuntimeError
    assert torch.float32 is f32
