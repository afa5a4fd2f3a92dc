"""The port's serving path against the JAX reference's, on the CPU.

Both sides run on the reference's ``PRNGKey(0)`` parameters of each
``zoo_arch`` family (float32), carried across leaf for leaf by
``convert.lm_params_from_numpy``, on the same prompts and frontends drawn
with numpy. Held:

  * the chunked online-softmax attention (``_flash_attention``) forward and
    VJP at ``q_chunk=4, kv_chunk=8``: ragged lengths, causal and not, a
    window, padded keys; ``multihead_attention`` past 2,048 tokens, forward
    and gradient;
  * prefill's logits and decode state, then 7 decode steps' logits and the
    final state, for every zoo family; one port decode step from the
    reference's prefilled state (``convert.decode_state_from_numpy``);
  * greedy ``serve_traffic`` tokens against the reference's on
    ``make_host_mesh(1, 1)``;
  * the four regression locks of tests/test_serving.py, and prefill then
    decode against the port's own full forward at the reference's bound;
  * ``restore_for_serving`` bit for bit, checkpoints interchanged both ways.

Tolerance: rtol 1e-5, atol 1e-6 (float32) for the caches and states.
Logits, attention outputs and the gradients of the attention's params are
sums of many terms that can cancel, so a value near zero carries the
rounding of the values' own scale: they are held to rtol 1e-5 with atol
1e-5 times their largest magnitude, as tests/test_torch_models.py holds
the forward (measured: an RWKV decode logit of 0.032 off by 1.4e-6). The
MoE families (``moe``, ``jamba``) route by each expert's top-C tokens at
near-ties of the gate weights, so their caches past a MoE block are held
the same way (tests/test_torch_zoo_ops.py's provision for the MoE output;
measured: a Jamba K of 0.014 off by 1.9e-6).

MoE and prefill-then-decode: an expert's capacity is a function of the
tokens routed together (``expert_capacity``), so a prefill of 13 tokens and
one-token decode steps drop other tokens than a forward over all 20; the
reference's own conformance case for ``moe`` misses its 1e-1 bound at its
seed (0.95 at the prefill logits). The conformance cases here are the
families that do not route; ``moe`` and ``jamba`` are held to the
reference's serving path step by step instead.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.checkpoint import restore_for_serving as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.configs.archs import ARCHS as JARCHS
from repro.configs.archs import reduced as jreduced
from repro.configs.base import BlockSpec as JBlockSpec
from repro.configs.base import EncoderConfig as JEncoderConfig
from repro.core import scenarios as jscn
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import serve_traffic as jserve
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.serving import _sinusoidal_at as j_sinusoidal_at
from repro_torch import checkpoint, convert, models, pytree
from repro_torch.configs.archs import ARCHS as TARCHS
from repro_torch.configs.archs import reduced as treduced
from repro_torch.configs.base import BlockSpec, EncoderConfig
from repro_torch.core import scenarios as tscn
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import serving as tserving

RTOL, ATOL = 1e-5, 1e-6
CONFORMANCE = 5e-2  # the reference's prefill-then-decode bound against the full forward
ROUTED = ("moe", "jamba")
S0, T_TOTAL = 13, 20  # prompt length and prompt + decoded tokens, as tests/test_serving.py


def close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, dtype=np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def close_sum(got: torch.Tensor, want, what=""):
    """A sum that can cancel: atol 1e-5 of its largest magnitude."""
    close(got, want, atol=1e-5 * float(np.abs(np.asarray(want)).max()), what=what)


def _cross_first_audio(reduced, archs, block_spec, encoder_config):
    """tests/test_serving.py's audio arch whose first block is
    cross-attention (its cache length never advances in decode)."""
    return reduced(archs["whisper-small"]).scaled(
        name="audio-cross-first", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64, vocab=64,
        period=(block_spec(mixer="cross", mlp="dense"), block_spec(mixer="attn_nope", mlp="none")),
        encoder=encoder_config(n_frontend_tokens=8, d_frontend=16, n_encoder_layers=1))


def arch_pair(name: str):
    if name == "audio-cross-first":
        return (_cross_first_audio(jreduced, JARCHS, JBlockSpec, JEncoderConfig),
                _cross_first_audio(treduced, TARCHS, BlockSpec, EncoderConfig))
    return jscn.zoo_arch(name), tscn.zoo_arch(name)


def carried(name: str):
    """(reference arch, port arch, reference params, specs, port params)."""
    jarch, tarch = arch_pair(name)
    params, specs = jmodels.init(jax.random.PRNGKey(0), jarch)
    return jarch, tarch, params, specs, convert.lm_params_from_numpy(jax.device_get(params))


def traffic(cfg, seed: int = 1, b: int = 2, t: int = T_TOTAL):
    """Prompt tokens (B, t) int32 and the frontend (or None), numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    frontend = None
    if cfg.family in ("vlm", "audio"):
        enc = cfg.encoder
        frontend = rng.standard_normal((b, enc.n_frontend_tokens, enc.d_frontend)).astype(np.float32)
    return tokens, frontend


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def state_close(got: dict, want: dict, what: str, routed: bool = False):
    """Every cache field and ``pos`` of a port state against a reference
    state: integers equal, floats within rtol 1e-5 / atol 1e-6, or, past a
    routed MoE block (``routed``), atol 1e-5 of the field's largest value."""
    got = convert.decode_state_to_numpy(got)
    want = jax.device_get(want)
    assert set(got) == set(want), what
    np.testing.assert_array_equal(got["pos"], np.asarray(want["pos"]))
    for name, cache in want.items():
        if name == "pos":
            continue
        assert got[name]["kind"] == type(cache).__name__, (what, name)
        for f in dataclasses.fields(cache):
            ref = np.asarray(getattr(cache, f.name))
            assert got[name][f.name].shape == ref.shape, (what, name, f.name)
            if ref.dtype.kind in "iu":
                np.testing.assert_array_equal(got[name][f.name], ref, err_msg=f"{what} {name}.{f.name}")
            else:
                atol = 1e-5 * float(np.abs(ref).max()) if routed else ATOL
                np.testing.assert_allclose(got[name][f.name], ref.astype(np.float32), rtol=RTOL, atol=atol,
                                           err_msg=f"{what} {name}.{f.name}")


# ------------------------------------------------------------ chunked attention


FLASH_CASES = {
    "causal-ragged": (8, 16, True, None, False),
    "bidirectional-padded-keys": (12, 24, False, None, True),
    "window": (16, 16, True, 5, False),
    "short-padded-keys": (4, 8, True, None, True),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_matches_reference(case):
    """Forward and VJP of ``_flash_attention`` at q_chunk=4, kv_chunk=8:
    queries at the last ``sq`` of ``sk`` positions; padded keys carry kpos
    -1. Also equal to the port's plain attention on the same inputs."""
    sq, sk, causal, window, padded = FLASH_CASES[case]
    b, h, g, d = 2, 2, 3, 8
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, sq, h, g, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, h, d)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((b, sq, h, g, d)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(sk - sq, sk, dtype=np.int32), (b, sq)).copy()
    kpos = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    if padded:
        kpos[:, -3:] = -1
    want, vjp = jax.vjp(lambda q, k, v: jattn._flash_attention(q, k, v, jnp.asarray(qpos), jnp.asarray(kpos), causal,
                                                                window, 4, 8), *map(jnp.asarray, (q, k, v)))
    wants = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = tattn._flash_attention(tq, tk, tv, _t(qpos), _t(kpos), causal, window, 4, 8)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(dout))
    close(got, want, what="out")
    for g_, w_, what in zip(grads, wants, ("dq", "dk", "dv")):
        close(g_, w_, what=what)
    plain = tattn._plain_attention(tq, tk, tv, _t(qpos), _t(kpos), causal, window)
    close(got, plain.detach().numpy(), what="against the plain attention")


def test_flash_attention_under_vmap_of_grad():
    """``torch.func.vmap`` of ``grad`` through the chunked attention (as
    the training path's subset gradients take it) equals each sample's
    own gradient."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((3, 1, 8, 1, 2, 4)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 16, 1, 4)).astype(np.float32)) for _ in range(2))
    qpos, kpos = torch.arange(8, 16)[None], torch.arange(16)[None]

    def loss(q):
        return torch.sum(tattn._flash_attention(q, k, v, qpos, kpos, True, None, 4, 8) ** 2)

    batched = torch.func.vmap(torch.func.grad(loss))(q)
    for i in range(3):
        assert torch.equal(batched[i], torch.func.grad(loss)(q[i]))


@pytest.mark.parametrize("window", [None, 700], ids=["causal", "window"])
def test_multihead_attention_past_threshold_matches_reference(window):
    """2,100 tokens (past PLAIN_THRESHOLD, not a multiple of either chunk):
    the output, K, V and the gradients of the params and the input."""
    jarch, _, params, _, tparams = carried("transformer")
    s = 2100
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, s, jarch.d_model)).astype(np.float32)
    ct = rng.standard_normal((1, s, jarch.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    jp = jax.tree.map(lambda a: a[0], params["periods"]["blk0"]["mixer"])
    tp = {k: v[0].clone().requires_grad_() for k, v in tparams["periods"]["blk0"]["mixer"].items()}
    kw = dict(n_heads=jarch.n_heads, n_kv_heads=jarch.n_kv_heads, rope_theta=jarch.rope_theta, window=window)
    (want, wk, wv), vjp = jax.vjp(lambda p, x: jattn.multihead_attention(p, x, jnp.asarray(pos), **kw), jp,
                                  jnp.asarray(x))
    wp, wx = vjp((jnp.asarray(ct), jnp.zeros_like(wk), jnp.zeros_like(wv)))
    tx = torch.from_numpy(x).requires_grad_()
    got, gk, gv = tattn.multihead_attention(tp, tx, torch.from_numpy(pos), **kw)
    close_sum(got, want, "out")
    close(gk, wk, what="k")
    close(gv, wv, what="v")
    grads = torch.autograd.grad(got, [tp[n] for n in sorted(tp)] + [tx], torch.from_numpy(ct))
    for name, g_ in zip(sorted(tp), grads):
        close_sum(g_, wp[name], f"d{name}")
    close_sum(grads[-1], wx, "dx")


# ---------------------------------------------------------- prefill and decode


@pytest.mark.parametrize("family", jscn.ZOO_FAMILIES)
def test_prefill_and_decode_match_reference(family):
    """Prefill of 13 tokens (capacity 22): the last logits and the whole
    decode state; then 7 decode steps: every step's logits, ``pos``, and
    the final state."""
    jarch, tarch, params, specs, tparams = carried(family)
    tokens, frontend = traffic(jarch)
    want, jstate = jmodels.prefill(params, specs, jarch, jnp.asarray(tokens[:, :S0]), frontend=_j(frontend),
                                   capacity=T_TOTAL + 2)
    got, tstate = models.prefill(tparams, None, tarch, _t(tokens[:, :S0]), frontend=_t(frontend),
                                 capacity=T_TOTAL + 2)
    close_sum(got, want, f"{family} prefill logits")
    state_close(tstate, jstate, f"{family} prefill state", family in ROUTED)
    for t in range(S0, T_TOTAL):
        want, jstate = jmodels.decode_step(params, specs, jarch, jnp.asarray(tokens[:, t:t + 1]), jstate)
        got, tstate = models.decode_step(tparams, None, tarch, _t(tokens[:, t:t + 1]), tstate)
        close_sum(got, want, f"{family} decode logits at {t}")
        assert int(tstate["pos"]) == t + 1
    state_close(tstate, jstate, f"{family} final state", family in ROUTED)


@pytest.mark.parametrize("family", jscn.ZOO_FAMILIES)
def test_decode_step_from_reference_state(family):
    """The reference's prefilled state, carried across by ``convert``: one
    port decode step equals the reference's (logits and state), and the
    state carried back is the reference's bit for bit."""
    jarch, tarch, params, specs, tparams = carried(family)
    tokens, frontend = traffic(jarch, seed=2)
    _, jstate = jmodels.prefill(params, specs, jarch, jnp.asarray(tokens[:, :S0]), frontend=_j(frontend),
                                capacity=T_TOTAL)
    tstate = convert.decode_state_from_numpy(jax.device_get(jstate))
    state_close(tstate, jstate, "carried")
    for name, cache in jax.device_get(jstate).items():
        if name != "pos":
            for f in dataclasses.fields(cache):
                np.testing.assert_array_equal(convert.decode_state_to_numpy(tstate)[name][f.name],
                                              np.asarray(getattr(cache, f.name)))
    token = tokens[:, S0:S0 + 1]
    want, jstate = jmodels.decode_step(params, specs, jarch, jnp.asarray(token), jstate)
    got, tstate = models.decode_step(tparams, None, tarch, _t(token), tstate)
    close_sum(got, want, f"{family} decode logits")
    state_close(tstate, jstate, f"{family} decode state", family in ROUTED)


@pytest.mark.parametrize("family", [f for f in jscn.ZOO_FAMILIES if f not in ROUTED] + ["audio-cross-first"])
def test_prefill_then_decode_is_the_full_forward(family):
    """tests/test_serving.py's conformance matrix on the port: decode step
    t after prefilling 13 tokens gives the full forward's logits at t
    (within the reference's 5e-2). ``audio-cross-first`` is the regression
    lock of a cross-attention first block, whose cache length never
    advances: the position comes from ``state["pos"]``."""
    _, tarch, _, _, tparams = carried(family)
    tokens, frontend = traffic(tarch, seed=3)
    full, _ = models.forward(tparams, None, tarch, _t(tokens), frontend=_t(frontend))
    logits, state = models.prefill(tparams, None, tarch, _t(tokens[:, :S0]), frontend=_t(frontend),
                                   capacity=T_TOTAL + 2)
    close(logits, full[:, S0 - 1].numpy(), rtol=CONFORMANCE, atol=CONFORMANCE, what="prefill logits")
    assert int(state["pos"]) == S0
    for t in range(S0, T_TOTAL):
        logits, state = models.decode_step(tparams, None, tarch, _t(tokens[:, t:t + 1]), state)
        assert int(state["pos"]) == t + 1
        close(logits, full[:, t].numpy(), rtol=CONFORMANCE, atol=CONFORMANCE, what=f"decode at {t}")


def test_cross_first_audio_matches_reference():
    """The cross-first audio arch through prefill and 7 decode steps,
    against the reference's."""
    jarch, tarch, params, specs, tparams = carried("audio-cross-first")
    tokens, frontend = traffic(jarch, seed=4)
    want, jstate = jmodels.prefill(params, specs, jarch, jnp.asarray(tokens[:, :S0]), frontend=_j(frontend),
                                   capacity=T_TOTAL + 2)
    got, tstate = models.prefill(tparams, None, tarch, _t(tokens[:, :S0]), frontend=_t(frontend),
                                 capacity=T_TOTAL + 2)
    close_sum(got, want, "prefill")
    for t in range(S0, T_TOTAL):
        want, jstate = jmodels.decode_step(params, specs, jarch, jnp.asarray(tokens[:, t:t + 1]), jstate)
        got, tstate = models.decode_step(tparams, None, tarch, _t(tokens[:, t:t + 1]), tstate)
        close_sum(got, want, f"decode at {t}")
    state_close(tstate, jstate, "final state")


@pytest.mark.parametrize("d_model", [16, 17, 32, 33])
def test_sinusoidal_at_matches_table_even_and_odd(d_model):
    """Regression lock 1: ``_sinusoidal_at(p, d)`` is row p of
    ``sinusoidal_positions`` bit for bit, for even and odd d, and the
    reference's single-position embedding within 1e-6."""
    table = tlayers.sinusoidal_positions(8, d_model)
    for pos in (0, 3, 7):
        single = tserving._sinusoidal_at(torch.tensor(pos, dtype=torch.int32), d_model)
        assert torch.equal(single, table[pos])
        np.testing.assert_allclose(single.numpy(), np.asarray(j_sinusoidal_at(pos, d_model)), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(single.numpy(), np.asarray(jlayers.sinusoidal_positions(8, d_model))[pos],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("family", jscn.ZOO_FAMILIES + ("audio-cross-first",))
def test_decode_state_carries_pos_counter(family):
    """Regression lock 2's counter: ``init_decode_state`` has the
    reference's structure, shapes and dtypes, and ``pos`` is a 0-d int32
    ``filled``."""
    jarch, tarch = arch_pair(family)
    want = jax.device_get(jmodels.init_decode_state(jarch, batch=2, seq_len=16, filled=5))
    got = models.init_decode_state(tarch, batch=2, seq_len=16, filled=5, device="cpu")
    assert int(got["pos"]) == 5 and got["pos"].dtype == torch.int32 and got["pos"].dim() == 0
    state_close(got, want, family)
    for name, cache in want.items():
        if name != "pos":
            for f in dataclasses.fields(cache):
                assert str(getattr(got[name], f.name).dtype).removeprefix("torch.") == \
                    str(np.asarray(getattr(cache, f.name)).dtype), (name, f.name)


def test_rwkv_ffn_on_non_rwkv_mixer_rejected_and_rwkv_serves():
    """Regression lock 3: ``rwkv_ffn`` needs the rwkv mixer's state (the
    config refuses it elsewhere); on the rwkv mixer it serves."""
    with pytest.raises(ValueError, match="rwkv_ffn"):
        dataclasses.replace(tscn.zoo_arch("transformer"), period=(BlockSpec(mixer="attn", mlp="rwkv_ffn"),))
    _, tarch, _, _, tparams = carried("rwkv")
    assert tarch.period[0].mlp == "rwkv_ffn"
    tokens, _ = traffic(tarch, t=9)
    _, state = models.prefill(tparams, None, tarch, _t(tokens[:, :8]))
    logits, _ = models.decode_step(tparams, None, tarch, _t(tokens[:, 8:9]), state)
    assert bool(torch.isfinite(logits).all())


def test_sliding_window_ring_alignment():
    """Regression lock 4: window 6, a prompt of 13 it does not divide. The
    ring rows land at ``position % 6`` (against the reference's cache bit
    for bit in layout), and decode follows the full forward."""
    jarch, tarch, params, specs, tparams = carried("swa")
    assert tarch.period[0].sliding_window == 6
    tokens, _ = traffic(tarch, seed=7)
    _, jstate = jmodels.prefill(params, specs, jarch, jnp.asarray(tokens[:, :S0]))
    _, tstate = models.prefill(tparams, None, tarch, _t(tokens[:, :S0]))
    assert tstate["blk0"].capacity == 6
    state_close(tstate, jstate, "ring")
    full, _ = models.forward(tparams, None, tarch, _t(tokens))
    for t in range(S0, T_TOTAL):
        logits, tstate = models.decode_step(tparams, None, tarch, _t(tokens[:, t:t + 1]), tstate)
        close(logits, full[:, t].numpy(), rtol=CONFORMANCE, atol=CONFORMANCE, what=f"decode at {t}")


# ------------------------------------------------------------------ traffic


@pytest.mark.parametrize("family", ["transformer", "swa", "audio", "rwkv"])
def test_serve_traffic_tokens_match_reference(family):
    """Greedy tokens of the port's ``serve_traffic`` (loop mode, CPU)
    against the reference's on ``make_host_mesh(1, 1)``; ``pos`` and the
    returned keys."""
    jarch, tarch, params, specs, tparams = carried(family)
    tokens, frontend = traffic(jarch, seed=8, t=S0)
    want = jserve(jarch, params, specs, make_host_mesh(1, 1), jnp.asarray(tokens), frontend=_j(frontend),
                  new_tokens=6)
    got = serve.serve_traffic(tarch, tparams, None, _t(tokens), frontend=_t(frontend), new_tokens=6, mode="loop",
                              device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    assert got["pos"] == want["pos"] == S0 + 6
    assert set(want) <= set(got) and got["clock"] == "host"
    assert got["tokens"].dtype == torch.int32


def test_serve_traffic_greedy_is_decode_step_argmax():
    """``serve_traffic``'s tokens are the argmax of ``decode_step`` fed its
    own tokens from the prefill on, and its final state that of those
    steps."""
    _, tarch, _, _, tparams = carried("jamba")
    tokens, _ = traffic(tarch, seed=9, t=S0)
    got = serve.serve_traffic(tarch, tparams, None, _t(tokens), new_tokens=4, mode="loop", device="cpu")
    logits, state = models.prefill(tparams, None, tarch, _t(tokens), capacity=S0 + 4)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    out = []
    for _ in range(4):
        logits, state = models.decode_step(tparams, None, tarch, tok, state)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out.append(tok)
    assert torch.equal(got["tokens"], torch.cat(out, dim=1))
    for (ka, a), (kb, b) in zip(pytree.paths(got["state"]), pytree.paths(state), strict=True):
        assert ka == kb and torch.equal(a, b), ka


def test_serve_refuses_what_waits():
    """Graph mode needs a card; over a mesh of more than one rank it waits
    for A.14 (sharded serving runs in loop mode: tests/test_torch_serve_tp.py);
    a decoder refuses a step past its output's columns."""
    _, tarch, _, _, tparams = carried("transformer")
    logits, state = models.prefill(tparams, None, tarch, torch.zeros((1, 4), dtype=torch.int32), capacity=6)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    dec = serve.GreedyDecoder(serve.build_decode_fn(tarch, None), tparams, tok, state, 1, "loop")
    dec()
    with pytest.raises(ValueError, match="all decoded"):
        dec()
    assert int(state["pos"]) == 5
    with pytest.raises(ValueError, match="CUDA"):
        serve.serve_traffic(tarch, tparams, None, torch.zeros((1, 4), dtype=torch.int32), mode="graph",
                            device="cpu")
    from repro_torch.launch.mesh import abstract_mesh

    ranked = dataclasses.replace(abstract_mesh(2, 2), abstract=False)  # the check precedes any collective
    with pytest.raises(ValueError, match="A.14"):
        serve.serve_traffic(tarch, tparams, None, torch.zeros((2, 4), dtype=torch.int32), mode="graph", device="cpu",
                            mesh=ranked)


# ------------------------------------------------------------- checkpoints


def _bits(a) -> np.ndarray:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) and a.dtype != torch.bfloat16 else a
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().view(torch.int16).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_restore_for_serving_roundtrip(tmp_path, writer):
    """A checkpoint written by either package: ``restore_for_serving``
    gives the trained params bit for bit (dtypes included; smollm's bf16
    family at zoo widths), the step, and ``specs`` equal to ``init``'s; the
    port's prefill on them equals the prefill on the originals bit for
    bit. The reference's ``restore_for_serving`` reads the port's file."""
    jarch = JARCHS["smollm-360m"].scaled(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128,
                                         vocab=128)
    tarch = TARCHS["smollm-360m"].scaled(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128,
                                         vocab=128)
    params, specs = jmodels.init(jax.random.PRNGKey(0), jarch)
    tparams = convert.lm_params_from_numpy(jax.device_get(params))
    path = str(tmp_path / "ck")
    if writer == "port":
        checkpoint.save_checkpoint(path, tparams, step=7, specs=models.init(torch.Generator(), tarch)[1])
    else:
        jsave(path, params, step=7, specs=specs)
    restored, r_specs, step = checkpoint.restore_for_serving(path, tarch, device="cpu")
    assert step == 7
    assert r_specs == models.init(torch.Generator().manual_seed(3), tarch)[1]
    pa, pb = list(pytree.paths(tparams)), list(pytree.paths(restored))
    assert [k for k, _ in pa] == [k for k, _ in pb]
    for (k, a), (_, b) in zip(pa, pb):
        assert a.dtype == b.dtype and b.device.type == "cpu", k
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)
    tokens = torch.from_numpy(traffic(tarch, seed=10, t=8)[0])
    la, _ = models.prefill(tparams, None, tarch, tokens)
    lb, _ = models.prefill(restored, r_specs, tarch, tokens)
    assert torch.equal(la, lb)
    if writer == "port":
        jp, j_specs, jstep = jrestore(path, jarch)
        assert jstep == 7 and j_specs == specs
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(jp)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(_bits(np.asarray(a)), _bits(np.asarray(b)))
