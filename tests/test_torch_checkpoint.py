"""The port's checkpoints against ``repro.checkpoint``, and a bitwise resume.

A file written by either package loads in the other bit for bit: the LM's
parameter tree (fp32 and bf16 leaves) and an AdamW state with bf16 moments
under the reference's keys (``opt/.step``, ``opt/.mu/embed/table``, ...),
with the same sidecar (step, keys, dtypes, shapes, specs). A resumed run of
the port's train step (``launch.train.build_engine_step``, driven directly)
equals the uninterrupted one bit for bit: the port's counterpart of
tests/test_checkpoint_engine.py, which goes through the reference's
``Trainer`` and is red under this jax (ROADMAP C.4).
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.configs.archs import ARCHS as JARCHS
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import checkpoint, convert, models, pytree
from repro_torch.configs.archs import ARCHS, reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import train
from repro_torch.optim import make_optimizer


def _arch(archs):
    """A bf16 two-layer smollm-360m (tied embedding, fp32 norm scales)."""
    return archs["smollm-360m"].scaled(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128,
                                       vocab=128)


def _reference_state():
    """The reference's params and an AdamW state (bf16 moments) with
    non-zero moments, as numpy trees, and its specs."""
    params, specs = jmodels.init(jax.random.PRNGKey(0), _arch(JARCHS))
    opt = jmake_optimizer("adamw", momentum_dtype="bfloat16")
    grads = jax.tree.map(lambda p: jnp.sin(jnp.arange(p.size, dtype=jnp.float32)).reshape(p.shape) * 1e-2, params)
    params, state = opt.update(params, grads, opt.init(params), 1e-3, weight_decay=0.01)
    return jax.device_get({"params": params, "opt": state}), specs


def _port_like(ref):
    return {"params": convert.lm_params_from_numpy(ref["params"]), "opt": convert.opt_state_from_numpy(ref["opt"])}


def _bits(a) -> np.ndarray:
    a = a.detach().cpu() if isinstance(a, torch.Tensor) else a
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_bitwise(port_tree, ref_tree):
    got, want = pytree.paths(port_tree), jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got = list(got)
    assert len(got) == len(want)
    for (key, a), (_, b) in zip(got, want):
        assert str(a.dtype).removeprefix("torch.") == str(np.asarray(b).dtype), key
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=key)


def test_port_file_loads_in_reference_bitwise(tmp_path):
    ref, specs = _reference_state()
    port = _port_like(ref)
    _, tspecs = models.init(torch.Generator().manual_seed(0), _arch(ARCHS))
    checkpoint.save_checkpoint(str(tmp_path / "port"), port, step=5, specs={"params": tspecs})
    jsave(str(tmp_path / "ref"), ref, step=5, specs={"params": specs})
    loaded, step = jload(str(tmp_path / "port"), like=ref)
    assert step == 5
    _assert_bitwise(port, jax.device_get(loaded))
    meta = [json.loads((tmp_path / f"{w}.json").read_text()) for w in ("port", "ref")]
    assert meta[0] == meta[1]
    assert "opt/.step" in meta[0]["keys"] and "opt/.mu/embed/table" in meta[0]["keys"]
    assert meta[0]["dtypes"]["opt/.nu/ln_f"] == "bfloat16"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["port.json", "port.npz", "ref.json", "ref.npz"]


def test_reference_file_loads_in_port_bitwise(tmp_path):
    ref, _ = _reference_state()
    jsave(str(tmp_path / "ref"), ref, step=9)
    like = pytree.map_tree(torch.zeros_like, _port_like(ref)["params"])
    like = {"params": like, "opt": make_optimizer("adamw", momentum_dtype="bfloat16").init(like)}
    loaded, step = checkpoint.load_checkpoint(str(tmp_path / "ref"), like)
    assert step == 9 and loaded["opt"].step.dtype == torch.int32
    _assert_bitwise(loaded, ref)


@pytest.mark.parametrize("case", ["missing", "extra"])
def test_mismatched_tree_raises(tmp_path, case):
    tree = {"a": torch.ones(3), "b": {"c": torch.zeros(2, dtype=torch.bfloat16)}}
    checkpoint.save_checkpoint(str(tmp_path / "ck"), tree)
    like = {"a": torch.ones(3)} if case == "extra" else {**tree, "d": torch.ones(1)}
    with pytest.raises(ValueError, match=f"checkpoint mismatch.*{'extra' if case == 'extra' else 'missing'}"):
        checkpoint.load_checkpoint(str(tmp_path / "ck"), like)


def test_restore_for_serving_waits_for_serving(tmp_path):
    """``restore_for_serving`` (ported with serving) reads the reference's
    checkpoint of the bf16 arch: its params bit for bit on the CPU, the
    step, and the specs of ``init``."""
    ref, specs = _reference_state()
    jsave(str(tmp_path / "ck"), ref["params"], step=3, specs=specs)
    params, r_specs, step = checkpoint.restore_for_serving(str(tmp_path / "ck"), _arch(ARCHS), device="cpu")
    assert step == 3 and r_specs == models.init(torch.Generator(), _arch(ARCHS))[1]
    want = convert.lm_params_from_numpy(ref["params"])
    for (k, a), (kb, b) in zip(pytree.paths(params), pytree.paths(want), strict=True):
        assert k == kb and a.dtype == b.dtype and a.device.type == "cpu", k
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)


def _tiny_cfg():
    """The reference's ``_tiny_cfg`` of tests/test_checkpoint_engine.py."""
    return reduced(ARCHS["smollm-360m"]).scaled(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
                                                d_ff=128, vocab=128)


def _batches(cfg, n_sub: int, steps: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        t = torch.from_numpy(rng.integers(0, cfg.vocab, (n_sub * 2, 17)))
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


@pytest.mark.parametrize("momentum_dtype", ["float32", "bfloat16"])
def test_resume_is_bitwise_through_the_engine_step(tmp_path, momentum_dtype):
    """6 steps straight through, against 3 steps, a checkpoint of params and
    optimizer state, a load, and 3 more (N=10, LAD+CWTM under sign-flip,
    AdamW): bit for bit."""
    cfg = _tiny_cfg()
    tcfg = TrainConfig(arch=cfg.name, protocol="lad", protocol_impl="engine", n_subsets=10, d=2,
                       aggregator="cwtm", trim_frac=0.25, n_byz=2, attack="sign_flip", optimizer="adamw", lr=3e-3,
                       steps=6, momentum_dtype=momentum_dtype)
    params, specs = models.init(torch.Generator().manual_seed(0), cfg)
    step, opt = train.build_engine_step(cfg, tcfg, specs, device="cpu")
    batches = _batches(cfg, 10, 6)

    def drive(p, s, bs, start):
        for i, b in enumerate(bs, start=start):
            p, s, _, _ = step(p, s, b, i)
        return p, s

    p_ref, s_ref = drive(params, opt.init(params), batches, 0)
    p_mid, s_mid = drive(params, opt.init(params), batches[:3], 0)
    ck = str(tmp_path / "engine_ck")
    state = {"params": p_mid, "opt": s_mid}
    checkpoint.save_checkpoint(ck, state, step=3)
    restored, at = checkpoint.load_checkpoint(ck, {"params": params, "opt": opt.init(params)})
    assert at == 3
    leaves = lambda t: list(pytree.paths(t))
    for (k, a), (_, b) in zip(leaves(state), leaves(restored), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    p_fin, s_fin = drive(restored["params"], restored["opt"], batches[3:], 3)
    for (k, a), (_, b) in zip(leaves({"p": p_ref, "s": s_ref}), leaves({"p": p_fin, "s": s_fin}), strict=True):
        assert torch.equal(a, b), k
