"""The port's optimizers and learning-rate schedules against ``repro.optim``.

Inputs are drawn with numpy from a seed and handed to both sides. Each
optimizer runs six steps on a tree of mixed leaves (fp32, and bf16 as the
LM's dense weights are), on a flat vector and on an ``(L, Q)`` lane stack,
with weight decay and a step size that changes every step.

Tolerance: rtol 1e-5 and atol 1e-6 on the params and fp32 moments, the
per-op standard of tests/test_kernels.py. Both sides run the same
elementwise operations in the same order in fp32; they may differ where
XLA's ``pow`` (AdamW's bias correction ``b ** t``) or ``cos`` rounds
otherwise than libm's. A bf16 leaf (a moment, or a bf16 weight) may then
round the other way: bf16 leaves are held to at most one bf16 ulp, on at
most 1 % of the elements (the share measured is reported in the assertion
message). Schedules are held to relative 1e-6: XLA's ``cos`` and libm's
differ by an ulp of the cosine, which ``lr * (0.1 + 0.9 * 0.5 * (1 +
cos))`` carries to up to 3 ulps of the rate (2.4e-7 relative measured).

Inside the port, bitwise: a lane of an ``(L, Q)`` stack with a per-lane
step size equals the one-lane update with that step size as a float.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import schedule as jschedule
from repro_torch import convert, pytree
from repro_torch.optim import OptState, make_optimizer
from repro_torch.optim import schedule as tschedule

RTOL, ATOL = 1e-5, 1e-6
BF16_ULP_SHARE = 0.01
STEPS = 6
LRS = [3e-3, 1e-2, 2.5e-3, 7e-4, 1e-1, 5e-3]
OPTIMIZERS = ["sgd", "momentum", "sgd_momentum", "adamw"]


def _tree(rng, bf16: bool):
    """Mixed leaves: a norm-like fp32 vector and two weight matrices."""
    w = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    tree = {"ln": 1.0 + w(7), "blk": {"wq": w(3, 5), "wo": w(4, 6)}, "emb": [w(2, 8)]}
    if bf16:
        tree["blk"] = {k: v.astype(jnp.bfloat16) for k, v in tree["blk"].items()}
    return tree


def _grads(rng, tree):
    g = {k: v for k, v in jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32),
                                       tree).items()}
    g["ln"][::3] = 1e-9  # near-zero coordinates, where AdamW's step is g / (|g| + eps)
    return g


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _bf16_ulps(got: torch.Tensor, want) -> np.ndarray:
    """Signed distance in bf16 ulps (same-sign values)."""
    a = got.view(torch.int16).numpy().astype(np.int32)
    b = np.asarray(want).view(np.int16).astype(np.int32)
    return a - b


def _assert_close(got, want, what: str):
    for i, (g, w) in enumerate(zip(pytree.leaves(got), jax.tree.leaves(want))):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), f"{what} leaf {i}: {g.dtype} != {w.dtype}"
        if g.dtype == torch.bfloat16:
            ulps = np.abs(_bf16_ulps(g, w))
            share = float((ulps > 0).mean())
            assert ulps.max() <= 1 and share <= BF16_ULP_SHARE, f"{what} leaf {i}: {share:.4f} off by an ulp"
        else:
            np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("momentum_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bf16_leaves", [False, True], ids=["fp32-leaves", "mixed-leaves"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_tree_update_matches_reference(name, bf16_leaves, momentum_dtype):
    rng = np.random.default_rng(3)
    jp = _tree(rng, bf16_leaves)
    grads = [_grads(rng, jp) for _ in range(STEPS)]
    jopt = jmake_optimizer(name, momentum_dtype=momentum_dtype)
    topt = make_optimizer(name, momentum_dtype=momentum_dtype)
    tp = convert.lm_params_from_numpy(jax.device_get(jp))
    js, ts = jopt.init(jp), topt.init(tp)
    for t, (g, lr) in enumerate(zip(grads, LRS)):
        jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, g), js, jnp.float32(lr), weight_decay=0.01)
        tp, ts = topt.update(tp, convert.lm_params_from_numpy(g), ts, torch.tensor(lr), weight_decay=0.01)
        _assert_close(tp, jp, f"params step {t}")
        for k in ("mu", "nu"):
            _assert_close(getattr(ts, k), getattr(js, k), f"moment {k} step {t}")
        assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step) == t + 1


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_flat_and_lane_updates_match_reference_and_each_lane(name):
    """A flat vector against the reference; an (L, Q) stack with one step
    size per lane: each lane bit for bit its one-lane update with the float,
    and within tolerance of the reference's update of that lane."""
    rng = np.random.default_rng(5)
    lanes, q = 4, 300
    x = rng.standard_normal((lanes, q)).astype(np.float32)
    gs = [(rng.standard_normal((lanes, q)) * 0.1).astype(np.float32) for _ in range(STEPS)]
    lr = np.array([1e-3, 3e-2, 1e-2 * 1.37, 0.1], np.float32)
    opt, jopt = make_optimizer(name), jmake_optimizer(name)
    stack, stack_state = torch.from_numpy(x.copy()), opt.init(torch.from_numpy(x))
    for g in gs:
        stack, stack_state = opt.update(stack, torch.from_numpy(g), stack_state, torch.from_numpy(lr),
                                        weight_decay=0.01)
    for i in range(lanes):
        one, one_state = torch.from_numpy(x[i].copy()), opt.init(torch.from_numpy(x[i]))
        jx, jstate = jnp.asarray(x[i]), jopt.init(jnp.asarray(x[i]))
        for g in gs:
            one, one_state = opt.update(one, torch.from_numpy(g[i]), one_state, float(lr[i]), weight_decay=0.01)
            jx, jstate = jopt.update(jx, jnp.asarray(g[i]), jstate, float(lr[i]), weight_decay=0.01)
        assert torch.equal(stack[i], one), i
        for lane_moment, one_moment in zip(pytree.leaves((stack_state.mu, stack_state.nu)),
                                           pytree.leaves((one_state.mu, one_state.nu)), strict=True):
            assert torch.equal(lane_moment[i], one_moment), i
        np.testing.assert_allclose(one.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)


# the twins of tests/test_substrate.py's optimizer and schedule tests


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_optimizer_decreases_quadratic(name):
    opt = make_optimizer(name)
    w = {"a": torch.tensor([3.0, -2.0]), "b": torch.tensor([[1.5]])}
    state = opt.init(w)
    loss = lambda p: torch.sum(p["a"] ** 2) + torch.sum(p["b"] ** 2)
    l0 = loss(w)
    for _ in range(60):
        g = torch.func.grad(loss)(w)
        w, state = opt.update(w, g, state, lr=0.1)
    assert loss(w) < l0 * 0.01


def test_adamw_bf16_state_dtype():
    opt = make_optimizer("adamw", momentum_dtype="bfloat16")
    st = opt.init({"a": torch.ones((4,), dtype=torch.float32)})
    assert st.mu["a"].dtype == torch.bfloat16 and st.nu["a"].dtype == torch.bfloat16
    assert st.step.dtype == torch.int32 and st.step.shape == ()


def test_schedules():
    f = tschedule.linear_warmup_cosine(1.0, warmup=10, total_steps=100)
    assert float(f(torch.tensor(0))) == 0.0
    assert float(f(torch.tensor(10))) == pytest.approx(1.0, rel=1e-3)
    assert float(f(torch.tensor(99))) < 0.5
    g = tschedule.cosine_decay(2.0, 100, final_frac=0.1)
    assert float(g(torch.tensor(0))) == pytest.approx(2.0)
    assert float(g(torch.tensor(100))) == pytest.approx(0.2, rel=1e-3)


@pytest.mark.parametrize("which", ["constant", "cosine_decay", "linear_warmup_cosine"])
def test_schedules_match_reference(which):
    """Every step 0..130 (past the end, where the cosine clips) within
    relative 1e-6 of the reference; float32 on the step's device."""
    make = {"constant": lambda m: m.constant(3e-4),
            "cosine_decay": lambda m: m.cosine_decay(3e-4, 100, final_frac=0.1),
            "linear_warmup_cosine": lambda m: m.linear_warmup_cosine(3e-4, warmup=5, total_steps=100)}[which]
    steps = np.arange(131, dtype=np.int32)
    want = np.asarray(jax.vmap(make(jschedule))(jnp.asarray(steps)))
    got = torch.stack([make(tschedule)(torch.tensor(int(s), dtype=torch.int32)) for s in steps])
    assert got.dtype == torch.float32 and got.shape == (131,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_make_optimizer_refuses_unknown_names():
    with pytest.raises(KeyError, match="unknown optimizer"):
        make_optimizer("lion")
    with pytest.raises(ValueError, match="momentum dtype"):
        make_optimizer("adamw", momentum_dtype="float33")
    assert isinstance(make_optimizer("sgd").init(torch.zeros(3)), OptState)
