"""The port's public surface against the reference's, on the CPU.

(a) The guard: every name a module of ``src/repro/`` makes public (its
``__all__``, or without one its public top-level functions and classes,
read from the source) exists in the port's module of the same path, or is
one of the omissions listed below, each with its reason and the port's
replacement.

(b) Parity of the names ported by name: the package exports are the
submodules' objects; the five named attacks, ``lad_round``,
``coded_draco_decode``, ``encode_coded_gradient`` and the sparsifiers and
``make_compressor`` against the reference on the same inputs, made with
numpy from a seed, and the reference's own draws (its permutation
``jax.random.permutation(key, Q)``, its round records through
``test_torch_protocol.jax_round_randomness``). Tolerance: rtol 1e-5, atol
1e-6 (tests/test_torch_protocol.py's); the sparsifiers fed the reference's
permutation exactly; QSGD within its flip margin as
``test_torch_protocol.assert_no_level_flip`` holds it.

(c) The program-cache registry: a warm engine step is counted, a clear
returns the counts and empties the caches, and a step built after it
captures once and then never again. Graph mode needs the card, so its
capture is stood in for on the CPU by a class that keeps static copies of
the first inputs and runs the step on them (graph mode's copy-in path).

The dry run's ``microbatches=0`` resolves to the reference's
``auto_microbatches`` count for every train case, and the committed
``experiments/dryrun_torch`` train records are those of the resolved count.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attacks as jatt
from repro.core import byzantine as jbyz
from repro.core import coding as jcoding
from repro.core import compression as jcomp
from repro.core import scenarios as jscn
from repro.data import synthetic as jsyn
from repro_torch.core import attacks as tatt
from repro_torch.core import byzantine as tbyz
from repro_torch.core import coding as tcoding
from repro_torch.core import compression as tcomp
from repro_torch.core import engine as tengine
from repro_torch.core import scenarios as tscn
from repro_torch.data import synthetic as tsyn

from test_torch_protocol import _close, _msgs, _t, assert_no_level_flip, jax_round_randomness

REPO = Path(__file__).resolve().parent.parent
REF_ROOT = REPO / "src" / "repro"

# (reference module, name) -> (why the port has no such name, what it does instead: a
# ``path::name`` under src/repro_torch/)
OMISSIONS = {
    ("repro.core.engine", "grid_compiled_hlo"): (
        "no XLA program to lower: a grid round is a captured CUDA graph", "core/engine.py::grid_launch_list"),
    ("repro.core.scenarios", "grid_compiled_hlo"): (
        "no XLA program to lower: a grid round is a captured CUDA graph", "core/scenarios.py::grid_launch_list"),
    ("repro.core.engine", "make_engine_mesh"): (
        "no jax device mesh: the engine spreads over a torch.distributed group's ranks", "core/engine.py::engine_ranks"),
    ("repro.core.engine", "engine_device_count"): (
        "no jax device mesh: the ranks of a torch.distributed group", "core/engine.py::engine_ranks"),
    ("repro.core.engine", "engine_device_grid"): (
        "no jax device mesh: the ranks of a torch.distributed group", "core/engine.py::engine_ranks"),
    ("repro.kernels.attacks", "attack_pallas"): ("a Pallas kernel: CUDA in csrc/attack.cu", "kernels/attacks.py::launch"),
    ("repro.kernels.attacks", "attack_pallas_lanes"): (
        "a Pallas kernel: CUDA in csrc/attack.cu", "kernels/attacks.py::launch"),
    ("repro.kernels.coded_combine", "coded_combine_pallas"): (
        "a Pallas kernel: CUDA in csrc/row_combine.cu", "kernels/coded_combine.py::rows_launch"),
    ("repro.kernels.coded_combine", "coded_combine_pallas_lanes"): (
        "a Pallas kernel: CUDA in csrc/row_combine.cu", "kernels/coded_combine.py::rows_launch"),
    ("repro.kernels.coded_combine", "gather_combine_pallas"): (
        "a Pallas kernel: CUDA in csrc/gather_combine.cu", "kernels/coded_combine.py::gather_launch"),
    ("repro.kernels.coded_combine", "gather_combine_pallas_lanes"): (
        "a Pallas kernel: CUDA in csrc/gather_combine.cu", "kernels/coded_combine.py::gather_launch"),
    ("repro.kernels.coded_combine", "masked_combine_pallas"): (
        "a Pallas kernel: CUDA in csrc/row_combine.cu", "kernels/coded_combine.py::rows_launch"),
    ("repro.kernels.coded_combine", "masked_combine_pallas_lanes"): (
        "a Pallas kernel: CUDA in csrc/row_combine.cu", "kernels/coded_combine.py::rows_launch"),
    ("repro.kernels.cwtm", "cwtm_pallas"): ("a Pallas kernel: CUDA in csrc/cwtm.cu", "kernels/cwtm.py::launch"),
    ("repro.kernels.cwtm", "cwtm_pallas_lanes"): ("a Pallas kernel: CUDA in csrc/cwtm.cu", "kernels/cwtm.py::launch"),
    ("repro.kernels.nnm_dist", "gram_pallas"): ("a Pallas kernel: CUDA in csrc/gram.cu", "kernels/nnm_dist.py::launch"),
    ("repro.kernels.nnm_dist", "gram_pallas_lanes"): (
        "a Pallas kernel: CUDA in csrc/gram.cu", "kernels/nnm_dist.py::launch"),
    ("repro.kernels.quantize", "stochastic_quantize_pallas"): (
        "a Pallas kernel: CUDA in csrc/quantize.cu", "kernels/quantize.py::launch"),
    ("repro.kernels.quantize", "stochastic_quantize_pallas_lanes"): (
        "a Pallas kernel: CUDA in csrc/quantize.cu", "kernels/quantize.py::launch"),
    ("repro.launch.dryrun", "build_case"): (
        "no compiler to lower a case for: the port counts placed meta tensors", "launch/dryrun.py::run_case"),
    ("repro.launch.roofline", "parse_collectives"): (
        "no HLO text: the port costs the launches of a captured round", "launch/roofline.py::analyze_launches"),
    ("repro.launch.roofline", "HLOAnalysis"): (
        "no HLO text: the port costs the launches of a captured round", "launch/roofline.py::analyze_launches"),
    ("repro.launch.roofline", "analyze_hlo"): (
        "no HLO text: the port costs the launches of a captured round", "launch/roofline.py::analyze_launches"),
    ("repro.launch.roofline", "analyze_compiled"): (
        "no HLO text: the port costs the launches of a captured round", "launch/roofline.py::analyze_launches"),
    ("repro.launch.train", "shardings_for"): (
        "no NamedSharding: a placement is the partition spec itself", "launch/train.py::param_pspecs"),
}
# reference modules with no port module at all, and why
MODULE_OMISSIONS = {
    "repro.testing": "the test side's hypothesis fallback: it belongs to the tests, not to the program",
}


def _ref_modules() -> list[str]:
    mods = []
    for path in sorted(REF_ROOT.rglob("*.py")):
        parts = path.relative_to(REF_ROOT.parent).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def _public_names(module: str) -> list[str]:
    """The module's ``__all__``, or its public top-level defs and classes,
    read from the source without importing it."""
    rel = Path(*module.split("."))
    path = REF_ROOT.parent / rel / "__init__.py"
    path = path if path.exists() else (REF_ROOT.parent / rel).with_suffix(".py")
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not n.name.startswith("_")]


def _port_of(module: str) -> str:
    return "repro_torch" + module[len("repro"):]


def _resolve(citation: str):
    """``path/under/repro_torch.py::name`` -> the object it names."""
    path, name = citation.split("::")
    return getattr(importlib.import_module("repro_torch." + path.removesuffix(".py").replace("/", ".")), name)


@pytest.mark.parametrize("module", _ref_modules())
def test_every_reference_name_has_a_port_counterpart(module):
    if module in MODULE_OMISSIONS:
        assert importlib.util.find_spec(_port_of(module)) is None, f"{module} has a port now: drop its omission"
        return
    port = importlib.import_module(_port_of(module))
    names = _public_names(module)
    missing = [n for n in names if not hasattr(port, n) and (module, n) not in OMISSIONS]
    assert not missing, f"{_port_of(module)} lacks {missing}"
    for (mod, name), (_, instead) in OMISSIONS.items():
        if mod == module:
            assert name in names, f"omission {mod}::{name} names nothing of the reference"
            assert not hasattr(port, name), f"{_port_of(mod)} has {name} now: drop its omission"
            _resolve(instead)


@pytest.mark.parametrize("package", ["core", "data"])
def test_package_exports_are_the_submodules_objects(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    assert port.__all__ == ref.__all__
    for name in port.__all__:
        got = getattr(port, name)
        if isinstance(getattr(ref, name), type(jax)):  # a submodule
            assert got is importlib.import_module(f"repro_torch.{package}.{name}")
        else:
            assert got is getattr(importlib.import_module(got.__module__), name), name
            assert got.__module__ == _port_of(getattr(ref, name).__module__), name


N, Q = 100, 100


@pytest.mark.parametrize("name,param,value", [("sign_flip", "coeff", -3.0), ("zero_attack", None, None),
                                               ("alie", "z", 1.0), ("ipm", "eps", 0.8),
                                               ("label_shift_proxy", "scale", 2.5)])
def test_named_attacks_match_and_are_make_attacks_maps(name, param, value):
    msgs = _msgs(11)
    mask = np.asarray(jatt.sample_byzantine_mask(jax.random.PRNGKey(3), N, 20, fixed=False))
    kw = {} if param is None else {param: value}
    want = getattr(jatt, name)(None, jnp.asarray(msgs), jnp.asarray(mask), **kw)
    got = getattr(tatt, name)(_t(msgs), _t(mask), **kw)
    _close(got, want)
    # make_attack's map of the same attack, bit for bit (AttackSpec has no
    # scale: label_shift stays at 1.0, as the reference's does)
    spec_name = {"zero_attack": "zero", "label_shift_proxy": "label_shift"}.get(name, name)
    spec_kw = {} if param in (None, "scale") else kw
    fn = getattr(tatt, name)
    direct = fn(_t(msgs), _t(mask)) if param == "scale" else got
    assert torch.equal(tatt.make_attack(tatt.AttackSpec(spec_name, **spec_kw))(_t(msgs), _t(mask)), direct)


def test_lad_round_matches_under_the_references_draws():
    """Fig. 4's LAD-CWTM-NNM-d10 (N=100, d=10, 20 sign-flippers), one
    round at the reference's draws."""
    row = "LAD-CWTM-NNM-d10"
    jcfg, tcfg = jscn.PAPER_FIG4[row].protocol(), tscn.PAPER_FIG4[row].protocol()
    z, y = jsyn.linear_regression_problem(jax.random.PRNGKey(0), n=N, dim=Q, sigma_h=0.3)
    x = np.random.default_rng(5).standard_normal(Q).astype(np.float32)
    key = jax.random.PRNGKey(21)
    want = jbyz.lad_round(jcfg, key, jnp.asarray(x), lambda p: jsyn.linreg_subset_grads(z, y, p))
    zt, yt = _t(z), _t(y)
    got = tbyz.lad_round(tcfg, _t(x), lambda p: tsyn.linreg_subset_grads(zt, yt, p),
                         jax_round_randomness(jcfg, key, Q), device="cpu")
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_coded_draco_decode_matches(masked):
    n, d = 12, 3
    msgs = _msgs(12, n=n, q=16)
    msgs[4] *= -2.0  # one liar in the second group
    mask = None if not masked else np.array([1, 1, 1, 1, 0, 1, 0, 1, 1, 1, 1, 0], np.float32)
    want = jbyz.coded_draco_decode(jnp.asarray(msgs), d, None if mask is None else jnp.asarray(mask))
    got = tbyz.coded_draco_decode(_t(msgs), d, None if mask is None else _t(mask))
    _close(got, want)


def test_encode_coded_gradient_matches_on_a_pytree():
    rng = np.random.default_rng(13)
    tree = {"w": rng.standard_normal((4, 3, 5)).astype(np.float32), "b": [rng.standard_normal((4, 7)).astype(np.float32)]}
    want = jcoding.encode_coded_gradient(jax.tree.map(jnp.asarray, tree))
    got = tcoding.encode_coded_gradient({"w": _t(tree["w"]), "b": [_t(tree["b"][0])]})
    assert set(got) == {"w", "b"} and isinstance(got["b"], list)
    _close(got["w"], want["w"])
    _close(got["b"][0], want["b"][0])


@pytest.mark.parametrize("text", ["identity", "randk:0.3", "randk_shared:0.3", "quant:4", "topk:0.3"])
def test_sparsifiers_and_make_compressor_match_on_the_references_permutation(text):
    g = _msgs(14, n=1, q=Q)[0]
    key = jax.random.PRNGKey(17)
    spec_j, spec_t = jcomp.CompressionSpec.parse(text), tcomp.CompressionSpec.parse(text)
    perm = _t(jax.random.permutation(key, Q))
    want = np.asarray(jcomp.make_compressor(spec_j, Q)(key, jnp.asarray(g)))
    if spec_t.name == "quant":
        u = _t(jax.random.uniform(key, (Q,)))
        got = tcomp.make_compressor(spec_t, Q)(_t(g)[None], u[None])[0]
        assert_no_level_flip(g[None], g[None], u[None].numpy(), spec_j)
        _close(got, want)
        return
    got = tcomp.make_compressor(spec_t, Q)(_t(g), perm)
    np.testing.assert_array_equal(got.numpy(), want)
    if spec_t.name in tcomp.SPARSE:
        q_hat = spec_t.kept(Q)
        np.testing.assert_array_equal(tcomp.random_sparsification(_t(g), perm, q_hat).numpy(),
                                      np.asarray(jcomp.random_sparsification(key, jnp.asarray(g), q_hat)))
        np.testing.assert_array_equal(tcomp.rand_k_shared_mask(perm, Q, q_hat).numpy(),
                                      np.asarray(jcomp.rand_k_shared_mask(key, Q, q_hat)))
        # drawn from a generator: the round's own draw (sample_keep_idx) from the same seed
        keep = tcomp.sample_keep_idx(spec_t, 1, Q, torch.Generator().manual_seed(2))[0]
        drawn = tcomp.random_sparsification(_t(g), None, q_hat, generator=torch.Generator().manual_seed(2))
        assert torch.equal(drawn, tcomp.random_sparsification(_t(g), keep, q_hat))
        mask = tcomp.rand_k_shared_mask(None, Q, q_hat, generator=torch.Generator().manual_seed(2))
        assert torch.equal(mask, tcomp.rand_k_shared_mask(keep, Q, q_hat)) and int(mask.sum()) == q_hat


class _HostCapture:
    """A CPU stand-in for ``launch.train._Capture``: static copies of the
    first call's inputs; a call copies its inputs in and runs the function
    on the copies."""

    def __init__(self, fn, inputs, dev):
        from repro_torch.launch import train

        self.fn, self.inputs, self.copy = fn, train._clone(inputs), train._copy_into

    def __call__(self, *inputs):
        self.copy(self.inputs, inputs)
        return self.fn(*self.inputs)


def test_clear_program_caches_drops_what_a_warm_step_holds(monkeypatch):
    from repro_torch import models
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train

    monkeypatch.setattr(train, "_Capture", _HostCapture)
    monkeypatch.setattr(tengine, "_check_mode", lambda mode, dev: None)
    arch = tscn.lm_arch()
    params, specs = models.init(torch.Generator().manual_seed(0), arch)
    tcfg = TrainConfig(arch=arch.name, protocol_impl="engine", n_subsets=4, d=2, n_byz=1, optimizer="adamw",
                       lr=3e-3, steps=4)
    toks = torch.randint(0, arch.vocab, (4, 9), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def captures():
        info = train.engine_program_cache_info()
        return info["round"] + info["apply"]

    step, opt = train.build_engine_step(arch, tcfg, specs, device="cpu", mode="graph")
    state = opt.init(params)
    step(params, state, batch, 0)
    step(params, state, batch, 1)  # warm
    sizes = tengine.program_cache_sizes()
    assert {"train.engine_step", "scenarios.lm_arch", "scenarios.lm_fns", "scenarios.zoo_arch"} <= set(sizes)
    assert sizes["train.engine_step"] >= 2 and sizes["scenarios.lm_arch"] == 1  # the round and the apply
    assert tengine.clear_program_caches() == sizes
    assert set(tengine.program_cache_sizes().values()) == {0}
    before = captures()
    step, opt = train.build_engine_step(tscn.lm_arch(), tcfg, specs, device="cpu", mode="graph")
    first = step(params, state, batch, 0)
    assert captures() == before + 2 and tengine.program_cache_sizes()["train.engine_step"] == 2
    again = step(params, state, batch, 0)
    assert captures() == before + 2
    assert torch.equal(first[2], again[2])


# ------------------------------------------------------------------- the dry run

@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module; importing it sets ``XLA_FLAGS`` for
    its own process, which is put back."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


def _train_cases():
    from repro_torch.configs.archs import ARCHS

    return [(a, mp) for a in sorted(ARCHS) for mp in ("pod1", "pod2")]


@pytest.mark.parametrize("arch,mesh_name", _train_cases())
def test_dryrun_resolves_auto_microbatches_as_the_reference(jdryrun, arch, mesh_name):
    from repro.configs.archs import ARCHS as JARCHS
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import INPUT_SHAPES, TrainConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh, n_data_devices

    multi_pod = mesh_name == "pod2"
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_data = 32 if multi_pod else 16  # the reference's data ranks: (pod x) data of its 16 x 16 meshes
    assert n_data_devices(mesh) == n_data
    shape = INPUT_SHAPES["train_4k"]
    jshape = jdryrun.INPUT_SHAPES["train_4k"]
    auto = TrainConfig(microbatches=0, d=2, n_byz=2)
    want = jdryrun.auto_microbatches(jdryrun._effective_cfg(JARCHS[arch], jshape), jshape, n_data, 2)
    got = dryrun._microbatches(dryrun._effective_cfg(ARCHS[arch], shape), shape, mesh, auto)
    assert got == want
    # the committed record is the CLI's run at microbatches 0, and its bytes those of the resolved count
    path = REPO / "experiments" / "dryrun_torch" / f"{arch}__train_4k__{mesh_name}.json"
    rec = json.loads(path.read_text())
    tcfg = TrainConfig(**{k: v for k, v in rec["tcfg"].items()})
    assert tcfg.microbatches == 0
    ran = dryrun.run_case(arch, "train_4k", multi_pod, tcfg, out_dir=None)
    resolved = dryrun.run_case(arch, "train_4k", multi_pod, dataclasses.replace(tcfg, microbatches=want),
                               out_dir=None)
    for key in ("bytes_accessed_per_rank", "collectives"):
        assert ran[key] == resolved[key] == rec[key], key
    assert ran["tcfg"]["microbatches"] == 0 and resolved["tcfg"]["microbatches"] == want
