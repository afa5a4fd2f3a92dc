"""The port stands alone: no JAX and nothing of ``repro`` in ``repro_torch``,
its examples (``examples/torch_*.py``) or ``chip_smoke.py``, and importing
the package builds no kernel."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((REPO / "src" / "repro_torch").rglob("*.py")) + sorted((REPO / "examples").glob("torch_*.py"))
              + [REPO / "chip_smoke.py"])


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_and_no_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def _run(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), **env}, cwd=REPO,
    )


def test_port_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.convert, repro_torch.core.scenarios, "
        "repro_torch.core.engine, repro_torch.core.byzantine, repro_torch.kernels.ops, "
        "repro_torch.core.participation, repro_torch.core.coding, repro_torch.kernels.quantize, "
        "repro_torch.models, repro_torch.configs.archs, repro_torch.core.theory, repro_torch.pytree, "
        "repro_torch.optim.schedule, repro_torch.checkpoint, repro_torch.launch.train, "
        "repro_torch.models.moe, repro_torch.models.mamba, repro_torch.models.rwkv, repro_torch.models.precision, "
        "repro_torch.core.protomath, repro_torch.core.distributed, repro_torch.launch.mesh, "
        "repro_torch.launch.fleet, repro_torch.launch.chaos, repro_torch.timing, repro_torch.launch.tuner, "
        "repro_torch.launch.roofline\n"
        "import dataclasses, torch\n"
        "from repro_torch.core import scenarios as S\n"
        "r = S.run_scenario(S.PAPER_FIG4['LAD-CWTM-NNM-d10'], 2, device='cpu')\n"
        "assert r.metrics['loss'].shape == (2,)\n"
        "row = dataclasses.replace(S.participation_sweep(schedules=('adversarial',))[0], compressor='quant:4')\n"
        "r = S.run_scenario(row, 2, dim=32, device='cpu')\n"
        "assert r.metrics['n_report'].tolist() == [13.0, 13.0]\n"
        "r = S.run_lm_scenario(S.lm_sweep()[0], 1, device='cpu')\n"
        "assert r.metrics['loss'].shape == (1,)\n"
        "z = S.run_zoo_sweep(1, families=('moe', 'audio'), device='cpu', mode='loop')\n"
        "assert sorted(z) == ['audio', 'moe'] and all(r.metrics['loss'].shape == (1,) for f in z.values() "
        "for r in f.values())\n"
        "assert S.zoo_arch('jamba').name == 'zoo-jamba' and len(S.zoo_sweep()) == len(S.ZOO_FAMILIES) == 7\n"
        "from repro_torch.launch import train as T\n"
        "tr = T.Trainer(S.lm_arch(), T.TrainConfig(protocol_impl='engine', n_subsets=4, n_byz=1), device='cpu')\n"
        "toks = torch.randint(0, 64, (4, 9), generator=torch.Generator().manual_seed(0))\n"
        "assert len(tr.run([{'tokens': toks[:, :-1], 'labels': toks[:, 1:]}])) == 1\n"
        "from repro_torch.launch.mesh import make_host_mesh\n"
        "tr = T.Trainer(S.lm_arch(), T.TrainConfig(n_byz=1, attack='alie'), device='cpu', mesh=make_host_mesh(4))\n"
        "assert len(tr.run([{'tokens': toks[:, :-1], 'labels': toks[:, 1:]}])) == 1\n"
        "from repro_torch.launch import roofline, tuner\n"
        "tuner.set_store_path(None)\n"
        "g = S.run_grid(S.synthetic_sweep(3), 2, dim=8, device='cpu', mode='loop', max_lanes_per_device='auto')\n"
        "assert len(g) == 3 and tuner.tuner_stats()['probes'] > 0\n"
        "assert roofline.active_params(S.lm_arch()) > 0\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules "
        "if sys.modules[m] is not None)\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr


def test_import_builds_nothing_and_needs_no_nvcc(tmp_path):
    build_dir = REPO / "build" / "repro_torch"
    before = sorted(build_dir.iterdir()) if build_dir.exists() else None
    code = (
        "import repro_torch, repro_torch.kernels.ops, repro_torch.core.scenarios, repro_torch.core.coding, "
        "repro_torch.launch.fleet\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._entries == {}\n"
        "print(_build.BUILD_DIR)\n"
    )
    proc = _run(code, PATH=str(tmp_path))  # no nvcc on PATH
    assert proc.returncode == 0, proc.stderr
    assert Path(proc.stdout.strip()) == build_dir
    after = sorted(build_dir.iterdir()) if build_dir.exists() else None
    assert after == before
