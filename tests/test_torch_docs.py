"""The port's paper map (``docs/paper_map_torch.md``) stays true.

Its ``python`` snippets run in order in one namespace, in a fresh
interpreter with ``jax`` and ``repro`` blocked, as a reader of the port
would run them on the CPU; every ``path::name`` it cites resolves to an
attribute of a module under ``src/repro_torch/`` (and every ``csrc/`` file
it names exists), so a renamed function fails here without running any
code; and every row of the reference's ``docs/paper_map.md`` has its row
on the port's page. ``bash`` fences are not run.
"""
from __future__ import annotations

import importlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PAGE = REPO / "docs" / "paper_map_torch.md"
REFERENCE_PAGE = REPO / "docs" / "paper_map.md"
SNIPPETS_TIMEOUT_S = 120

_FENCE = re.compile(r"^```python[ \t]*\n(.*?)^```", re.S | re.M)
_CITATION = re.compile(r"`([\w/]+\.py)::([\w.]+)`")
_SOURCE = re.compile(r"`(csrc/[\w.]+\.cuh?)`")


def _mapped_rows(text: str) -> set[str]:
    """The first cells of the rows of the page's map tables (those headed
    ``| Paper object | Code |`` or ``| Extension | Code |``)."""
    rows, in_map = set(), False
    for line in text.splitlines():
        if not line.startswith("|"):
            in_map = False
            continue
        first = line.split("|")[1].strip()
        if first in ("Paper object", "Extension"):
            in_map = True
        elif in_map and not first.startswith("---"):
            rows.add(first)
    return rows


_RUNNER = """
import json, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
ns = {"__name__": "paper_map_torch"}
for i, code in enumerate(json.load(sys.stdin)):
    exec(compile(code, f"docs/paper_map_torch.md[block {i}]", "exec"), ns)
print(sorted(m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in ("jax", "repro")))
"""


def snippets(path: Path) -> list[str]:
    """The ``python``-fenced blocks of a markdown file, in order."""
    return _FENCE.findall(path.read_text())


def test_snippets_run_with_jax_and_the_reference_blocked(tmp_path):
    blocks = snippets(PAGE)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "TMPDIR": str(tmp_path)}
    run = subprocess.run([sys.executable, "-c", _RUNNER], input=json.dumps(blocks), capture_output=True, text=True,
                         timeout=SNIPPETS_TIMEOUT_S, env=env, cwd=REPO)
    assert run.returncode == 0, run.stderr[-4000:]
    assert run.stdout.strip() == "[]", run.stdout  # no jax or repro module came in


def test_every_citation_resolves_and_every_paper_row_is_mapped():
    text = PAGE.read_text()
    cited = _CITATION.findall(text)
    assert len(cited) > 50
    for path, name in cited:
        module = importlib.import_module("repro_torch." + path.removesuffix(".py").replace("/", "."))
        obj = module
        for part in name.split("."):
            assert hasattr(obj, part), f"{path}::{name} does not resolve"
            obj = getattr(obj, part)
    for source in _SOURCE.findall(text):
        assert (REPO / "src" / "repro_torch" / source).is_file(), source
    theirs = _mapped_rows(REFERENCE_PAGE.read_text())
    assert len(theirs) > 30 and not theirs - _mapped_rows(text), sorted(theirs - _mapped_rows(text))


def test_extractor_finds_the_snippets():
    blocks = snippets(PAGE)
    assert len(blocks) >= 6 and all(b.strip() for b in blocks)
    assert not any("```" in b for b in blocks)
