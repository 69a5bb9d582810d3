"""No module of the benchmark imports JAX or the JAX package; the reference
imports nothing of the port; the run-time guard compares whole names."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = set(_imports(f)) & set(harness.BANNED)
        assert not bad, f"{f.relative_to(BENCH)} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for f in sorted((BENCH / "reference").glob("*.py")):
        mods = set(_imports(f))
        assert "mica_tpu_torch" not in mods and not mods & set(harness.BANNED), f


def test_guard_compares_top_level_names_whole(monkeypatch):
    clean = {k: v for k, v in sys.modules.items() if k.split(".")[0] not in harness.BANNED}
    monkeypatch.setattr(sys, "modules", {**clean, "mica_tpu_torch.ops": object(),
                                         "jaxlibrary": object()})
    assert harness.banned_modules() == []
    monkeypatch.setattr(sys, "modules", {**clean, "mica_tpu.io.mrc": object(),
                                         "jax": object()})
    assert harness.banned_modules() == ["jax", "mica_tpu"]
