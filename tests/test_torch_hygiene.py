"""Boundaries of the PyTorch port: no JAX in the port, no silent CPU
fallback, and wrappers that take their plain version only for CPU tensors."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "mica_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "flax", "mica_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_import_leaves_jax_out():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in PORT_FILES if p.parent != ROOT and p.name != "__init__.py"]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'mica_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    from mica_tpu_torch.infer.engine import SlidingWindowPredictor
    from mica_tpu_torch.models.mica import MICA

    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlidingWindowPredictor(MICA(base=16), base_filters=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from mica_tpu_torch.infer.pipeline import prepare_map

        prepare_map("unused.mrc")


def test_cpu_wrappers_take_plain_version():
    from mica_tpu_torch.ops import conv3d_in, depthwise

    before = dict(conv3d_in.launches), dict(depthwise.launches)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 4, 4, 32, generator=g)
    w = torch.randn(32, 32, 3, 3, 3, generator=g)
    y, st = conv3d_in.conv3d([x], w, torch.zeros(32))
    want, _ = conv3d_in.conv3d_plain([x], w, torch.zeros(32))
    assert torch.equal(y, want) and st.shape == (1, 2, 32)
    z = conv3d_in.in_apply(y, st[:, 0], st[:, 1])
    assert torch.equal(z, conv3d_in.in_apply_plain(y, st[:, 0], st[:, 1]))
    dw = depthwise.depthwise_conv3(x, torch.randn(32, 1, 3, 3, 3, generator=g),
                                   torch.zeros(32))
    assert dw.shape == x.shape
    assert (dict(conv3d_in.launches), dict(depthwise.launches)) == before


def test_kernel_build_is_keyed_by_source():
    """Libraries are named by a hash of the source and flags, under the
    git-ignored build directory; nothing is built at import."""
    from mica_tpu_torch.ops import _build

    paths = {name: _build._lib_path(name) for name in _build.SOURCES}
    assert len(set(paths.values())) == len(paths)
    for name, p in paths.items():
        assert p.parent == _build.BUILD_DIR and p.name.startswith(name + "-")
        assert (_build.CSRC / f"{name}.cu").exists()
    assert "build/" in (ROOT / ".gitignore").read_text().split()
