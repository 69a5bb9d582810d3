"""The benchmark's inputs repeat from a seed, and the two map kinds leave the
engine the windows their cells are about."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import gen
from benchmark.harness import load
from benchmark.reference import mica as ref

SEED = 3_000_000_019


def _maps(tmp_path, seed, traffic):
    files = gen.map_pair(seed, traffic, tmp_path, "cpu")
    return [(m.read_bytes(), p.read_bytes()) for m, p in files]


def test_maps_repeat_from_a_seed(tmp_path):
    tr = {**load("traffic", "maps-masked"), "box": 48, "residues": 80}
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "c").mkdir()
    a = _maps(tmp_path / "a", SEED, tr)
    assert a == _maps(tmp_path / "b", SEED, tr)
    other = _maps(tmp_path / "c", SEED + 1, tr)
    assert a[0][0] != other[0][0] and a[0][1] != other[0][1]
    assert a[0][0] != a[1][0], "the two maps of a run differ"


def test_training_windows_and_weights_repeat_from_a_seed():
    tr = {**load("traffic", "train-windows"), "box": 24, "residues": 40, "windows": 6}
    a = gen.train_windows(SEED, tr, 8, 4, "cpu", lambda v: v / v.max())
    b = gen.train_windows(SEED, tr, 8, 4, "cpu", lambda v: v / v.max())
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert a["density"].shape == (6, 16, 16, 16) and a["af3"].dtype == np.uint8
    assert a["aa"].max() <= 20 and a["bb"].max() == 3
    shapes = ref.param_shapes(16)
    w1, w2 = gen.weights(shapes, SEED, "cpu"), gen.weights(shapes, SEED, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in shapes)
    w3 = gen.weights(shapes, SEED + 1, "cpu")
    assert not torch.equal(w1["encoder.0.transition.0.weight"], w3["encoder.0.transition.0.weight"])


def _nonempty(tmp_path, name):
    """Windows the port's engine would compute on the traffic's first map,
    after the port's own resampling and normalization."""
    from mica_tpu_torch.infer.engine import _window_nonempty
    from mica_tpu_torch.infer.pipeline import prepare_map
    from mica_tpu_torch.ops.window import window_counts

    tr = {**load("traffic", name), "maps": 1}
    (mp, _), = gen.map_pair(SEED, tr, tmp_path, "cpu")
    v = prepare_map(str(mp), device="cpu").volume
    core, halo = 48, 8
    counts = window_counts(v.shape, core)
    pads = [(halo, n * core - core + 2 * halo + core - halo - s) for n, s in zip(counts, v.shape)]
    return int(_window_nonempty(np.pad(v, pads), counts, core, halo).sum()), int(np.prod(counts))


def test_unmasked_map_leaves_no_window_empty(tmp_path):
    n, total = _nonempty(tmp_path, "maps-dense-docked")
    assert total == 216 and n == 216


def test_masked_map_leaves_about_half_empty(tmp_path):
    n, total = _nonempty(tmp_path, "maps-masked")
    assert total == 216 and 0.4 * total <= n <= 0.6 * total, n
