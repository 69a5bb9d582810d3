"""The plain reference agrees with the port's f32 CPU route at a small width
and window, and its input path with independent witnesses (scipy's zoom)
and the port's own functions."""

from __future__ import annotations

import numpy as np
import pytest
import scipy.ndimage
import torch

from benchmark import gen
from benchmark.reference import mica as ref
from benchmark.reference import prep

SEED = 4_100_000_007


def test_param_shapes_are_the_ports():
    from mica_tpu_torch.models.mica import MICA

    port = {k: tuple(v.shape) for k, v in MICA(base=16).state_dict().items()}
    assert port == ref.param_shapes(16)


@pytest.mark.parametrize("with_af", [True, False])
def test_forward_matches_the_port_f32(with_af):
    from mica_tpu_torch.models.mica import MICA

    base, w = 16, 16
    sd = gen.weights(ref.param_shapes(base), SEED, "cpu")
    model = MICA(base=base, dtype=torch.float32)
    model.load_state_dict(sd)
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, w, w, w, 1, generator=g)
    af = (torch.rand(2, w, w, w, 24, generator=g) < 0.05).float() if with_af else None
    if af is not None:
        af[1] = 0.0                       # one sample takes the zero-AF3 bypass
    crop = slice(4, 12)
    with torch.no_grad():
        want = model(x, af, out_slice=crop)
        got = ref.forward(sd, x.permute(0, 4, 1, 2, 3),
                          None if af is None else af.permute(0, 4, 1, 2, 3), out_slice=crop)
    for a, b in zip(got, want):
        b = b.permute(0, 4, 1, 2, 3)
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item())


def test_resample_matches_scipy_zoom():
    x = np.random.default_rng(2).random((30, 27, 33), np.float32)
    voxel = np.array([0.83, 0.83, 0.83])
    got = prep.resample(torch.from_numpy(x), voxel).numpy()
    want = scipy.ndimage.zoom(x.astype(np.float64), 0.83, order=3)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5


def test_prepare_and_rasterize_match_the_port(tmp_path):
    from mica_tpu_torch.infer.pipeline import build_af3_encoding, prepare_map

    tr = {"box": 40, "voxel_size": 0.83, "residues": 60, "domains": [1, 1, 1],
          "envelope": [0.2, 0.2, 0.2], "sigma_a": 1.2, "noise": 0.05, "masked": False, "maps": 1}
    (mp, pp), = gen.map_pair(SEED, tr, tmp_path, "cpu")
    vol, origin, voxel, start = prep.prepare(mp, "cpu")
    port = prepare_map(str(mp), device="cpu")
    assert vol.shape == port.volume.shape
    assert np.abs(vol.numpy() - port.volume).max() < 1e-5
    enc = prep.rasterize(pp, vol.shape, origin, voxel, start)
    assert np.array_equal(enc, build_af3_encoding(port, str(pp)).astype(np.uint8))
    assert enc.sum() > 0


def test_window_cuts_like_the_port():
    from mica_tpu_torch.ops.window import extract_windows, window_starts

    v = torch.rand(20, 17, 23)
    wins = extract_windows(v, 8, 4)
    for i, s in enumerate(window_starts(tuple(v.shape), 8)):
        assert torch.equal(prep.window(v, s, 8, 4), wins[i])


def test_training_reference_follows_the_port_f32(tmp_path):
    """The trainer at f32 on the CPU and the reference take the same three
    steps: the same rows, augmentation, blanking and dropout."""
    from benchmark import harness
    from benchmark.reference import compare

    from .conftest import SMALL_CFG, SMALL_TRAIN

    w, cfg, tr = harness.cell("train-b8-af3")
    d = harness.driver_class("train")({**cfg, **SMALL_CFG}, {**tr, **SMALL_TRAIN}, SEED,
                                      torch.device("cpu"), tmp_path)
    d.setup()
    d.release()
    want = d.reference()
    n = compare.train_numbers(d.judged(d.got, want), want)
    assert n["loss1_gap"] < 1e-6 and n["loss_gap"] < 1e-3
    assert n["grad_gap"] < 1e-2 and n["grad_gap_median"] < 1e-4
    assert n["grad_diff_median"] < 1e-4


def test_leaves_of_rounding_alone_are_not_counted():
    """A leaf whose reference gradient is under a thousandth of the median
    leaf's, or a bias under a thousandth of its weight's RMS (a conv bias
    before an InstanceNorm), is left out; a small bias that is more than
    rounding stays."""
    from benchmark.reference import compare

    g = {"a.weight": 1.0, "a.bias": 0.05, "b.weight": 20.0, "b.bias": 6e-4,
         "c.weight": 1.5, "c.bias": 0.5, "d.weight": 0.0}
    n = {"a.weight": 1000, "a.bias": 10, "b.weight": 1000, "b.bias": 10,
         "c.weight": 1000, "c.bias": 10, "d.weight": 1000}
    assert compare.counted({"grad_norms": g, "sizes": n}) == ["a.weight", "a.bias", "b.weight",
                                                              "c.weight", "c.bias"]
