"""The port's sliding-window engine against the JAX engine, f32 on the CPU.

A small window geometry (core 12, halo 2) keeps the CPU time low; the
engine code is the same at 48/8.  The volume has empty regions, so the
zero-window tiling and the nonempty-window dedup both run.  Tolerance
atol 1e-4 on the probabilities (f32 convs in another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mica_tpu.infer import engine as jengine
from mica_tpu.models.init import init_params_fast
from mica_tpu.models.mica import MICA as JaxMICA
from mica_tpu.ops import window as jwindow
from mica_tpu_torch.infer import engine
from mica_tpu_torch.ops import window

BASE, CORE, HALO = 16, 12, 2
KEYS = ("backbone_probability", "carbon_alpha_probability", "amino_acid_probability")


@pytest.fixture(scope="module")
def params():
    return init_params_fast(
        JaxMICA(base=BASE), (jnp.zeros((1, 8, 8, 8, 1)), jnp.zeros((1, 8, 8, 8, 24))),
        seed=5)


def _volume():
    rng = np.random.default_rng(21)
    shape = (30, 26, 20)
    vol = np.zeros(shape, np.float32)
    vol[2:14, 3:12, 1:10] = rng.random((12, 9, 9))
    af = np.zeros((24,) + shape, np.float32)
    af[:, 4:10, 4:9, 2:8] = rng.random((24, 6, 5, 6)) < 0.05
    return vol, af


@pytest.mark.parametrize("with_af,blend", [(True, "core"), (False, "core"),
                                           (True, "average")])
def test_engine_matches_jax(params, with_af, blend):
    vol, af = _volume()
    af = af if with_af else None
    jpred = jengine.SlidingWindowPredictor(params, batch_size=2, dtype=jnp.float32,
                                           base_filters=BASE, core=CORE, halo=HALO,
                                           blend=blend)
    want = jpred.predict_volume(vol, af)
    pred = engine.SlidingWindowPredictor(params, batch_size=2, dtype=torch.float32,
                                         base_filters=BASE, core=CORE, halo=HALO,
                                         blend=blend, device="cpu")
    got = pred.predict_volume(vol, af)
    assert pred.timing["n_empty"] == jpred.timing["n_empty"] > 0
    for k in KEYS:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], atol=1e-4)
    agree = got["amino_acid_prediction"] == want["amino_acid_prediction"]
    top2 = np.sort(want["amino_acid_probability"], axis=0)[-2:]
    assert (agree | (top2[1] - top2[0] < 1e-3)).all()


def test_af_bit_pack_round_trip():
    rng = np.random.default_rng(2)
    af = (rng.random((24, 5, 4, 3)) < 0.3).astype(np.float32)
    packed = engine.pack_af_encoding(af)
    np.testing.assert_array_equal(packed, jengine.pack_af_encoding(af))
    unpacked = engine.unpack_af_bits(torch.from_numpy(packed.view(np.int32)))
    np.testing.assert_array_equal(unpacked.numpy(), np.moveaxis(af, 0, -1))
    np.testing.assert_array_equal(
        unpacked.numpy(), np.asarray(jengine.unpack_af_bits(jnp.asarray(packed))))


def test_postprocess_matches_jax():
    rng = np.random.default_rng(4)
    bb, ca = (rng.standard_normal((2, 3, 3, 3, 4)).astype(np.float32) * 4 for _ in range(2))
    aa = rng.standard_normal((2, 3, 3, 3, 21)).astype(np.float32) * 4
    want = jengine.postprocess_logits(jnp.asarray(bb), jnp.asarray(ca), jnp.asarray(aa))
    got = engine.postprocess_logits(torch.from_numpy(bb), torch.from_numpy(ca),
                                    torch.from_numpy(aa))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape,core", [((70, 70, 70), 48), ((13, 5, 97), 12)])
def test_window_geometry_matches_jax(shape, core):
    np.testing.assert_array_equal(window.window_starts(shape, core),
                                  jwindow.window_starts(shape, core))
    assert window.window_counts(shape, core) == jwindow.window_counts(shape, core)
    np.testing.assert_array_equal(window.core_extents(shape, core),
                                  jwindow.core_extents(shape, core))


def test_best_core_minimizes_computed_voxels():
    """core=0 (auto geometry) picks the candidate with the fewest computed
    voxels, scaling the batch to the 64^3-window footprint."""
    core, batch = engine.best_core((100, 100, 100), halo=8, max_batch=8)
    costs = {c: np.prod([-(-100 // c)] * 3) * (c + 16) ** 3 for c in (48, 64, 112)}
    assert core == min(costs, key=costs.get)
    assert batch == max(1, int(8 * 64 ** 3 / (core + 16) ** 3))
    assert engine.auto_batch_size(8, device="cpu") == 8
