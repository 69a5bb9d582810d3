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


def test_cli_window_difference_is_the_reductions_rounding(params, monkeypatch):
    """At the 28^3 windows of ``cli.run`` on the CPU (core 12, halo 8) the f32
    logits of the two packages differ by more than at 16^3.  The cause is on
    the XLA side: its CPU reductions sum a window's InstanceNorm statistics
    in f32 less exactly than torch's, the more so the larger the window, and
    twelve normalisations carry that on.  With
    the JAX model's statistics summed in f64, nothing else changed, the same
    window agrees to 1e-4 (reads 3.8e-5; unchanged it reads 2.7e-4, held
    here to 1e-3)."""
    import jax

    from mica_tpu.models import mica as jmica
    from mica_tpu_torch.models.convert import state_dict_from_jax_params
    from mica_tpu_torch.models.mica import MICA
    from mica_tpu_torch.utils.synthetic import make_scenario

    _, _, vols = make_scenario(n_res=24, shape=(36, 36, 36), seed=3)
    x = np.pad(vols["backbone_probability"].astype(np.float32), 8)[None, 4:32, 4:32, 4:32, None]
    model = MICA(base=BASE, dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax_params(params))
    with torch.no_grad():
        got = [o.numpy() for o in model(torch.from_numpy(x.copy()), None)]

    def jax_logits():
        out = JaxMICA(base=BASE, dtype=jnp.float32).apply({"params": params}, jnp.asarray(x), None)
        return [np.asarray(o) for o in out]

    def worst(want):
        return max(float(np.abs(g - w).max()) for g, w in zip(got, want))

    as_is = worst(jax_logits())

    def f64_stats_norm(v, eps=1e-5):
        vd = v.astype(jnp.float64)
        mean = jnp.mean(vd, axis=(1, 2, 3), keepdims=True)
        var = jnp.maximum(jnp.mean(vd * vd, axis=(1, 2, 3), keepdims=True) - mean * mean, 0.0)
        scale = jax.lax.rsqrt(var + eps)
        return (v - mean.astype(v.dtype)) * scale.astype(v.dtype)

    monkeypatch.setattr(jmica, "instance_norm", f64_stats_norm)
    with jax.enable_x64(True):
        exact_stats = worst(jax_logits())
    print(f"28^3 window, f32 logits, port vs JAX: {as_is:.3e} as is, {exact_stats:.3e} with "
          "the JAX statistics summed in f64")
    assert exact_stats <= 1e-4 < as_is <= 1e-3


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


@pytest.mark.parametrize("with_af", [True, False])
def test_keep_on_device_returns_the_same_volumes_as_tensors(params, with_af):
    vol, af = _volume()
    af = af if with_af else None
    pred = engine.SlidingWindowPredictor(params, batch_size=2, dtype=torch.float32,
                                         base_filters=BASE, core=CORE, halo=HALO, device="cpu")
    host = pred.predict_volume(vol, af)
    kept = pred.predict_volume(vol, af, keep_on_device=True)
    assert set(kept) == set(host)
    for k, v in kept.items():
        assert isinstance(v, torch.Tensor) and v.device == pred.device and v.is_contiguous()
        assert tuple(v.shape) == host[k].shape
        np.testing.assert_array_equal(v.numpy(), host[k])
    assert kept["amino_acid_probability"].shape == (20,) + vol.shape
    assert kept["amino_acid_prediction"].dtype == torch.int64


def test_core_blend_moves_windows_through_the_copy_functions(params, monkeypatch):
    """Core blend with a packed (or no) AF encoding gathers and scatters one
    batch per call with starts uploaded once; a fractional encoding and
    average blend keep their torch slices."""
    vol, af = _volume()
    calls = {"gather": 0, "scatter": 0, "starts": 0}

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(engine, "gather_windows", counted("gather", engine.gather_windows))
    monkeypatch.setattr(engine, "scatter_cores", counted("scatter", engine.scatter_cores))
    monkeypatch.setattr(engine, "starts_tensor", counted("starts", engine.starts_tensor))
    pred = engine.SlidingWindowPredictor(params, batch_size=2, dtype=torch.float32,
                                         base_filters=BASE, core=CORE, halo=HALO, device="cpu")
    pred.predict_volume(vol, af)
    batches = pred.timing["n_forwards"] - 1          # one forward is the all-zero window
    assert batches >= 2
    assert calls == {"gather": batches, "scatter": batches, "starts": 1}
    frac = af * 0.5
    got = pred.predict_volume(vol, frac)
    assert calls["gather"] == batches and np.isfinite(got["backbone_probability"]).all()
    avg = engine.SlidingWindowPredictor(params, batch_size=2, dtype=torch.float32,
                                        base_filters=BASE, core=CORE, halo=HALO,
                                        blend="average", device="cpu")
    avg.predict_volume(vol, af)
    assert calls["gather"] == batches
