"""The port's map pipeline against the JAX one, on the CPU.

resample and normalize: f32 on both sides, atol 1e-6 (same arithmetic,
other summation order in the spline's causal init).  predict_map: f32
network, atol 1e-4 on the probabilities, with and without a docked AF3
model.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mica_tpu.infer import pipeline as jpipeline
from mica_tpu.models.init import init_params_fast
from mica_tpu.models.mica import MICA as JaxMICA
from mica_tpu.ops import normalize as jnormalize
from mica_tpu.ops import resample as jresample
from mica_tpu_torch.infer import pipeline
from mica_tpu_torch.io import mrc, pdb
from mica_tpu_torch.ops import normalize, resample

BASE = 16


@pytest.mark.parametrize("shape,spacing", [((9, 12, 7), (1.2, 0.8, 1.0)),
                                           ((16, 10, 11), (0.7, 1.3, 1.1))])
def test_resample_matches_jax(shape, spacing):
    x = np.random.default_rng(1).random(shape).astype(np.float32)
    want = np.asarray(jresample.resample_to_voxel_size(x, spacing))
    got = resample.resample_to_voxel_size(torch.from_numpy(x), spacing).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("shape", [(9, 8, 7), (10, 10, 10)])
def test_normalize_matches_jax(shape):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    x[0, 0, 0] = np.nan
    want = np.asarray(jnormalize.normalize_map(jnp.asarray(x)))
    got = normalize.normalize_map(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def _write_map(path, shape=(20, 18, 16), voxel=1.25):
    rng = np.random.default_rng(7)
    data = np.zeros(shape, np.float32)
    blob = tuple(slice(n // 6, n // 2 + 2) for n in shape)
    data[blob] = rng.random(tuple(b.stop - b.start for b in blob))
    mrc.write_mrc(path, data, voxel_size=voxel, origin=(1.0, -2.0, 3.0), nstart=(2, 0, 1))
    return path


@pytest.fixture(scope="module")
def params():
    return init_params_fast(
        JaxMICA(base=BASE), (jnp.zeros((1, 8, 8, 8, 1)), jnp.zeros((1, 8, 8, 8, 24))),
        seed=9)


def _write_docked(path, n=40):
    """A CA model of ``n`` residues of mixed types inside ``_write_map``'s
    box (some atoms share a voxel)."""
    rng = np.random.default_rng(11)
    ca = rng.uniform(4.0, 22.0, (n, 3))
    ca[1::7] = ca[::7][: len(ca[1::7])] + 0.2
    types = rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n)
    pdb.write_ca_pdb(path, [ca], res_names_by_chain=[list(types)])
    return path


@pytest.mark.parametrize("docked", [False, True])
def test_predict_map_matches_jax(tmp_path, params, docked):
    path = str(_write_map(tmp_path / "m.mrc"))
    kw = dict(batch_size=2, base_filters=BASE, core=12, halo=2)
    if docked:
        kw["docked_pdb_path"] = str(_write_docked(tmp_path / "docked.pdb"))
    want = jpipeline.predict_map(path, params, dtype=jnp.float32, **kw)
    got = pipeline.predict_map(path, params, dtype=torch.float32, device="cpu", **kw)
    np.testing.assert_allclose(got["prepared_map"].volume, want["prepared_map"].volume,
                               atol=1e-6)
    np.testing.assert_array_equal(got["prepared_map"].offset, want["prepared_map"].offset)
    for k in ("backbone_probability", "carbon_alpha_probability",
              "amino_acid_probability"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4)
    assert set(got["timing"]) >= {"setup", "inference", "reconstruction", "n_windows"}
    if docked:
        assert pipeline.build_af3_bits(got["prepared_map"], kw["docked_pdb_path"]).any()


def test_cli_writes_volumes(tmp_path):
    from mica_tpu_torch.cli.predict import main

    path = str(_write_map(tmp_path / "m.mrc", shape=(10, 9, 8), voxel=1.0))
    out = tmp_path / "out"
    assert main(["-m", path, "-o", str(out), "--base_filters", str(BASE),
                 "--window_core", "12", "--batch_size", "1", "--float32",
                 "--device", "cpu"]) == 0
    for key in ("backbone_probability", "carbon_alpha_probability",
                "amino_acid_prediction"):
        vol = mrc.read_mrc(out / f"{key}.mrc")
        assert vol.to_xyz()[0].shape == (8, 9, 10)  # MRC data is (z, y, x)
        assert np.isfinite(vol.data).all()
    aa = np.load(out / "amino_acid_probability.npz")["data"]
    assert aa.shape == (20, 8, 9, 10)
