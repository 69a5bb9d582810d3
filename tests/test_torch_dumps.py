"""The port's per-window dumps and Dice report against the JAX package's.

The engine at base 16, f32, core 12 / halo 2 on the CPU, on an odd
(30, 25, 17) volume with empty windows: the same file names and metadata as
the JAX engine, data within 1e-4 (the engines' f32 tolerance,
``test_torch_engine.py``), amino-acid labels equal where the top two
probabilities are more than 1e-3 apart; the volumes rebuilt from the
dumps equal the returned ones exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mica_tpu.infer import engine as jengine
from mica_tpu.models.init import init_params_fast
from mica_tpu.models.mica import MICA as JaxMICA
from mica_tpu.utils import parity as jparity
from mica_tpu_torch.cli import predict as cli_predict
from mica_tpu_torch.infer import engine
from mica_tpu_torch.infer.pipeline import predict_map
from mica_tpu_torch.io import mrc
from mica_tpu_torch.models.convert import state_dict_from_jax_params
from mica_tpu_torch.utils import parity

BASE, CORE, HALO = 16, 12, 2
KEYS = ("backbone_probability", "carbon_alpha_probability", "amino_acid_probability",
        "amino_acid_prediction")


@pytest.fixture(scope="module")
def params():
    return init_params_fast(
        JaxMICA(base=BASE), (jnp.zeros((1, 8, 8, 8, 1)), jnp.zeros((1, 8, 8, 8, 24))),
        seed=5)


def _volume():
    rng = np.random.default_rng(5)
    vol = np.zeros((30, 25, 17), np.float32)
    vol[2:20, 2:20, 2:14] = rng.random((18, 18, 12), dtype=np.float32)
    return vol


def rebuild(files, key: str, halo: int):
    """A volume from reference-layout dumps: each window's core, cropped to
    the volume by its di/dj/dk, pasted at its i/j/k."""
    vol = None
    for f in files:
        z = np.load(f, allow_pickle=True)
        data, m = z["data"], z["metadata"].item()
        shape = tuple(int(s) for s in m["orig_shape"])
        if vol is None:
            vol = np.zeros(data.shape[:-3] + shape, data.dtype)
        i, j, k, di, dj, dk = (m[c] for c in ("i", "j", "k", "di", "dj", "dk"))
        vol[..., i:i + di, j:j + dj, k:k + dk] = data[..., halo:halo + di, halo:halo + dj,
                                                      halo:halo + dk]
    return vol


def _aa_agree(got, want, probs):
    top2 = np.sort(probs, axis=0)[-2:]
    assert ((got == want) | (top2[1] - top2[0] < 1e-3)).all()


@pytest.mark.parametrize("fmt,blend", [("reference", "core"), ("compact", "core"),
                                       ("reference", "average")])
def test_dumps_match_jax(tmp_path, params, fmt, blend):
    vol = _volume()
    jpred = jengine.SlidingWindowPredictor(params, batch_size=4, dtype=jnp.float32,
                                           base_filters=BASE, core=CORE, halo=HALO, blend=blend)
    want = jpred.predict_volume(vol, None, dump_windows_dir=str(tmp_path / "jax"),
                                dump_format=fmt)
    pred = engine.SlidingWindowPredictor(params, batch_size=4, dtype=torch.float32,
                                         base_filters=BASE, core=CORE, halo=HALO, blend=blend,
                                         device="cpu")
    got = pred.predict_volume(vol, None, dump_windows_dir=str(tmp_path / "port"),
                              dump_format=fmt)
    assert pred.timing["n_empty"] > 0
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == pred.timing["n_windows"] * (4 if fmt == "reference" else 1)
    for name in names:
        g, w = (np.load(tmp_path / side / name, allow_pickle=True) for side in ("port", "jax"))
        assert sorted(g.files) == sorted(w.files)
        for f in g.files:
            if f == "metadata":
                gm, wm = g[f].item(), w[f].item()
                assert gm.keys() == wm.keys()
                for k in wm:
                    np.testing.assert_array_equal(gm[k], wm[k], err_msg=f"{name} {k}")
            elif f == "start":
                np.testing.assert_array_equal(g[f], w[f])
                assert g[f].dtype == w[f].dtype
            elif name.endswith("_amino_acid_prediction.npz"):
                probs = np.load(tmp_path / "jax" / name.replace("prediction", "probability"),
                                allow_pickle=True)["data"]
                _aa_agree(g[f], w[f], probs)
            else:
                assert g[f].shape == w[f].shape, name
                np.testing.assert_allclose(g[f], w[f], atol=1e-4, err_msg=name)
    if fmt == "reference" and blend == "core":
        for key in KEYS:
            files = sorted((tmp_path / "port").glob(f"*_{key}.npz"))
            np.testing.assert_array_equal(rebuild(files, key, HALO), got[key], err_msg=key)
    for key in KEYS[:3]:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4)


def test_dumps_do_not_change_the_volumes(tmp_path, params):
    """In core blend the reference layout's full-window forward gives the
    volumes the core forward gives."""
    vol = _volume()
    pred = engine.SlidingWindowPredictor(params, batch_size=4, dtype=torch.float32,
                                         base_filters=BASE, core=CORE, halo=HALO, device="cpu")
    plain = pred.predict_volume(vol)
    dumped = pred.predict_volume(vol, dump_windows_dir=str(tmp_path), dump_format="reference")
    for key in KEYS[:3]:
        np.testing.assert_allclose(dumped[key], plain[key], atol=1e-6)
    with pytest.raises(ValueError, match="dump_format"):
        pred.predict_volume(vol, dump_windows_dir=str(tmp_path), dump_format="grid")


def _write_map(path, shape=(20, 18, 16)):
    rng = np.random.default_rng(7)
    data = np.zeros(shape, np.float32)
    data[3:12, 2:10, 4:12] = rng.random((9, 8, 8))
    mrc.write_mrc(path, data, voxel_size=1.0, origin=(1.0, -2.0, 3.0))
    return path


def test_cli_predict_npz_dir(tmp_path, params):
    """``--npz_dir`` writes the reference layout, whose rebuilt volumes
    equal ``predict_map``'s; with several maps it is refused."""
    sd = state_dict_from_jax_params(params)
    torch.save(sd, tmp_path / "ck.pth")
    map_path = _write_map(tmp_path / "map.mrc")
    common = ["--model_checkpoint", str(tmp_path / "ck.pth"), "--base_filters", str(BASE),
              "--window_core", "12", "--batch_size", "4", "--float32", "--device", "cpu"]
    rc = cli_predict.main(["-m", str(map_path), "-o", str(tmp_path / "out"),
                           "--npz_dir", str(tmp_path / "grids")] + common)
    assert rc == 0
    out = predict_map(str(map_path), sd, batch_size=4, dtype=torch.float32, base_filters=BASE,
                      core=12, device="cpu")
    n = out["timing"]["n_windows"]
    for key in KEYS:
        files = sorted((tmp_path / "grids").glob(f"grid_i*_j*_k*_{key}.npz"))
        assert len(files) == n
        np.testing.assert_array_equal(rebuild(files, key, 8), out[key], err_msg=key)
    with pytest.raises(SystemExit):
        cli_predict.main(["-m", str(map_path), str(map_path), "-o", str(tmp_path / "o2"),
                          "--npz_dir", str(tmp_path / "g2")] + common)
    assert not (tmp_path / "g2").exists()


def test_dice_report_equals_jax():
    rng = np.random.default_rng(3)
    a = {"backbone_probability": rng.random((9, 8, 7)),
         "carbon_alpha_probability": rng.random((9, 8, 7)),
         "amino_acid_prediction": rng.integers(0, 20, (9, 8, 7))}
    b = {k: v.copy() for k, v in a.items()}
    b["backbone_probability"][:3] = rng.random((3, 8, 7))
    b["amino_acid_prediction"][4:] = rng.integers(0, 20, (5, 8, 7))
    for x, y in ((a, b), (a, a)):
        assert parity.mask_dice_report(x, y) == jparity.mask_dice_report(x, y)
    assert parity.mask_dice_report(a, a)["min_dice"] == 1.0
    z = np.zeros((4, 4), bool)
    assert parity.dice(z, z) == jparity.dice(z, z) == 1.0
    assert parity.dice(a["backbone_probability"] > 0.3, b["backbone_probability"] > 0.5) == \
        jparity.dice(a["backbone_probability"] > 0.3, b["backbone_probability"] > 0.5)
