"""One checkpoint loader for the port's CLIs (``models.convert.load_checkpoint``),
on the CPU at base 16 in f32.

``cli.train`` writes ``mica_epoch_<n>[_best].pt`` with the weights under
``"model"``; ``cli.predict`` and ``cli.run``'s ``build_solver`` load it, and
the volumes ``cli.predict`` writes equal those of the trainer's model.  An
original-format ``.pth`` (``module.``-prefixed ``model_state_dict``) and a
bare state dict load too; any other layout raises and names its keys.
"""

import numpy as np
import pytest
import torch

from mica_tpu_torch.cli import predict as cli_predict
from mica_tpu_torch.cli import run as cli_run
from mica_tpu_torch.cli import train as cli_train
from mica_tpu_torch.infer.pipeline import predict_map
from mica_tpu_torch.io import mrc as mrc_io
from mica_tpu_torch.models.convert import load_checkpoint
from mica_tpu_torch.models.mica import MICA
from mica_tpu_torch.train import data

BASE = 16


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A one-epoch ``cli.train`` run on a tiny dataset: (its .pt, the
    trainer model's state dict, the directory)."""
    tmp = tmp_path_factory.mktemp("ckpt")
    data.ArrayDataset(*data.synthetic_batch(3, 8, seed=6)).save(str(tmp / "d.npz"))
    assert cli_train.main([
        "--data_path", str(tmp / "d.npz"), "--output_path", str(tmp / "out"),
        "--batch_size", "2", "--num_epochs", "1", "--base_filters", str(BASE),
        "--dtype", "float32", "--log_dir", str(tmp / "logs"), "--device", "cpu"]) == 0
    (pt,) = sorted((tmp / "out").glob("mica_epoch_0*.pt"))
    sd = torch.load(pt, map_location="cpu", weights_only=True)["model"]
    return pt, sd, tmp


def _map(path, n=16, seed=0):
    vol = np.random.default_rng(seed).random((n, n, n)).astype(np.float32)
    mrc_io.write_mrc(path, vol, voxel_size=1.0)
    return path


def test_cli_predict_loads_a_cli_train_checkpoint(trained, tmp_path):
    pt, sd, _ = trained
    map_path = _map(tmp_path / "m.mrc")
    assert cli_predict.main(["-m", str(map_path), "-o", str(tmp_path / "out"),
                             "--model_checkpoint", str(pt), "--base_filters", str(BASE),
                             "--window_core", "8", "--batch_size", "4", "--float32",
                             "--device", "cpu"]) == 0
    want = predict_map(str(map_path), sd, batch_size=4, dtype=torch.float32,
                       base_filters=BASE, core=8, device="cpu")
    for key in ("backbone_probability", "carbon_alpha_probability"):
        got = mrc_io.read_mrc(tmp_path / "out" / f"{key}.mrc").to_xyz()[0]
        np.testing.assert_array_equal(got, np.asarray(want[key], np.float32), err_msg=key)


def test_cli_run_solver_loads_a_cli_train_checkpoint(trained, tmp_path):
    pt, sd, _ = trained
    sol = cli_run.build_solver(cli_run.build_parser().parse_args([
        "-m", "map.mrc", "-f", "seq.fasta", "-i", str(tmp_path), "--model_path", str(pt),
        "--base_filters", str(BASE), "--device", "cpu", "--float32"]))
    assert sol.params.keys() == sd.keys()
    assert all(torch.equal(sol.params[k], v) for k, v in sd.items())
    MICA(base=BASE, dtype=torch.float32).load_state_dict(sol.params, strict=True)


@pytest.mark.parametrize("layout", ["original", "bare", "trainer", "unknown"])
def test_load_checkpoint_layouts(trained, tmp_path, layout):
    _, sd, _ = trained
    half = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    obj = {"original": {"epoch": 3, "model_state_dict": {f"module.{k}": v for k, v in half.items()},
                        "optimizer_state_dict": {}, "val_loss": 1.0},
           "bare": half,
           "trainer": {"model": half, "epoch": 0, "step": 2},
           "unknown": {"weights": half, "epoch": 0}}[layout]
    path = tmp_path / "ck.bin"
    torch.save(obj, path)
    if layout == "unknown":
        with pytest.raises(ValueError, match=r"keys: \['epoch', 'weights'\]"):
            load_checkpoint(str(path))
        return
    got = load_checkpoint(str(path))
    assert got.keys() == sd.keys()
    assert all(v.dtype == torch.float32 and torch.equal(v, half[k].float())
               for k, v in got.items())
