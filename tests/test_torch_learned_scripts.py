"""The port's fixture trainer and synthetic demo, on the CPU.

``train_synth_fixture`` runs tiny (f32, two steps, one 32^3 scenario,
two held-out ones) and writes an original-format ``.pth`` that
``load_checkpoint`` reads back as the trained network's weights.  The
demo's input builder, its ``cli.run`` command line and ``ca_accuracy`` are
checked on a known chain, without running ``cli.run``: random weights can
leave its aligner without candidates.
"""

import functools
import sys

import numpy as np
import pytest
import torch

from mica_tpu_torch.io import mrc as mrc_io
from mica_tpu_torch.io import pdb as pdb_io
from mica_tpu_torch.models.convert import load_checkpoint
from mica_tpu_torch.models.mica import MICA
from mica_tpu_torch.ops import window
from mica_tpu_torch.scripts import synthetic_demo, train_synth_fixture
from mica_tpu_torch.train import data


def test_fixture_trains_tiny_and_writes_a_loadable_pth(tmp_path, monkeypatch):
    # 24^3 windows (core 16, halo 4) in the data and the evaluation: a
    # training step on a 64^3 window takes ~15 s on the CPU
    monkeypatch.setattr(data, "extract_windows",
                        functools.partial(window.extract_windows, core=16, halo=4))
    monkeypatch.setattr(train_synth_fixture, "SlidingWindowPredictor", functools.partial(
        train_synth_fixture.SlidingWindowPredictor, core=16, halo=4))
    out = tmp_path / "fixture.pth"
    args = train_synth_fixture.build_parser().parse_args([
        "--device", "cpu", "--dtype", "float32", "--steps", "2", "--batch", "2",
        "--n_scenarios", "1", "--shape", "32", "--n_res", "12", "--eval_shape", "32",
        "--eval_n_res", "12", "--eval_scenarios", "2", "--out", str(out)])
    res = train_synth_fixture.run(args)
    assert res["dataset_windows"] == 8 and len(res["losses"]) == 2
    assert np.isfinite(res["losses"]).all()
    for d in (res["init_dice"], res["dice"]):
        assert len(d["each"]) == 2
        assert all(0.0 <= b <= 1.0 and 0.0 <= c <= 1.0 for b, c in d["each"])
        assert d["backbone"] == pytest.approx(np.mean([b for b, _ in d["each"]]))
        assert d["ca"] == pytest.approx(np.mean([c for _, c in d["each"]]))
    raw = torch.load(out, map_location="cpu", weights_only=True)
    assert all(k.startswith("module.") for k in raw["model_state_dict"])
    sd = load_checkpoint(str(out))
    MICA(base=16, dtype=torch.float32).load_state_dict(sd, strict=True)
    # the exported weights are the trained ones, not the initial ones
    init = MICA(base=16).init_weights(torch.Generator().manual_seed(2)).state_dict()
    assert any(not torch.equal(sd[k], v) for k, v in init.items())
    defaults = train_synth_fixture.build_parser().parse_args([])
    assert (defaults.steps, defaults.batch, defaults.n_scenarios, defaults.shape,
            defaults.n_res, defaults.lr, defaults.base, defaults.dtype, defaults.device,
            defaults.eval_scenarios) == (1200, 8, 8, 144, 170, 3e-4, 16, "bfloat16", "cuda", 1)
    assert defaults.out.startswith("build/")


def test_demo_inputs_command_and_accuracy(tmp_path):
    truth = synthetic_demo.build_inputs(tmp_path, 20, (40, 40, 40), seed=11)
    assert truth.shape == (20, 3)
    vol = mrc_io.read_mrc(tmp_path / "emd_demo.mrc").to_xyz()[0]
    assert vol.shape == (40, 40, 40)
    seq = (tmp_path / "demo.fasta").read_text().splitlines()[1]
    for pdb in ("input/AF3_structures/synth/ranked_0.pdb", "input/input_af3_docked.pdb"):
        atoms = pdb_io.parse_pdb(tmp_path / pdb)
        np.testing.assert_allclose(pdb_io.coords(atoms), truth, atol=1e-3)
        assert "".join(pdb_io.THREE_TO_ONE[r] for r in atoms["res_name"]) == seq

    cmd = synthetic_demo.run_command(tmp_path, "/w/ck.pth", 16, "cuda")
    assert cmd[:3] == [sys.executable, "-m", "mica_tpu_torch.cli.run"]
    from mica_tpu_torch.cli import run as cli_run

    args = cli_run.build_parser().parse_args(cmd[3:])
    assert (args.map_path, args.input_dir, args.model_checkpoint, args.base_filters,
            args.device, args.run_pulchra) == (str(tmp_path / "emd_demo.mrc"),
                                               str(tmp_path / "input"), "/w/ck.pth", 16,
                                               "cuda", True)

    # the true chain itself: all covered at 0 A; moved by 1 A: all covered
    # at 1 A (CAs are >= 3.4 A apart, so no other built CA is nearer);
    # its first half alone: half covered at 0 A, the rest farther
    for name, built, want in (("same", truth, (1.0, 0.0)),
                              ("moved", truth + (0.0, 0.0, 1.0), (1.0, 1.0))):
        pdb_io.write_ca_pdb(tmp_path / f"{name}.pdb", [built])
        got = synthetic_demo.ca_accuracy(tmp_path / f"{name}.pdb", truth)
        assert got == pytest.approx(want, abs=1e-3), name
    pdb_io.write_ca_pdb(tmp_path / "half.pdb", [truth[:10]])
    cov, med = synthetic_demo.ca_accuracy(tmp_path / "half.pdb", truth)
    assert 0.5 <= cov < 1.0 and med > 0.0
    (tmp_path / "empty.pdb").write_text("END\n")
    assert synthetic_demo.ca_accuracy(tmp_path / "empty.pdb", truth) == (0.0, float("inf"))
    with pytest.raises(FileNotFoundError, match="train_synth_fixture"):
        synthetic_demo.run(synthetic_demo.build_parser().parse_args(
            ["--model_path", str(tmp_path / "missing.pth"), "--out", str(tmp_path / "o")]))


def test_selection_keeps_the_weights_with_the_best_validation_dice(monkeypatch):
    """``Selection`` measures every ``every`` steps, keeps the best
    weights (the earliest on a tie, a copy on the host) and measures a
    step once."""
    model = MICA(base=16, dtype=torch.float32)
    trainer = type("T", (), {"model": model})()
    readings = iter([0.1, 0.3, 0.2, 0.3, 0.25])

    def fake_evaluate(sd, base, dtype, device, scenarios):
        return {"backbone": next(readings), "ca": 0.0}

    monkeypatch.setattr(train_synth_fixture, "evaluate", fake_evaluate)
    select = train_synth_fixture.Selection(trainer, 16, torch.float32, "cpu", [], every=2)
    param = next(iter(model.parameters()))
    for step in range(1, 9):
        with torch.no_grad():
            param.fill_(float(step))
        select(step)
        if step == 8:
            select.measure(8)  # already measured at step 8: no sixth reading
    select.measure(9)
    assert select.curve == [(2, 0.1), (4, 0.3), (6, 0.2), (8, 0.3), (9, 0.25)]
    step, dice, sd = select.best
    name = next(n for n, p in model.named_parameters() if p is param)
    assert (step, dice) == (4, 0.3)
    assert sd[name].device.type == "cpu" and torch.all(sd[name] == 4.0)
