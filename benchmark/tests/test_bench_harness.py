"""The harness driven on the CPU at small sizes, past its look for a chip:
a cell is found by its file alone; a sound run is correct; a run whose timed
path is broken underneath, or whose program is the lower-precision control,
is not."""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import harness

from .conftest import SMALL, SMALL_CFG

SEED = 2_718_281_828_459


def _run(workload, tmp_path, traffic=None):
    ov = {"config": SMALL_CFG, "traffic": traffic or SMALL[workload]}
    return harness.run_cell(workload, SEED, 0.1, False, "cpu", tmp_path, overrides=ov)


def test_a_dropped_workload_file_is_found(tmp_path):
    name = f"dropped-test-cell-{os.getpid()}"
    path = harness.BENCH / "workloads" / f"{name}.json"
    path.write_text(json.dumps({"config": "mica-mapfree", "traffic": "maps-masked",
                                "limits": harness.load("workloads", "predict-masked-mapfree")
                                ["limits"]}))
    try:
        w, cfg, tr = harness.cell(name)
        assert cfg["protocol"] == "AF3_struct_free" and tr["driver"] == "predict"
        result, info = _run(name, tmp_path, SMALL["predict-masked-mapfree"])
    finally:
        path.unlink()
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s"}      # not named in BENCHMARK.json
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload, tmp_path):
    result, info = _run(workload, tmp_path)
    assert result["correct"], info
    assert set(result["checks"]) == set(harness.load("workloads", workload)["limits"])
    e2e = {m["name"] for m in harness.metric_specs(workload, False)}
    assert set(result["metrics"]) == e2e - {"peak_mem_gib"}   # no card, no allocator peak


def _swap_aa(monkeypatch):
    from mica_tpu_torch.infer import engine

    post = engine.postprocess_logits

    def altered(bb, ca, aa):
        b, c, a = post(bb, ca, aa)
        return b, c, a[..., [1, 0] + list(range(2, a.shape[-1]))]

    monkeypatch.setattr(engine, "postprocess_logits", altered)


def _frozen(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from mica_tpu_torch.train.trainer import Trainer

    to_device = Trainer._to_device
    monkeypatch.setattr(Trainer, "_to_device",
                        lambda self, batch: to_device(self, [b[:len(b) // 2] for b in batch]))


@pytest.mark.parametrize("workload,fault", [
    ("predict-dense-af3", _swap_aa), ("predict-masked-mapfree", _swap_aa),
    ("train-b8-af3", _frozen), ("train-b8-af3", _half_batch)])
def test_broken_timed_path_is_not_correct(workload, fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    result, info = _run(workload, tmp_path)
    assert not result["correct"], info


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_fp8_control_is_not_correct(workload, tmp_path):
    w, cfg, tr = harness.cell(workload)
    drv = harness.driver_class(tr["driver"])({**cfg, **SMALL_CFG}, {**tr, **SMALL[workload]},
                                             SEED, torch.device("cpu"), tmp_path)
    numbers = drv.control("fp8")
    assert any(numbers[k] > lim for k, lim in w["limits"].items()), numbers


def test_card_run_of_a_cell(tmp_path):
    """On the card: one short run of the masked cell through ``run.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import subprocess
    import sys

    out = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload",
                          "predict-masked-mapfree", "--seed", str(SEED), "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True, timeout=900,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


test_card_run_of_a_cell = pytest.mark.cuda(test_card_run_of_a_cell)
