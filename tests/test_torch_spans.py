"""The port's spans and counters (``mica_tpu_torch.utils.spans``) on the
CPU: nothing kept without a profiler, the span tree and byte counts of the
engine and the trainer under one, and the benchmark's readers of them."""

import collections
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mica_tpu_torch.infer import pipeline
from mica_tpu_torch.infer.engine import SlidingWindowPredictor, pack_af_encoding
from mica_tpu_torch.io import mrc, pdb
from mica_tpu_torch.models.mica import MICA
from mica_tpu_torch.train import data
from mica_tpu_torch.train.loss import task_lambdas
from mica_tpu_torch.train.trainer import Trainer
from mica_tpu_torch.utils import spans

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import devtrace, harness  # noqa: E402

BASE, CORE, HALO = 16, 12, 2


@pytest.fixture(autouse=True)
def _empty_recorder():
    spans.clear()
    yield
    spans.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name():
    out = collections.defaultdict(list)
    for r in spans.recorded():
        out[r.name].append(r)
    return out


def test_without_a_profiler_nothing_is_kept():
    with spans.span("outer") as outer:
        spans.count("h2d_bytes", 5)
        with spans.span("inner") as inner:
            time.sleep(0.002)
    assert spans.recorded() == []
    assert outer.seconds >= inner.seconds >= 0.002
    spans.count("h2d_bytes", 5)            # no span open: nothing to add to
    assert spans.recorded() == [] and spans.counter("h2d_bytes") == 0


def test_nested_spans_under_the_profiler():
    with _profiled() as prof:
        with spans.span("layer.outer") as outer:
            spans.count("h2d_bytes", 10)
            with spans.span("layer.inner") as inner:
                spans.count("h2d_bytes", 5)
                spans.count("h2d_bytes", 2)
                time.sleep(0.002)
            with spans.span("layer.inner"):
                pass
    got = _by_name()
    (o,), (i1, i2) = got["layer.outer"], got["layer.inner"]
    assert o.parent is None and i1.parent == i2.parent == "layer.outer"
    assert o.counters == {"h2d_bytes": 10} and i1.counters == {"h2d_bytes": 7}
    assert i2.counters == {} and spans.counter("h2d_bytes") == 17
    assert o.child_ns == (i1.end_ns - i1.start_ns) + (i2.end_ns - i2.start_ns)
    assert o.self_ns == o.end_ns - o.start_ns - o.child_ns > 0
    assert spans.self_s("layer.inner") == spans.total_s("layer.inner")
    assert spans.total_s("layer.outer") == pytest.approx(outer.seconds)
    assert (i1.end_ns - i1.start_ns) * 1e-9 == inner.seconds
    assert spans.n_spans("layer.inner") == 2
    host = {e.name for e in prof.events() if "CPU" in str(e.device_type)}
    assert {"layer.outer", "layer.inner"} <= host


def _volume():
    rng = np.random.default_rng(21)
    shape = (30, 26, 20)
    vol = np.zeros(shape, np.float32)
    vol[2:14, 3:12, 1:10] = rng.random((12, 9, 9))
    af = np.zeros((24,) + shape, np.float32)
    af[:, 4:10, 4:9, 2:8] = rng.random((24, 6, 5, 6)) < 0.05
    return vol, af


def test_engine_span_tree_counts_and_timing():
    model = MICA(base=BASE).init_weights(torch.Generator().manual_seed(3))
    pred = SlidingWindowPredictor(model, batch_size=2, dtype=torch.float32, base_filters=BASE,
                                  core=CORE, halo=HALO, device="cpu")
    vol, af = _volume()
    with torch.no_grad(), _profiled():
        out = pred.predict_volume(vol, af)
    got = _by_name()
    assert {r.parent for r in got["engine.setup"] + got["engine.inference"]
            + got["engine.reconstruction"]} == {None}
    for name, n in (("engine.pad", 2), ("engine.pack", 1), ("engine.h2d", 2),
                    ("engine.occupancy", 1)):
        assert len(got[name]) == n and {r.parent for r in got[name]} == {"engine.setup"}
    assert [r.parent for r in got["engine.d2h"]] == ["engine.reconstruction"]
    # the padded map and the packed encoding, 4 bytes a voxel each
    padded = np.prod([-(-s // CORE) * CORE + 2 * HALO for s in vol.shape])
    assert spans.counter("h2d_bytes") == 2 * 4 * padded
    assert got["engine.d2h"][0].counters["d2h_bytes"] == sum(v.nbytes for v in out.values())
    for key in ("setup", "inference", "reconstruction"):
        (r,) = got[f"engine.{key}"]
        assert pred.timing[key] == (r.end_ns - r.start_ns) * 1e-9
    setup = got["engine.setup"][0]
    assert setup.child_ns == sum(r.end_ns - r.start_ns for k in ("pad", "pack", "h2d", "occupancy")
                                 for r in got[f"engine.{k}"])


def _docked_map(tmp_path):
    """A map file and a docked CA model inside its box."""
    vol, _ = _volume()
    mrc.write_mrc(tmp_path / "m.mrc", np.transpose(vol, (2, 1, 0)), voxel_size=1.0)
    ca = np.random.default_rng(4).uniform(3.0, 12.0, (12, 3))
    pdb.write_ca_pdb(tmp_path / "docked.pdb", [ca], res_names_by_chain=[list("MKTAYIAKQRQI")])
    return str(tmp_path / "m.mrc"), str(tmp_path / "docked.pdb")


@pytest.mark.parametrize("fed", ["bits", "encoding", "predict_map"])
def test_engine_pack_counts_the_path_taken(tmp_path, fed):
    """``engine.pack`` counts ``af_prepacked`` when handed the bitfield and
    ``af_repacked`` when it checks and packs a (24, X, Y, Z) encoding."""
    model = MICA(base=BASE).init_weights(torch.Generator().manual_seed(3))
    pred = SlidingWindowPredictor(model, batch_size=2, dtype=torch.float32, base_filters=BASE,
                                  core=CORE, halo=HALO, device="cpu")
    vol, af = _volume()
    with torch.no_grad(), _profiled():
        if fed == "predict_map":
            map_path, docked = _docked_map(tmp_path)
            pipeline.predict_map(map_path, None, docked, predictor=pred)
        else:
            pred.predict_volume(vol, pack_af_encoding(af) if fed == "bits" else af)
    (pack,) = _by_name()["engine.pack"]
    want = "af_repacked" if fed == "encoding" else "af_prepacked"
    assert {k: v for k, v in pack.counters.items() if k.startswith("af_")} == {want: 1}


def test_trainer_step_records_load_and_copy():
    tr = Trainer(base_filters=BASE, dtype=torch.float32, device="cpu", seed=7,
                 use_augmentation=False)
    st = tr.init_state()
    ds = data.ArrayDataset(*data.synthetic_batch(4, 8, seed=2))
    feed = data.batch_iterator(ds, 2, shuffle=True, seed=1)
    with _profiled():
        batch = next(feed)
        tr.train_step(st, batch, task_lambdas(0), 0.0)
    got = _by_name()
    (load,), (step,), (copy,) = got["train.load"], got["train.step"], got["train.to_device"]
    assert load.parent is None and step.parent is None and copy.parent == "train.step"
    assert copy.counters["h2d_bytes"] == sum(b.nbytes for b in batch)
    assert spans.counter("h2d_bytes") == sum(b.nbytes for b in batch)


def _record(name, parent, ms, counters=None, child_ms=0):
    return spans.Record(name, parent, 0, int(ms * 1e6), int(child_ms * 1e6), counters or {})


def _run(kind, idle):
    p = devtrace.Profile(window_s=1.0, busy_s=0.5, by_name={}, idle_by_host=idle, launches={})
    return harness.Run(kind, {}, {}, None, profile=p)


PREDICT_WINDOW = [
    _record("pipeline.prepare", "pipeline.predict_map", 300,
            {"h2d_bytes": 2 ** 20, "d2h_bytes": 2 ** 21}),
    _record("pipeline.rasterize", "pipeline.predict_map", 200),
    _record("engine.pad", "engine.setup", 100),
    _record("engine.pack", "engine.setup", 500),
    _record("engine.occupancy", "engine.setup", 40),
    _record("engine.h2d", "engine.setup", 30, {"h2d_bytes": 3 * 2 ** 20}),
    _record("engine.setup", "pipeline.predict_map", 700, child_ms=670),
    _record("engine.d2h", "engine.reconstruction", 90, {"d2h_bytes": 2 ** 22}),
    _record("engine.reconstruction", "pipeline.predict_map", 100, child_ms=90),
    _record("pipeline.predict_map", None, 2000, child_ms=1300),
] * 2
TRAIN_WINDOW = [
    _record("train.load", None, 50),
    _record("train.to_device", "train.step", 40, {"h2d_bytes": 7 * 2 ** 20}),
    _record("train.step", None, 800, child_ms=40),
] * 4


@pytest.mark.parametrize("name,kind,window,idle,want", [
    ("prepare_ms", "predict", PREDICT_WINDOW, [], 300.0),
    ("rasterize_ms", "predict", PREDICT_WINDOW, [], 200.0),
    ("engine_pack_ms", "predict", PREDICT_WINDOW, [], 640.0),
    ("h2d_mib.predict", "predict", PREDICT_WINDOW, [], 4.0),
    ("d2h_mib.predict", "predict", PREDICT_WINDOW, [], 6.0),
    ("idle_host_ms.predict", "predict", PREDICT_WINDOW,
     [("engine.pack", 0.6), ("bench.predict_map", 0.2), ("aten::copy_", 0.1),
      ("pipeline.prepare", 0.2)], 400.0),
    ("h2d_mib.train", "train", TRAIN_WINDOW, [], 7.0),
    ("to_device_ms", "train", TRAIN_WINDOW, [], 40.0),
    ("idle_host_ms.train", "train", TRAIN_WINDOW,
     [("train.load", 0.1), ("bench.loader", 0.3), ("train.to_device", 0.02)], 30.0),
])
def test_span_readers(monkeypatch, name, kind, window, idle, want):
    read = harness.metric_reader(name)
    run = _run(kind, idle)
    assert read(run) is None                    # nothing recorded
    monkeypatch.setattr(spans, "_records", collections.deque(window))
    assert read(run) == pytest.approx(want)
    other = _run("train" if kind == "predict" else "predict", idle)
    assert read(other) is None                  # a cell of the other kind
