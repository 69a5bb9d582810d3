"""The trace reader on hand-made profiler events."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import counts, devtrace


def _ev(name, start, end, kind, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=f"DeviceType.{kind}", is_user_annotation=annotation)


def test_busy_union_gaps_and_names():
    events = [
        _ev(devtrace.WINDOW_MARK, 0.0, 1000.0, "CPU", True),
        _ev("bench.predict_map", 0.0, 1000.0, "CPU", True),
        _ev("bench.predict_map", 0.0, 1000.0, "CUDA", True),     # mirrored range: not work
        _ev("aten::copy_", 100.0, 400.0, "CPU"),
        _ev("conv3d_stats_kernel<256, 1>", 0.0, 100.0, "CUDA"),
        _ev("sm90_xmma_fprop", 50.0, 150.0, "CUDA"),               # overlaps the one before
        _ev("Memcpy DtoH (Device -> Pageable)", 600.0, 700.0, "CUDA"),
    ]
    p = devtrace.summarize(events, 1e-3, {"conv3d_stats": 1})
    assert p.busy_s == pytest.approx(250e-6)
    assert p.seconds(counts.is_k1) == pytest.approx(100e-6)
    assert p.seconds(counts.is_library) == pytest.approx(100e-6)
    # gaps: 150-600 (host in aten::copy_ at its middle, 375) and 700-1000
    labels = dict(p.idle_by_host)
    assert labels["aten::copy_"] == pytest.approx(450e-6)
    assert labels["bench.predict_map"] == pytest.approx(300e-6)
    b = devtrace.breakdown(p)
    assert b["device_ops"][0][0] == "conv3d_stats_kernel<256, 1>"
    assert len(b["idle_gaps"]) == 2
