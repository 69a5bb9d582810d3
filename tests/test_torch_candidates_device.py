"""The port's device candidate extraction against the JAX one and against
the host pipeline, on the CPU.

The contract of ``tests/test_candidates_device.py``: candidate order,
``pred`` exactly, ``coords`` and ``aa`` to 1e-12 (the float64 centroid runs
on the host over gathered f32 values), and ``None`` in the same cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mica_tpu.trace import candidates_device as jdev
from mica_tpu_torch.trace import candidates_device as cdev
from mica_tpu_torch.trace.candidates import build_neighbor_structure, extract_candidates
from mica_tpu_torch.utils.synthetic import make_scenario

KEYS = ("carbon_alpha_probability", "backbone_probability", "amino_acid_probability")


@pytest.fixture(scope="module")
def scenario():
    return make_scenario(n_res=40, shape=(48, 48, 48), seed=7)


def _host(vols, **kw):
    return extract_candidates(*(vols[k] for k in KEYS), vols["amino_acid_prediction"],
                              cluster_method="morphology", **kw)


def _port(vols, **kw):
    return cdev.extract_candidates_device(*(torch.from_numpy(vols[k]) for k in KEYS), **kw)


def _jax(vols, **kw):
    return jdev.extract_candidates_device(*(jnp.asarray(vols[k]) for k in KEYS), **kw)


@pytest.mark.parametrize("thr", [0.3, 0.5])
def test_port_matches_jax_and_host(scenario, thr):
    _, _, vols = scenario
    host = _host(vols, ca_score_threshold=thr)
    want = _jax(vols, ca_score_threshold=thr)
    stats = {}
    got = _port(vols, ca_score_threshold=thr, stats=stats)
    assert set(got) == set(want) == {"coords", "aa", "pred"}
    assert len(got["coords"]) == len(host.coords) == len(want["coords"]) > 0
    # candidate ORDER must match too (NMS pick order drives downstream ids)
    np.testing.assert_array_equal(got["pred"], host.aa_pred)
    np.testing.assert_array_equal(got["pred"], want["pred"])
    for ref_c, ref_a in ((host.coords, host.aa_prob), (want["coords"], want["aa"])):
        np.testing.assert_allclose(got["coords"], ref_c, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got["aa"], ref_a, rtol=0, atol=1e-12)
    assert got["coords"].dtype == np.float64
    assert stats["n_candidates"] == len(got["coords"]) and stats["nms_rounds"] >= 1


def test_candidates_structure_with_the_backbone_volume_as_a_tensor(scenario):
    _, _, vols = scenario
    host = _host(vols)
    dev = _port(vols)
    cands = build_neighbor_structure(dev["coords"], dev["aa"], dev["pred"],
                                     torch.from_numpy(vols["backbone_probability"]))
    assert len(cands) == len(host)
    for a, b in zip(cands.neighbors2to6, host.neighbors2to6):
        np.testing.assert_array_equal(a, b)
    assert cands.best_neigh == host.best_neigh
    np.testing.assert_array_equal(cands.neigh_mat.todense(), host.neigh_mat.todense())


def test_none_in_the_reference_cases(scenario, monkeypatch):
    _, _, vols = scenario
    assert _port(vols, nms_radius_sq=16.0) is None and _jax(vols, nms_radius_sq=16.0) is None
    with monkeypatch.context() as mp:
        mp.setattr(cdev, "POINT_CAPS", (4,))
        mp.setattr(jdev, "POINT_CAPS", (4,))
        assert _port(vols) is None and _jax(vols) is None
    with monkeypatch.context() as mp:
        mp.setattr(cdev, "NMS_CAPS", (2, 8))
        mp.setattr(jdev, "NMS_CAPS", (2, 8))
        assert _port(vols) is None and _jax(vols) is None
    # a first cap too small is no overflow while a later one holds the map
    monkeypatch.setattr(cdev, "NMS_CAPS", (2, 2048))
    np.testing.assert_allclose(_port(vols)["coords"], _host(vols).coords, atol=1e-12)


def test_empty_volume():
    vols = {"carbon_alpha_probability": np.zeros((24, 24, 24), np.float32),
            "backbone_probability": np.zeros((24, 24, 24), np.float32),
            "amino_acid_probability": np.zeros((20, 24, 24, 24), np.float32)}
    dev = _port(vols)
    assert dev is not None and len(dev["coords"]) == 0
    assert dev["aa"].shape == (20, 0) and dev["pred"].shape == (0,)


def test_ties_and_boundary_candidates_follow_the_host(rng):
    """Equal scores (plateaus) rank by ascending flat index and candidates
    on the volume's faces are dropped, as on the host."""
    shape = (20, 22, 24)
    ca = np.zeros(shape, np.float32)
    pts = rng.integers(0, [20, 22, 24], size=(150, 3))
    ca[pts[:, 0], pts[:, 1], pts[:, 2]] = rng.choice([0.5, 0.75, 0.875], size=150)
    ca[0, 5, 5] = ca[19, 21, 23] = 0.9375
    vols = {"carbon_alpha_probability": ca,
            "backbone_probability": np.full(shape, 0.5, np.float32),
            "amino_acid_probability": rng.random((20,) + shape).astype(np.float32)}
    vols["amino_acid_prediction"] = vols["amino_acid_probability"].argmax(0)
    host = _host(vols)
    got = _port(vols)
    assert len(got["coords"]) == len(host.coords) > 10
    np.testing.assert_array_equal(got["pred"], host.aa_pred)
    np.testing.assert_allclose(got["coords"], host.coords, rtol=0, atol=1e-12)
