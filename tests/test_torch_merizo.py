"""The port's Merizo against the JAX package's, f32 on the CPU.

Random weights from ``Merizo().init`` / ``ConfidenceHead().init`` (fixed
keys) reach the port through ``merizo_state_dict_from_jax_params``; the
trained shards are not in the repository.  Tolerances: mask and background
logits 1e-4 (absolute), confidences 1e-5; domain ids are compared where
the top two mask logits are more than 1e-4 apart, since an argmax over a
closer pair may flip between two f32 summation orders.
"""

import jax
import numpy as np
import pytest
import torch

from mica_tpu.io import pdb as jpdb
from mica_tpu.models import merizo as jmz
from mica_tpu.prep import af3_results as jaf3
from mica_tpu_torch.io import pdb as pdb_io
from mica_tpu_torch.models import merizo
from mica_tpu_torch.models.convert import merizo_state_dict_from_jax_params
from mica_tpu_torch.prep import af3_results

TOL = 1e-4


def _features(n=70, seed=0):
    """A helix-like CA walk with N and C atoms offset from each CA."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * (100.0 * np.pi / 180.0)
    ca = np.stack([2.3 * np.cos(t), 2.3 * np.sin(t), 1.5 * np.arange(n)], 1)
    ca += rng.normal(0, 0.2, ca.shape)
    n_xyz = ca + rng.normal([-1.2, 0.3, -0.5], 0.05, ca.shape)
    c_xyz = ca + rng.normal([1.2, -0.4, 0.4], 0.05, ca.shape)
    onehot = np.zeros((n, 20), np.float32)
    onehot[np.arange(n), rng.integers(0, 20, n)] = 1.0
    rot, trans = jmz.gram_schmidt_frames(n_xyz, ca, c_xyz)
    return {
        "s": onehot, "z": np.linalg.norm(ca[:, None] - ca[None], axis=-1).astype(np.float32),
        "rot": rot.astype(np.float32), "trans": trans.astype(np.float32),
        "ri": np.arange(1, n + 1, dtype=np.float32), "ca_xyz": ca,
    }


@pytest.fixture(scope="module")
def jax_params():
    f = _features(n=8)
    net = jax.jit(jmz.Merizo().init)(jax.random.PRNGKey(0), f["s"], f["z"], f["rot"],
                                     f["trans"], f["ri"])
    conf = jmz.ConfidenceHead().init(jax.random.PRNGKey(1), np.zeros((5, 20), np.float32))
    return {"merizo": net["params"], "confidence": conf["params"]}


@pytest.fixture(scope="module")
def model(jax_params):
    m = merizo.Merizo()
    m.load_state_dict(merizo_state_dict_from_jax_params(jax_params), strict=True)
    return m.eval()


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_carrier_round_trips_through_the_jax_reader(jax_params):
    """The carrier's state dict has exactly the port module's keys, and the
    JAX package's reader of the original torch names gives the flax trees
    back, leaf for leaf."""
    sd = merizo_state_dict_from_jax_params(jax_params)
    assert set(sd) == set(merizo.Merizo().state_dict())
    back = jmz.torch_state_dict_to_params({k: v.numpy() for k, v in sd.items()})
    want, got = dict(_leaves(jax_params)), dict(_leaves(back))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_forward_matches_jax(jax_params, model):
    feats = _features(n=70)
    want_m, want_bg = jmz._forward(jax_params, feats)
    got_m, got_bg = merizo._forward(model, feats)
    np.testing.assert_allclose(got_m, want_m, atol=TOL)
    np.testing.assert_allclose(got_bg, want_bg, atol=TOL)
    top2 = np.sort(want_m, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > TOL
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(np.argmax(got_m, -1)[clear], np.argmax(want_m, -1)[clear])
    assert merizo.forwards["cuda"] == 0


def test_domain_confidences_match_jax(jax_params, model):
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(40, 20)).astype(np.float32)
    dom_ids = np.array([1] * 25 + [0] * 5 + [2] * 10)
    want = jmz.domain_confidences(jax_params, rows, dom_ids)
    got = merizo.domain_confidences(model, rows, dom_ids)
    assert (got[dom_ids == 0] == 0).all()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _random_ids(rng):
    segs = []
    for _ in range(rng.integers(2, 8)):
        segs += [int(rng.integers(0, 5))] * int(rng.integers(1, 60))
    return np.array(segs, np.int64)


def test_host_helpers_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(30):
        ids = _random_ids(rng)
        np.testing.assert_array_equal(merizo._segment_lengths(ids), jmz._segment_lengths(ids))
        np.testing.assert_array_equal(merizo.clean_singletons(ids, 10),
                                      jmz.clean_singletons(ids, 10))
        np.testing.assert_array_equal(merizo.clean_domains(ids, 50), jmz.clean_domains(ids, 50))
        np.testing.assert_array_equal(merizo.remap_ids(ids), jmz.remap_ids(ids))
        ca = np.cumsum(rng.normal(0, 3.0, (len(ids), 3)), axis=0)
        np.testing.assert_array_equal(merizo.separate_components(ids, ca),
                                      jmz.separate_components(ids, ca))
        logits = rng.normal(size=(len(ids), 20)).astype(np.float32)
        bg = rng.normal(size=(len(ids), 2)).astype(np.float32)
        np.testing.assert_array_equal(merizo.postprocess_masks(logits, bg),
                                      jmz.postprocess_masks(logits, bg))
    pts = [rng.normal(size=(12, 3)) for _ in range(3)]
    for got, want in zip(merizo.gram_schmidt_frames(*pts), jmz.gram_schmidt_frames(*pts)):
        np.testing.assert_array_equal(got, want)


def _write_chain_pdb(path, n=80, seed=1, resnames=("ALA", "GLY", "LEU", "SER", "VAL")):
    """A chain-A PDB with N, CA, C and O in every residue."""
    ca_xyz = _features(n=n, seed=seed)["ca_xyz"]
    rng = np.random.default_rng(seed)
    lines, serial = [], 1
    for i in range(n):
        res = resnames[int(rng.integers(0, len(resnames)))]
        for name, ofs in (("N", [-1.2, 0.3, -0.5]), ("CA", [0, 0, 0]),
                          ("C", [1.2, -0.4, 0.4]), ("O", [2.2, -1.1, 0.2])):
            lines.append(pdb_io.format_atom_line(serial, name, res, "A", i + 1,
                                                 ca_xyz[i] + np.asarray(ofs), element=name[0]))
            serial += 1
    path.write_text("\n".join(lines) + "\nEND\n")
    return path


def test_chain_features_equal_jax(tmp_path):
    path = _write_chain_pdb(tmp_path / "chain_A.pdb", n=30, seed=2)
    got = merizo.chain_features(pdb_io.parse_pdb(path))
    want = jmz.chain_features(jpdb.parse_pdb(path))
    for k in ("s", "z", "rot", "trans", "ri", "ca_xyz"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["ca_atoms"]["res_id"], want["ca_atoms"]["res_id"])


def _write_shards(sd, wdir):
    wdir.mkdir()
    keys = list(sd)
    for i in range(3):
        torch.save({k: sd[k] for k in keys[i::3]}, wdir / f"weights_part_{i}.pt")
    return wdir


def test_shards_load_strictly(tmp_path, jax_params, model):
    """Three shards written from the carrier's state dict: the port loads
    them strictly, and the JAX reader gives the same flax trees."""
    wdir = _write_shards(merizo_state_dict_from_jax_params(jax_params), tmp_path / "w")
    loaded = merizo.load_weights(str(wdir), "cpu")
    assert merizo.load_weights(str(wdir), "cpu") is loaded
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    back = dict(_leaves(jmz.load_weights(str(wdir))))
    for k, v in _leaves(jax_params):
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_split_chain_into_domains_writes_jax_files(tmp_path, jax_params, monkeypatch):
    wdir = _write_shards(merizo_state_dict_from_jax_params(jax_params), tmp_path / "w")
    monkeypatch.setenv("MICA_MERIZO_WEIGHTS", str(wdir))
    chain = _write_chain_pdb(tmp_path / "chain_A.pdb", n=70, seed=1, resnames=("ALA",))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    before = merizo.forwards["cpu"]
    want = jaf3.split_chain_into_domains(str(chain), str(tmp_path / "jax"), min_domain_size=20)
    got = af3_results.split_chain_into_domains(str(chain), str(tmp_path / "port"),
                                               min_domain_size=20, device="cpu")
    assert merizo.forwards["cpu"] > before
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want] != []
    for g, w in zip(got, want):
        assert open(g, "rb").read() == open(w, "rb").read()


def test_network_error_raises(tmp_path, monkeypatch):
    """A shard set the network cannot load raises; the JAX package would
    answer with the geometric segmenter."""
    wdir = tmp_path / "w"
    wdir.mkdir()
    torch.save({"linear_s_in.weight": torch.zeros(512, 20)}, wdir / "weights_part_0.pt")
    monkeypatch.setenv("MICA_MERIZO_WEIGHTS", str(wdir))
    chain = _write_chain_pdb(tmp_path / "chain_A.pdb", n=60, seed=3)
    with pytest.raises(RuntimeError, match="Missing key"):
        af3_results.split_chain_into_domains(str(chain), str(tmp_path), min_domain_size=20,
                                             device="cpu")


def test_iterative_segmentation_matches_jax(jax_params, model, monkeypatch):
    """The iterative path: a chain over ``2 * DOM_AVE`` residues whose
    domains over ``DOM_AVE`` are segmented again on their own.  Random
    weights find no domain, so on both sides the same ``postprocess_masks``
    stand-in splits each forward's residues into two halves; and on both
    sides the protocol's sizes are scaled by 0.3 (``DOM_AVE`` 200 -> 60,
    ``MIN_DOMAIN_SIZE`` 50 -> 30) so that a 140-residue chain takes the
    path (the JAX package compiles each new length for seconds): its two
    70-residue halves get their own forwards, confidences and id offsets."""
    def halves(mask_logits, bg_logits):
        return (np.arange(len(mask_logits)) >= len(mask_logits) // 2).astype(np.int64) + 1

    for mod in (jmz, merizo):
        monkeypatch.setattr(mod, "postprocess_masks", halves)
        monkeypatch.setattr(mod, "DOM_AVE", 60)
        monkeypatch.setattr(mod, "MIN_DOMAIN_SIZE", 30)
    feats = _features(n=140, seed=3)
    before = merizo.forwards["cpu"]
    want_ids, want_conf = jmz.segment(jax_params, feats, iterate=True, max_iterations=1)
    got_ids, got_conf = merizo.segment(model, feats, iterate=True, max_iterations=1)
    assert merizo.forwards["cpu"] - before == 3
    np.testing.assert_array_equal(got_ids, want_ids)
    assert len(np.unique(got_ids)) == 4
    np.testing.assert_allclose(got_conf, want_conf, atol=1e-5)
