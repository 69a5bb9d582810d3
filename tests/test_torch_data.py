"""Training windows from a (map, model) pair: the port's
``build_training_grids`` and ``cli.makedata`` against the JAX package's, on
the CPU.

The map and model are those of ``tests/test_data_gen.py`` (a 60 x 56 x 52
map with density at a 20-residue chain's CAs).  The density windows agree
to 1e-6 (the port prepares the map in torch), the masks, the AF3 windows
and the set of kept windows are equal.  ``cli.makedata`` in both pair
modes writes packed ``.npz`` files that ``ArrayDataset.load`` reads back
equal to the function's windows.
"""

import numpy as np
import pytest

from mica_tpu.train import data as jdata
from mica_tpu_torch.cli import makedata
from mica_tpu_torch.io import mrc as mrc_io
from mica_tpu_torch.io import pdb as pdb_io
from mica_tpu_torch.train import data
from mica_tpu_torch.utils.synthetic import make_chain


def _inputs(tmp_path, n_res=20, shape=(60, 56, 52)):
    ca = make_chain(n_res, shape, seed=1)
    seq = "MKTAYIAKQRQISFVKSHFS"[:n_res]
    density = np.zeros(shape, np.float32)
    idx = np.rint(ca).astype(int)
    density[idx[:, 0], idx[:, 1], idx[:, 2]] = 5.0
    # (sections=z, rows=y, cols=x) on disk
    mrc_io.write_mrc(tmp_path / "map.mrc", np.transpose(density, (2, 1, 0)), voxel_size=1.0)
    pdb_io.write_ca_pdb(tmp_path / "model.pdb", [ca], res_names_by_chain=[list(seq)])
    # a docked model: the chain moved by 2 A, with its own residue types
    pdb_io.write_ca_pdb(tmp_path / "docked.pdb", [ca + 2.0],
                        res_names_by_chain=[list(seq[::-1])])
    return tmp_path / "map.mrc", tmp_path / "model.pdb", tmp_path / "docked.pdb"


def _assert_equal_sets(got, want, density_atol=1e-6):
    assert len(got) == len(want) and len(got) >= 1
    np.testing.assert_allclose(got.density, want.density, rtol=0, atol=density_atol)
    assert got.af3.dtype == want.af3.dtype == np.uint8
    for f in ("af3", "bb", "ca", "aa"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("docked", [False, True])
def test_build_training_grids_matches_jax(tmp_path, docked):
    map_path, model, dock = _inputs(tmp_path)
    dock = str(dock) if docked else None
    got = data.build_training_grids(str(map_path), str(model), dock, device="cpu")
    want = jdata.build_training_grids(str(map_path), str(model), dock)
    _assert_equal_sets(got, want)
    assert got.density.dtype == np.float32 and got.bb.dtype == np.int32
    assert got.density.shape[1:] == (64, 64, 64) and got.af3.shape[1:] == (24, 64, 64, 64)
    assert (got.density.reshape(len(got), -1).max(axis=1) >= 0.01).all()
    assert (got.ca == 3).sum() > 0 and got.af3[:, 0].sum() > 0


def test_build_training_grids_drops_empty_windows(tmp_path):
    """A threshold above the map's maximum keeps no window; one of 0 keeps
    every window of the lattice."""
    map_path, model, _ = _inputs(tmp_path)
    none = data.build_training_grids(str(map_path), str(model), density_threshold=1.5,
                                     device="cpu")
    every = data.build_training_grids(str(map_path), str(model), density_threshold=0.0,
                                      device="cpu")
    assert len(none) == 0 and none.af3.shape[1:] == (24, 64, 64, 64)
    assert len(every) == 2 * 2 * 2


@pytest.mark.parametrize("mode", ["pairs", "single"])
def test_makedata_writes_packed_npz(tmp_path, mode):
    map_path, model, dock = _inputs(tmp_path)
    out = tmp_path / "packed"
    if mode == "pairs":
        csv = tmp_path / "pairs.csv"
        csv.write_text(f"# map,model,docked\n{map_path},{model},{dock}\n")
        argv = ["--pairs", str(csv)]
        want = data.build_training_grids(str(map_path), str(model), str(dock), device="cpu")
    else:
        argv = ["--map", str(map_path), "--model", str(model)]
        want = data.build_training_grids(str(map_path), str(model), device="cpu")
    assert makedata.main(argv + ["--output", str(out), "--device", "cpu"]) == 0
    got = data.ArrayDataset.load(str(out / "map.npz"))
    _assert_equal_sets(got, want, density_atol=0)


def test_makedata_skips_an_unreadable_pair_and_says_so(tmp_path):
    map_path, model, _ = _inputs(tmp_path)
    csv = tmp_path / "pairs.csv"
    csv.write_text(f"{tmp_path / 'missing.mrc'},{model}\n{map_path},{model}\n")
    out = tmp_path / "packed"
    assert makedata.main(["--pairs", str(csv), "--output", str(out), "--device", "cpu"]) == 1
    assert sorted(p.name for p in out.iterdir()) == ["map.npz"]
    assert makedata.main(["--output", str(out), "--device", "cpu"]) == 1
    assert makedata.build_parser().parse_args(["--output", "o"]).device == "cuda"
