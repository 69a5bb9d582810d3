"""The port's multi-process paths on the CPU that need no JAX reference:
a process without a group (world size 1, no collective), ``cli.train`` at
world size 2, ``dryrun_multigpu`` and a failing rank.  Ranks are
processes that ``parallel.dryrun.spawn`` starts on gloo, as in
``tests/test_torch_parallel.py`` (the references computed with JAX are
there); what they run is in ``tests/torch_parallel_ranks.py``.

This process runs its torch ops on one thread while the file runs, and
the ranks get ``OMP_NUM_THREADS`` 2: under a loaded suite (several test
workers on the host's cores) a pool of one thread a core waits for
descheduled threads at every parallel region, and these tests ran 12-58x
slower there than alone.
"""

import functools
import time

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from mica_tpu_torch.cli import makedata
from mica_tpu_torch.cli import predict as cli_predict
from mica_tpu_torch.infer.engine import SlidingWindowPredictor
from mica_tpu_torch.io import mrc as mrc_io
from mica_tpu_torch.io import pdb as pdb_io
from mica_tpu_torch.models.mica import MICA, dropout_rate_for_epoch
from mica_tpu_torch.ops import window
from mica_tpu_torch.parallel import distributed, dryrun
from mica_tpu_torch.parallel.mesh import make_mesh
from mica_tpu_torch.train import data
from mica_tpu_torch.train.loss import task_lambdas
from mica_tpu_torch.utils.synthetic import make_chain

BASE, CORE, HALO = ranks.BASE, ranks.CORE, ranks.HALO
WORLD = 2
SPAWN = ranks.SPAWN


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_one_process_is_a_world_of_one_and_exchanges_nothing(monkeypatch):
    """Without a process group ``use_mesh`` gives world size 1, and the
    engine (both modes) and a trainer step call no collective and give
    the meshless results."""
    def refuse(*a, **k):
        raise AssertionError("a collective ran without a process group")

    for name in ("all_reduce_sum_", "exchange_rows", "broadcast_"):
        monkeypatch.setattr(distributed, name, refuse)
    m = make_mesh("cpu")
    assert (m.rank, m.size, m.distributed, m.is_main) == (0, 1, False, True)
    vol = ranks.volumes()
    model = MICA(base=BASE, dtype=torch.float32).init_weights(torch.Generator().manual_seed(1))
    kw = dict(batch_size=3, dtype=torch.float32, base_filters=BASE, core=CORE, halo=HALO,
              device="cpu")
    want = SlidingWindowPredictor(model, **kw).predict_volume(vol["a_vol"], vol["a_af"])
    for sv in (False, True):
        pred = SlidingWindowPredictor(model, use_mesh=True, shard_volumes=sv, **kw)
        assert pred.mesh == m and pred.batch_size == 3
        got = pred.predict_volume(vol["a_vol"], vol["a_af"])
        for k in ranks.VOLUME_KEYS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=(sv, k))
    from mica_tpu_torch.train.trainer import Trainer

    t = Trainer(base_filters=BASE, dtype=torch.float32, device="cpu")
    assert t.mesh == m and t.is_main
    state = t.init_state()
    met = t.train_step(state, ranks.batch(n=3, d=8), task_lambdas(0), dropout_rate_for_epoch(0))
    assert np.isfinite(float(met["total_loss"]))


# ---------------------------------------------------------------------------
# cli.train, the dry run, a failing rank
# ---------------------------------------------------------------------------


def _makedata_set(tmp_path, monkeypatch):
    """A tiny ``cli.makedata`` set: 16^3 windows (core 8, halo 4) of a
    synthetic chain's map; a 64^3 window trains in ~15 s on the CPU."""
    shape = (32, 32, 24)
    ca = make_chain(16, shape, seed=3)
    density = np.zeros(shape, np.float32)
    idx = np.rint(ca).astype(int)
    density[idx[:, 0], idx[:, 1], idx[:, 2]] = 5.0
    mrc_io.write_mrc(tmp_path / "map.mrc", np.transpose(density, (2, 1, 0)), voxel_size=1.0)
    pdb_io.write_ca_pdb(tmp_path / "model.pdb", [ca], res_names_by_chain=[list("ACDEFGHIKLMNPQRS")])
    monkeypatch.setattr(data, "extract_windows",
                        functools.partial(window.extract_windows, core=8, halo=4))
    assert makedata.main(["--map", str(tmp_path / "map.mrc"), "--model",
                          str(tmp_path / "model.pdb"), "--output", str(tmp_path / "packed"),
                          "--device", "cpu"]) == 0
    (packed,) = (tmp_path / "packed").glob("*.npz")
    packed.rename(tmp_path / "packed.npz")
    return len(data.ArrayDataset.load(str(tmp_path / "packed.npz")))


def test_cli_train_world2_saves_on_rank0_only(tmp_path, monkeypatch):
    n = _makedata_set(tmp_path, monkeypatch)
    assert n >= 6
    results = dryrun.spawn("torch_parallel_ranks:cli_train", WORLD,
                           {"workdir": str(tmp_path)}, **SPAWN)
    assert [r["rc"] for r in results] == [0, 0]
    assert results[1]["files"] == [] and not (tmp_path / "logs_1").exists()
    (pt,) = results[0]["files"]
    assert pt.startswith("mica_epoch_0") and pt.endswith(".pt")
    vol = np.random.default_rng(0).random((16, 16, 16)).astype(np.float32)
    mrc_io.write_mrc(tmp_path / "m.mrc", vol, voxel_size=1.0)
    assert cli_predict.main(["-m", str(tmp_path / "m.mrc"), "-o", str(tmp_path / "pred"),
                             "--model_checkpoint", str(tmp_path / "out_0" / pt),
                             "--base_filters", str(BASE), "--window_core", "8",
                             "--batch_size", "4", "--float32", "--device", "cpu"]) == 0
    assert (tmp_path / "pred" / "backbone_probability.mrc").exists()


def test_dryrun_multigpu_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    results = dryrun.dryrun_multigpu(WORLD, device="cpu", timeout=240.0)
    assert len(results) == WORLD and all(r["shard_err"] <= 1e-4 for r in results)
    assert "dryrun_multigpu(2): train loss" in capsys.readouterr().out


def test_a_failing_rank_stops_its_peers():
    """Rank 1 raises while rank 0 waits in a collective: the run raises
    with rank 1's error at once, not at the group's timeout."""
    t0 = time.time()
    with pytest.raises(RuntimeError, match=r"(?s)exited.*rank 1 fails on purpose"):
        dryrun.spawn("torch_parallel_ranks:fail_on_rank_1", WORLD, **SPAWN)
    assert time.time() - t0 < 60
