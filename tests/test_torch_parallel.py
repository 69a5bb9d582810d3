"""The port's data-parallel paths (``mica_tpu_torch/parallel``, the
engine's replicated and ``shard_volumes`` modes, the data-parallel
``Trainer``) on the CPU, against the JAX package's mesh paths.
``cli.train`` under a group, the dry run, a process without a group and a
failing rank are in ``tests/test_torch_parallel_procs.py``.

Ranks are processes that ``parallel.dryrun.spawn`` starts on gloo with a
``file://`` rendezvous in a temporary directory, a process-group timeout
of 120 s and a deadline of 240 s; what they run is in
``tests/torch_parallel_ranks.py``.  Most checks share one spawn at world
size 2 (module fixture ``world2``); this process computes the references:
the JAX package on its virtual 8-device mesh, and the port in one process.

Tolerances:
  * engines against the JAX mesh engines: atol 1e-4 on the probabilities
    (f32 convs summed in another order, as ``tests/test_torch_engine.py``);
    ranks against each other and ``shard_volumes`` against replicated:
    bitwise (every rank pastes the same exchanged outputs);
  * world 2 against world 1, f32, augmentation, AF3 blanking and dropout
    on: loss within 1e-6 relative, gradient cosine > 0.99999 (the reduced
    gradient sums two partials), parameters after the step bitwise equal
    across the ranks;
  * world 2 against the JAX loss and gradient on a 2-device mesh:
    ``tests/test_torch_train.py``'s tolerances for one process (loss rtol
    1e-4; per tensor cosine > 0.999, relative L2 < 1e-2, or 5e-2 below
    0.1 of the largest norm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from mica_tpu.infer import engine as jengine
from mica_tpu.models.init import init_params_fast
from mica_tpu.models.mica import MICA as JaxMICA
from mica_tpu.parallel import distributed as jdist
from mica_tpu.parallel import mesh as jmesh
from mica_tpu.train import loss as jloss
from mica_tpu_torch.infer.engine import SlidingWindowPredictor
from mica_tpu_torch.models.convert import state_dict_from_jax_params
from mica_tpu_torch.models.mica import MICA, Dropout
from mica_tpu_torch.parallel import dryrun
from mica_tpu_torch.parallel.mesh import Mesh, make_mesh, pad_to_multiple
from mica_tpu_torch.train import augment, data
from mica_tpu_torch.train.loss import task_lambdas

BASE, CORE, HALO = ranks.BASE, ranks.CORE, ranks.HALO
WORLD = 2
SPAWN = ranks.SPAWN
PROB_KEYS = ranks.VOLUME_KEYS[:3]
# train runs at world 2: (tag, seed, augmentation, AF3 blanking, dropout)
AUG = dict(tag="aug", seed=3, augment=True, blank=0.5, rate=0.1)
PLAIN = dict(tag="plain", seed=3, augment=False, blank=0.0, rate=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's torch ops on one thread while the file runs.  Under
    a loaded suite (several test workers on the host's cores) a pool of
    one thread a core waits for descheduled threads at every parallel
    region: the file ran 12-58x slower there than alone.  The ranks get
    ``OMP_NUM_THREADS`` 2 (``SPAWN``)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def jax_params():
    return init_params_fast(JaxMICA(base=BASE),
                            (jnp.zeros((1, 8, 8, 8, 1)), jnp.zeros((1, 8, 8, 8, 24))), seed=5)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, jax_params):
    wd = tmp_path_factory.mktemp("world2")
    torch.save(state_dict_from_jax_params(jax_params), wd / "params.pt")
    np.savez(wd / "volumes.npz", **ranks.volumes())
    np.savez(wd / "batch.npz", **dict(zip(("d", "af", "bb", "ca", "aa"), ranks.batch())))
    return wd


@pytest.fixture(scope="module")
def world2(workdir):
    results = dryrun.spawn("torch_parallel_ranks:world2", WORLD,
                           {"workdir": str(workdir), "train_runs": [AUG, PLAIN]}, **SPAWN)
    assert [r["collectives"]["rank"] for r in results] == list(range(WORLD))
    arrays = [dict(np.load(workdir / f"engine_{r}.npz")) for r in range(WORLD)]
    steps = {run["tag"]: [dict(np.load(workdir / f"{run['tag']}_{r}.npz"))
                          for r in range(WORLD)] for run in (AUG, PLAIN)}
    return results, arrays, steps


# ---------------------------------------------------------------------------
# mesh, distributed
# ---------------------------------------------------------------------------


def test_world_and_batch_slices_match_jax(world2, monkeypatch):
    results, _, _ = world2
    for r, res in enumerate(results):
        c = res["collectives"]
        assert (c["size"], c["local_rank"], c["distributed"], c["multiprocess"]) == (
            WORLD, r, True, True)
        monkeypatch.setattr(jax, "process_count", lambda backend=None: WORLD)
        monkeypatch.setattr(jax, "process_index", lambda backend=None, r=r: r)
        for g, (start, stop) in c["slices"].items():
            want = jdist.local_batch_slice(int(g))
            assert (start, stop) == (want.start, want.stop), (r, g)
        for n, (lo, hi) in c["rows"].items():
            per = -(-int(n) // WORLD)
            assert (lo, hi) == (min(r * per, int(n)), min(r * per + per, int(n)))


def test_pad_to_multiple_matches_jax():
    for n in range(0, 20):
        for m in (1, 2, 3, 8):
            assert pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)


def test_collectives_give_the_sums_rows_and_broadcast(world2):
    results, _, _ = world2
    a = np.arange(6.0).reshape(2, 3)
    for res in results:
        c = res["collectives"]
        np.testing.assert_array_equal(c["all_reduce"][0], a * 1 + a * 2)
        np.testing.assert_array_equal(c["all_reduce"][1], np.full(4, 0.0 + 1.0))
        np.testing.assert_array_equal(
            c["exchange"][0], np.arange(5)[:, None] * 10.0 + np.arange(2))
        np.testing.assert_array_equal(np.asarray(c["exchange"][1])[:, 0, 0], [0, 0, 0, 1, 1])
        np.testing.assert_array_equal(c["broadcast"][0], np.full(3, 8.0))
        np.testing.assert_array_equal(c["broadcast"][1], np.full((2, 2), -1.0))


def test_initialize_is_idempotent_and_the_card_still_refused(world2):
    results, _, _ = world2
    for res in results:
        c = res["collectives"]
        assert c["idempotent"] and c["mesh_again"]
        assert c["card_refused"] == (not torch.cuda.is_available())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_engine(jax_params):
    """JAX's replicated and shard_volumes engines on the 8-device mesh."""
    v = ranks.volumes()
    kw = dict(batch_size=8, dtype=jnp.float32, base_filters=BASE, core=CORE, halo=HALO,
              mesh=jmesh.make_mesh())
    out = {}
    for mode, sv in (("rep", False), ("sv", True)):
        out[mode] = jengine.SlidingWindowPredictor(jax_params, shard_volumes=sv,
                                                   **kw).predict_volume(v["a_vol"], v["a_af"])
    return out


@pytest.mark.parametrize("mode", ["rep", "sv"])
def test_engine_matches_the_jax_mesh_engine(world2, jax_engine, mode):
    """Volume a has 3 X cores, which do not divide the world of 2: the
    sharded mode pads them to 4 (JAX's to 8)."""
    _, arrays, _ = world2
    for k in PROB_KEYS:
        got, want = arrays[0][f"a_{mode}_{k}"], np.asarray(jax_engine[mode][k])
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=k)


def test_ranks_and_modes_return_the_same_volumes(world2):
    _, arrays, _ = world2
    for name in ("a", "b"):
        for k in ranks.VOLUME_KEYS:
            ref = arrays[0][f"{name}_rep_{k}"]
            for r in range(WORLD):
                for mode in ("rep", "sv"):
                    np.testing.assert_array_equal(arrays[r][f"{name}_{mode}_{k}"], ref,
                                                  err_msg=(name, k, r, mode))


def test_shard_volumes_holds_a_slab_a_rank(world2):
    """Per-rank accumulator bytes: the slab's share of the replicated
    volumes, half at 4 X cores, 2 of 3 cores' planes at 3; the slabs
    ``keep_on_device`` returns are the rank's rows of the full volumes."""
    results, _, _ = world2
    for r, res in enumerate(results):
        e = res["engine"]
        assert e["b_sv_acc_bytes"] * 2 == e["b_rep_acc_bytes"]
        assert e["a_sv_acc_bytes"] * 3 == e["a_rep_acc_bytes"] * 2
        assert e["a_slab"] == [[0, 24], [24, 2]][r]
        assert e["b_slab"] == [[0, 24], [24, 24]][r]
        for name in ("a", "b"):
            assert e[f"{name}_slab_err"] == 0.0 and e[f"{name}_slab_aa_ok"]


def test_each_rank_forwards_its_share(world2):
    """a: 18 nonempty windows in batches of 8, 8, 2 -> 4, 4, 1 windows a
    rank, 3 forwards each, plus the all-zero window's."""
    results, _, _ = world2
    for res in results:
        assert res["engine"]["a_rep_forwards"] == 3 + 1


def test_engine_refuses_what_jax_refuses():
    model = MICA(base=BASE, dtype=torch.float32)
    kw = dict(base_filters=BASE, core=CORE, halo=HALO, device="cpu")
    with pytest.raises(ValueError, match="shard_volumes requires a mesh"):
        SlidingWindowPredictor(model, shard_volumes=True, **kw)
    with pytest.raises(ValueError, match="shard_volumes requires a mesh"):
        SlidingWindowPredictor(model, shard_volumes=True, blend="average",
                               mesh=make_mesh("cpu"), **kw)
    pred = SlidingWindowPredictor(model, shard_volumes=True, mesh=make_mesh("cpu"), **kw)
    with pytest.raises(ValueError, match="reference-layout dumps"):
        pred.predict_volume(np.zeros((8, 8, 8), np.float32), dump_windows_dir="unused",
                            dump_format="reference")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _world1(workdir, run):
    """The same step in this process, without a process group."""
    sd = torch.load(workdir / "params.pt", weights_only=True)
    trainer, state = ranks._trainer(run["seed"], run["augment"], run["blank"], sd)
    assert not trainer.mesh.distributed
    batch = ranks.batch()
    val = trainer.run_validation(state, [batch, tuple(b[:3] for b in batch)], 3)
    met = trainer.train_step(state, batch, task_lambdas(3), run["rate"])
    return (float(met["total_loss"]), ranks._flat_grads(trainer.model),
            ranks._flat_params(trainer.model), val)


def test_augmentation_runs_in_both_ranks_rows():
    """The AUG run's first draws put augmented samples in both ranks' rows
    (the generator the trainer seeds with ``AUG['seed']``)."""
    u = torch.rand((4, augment.N_DRAWS), generator=torch.Generator().manual_seed(AUG["seed"]))
    gate = (u[:, augment.GATE] < augment.AUGMENT_PROB).tolist()
    assert any(gate[:2]) and any(gate[2:])


def test_world2_step_equals_world1(world2, workdir):
    results, _, steps = world2
    loss1, grad1, params1, _ = _world1(workdir, AUG)
    for r, res in enumerate(results):
        loss2 = res["train"][0]["loss"]
        assert abs(loss2 - loss1) <= 1e-6 * abs(loss1), (loss2, loss1)
        g = steps["aug"][r]["grads"]
        cos = float(g @ grad1 / (np.linalg.norm(g) * np.linalg.norm(grad1)))
        assert cos > 0.99999, cos
    np.testing.assert_array_equal(steps["aug"][0]["params"], steps["aug"][1]["params"])
    np.testing.assert_array_equal(steps["aug"][0]["grads"], steps["aug"][1]["grads"])


def test_world2_step_matches_the_jax_loss_and_gradient_on_a_mesh(world2, jax_params):
    """JAX's trainer loss (model + ``multi_task_loss``) and its gradient
    with the batch sharded over a 2-device mesh, as its train step takes
    them, against the PLAIN run's reduced gradient."""
    results, _, steps = world2
    dens, af3, *tgt = ranks.batch()
    jm = jmesh.make_mesh(jax.devices()[:WORLD])
    shard, repl = NamedSharding(jm, P(jmesh.DATA_AXIS)), NamedSharding(jm, P())
    lam = jnp.asarray(task_lambdas(3), jnp.float32)

    def loss_j(p, x, af, t0, t1, t2):
        outs = JaxMICA(base=BASE).apply({"params": p}, x, af, dropout_rate=0.0, train=True,
                                        rngs={"dropout": jax.random.PRNGKey(0)})
        return jloss.multi_task_loss(outs, (t0, t1, t2), lam)[0]

    fn = jax.jit(jax.value_and_grad(loss_j), in_shardings=(repl,) + (shard,) * 5)
    l_ref, g_ref = fn(jax_params, jnp.asarray(dens[..., None]),
                      jnp.asarray(np.moveaxis(af3, 1, -1)), *map(jnp.asarray, tgt))
    ref = {k: v.numpy().astype(np.float64)
           for k, v in state_dict_from_jax_params(g_ref).items()}
    assert results[0]["train"][1]["loss"] == pytest.approx(float(l_ref), rel=1e-4)
    names = [k for k, _ in MICA(base=BASE).named_parameters()]
    sizes = [p.numel() for _, p in MICA(base=BASE).named_parameters()]
    got = dict(zip(names, np.split(steps["plain"][0]["grads"], np.cumsum(sizes)[:-1])))
    gmax = max(np.linalg.norm(v) for v in ref.values())
    for k, r in ref.items():
        a, nr = got[k], np.linalg.norm(r)
        if nr < 1e-4 * gmax:
            assert np.linalg.norm(a) < 1e-3 * gmax, k
            continue
        cos = float(a @ r.ravel() / (np.linalg.norm(a) * nr))
        rel = float(np.linalg.norm(a - r.ravel()) / nr)
        assert cos > 0.999 and rel < (1e-2 if nr >= 0.1 * gmax else 5e-2), (k, cos, rel)


def test_a_batch_that_does_not_divide_the_world_raises(world2):
    results, _, _ = world2
    for res in results:
        msg = res["train"][0]["uneven_error"]
        assert "batch size 3 is not divisible by the 2-rank world" in msg


def test_validation_reduces_to_the_world1_metrics(world2, workdir):
    """A 4-row batch split over the ranks and a 3-row one evaluated whole
    on each (before the step, at equal weights): every rank reports world
    1's means."""
    results, _, _ = world2
    *_, val1 = _world1(workdir, PLAIN)
    for res in results:
        val2 = res["train"][1]["validation"]
        for k, v in val1.items():
            assert val2[k] == pytest.approx(v, rel=1e-6), k


def test_dropout_rows_are_the_whole_batch_masks_rows():
    x = torch.ones(4, 3, 3, 3, 16)
    whole = Dropout(9).channels(x, 0.5)
    parts = [Dropout(9, rows=(i, 4)).channels(x[i:i + 2], 0.5) for i in (0, 2)]
    assert torch.equal(torch.cat(parts), whole)
    assert not torch.equal(parts[0], parts[1])
    y = torch.ones(4, 7)
    assert torch.equal(Dropout(2, rows=(2, 4)).elements(y[2:], 0.5),
                       Dropout(2).elements(y, 0.5)[2:])


def test_augment_rows_are_the_whole_batch_augmentation():
    dens, af3, *tgt = ranks.batch(n=6, d=8, seed=4)
    d = torch.from_numpy(dens)[:, None]
    a = torch.from_numpy(af3)
    t = torch.from_numpy(np.stack(tgt, axis=1))
    g = torch.Generator().manual_seed(7)
    whole = augment.augment_batch(g, d, a, t)
    after = torch.rand(3, generator=g)
    for first in (0, 2, 4):
        gr = torch.Generator().manual_seed(7)
        part = augment.augment_batch(gr, d[first:first + 2], a[first:first + 2],
                                     t[first:first + 2], first, 6)
        for w, p in zip(whole, part):
            assert torch.equal(w[first:first + 2], p)
        assert torch.equal(torch.rand(3, generator=gr), after)


def test_batch_iterator_reads_a_ranks_rows():
    ds = data.ArrayDataset(*data.synthetic_batch(7, 4, seed=2))
    for r in range(WORLD):
        m = Mesh(rank=r, size=WORLD, local_rank=r, device=torch.device("cpu"),
                 distributed=True)
        got = list(data.batch_iterator(ds, 4, shuffle=True, seed=5, drop_last=False, mesh=m))
        whole = list(data.batch_iterator(ds, 4, shuffle=True, seed=5, drop_last=False))
        assert isinstance(got[0], data.RowShard) and (got[0].first, got[0].total) == (2 * r, 4)
        for f in range(5):
            np.testing.assert_array_equal(got[0].rows[f], whole[0][f][2 * r:2 * r + 2])
            np.testing.assert_array_equal(got[1][f], whole[1][f])  # 3 rows: whole
