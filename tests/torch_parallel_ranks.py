"""What each rank runs for tests/test_torch_parallel.py and
tests/test_torch_parallel_procs.py, in processes that
``mica_tpu_torch.parallel.dryrun.spawn`` starts (gloo on the CPU), and
the inputs both files make (``batch``, ``volumes``).  No JAX here: the
test process computes the references.  Each rank function reads its
inputs from ``workdir``, writes arrays there under the rank's name and
returns a small JSON result."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

BASE, CORE, HALO = 16, 12, 2
# ``dryrun.spawn``'s arguments in the tests: gloo on the CPU, a deadline of
# 240 s, a process-group timeout of 120 s, two torch threads a rank
SPAWN = dict(device="cpu", timeout=240.0, group_timeout=120,
             pythonpath=[str(Path(__file__).resolve().parent)], env={"OMP_NUM_THREADS": "2"})
VOLUME_KEYS = ("backbone_probability", "carbon_alpha_probability",
               "amino_acid_probability", "amino_acid_prediction")


def batch(n=4, d=16, seed=11):
    """A training batch (density, AF3, three targets) of n d^3 windows."""
    r = np.random.default_rng(seed)
    dens = r.random((n, d, d, d)).astype(np.float32)
    af = (r.random((n, 24, d, d, d)) < 0.03).astype(np.float32)
    af[0] = 0.0  # a density-only sample in each rank's rows
    af[2] = 0.0
    tgt = [r.integers(0, c, (n, d, d, d)).astype(np.int32) for c in (4, 4, 21)]
    return (dens, af, *tgt)


def volumes():
    """a: random, 3 X cores (does not divide the world); b: one blob in an
    empty (48, 26, 13), 4 X cores (divides it)."""
    r = np.random.default_rng(0)
    a = r.random((26, 26, 13)).astype(np.float32)
    a_af = (r.random((24, 26, 26, 13)) < 0.02).astype(np.float32)
    b = np.zeros((48, 26, 13), np.float32)
    b[30:40, 5:15, 2:10] = r.random((10, 10, 8))
    b_af = np.zeros((24, 48, 26, 13), np.float32)
    b_af[5, 33, 8, 4] = 1.0
    return dict(a_vol=a, a_af=a_af, b_vol=b, b_af=b_af)


def _flat_grads(model):
    return np.concatenate([(torch.zeros_like(p) if p.grad is None else p.grad)
                           .detach().double().reshape(-1).numpy()
                           for p in model.parameters()])


def _flat_params(model):
    return np.concatenate([p.detach().reshape(-1).numpy() for p in model.parameters()])


def collectives() -> dict:
    """The mesh, the batch slice, the three collectives, initialize's
    idempotence and the device rule under a gloo group."""
    from mica_tpu_torch.device import resolve_device
    from mica_tpu_torch.parallel import distributed
    from mica_tpu_torch.parallel.mesh import make_mesh

    mesh = distributed.global_mesh("cpu")
    r, n = mesh.rank, mesh.size
    out = {"rank": r, "size": n, "distributed": mesh.distributed,
           "local_rank": mesh.local_rank, "multiprocess": distributed.is_multiprocess(),
           "slices": {str(g): [distributed.local_batch_slice(g).start,
                               distributed.local_batch_slice(g).stop] for g in (2, 4, 8, 12)},
           "rows": {str(k): [mesh.rows(k).start, mesh.rows(k).stop] for k in range(0, 6)}}
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (r + 1)
    b = torch.full((4,), float(r))
    distributed.all_reduce_sum_([a, b])
    out["all_reduce"] = [a.tolist(), b.tolist()]
    rows = mesh.rows(5)
    mine = [torch.arange(rows.start, rows.stop, dtype=torch.float32)[:, None] * 10
            + torch.arange(2), torch.full((rows.stop - rows.start, 3, 1), float(r))]
    ex = distributed.exchange_rows(mine, rows, 5)
    out["exchange"] = [t.tolist() for t in ex]
    c = [torch.full((3,), float(r + 7)), torch.full((2, 2), float(-r))]
    distributed.broadcast_(c, src=1)
    out["broadcast"] = [t.tolist() for t in c]
    group = torch.distributed.group.WORLD
    distributed.initialize(init_method="file:///nonexistent", world_size=99, rank=5)
    out["idempotent"] = (torch.distributed.group.WORLD is group
                         and torch.distributed.get_world_size() == n)
    try:
        resolve_device(None)
        out["card_refused"] = False
    except RuntimeError as e:
        out["card_refused"] = "no CUDA device" in str(e)
    out["mesh_again"] = make_mesh("cpu") == mesh
    distributed.barrier("collectives", 60)
    return out


def engine(workdir: str) -> dict:
    """Replicated and ``shard_volumes`` engines on the test's volumes, the
    slabs ``keep_on_device`` returns, and the per-rank accumulator bytes."""
    from mica_tpu_torch.infer.engine import SlidingWindowPredictor
    from mica_tpu_torch.parallel.mesh import make_mesh

    wd = Path(workdir)
    mesh = make_mesh("cpu")
    sd = torch.load(wd / "params.pt", weights_only=True)
    inputs = np.load(wd / "volumes.npz")
    kw = dict(batch_size=8, dtype=torch.float32, base_filters=BASE, core=CORE, halo=HALO,
              mesh=mesh)
    rep = SlidingWindowPredictor(sd, **kw)
    sv = SlidingWindowPredictor(sd, shard_volumes=True, **kw)
    result, arrays = {"rank": mesh.rank}, {}
    for name in ("a", "b"):
        vol, af = inputs[f"{name}_vol"], inputs[f"{name}_af"]
        for mode, pred in (("rep", rep), ("sv", sv)):
            got = pred.predict_volume(vol, af)
            for k in VOLUME_KEYS:
                arrays[f"{name}_{mode}_{k}"] = got[k]
            result[f"{name}_{mode}_acc_bytes"] = pred.timing["acc_bytes_per_device"]
            result[f"{name}_{mode}_forwards"] = pred.timing["n_forwards"]
        slab = sv.predict_volume(vol, af, keep_on_device=True)
        x0, xs = slab["x_offset"], slab["backbone_probability"].shape[0]
        full = arrays[f"{name}_rep_backbone_probability"]
        result[f"{name}_slab"] = [x0, xs]
        result[f"{name}_slab_err"] = float(np.abs(
            slab["backbone_probability"].numpy() - full[x0:x0 + xs]).max()) if xs else 0.0
        result[f"{name}_slab_aa_ok"] = bool(
            (slab["amino_acid_prediction"].numpy()
             == arrays[f"{name}_rep_amino_acid_prediction"][x0:x0 + xs]).all())
    np.savez(wd / f"engine_{mesh.rank}.npz", **arrays)
    return result


def _trainer(seed: int, augment: bool, blank: float, sd):
    from mica_tpu_torch.train.trainer import Trainer

    trainer = Trainer(base_filters=BASE, dtype=torch.float32, seed=seed, device="cpu",
                      use_augmentation=augment, exp_only_prob=blank)
    state = trainer.init_state()
    trainer.model.load_state_dict(sd)
    return trainer, state


def train_step(workdir: str, tag: str, seed: int, augment: bool, blank: float,
               rate: float) -> dict:
    """Validation, then one data-parallel step on the test's global batch;
    this rank's gradient (the reduced one) and parameters after the step
    go to ``workdir``; then a batch that does not divide the world."""
    from mica_tpu_torch.train.loss import task_lambdas

    wd = Path(workdir)
    sd = torch.load(wd / "params.pt", weights_only=True)
    batch = tuple(np.load(wd / "batch.npz")[k] for k in ("d", "af", "bb", "ca", "aa"))
    trainer, state = _trainer(seed, augment, blank, sd)
    val = trainer.run_validation(state, [batch, tuple(b[:3] for b in batch)], 3)
    met = trainer.train_step(state, batch, task_lambdas(3), rate)
    rank = trainer.mesh.rank
    np.savez(wd / f"{tag}_{rank}.npz", grads=_flat_grads(trainer.model),
             params=_flat_params(trainer.model))
    try:
        trainer.train_step(state, tuple(b[:3] for b in batch), task_lambdas(3), rate)
        uneven = ""
    except ValueError as e:
        uneven = str(e)
    return {"rank": rank, "loss": float(met["total_loss"]),
            "parts": [float(met[k]) for k in ("backbone_loss", "carbon_alpha_loss",
                                               "amino_acid_loss")],
            "uneven_error": uneven, "validation": val}


def cli_train(workdir: str) -> dict:
    """``cli.train`` for one epoch under the group, every rank in its own
    output directory, so the test sees who wrote what."""
    import torch.distributed as dist

    from mica_tpu_torch.cli import train as cli

    wd = Path(workdir)
    rank = dist.get_rank()
    out = wd / f"out_{rank}"
    rc = cli.main(["--data_path", str(wd / "packed.npz"), "--output_path", str(out),
                   "--log_dir", str(wd / f"logs_{rank}"), "--batch_size", "2",
                   "--num_epochs", "1", "--base_filters", str(BASE), "--dtype", "float32",
                   "--device", "cpu", "--val_fraction", "0.25"])
    return {"rank": rank, "rc": rc,
            "files": sorted(p.name for p in out.iterdir()) if out.exists() else []}


def world2(workdir: str, train_runs: list) -> dict:
    """Everything the test file holds at world size 2, in one spawn: the
    collectives, the engines, then each of ``train_runs`` (keyword
    arguments of ``train_step``)."""
    return {"collectives": collectives(), "engine": engine(workdir),
            "train": [train_step(workdir, **run) for run in train_runs]}


def fail_on_rank_1() -> dict:
    """Rank 1 fails while rank 0 waits for it in a collective."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.zeros(1))
    return {}
