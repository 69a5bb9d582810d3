"""Multi-process dry run of the data-parallel paths, and the launcher that
runs a function on every rank of a fresh process group.

    python -m mica_tpu_torch.parallel.dryrun --n 2 [--device cpu]

Counterpart of the JAX package's ``dryrun_multichip``: ``n`` rank
processes, joined by a ``file://`` rendezvous in a temporary directory,
each take one data-parallel ``Trainer`` step at base 16 on 16^3 windows
with augmentation on (a finite loss), then run the replicated engine and
the ``shard_volumes`` engine on a (26, 26, 13) volume at core 12 / halo 2
and hold the two equal at 1e-4.  Without ``--device`` the ranks run on
the card: NCCL with a card a rank where the host has ``n`` cards, else
gloo with every rank on ``cuda:0`` (NCCL refuses two ranks on one card);
``--device cpu`` runs gloo on the CPU.

``spawn`` starts the ranks with torchrun's ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` in their environment, gives the group a timeout and the
processes a deadline, and on the first rank that fails or the deadline
kills every rank (each in a session of its own, with what it started).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def _placement(n: int, device: Optional[str]):
    """(backend, local rank of each rank) for ``n`` ranks on ``device``."""
    if device == "cpu":
        return "gloo", list(range(n))
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "ranks on the CPU")
    if torch.cuda.device_count() >= n:
        return "nccl", list(range(n))
    return "gloo", [0] * n


def _kill(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    proc.wait()


def spawn(target: str, n: int, kwargs: Optional[Dict[str, Any]] = None,
          device: Optional[str] = None, timeout: float = 900.0,
          group_timeout: int = 600, pythonpath: Sequence[str] = (),
          env: Optional[Dict[str, str]] = None) -> List[Any]:
    """Call ``target`` ("module:function") with ``kwargs`` in ``n`` new
    rank processes of one process group and return each rank's result
    (JSON).  ``pythonpath``: directories the target's module is found in,
    besides the repository.  ``group_timeout`` bounds a collective's wait;
    ``timeout`` the whole run.  Raises with each rank's last output if a
    rank fails or the run outlasts ``timeout``."""
    backend, local = _placement(n, device)
    with tempfile.TemporaryDirectory(prefix="mica_ranks_") as tmp:
        tmp = Path(tmp)
        base_env = dict(os.environ)
        base_env.update(env or {})
        base_env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT), *map(str, pythonpath)]
            + ([base_env["PYTHONPATH"]] if base_env.get("PYTHONPATH") else []))
        procs, logs = [], []
        failed = None

        def exits():
            return "; ".join(f"rank {r} exited {p.returncode}" for r, p in enumerate(procs)
                             if p.poll() not in (None, 0))

        try:
            for r in range(n):
                spec = dict(target=target, kwargs=kwargs or {},
                            init=f"file://{tmp}/rendezvous", backend=backend,
                            group_timeout=group_timeout, result=str(tmp / f"result_{r}.json"))
                e = dict(base_env, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(local[r]))
                logs.append(open(tmp / f"rank_{r}.log", "w"))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "mica_tpu_torch.parallel.dryrun", "--rank-spec",
                     json.dumps(spec)], env=e, cwd=str(ROOT), stdout=logs[-1],
                    stderr=subprocess.STDOUT, start_new_session=True))
            deadline = time.time() + timeout
            while any(p.poll() is None for p in procs) and not exits():
                if time.time() > deadline:
                    failed = f"the ranks outlasted {timeout:.0f} s"
                    break
                time.sleep(0.05)
            failed = failed or exits() or None
        finally:
            for p in procs:
                _kill(p)
            for log in logs:
                log.close()
        if failed is not None:
            tails = "\n".join(
                f"--- rank {r} ({backend}):\n"
                + "\n".join((tmp / f"rank_{r}.log").read_text().splitlines()[-40:])
                for r in range(n))
            raise RuntimeError(f"{target} on {n} ranks failed: {failed}\n{tails}")
        return [json.loads((tmp / f"result_{r}.json").read_text()) for r in range(n)]


def _rank_main(spec: Dict[str, Any]) -> None:
    """One rank: join the group, call the target, write its result."""
    import torch.distributed as dist

    from . import distributed

    distributed.initialize(init_method=spec["init"], backend=spec["backend"],
                           timeout_seconds=spec["group_timeout"])
    try:
        mod, fn = spec["target"].split(":")
        result = getattr(importlib.import_module(mod), fn)(**spec["kwargs"])
        Path(spec["result"]).write_text(json.dumps(result))
        distributed.barrier("done", spec["group_timeout"])
    finally:
        dist.destroy_process_group()


def _dryrun_rank(device: Optional[str] = None) -> Dict[str, Any]:
    """One rank of ``dryrun_multigpu``: returns its loss and what it checked."""
    import math

    import torch

    from ..infer.engine import SlidingWindowPredictor
    from ..models.mica import dropout_rate_for_epoch
    from ..train.data import synthetic_batch
    from ..train.loss import task_lambdas
    from ..train.trainer import Trainer
    from .distributed import global_mesh

    mesh = global_mesh(device)
    size = 16
    trainer = Trainer(base_filters=16, dtype=torch.float32, use_augmentation=True, mesh=mesh)
    state = trainer.init_state()
    batch = synthetic_batch(batch_size=mesh.size, size=size)
    metrics = trainer.train_step(state, batch, task_lambdas(0), dropout_rate_for_epoch(0))
    total = float(metrics["total_loss"])
    if not math.isfinite(total):
        raise RuntimeError(f"rank {mesh.rank}: non-finite loss {total}")

    vol = np.random.default_rng(0).random((26, 26, 13)).astype(np.float32)
    kw = dict(batch_size=mesh.size, dtype=torch.float32, base_filters=16, mesh=mesh,
              core=12, halo=2)
    out = SlidingWindowPredictor(trainer.model, **kw).predict_volume(vol, None)
    bb = out["backbone_probability"]
    if not np.isfinite(bb).all():
        raise RuntimeError(f"rank {mesh.rank}: non-finite volumes")
    out_sv = SlidingWindowPredictor(trainer.model, shard_volumes=True,
                                    **kw).predict_volume(vol, None)
    err = float(np.abs(out_sv["backbone_probability"] - bb).max())
    if not err <= 1e-4:
        raise RuntimeError(f"rank {mesh.rank}: shard_volumes differs from the replicated "
                           f"volumes by {err}")
    return {"rank": mesh.rank, "loss": total, "shape": list(bb.shape), "shard_err": err,
            "device": str(mesh.device)}


def dryrun_multigpu(n: int, device: Optional[str] = None, timeout: float = 900.0) -> List[dict]:
    """Run the dry run on ``n`` ranks (see the module's docstring) and
    return each rank's result; raises if any rank fails."""
    if device != "cpu":
        from ..ops import _build

        _build.build()     # once, here: the ranks only load the libraries
    results = spawn("mica_tpu_torch.parallel.dryrun:_dryrun_rank", n, {"device": device},
                    device=device, timeout=timeout)
    losses = {r["loss"] for r in results}
    if len(losses) != 1:
        raise RuntimeError(f"the ranks report different losses: {sorted(losses)}")
    r0 = results[0]
    print(f"dryrun_multigpu({n}): train loss {r0['loss']:.4f} on every rank "
          f"({r0['device']}), inference ok {tuple(r0['shape'])}, sharded volumes within "
          f"{max(r['shard_err'] for r in results):.2e}", flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-process dry run of the data-parallel paths")
    ap.add_argument("--n", type=int, default=2, help="ranks")
    ap.add_argument("--device", default=None, help="'cpu', or the card (default)")
    ap.add_argument("--rank-spec", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_spec is not None:
        _rank_main(json.loads(args.rank_spec))
        return 0
    dryrun_multigpu(args.n, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
