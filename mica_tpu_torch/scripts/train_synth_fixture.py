"""Train a small MICA on synthetic scenarios and export its weights.

Counterpart of ``scripts/train_synth_fixture.py``.  It builds N synthetic
chain scenarios (``utils/synthetic.make_scenario``), writes each as a map
(the scenario's backbone volume plus Gaussian noise of sigma 0.05) and a
CA-model PDB, and turns them into training windows with the code real
training data takes (``train.data.build_training_grids``: ``ops/masks``
and ``ops/rasterize``, windowed on the device).  It trains a base-16
``Trainer`` on them, measures the held-out backbone and CA Dice through
``SlidingWindowPredictor.predict_volume`` on a 96^3 scenario (seed 12345)
(and, with ``--eval_scenarios N``, on N held-out scenarios, seeds 12345
on, whose Dice it averages) for the trained weights and for the initial
ones, and exports the original
trainer's ``.pth`` layout (a ``module.``-prefixed ``model_state_dict``,
empty optimizer and criterion states), which ``cli.predict`` and
``cli.run --model_path`` read.

The exported weights are the last step's, as in the JAX script.
``Selection`` keeps instead the weights with the best mean backbone Dice
on validation scenarios (seeds 54321 on, none of them trained on or held
out), as ``cli.train`` keeps its best checkpoint by validation loss:
``chip_smoke.py``'s learned phase gates the held-out Dice of those.

    python -m mica_tpu_torch.scripts.train_synth_fixture [--steps 1200] [--dtype bfloat16]

The defaults are the JAX script's: 1200 steps, batch 8, 8 scenarios of
144^3 and 170 residues, lr 3e-4, base 16, bf16, on the card
(``--device cpu`` runs the plain versions; the size flags cut a run).
The windows are copied to the device once and each epoch gathers them
there in ``train.data.batch_iterator``'s order: its host batches, which
the trainer copies over, took ~480 ms a step at base 16 against ~280
(PERF.md).  The weights go to ``build/mica_synth_base16.pth``
(git-ignored) unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..infer.engine import SlidingWindowPredictor
from ..io import mrc as mrc_io
from ..io import pdb as pdb_io
from ..models.mica import dropout_rate_for_epoch
from ..ops import masks as mask_ops
from ..ops.rasterize import rasterize_af3_encoding
from ..train.data import ArrayDataset, build_training_grids
from ..train.loss import task_lambdas
from ..train.trainer import Trainer
from ..utils.synthetic import make_scenario

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
EVAL_SEED = 12345
VAL_SEED = 54321    # validation scenarios of ``Selection``
SEED = 0            # the Trainer's: weights, augmentation, dropout
LOG_EVERY = 50


def write_scenario(seed: int, shape, n_res: int, out: Path):
    """One scenario as (``scenario<seed>.mrc``, ``scenario<seed>.pdb``)
    under ``out``: the backbone volume plus noise (``default_rng(seed +
    1000)``, sigma 0.05), written transposed since an MRC's fastest axis is
    x, and the chain as a CA model."""
    ca, seq, vols = make_scenario(n_res=n_res, shape=shape, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    density = vols["backbone_probability"] + rng.normal(
        scale=0.05, size=shape).astype(np.float32)
    out.mkdir(parents=True, exist_ok=True)
    map_path, pdb_path = out / f"scenario{seed}.mrc", out / f"scenario{seed}.pdb"
    mrc_io.write_mrc(map_path, np.transpose(density, (2, 1, 0)), voxel_size=1.0)
    pdb_io.write_ca_pdb(pdb_path, [ca], res_names_by_chain=[list(seq)])
    return map_path, pdb_path


def concat(parts: List[ArrayDataset]) -> ArrayDataset:
    return ArrayDataset(*(np.concatenate([getattr(p, f) for p in parts])
                          for f in ("density", "af3", "bb", "ca", "aa")))


def build_dataset(n_scenarios: int, shape, n_res: int, device) -> ArrayDataset:
    """Scenarios 0..n-1 written to a temporary directory and windowed."""
    with tempfile.TemporaryDirectory(prefix="mica_fixture_") as tmp:
        parts = []
        for seed in range(n_scenarios):
            map_path, pdb_path = write_scenario(seed, shape, n_res, Path(tmp))
            parts.append(build_training_grids(str(map_path), str(pdb_path), device=device))
    return concat(parts)


def to_device(ds: ArrayDataset, device: torch.device) -> List[torch.Tensor]:
    """The dataset's five arrays on ``device``, in their packed dtypes."""
    return [torch.from_numpy(np.ascontiguousarray(getattr(ds, f))).to(device)
            for f in ("density", "af3", "bb", "ca", "aa")]


def device_batches(arrays: List[torch.Tensor], batch: int, epoch: int) -> Iterator[tuple]:
    """``batch_iterator(ds, batch, shuffle=True, seed=epoch)``'s batches,
    gathered on the device from ``to_device``'s arrays instead of stacked
    on the host."""
    density, af3, bb, ca, aa = arrays
    perm = np.random.default_rng(epoch).permutation(len(density))
    for ofs in range(0, len(perm) - len(perm) % batch, batch):
        idx = torch.from_numpy(perm[ofs:ofs + batch]).to(density.device)
        yield (density[idx].float(), af3[idx].float(), bb[idx].int(), ca[idx].int(),
               aa[idx].int())


def train(trainer: Trainer, state, ds: ArrayDataset, steps: int, batch: int,
          log_every: int = LOG_EVERY, on_step=None) -> Dict[str, object]:
    """``steps`` Adam steps over epochs of ``ds`` with each epoch's task
    weights and dropout rate.  Returns the per-step losses, the seconds of
    the first step and the mean seconds of the others (host clock, the
    card synchronized; the time ``on_step(step)``, called after each step,
    takes is left out, and reported as ``aside_s``), and the epochs begun."""
    dev = trainer.device
    arrays = to_device(ds, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    losses: List[torch.Tensor] = []
    epoch, t0, t1, aside = 0, time.time(), None, 0.0
    while len(losses) < steps:
        lambdas, rate = task_lambdas(epoch), dropout_rate_for_epoch(epoch)
        for b in device_batches(arrays, batch, epoch):
            losses.append(trainer.train_step(state, b, lambdas, rate)["total_loss"].detach())
            n = len(losses)
            if n == 1:
                sync()
                t1 = time.time()
            if on_step is not None:
                sync()
                ts = time.time()
                on_step(n)
                sync()
                aside += time.time() - ts
            if log_every and n % log_every == 0:
                recent = torch.stack(losses[-log_every:]).mean().item()
                print(f"step {n:5d} epoch {epoch:3d} loss {recent:.4f} (mean of the last "
                      f"{log_every}; {time.time() - t0:.0f} s)", flush=True)
            if n >= steps:
                break
        epoch += 1
    sync()
    t2 = time.time()
    return dict(losses=torch.stack(losses).float().cpu().numpy(), first_step_s=t1 - t0,
                step_s=(t2 - t1 - aside) / max(steps - 1, 1), epochs=epoch, aside_s=aside)


def held_out(shape=(96, 96, 96), n_res: int = 100, seed: int = EVAL_SEED) -> dict:
    """The JAX script's held-out scenario: density (backbone volume plus
    noise from ``default_rng(99)``, clipped to [0, 1]), its AF3 encoding
    and the class-3 backbone and CA truth masks."""
    ca, seq, vols = make_scenario(n_res=n_res, shape=shape, seed=seed)
    rng = np.random.default_rng(99)
    density = np.clip(vols["backbone_probability"]
                      + rng.normal(scale=0.05, size=shape).astype(np.float32), 0.0, 1.0)
    with tempfile.TemporaryDirectory(prefix="mica_fixture_eval_") as tmp:
        pdb_io.write_ca_pdb(Path(tmp) / "model.pdb", [ca], res_names_by_chain=[list(seq)])
        atoms = pdb_io.parse_pdb(Path(tmp) / "model.pdb")
    return dict(density=density.astype(np.float32),
                af3=rasterize_af3_encoding(atoms, shape),
                bb=mask_ops.backbone_mask(atoms, shape) == 3,
                ca=mask_ops.carbon_alpha_mask(atoms, shape) == 3)


def dice(pred_prob: np.ndarray, truth: np.ndarray, thr: float = 0.5) -> float:
    a = pred_prob > thr
    inter = float((a & truth).sum())
    return 2.0 * inter / max(float(a.sum() + truth.sum()), 1.0)


def evaluate(state_dict, base: int, dtype: torch.dtype, device, scenarios: List[dict],
             batch: int = 8) -> Dict[str, object]:
    """Backbone Dice (P > 0.5) and CA Dice (P > 0.3) against the class-3
    truth, through the sliding-window engine, on each held-out scenario
    (``each``) and their mean (``backbone``, ``ca``)."""
    pred = SlidingWindowPredictor(state_dict, batch_size=batch, dtype=dtype,
                                  base_filters=base, device=device)
    each = []
    for sc in scenarios:
        out = pred.predict_volume(sc["density"], sc["af3"])
        each.append((dice(out["backbone_probability"], sc["bb"]),
                     dice(out["carbon_alpha_probability"], sc["ca"], thr=0.3)))
    return dict(backbone=float(np.mean([e[0] for e in each])),
                ca=float(np.mean([e[1] for e in each])), each=each)


class Selection:
    """Model selection on validation scenarios, an ``on_step`` for
    ``train``: every ``every`` steps the mean validation backbone Dice of
    the trainer's weights (``curve``), and the best of them (``best``:
    step, Dice, weights on the host; the earliest on a tie)."""

    def __init__(self, trainer: Trainer, base: int, dtype: torch.dtype, device,
                 scenarios: List[dict], every: int):
        self.trainer, self.base, self.dtype, self.device = trainer, base, dtype, device
        self.scenarios, self.every = scenarios, every
        self.curve: List[tuple] = []
        self.best: Optional[tuple] = None

    def __call__(self, step: int) -> None:
        if step % self.every == 0:
            self.measure(step)

    def measure(self, step: int) -> None:
        if self.curve and self.curve[-1][0] == step:
            return
        sd = state_dict_of(self.trainer)
        d = evaluate(sd, self.base, self.dtype, self.device, self.scenarios)
        self.curve.append((step, d["backbone"]))
        if self.best is None or d["backbone"] > self.best[1]:
            self.best = (step, d["backbone"], sd)


def dice_line(d: Dict[str, object]) -> str:
    each = ", ".join(f"{b:.4f}" for b, _ in d["each"])
    return (f"backbone(cls3) {d['backbone']:.4f}  CA(cls3) {d['ca']:.4f} (mean of "
            f"{len(d['each'])}; backbone each {each})")


def state_dict_of(trainer: Trainer) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().cpu().clone() for k, v in trainer.model.state_dict().items()}


def export_pth(path: Path, state_dict: Dict[str, torch.Tensor], epoch: int,
               loss: float) -> None:
    """The original trainer's checkpoint layout."""
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"epoch": epoch,
                "model_state_dict": {f"module.{k}": v for k, v in state_dict.items()},
                "optimizer_state_dict": {}, "criterion_state_dict": {},
                "train_loss": loss, "val_loss": loss}, path)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", type=int, default=16)
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n_scenarios", type=int, default=8)
    ap.add_argument("--shape", type=int, default=144)
    ap.add_argument("--n_res", type=int, default=170)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--eval_shape", type=int, default=96)
    ap.add_argument("--eval_n_res", type=int, default=100)
    ap.add_argument("--eval_scenarios", type=int, default=1,
                    help="held-out scenarios (seeds 12345 on) whose Dice is averaged")
    ap.add_argument("--eval_every", type=int, default=0,
                    help="also measure the held-out Dice every N steps (0: at the end only)")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", default="build/mica_synth_base16.pth")
    return ap


def run(args: argparse.Namespace) -> Dict[str, object]:
    """Build, train, evaluate and export; returns the readings."""
    dev = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    t0 = time.time()
    ds = build_dataset(args.n_scenarios, (args.shape,) * 3, args.n_res, dev)
    data_s = time.time() - t0
    print(f"dataset: {len(ds)} windows from {args.n_scenarios} scenarios of {args.shape}^3 "
          f"and {args.n_res} residues in {data_s:.1f} s", flush=True)

    trainer = Trainer(base_filters=args.base, lr=args.lr, dtype=dtype, use_augmentation=True,
                      seed=SEED, device=dev)
    state = trainer.init_state()
    scenarios = [held_out((args.eval_shape,) * 3, args.eval_n_res, EVAL_SEED + i)
                 for i in range(args.eval_scenarios)]
    init = evaluate(state_dict_of(trainer), args.base, dtype, dev, scenarios)
    print(f"held-out Dice at the initial weights: {dice_line(init)}", flush=True)
    curve = []

    def on_step(n):
        if n % args.eval_every == 0 and n < args.steps:
            d = evaluate(state_dict_of(trainer), args.base, dtype, dev, scenarios)
            curve.append((n, d["backbone"], d["ca"]))
            print(f"step {n}: held-out Dice {dice_line(d)}", flush=True)

    res = train(trainer, state, ds, args.steps, args.batch, LOG_EVERY,
                on_step if args.eval_every else None)
    sd = state_dict_of(trainer)
    final = evaluate(sd, args.base, dtype, dev, scenarios)
    curve.append((args.steps, final["backbone"], final["ca"]))
    losses = res["losses"]
    tail = min(50, len(losses))
    print(f"trained {args.steps} steps ({res['epochs']} epochs) in {args.dtype}: first step "
          f"{res['first_step_s']:.3f} s, then {1e3 * res['step_s']:.3f} ms a step; loss "
          f"{losses[:tail].mean():.4f} over the first {tail} steps, {losses[-tail:].mean():.4f} "
          f"over the last {tail}", flush=True)
    print(f"held-out Dice: {dice_line(final)}", flush=True)
    out = Path(args.out)
    export_pth(out, sd, res["epochs"], float(losses[-tail:].mean()))
    print(f"saved {out} ({out.stat().st_size / 1e6:.1f} MB, base={args.base})", flush=True)
    return dict(dataset_windows=len(ds), data_s=data_s, init_dice=init, dice=final,
                dice_curve=curve, out=str(out), **res)


def main(argv: Optional[list] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
