"""Training CLI.

    python -m mica_tpu_torch.cli.train --data_path Training_Dataset/Grids [...]

Flag-compatible with ``mica_tpu/cli/train.py``, plus ``--device``.  Each
epoch writes ``<output_path>/mica_epoch_<n>[_best].pt`` (``torch.save``
of the whole training state); ``--resume_train --model_checkpoint`` takes
one back.

On N cards of a host, data-parallel (``--batch_size`` is the global batch,
a multiple of N):

    torchrun --nproc_per_node N -m mica_tpu_torch.cli.train --data_path ...

Each rank reads its rows of every global batch (the same shuffle on every
rank, from the epoch); only rank 0 logs and saves.
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the MICA network (PyTorch)")
    p.add_argument("--data_path", required=True,
                   help="Grids root (reference layout) or packed .npz dataset")
    p.add_argument("--output_path", default="trained_models")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_epochs", type=int, default=60)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--exp_only_prob", type=float, default=0.4)
    p.add_argument("--no_augmentation", action="store_true")
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=2022)
    p.add_argument("--resume_train", action="store_true")
    p.add_argument("--model_checkpoint", default="")
    p.add_argument("--val_fraction", type=float, default=0.2)
    p.add_argument("--base_filters", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="compute dtype; float32 takes the library convs with TF32 "
                        "off, on the card or the CPU")
    p.add_argument("--log_dir", default="logs/training_logs")
    p.add_argument("--wandb", action="store_true", help="mirror metrics to wandb")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from ..parallel import distributed

    if "WORLD_SIZE" in os.environ or torch.distributed.is_initialized():
        distributed.initialize(backend="gloo" if args.device == "cpu" else None)
    main_rank = not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0
    logging.basicConfig(level=logging.INFO if main_rank else logging.WARNING,
                        format="%(asctime)s - %(levelname)s - %(message)s")

    from ..train import data as data_mod
    from ..train.trainer import Trainer, load_checkpoint, save_checkpoint
    from ..utils.metrics import MetricsLogger

    if args.data_path.endswith(".npz"):
        dataset = data_mod.ArrayDataset.load(args.data_path)
    else:
        dataset = data_mod.NpzGridsDataset.from_root(args.data_path)
    if len(dataset) == 0:
        logger.error("no training samples found under %s", args.data_path)
        return 1
    train_ix, val_ix = data_mod.train_val_split(len(dataset), args.val_fraction)
    logger.info("dataset: %d samples (%d train / %d val)",
                len(dataset), len(train_ix), len(val_ix))

    trainer = Trainer(
        base_filters=args.base_filters,
        lr=args.learning_rate,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        label_smoothing=args.label_smoothing,
        exp_only_prob=args.exp_only_prob,
        use_augmentation=not args.no_augmentation,
        seed=args.seed,
        device=args.device,
    )
    state = trainer.init_state()
    start_epoch = 0
    best_val = float("inf")
    if args.resume_train and args.model_checkpoint:
        ckpt = load_checkpoint(args.model_checkpoint)
        start_epoch = trainer.restore(state, ckpt)
        best_val = float(ckpt["val_loss"])
        logger.info("resumed from epoch %d (val %.4f)", start_epoch, best_val)

    out = Path(args.output_path)
    if trainer.is_main:
        out.mkdir(parents=True, exist_ok=True)
    metrics_log = (MetricsLogger(args.log_dir, use_wandb=args.wandb) if trainer.is_main
                   else None)

    for epoch in range(start_epoch, args.num_epochs):
        train_loader = data_mod.batch_iterator(
            dataset, args.batch_size, train_ix, shuffle=True, seed=epoch, mesh=trainer.mesh)
        state, train_metrics = trainer.run_epoch(state, train_loader, epoch)
        # keep the tail: a val split smaller than the batch would otherwise
        # give no batch at all
        val_loader = data_mod.batch_iterator(
            dataset, args.batch_size, val_ix, shuffle=False, drop_last=False,
            mesh=trainer.mesh)
        val_metrics = trainer.run_validation(state, val_loader, epoch)
        logger.info("epoch %d: train %.4f val %.4f (%.1fs, %d steps)", epoch,
                    train_metrics.get("total_loss", float("nan")),
                    val_metrics.get("total_loss", float("nan")),
                    train_metrics["epoch_time"], train_metrics["steps"])
        if metrics_log is not None:
            metrics_log.log_epoch(epoch, train_metrics, val_metrics, lr=trainer.scheduler.lr)
        val_loss = val_metrics.get("total_loss", float("inf"))
        is_best = val_loss < best_val
        if is_best:
            best_val = val_loss
        name = f"mica_epoch_{epoch}" + ("_best" if is_best else "")
        save_checkpoint(str(out / f"{name}.pt"), trainer, state, epoch, val_loss)
        trainer.scheduler.step(val_loss)
    if metrics_log is not None:
        metrics_log.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
