"""Training loop on one device (port of ``mica_tpu/train/trainer.py``).

  * Adam (``torch.optim.Adam``; its defaults are optax's), lr 1e-4, set
    in the optimizer's param groups from a host-side ReduceLROnPlateau
    (factor 0.5, patience 5);
  * adaptive gradient clipping with the last 10 global gradient norms in
    a ring buffer on the device: once 5 are recorded, clip to 1.5x their
    mean whenever the current norm exceeds 2x the mean;
  * the reference's epoch-gated dropout schedule and cosine task weights;
  * on-device augmentation and random AF3 blanking (``exp_only_prob``),
    drawn from the trainer's device generator; dropout seeds from a CPU
    generator (``MICA.forward``);
  * exact microbatch accumulation: the weighted-CE normalisers come from
    the full batch, so the microbatches' losses and gradients sum to the
    full batch's;
  * per-block recomputation (``MICA(remat=True)``), the JAX trainer's
    ``remat_scope="blocks"`` default;
  * checkpoints with ``torch.save``: model, optimizer, scheduler, ring
    buffer, step, epoch and both generators, so a resumed run takes the
    same next step.

Metrics stay on the device and are read once per epoch.  The mesh of
the JAX trainer (data parallelism over devices) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..models.mica import MICA, dropout_rate_for_epoch, exact_f32
from . import augment
from .loss import class_weight_denominators, multi_task_loss, task_lambdas

logger = logging.getLogger(__name__)

GRAD_HISTORY = 10
GRAD_HISTORY_MIN = 5
_EPOCH_KEYS = ("total_loss", "backbone_loss", "carbon_alpha_loss", "amino_acid_loss")


@dataclasses.dataclass
class TrainState:
    optimizer: torch.optim.Adam
    step: int
    grad_norms: torch.Tensor  # (GRAD_HISTORY,) f32 ring buffer on the device
    grad_count: torch.Tensor  # () int64: norms recorded so far


class PlateauScheduler:
    """Host-side ReduceLROnPlateau (torch semantics: factor 0.5, patience 5,
    rel threshold 1e-4, mode min)."""

    def __init__(self, lr: float, factor: float = 0.5, patience: int = 5,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
                logger.info("plateau: reducing lr to %.3e", self.lr)
        return self.lr

    def state_dict(self):
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d):
        self.lr, self.best, self.num_bad = d["lr"], d["best"], d["num_bad"]


def adaptive_clip(grads: List[torch.Tensor], grad_norms: torch.Tensor,
                  grad_count: torch.Tensor):
    """The reference's adaptive clipping on device tensors, no host sync:
    records the global norm in the ring buffer and scales ``grads`` in
    place.  Returns (grads, grad_norms, grad_count, norm, clipped)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    slot = torch.arange(GRAD_HISTORY, device=grad_norms.device) == grad_count % GRAD_HISTORY
    grad_norms = torch.where(slot, norm, grad_norms)
    grad_count = grad_count + 1
    n_valid = torch.clamp(grad_count, max=GRAD_HISTORY)
    avg = grad_norms.sum() / n_valid.float()
    clipped = (n_valid >= GRAD_HISTORY_MIN) & (norm > 2.0 * avg)
    clip_to = 1.5 * avg
    scale = torch.where(clipped & (norm > clip_to), clip_to / (norm + 1e-12), 1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return grads, grad_norms, grad_count, norm, clipped


class Trainer:
    def __init__(self, base_filters: int = 64, lr: float = 1e-4,
                 dtype: torch.dtype = torch.bfloat16, label_smoothing: float = 0.0,
                 exp_only_prob: float = 0.4, use_augmentation: bool = True,
                 seed: int = 2022, microbatch: Optional[int] = None, device=None):
        """``device`` None means the card (raises where there is none); the
        CPU runs the kernels' plain versions.  bf16 compute takes the
        kernels; f32 takes the library route with TF32 off, over the
        backward too (``train_step``), as the JAX package's f32 does."""
        self.device = resolve_device(device)
        self.seed = seed
        self.model = MICA(base=base_filters, dtype=dtype, remat=True).to(self.device)
        self.scheduler = PlateauScheduler(lr)
        self.label_smoothing = label_smoothing
        self.exp_only_prob = exp_only_prob
        self.use_augmentation = use_augmentation
        self.microbatch = microbatch
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.dropout_gen = torch.Generator().manual_seed(seed + 1)

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Fresh xavier-normal weights (``MICA.init_weights``) and Adam."""
        self.model.init_weights(torch.Generator(device=self.device).manual_seed(self.seed + 2))
        return TrainState(
            optimizer=torch.optim.Adam(self.model.parameters(), lr=self.scheduler.lr),
            step=0,
            grad_norms=torch.zeros(GRAD_HISTORY, dtype=torch.float32, device=self.device),
            grad_count=torch.zeros((), dtype=torch.int64, device=self.device))

    def _to_device(self, batch) -> List[torch.Tensor]:
        return [torch.as_tensor(b).to(self.device, non_blocking=True) for b in batch]

    # ------------------------------------------------------------------
    def train_step(self, state: TrainState, batch, lambdas,
                   dropout_rate: float) -> Dict[str, torch.Tensor]:
        """One Adam step on ``batch`` = (density (N,D,H,W), af3
        (N,24,D,H,W), bb, ca, aa (N,D,H,W) integer), numpy or tensors.
        Updates the model and ``state`` in place; returns the step's
        metrics as device tensors."""
        with exact_f32(self.model.dtype):
            return self._train_step(state, batch, lambdas, dropout_rate)

    def _train_step(self, state: TrainState, batch, lambdas,
                    dropout_rate: float) -> Dict[str, torch.Tensor]:
        density, af3, bb, ca, aa = self._to_device(batch)
        dens = density[:, None].float()
        af3 = af3.float()
        targets = torch.stack([bb, ca, aa], dim=1)
        if self.use_augmentation:
            dens, af3, targets = augment.augment_batch(self.gen, dens, af3, targets)
        n = dens.shape[0]
        # random AF3 blanking: the sample trains on the map alone
        zero = torch.rand(n, generator=self.gen, device=self.device) < self.exp_only_prob
        af3 = torch.where(zero.reshape(-1, 1, 1, 1, 1), 0.0, af3)
        x = dens.movedim(1, -1).contiguous()
        af = af3.movedim(1, -1).contiguous()
        tgt = (targets[:, 0], targets[:, 1], targets[:, 2])

        model, opt = self.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        mb = self.microbatch
        if mb and mb < n and n % mb == 0:
            denoms = class_weight_denominators(tgt)
            slices = [slice(i, i + mb) for i in range(0, n, mb)]
        else:
            denoms, slices = None, [slice(0, n)]
        metrics: Dict[str, torch.Tensor] = {}
        for sl in slices:
            outs = model(x[sl], af[sl], dropout_rate=dropout_rate, train=True,
                         generator=self.dropout_gen)
            loss, met = multi_task_loss(outs, tuple(t[sl] for t in tgt), lambdas,
                                        self.label_smoothing, denoms)
            loss.backward()
            for k, v in met.items():
                metrics[k] = metrics[k] + v.detach() if k in metrics else v.detach()
        for k in ("lambda_b", "lambda_c", "lambda_a"):
            metrics[k] = metrics[k] / len(slices)

        grads = [p.grad for p in model.parameters() if p.grad is not None]
        _, state.grad_norms, state.grad_count, norm, clipped = adaptive_clip(
            grads, state.grad_norms, state.grad_count)
        opt.step()
        state.step += 1
        metrics["gradient_norm"] = norm
        metrics["gradient_clipped"] = clipped
        return metrics

    def _set_lr(self, state: TrainState) -> None:
        for group in state.optimizer.param_groups:
            group["lr"] = self.scheduler.lr

    # ------------------------------------------------------------------
    def run_epoch(self, state: TrainState, loader: Iterable,
                  epoch: int) -> Tuple[TrainState, Dict[str, float]]:
        """Train over ``loader`` at the epoch's dropout rate and task
        weights, with the scheduler's lr; metrics are epoch means."""
        rate = dropout_rate_for_epoch(epoch)
        lambdas = task_lambdas(epoch)
        self._set_lr(state)
        self.model.train()
        totals: Dict[str, torch.Tensor] = {}
        n = 0
        t0 = time.time()
        for batch in loader:
            metrics = self.train_step(state, batch, lambdas, rate)
            n += 1
            for k in _EPOCH_KEYS:
                totals[k] = totals[k] + metrics[k] if k in totals else metrics[k]
        out = {k: float(v) / max(n, 1) for k, v in totals.items()}
        out["epoch_time"] = time.time() - t0
        out["steps"] = n
        return state, out

    def run_validation(self, state: TrainState, loader: Iterable,
                       epoch: int) -> Dict[str, float]:
        """Mean validation metrics: the inference forward, no augmentation,
        no blanking, no dropout."""
        lambdas = task_lambdas(epoch)
        self.model.eval()
        totals: Dict[str, torch.Tensor] = {}
        n = 0
        with torch.no_grad():
            for batch in loader:
                density, af3, bb, ca, aa = self._to_device(batch)
                outs = self.model(density[..., None].float(),
                                  af3.float().movedim(1, -1).contiguous())
                _, metrics = multi_task_loss(outs, (bb, ca, aa), lambdas,
                                             self.label_smoothing)
                n += 1
                for k in _EPOCH_KEYS:
                    totals[k] = totals[k] + metrics[k] if k in totals else metrics[k]
        return {k: float(v) / max(n, 1) for k, v in totals.items()}

    # ------------------------------------------------------------------
    def checkpoint_dict(self, state: TrainState, epoch: int, val_loss: float) -> dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
            "grad_norms": state.grad_norms.cpu(),
            "grad_count": int(state.grad_count),
            "epoch": epoch,
            "val_loss": float(val_loss),
            "scheduler": self.scheduler.state_dict(),
            "generators": {"augment": self.gen.get_state(),
                           "dropout": self.dropout_gen.get_state()},
        }

    def restore(self, state: TrainState, ckpt: dict) -> int:
        """Load a checkpoint into the model, ``state``, the scheduler and
        the generators; returns the epoch to resume at."""
        self.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        state.grad_norms = ckpt["grad_norms"].to(self.device)
        state.grad_count = torch.tensor(int(ckpt["grad_count"]), device=self.device)
        self.scheduler.load_state_dict(ckpt["scheduler"])
        self.gen.set_state(ckpt["generators"]["augment"])
        self.dropout_gen.set_state(ckpt["generators"]["dropout"])
        return int(ckpt["epoch"]) + 1


def save_checkpoint(path: str, trainer: Trainer, state: TrainState, epoch: int,
                    val_loss: float) -> None:
    """``torch.save`` of the whole training state."""
    torch.save(trainer.checkpoint_dict(state, epoch, val_loss), path)


def load_checkpoint(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)
