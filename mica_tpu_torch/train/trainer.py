"""Training loop, on one card or data-parallel over ranks (port of
``mica_tpu/train/trainer.py``).

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

Metrics stay on the device and are read once per epoch.

Data parallelism, the JAX trainer's mesh (on by default, as there): under
an initialized process group each rank takes its rows of every global
batch (``parallel.distributed.local_batch_slice``, or a
``data.RowShard``), the parameters start equal (rank 0's are broadcast)
and stay equal.  The weighted cross-entropies divide by ``sum_i w[y_i]``
over the whole batch, so a rank's loss is a partial with the all-reduced
normalisers, and the gradients are summed over the ranks, not averaged:
one all-reduce of a flat buffer after the backward, which also sums the
loss metrics.  (DDP would average; its loss would have to be scaled by the
world size, with ``no_sync`` on all microbatches but the last, for the same
result.)  Clipping and Adam then see the same gradients on every rank.
Augmentation, AF3 blanking and dropout draw for the whole batch and take
the rank's rows, so a world of N gives the step one process gives the
batch (with ``microbatch`` each rank's microbatches draw their own
dropout seeds).  Validation reduces across ranks, and a batch that does not
divide the world is evaluated whole on every rank, so the plateau
scheduler reads the same loss everywhere.  Only rank 0 saves.  Without a
process group the world is this process and nothing is exchanged.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..models.mica import MICA, dropout_rate_for_epoch, exact_f32
from ..parallel import distributed
from ..parallel.mesh import make_mesh
from ..utils.spans import count, span
from . import augment
from .data import RowShard
from .loss import class_weight_denominators, multi_task_loss, task_lambdas

logger = logging.getLogger(__name__)

GRAD_HISTORY = 10
GRAD_HISTORY_MIN = 5
_EPOCH_KEYS = ("total_loss", "backbone_loss", "carbon_alpha_loss", "amino_acid_loss")
# what the step computes on: density, AF3, bb, ca, aa
BATCH_DTYPES = (torch.float32, torch.float32, torch.int32, torch.int32, torch.int32)


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
                 seed: int = 2022, microbatch: Optional[int] = None, device=None,
                 mesh=None, use_mesh: bool = True):
        """``device`` None means the card (the mesh's, given a mesh; raises
        where there is none); the CPU runs the kernels' plain versions.
        bf16 compute takes the kernels; f32 takes the library route with
        TF32 off, over the backward too (``train_step``), as the JAX
        package's f32 does.  ``mesh``: the data-parallel world
        (``parallel.mesh``); ``use_mesh`` makes it from the process group
        when none is given."""
        if mesh is None and use_mesh:
            mesh = make_mesh(device)
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None and device is None
                                     else device)
        self.seed = seed
        self.model = MICA(base=base_filters, dtype=dtype, remat=True).to(self.device)
        self.scheduler = PlateauScheduler(lr)
        self.label_smoothing = label_smoothing
        self.exp_only_prob = exp_only_prob
        self.use_augmentation = use_augmentation
        self.microbatch = microbatch
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.dropout_gen = torch.Generator().manual_seed(seed + 1)

    @property
    def _dp(self) -> bool:
        """Ranks exchange: a process group is up."""
        return self.mesh is not None and self.mesh.distributed

    @property
    def is_main(self) -> bool:
        """This process logs and saves (rank 0, or the only one)."""
        return self.mesh is None or self.mesh.is_main

    def _check_batch_divisible(self, n: int) -> None:
        """Each rank takes batch / world rows: fail readably otherwise."""
        if self.mesh is not None and n % self.mesh.size:
            raise ValueError(
                f"batch size {n} is not divisible by the {self.mesh.size}-rank world; "
                f"round the batch up (parallel.mesh.pad_to_multiple) or drop the "
                f"remainder")

    def _rows(self, batch, whole_if_uneven: bool = False):
        """(this rank's rows, first row, global rows, split) of a global batch
        or a ``RowShard``.  A batch that does not divide the world raises,
        or with ``whole_if_uneven`` comes back whole (``split`` False)."""
        if isinstance(batch, RowShard):
            return batch.rows, batch.first, batch.total, True
        n = len(batch[0])
        if not self._dp:
            return batch, 0, n, False
        if n % self.mesh.size and whole_if_uneven:
            return batch, 0, n, False
        self._check_batch_divisible(n)
        sl = distributed.local_batch_slice(n)
        return [b[sl] for b in batch], sl.start, n, True

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Fresh xavier-normal weights (``MICA.init_weights``; under a
        process group rank 0's on every rank) and Adam."""
        self.model.init_weights(torch.Generator(device=self.device).manual_seed(self.seed + 2))
        if self._dp:
            distributed.broadcast_([p.data for p in self.model.parameters()])
        return TrainState(
            optimizer=torch.optim.Adam(self.model.parameters(), lr=self.scheduler.lr),
            step=0,
            grad_norms=torch.zeros(GRAD_HISTORY, dtype=torch.float32, device=self.device),
            grad_count=torch.zeros((), dtype=torch.int64, device=self.device))

    def _to_device(self, batch) -> List[torch.Tensor]:
        """``batch``'s fields on the device, copied in the types they come in
        (``h2d_bytes`` counts those: uint8 AF3 bits and int8 labels from a
        packed dataset) and widened there to ``BATCH_DTYPES``.  A batch
        already in those types comes through unchanged."""
        with span("train.to_device"):
            host = [torch.as_tensor(b) for b in batch]
            count("h2d_bytes", sum(t.nbytes for t in host))
            return [t.to(self.device, non_blocking=True).to(dt)
                    for t, dt in zip(host, BATCH_DTYPES)]

    # ------------------------------------------------------------------
    def train_step(self, state: TrainState, batch, lambdas,
                   dropout_rate: float) -> Dict[str, torch.Tensor]:
        """One Adam step on ``batch`` = (density (N,D,H,W), af3
        (N,24,D,H,W), bb, ca, aa (N,D,H,W) integer), numpy or tensors: the
        global batch, or under a process group this rank's ``RowShard`` of
        it.  Updates the model and ``state`` in place; returns the step's
        metrics as device tensors, the global batch's on every rank."""
        with span("train.step"), exact_f32(self.model.dtype):
            return self._train_step(state, batch, lambdas, dropout_rate)

    def _train_step(self, state: TrainState, batch, lambdas,
                    dropout_rate: float) -> Dict[str, torch.Tensor]:
        rows, first, total, split = self._rows(batch)
        density, af3, bb, ca, aa = self._to_device(rows)
        dens = density[:, None]
        targets = torch.stack([bb, ca, aa], dim=1)
        if self.use_augmentation:
            dens, af3, targets = augment.augment_batch(self.gen, dens, af3, targets,
                                                       first, total)
        n = dens.shape[0]
        # random AF3 blanking: the sample trains on the map alone
        zero = torch.rand(total, generator=self.gen,
                          device=self.device)[first:first + n] < self.exp_only_prob
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
        if split:
            # the normalisers of the whole batch: each rank's loss is a partial
            d = torch.stack(class_weight_denominators(tgt))
            distributed.all_reduce_sum_([d])
            denoms = tuple(d)
        metrics: Dict[str, torch.Tensor] = {}
        for sl in slices:
            outs = model(x[sl], af[sl], dropout_rate=dropout_rate, train=True,
                         generator=self.dropout_gen,
                         batch_rows=(first + sl.start, total) if split else None)
            loss, met = multi_task_loss(outs, tuple(t[sl] for t in tgt), lambdas,
                                        self.label_smoothing, denoms)
            loss.backward()
            for k, v in met.items():
                metrics[k] = metrics[k] + v.detach() if k in metrics else v.detach()
        for k in ("lambda_b", "lambda_c", "lambda_a"):
            metrics[k] = metrics[k] / len(slices)

        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if split:
            # the gradients and losses of the whole batch: sums of the partials
            losses = torch.stack([metrics[k] for k in _EPOCH_KEYS])
            distributed.all_reduce_sum_(grads + [losses])
            metrics.update(zip(_EPOCH_KEYS, losses))
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
        with span("train.epoch") as epoch_span:
            for batch in loader:
                metrics = self.train_step(state, batch, lambdas, rate)
                n += 1
                for k in _EPOCH_KEYS:
                    totals[k] = totals[k] + metrics[k] if k in totals else metrics[k]
            out = {k: float(v) / max(n, 1) for k, v in totals.items()}
        out["epoch_time"] = epoch_span.seconds
        out["steps"] = n
        return state, out

    def run_validation(self, state: TrainState, loader: Iterable,
                       epoch: int) -> Dict[str, float]:
        """Mean validation metrics: the inference forward, no augmentation,
        no blanking, no dropout.  Under a process group, the global batch's
        on every rank: a batch that divides the world is split and reduced,
        one that does not is evaluated whole by every rank."""
        lambdas = task_lambdas(epoch)
        self.model.eval()
        totals: Dict[str, torch.Tensor] = {}
        n = 0
        with torch.no_grad():
            for batch in loader:
                rows, _, _, split = self._rows(batch, whole_if_uneven=True)
                density, af3, bb, ca, aa = self._to_device(rows)
                outs = self.model(density[..., None], af3.movedim(1, -1).contiguous())
                denoms = None
                if split:
                    d = torch.stack(class_weight_denominators((bb, ca, aa)))
                    distributed.all_reduce_sum_([d])
                    denoms = tuple(d)
                _, metrics = multi_task_loss(outs, (bb, ca, aa), lambdas,
                                             self.label_smoothing, denoms)
                if split:
                    losses = torch.stack([metrics[k] for k in _EPOCH_KEYS])
                    distributed.all_reduce_sum_([losses])
                    metrics.update(zip(_EPOCH_KEYS, losses))
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
    """``torch.save`` of the whole training state, by rank 0 alone under a
    process group."""
    if not trainer.is_main:
        return
    torch.save(trainer.checkpoint_dict(state, epoch, val_loss), path)


def load_checkpoint(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)
