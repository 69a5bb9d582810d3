"""Training: ``Trainer.train_step`` fed by ``mica_tpu_torch.train.data.
batch_iterator(dataset, batch, shuffle=True)`` over an in-memory
``ArrayDataset``, reshuffled each epoch: the path ``cli.train --data_path
<packed .npz>`` takes.  Set-up builds one trainer and takes its first
steps through that same feed; the window goes on with the same object.
The first steps' losses, the first gradient (from Adam's state after one
step, kept on the host through the window) and the parameters' change over
the first steps are the readings the reference is held against."""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark import gen
from benchmark.reference import compare
from benchmark.reference import mica as ref
from benchmark.reference import prep

BETA1 = 0.9   # Adam's first-moment decay: exp_avg after one step is (1 - BETA1) g


class Driver:
    kind = "train"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, workdir: Path):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.batch = int(cfg["batch_size"])
        self.first = int(traffic["checked_steps"])
        self.trainer_seed = gen.derived_seed(seed, 5) % 2 ** 62
        self.shuffle_seed = gen.derived_seed(seed, 7)
        self.data = None
        self.records: List[Dict] = []

    def _epochs(self):
        from mica_tpu_torch.train.data import batch_iterator

        epoch = 0
        while True:
            yield from batch_iterator(self.dataset, self.batch, shuffle=True,
                                      seed=self.shuffle_seed + epoch)
            epoch += 1

    # ---- the program -----------------------------------------------------
    def setup(self, keep_grads: bool = False) -> None:
        """``keep_grads`` also keeps each set-up step's gradients as Adam
        received them, and the parameters' change (a look at the leaves)."""
        from mica_tpu_torch.train.data import ArrayDataset
        from mica_tpu_torch.train.loss import task_lambdas
        from mica_tpu_torch.train.trainer import Trainer

        cfg, tr = self.cfg, self.traffic
        self.data = gen.train_windows(self.seed, tr, int(cfg["core"]), int(cfg["halo"]),
                                      self.device, prep.normalize)
        self.dataset = ArrayDataset(**self.data)
        self.trainer = Trainer(base_filters=int(cfg["base_filters"]), lr=float(tr["lr"]),
                               dtype=getattr(torch, cfg["dtype"]),
                               exp_only_prob=float(tr["exp_only_prob"]),
                               use_augmentation=bool(tr["augment"]), seed=self.trainer_seed,
                               device=self.device, use_mesh=False)
        self.state = self.trainer.init_state()
        w0 = gen.weights(ref.param_shapes(int(cfg["base_filters"])), self.seed, self.device)
        self.trainer.model.load_state_dict(w0)
        self.trainer.model.train()
        self.lambdas = task_lambdas(float(tr["epoch"]))
        self.rate = float(tr["dropout_rate"])
        self.feed = self._epochs()
        params = dict(self.trainer.model.named_parameters())
        got = {"losses": [], "sizes": {k: p.numel() for k, p in params.items()}}
        if keep_grads:
            got["grads"], got["clipped"] = [], []
        for step in range(self.first):
            m = self.trainer.train_step(self.state, next(self.feed), self.lambdas, self.rate)
            got["losses"].append(float(m["total_loss"]))
            if keep_grads:
                got["grads"].append({k: p.grad.detach().float().clone() if p.grad is not None
                                     else torch.zeros_like(p, dtype=torch.float32)
                                     for k, p in params.items()})
                got["clipped"].append(bool(m["gradient_clipped"]))
            if step == 0:
                st = self.state.optimizer.state
                # a leaf Adam has not stepped has no state: its gradient reads 0;
                # kept on the host through the window, for the check
                got["grad1"] = {
                    k: (st[p]["exp_avg"] / (1 - BETA1)).float().cpu() if "exp_avg" in st.get(p, {})
                    else torch.zeros(p.shape) for k, p in params.items()}
                got["grad_norms"] = {k: float(g.norm()) for k, g in got["grad1"].items()}
        got["update_norms"] = {k: float((p.detach() - w0[k]).norm()) for k, p in params.items()}
        if keep_grads:
            got["updates"] = {k: (p.detach() - w0[k]).float() for k, p in params.items()}
        self.got = got

    def _step(self, spans) -> None:
        t = time.perf_counter()
        with spans("bench.loader"):
            batch = next(self.feed)
        loader = time.perf_counter() - t
        with spans("bench.train_step"):
            self.trainer.train_step(self.state, batch, self.lambdas, self.rate)
        self.records.append({"loader": loader, "samples": len(batch[0]),
                             "host": time.perf_counter() - t})

    def run_window(self, seconds: float, spans) -> None:
        t0 = time.perf_counter()
        while True:
            self._step(spans)
            if time.perf_counter() - t0 >= seconds:
                if self.device.type == "cuda":
                    torch.cuda.synchronize()
                break
        self.window_s = time.perf_counter() - t0

    def trace_body(self, spans) -> None:
        """The traced window: ``traced_steps`` more steps."""
        n = int(self.traffic["traced_steps"])
        for _ in range(n):
            self._step(spans)
        self.records, self.traced = self.records[:-n], self.records[-n:]

    def release(self) -> None:
        self.trainer = self.state = self.feed = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # ---- the reference ---------------------------------------------------
    def reference(self, q=None, half_batch: bool = False, frozen: bool = False,
                  keep_grads: bool = False) -> Dict:
        """The first steps, worked out again from the seed: the same rows,
        augmentation, blanking and dropout draws, in f32 (``q`` rounds the
        products' operands).  ``half_batch`` and ``frozen`` plant faults:
        the loss of half the rows, or no update.  ``keep_grads`` keeps each
        step's gradients and the parameters' change, as ``setup`` does."""
        cfg, tr, dev = self.cfg, self.traffic, self.device
        if self.data is None:
            self.data = gen.train_windows(self.seed, tr, int(cfg["core"]), int(cfg["halo"]),
                                          dev, prep.normalize)
        params = gen.weights(ref.param_shapes(int(cfg["base_filters"])), self.seed, dev)
        w0 = {k: v.clone() for k, v in params.items()}
        adam = ref.Adam(params, float(tr["lr"]))
        aug = torch.Generator(device=dev).manual_seed(self.trainer_seed)
        drop = torch.Generator().manual_seed(self.trainer_seed + 1)
        perm = np.random.default_rng(self.shuffle_seed).permutation(len(self.data["density"]))
        lam = ref.task_weights(float(tr["epoch"]))
        rate = float(tr["dropout_rate"])
        block = int(tr.get("reference_rows", 2))
        n = self.batch
        out = {"losses": [], "sizes": {k: v.numel() for k, v in params.items()}}
        if keep_grads:
            out["grads"] = []
        with ref.exact_f32():
            for step in range(self.first):
                ix = perm[step * n:(step + 1) * n]
                d = torch.from_numpy(self.data["density"][ix]).to(dev).float()[:, None]
                a = torch.from_numpy(self.data["af3"][ix]).to(dev).float()
                t = torch.stack([torch.from_numpy(self.data[k][ix]).to(dev).long()
                                 for k in ("bb", "ca", "aa")], 1)
                if tr["augment"]:
                    d, a, t = ref.augment(aug, d, a, t)
                blank = torch.rand(n, generator=aug, device=dev) < float(tr["exp_only_prob"])
                a = torch.where(blank.reshape(-1, 1, 1, 1, 1), 0.0, a)
                seeds = torch.randint(0, 2 ** 62, (ref.N_UNITS,), generator=drop).tolist()
                rows_used = n // 2 if half_batch else n
                dens = ref.denominators([t[:rows_used, j] for j in range(3)])
                grads = {k: torch.zeros_like(v) for k, v in params.items()}
                loss = 0.0
                for r0 in range(0, rows_used, block):
                    rows = slice(r0, min(r0 + block, rows_used))
                    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
                    masks = ref.unit_masks(seeds, rows, n, dev)
                    logits = ref.forward(leaves, d[rows], a[rows], q=q, rate=rate, masks=masks)
                    parts = ref.loss_parts(logits, [t[rows, j] for j in range(3)], dens)
                    total = sum(w * p for w, p in zip(lam, parts))
                    gs = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
                    for k, g in zip(leaves, gs):
                        if g is not None:
                            grads[k] += g
                    loss += float(total.detach())
                    del logits, parts, total, gs, leaves
                out["losses"].append(loss)
                if step == 0:
                    out["grad1"] = {k: g.clone() for k, g in grads.items()}
                    out["grad_norms"] = {k: float(g.norm()) for k, g in grads.items()}
                if keep_grads:
                    out["grads"].append({k: g.clone() for k, g in grads.items()})
                if not frozen:
                    adam.step(params, grads)
        out["update_norms"] = {k: float((params[k] - w0[k]).norm()) for k in params}
        if keep_grads:
            out["updates"] = {k: params[k] - w0[k] for k in params}
        return out

    @staticmethod
    def judged(got: Dict, want: Dict) -> Dict:
        """``got`` with the norm of its first gradient's difference from the
        reference's, a leaf each (``grad_diff``)."""
        return {**got, "grad_diff": {
            k: float((got["grad1"][k].to(g.device) - g).norm()) for k, g in want["grad1"].items()}}

    def check(self) -> Dict[str, float]:
        want = self.reference()
        got = self.judged(self.got, want)
        self.detail = compare.worst_leaves(got, want)
        return compare.train_numbers(got, want)

    def control(self, mode: str) -> Dict[str, float]:
        """The reference in the program's place: in fp8 (``fp8``), or with a
        fault planted (``half_batch``, ``frozen``)."""
        kw = {"fp8": {"q": ref.fp8}, "half_batch": {"half_batch": True},
              "frozen": {"frozen": True}}
        if mode not in kw:
            raise ValueError(f"training has no control {mode!r}")
        got, want = self.reference(**kw[mode]), self.reference()
        got = self.judged(got, want)
        self.detail = compare.worst_leaves(got, want)
        return compare.train_numbers(got, want)

    def attempted(self) -> int:
        return len(self.records)
