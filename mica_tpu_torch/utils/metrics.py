"""Training metrics logging (copy of ``mica_tpu/utils/metrics.py``).

A dependency-free JSONL metrics sink with optional wandb mirroring when
the package is importable and enabled.  Batch and epoch metrics use
independent step counters, like the reference's custom wandb step
metrics.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class MetricsLogger:
    def __init__(self, log_dir: str, run_name: Optional[str] = None,
                 use_wandb: bool = False, wandb_project: str = "mica-tpu"):
        self.run_name = run_name or time.strftime("run_%Y%m%d_%H%M%S")
        self.path = Path(log_dir) / f"{self.run_name}.metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")
        self.batch_step = 0
        self.epoch_step = 0
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=wandb_project, name=self.run_name)
            except Exception as e:
                logger.warning("wandb unavailable (%s); JSONL only", e)

    def _write(self, record: Dict) -> None:
        record["time"] = time.time()
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            payload = {k: v for k, v in record.items() if isinstance(v, (int, float))}
            self._wandb.log(payload)

    def log_batch(self, metrics: Dict) -> None:
        self.batch_step += 1
        self._write({"kind": "batch", "batch_step": self.batch_step, **metrics})

    def log_epoch(self, epoch: int, train: Dict, val: Dict, lr: float) -> None:
        self.epoch_step += 1
        self._write({
            "kind": "epoch", "epoch": epoch, "lr": lr,
            **{f"train_{k}": v for k, v in train.items()},
            **{f"val_{k}": v for k, v in val.items()},
        })

    def close(self) -> None:
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
