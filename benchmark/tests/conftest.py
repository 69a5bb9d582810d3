"""Small sizes for running the harness on the CPU."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL_CFG = {"base_filters": 16, "window": 16, "core": 8, "halo": 4, "batch_size": 2,
             "dtype": "float32"}
SMALL_MAPS = {"box": 40, "residues": 60, "sample_windows": 3, "reference_batch": 2}
SMALL_TRAIN = {"box": 24, "residues": 40, "windows": 8, "reference_rows": 1}
SMALL = {"predict-dense-af3": SMALL_MAPS, "predict-masked-mapfree": SMALL_MAPS,
         "train-b8-af3": SMALL_TRAIN}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
