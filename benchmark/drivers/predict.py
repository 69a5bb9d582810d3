"""Prediction: ``mica_tpu_torch.infer.pipeline.predict_map(map, params,
docked model, predictor=P)``, closed loop, one map after another, each
returning its four volumes to the host.  ``P``, a ``SlidingWindowPredictor``,
is built in set-up, as a modeller's process holds one.  The traffic's maps
alternate, so no call meets the output of the call before it."""

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


class Driver:
    kind = "predict"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, workdir: Path):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.workdir = Path(workdir)
        self.core, self.halo = int(cfg["core"]), int(cfg["halo"])
        self.docked = cfg["protocol"] == "AF3_struct"
        n = int(round(int(traffic["box"]) * float(traffic["voxel_size"])))
        self.shape = (n, n, n)
        axes = [np.arange(0, s, self.core) for s in self.shape]
        self.starts = np.stack([g.reshape(-1) for g in np.meshgrid(*axes, indexing="ij")], -1)
        self.records: List[Dict] = []
        self.kept: List[List[Dict]] = [[] for _ in range(int(traffic["maps"]))]

    def _make_maps(self) -> None:
        """The traffic's maps, and the windows the check compares on each:
        drawn from the seed, three in four among windows whose core holds
        density in the map as written (over a tenth of its largest value),
        the rest among the others, so every seed compares the same mix."""
        self.files = gen.map_pair(self.seed, self.traffic, self.workdir, self.device)
        rng = np.random.default_rng(gen.derived_seed(self.seed, 6))
        k = min(int(self.traffic["sample_windows"]), len(self.starts))
        self.samples = []
        for mp, _ in self.files:
            raw = np.abs(prep.read_mrc(mp)[0])
            scale = (np.asarray(raw.shape) - 1) / (np.asarray(self.shape) - 1)
            dense = np.zeros(len(self.starts), bool)
            for i, st in enumerate(self.starts):
                lo = np.floor(st * scale).astype(int)
                hi = np.ceil((st + self.core) * scale).astype(int) + 1
                dense[i] = raw[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].max() > 0.1 * raw.max()
            pools = [np.nonzero(dense)[0], np.nonzero(~dense)[0]]
            n0 = min(len(pools[0]), -(-3 * k // 4)) if len(pools[1]) else min(len(pools[0]), k)
            pick = list(rng.choice(pools[0], n0, replace=False))
            pick += list(rng.choice(pools[1], min(len(pools[1]), k - n0), replace=False))
            self.samples.append(np.sort(np.asarray(pick, int)))

    # ---- the program -----------------------------------------------------
    def setup(self) -> None:
        from mica_tpu_torch.infer.engine import SlidingWindowPredictor
        from mica_tpu_torch.infer.pipeline import predict_map

        self._predict_map = predict_map
        cfg = self.cfg
        self._make_maps()
        weights = gen.weights(ref.param_shapes(int(cfg["base_filters"])), self.seed, self.device)
        self.predictor = SlidingWindowPredictor(
            weights, batch_size=int(cfg["batch_size"]), dtype=getattr(torch, cfg["dtype"]),
            base_filters=int(cfg["base_filters"]), core=self.core, halo=self.halo,
            device=self.device)
        for k in range(int(self.traffic["warm_maps"])):
            self._call(k)

    def _call(self, k: int) -> Dict:
        mp, pp = self.files[k % len(self.files)]
        return self._predict_map(str(mp), None, str(pp) if self.docked else None,
                                 predictor=self.predictor)

    def _keep(self, k: int, out: Dict) -> None:
        """The sampled windows' cores of a call's volumes."""
        rows = []
        for i in self.samples[k]:
            sl = tuple(slice(int(s), int(s) + self.core) for s in self.starts[i])
            probs = np.concatenate([out["backbone_probability"][sl][None],
                                    out["carbon_alpha_probability"][sl][None],
                                    out["amino_acid_probability"][(slice(None),) + sl]])
            rows.append({"probs": probs.astype(np.float32),
                         "argmax": np.array(out["amino_acid_prediction"][sl])})
        self.kept[k].append(rows)

    def run_window(self, seconds: float, spans) -> None:
        t0 = time.perf_counter()
        i, kept = 0, 0.0
        while True:
            t = time.perf_counter()
            with spans("bench.predict_map"):
                out = self._call(i)
            wall = time.perf_counter() - t
            tm = out["timing"]
            self.records.append({"wall": wall, "voxels": int(np.prod(out["prepared_map"].volume.shape)),
                                 **{k: tm[k] for k in ("setup", "inference", "reconstruction",
                                                       "n_windows", "n_empty", "n_forwards")}})
            t = time.perf_counter()
            self._keep(i % len(self.files), out)
            del out
            self.records[-1]["keep"] = time.perf_counter() - t
            kept += self.records[-1]["keep"]
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        # the check's copies of the sampled windows are not the program's work
        self.window_s = time.perf_counter() - t0 - kept

    def trace_body(self, spans) -> None:
        """The traced window: one whole map."""
        with spans("bench.predict_map"):
            self.traced = self._call(len(self.records))["timing"]

    def release(self) -> None:
        self.predictor = None
        self._predict_map = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # ---- the reference ---------------------------------------------------
    def reference(self, k: int, q=None) -> List[Dict]:
        """The reference's probabilities at map ``k``'s sampled windows."""
        cfg = self.cfg
        mp, pp = self.files[k]
        vol, origin, voxel, start = prep.prepare(mp, self.device)
        enc = None
        if self.docked:
            enc = torch.from_numpy(prep.rasterize(pp, vol.shape, origin, voxel, start)).to(self.device)
        sd = gen.weights(ref.param_shapes(int(cfg["base_filters"])), self.seed, self.device)
        crop = slice(self.halo, self.halo + self.core)
        out, block = [], int(self.traffic.get("reference_batch", 4))
        idx = list(self.samples[k])
        with torch.no_grad(), ref.exact_f32():
            for b0 in range(0, len(idx), block):
                st = [self.starts[i] for i in idx[b0:b0 + block]]
                x = torch.stack([prep.window(vol, s, self.core, self.halo) for s in st])[:, None]
                af = None
                if enc is not None:
                    af = torch.stack([prep.window(enc, s, self.core, self.halo) for s in st]).float()
                bb, ca, aa = ref.forward(sd, x, af, q=q)
                p_bb, p_ca, p_aa = ref.probabilities(bb, ca, aa)
                probs = torch.cat([p_bb[:, None], p_ca[:, None], p_aa], 1)[:, :, crop, crop, crop]
                for j, s in enumerate(st):
                    ext = [min(self.core, n - int(a)) for a, n in zip(s, self.shape)]
                    p = probs[j][:, :ext[0], :ext[1], :ext[2]].cpu().numpy()
                    out.append({"probs": p, "argmax": p[2:].argmax(0)})
        return out

    def check(self) -> Dict[str, float]:
        """The widest of each number over every call of the window."""
        worst: Dict[str, float] = {}
        for k in range(len(self.files)):
            if not self.kept[k]:
                continue
            want = self.reference(k)
            for got in self.kept[k]:
                for name, v in compare.predict_numbers(got, want).items():
                    worst[name] = max(worst.get(name, 0.0), v)
        return worst

    def control(self, mode: str) -> Dict[str, float]:
        """The reference in fp8 in the program's place, judged as a run
        judges the program."""
        if mode != "fp8":
            raise ValueError(f"prediction has no control {mode!r}")
        self._make_maps()
        worst: Dict[str, float] = {}
        for k in range(len(self.files)):
            got = self.reference(k, q=ref.fp8)
            for name, v in compare.predict_numbers(got, self.reference(k)).items():
                worst[name] = max(worst.get(name, 0.0), v)
        return worst

    # ---- what the metrics read -------------------------------------------
    def attempted(self) -> int:
        return len(self.records)
