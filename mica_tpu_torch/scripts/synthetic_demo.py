"""End to end on synthetic inputs: a map -> the CA and all-atom models.

Counterpart of ``examples/synthetic_demo.py``.  It needs nothing from
outside the repository: it makes a protein-shaped scenario (a
self-avoiding CA walk, a random sequence, the backbone volume plus noise as
the density), writes the layout the real pipeline reads (the map as MRC, a
FASTA, an AF3 structure directory and a docked model), and runs
``python -m mica_tpu_torch.cli.run`` on it with ``--run_pulchra``: map
preparation, the sliding-window network with the given weights, candidate
extraction, sequence alignment, model assembly, gap filling and the native
all-atom rebuild.  The weights are a base-16 network trained on this
synthetic family by ``mica_tpu_torch.scripts.train_synth_fixture``.

    python -m mica_tpu_torch.scripts.train_synth_fixture
    python -m mica_tpu_torch.scripts.synthetic_demo [--out DIR] [--n_res 100]

It prints the command, ``cli.run``'s per-stage time-cost table and the CA
model's coverage (the share of true CAs with a built CA within 3 A) and
median distance against the true chain.  On the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import csv
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..io import mrc as mrc_io
from ..io import pdb as pdb_io
from ..utils.synthetic import make_scenario

REPO = Path(__file__).resolve().parents[2]


def build_inputs(out: Path, n_res: int, shape, seed: int) -> np.ndarray:
    """The scenario's inputs under ``out``: ``emd_demo.mrc`` (the backbone
    volume plus noise from ``default_rng(seed + 17)``, sigma 0.05),
    ``demo.fasta``, ``input/AF3_structures/synth/ranked_0.pdb`` and
    ``input/input_af3_docked.pdb`` (the true chain as CA models).  Returns
    the true CA coordinates."""
    ca, seq, vols = make_scenario(n_res=n_res, shape=shape, seed=seed)
    rng = np.random.default_rng(seed + 17)
    density = vols["backbone_probability"] + rng.normal(scale=0.05, size=shape).astype(
        np.float32)
    inp = out / "input"
    af_dir = inp / "AF3_structures" / "synth"
    af_dir.mkdir(parents=True, exist_ok=True)
    # an MRC's fastest axis is x; scenario arrays are (x, y, z)
    mrc_io.write_mrc(out / "emd_demo.mrc", np.transpose(density, (2, 1, 0)), voxel_size=1.0)
    (out / "demo.fasta").write_text(f">synth|Chains A\n{seq}\n")
    pdb_io.write_ca_pdb(af_dir / "ranked_0.pdb", [ca], res_names_by_chain=[list(seq)])
    pdb_io.write_ca_pdb(inp / "input_af3_docked.pdb", [ca], res_names_by_chain=[list(seq)])
    return ca


def run_command(out: Path, model_path: str, base_filters: int = 16,
                device: str = "cuda") -> List[str]:
    """The ``cli.run`` command line over ``build_inputs``' layout."""
    return [sys.executable, "-m", "mica_tpu_torch.cli.run",
            "-m", str(out / "emd_demo.mrc"), "-f", str(out / "demo.fasta"),
            "-i", str(out / "input"), "-o", str(out / "output"),
            "--model_path", model_path, "--base_filters", str(base_filters),
            "--device", device, "--run_pulchra"]


def ca_accuracy(model_pdb: Path, truth_ca: np.ndarray) -> Tuple[float, float]:
    """(coverage, median distance): the share of true CAs with a built CA
    within 3 A, and the median distance from a true CA to its nearest
    built one."""
    built = pdb_io.coords(pdb_io.select(pdb_io.parse_pdb(model_pdb), name="CA"))
    if len(built) == 0:
        return 0.0, float("inf")
    nearest = np.linalg.norm(truth_ca[:, None, :] - built[None, :, :], axis=-1).min(axis=1)
    return float((nearest < 3.0).mean()), float(np.median(nearest))


def outputs(out: Path) -> Tuple[Optional[Path], Optional[Path]]:
    """(CA model, all-atom model) that ``cli.run`` wrote, or None each."""
    ca = [p for p in sorted((out / "output").glob("*_ca_model.pdb")) if "init" not in p.name]
    aa = sorted((out / "output").glob("*_all_atom_model.pdb"))
    return (ca[-1] if ca else None), (aa[-1] if aa else None)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/mica_demo")
    ap.add_argument("--n_res", type=int, default=100)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--model_path", default="build/mica_synth_base16.pth",
                    help="network checkpoint (.pth as train_synth_fixture writes it, or a "
                         "cli.train .pt)")
    ap.add_argument("--base_filters", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap


def run(args: argparse.Namespace) -> dict:
    """Build the inputs, run ``cli.run`` (raises if it fails) and measure
    the CA model."""
    if not Path(args.model_path).exists():
        raise FileNotFoundError(
            f"checkpoint not found: {args.model_path}; make it with "
            "python -m mica_tpu_torch.scripts.train_synth_fixture or pass --model_path")
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    print(f"[demo] building synthetic inputs in {out} ...", flush=True)
    truth = build_inputs(out, args.n_res, (args.size,) * 3, args.seed)
    cmd = run_command(out, str(Path(args.model_path).resolve()), args.base_filters,
                      args.device)
    print("[demo] running:", " ".join(cmd), flush=True)
    t0 = time.time()
    subprocess.run(cmd, check=True, cwd=REPO)
    wall = time.time() - t0
    ca_model, all_atom = outputs(out)
    if ca_model is None or all_atom is None:
        raise RuntimeError(f"cli.run wrote no CA or all-atom model under {out / 'output'}")
    stages = {}
    for log in (out / "output").glob("time_cost_*.csv"):
        with open(log) as f:
            stages = {row["step"]: float(row["time"]) for row in csv.DictReader(f)}
    cov, med = ca_accuracy(ca_model, truth)
    print(f"\n[demo] cli.run finished in {wall:.1f} s; stages (s, as cli.run rounds them): "
          f"{stages}", flush=True)
    print(f"[demo] outputs: {ca_model}, {all_atom}", flush=True)
    print(f"[demo] CA model vs the true chain: coverage (< 3 A) {cov * 100:.1f} %, median "
          f"distance {med:.2f} A", flush=True)
    return dict(wall_s=wall, stages=stages, coverage=cov, median=med,
                ca_model=str(ca_model), all_atom_model=str(all_atom))


def main(argv: Optional[list] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
