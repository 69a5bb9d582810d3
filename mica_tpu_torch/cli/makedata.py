"""Training-data generation CLI.

For each (map, model) pair: resample and normalize the map, rasterize the
BB/CA/AA label masks and the 24-channel AF3 encoding, window everything
and keep the windows whose density max is >= 0.01
(``train.data.build_training_grids``); one packed ``.npz`` a map, which
``cli.train --data_path`` reads.

    python -m mica_tpu_torch.cli.makedata --pairs pairs.csv --output packed/

``pairs.csv`` rows: map_path,model_pdb_path[,docked_af3_pdb_path]
Single pair mode: --map ... --model ... [--docked ...]

The flags of ``mica_tpu/cli/makedata.py``, plus ``--device`` ('cuda', the
default, or 'cpu').  A pair whose files cannot be read or parsed is logged
and skipped, as there; the exit code is then 1.
"""

from __future__ import annotations

import argparse
import csv
import logging
from pathlib import Path

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate MICA training windows (PyTorch)")
    p.add_argument("--pairs", help="CSV of map_path,model_pdb[,docked_af3_pdb]")
    p.add_argument("--map", dest="map_path")
    p.add_argument("--model", dest="model_path")
    p.add_argument("--docked", dest="docked_path", default="")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--density_threshold", type=float, default=0.01)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def read_pairs(args: argparse.Namespace) -> list:
    """(map, model, docked or None) from ``--pairs`` and the single pair."""
    pairs = []
    if args.pairs:
        with open(args.pairs) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                pairs.append((row[0], row[1], row[2] if len(row) > 2 and row[2] else None))
    if args.map_path and args.model_path:
        pairs.append((args.map_path, args.model_path, args.docked_path or None))
    return pairs


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    args = build_parser().parse_args(argv)

    from ..train.data import build_training_grids

    pairs = read_pairs(args)
    if not pairs:
        logger.error("no input pairs given")
        return 1
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    total = failed = 0
    for map_path, model_path, docked in pairs:
        name = Path(map_path).stem
        try:
            ds = build_training_grids(map_path, model_path, docked,
                                      density_threshold=args.density_threshold,
                                      device=args.device)
        except (OSError, ValueError) as e:
            logger.error("failed on %s: %s", name, e)
            failed += 1
            continue
        dest = out / f"{name}.npz"
        ds.save(str(dest))
        total += len(ds)
        logger.info("%s: %d windows -> %s", name, len(ds), dest)
    logger.info("done: %d windows total, %d of %d pairs failed", total, failed, len(pairs))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
