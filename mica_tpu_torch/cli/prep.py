"""Preparation CLIs: FASTA->AF3 JSON, AF3 result processing, docking, EMDB.

Port of ``mica_tpu/cli/prep.py``, the same subcommands and flags, plus
``--device`` on ``af3-results`` (where Merizo runs; default the card):

  python -m mica_tpu_torch.cli.prep af3-json -f seq.fasta -i inputdir
  python -m mica_tpu_torch.cli.prep af3-results -a inputdir/AF3_results
  python -m mica_tpu_torch.cli.prep dock -m map.mrc -i inputdir [...]
  python -m mica_tpu_torch.cli.prep emdb -e 15635

``af3-results`` splits domains with Merizo when its weight shards are in
``$MICA_MERIZO_WEIGHTS`` or ``merizo_weights/`` at the repository's root,
else with the geometric segmenter.
"""

from __future__ import annotations

import argparse
import json
import logging
from glob import glob
from pathlib import Path


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    p = argparse.ArgumentParser(description="MICA data preparation tools (PyTorch)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pj = sub.add_parser("af3-json", help="FASTA -> AF3 server JSON")
    pj.add_argument("-f", "--fasta_path", required=True)
    pj.add_argument("-i", "--input_dir", required=True)

    pr = sub.add_parser("af3-results", help="process AF3 CIF results")
    pr.add_argument("-a", "--AF3_results", required=True)
    pr.add_argument("--no_domains", action="store_true")
    pr.add_argument("--device", default="cuda",
                    help="where Merizo runs: 'cuda' (default) or 'cpu'")

    pd = sub.add_parser("dock", help="dock AF3 domains into the map (PHENIX)")
    pd.add_argument("-m", "--map_path", required=True)
    pd.add_argument("-i", "--input_dir", required=True)
    pd.add_argument("--resolution", type=float, required=True)
    pd.add_argument("--contour_level", type=float, required=True)
    pd.add_argument("--phenix_env", default="")
    pd.add_argument("--sequence", default="")
    pd.add_argument("--use_chains", action="store_true",
                    help="dock whole chains instead of domains")
    pd.add_argument("--dry_run", action="store_true")

    pe = sub.add_parser("emdb", help="fetch EMDB contour level + resolution")
    pe.add_argument("-e", "--emdb_id", required=True)

    args = p.parse_args(argv)

    if args.cmd == "af3-json":
        from ..prep.af3_json import convert_fasta_to_af3_json

        files = convert_fasta_to_af3_json(args.fasta_path, args.input_dir)
        return 0 if files else 1

    if args.cmd == "af3-results":
        from ..prep.af3_results import process_af3_results

        res = process_af3_results(args.AF3_results, split_domains=not args.no_domains,
                                  device=args.device)
        print(json.dumps({k: len(v) for k, v in res.items()}))
        return 0 if res["converted"] or not res["failed"] else 1

    if args.cmd == "dock":
        from ..prep.dock import dock_structures

        src = Path(args.input_dir) / (
            "AF3_chains" if args.use_chains else "AF3_domains"
        )
        models = sorted(glob(str(src / "*.pdb")))
        if not models:
            logging.error("no models found under %s", src)
            return 1
        res = dock_structures(
            args.map_path, models, args.resolution, args.contour_level,
            str(Path(args.input_dir) / "docking_work"),
            phenix_env=args.phenix_env, sequence_path=args.sequence,
            output_name=f"{Path(args.input_dir).name}_af3_docked.pdb",
            dry_run=args.dry_run,
        )
        print(json.dumps({"docked": len(res["docked"]),
                          "merged": res["merged"],
                          "commands": len(res["commands"])}))
        return 0

    if args.cmd == "emdb":
        from ..prep.emdb import extract_map_info

        info = extract_map_info(args.emdb_id)
        if info is None:
            print(json.dumps({"error": "lookup failed"}))
            return 1
        print(json.dumps({"contour_level": info[0], "resolution": info[1]}))
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
