"""Prediction CLI: map -> BB/CA/AA probability volumes (MRC).

    python -m mica_tpu_torch.cli.predict -m map.mrc -o out/ [--model_checkpoint ck.pth]

Flag-compatible with ``mica_tpu/cli/predict.py``, plus ``--device``.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MICA sliding-window prediction (PyTorch)")
    p.add_argument("-m", "--map_path", required=True, nargs="+",
                   help="one or more density maps; with several, the predictor "
                        "is reused and each map's volumes land in "
                        "<output_path>/<map_stem>/")
    p.add_argument("-o", "--output_path", required=True)
    p.add_argument("--docked_model", default="",
                   help="docked AF3 model (single-map mode only)")
    p.add_argument("--model_checkpoint", default="",
                   help="original-format .pth checkpoint; random weights if empty")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--base_filters", type=int, default=64,
                   help="network width (MICA: 64)")
    p.add_argument("--window_core", type=int, default=48,
                   help="sliding-window core (MICA: 48); 0 = auto")
    p.add_argument("--float32", action="store_true",
                   help="run the network in float32 instead of bfloat16 (library "
                        "convs, TF32 off, on the card or the CPU)")
    p.add_argument("--npz_dir", default="",
                   help="per-grid .npz artifacts (not available in this port yet)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    p = build_parser()
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ..infer.pipeline import predict_map
    from ..io import mrc as mrc_io
    from ..models.convert import load_checkpoint
    from ..models.mica import MICA

    if args.npz_dir:
        p.error("--npz_dir (per-grid artifacts) is not available in the PyTorch port yet")
    maps = list(args.map_path)
    if len(maps) > 1 and args.docked_model:
        p.error("--docked_model applies to a single map; run maps with "
                "docked models individually")

    if args.model_checkpoint:
        if not args.model_checkpoint.endswith(".pth"):
            p.error("the PyTorch port reads original-format .pth checkpoints")
        params = load_checkpoint(args.model_checkpoint)
    else:
        logging.warning("no checkpoint given; using random weights (seed 0)")
        params = MICA(base=args.base_filters).init_weights(
            torch.Generator().manual_seed(0))

    predictor = None
    for map_path in maps:
        out = predict_map(
            map_path, params,
            docked_pdb_path=args.docked_model or None,
            batch_size=args.batch_size,
            base_filters=args.base_filters,
            core=args.window_core,
            dtype=torch.float32 if args.float32 else torch.bfloat16,
            predictor=predictor,
            device=args.device,
        )
        predictor = out["predictor"]
        prepared = out["prepared_map"]
        outdir = Path(args.output_path)
        if len(maps) > 1:
            outdir = outdir / Path(map_path).stem
        outdir.mkdir(parents=True, exist_ok=True)
        for key in ("backbone_probability", "carbon_alpha_probability",
                    "amino_acid_prediction"):
            vol = np.asarray(out[key], np.float32)
            mrc_io.write_mrc(
                outdir / f"{key}.mrc", np.transpose(vol, (2, 1, 0)),
                voxel_size=prepared.voxel_size, origin=tuple(prepared.origin),
                nstart=tuple(int(v) for v in prepared.offset),
            )
        np.savez_compressed(outdir / "amino_acid_probability.npz",
                            data=out["amino_acid_probability"].astype(np.float16))
        logging.info("%s timing: %s", Path(map_path).name, out["timing"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
