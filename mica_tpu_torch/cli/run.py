"""Main pipeline CLI: map + FASTA + AF3 inputs -> CA model PDB.

    python -m mica_tpu_torch.cli.run -m map.mrc -f seq.fasta -i inputdir [-o out]

The flags of ``mica_tpu/cli/run.py``, plus ``--device`` ('cuda', the
default, or 'cpu') and ``--float32`` as in the port's other CLIs.  The
all-atom rebuild and the PHENIX refinement are not ported: ``--run_pulchra``
and ``--run_phenix`` are parsed and refused with an error that says so.
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="MICA (PyTorch): cryo-EM protein structure determination"
    )
    p.add_argument("-m", "--map_path", required=True, help="cryo-EM density map")
    p.add_argument("-f", "--fasta_path", required=True, help="FASTA sequence file")
    p.add_argument("-i", "--input_path", "--input_dir", dest="input_dir",
                   required=True,
                   help="input directory (AF3_results, AF3_structures, docked model)")
    p.add_argument("-o", "--output_path", default="output")
    p.add_argument("--protocol", default="AF3_struct",
                   choices=["AF3_struct", "AF3_struct_free"])
    p.add_argument("-r", "--resolution", type=float, default=3.0)
    p.add_argument("--model_path", "--model_checkpoint",
                   dest="model_checkpoint", default="",
                   help="MICA network checkpoint (original-format .pth)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--float32", action="store_true",
                   help="run the network in float32 instead of bfloat16 (library "
                        "convs, TF32 off, on the card or the CPU)")
    # reference drop-in compatibility: accepted, inert here (no fork pools;
    # the pipeline is deterministic — reference run.py:78-84)
    p.add_argument("--no_parallel", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--quiet", action="store_true",
                   help="reduce logging verbosity")
    p.add_argument("--mul_proc_num", type=int, default=1, help=argparse.SUPPRESS)
    # algorithm knobs (defaults = reference run.py:46-97)
    p.add_argument("--cluster_eps", type=float, default=10)
    p.add_argument("--cluster_min_points", type=int, default=10)
    p.add_argument("--nms_radius", type=float, default=9)
    p.add_argument("--CA_score_thrh", type=float, default=0.3)
    p.add_argument("--frags_len", type=int, default=150)
    p.add_argument("--n_hop", type=int, default=6)
    p.add_argument("--neigh_mat_thrh", type=float, default=0.7)
    p.add_argument("--score_thrh", type=float, default=2)
    p.add_argument("--gap_len", type=int, default=3)
    p.add_argument("--struct_len", type=int, default=5)
    p.add_argument("--seed", type=int, default=2022)
    p.add_argument("--batch_size", type=int, default=0,
                   help="0 = derive from device memory (auto_batch_size)")
    p.add_argument("--base_filters", type=int, default=64,
                   help="network width (reference MICA: 64)")
    p.add_argument("--window_core", type=int, default=48,
                   help="sliding-window core size (reference: 48, window "
                        "64). 0 = auto-pick the geometry minimizing "
                        "computed voxels for this map; per-window "
                        "InstanceNorm stats then differ slightly from the "
                        "reference's fixed decomposition")
    p.add_argument("--allow_random_weights", action="store_true",
                   help="run without a trained checkpoint (random weights; "
                        "smoke tests only — the output model is meaningless)")
    p.add_argument("--coord_mode", default="ccp4",
                   choices=("ccp4", "reference"),
                   help="PDB coordinate convention: 'ccp4' = (cand + "
                        "nstart)*voxel + origin (correct for nonzero-origin "
                        "maps); 'reference' = cand + nstart, byte-compatible "
                        "with the reference's modeler.py:1775-1779")
    # external tools: parsed for compatibility, refused until they are ported
    p.add_argument("--run_pulchra", action="store_true",
                   help="all-atom rebuild (not ported yet: raises)")
    p.add_argument("--pulchra_path", default="")
    p.add_argument("--run_phenix", action="store_true",
                   help="PHENIX refinement (not ported yet: raises)")
    p.add_argument("--phenix_act", default="")
    p.add_argument("--phenix_param", default="")
    return p


def load_network_params(checkpoint: str):
    if not checkpoint:
        return None
    if not checkpoint.endswith(".pth"):
        raise ValueError("the PyTorch port reads original-format .pth checkpoints, "
                         f"got {checkpoint!r}")
    from ..models.convert import load_checkpoint

    return load_checkpoint(checkpoint)


def build_solver(args: argparse.Namespace):
    """The ``Solver`` for parsed flags, its checkpoint loaded."""
    import torch

    from ..trace.solver import ModelingConfig, Solver

    cfg = ModelingConfig(
        map_path=args.map_path,
        fasta_path=args.fasta_path,
        input_dir=args.input_dir,
        output_path=args.output_path,
        protocol=args.protocol,
        resolution=args.resolution,
        model_path=args.model_checkpoint,
        cluster_eps=args.cluster_eps,
        cluster_min_points=args.cluster_min_points,
        nms_radius=args.nms_radius,
        ca_score_threshold=args.CA_score_thrh,
        frags_len=args.frags_len,
        n_hop=args.n_hop,
        neigh_mat_threshold=args.neigh_mat_thrh,
        score_threshold=args.score_thrh,
        gap_len=args.gap_len,
        struct_len=args.struct_len,
        seed=args.seed,
        batch_size=args.batch_size,
        base_filters=args.base_filters,
        window_core=args.window_core,
        allow_random_weights=args.allow_random_weights,
        coord_mode=args.coord_mode,
        run_pulchra=args.run_pulchra,
        pulchra_path=args.pulchra_path,
        run_phenix=args.run_phenix,
        phenix_act=args.phenix_act,
        phenix_param=args.phenix_param,
        dtype=torch.float32 if args.float32 else torch.bfloat16,
        device=args.device,
    )
    return Solver(cfg, params=load_network_params(args.model_checkpoint))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.WARNING if args.quiet else logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    result = build_solver(args).run()
    if result != "success":
        logging.error(result)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
