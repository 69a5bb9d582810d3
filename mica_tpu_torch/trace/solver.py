"""The modeling solver: density map + FASTA (+ AF3) -> CA model PDB.

Counterpart of ``mica_tpu/trace/solver.py``, stages and names kept.  It
orchestrates the full post-processing pipeline (the reference's ``Solver``,
modeler.py:455-2251): sequence parsing, network prediction, candidate
extraction, fragment generation, sequence alignment (with or without AF3
templates), initial model building, gap filling, and model output, with
per-stage wall-clock accounting written to a ``time_cost_*.csv``.

The network stage runs the port's ``SlidingWindowPredictor`` on ``device``
(the card unless the caller asks for the CPU) and keeps the four volumes
there; candidate extraction reads them in place.  The all-atom rebuild and
the PHENIX refinement are not ported: asking for either raises.

Coordinate output: the reference emits ``candidate + nstart offset``
(modeler.py:1775-1779) and ignores the map origin; this solver uses the
full CCP4 convention ``(candidate + nstart) * voxel + origin`` (see
``ops.rasterize``), which is identical for origin-0 maps and correct
otherwise.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..io import fasta as fasta_io
from ..io import pdb as pdb_io
from .af3_align import AF3Aligner
from .align import TemplateFreeAligner
from .assemble import Assembler
from .candidates import Candidates, extract_candidates
from .fragments import build_fragments
from .types import ChainModel, SequenceEntry

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ModelingConfig:
    """Algorithm knobs, defaults matching run.py:46-97."""

    map_path: str = ""
    fasta_path: str = ""
    input_dir: str = ""
    output_path: str = "output"
    protocol: str = "AF3_struct"  # or 'AF3_struct_free'
    resolution: float = 3.0
    model_path: str = ""

    cluster_eps: float = 10.0
    cluster_min_points: int = 10
    nms_radius: float = 9.0  # squared radius
    ca_score_threshold: float = 0.3
    frags_len: int = 150
    n_hop: int = 6
    neigh_mat_threshold: float = 0.7
    score_threshold: float = 2.0
    # Accepted for reference-CLI compatibility but inert, exactly as in the
    # reference: run.py:96 parses --gap_len and modeler.py never reads it.
    gap_len: int = 3
    struct_len: int = 5
    # Accepted for compatibility (reference seeds torch with it, run.py:115);
    # this pipeline has no RNG anywhere — deterministic by construction.
    seed: int = 2022

    # Coordinate convention for emitted PDBs: "ccp4" (default) writes
    # (candidate + nstart) * voxel + origin; "reference" reproduces the
    # reference byte-for-byte — candidate + nstart, ignoring voxel size
    # and map origin (modeler.py:1775-1779) — so a real-artifact run can
    # diff final models directly on nonzero-origin maps.
    coord_mode: str = "ccp4"

    run_pulchra: bool = False
    # Random weights produce a garbage model; a production run must load a
    # trained checkpoint or opt in explicitly (tests/benchmarks set this).
    allow_random_weights: bool = False
    pulchra_path: str = ""
    run_phenix: bool = False
    phenix_act: str = ""
    phenix_param: str = ""

    batch_size: int = 0  # 0 = derive from device memory (auto_batch_size)
    base_filters: int = 64
    window_core: int = 48   # 0 = auto (best_core for the map shape; NOTE:
    window_halo: int = 8    # non-default geometry shifts InstanceNorm
                            # window stats vs the reference's fixed 64/48)
    dtype: torch.dtype = torch.bfloat16  # network compute dtype
    device: Optional[str] = None  # None = the card (raises without one); "cpu"

    @property
    def af3_structures_path(self) -> str:
        return str(Path(self.input_dir) / "AF3_structures")

    @property
    def docked_model_path(self) -> str:
        name = Path(self.input_dir).name
        return str(Path(self.input_dir) / f"{name}_af3_docked.pdb")


NOT_PORTED = ("the all-atom rebuild (--run_pulchra, mica_tpu/tools/allatom.py) and the "
              "PHENIX refinement (--run_phenix, mica_tpu/tools/phenix.py) are not ported to "
              "mica_tpu_torch yet; this package writes the CA model only")


class Solver:
    def __init__(self, config: ModelingConfig, params=None):
        """``params``: a ``MICA`` module, a torch state dict or a JAX
        parameter tree; None with ``allow_random_weights`` draws weights
        from ``config.seed``."""
        if config.run_pulchra or config.run_phenix:
            raise NotImplementedError(NOT_PORTED)
        self.config = config
        self.params = params
        self.method_name = (
            "MICA" if config.protocol == "AF3_struct" else "MICA_TempFree"
        )
        self.map_id = Path(config.map_path).stem.replace("emd_", "") or "map"
        self.pdb_id = Path(config.fasta_path).stem or "model"
        self.entries: List[SequenceEntry] = []
        self.cands: Optional[Candidates] = None
        self.prepared = None
        self.volumes: Dict[str, np.ndarray] = {}
        self.time_cost: Dict[str, float] = {}
        self.extraction_stats: Dict[str, float] = {}
        self.predictor_timing: Dict[str, float] = {}
        self.fragments: List[List[int]] = []
        out = Path(config.output_path)
        out.mkdir(parents=True, exist_ok=True)
        self.ca_model_path = str(
            out / f"{self.map_id}_{self.pdb_id}_{self.method_name}_ca_model.pdb"
        )
        self.init_model_path = str(
            out / f"{self.map_id}_{self.pdb_id}_{self.method_name}(init)_ca_model.pdb"
        )
        self.time_log = str(
            out / f"time_cost_{self.map_id}_{self.pdb_id}_{self.method_name}.csv"
        )

    # ==================================================================
    def run(self) -> str:
        res = self.check_seq()
        if res != "success":
            return res
        self.predict()
        return self.model_from_volumes()

    def model_from_volumes(self) -> str:
        """Every stage after the network, from ``self.volumes`` (predicted,
        or injected with ``set_volumes``) to the CA model and the time log."""
        self._timed("clustering", self._clustering)
        self._timed("fragModeling", self.frag_modeling)
        if self.config.protocol == "AF3_struct":
            self._timed("seqStructAlignWithAF3Structure", self.align_af3)
        else:
            ok = self._timed("seqStructureAlign", self.align_template_free)
            if not ok:
                return "seqStructureAlign error! this case is too hard!"
        self._timed("initialModelBuilding", self.build_initial)
        self._timed("gapFilling", self.fill_gaps)

        self.time_record()
        return "success"

    def _timed(self, name, fn):
        t0 = time.time()
        out = fn()
        self.time_cost[name] = time.time() - t0
        logger.info("%s completed in %.2fs", name, self.time_cost[name])
        return out

    # ==================================================================
    def check_seq(self) -> str:
        """Parse FASTA and (optionally) AF3 template structures."""
        if not Path(self.config.fasta_path).exists():
            return "fasta not found!"
        parsed = fasta_io.parse_fasta(self.config.fasta_path)
        if not parsed:
            return "Error in parse fasta, terminated!"
        missing = []
        for f in parsed:
            entry = SequenceEntry(name=f.name, sequence=f.sequence)
            if self.config.protocol == "AF3_struct":
                af3_path = Path(self.config.af3_structures_path) / f.name / "ranked_0.pdb"
                if af3_path.exists():
                    atoms = pdb_io.parse_pdb(af3_path)
                    first_chain = pdb_io.chains(atoms)[0]
                    ca = pdb_io.select(atoms, name="CA", chain=first_chain)
                    entry.af3_coords = pdb_io.coords(ca).astype(np.float64)
                    # the template's residue sequence replaces the FASTA one
                    # (modeler.py:438-448)
                    entry.sequence = "".join(
                        pdb_io.THREE_TO_ONE.get(r, "A") for r in ca["res_name"]
                    )
                else:
                    missing.append(f.name)
            for cid in f.chain_ids:
                entry.chains[cid] = ChainModel(chain_id=cid, length=len(entry.sequence))
            self.entries.append(entry)
        if missing:
            return (
                f"Structures not found for {missing}, "
                "Check your directory of AF3 structures!"
            )
        for e in self.entries:
            logger.info("sequence %s: %d res, chains %s", e.name, len(e),
                        list(e.chains))
        return "success"

    # ==================================================================
    def nn_process(self) -> None:
        """Map preprocessing + network prediction + candidate extraction."""
        self.predict()
        self._timed("clustering", self._clustering)

    def predict(self) -> None:
        """Map preprocessing and network prediction; the volumes stay on
        the predictor's device."""
        from ..infer.engine import SlidingWindowPredictor, auto_batch_size, best_core
        from ..infer.pipeline import build_af3_encoding, prepare_map

        t0 = time.time()
        self.prepared = prepare_map(self.config.map_path, device=self.config.device)
        encoding = None
        docked = self.config.docked_model_path
        if Path(docked).exists():
            encoding = build_af3_encoding(self.prepared, docked)
        self.time_cost["getData"] = time.time() - t0

        t0 = time.time()
        if self.params is None:
            if not self.config.allow_random_weights:
                raise RuntimeError(
                    "no network checkpoint loaded (--model_path); refusing to "
                    "produce a model from random weights. Pass "
                    "--allow_random_weights to override (tests/smoke runs only)."
                )
            from ..models.mica import MICA

            logger.warning("no network checkpoint loaded; using random weights")
            self.params = MICA(base=self.config.base_filters).init_weights(
                torch.Generator().manual_seed(self.config.seed))

        core, halo = self.config.window_core, self.config.window_halo
        batch = self.config.batch_size or auto_batch_size(device=self.config.device)
        if core == 0:
            core, batch = best_core(self.prepared.volume.shape, halo,
                                    max_batch=batch)
            logger.info("auto window geometry: core=%d (window=%d) batch=%d",
                        core, core + 2 * halo, batch)
        predictor = SlidingWindowPredictor(
            self.params,
            batch_size=batch,
            dtype=self.config.dtype,
            base_filters=self.config.base_filters,
            core=core, halo=halo,
            device=self.config.device,
        )
        out = predictor.predict_volume(
            self.prepared.volume, encoding, keep_on_device=True
        )
        # every volume stays on the device: candidate extraction runs there
        # (candidates_device.py) and only O(candidates) values reach the
        # host; the CA volume is materialized lazily iff the AF3 aligner
        # needs its pointwise integrals (align_af3)
        self.volumes = dict(out)
        self.predictor_timing = dict(predictor.timing)
        self.time_cost["nnPred"] = time.time() - t0

    def set_volumes(self, volumes: Dict, prepared=None) -> None:
        """Inject precomputed prediction volumes, numpy arrays or tensors
        (for tests / replays)."""
        self.volumes = volumes
        self.prepared = prepared

    def _clustering(self) -> None:
        vols = self.volumes
        on_device = isinstance(vols["carbon_alpha_probability"], torch.Tensor)
        if on_device:
            # on the volumes' device; only O(candidates) data crosses the
            # device->host link (morphology clustering semantics —
            # candidates_device.py)
            from .candidates import build_neighbor_structure
            from .candidates_device import extract_candidates_device

            d = extract_candidates_device(
                vols["carbon_alpha_probability"],
                vols["backbone_probability"],
                vols["amino_acid_probability"],
                ca_score_threshold=self.config.ca_score_threshold,
                cluster_eps=self.config.cluster_eps,
                nms_radius_sq=self.config.nms_radius,
                stats=self.extraction_stats,
            )
            if d is not None:
                self.cands = build_neighbor_structure(
                    d["coords"], d["aa"], d["pred"],
                    vols["backbone_probability"],
                )
                logger.info("candidates: %d (device extraction)",
                            len(self.cands))
                return
            logger.info("device extraction unavailable; falling back to "
                        "the host pipeline")
            for k in ("carbon_alpha_probability", "backbone_probability",
                      "amino_acid_prediction"):
                vols[k] = vols[k].cpu().numpy()
        self.cands = extract_candidates(
            vols["carbon_alpha_probability"],
            vols["backbone_probability"],
            vols["amino_acid_probability"],
            vols["amino_acid_prediction"],
            ca_score_threshold=self.config.ca_score_threshold,
            cluster_eps=self.config.cluster_eps,
            cluster_min_points=self.config.cluster_min_points,
            nms_radius_sq=self.config.nms_radius,
        )
        logger.info("candidates: %d", len(self.cands))

    # ==================================================================
    def frag_modeling(self) -> None:
        self.fragments = build_fragments(self.cands, self.config.frags_len)

    def align_af3(self) -> None:
        # the AF3 aligner's CA integrals are many small pointwise host
        # lookups — materialize the volume on host once, here only
        ca = self.volumes["carbon_alpha_probability"]
        if isinstance(ca, torch.Tensor):
            ca = ca.cpu().numpy()
            self.volumes["carbon_alpha_probability"] = ca
        aligner = AF3Aligner(
            self.entries, self.cands,
            ca,
            n_hop=self.config.n_hop, struct_len=self.config.struct_len,
            neigh_mat_threshold=self.config.neigh_mat_threshold,
        )
        aligner.run()
        self._aligner = aligner

    def align_template_free(self) -> bool:
        aligner = TemplateFreeAligner(
            self.entries, self.cands, n_hop=self.config.n_hop,
            score_threshold=self.config.score_threshold,
        )
        ok = aligner.run()
        self._aligner = aligner
        return ok

    def build_initial(self) -> None:
        self.assembler = Assembler(
            self.entries, self.cands,
            self._aligner.seq_cand_aa_mat, self._aligner.n_hop_mat,
            protocol=self.config.protocol,
        )
        self.assembler.build_initial_model()
        self._write_model(self.init_model_path, dedupe=False)

    def fill_gaps(self) -> None:
        self.assembler.fill_gaps()
        self._write_model(self.ca_model_path, dedupe=True)

    # ==================================================================
    def _cand_world_coords(self, cand: int) -> np.ndarray:
        c = self.cands.coords[cand]
        if self.prepared is None:
            return c
        if self.config.coord_mode == "reference":
            # reference-exact output: candidate + nstart, no voxel
            # scaling, no origin (modeler.py:1775-1779)
            return np.asarray(c, np.float64) + np.asarray(
                self.prepared.offset, np.float64)
        return self.prepared.voxel_to_world(c)

    def _write_model(self, path: str, dedupe: bool) -> None:
        lines = []
        atom_ix = 0
        seen: set = set()
        for entry in self.entries:
            for chain_id, chain in entry.chains.items():
                for seq_id, cand in enumerate(chain.result):
                    if cand == -1 or (dedupe and cand in seen):
                        continue
                    seen.add(int(cand))
                    atom_ix += 1
                    res3 = pdb_io.ONE_TO_THREE.get(entry.sequence[seq_id], "ALA")
                    xyz = self._cand_world_coords(int(cand))
                    lines.append(
                        pdb_io.format_atom_line(
                            atom_ix, "CA", res3, chain_id, seq_id + 1, xyz,
                            1.0, 0.0, "C",
                        )
                    )
        lines.append("END")
        Path(path).write_text("\n".join(lines) + "\n")
        logger.info("wrote %s (%d atoms)", path, atom_ix)

    def time_record(self) -> None:
        with open(self.time_log, "w") as w:
            w.write("step,time\n")
            for k, v in self.time_cost.items():
                w.write(f"{k},{round(v)}\n")
