"""AlphaFold3 result processing: CIF -> PDB, chain splits, domain splits.

Port of ``mica_tpu/prep/af3_results.py`` (the original's
utils/process_AF3_results.py):

  * discover ``<AF3_results>/*/*_model_0.cif``, convert to PDB with chains
    renamed into the 62-symbol PDB chain alphabet (``OutOfChainsError``
    beyond 62);
  * write ``AF3_PDBs/<name>.pdb`` and extract the first chain of each
    structure to ``AF3_structures/<protein_id>/ranked_0.pdb`` for the
    modelling engine;
  * split every PDB into per-chain files under ``AF3_chains/``;
  * split chains into domains under ``AF3_domains/`` with Merizo
    (``models.merizo``, on the card unless ``device`` says otherwise) when
    its weight shards are found, else with the geometric segmenter
    (``models.segmenter.segment_domains``).  Unlike the JAX package, an
    error of the network is raised, not answered with the geometric
    segmenter; only a network that finds no domain hands over to it.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..io import cif as cif_io
from ..io import pdb as pdb_io

logger = logging.getLogger(__name__)


class OutOfChainsError(Exception):
    """More than 62 chains — unrepresentable in single-char PDB chain IDs."""


def int_to_chain(i: int, base: int = 62) -> str:
    """0->A, 25->Z, 26->a, 51->z, 52->0, 61->9."""
    if i < 0 or base > 62:
        raise ValueError(f"bad chain index {i}")
    if i >= base:
        raise OutOfChainsError(f"chain index {i} >= {base}")
    return pdb_io.CHAIN_IDS[i]


def rename_chains(atoms: np.ndarray) -> Dict[str, str]:
    """Rename chains into the 62-ID space, preserving IDs already valid."""
    chains = pdb_io.chains(atoms)
    if len(chains) > 62:
        raise OutOfChainsError(f"{len(chains)} chains")

    def valid(c):  # single-char member (NOT substring: "AB" in CHAIN_IDS is True)
        return len(c) == 1 and c in pdb_io.CHAIN_IDS

    used = set(c for c in chains if valid(c))
    mapping: Dict[str, str] = {}
    next_ix = 0
    for c in chains:
        if valid(c) and c not in mapping.values():
            mapping[c] = c
            continue
        while next_ix < 62 and pdb_io.CHAIN_IDS[next_ix] in used:
            next_ix += 1
        if next_ix >= 62:
            raise OutOfChainsError("no chain IDs left")
        mapping[c] = pdb_io.CHAIN_IDS[next_ix]
        used.add(pdb_io.CHAIN_IDS[next_ix])
    new = atoms.copy()
    for old, newid in mapping.items():
        new["chain"][atoms["chain"] == old] = newid
    atoms["chain"] = new["chain"]
    return mapping


def process_af3_results(af3_results_dir: str,
                        split_domains: bool = True,
                        min_domain_size: int = 50,
                        device=None) -> Dict[str, list]:
    """Full AF3 result processing pipeline; ``device`` is Merizo's (None:
    the card).

    Returns {"converted": [...], "failed": [...], "chains": [...],
    "domains": [...]}.
    """
    af3_results = Path(af3_results_dir)
    parent = af3_results.parent
    pdb_dir = parent / "AF3_PDBs"
    structures_dir = parent / "AF3_structures"
    chains_dir = parent / "AF3_chains"
    domains_dir = parent / "AF3_domains"
    for d in (pdb_dir, structures_dir, chains_dir):
        d.mkdir(parents=True, exist_ok=True)

    converted, failed, chain_files, domain_files = [], [], [], []
    cif_files = sorted(af3_results.glob("*/*_model_0.cif"))
    if not cif_files:
        logger.error("no AF3 structures found in %s (expected */*_model_0.cif)",
                     af3_results)
    for cif_file in cif_files:
        try:
            atoms = cif_io.parse_cif_atoms(cif_file)
            if len(atoms) == 0:
                raise ValueError("no atoms parsed")
            rename_chains(atoms)
            name = cif_file.stem
            pdb_path = pdb_dir / f"{name}.pdb"
            pdb_io.write_pdb(pdb_path, atoms)
            converted.append(str(pdb_path))

            # first chain -> AF3_structures/<protein_id>/ranked_0.pdb
            protein_id = cif_file.parent.name
            first = pdb_io.chains(atoms)[0]
            sdir = structures_dir / protein_id
            sdir.mkdir(parents=True, exist_ok=True)
            pdb_io.write_pdb(sdir / "ranked_0.pdb",
                             pdb_io.select(atoms, chain=first))

            # per-chain splits
            for c in pdb_io.chains(atoms):
                cpath = chains_dir / f"{name}_chain_{c}.pdb"
                pdb_io.write_pdb(cpath, pdb_io.select(atoms, chain=c))
                chain_files.append(str(cpath))
        except Exception as e:
            logger.error("failed to convert %s: %s", cif_file.name, e)
            failed.append(str(cif_file))

    if split_domains and chain_files:
        domains_dir.mkdir(parents=True, exist_ok=True)
        for cf in chain_files:
            domain_files.extend(
                split_chain_into_domains(cf, str(domains_dir), min_domain_size,
                                         device=device)
            )

    return {
        "converted": converted, "failed": failed,
        "chains": chain_files, "domains": domain_files,
    }


def find_merizo_weights() -> str | None:
    """Locate Merizo's weight shards: ``$MICA_MERIZO_WEIGHTS``, or a
    ``merizo_weights/`` directory at the root of the repository (where the
    original ships them as modules/merizo/weights/)."""
    import os

    for cand in (os.environ.get("MICA_MERIZO_WEIGHTS"),
                 str(Path(__file__).resolve().parents[2] / "merizo_weights")):
        if cand and Path(cand).is_dir() and list(Path(cand).glob("*.pt")):
            return cand
    return None


def split_chain_into_domains(chain_pdb: str, out_dir: str,
                             min_domain_size: int = 50, device=None) -> List[str]:
    """Split one chain PDB into per-domain PDBs.

    Merizo (``models.merizo.segment_chain_atoms`` on ``device``, None: the
    card) when its shards are found and the chain has ``min_domain_size``
    CAs or more; the geometric partitioner when the shards are absent or
    the network finds no domain.  An error of the network raises."""
    from ..models.segmenter import segment_chain_pdb

    atoms = pdb_io.parse_pdb(chain_pdb)
    ca = pdb_io.select(atoms, name="CA", standard_aa=True)
    if len(ca) < min_domain_size:
        # too short to split: single domain file
        out = Path(out_dir) / (Path(chain_pdb).stem + "_domain_0.pdb")
        pdb_io.write_pdb(out, atoms)
        return [str(out)]

    weights_dir = find_merizo_weights()
    seg_res_ids = ca["res_id"].astype(np.int64)
    domain_ids = None
    if weights_dir is not None:
        from ..models import merizo

        # no confidence gate by default, as in the original's predict script
        ids, mz_res_ids = merizo.segment_chain_atoms(atoms, weights_dir, device=device)
        if (ids > 0).any():
            # merizo ids: 0 = background -> excluded; shift to 0-based
            domain_ids = ids.astype(np.int64) - 1
            seg_res_ids = mz_res_ids
        else:
            logger.warning("learned segmenter found no domains; using geometric")
    if domain_ids is None:
        domain_ids = segment_chain_pdb(atoms, min_domain_size=min_domain_size)
    outs = []
    for dom in np.unique(domain_ids):
        if dom < 0:
            continue
        res_ids = set(seg_res_ids[domain_ids == dom].tolist())
        sel = atoms[np.isin(atoms["res_id"], list(res_ids))]
        out = Path(out_dir) / (Path(chain_pdb).stem + f"_domain_{int(dom)}.pdb")
        pdb_io.write_pdb(out, sel)
        outs.append(str(out))
    return outs
