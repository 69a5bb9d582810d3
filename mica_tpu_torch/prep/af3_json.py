"""FASTA -> AlphaFold3-server JSON conversion.

The port's own copy of ``mica_tpu/prep/af3_json.py`` (the original's
utils/fasta_to_AF3_json.py): one JSON per protein entry, ``proteinChain``
entries in the AF3-server dialect.  DNA/RNA/X-only/short sequences are
skipped; ``X`` residues are removed from submitted sequences.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import List, Optional

from ..io.fasta import FastaEntry, parse_fasta

logger = logging.getLogger(__name__)


def entry_to_af3_json(entry: FastaEntry) -> Optional[list]:
    """One FASTA entry -> AF3 server JSON payload (list of one job).

    X residues are REMOVED from the submitted sequence (the reference's
    fasta_to_AF3_json.py behavior) — they must come from the raw
    sequence, since parse_fasta rewrites non-protein letters to A for
    the modeler's alphabet."""
    src = entry.raw_sequence or entry.sequence
    cleaned = src.replace("X", "").replace("x", "")
    if not cleaned or len(cleaned) < 2:
        return None
    if set(cleaned).issubset(set("AGCT")) or set(cleaned).issubset(set("AGCU")):
        return None
    sequences = [
        {"proteinChain": {"id": cid, "sequence": cleaned, "count": 1}}
        for cid in entry.chain_ids
    ]
    if not sequences:
        sequences = [{"proteinChain": {"id": "A", "sequence": cleaned, "count": 1}}]
    return [
        {
            "name": entry.name,
            "modelSeeds": [],
            "sequences": sequences,
            "dialect": "alphafold3",
            "version": 1,
        }
    ]


def convert_fasta_to_af3_json(fasta_path: str, input_dir: str,
                              base_name: Optional[str] = None) -> List[str]:
    """Write one AF3 JSON per protein under <input_dir>/<base>/AF3_JSON/."""
    base = base_name or Path(fasta_path).stem
    out_dir = Path(input_dir) / base / "AF3_JSON"
    out_dir.mkdir(parents=True, exist_ok=True)
    (Path(input_dir) / base / "AF3_results").mkdir(parents=True, exist_ok=True)

    generated = []
    for entry in parse_fasta(fasta_path):
        payload = entry_to_af3_json(entry)
        if payload is None:
            logger.warning("skipping %s (not a protein sequence)", entry.name)
            continue
        path = out_dir / f"{entry.name}.json"
        path.write_text(json.dumps(payload, indent=2))
        generated.append(str(path))
        logger.info("wrote %s", path)
    logger.info(
        "generated %d AF3 JSON files; upload them to the AlphaFold3 server "
        "and place results under %s", len(generated),
        Path(input_dir) / base / "AF3_results",
    )
    return generated
