"""Lightweight structured-array PDB reader (numpy only).

The port's own copy of the part of ``mica_tpu/io/pdb.py`` that the
prediction path needs: ``parse_pdb`` and the channel tables that
``ops.rasterize`` builds the 24-channel AF3 encoding from.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import numpy as np

# The 20 standard amino acids, in the channel order of the AF3 encoding
# (channels 4..23).
AMINO_ACIDS: List[str] = [
    "ALA", "CYS", "ASP", "GLU", "PHE",
    "GLY", "HIS", "ILE", "LYS", "LEU",
    "MET", "ASN", "PRO", "GLN", "ARG",
    "SER", "THR", "VAL", "TRP", "TYR",
]
AA_INDEX = {name: i for i, name in enumerate(AMINO_ACIDS)}

BACKBONE_ATOMS: List[str] = ["CA", "N", "C", "O"]

ATOM_DTYPE = np.dtype(
    [
        ("serial", np.int32),
        ("name", "U4"),
        ("altloc", "U1"),
        ("res_name", "U3"),
        ("chain", "U4"),
        ("res_id", np.int32),
        ("icode", "U1"),
        ("x", np.float32),
        ("y", np.float32),
        ("z", np.float32),
        ("occupancy", np.float32),
        ("bfactor", np.float32),
        ("element", "U2"),
        ("hetero", np.bool_),
    ]
)


def parse_pdb(
    path_or_text: Union[str, Path],
    model: Optional[int] = 1,
    include_hetero: bool = False,
) -> np.ndarray:
    """Parse a PDB file (or raw text) into a structured atom array.

    Only the first MODEL is kept by default.
    """
    if isinstance(path_or_text, Path) or (
        isinstance(path_or_text, str) and "\n" not in path_or_text
    ):
        text = Path(path_or_text).read_text()
    else:
        text = path_or_text

    rows = []
    current_model = 1
    seen_model_record = False
    for line in text.splitlines():
        rec = line[:6]
        if rec.startswith("MODEL"):
            try:
                current_model = int(line[10:14])
            except ValueError:
                current_model = (current_model + 1) if seen_model_record else 1
            seen_model_record = True
            continue
        if rec.startswith("ENDMDL"):
            if model is not None and current_model >= model:
                break
            continue
        is_atom = rec == "ATOM  "
        is_het = rec == "HETATM"
        if not (is_atom or (is_het and include_hetero)):
            continue
        if model is not None and seen_model_record and current_model != model:
            continue
        try:
            serial = int(line[6:11])
        except ValueError:
            serial = 0
        name = line[12:16].strip()
        altloc = line[16:17].strip()
        res_name = line[17:20].strip()
        chain = line[21:22].strip()
        try:
            res_id = int(line[22:26])
        except ValueError:
            continue
        icode = line[26:27].strip()
        try:
            x = float(line[30:38]); y = float(line[38:46]); z = float(line[46:54])
        except ValueError:
            continue
        try:
            occ = float(line[54:60])
        except (ValueError, IndexError):
            occ = 1.0
        try:
            bf = float(line[60:66])
        except (ValueError, IndexError):
            bf = 0.0
        element = line[76:78].strip() if len(line) >= 78 else name[:1]
        rows.append(
            (serial, name, altloc, res_name, chain, res_id, icode,
             x, y, z, occ, bf, element, is_het)
        )

    return np.array(rows, dtype=ATOM_DTYPE)
