"""Minimal mmCIF reader for AlphaFold3 result files (numpy only).

The port's own copy of ``mica_tpu/io/cif.py``: parses the first
``_atom_site`` loop of a CIF file into the structured atom array of
:mod:`mica_tpu_torch.io.pdb`.
"""

from __future__ import annotations

import shlex
from pathlib import Path
from typing import List, Union

import numpy as np

from .pdb import ATOM_DTYPE


def _split_cif_line(line: str) -> List[str]:
    # cif values may be quoted with ' or "
    try:
        return shlex.split(line)
    except ValueError:
        return line.split()


def parse_cif_atoms(path_or_text: Union[str, Path],
                    include_hetero: bool = False) -> np.ndarray:
    """Parse the first _atom_site loop into a structured atom array."""
    if isinstance(path_or_text, Path) or "\n" not in str(path_or_text):
        text = Path(path_or_text).read_text()
    else:
        text = str(path_or_text)

    lines = text.splitlines()
    fields: List[str] = []
    rows = []
    in_loop = False
    collecting = False
    for line in lines:
        s = line.strip()
        if s == "loop_":
            in_loop = True
            fields = []
            collecting = False
            continue
        if in_loop and s.startswith("_atom_site."):
            fields.append(s.split(".", 1)[1].split()[0])
            collecting = True
            continue
        if collecting:
            if s.startswith("_") and not s.startswith("_atom_site."):
                # a different category: stop if we already got rows
                if rows:
                    break
                in_loop = False
                collecting = False
                continue
            if s.startswith("#") or s == "" or s == "loop_":
                if rows:
                    break
                continue
            vals = _split_cif_line(s)
            if len(vals) != len(fields):
                continue
            rec = dict(zip(fields, vals))
            group = rec.get("group_PDB", "ATOM")
            if group == "HETATM" and not include_hetero:
                continue
            try:
                x = float(rec["Cartn_x"]); y = float(rec["Cartn_y"]); z = float(rec["Cartn_z"])
            except (KeyError, ValueError):
                continue
            chain = rec.get("auth_asym_id", rec.get("label_asym_id", "A"))
            res_id_s = rec.get("auth_seq_id", rec.get("label_seq_id", "0"))
            try:
                res_id = int(res_id_s)
            except ValueError:
                res_id = 0
            try:
                serial = int(rec.get("id", "0"))
            except ValueError:
                serial = 0
            # '.'/'?' are mmCIF null tokens — default like the other fields
            try:
                occ = float(rec.get("occupancy", "1"))
            except ValueError:
                occ = 1.0
            try:
                bf = float(rec.get("B_iso_or_equiv", "0"))
            except ValueError:
                bf = 0.0
            rows.append(
                (
                    serial,
                    rec.get("label_atom_id", "").strip('"'),
                    rec.get("label_alt_id", ".").replace(".", ""),
                    rec.get("label_comp_id", ""),
                    # full ID kept (multi-char past 26 chains); renamed into
                    # the 62-ID space by prep.af3_results.rename_chains
                    # BEFORE truncation to PDB's single chain column
                    # (reference: process_AF3_results.py:145-198)
                    chain,
                    res_id,
                    "",
                    x, y, z, occ, bf,
                    rec.get("type_symbol", ""),
                    group == "HETATM",
                )
            )
    return np.array(rows, dtype=ATOM_DTYPE)
