"""Lightweight structured-array PDB I/O (numpy only).

The port's own copy of ``mica_tpu/io/pdb.py``: ``parse_pdb`` and the channel
tables that ``ops.rasterize`` builds the 24-channel AF3 encoding from, the
selectors the solver reads AF3 templates with, and the writers of the CA
model.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Union

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

THREE_TO_ONE = {
    "ALA": "A", "CYS": "C", "ASP": "D", "GLU": "E", "PHE": "F",
    "GLY": "G", "HIS": "H", "ILE": "I", "LYS": "K", "LEU": "L",
    "MET": "M", "ASN": "N", "PRO": "P", "GLN": "Q", "ARG": "R",
    "SER": "S", "THR": "T", "VAL": "V", "TRP": "W", "TYR": "Y",
}
ONE_TO_THREE = {v: k for k, v in THREE_TO_ONE.items()}

# 62-symbol chain-ID alphabet.
CHAIN_IDS = (
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "abcdefghijklmnopqrstuvwxyz"
    "0123456789"
)

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


def coords(atoms: np.ndarray) -> np.ndarray:
    """(N, 3) float32 coordinates from a structured atom array."""
    return np.stack([atoms["x"], atoms["y"], atoms["z"]], axis=-1)


def select(atoms: np.ndarray, name: Optional[str] = None,
           chain: Optional[str] = None, standard_aa: bool = False) -> np.ndarray:
    mask = np.ones(len(atoms), dtype=bool)
    if name is not None:
        mask &= atoms["name"] == name
    if chain is not None:
        mask &= atoms["chain"] == chain
    if standard_aa:
        mask &= np.isin(atoms["res_name"], AMINO_ACIDS)
    return atoms[mask]


def chains(atoms: np.ndarray) -> List[str]:
    """Chain IDs in first-occurrence order (vectorized: the per-atom
    Python loop took seconds on million-atom assemblies)."""
    if len(atoms) == 0:
        return []
    uniq, first = np.unique(atoms["chain"], return_index=True)
    return [str(c) for c in uniq[np.argsort(first)]]


def chain_sequence(atoms: np.ndarray, chain: str) -> str:
    """One-letter sequence of a chain from its CA atoms (ordered by res_id)."""
    ca = select(atoms, name="CA", chain=chain, standard_aa=True)
    order = np.argsort(ca["res_id"], kind="stable")
    return "".join(THREE_TO_ONE.get(r, "X") for r in ca["res_name"][order])


def format_atom_line(
    serial: int, name: str, res_name: str, chain: str, res_id: int,
    xyz: Sequence[float], occupancy: float = 1.0, bfactor: float = 0.0,
    element: str = "",
) -> str:
    if not element:
        element = name[:1]
    chain = str(chain)[:1] or " "  # PDB format: single chain-ID column
    # fixed-width columns: overflowing values would shift every later
    # column and corrupt round-trip parses — wrap like most PDB writers
    serial = serial % 100000
    if res_id > 9999 or res_id < -999:
        res_id = res_id % 10000
    if len(name) < 4:
        name_field = f" {name:<3s}"
    else:
        name_field = f"{name:<4s}"
    return (
        f"ATOM  {serial:5d} {name_field} {res_name:>3s} {chain:1s}"
        f"{res_id:4d}    {xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}"
        f"{occupancy:6.2f}{bfactor:6.2f}          {element:>2s}"
    )


def write_pdb(path: Union[str, Path], atoms: np.ndarray,
              renumber_serials: bool = True) -> None:
    lines = []
    prev_chain = None
    for i, a in enumerate(atoms):
        serial = i + 1 if renumber_serials else int(a["serial"])
        if prev_chain is not None and a["chain"] != prev_chain:
            lines.append("TER")
        prev_chain = a["chain"]
        lines.append(
            format_atom_line(
                serial, str(a["name"]), str(a["res_name"]), str(a["chain"]),
                int(a["res_id"]), (float(a["x"]), float(a["y"]), float(a["z"])),
                float(a["occupancy"]), float(a["bfactor"]), str(a["element"]),
            )
        )
    lines.append("TER")
    lines.append("END")
    Path(path).write_text("\n".join(lines) + "\n")


def write_ca_pdb(
    path: Union[str, Path],
    coords_by_chain: Iterable,
    res_names_by_chain: Optional[Iterable] = None,
    start_res_id: int = 1,
    bfactors_by_chain: Optional[Iterable] = None,
) -> None:
    """Write a CA-only model: per-chain lists of (N,3) coordinates.

    Chain IDs are assigned deterministically from CHAIN_IDS (the reference
    picks them with unseeded random.choice, modeler.py:2190 — made
    deterministic here by construction).
    """
    coords_by_chain = list(coords_by_chain)
    res_names_by_chain = (
        list(res_names_by_chain) if res_names_by_chain is not None else None
    )
    bfactors_by_chain = (
        list(bfactors_by_chain) if bfactors_by_chain is not None else None
    )
    lines = []
    serial = 1
    for ci, chain_coords in enumerate(coords_by_chain):
        chain_id = CHAIN_IDS[ci % len(CHAIN_IDS)]
        chain_coords = np.asarray(chain_coords)
        for ri in range(len(chain_coords)):
            if res_names_by_chain is not None:
                rn = res_names_by_chain[ci][ri]
                res_name = ONE_TO_THREE.get(rn, rn) if len(rn) == 1 else rn
            else:
                res_name = "ALA"
            bf = (
                float(bfactors_by_chain[ci][ri])
                if bfactors_by_chain is not None
                else 0.0
            )
            lines.append(
                format_atom_line(
                    serial, "CA", res_name, chain_id, start_res_id + ri,
                    chain_coords[ri], 1.0, bf, "C",
                )
            )
            serial += 1
        lines.append("TER")
    lines.append("END")
    Path(path).write_text("\n".join(lines) + "\n")
