"""FASTA parsing with the chain-annotation header convention.

Mirrors the semantics of the reference's FASTA handling
(modeler.py:2145-2251 ``checkSeq`` and fasta_to_AF3_json.py): headers of the
form ``>name|Chains A, B, C`` declare the chain IDs a sequence occupies; a
header without a ``|`` section gets a single auto-assigned chain.  Skips
nucleic-acid sequences and sequences shorter than 10 residues; non-standard
residues are rewritten to ``A`` (ALA).  Unlike the reference, auto-assigned
chain IDs are deterministic (first unused ID), not ``random.choice``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Union

from .pdb import CHAIN_IDS, THREE_TO_ONE

_PROTEIN_LETTERS = set(THREE_TO_ONE.values())
_NUCLEIC_LETTERS = {"A", "U", "T", "G", "C"}


@dataclasses.dataclass
class FastaEntry:
    name: str  # unique name (deduplicated with _1, _2... suffixes)
    header: str  # full header line without '>'
    sequence: str  # non-protein letters rewritten to A (modeler alphabet)
    chain_ids: List[str]
    raw_sequence: str = ""  # as read from the file (AF3 JSON removes X)


def _parse_chain_ids(header: str) -> List[str]:
    """Extract chain IDs from 'name|Chains A, B' style headers.

    The reference takes the last whitespace-separated token of each
    comma-separated piece after the first '|' (modeler.py:2209-2211).
    """
    parts = header.split("|")
    if len(parts) < 2:
        return []
    ids = []
    for piece in parts[1].split(","):
        piece = piece.strip()
        if not piece:
            continue
        token = piece.split(" ")[-1].split("]")[0]
        if token:
            ids.append(token)
    return ids


def parse_fasta(path_or_text: Union[str, Path]) -> List[FastaEntry]:
    if isinstance(path_or_text, Path) or (
        isinstance(path_or_text, str) and "\n" not in path_or_text
        and Path(path_or_text).exists()
    ):
        text = Path(path_or_text).read_text()
    else:
        text = str(path_or_text)

    raw: List[FastaEntry] = []
    header = None
    seq_parts: List[str] = []

    def flush():
        if header is None:
            return
        seq = "".join(seq_parts).strip().upper()
        raw.append(FastaEntry(name="", header=header, sequence=seq, chain_ids=[]))

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            flush()
            header = line[1:]
            seq_parts = []
        else:
            seq_parts.append(line)
    flush()

    # Deduplicate names, clean sequences, skip nucleic/short entries.
    used_names: set = set()
    used_chain_ids: List[str] = []
    entries: List[FastaEntry] = []
    for e in raw:
        seq = e.sequence
        if len(seq) < 10:
            continue
        if "U" in seq or set(seq).issubset(_NUCLEIC_LETTERS):
            continue  # nucleic acid
        seq = "".join(c if c in _PROTEIN_LETTERS else "A" for c in seq)

        base = e.header.split("|")[0].strip()
        name, n = base, 0
        while name in used_names:
            n += 1
            name = f"{base}_{n}"
        used_names.add(name)

        chain_ids = _parse_chain_ids(e.header)
        if not chain_ids:
            for cid in CHAIN_IDS:
                if cid not in used_chain_ids:
                    chain_ids = [cid]
                    break
        # Resolve collisions deterministically (len check: substring
        # membership would accept multi-char IDs like "AB").
        resolved = []
        for cid in chain_ids:
            if len(cid) != 1 or cid not in CHAIN_IDS or cid in used_chain_ids:
                cid = next(c for c in CHAIN_IDS if c not in used_chain_ids)
            used_chain_ids.append(cid)
            resolved.append(cid)

        entries.append(
            FastaEntry(name=name, header=e.header, sequence=seq,
                       chain_ids=resolved, raw_sequence=e.sequence)
        )
    return entries


def write_fasta(path: Union[str, Path], entries: List[FastaEntry]) -> None:
    lines = []
    for e in entries:
        lines.append(f">{e.header}" if e.header else f">{e.name}")
        lines.append(e.sequence)
    Path(path).write_text("\n".join(lines) + "\n")
