"""Driver for the native all-atom reconstruction tool.

Counterpart of ``mica_tpu/tools/allatom.py``.  The reference splits the CA
model at chain/residue discontinuities, runs up to 30 concurrent PULCHRA
subprocesses and merges the ``.rebuilt`` outputs (modeler.py:294-419).  The
native ``mica_allatom`` tool handles splitting and merging internally, so
the driver is one subprocess call; an external PULCHRA binary can still be
used via ``pulchra_path``, in which case the reference's
split/parallel/merge protocol is applied.

The tool is built from this package's own sources (``allatom_src/``) on
first use, with

    g++ -O2 -std=c++17 -Wall -o build/mica_tpu_torch/mica_allatom-<hash> allatom.cc

at the repository root (git-ignored); the hash covers the sources and the
flags, so an edited source never runs a stale binary.  It runs on the host.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional

logger = logging.getLogger(__name__)

SRC_DIR = Path(__file__).resolve().parent / "allatom_src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mica_tpu_torch"
CXX_FLAGS = ["-O2", "-std=c++17", "-Wall"]
SOURCES = ("allatom.cc", "backbone_table.h", "sidechain_table.h")


def binary_path() -> Path:
    """Where the tool built from the current sources and flags lives."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"mica_allatom-{h.hexdigest()[:12]}"


def ensure_built() -> Path:
    """The ``mica_allatom`` binary, compiled first if there is none for the
    current sources.  Concurrent builders each write a temporary file and
    rename it into place.  Raises with the compiler's output if the build
    fails."""
    binary = binary_path()
    if binary.exists():
        return binary
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) found: the all-atom tool builds from "
                           f"{SRC_DIR} on first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = binary.with_name(f"{binary.name}.{os.getpid()}.tmp")
    logger.info("building %s", binary.name)
    t0 = time.time()
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC_DIR / "allatom.cc")],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the all-atom tool failed (exit {res.returncode}):\n"
                           f"{res.stdout}")
    os.replace(tmp, binary)
    logger.info("built %s in %.1f s", binary.name, time.time() - t0)
    return binary


def rebuild_ca_model(
    ca_model_path: str,
    out_path: str,
    pulchra_path: Optional[str] = None,
    max_jobs: int = 30,
    ca_optimize: bool = False,
    hbond_optimize: bool = False,
    max_shift: Optional[float] = None,
) -> Optional[str]:
    """CA-only PDB -> all-atom PDB.  Returns the output path or None.

    ``ca_optimize``: optimize CA positions before rebuilding (the reference
    tool's default mode — MICA's pipeline passes ``-c`` to skip it,
    modeler.py:371, so the default here is off).  ``hbond_optimize``: refine
    peptide planes to improve the backbone H-bond pattern (reference ``-q``).
    Native tool only; the external-PULCHRA compatibility path always runs
    with ``-c`` like the reference pipeline.
    """
    ca_model_path = str(ca_model_path)
    if not Path(ca_model_path).exists():
        logger.error("CA model %s does not exist", ca_model_path)
        return None
    if pulchra_path:
        return _rebuild_with_pulchra(ca_model_path, out_path, pulchra_path, max_jobs)
    binary = ensure_built()
    cmd = [str(binary)]
    if ca_optimize:
        cmd.append("--ca-optimize")
    if hbond_optimize:
        cmd.append("--hbond-optimize")
    if max_shift is not None:
        cmd += ["--max-shift", str(max_shift)]
    cmd += [ca_model_path, str(out_path)]
    res = subprocess.run(
        cmd,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    if res.returncode != 0:
        logger.error("mica_allatom failed: %s", res.stderr.strip())
        return None
    logger.info("all-atom model: %s (%s)", out_path, res.stderr.strip())
    return str(out_path)


# ---------------------------------------------------------------------------
# external-PULCHRA compatibility path


def _split_fragments(ca_model_path: str, out_dir: Path) -> List[Path]:
    """Split the CA model at chain changes / residue-number gaps, keeping
    fragments longer than 3 atoms (reference semantics, modeler.py:328-358)."""
    frags: List[Path] = []
    lines: List[str] = []
    last_chain, last_rid = None, None

    def flush():
        nonlocal lines
        if len(lines) > 3:
            rid = int(lines[-1][22:26])
            p = out_dir / f"frag_{last_chain}_{rid:04d}_{len(frags)}.pdb"
            p.write_text("".join(lines))
            frags.append(p)
        lines = []

    for line in Path(ca_model_path).read_text().splitlines(keepends=True):
        if not line.startswith("ATOM"):
            continue
        chain = line[21]
        rid = int(line[22:26])
        if last_chain is not None and (
            chain != last_chain or (rid - last_rid) not in (0, 1)
        ):
            flush()
        lines.append(line)
        last_chain, last_rid = chain, rid
    flush()
    return frags


def _rebuild_with_pulchra(ca_model_path, out_path, pulchra_path, max_jobs):
    pulchra = Path(pulchra_path).absolute()
    if not pulchra.exists():
        logger.error("pulchra binary not found: %s", pulchra)
        return None
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        frags = _split_fragments(ca_model_path, tmp)
        procs: List[subprocess.Popen] = []
        for frag in frags:
            while len([p for p in procs if p.poll() is None]) >= max_jobs:
                time.sleep(0.2)
            procs.append(
                subprocess.Popen(
                    [str(pulchra), frag.name, "-c"], cwd=tmp,
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                )
            )
        for p in procs:
            p.wait()

        serial = 1
        out_lines: List[str] = []
        for frag in sorted(frags):
            rebuilt = frag.with_suffix("").with_name(frag.stem + ".rebuilt.pdb")
            if not rebuilt.exists():
                continue
            chain_id = frag.name.split("_")[1]
            for line in rebuilt.read_text().splitlines():
                if not line.startswith("ATOM") or "nan" in line:
                    continue
                line = line.ljust(78)
                out_lines.append(
                    f"ATOM{serial:7d}{line[11:21]}{chain_id}{line[22:]}"
                )
                serial += 1
        Path(out_path).write_text("\n".join(out_lines) + "\nEND\n")
    return str(out_path)
