#!/usr/bin/env python3
"""Calibrate the side-chain placement table for mica_allatom (round-5).

PULCHRA places side chains by a nearest-entry lookup into a rotamer
library indexed by the local CA-geometry bins
(b13_1, b13_2, b14) — pulchra.c:1933-2123: per residue i it computes
  r13_1 = |CA(i-2) - CA(i)|,  r13_2 = |CA(i-1) - CA(i+1)|,
  r14   = |CA(i-2) - CA(i+1)| signed by the window chirality,
bins them ((r13-4.6)/0.3 clamped to [0,9]; (r14+11)/0.3 clamped to
[0,73]), picks the library entry of the residue's type minimizing
|db1| + |db2| + 0.2*|db14|, and places that entry's Cartesian
side-chain coordinates in a local frame built from CA(i-1), CA(i),
CA(i+1).  With CA-only input (MICA's `pulchra <chain> -c` mode,
modeler.py:371) the placement is therefore a DETERMINISTIC function of
(aa, b1, b2, b14) plus the frame.

We recover that function by *behavioral calibration* (the same approach
as calibrate_backbone.py — the shipped binary is the oracle; its data
files are never read): generate CA traces covering the bin space with
all residue types, run the binary, express each residue's side-chain
atoms in OUR local frame
  f1 = unit(CA(i+1) - CA(i-1)),
  f2 = unit((CA(i+1) - CA(i)) x (CA(i) - CA(i-1))),
  f3 = f1 x f2,
cluster the frame-relative coordinate sets per residue type into
distinct conformations (the binary's library is small, so observed
coordinate sets repeat exactly up to float noise; samples its
excluded-volume pass moved are key-inconsistent and removed by the
per-key majority vote), and emit
  * per-type conformation coordinate arrays, and
  * a sparse (aa, b1, b2, b14) -> conformation-id key table
as sidechain_table.h in OUR format.

Usage:
  python calibrate_sidechains.py --pulchra /path/to/pulchra \
      --out sidechain_table.h [--quick]
"""

from __future__ import annotations

import argparse
import subprocess
import tempfile
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np

if __package__:
    from .calibrate_backbone import make_trace, parse_rebuilt
else:  # run as a script: its directory is on sys.path
    from calibrate_backbone import make_trace, parse_rebuilt

AA3 = ["ALA", "CYS", "ASP", "GLU", "PHE", "HIS", "ILE", "LYS", "LEU",
       "MET", "ASN", "PRO", "GLN", "ARG", "SER", "THR", "VAL", "TRP",
       "TYR"]  # no GLY (no side chain)

# heavy side-chain atoms (incl. CB) in placement order per type
SC_ATOMS = {
    "ALA": ["CB"],
    "CYS": ["CB", "SG"],
    "ASP": ["CB", "CG", "OD1", "OD2"],
    "GLU": ["CB", "CG", "CD", "OE1", "OE2"],
    "PHE": ["CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"],
    "HIS": ["CB", "CG", "ND1", "CD2", "CE1", "NE2"],
    "ILE": ["CB", "CG1", "CG2", "CD1"],
    "LYS": ["CB", "CG", "CD", "CE", "NZ"],
    "LEU": ["CB", "CG", "CD1", "CD2"],
    "MET": ["CB", "CG", "SD", "CE"],
    "ASN": ["CB", "CG", "OD1", "ND2"],
    "PRO": ["CB", "CG", "CD"],
    "GLN": ["CB", "CG", "CD", "OE1", "NE2"],
    "ARG": ["CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"],
    "SER": ["CB", "OG"],
    "THR": ["CB", "OG1", "CG2"],
    "VAL": ["CB", "CG1", "CG2"],
    "TRP": ["CB", "CG", "CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3",
            "CH2"],
    "TYR": ["CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ", "OH"],
}


def pulchra_bins(p0, p1, p2, p3):
    """(b13_1, b13_2, b14) exactly as pulchra.c:1696-1713 computes them."""
    r13_1 = np.linalg.norm(p2 - p0)
    r13_2 = np.linalg.norm(p3 - p1)
    r14 = np.linalg.norm(p3 - p0)
    if np.dot(np.cross(p1 - p0, p2 - p1), p3 - p2) < 0:
        r14 = -r14
    b1 = min(max(int((r13_1 - 4.6) / 0.3), 0), 9)
    b2 = min(max(int((r13_2 - 4.6) / 0.3), 0), 9)
    b14 = min(max(int((r14 + 11.0) / 0.3), 0), 73)
    return b1, b2, b14


def sc_frame(pm1, p, pp1):
    """Rows (f1, f2, f3) of the side-chain local frame at CA(i)."""
    f1 = pp1 - pm1
    f1 = f1 / np.linalg.norm(f1)
    f2 = np.cross(pp1 - p, p - pm1)
    n = np.linalg.norm(f2)
    if n < 1e-9:
        f2 = np.cross(f1, [1.0, 0.0, 0.0])
        n = np.linalg.norm(f2)
    f2 = f2 / n
    f3 = np.cross(f1, f2)
    return np.stack([f1, f2, f3])


def write_seq_ca_pdb(path: Path, coords: np.ndarray, seq) -> None:
    lines = []
    for i, (p, rn) in enumerate(zip(coords, seq)):
        lines.append(
            f"ATOM  {i+1:5d}  CA  {rn} A{i+1:4d}    "
            f"{p[0]:8.3f}{p[1]:8.3f}{p[2]:8.3f}  1.00  0.00           C"
        )
    lines += ["TER", "END"]
    path.write_text("\n".join(lines) + "\n")


def gen_param_chains(rng, quick=False):
    """(thetas, taus) chains covering bin space; each grid point appears
    once per residue-type pass so every type sees every geometry."""
    th_grid = np.arange(74, 150, 4.0 if quick else 2.5)
    ta_grid = np.arange(-178, 180, 8.0 if quick else 3.5)
    params = [(t, ta) for t in th_grid for ta in ta_grid]
    chains = []
    chain_len = 120
    rng.shuffle(params)
    for ofs in range(0, len(params), chain_len):
        chunk = params[ofs:ofs + chain_len]
        if len(chunk) < 6:
            break
        thetas = np.array([c[0] for c in chunk])
        taus = np.array([c[1] for c in chunk][:-1])
        chains.append((thetas, taus))
    # secondary-structure-biased segments: the realistic high-traffic bins
    n_ss = 40 if quick else 400
    for _ in range(n_ss):
        n = 100
        thetas, taus = [], []
        mode = rng.integers(0, 3)
        for _k in range(n):
            if rng.random() < 0.07:
                mode = rng.integers(0, 3)
            if mode == 0:
                thetas.append(rng.normal(89, 4))
                taus.append(rng.normal(50, 7))
            elif mode == 1:
                thetas.append(rng.normal(123, 6))
                taus.append(rng.normal(-170, 20))
            else:
                thetas.append(rng.uniform(75, 148))
                taus.append(rng.uniform(-180, 180))
        chains.append((np.array(thetas[:-2]), np.array(taus[:-3])))
    return chains


def collect(pulchra: str, rng, quick=False, passes=1):
    """samples[aa] = list of (key, coords (n_atoms, 3))

    ``passes`` re-runs every chain with the sequence assignment cycled,
    so each residue type samples each chain's geometry windows."""
    samples = defaultdict(list)
    chains = gen_param_chains(rng, quick)
    with tempfile.TemporaryDirectory() as td:
        tdir = Path(td)
        for passno, chain_params in enumerate(chains * passes):
            thetas, taus = chain_params
            trace = make_trace(thetas, taus)
            n = len(trace)
            # each pass cycles the sequence so every type sweeps the grid
            seq = [AA3[(i + passno) % len(AA3)] for i in range(n)]
            pdb = tdir / "t.pdb"
            write_seq_ca_pdb(pdb, trace, seq)
            try:
                subprocess.run([pulchra, "-c", str(pdb)], timeout=120,
                               stdout=subprocess.DEVNULL,
                               stderr=subprocess.DEVNULL, check=True)
            except Exception:
                continue
            reb = tdir / "t.rebuilt.pdb"
            if not reb.exists():
                continue
            atoms = parse_rebuilt(reb)
            for i in range(2, n - 1):
                rn = seq[i]
                names = SC_ATOMS[rn]
                rid = i + 1
                if any((rid, nm) not in atoms for nm in names):
                    continue
                key = pulchra_bins(trace[i - 2], trace[i - 1], trace[i],
                                   trace[i + 1])
                fr = sc_frame(trace[i - 1], trace[i], trace[i + 1])
                rel = np.stack([
                    fr @ (atoms[(rid, nm)] - trace[i]) for nm in names])
                samples[rn].append((key, rel))
            reb.unlink()
    return samples


def cluster(samples_aa, tol=0.25):
    """Greedy conformation clustering; returns (confs (k, n_atoms, 3),
    labels)."""
    confs = []     # list of [sum, count]
    labels = []
    for _key, rel in samples_aa:
        best, besti = 1e9, -1
        for ci, (s, c) in enumerate(confs):
            cen = s / c
            d = np.max(np.linalg.norm(cen - rel, axis=1))
            if d < best:
                best, besti = d, ci
        if besti >= 0 and best < tol:
            confs[besti][0] += rel
            confs[besti][1] += 1
            labels.append(besti)
        else:
            confs.append([rel.copy(), 1])
            labels.append(len(confs) - 1)
    cents = [s / c for s, c in confs]
    counts = [c for _s, c in confs]
    return cents, counts, labels


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pulchra", required=True)
    ap.add_argument("--out", default="sidechain_table.h")
    ap.add_argument("--quick", action="store_true",
                    help="coarse grid (CI smoke; production uses full)")
    ap.add_argument("--passes", type=int, default=3,
                    help="sequence-cycled passes over the chain set")
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)

    samples = collect(args.pulchra, rng, args.quick,
                      1 if args.quick else args.passes)

    out_lines = [
        "// Generated by calibrate_sidechains.py — side-chain placement",
        "// table behaviorally calibrated against the reference PULCHRA",
        "// binary (black-box oracle).  OUR format: frame-relative",
        "// Cartesian conformations per residue type + a sparse",
        "// (b13_1, b13_2, b14) -> conformation key table.",
        "#pragma once",
        "",
        "struct ScKey { unsigned char b1, b2, b14; unsigned short conf; };",
        "",
    ]

    aa_names, atom_counts = [], []
    conf_arrays, key_arrays = [], []
    total_keys = total_confs = 0
    for rn in AA3:
        sam = samples.get(rn, [])
        if not sam:
            print(f"WARNING: no samples for {rn}")
            aa_names.append(rn)
            atom_counts.append(len(SC_ATOMS[rn]))
            conf_arrays.append([])
            key_arrays.append([])
            continue
        cents, counts, labels = cluster(sam)
        # per-key majority conformation (exvol-moved outliers lose the
        # vote; singleton conformations that never win a key are dropped)
        by_key = defaultdict(Counter)
        for (key, _rel), lab in zip(sam, labels):
            by_key[key][lab] += 1
        used = sorted({c.most_common(1)[0][0] for c in by_key.values()})
        remap = {old: new for new, old in enumerate(used)}
        keys = sorted(
            (k[0], k[1], k[2], remap[c.most_common(1)[0][0]])
            for k, c in by_key.items())
        aa_names.append(rn)
        atom_counts.append(len(SC_ATOMS[rn]))
        conf_arrays.append([cents[u] for u in used])
        key_arrays.append(keys)
        total_keys += len(keys)
        total_confs += len(used)
        spread = np.mean([np.max(np.linalg.norm(
            cents[lab] - rel, axis=1)) for (_k, rel), lab in
            zip(sam, labels)])
        print(f"{rn}: {len(sam)} samples, {len(cents)} raw confs, "
              f"{len(used)} used, {len(keys)} keys, "
              f"mean in-cluster spread {spread:.3f} A")

    out_lines.append(f"// {total_keys} keys, {total_confs} conformations")
    out_lines.append(f"const int kScNumTypes = {len(AA3)};")
    names = ", ".join(f'"{n}"' for n in aa_names)
    out_lines.append(f"const char *const kScTypeNames[] = {{{names}}};")
    out_lines.append(
        "const int kScAtomCounts[] = {"
        + ", ".join(str(c) for c in atom_counts) + "};")
    for rn in AA3:
        nm = ", ".join(f'"{a}"' for a in SC_ATOMS[rn])
        out_lines.append(
            f"const char *const kScAtoms_{rn}[] = {{{nm}}};")
    out_lines.append(
        "const char *const *const kScAtomNames[] = {"
        + ", ".join(f"kScAtoms_{rn}" for rn in AA3) + "};")

    for rn, confs in zip(AA3, conf_arrays):
        flat = []
        for c in confs:
            for row in c:
                flat.extend(f"{v:.3f}f" for v in row)
        out_lines.append(
            f"const float kScConfs_{rn}[] = {{"
            + ",".join(flat) + "};" if flat else
            f"const float kScConfs_{rn}[] = {{0.0f}};")
    out_lines.append(
        "const float *const kScConfs[] = {"
        + ", ".join(f"kScConfs_{rn}" for rn in AA3) + "};")
    out_lines.append(
        "const int kScConfCounts[] = {"
        + ", ".join(str(len(c)) for c in conf_arrays) + "};")

    for rn, keys in zip(AA3, key_arrays):
        body = ",".join(f"{{{b1},{b2},{b14},{cf}}}"
                        for b1, b2, b14, cf in keys)
        out_lines.append(
            f"const ScKey kScKeys_{rn}[] = {{{body}}};" if body else
            f"const ScKey kScKeys_{rn}[] = {{{{0,0,0,0}}}};")
    out_lines.append(
        "const ScKey *const kScKeys[] = {"
        + ", ".join(f"kScKeys_{rn}" for rn in AA3) + "};")
    out_lines.append(
        "const int kScKeyCounts[] = {"
        + ", ".join(str(len(k)) for k in key_arrays) + "};")

    Path(args.out).write_text("\n".join(out_lines) + "\n")
    print(f"wrote {args.out}: {total_keys} keys, {total_confs} confs")


if __name__ == "__main__":
    main()
