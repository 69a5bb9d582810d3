#!/usr/bin/env python3
"""Calibrate the statistical backbone-placement table for mica_allatom.

PULCHRA places backbone N/C/O atoms by looking up a 4-CA-fragment
statistical library binned by inter-CA distances (pulchra.c:1582,
nco_data.h — a table derived from PDB statistics).  We build our own
equivalent library by *behavioral calibration*: generate CA-only traces
densely covering the local-geometry descriptor space, run a reference
backbone-reconstruction tool (the shipped PULCHRA binary, as the
ground-truth oracle encoding those PDB statistics) with fixed CA positions
(``-c``), and record where it places C(i), O(i), N(i+1) in a canonical
local frame of each 4-CA window.  The result is OUR table in OUR format
(different binning, frame, and layout from nco_data.h).

Descriptors per window (P0..P3 = CA(i-1)..CA(i+2); peptide between P1,P2):
  r13a = |P2-P0|, r13b = |P3-P1|,
  r14  = |P3-P0| signed by window chirality (sign of (P1-P0)x(P2-P1).(P3-P2))
Frame: origin P1, u = unit(P2-P1), e1 = unit((P0-P1) orthogonalized vs u),
e2 = u x e1.  Stored: (C_i, O_i, N_{i+1}) coordinates in (u, e1, e2).

Usage:
  python calibrate_backbone.py --pulchra /path/to/pulchra --out backbone_table.h
"""

from __future__ import annotations

import argparse
import subprocess
import tempfile
from pathlib import Path

import numpy as np

CA_BOND = 3.8

# bin edges (inclusive-exclusive), chosen to cover the protein-accessible
# region: r13 in [4.0, 7.6) step .3 (12 bins), signed r14 in [-11, 11) step .5
R13_LO, R13_STEP, R13_N = 4.0, 0.3, 12
R14_LO, R14_STEP, R14_N = -11.0, 0.5, 44


def make_trace(thetas: np.ndarray, taus: np.ndarray) -> np.ndarray:
    """CA trace from pseudo bond angles theta (deg) and dihedrals tau (deg).

    len(trace) = len(thetas) + 2 = len(taus) + 3.
    """
    n = len(thetas) + 2
    pts = np.zeros((n, 3))
    pts[1] = [CA_BOND, 0, 0]
    th0 = np.radians(thetas[0])
    pts[2] = pts[1] + CA_BOND * np.array([-np.cos(th0), np.sin(th0), 0.0])
    for k in range(3, n):
        a, b, c = pts[k - 3], pts[k - 2], pts[k - 1]
        th = np.radians(thetas[k - 2])
        ta = np.radians(taus[k - 3])
        bc = c - b
        bc /= np.linalg.norm(bc)
        nrm = np.cross(b - a, bc)
        nn = np.linalg.norm(nrm)
        if nn < 1e-9:
            nrm = np.cross(bc, [1.0, 0, 0])
            nn = np.linalg.norm(nrm)
        nrm /= nn
        m = np.cross(nrm, bc)
        d2 = CA_BOND * np.sin(th)
        pts[k] = c + (-CA_BOND * np.cos(th)) * bc + (d2 * np.cos(ta)) * m + (
            d2 * np.sin(ta)
        ) * nrm
    return pts


def write_ca_pdb(path: Path, coords: np.ndarray) -> None:
    lines = []
    for i, p in enumerate(coords):
        lines.append(
            f"ATOM  {i+1:5d}  CA  ALA A{i+1:4d}    "
            f"{p[0]:8.3f}{p[1]:8.3f}{p[2]:8.3f}  1.00  0.00           C"
        )
    lines += ["TER", "END"]
    path.write_text("\n".join(lines) + "\n")


def parse_rebuilt(path: Path):
    """{(res_id, atom_name): xyz} from a rebuilt PDB."""
    out = {}
    for line in path.read_text().splitlines():
        if not line.startswith("ATOM"):
            continue
        name = line[12:16].strip()
        rid = int(line[22:26])
        out[(rid, name)] = np.array(
            [float(line[30:38]), float(line[38:46]), float(line[46:54])]
        )
    return out


def window_descriptors(p0, p1, p2, p3):
    r13a = np.linalg.norm(p2 - p0)
    r13b = np.linalg.norm(p3 - p1)
    r14 = np.linalg.norm(p3 - p0)
    sign = np.dot(np.cross(p1 - p0, p2 - p1), p3 - p2)
    return r13a, r13b, r14 if sign >= 0 else -r14


def window_frame(p0, p1, p2):
    u = p2 - p1
    u = u / np.linalg.norm(u)
    w = p0 - p1
    e1 = w - u * np.dot(w, u)
    n = np.linalg.norm(e1)
    if n < 1e-9:
        e1 = np.cross(u, [1.0, 0, 0])
        n = np.linalg.norm(e1)
    e1 = e1 / n
    e2 = np.cross(u, e1)
    return np.stack([u, e1, e2])  # rows


def bin_index(r13a, r13b, r14):
    i = int((r13a - R13_LO) / R13_STEP)
    j = int((r13b - R13_LO) / R13_STEP)
    k = int((r14 - R14_LO) / R14_STEP)
    if 0 <= i < R13_N and 0 <= j < R13_N and 0 <= k < R14_N:
        return i, j, k
    return None


def gen_training_traces(rng: np.random.Generator):
    """Mixture of secondary-structure-like and space-filling random traces."""
    traces = []
    # dense sweep over (theta, tau): window i of a chain has descriptors
    # determined by (theta_i, theta_{i+1}, tau_i); PULCHRA's placement is a
    # pure per-window table lookup, so packing shuffled grid parameters into
    # long chains covers the space with far fewer subprocess calls.
    th_grid = np.arange(72, 152, 2.5)
    ta_grid = np.arange(-178.75, 180, 2.5)
    params = [(t, ta) for t in th_grid for ta in ta_grid]
    rng.shuffle(params)
    chain_len = 120
    for ofs in range(0, len(params), chain_len):
        chunk = params[ofs : ofs + chain_len]
        if len(chunk) < 4:
            break
        thetas = np.array([c[0] for c in chunk])
        taus = np.array([c[1] for c in chunk][:-1])
        traces.append(make_trace(thetas, taus))
    # short chains: dense coverage for the HEAD/TAIL terminal tables
    # (each chain contributes exactly one head and one tail sample)
    for _ in range(6000):
        n = 6
        thetas = rng.uniform(75, 148, n - 2)
        taus = rng.uniform(-180, 180, n - 3)
        if rng.random() < 0.5:  # bias half toward real secondary structure
            kind = rng.integers(0, 2)
            mu_t, sd_t = (89, 5) if kind == 0 else (123, 7)
            mu_d, sd_d = (50, 10) if kind == 0 else (-170, 25)
            thetas = rng.normal(mu_t, sd_t, n - 2)
            taus = rng.normal(mu_d, sd_d, n - 3)
        traces.append(make_trace(thetas, taus))
    # long correlated random chains (helix/strand/loop segments)
    for _ in range(300):
        n = 80
        thetas, taus = [], []
        mode = rng.integers(0, 3)
        for _k in range(n):
            if rng.random() < 0.07:
                mode = rng.integers(0, 3)
            if mode == 0:  # helix
                thetas.append(rng.normal(89, 4))
                taus.append(rng.normal(50, 7))
            elif mode == 1:  # strand
                thetas.append(rng.normal(123, 6))
                taus.append(rng.normal(-170, 20))
            else:  # loop
                thetas.append(rng.uniform(75, 148))
                taus.append(rng.uniform(-180, 180))
        traces.append(make_trace(np.array(thetas[:-2]), np.array(taus[:-3])))
    return traces


AA3 = ["ALA", "CYS", "ASP", "GLU", "PHE", "GLY", "HIS", "ILE", "LYS", "LEU",
       "MET", "ASN", "PRO", "GLN", "ARG", "SER", "THR", "VAL", "TRP", "TYR"]
# chi1: dihedral N-CA-CB-<gamma>; chi2: CA-CB-<gamma>-<delta>
GAMMA = {"SER": "OG", "CYS": "SG", "THR": "OG1", "VAL": "CG1", "ILE": "CG1",
         "LEU": "CG", "MET": "CG", "PRO": "CG", "PHE": "CG", "TYR": "CG",
         "TRP": "CG", "ASP": "CG", "ASN": "CG", "GLU": "CG", "GLN": "CG",
         "LYS": "CG", "ARG": "CG", "HIS": "CG"}
DELTA = {"ILE": "CD1", "LEU": "CD1", "MET": "SD", "PHE": "CD1", "TYR": "CD1",
         "TRP": "CD1", "ASP": "OD1", "ASN": "OD1", "GLU": "CD", "GLN": "CD",
         "LYS": "CD", "ARG": "CD", "HIS": "ND1", "PRO": "CD"}
PHI_N = 12  # 30-degree bins over [-180, 180)


def dihedral(p0, p1, p2, p3):
    b1, b2, b3 = p1 - p0, p2 - p1, p3 - p2
    n1, n2 = np.cross(b1, b2), np.cross(b2, b3)
    m = np.cross(n1, b2 / np.linalg.norm(b2))
    return np.degrees(np.arctan2(np.dot(m, n2), np.dot(n1, n2)))


def calibrate_rotamers(pulchra, rng):
    """(restype, phi_bin, psi_bin) -> modal-well chi1/chi2 from the oracle's
    rebuilt side chains on random-sequence traces.

    Rotamer angles are multi-modal (chi1 wells near -60/60/180), so a plain
    circular mean is meaningless; instead each sample is assigned to a
    120-degree well and the most-populated well's circular mean is stored."""
    W = 3  # wells per chi: [0,120) -> 60, [120,240) -> 180, [240,360) -> -60
    sin1 = np.zeros((20, PHI_N, PHI_N, W)); cos1 = np.zeros_like(sin1)
    n1 = np.zeros((20, PHI_N, PHI_N, W), np.int64)
    sin2 = np.zeros_like(sin1); cos2 = np.zeros_like(sin1)
    n2 = np.zeros_like(n1)
    cnt = np.zeros((20, PHI_N, PHI_N), np.int64)

    def well(chi):
        return int(((chi % 360.0) // 120.0) % W)

    def trace_with_seq(n):
        mode = rng.integers(0, 3)
        thetas, taus = [], []
        for _ in range(n):
            if rng.random() < 0.08:
                mode = rng.integers(0, 3)
            if mode == 0:
                thetas.append(rng.normal(89, 4)); taus.append(rng.normal(50, 7))
            elif mode == 1:
                thetas.append(rng.normal(123, 6)); taus.append(rng.normal(-170, 20))
            else:
                thetas.append(rng.uniform(75, 148)); taus.append(rng.uniform(-180, 180))
        tr = make_trace(np.array(thetas[:-2]), np.array(taus[:-3]))
        seq = [AA3[rng.integers(0, 20)] for _ in range(len(tr))]
        return tr, seq

    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        for ti in range(500):
            tr, seq = trace_with_seq(40)
            pdb = td / f"r{ti}.pdb"
            lines = []
            for i, p in enumerate(tr):
                lines.append(
                    f"ATOM  {i+1:5d}  CA  {seq[i]} A{i+1:4d}    "
                    f"{p[0]:8.3f}{p[1]:8.3f}{p[2]:8.3f}  1.00  0.00           C")
            pdb.write_text("\n".join(lines) + "\nTER\nEND\n")
            r = subprocess.run([str(pulchra), "-c", str(pdb)],
                               capture_output=True)
            reb = pdb.with_suffix(".rebuilt.pdb")
            if r.returncode != 0 or not reb.exists():
                continue
            atoms = parse_rebuilt(reb)
            reb.unlink(); pdb.unlink()
            for i in range(1, len(tr) - 1):
                rid = i + 1
                res = seq[i]
                if res not in GAMMA:
                    continue
                need = [(rid, "N"), (rid, "CA"), (rid, "C"), (rid, "CB"),
                        (rid, GAMMA[res]), (rid - 1, "C"), (rid + 1, "N")]
                if any(k not in atoms for k in need):
                    continue
                phi = dihedral(atoms[(rid - 1, "C")], atoms[(rid, "N")],
                               atoms[(rid, "CA")], atoms[(rid, "C")])
                psi = dihedral(atoms[(rid, "N")], atoms[(rid, "CA")],
                               atoms[(rid, "C")], atoms[(rid + 1, "N")])
                chi1 = dihedral(atoms[(rid, "N")], atoms[(rid, "CA")],
                                atoms[(rid, "CB")], atoms[(rid, GAMMA[res])])
                ai = AA3.index(res)
                pi = int((phi + 180) / 30) % PHI_N
                si = int((psi + 180) / 30) % PHI_N
                w1 = well(chi1)
                sin1[ai, pi, si, w1] += np.sin(np.radians(chi1))
                cos1[ai, pi, si, w1] += np.cos(np.radians(chi1))
                n1[ai, pi, si, w1] += 1
                if res in DELTA and (rid, DELTA[res]) in atoms:
                    chi2 = dihedral(atoms[(rid, "CA")], atoms[(rid, "CB")],
                                    atoms[(rid, GAMMA[res])],
                                    atoms[(rid, DELTA[res])])
                    if res in ("PHE", "TYR"):  # ring flip symmetry
                        chi2 = (chi2 + 90.0) % 180.0 - 90.0
                    w2 = well(chi2)
                    sin2[ai, pi, si, w2] += np.sin(np.radians(chi2))
                    cos2[ai, pi, si, w2] += np.cos(np.radians(chi2))
                    n2[ai, pi, si, w2] += 1
                cnt[ai, pi, si] += 1

    def modal(sin_a, cos_a, n_a):
        best = np.argmax(n_a, axis=-1)
        ix = np.indices(best.shape)
        s = sin_a[ix[0], ix[1], ix[2], best]
        c = cos_a[ix[0], ix[1], ix[2], best]
        ang = np.degrees(np.arctan2(s, c))
        have = n_a.sum(-1) > 0
        # global per-restype modal fallback for empty bins
        gn = n_a.sum((1, 2))  # (20, W)
        gw = np.argmax(gn, axis=-1)
        gs = sin_a.sum((1, 2)); gc = cos_a.sum((1, 2))
        gfall = np.degrees(np.arctan2(gs[np.arange(20), gw],
                                      gc[np.arange(20), gw]))
        for aa in range(20):
            ang[aa][~have[aa]] = gfall[aa]
        return ang

    chi1 = modal(sin1, cos1, n1)
    chi2 = modal(sin2, cos2, n2)
    print(f"rotamer calibration: {int(cnt.sum())} residues sampled, "
          f"{int((cnt == 0).sum())} empty bins -> fallback")
    return chi1, chi2, cnt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pulchra", required=True)
    ap.add_argument("--out", default=str(Path(__file__).parent / "backbone_table.h"))
    ap.add_argument("--extra-ca-pdbs", nargs="*", default=[])
    args = ap.parse_args()

    rng = np.random.default_rng(7)
    traces = gen_training_traces(rng)
    for p in args.extra_ca_pdbs:
        coords = []
        for line in Path(p).read_text().splitlines():
            if line.startswith("ATOM") and line[12:16].strip() == "CA":
                coords.append([float(line[30:38]), float(line[38:46]),
                               float(line[46:54])])
        if len(coords) >= 4:
            traces.append(np.asarray(coords))

    # three tables over the same (r13a, r13b, signed-r14) binning:
    #   interior: window (CA_{i-1}..CA_{i+2})        -> C_i, O_i, N_{i+1}   (9)
    #   head:     window (CA_0..CA_3), frame from P0,P1 with e1 from P2
    #             -> N_0, C_0, O_0, N_1                                    (12)
    #   tail:     window (CA_{l-3}..CA_l), frame origin CA_{l-1}
    #             -> C_{l-1}, O_{l-1}, N_l, C_l, O_l                       (15)
    acc = {
        "interior": (np.zeros((R13_N, R13_N, R14_N, 9)),
                     np.zeros((R13_N, R13_N, R14_N), np.int64)),
        "head": (np.zeros((R13_N, R13_N, R14_N, 12)),
                 np.zeros((R13_N, R13_N, R14_N), np.int64)),
        "tail": (np.zeros((R13_N, R13_N, R14_N, 15)),
                 np.zeros((R13_N, R13_N, R14_N), np.int64)),
    }

    def deposit(name, desc, fr, origin, atoms_list):
        b = bin_index(*desc)
        if b is None:
            return
        loc = np.concatenate([fr @ (a - origin) for a in atoms_list])
        if not np.isfinite(loc).all():
            return
        sums, counts = acc[name]
        sums[b] += loc
        counts[b] += 1

    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        for ti, tr in enumerate(traces):
            pdb = td / f"t{ti}.pdb"
            write_ca_pdb(pdb, tr)
            r = subprocess.run([args.pulchra, "-c", str(pdb)],
                               capture_output=True)
            reb = pdb.with_suffix(".rebuilt.pdb")
            if r.returncode != 0 or not reb.exists():
                continue
            atoms = parse_rebuilt(reb)
            reb.unlink()
            pdb.unlink()
            n = len(tr)
            # interior windows (residue ids are 1-based)
            for i in range(1, n - 2):
                p0, p1, p2, p3 = tr[i - 1], tr[i], tr[i + 1], tr[i + 2]
                keys = [(i + 1, "C"), (i + 1, "O"), (i + 2, "N")]
                if any(k not in atoms for k in keys):
                    continue
                deposit("interior", window_descriptors(p0, p1, p2, p3),
                        window_frame(p0, p1, p2), p1,
                        [atoms[k] for k in keys])
            if n >= 4:
                # head: peptide 0->1 plus terminal N
                p0, p1, p2, p3 = tr[0], tr[1], tr[2], tr[3]
                keys = [(1, "N"), (1, "C"), (1, "O"), (2, "N")]
                if all(k in atoms for k in keys):
                    # frame anchored at P0 looking down the chain; e1 from P2
                    deposit("head", window_descriptors(p0, p1, p2, p3),
                            window_frame(p2, p0, p1), p0,
                            [atoms[k] for k in keys])
                # tail: peptide l-1->l plus terminal C/O
                q0, q1, q2, q3 = tr[n - 4], tr[n - 3], tr[n - 2], tr[n - 1]
                keys = [(n - 1, "C"), (n - 1, "O"), (n, "N"), (n, "C"),
                        (n, "O")]
                if all(k in atoms for k in keys):
                    deposit("tail", window_descriptors(q0, q1, q2, q3),
                            window_frame(q1, q2, q3), q2,
                            [atoms[k] for k in keys])

    from collections import deque

    lines = [
        "// Auto-generated by calibrate_backbone.py — statistical backbone",
        "// placement tables (local-frame atom coords per",
        "// (r13a, r13b, signed r14) bin).  Do not edit by hand.",
        "#pragma once",
        f"constexpr double kR13Lo = {R13_LO};",
        f"constexpr double kR13Step = {R13_STEP};",
        f"constexpr int kR13N = {R13_N};",
        f"constexpr double kR14Lo = {R14_LO};",
        f"constexpr double kR14Step = {R14_STEP};",
        f"constexpr int kR14N = {R14_N};",
    ]
    cpp_names = {"interior": "kBackboneTable", "head": "kHeadTable",
                 "tail": "kTailTable"}
    for name, (sums, counts) in acc.items():
        filled = counts > 0
        table = np.zeros_like(sums)
        table[filled] = sums[filled] / counts[filled][..., None]
        n_filled = int(filled.sum())
        print(f"{name}: filled {n_filled}/{filled.size} bins "
              f"({counts.sum()} samples)")
        # fill empty bins from the nearest filled bin (BFS in bin space)
        # so the C++ lookup never misses
        dist = np.full(filled.shape, -1, np.int32)
        q = deque()
        for t in np.argwhere(filled):
            dist[tuple(t)] = 0
            q.append(tuple(t))
        while q:
            i, j, k = q.popleft()
            for di, dj, dk in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                               (0, 0, 1), (0, 0, -1)):
                ni, nj, nk = i + di, j + dj, k + dk
                if 0 <= ni < R13_N and 0 <= nj < R13_N and 0 <= nk < R14_N \
                        and dist[ni, nj, nk] < 0:
                    dist[ni, nj, nk] = dist[i, j, k] + 1
                    table[ni, nj, nk] = table[i, j, k]
                    q.append((ni, nj, nk))
        flat = table.reshape(-1)
        lines.append(f"// {name}: filled {n_filled} bins, "
                     f"{int(counts.sum())} samples")
        lines.append(f"constexpr float {cpp_names[name]}[{flat.size}] = {{")
        for ofs in range(0, flat.size, 8):
            chunk = ", ".join(f"{v:.5f}f" for v in flat[ofs:ofs + 8])
            lines.append("    " + chunk + ",")
        lines.append("};")

    chi1, chi2, _cnt = calibrate_rotamers(args.pulchra, rng)
    lines.append(f"constexpr int kPhiN = {PHI_N};")
    for nm, arr in (("kChi1Table", chi1), ("kChi2Table", chi2)):
        flat = arr.reshape(-1)
        lines.append(f"// (restype, phi_bin, psi_bin) -> circular-mean chi")
        lines.append(f"constexpr float {nm}[{flat.size}] = {{")
        for ofs in range(0, flat.size, 10):
            chunk = ", ".join(f"{v:.1f}f" for v in flat[ofs:ofs + 10])
            lines.append("    " + chunk + ",")
        lines.append("};")
    Path(args.out).write_text("\n".join(lines) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
