"""The benchmark's inputs, made from the seed on the run's device.

A structure is a set of protein-like domains: residues of random types
whose CA atoms fill a ball per domain, with N, C, O and the type's
side-chain atoms around each CA.  The domains sit on a fixed layout
inside the box, so every seed asks for the same amount of work and only
the details change.  Its density is the atoms splatted to the nearest
voxel, weighted by element, and blurred by a Gaussian; solvent noise is
Gaussian everywhere (``masked`` false, as in a deposited unmasked map) or
the map is multiplied by a soft mask around the domains, exactly zero
outside it (``masked`` true, as cryoSPARC or RELION post-processing leaves
a map).  Maps are written as EMDB-style MRC
files, the structure as the docked model's PDB.

Everything is drawn with ``torch.Generator``s on the device in a few
large calls; integer splats keep the sums independent of the order of
the atoms, so one seed gives the same bytes on every run.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import prep
from benchmark.reference.prep import AMINO_ACIDS, BACKBONE

# heavy side-chain atoms of each type
SIDE_CHAIN = {"ALA": 1, "CYS": 2, "ASP": 4, "GLU": 5, "PHE": 7, "GLY": 0, "HIS": 6,
              "ILE": 4, "LYS": 5, "LEU": 4, "MET": 4, "ASN": 4, "PRO": 3, "GLN": 5,
              "ARG": 7, "SER": 2, "THR": 3, "VAL": 3, "TRP": 10, "TYR": 8}
SC_NAMES = ("CB", "CG", "CD", "CE", "CZ", "CH", "NE", "NZ", "OH", "CW")
ELEMENT_WEIGHT = {"C": 6, "N": 7, "O": 8}
RESIDUE_VOLUME = 130.0  # A^3 a residue in a folded protein


def derived_seed(seed: int, *parts: int) -> int:
    """A seed for one part of a run's inputs, from the run's seed."""
    h = int(seed) % (2 ** 63 - 1)
    for p in parts:
        h = (h * 1_000_003 + int(p) + 1) % (2 ** 63 - 1)
    return h


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


@dataclasses.dataclass
class Structure:
    """Atoms of a generated model: coordinates in A on the device and the
    PDB columns on the host."""

    xyz: torch.Tensor            # (n_atoms, 3) f32
    name: np.ndarray             # atom names
    res_name: np.ndarray
    res_index: np.ndarray        # residue of each atom, 0-based
    chain: np.ndarray
    element: np.ndarray
    centres: torch.Tensor        # (domains, 3) A
    radius: float                # of a domain's ball, A


def domain_centres(traffic: Dict, box_a: float) -> np.ndarray:
    """The fixed layout: ``domains`` = (nx, ny, nz) centres on a regular
    grid filling ``envelope`` (fractions of the box) about its centre."""
    grid = traffic["domains"]
    env = np.asarray(traffic["envelope"], np.float64) * box_a
    axes = [(np.arange(n) + 0.5) / n * e - e / 2 for n, e in zip(grid, env)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], -1) + box_a / 2


def make_structure(seed: int, traffic: Dict, box_a: float, device) -> Structure:
    """``traffic['residues']`` residues over the layout's domains."""
    g = generator(derived_seed(seed, 1), device)
    centres = torch.as_tensor(domain_centres(traffic, box_a), dtype=torch.float32,
                              device=device)
    nd = len(centres)
    n = int(traffic["residues"])
    per = -(-n // nd)
    radius = (3 * per * RESIDUE_VOLUME / (4 * math.pi)) ** (1 / 3)
    dom = torch.arange(n, device=device) // per
    u = torch.rand(n, 4, generator=g, device=device)
    dirs = torch.randn(n, 3, 3, generator=g, device=device)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    r = radius * u[:, 0:1] ** (1 / 3)
    ca = centres[dom] + r * dirs[:, 0]
    types = (u[:, 1] * len(AMINO_ACIDS)).long().clamp(max=len(AMINO_ACIDS) - 1).cpu().numpy()
    n_sc = np.array([SIDE_CHAIN[AMINO_ACIDS[t]] for t in range(len(AMINO_ACIDS))])[types]
    per_res = 4 + n_sc
    res_index = np.repeat(np.arange(n), per_res)
    slot = np.arange(len(res_index)) - np.repeat(np.cumsum(per_res) - per_res, per_res)
    # atom offsets from CA: backbone along the first direction, O off the
    # second, the side chain along the third in 1.53 A steps
    d1, d2, d3 = dirs[:, 1], dirs[:, 2], dirs[:, 0]
    ri = torch.as_tensor(res_index, device=device)
    sl = torch.as_tensor(slot, device=device)
    off = torch.zeros(len(res_index), 3, device=device)
    off = torch.where((sl == 1)[:, None], -1.46 * d1[ri], off)
    off = torch.where((sl == 2)[:, None], 1.52 * d1[ri], off)
    off = torch.where((sl == 3)[:, None], 1.52 * d1[ri] + 1.23 * d2[ri], off)
    sc = (sl >= 4)[:, None]
    off = torch.where(sc, 1.53 * (sl - 3).clamp(min=0)[:, None].float() * d3[ri], off)
    xyz = (ca[ri] + off).clamp(0.0, box_a - 1e-3)
    names = np.array(BACKBONE + list(SC_NAMES))[slot]
    element = np.array([nm[0] for nm in BACKBONE] + ["C"] * len(SC_NAMES))[slot]
    element = np.where(names == "NE", "N", np.where(names == "NZ", "N", element))
    element = np.where(names == "OH", "O", element)
    chain_ids = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    return Structure(xyz=xyz, name=names, res_name=np.array(AMINO_ACIDS)[types][res_index],
                     res_index=res_index, chain=chain_ids[(res_index // per) % 26],
                     element=element, centres=centres, radius=radius)


def splat(st: Structure, shape: Sequence[int], voxel: float) -> torch.Tensor:
    """Atoms to their nearest voxel weighted by element, summed as
    integers (order-free), as f32."""
    idx = torch.round(st.xyz / voxel).long()
    for a in range(3):
        idx[:, a] = idx[:, a].clamp(0, shape[a] - 1)
    weights = np.array([ELEMENT_WEIGHT[e] for e in st.element], np.int32)
    w = torch.as_tensor(weights, dtype=torch.int32, device=st.xyz.device)
    grid = torch.zeros(tuple(shape), dtype=torch.int32, device=st.xyz.device)
    grid.index_put_((idx[:, 0], idx[:, 1], idx[:, 2]), w, accumulate=True)
    return grid.float()


def blur(v: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian of ``sigma`` voxels, zero outside, as shifted
    adds (no atomics, the same bits on every run)."""
    r = max(1, int(math.ceil(3 * sigma)))
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k = (k / k.sum()).tolist()
    for dim in range(3):
        x = v.movedim(dim, 0)
        n = x.shape[0]
        p = torch.cat([x.new_zeros((r,) + x.shape[1:]), x, x.new_zeros((r,) + x.shape[1:])])
        out = k[0] * p[0:n]
        for j in range(1, 2 * r + 1):
            out.add_(p[j:j + n], alpha=k[j])
        v = out.movedim(0, dim).contiguous()
    return v


def density_map(st: Structure, traffic: Dict, shape: Sequence[int], voxel: float,
                seed: int, masked: bool) -> torch.Tensor:
    """The map on its (X, Y, Z) grid: blurred atoms plus solvent noise,
    masked or not."""
    dens = blur(splat(st, shape, voxel), traffic["sigma_a"] / voxel)
    peak = dens.amax()
    g = generator(derived_seed(seed, 2), dens.device)
    noise = torch.randn(dens.shape, generator=g, device=dens.device)
    vol = dens + float(traffic["noise"]) * peak * noise
    if masked:
        vol = vol * soft_mask(st, shape, voxel, traffic)
    return vol


def soft_mask(st: Structure, shape, voxel: float, traffic: Dict) -> torch.Tensor:
    """1 within ``mask_margin_a`` of a domain's ball, a cosine ramp over
    ``mask_ramp_a`` beyond it, exactly 0 further out: the same support for
    every seed of a layout."""
    dev = st.xyz.device
    ax = [torch.arange(n, device=dev, dtype=torch.float32) * voxel for n in shape]
    d2 = None
    for c in st.centres:
        r2 = ((ax[0] - c[0]) ** 2)[:, None, None] + ((ax[1] - c[1]) ** 2)[None, :, None] \
            + ((ax[2] - c[2]) ** 2)[None, None, :]
        d2 = r2 if d2 is None else torch.minimum(d2, r2)
    edge = st.radius + float(traffic["mask_margin_a"])
    t = ((d2.sqrt() - edge) / float(traffic["mask_ramp_a"])).clamp(0.0, 1.0)
    return 0.5 * (1.0 + torch.cos(math.pi * t))


def write_mrc(path: Path, vol_xyz: np.ndarray, voxel: float) -> None:
    """An MRC2014 map, mode 2, axes 1/2/3, origin and start 0: data stored
    as (z, y, x) sections."""
    vol_xyz = np.asarray(vol_xyz, np.float32)
    nx, ny, nz = vol_xyz.shape
    header = bytearray(1024)
    struct.pack_into("<4i", header, 0, nx, ny, nz, 2)
    struct.pack_into("<3i", header, 16, 0, 0, 0)
    struct.pack_into("<3i", header, 28, nx, ny, nz)
    struct.pack_into("<3f", header, 40, nx * voxel, ny * voxel, nz * voxel)
    struct.pack_into("<3f", header, 52, 90.0, 90.0, 90.0)
    struct.pack_into("<3i", header, 64, 1, 2, 3)
    struct.pack_into("<3f", header, 76, float(vol_xyz.min()), float(vol_xyz.max()),
                     float(vol_xyz.mean()))
    struct.pack_into("<2i", header, 88, 1, 0)
    struct.pack_into("<i", header, 108, 20140)
    struct.pack_into("<3f", header, 196, 0.0, 0.0, 0.0)
    header[208:212] = b"MAP "
    header[212:216] = b"\x44\x44\x00\x00"
    struct.pack_into("<f", header, 216, float(vol_xyz.std()))
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(vol_xyz.transpose(2, 1, 0)).tobytes())


def write_pdb(path: Path, st: Structure) -> None:
    xyz = st.xyz.cpu().numpy().astype(np.float64)
    lines = []
    for i in range(len(xyz)):
        nm = st.name[i]
        field = f" {nm:<3s}" if len(nm) < 4 else nm
        lines.append(f"ATOM  {(i + 1) % 100000:5d} {field} {st.res_name[i]} {st.chain[i]}"
                     f"{(st.res_index[i] + 1) % 10000:4d}    {xyz[i, 0]:8.3f}{xyz[i, 1]:8.3f}"
                     f"{xyz[i, 2]:8.3f}  1.00  0.00           {st.element[i]:>1s}")
    Path(path).write_text("\n".join(lines) + "\nEND\n")


def map_pair(seed: int, traffic: Dict, out_dir: Path, device) -> List[Tuple[Path, Path]]:
    """``traffic['maps']`` (map, docked model) files of the traffic's box,
    each from its own seed."""
    box, voxel = int(traffic["box"]), float(traffic["voxel_size"])
    shape = (box, box, box)
    files = []
    for k in range(int(traffic["maps"])):
        s = derived_seed(seed, 100 + k)
        st = make_structure(s, traffic, box * voxel, device)
        vol = density_map(st, traffic, shape, voxel, s, bool(traffic["masked"]))
        mp, pp = out_dir / f"map{k}.mrc", out_dir / f"docked{k}.pdb"
        write_mrc(mp, vol.cpu().numpy(), voxel)
        write_pdb(pp, st)
        files.append((mp, pp))
        del vol, st
    return files


# ---- training windows ----------------------------------------------------

def _windows(vol: torch.Tensor, core: int, halo: int) -> torch.Tensor:
    """(..., X, Y, Z) -> (nw, ..., w, w, w) zero-padded windows at
    multiples of the core, a view where it can be."""
    w = core + 2 * halo
    shape = vol.shape[-3:]
    counts = [-(-s // core) for s in shape]
    padded = vol.new_zeros(vol.shape[:-3] + tuple((n - 1) * core + w for n in counts))
    padded[..., halo:halo + shape[0], halo:halo + shape[1], halo:halo + shape[2]] = vol
    wins = padded.unfold(-3, w, core).unfold(-3, w, core).unfold(-3, w, core)
    lead = vol.dim() - 3
    wins = wins.reshape(vol.shape[:-3] + (-1, w, w, w))
    return wins.movedim(lead, 0) if lead else wins


def _dilate(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool3d(x[None, None].float(), 3, 1, 1)[0, 0] > 0


def label_volumes(st: Structure, shape, voxel: float):
    """The three label volumes of the training targets (int8): backbone
    and CA masks (0 solvent, 1 the 26-neighbour shell of an atom, 2 another
    atom, 3 a backbone / CA atom) and the amino-acid mask (the residue type
    1..20 around each CA, the lowest type where they meet, 0 at the CA)."""
    dev = st.xyz.device
    idx = torch.round(st.xyz / voxel).long()
    for a in range(3):
        idx[:, a] = idx[:, a].clamp(0, shape[a] - 1)
    flat = (idx[:, 0] * shape[1] + idx[:, 1]) * shape[2] + idx[:, 2]
    n = int(np.prod(shape))

    def occ(sel):
        v = torch.zeros(n, dtype=torch.bool, device=dev)
        v[flat[torch.as_tensor(sel, device=dev)]] = True
        return v.reshape(shape)

    any_atom = occ(np.ones(len(st.name), bool))
    shell = _dilate(any_atom)
    out = []
    for top in (np.isin(st.name, BACKBONE), st.name == "CA"):
        lab = shell.to(torch.int8)
        lab[any_atom] = 2
        lab[occ(top)] = 3
        out.append(lab)
    aa = torch.zeros(shape, dtype=torch.int8, device=dev)
    is_ca = st.name == "CA"
    for t in range(len(AMINO_ACIDS), 0, -1):
        sel = is_ca & (st.res_name == AMINO_ACIDS[t - 1])
        if sel.any():
            aa[_dilate(occ(sel))] = t
    aa[occ(is_ca)] = 0
    out.append(aa)
    return out


def af3_encoding(st: Structure, shape, voxel: float) -> torch.Tensor:
    """(24, X, Y, Z) uint8 on the structure's device: the reference's
    encoding of each atom at its nearest voxel."""
    idx = torch.round(st.xyz / voxel).long().cpu().numpy()
    return torch.from_numpy(prep.encode(st.name, st.res_name, idx, shape)).to(st.xyz.device)


def train_windows(seed: int, traffic: Dict, core: int, halo: int, device,
                  normalize) -> Dict[str, np.ndarray]:
    """``traffic['windows']`` training windows cut from an unmasked map of
    the prediction traffic's kind at 1 A: f32 density (normalized by
    ``normalize``) kept where its max is >= ``min_density_max``, uint8 AF3
    bits of the model and int8 labels, in host memory."""
    box = int(traffic["box"])
    shape = (box, box, box)
    st = make_structure(seed, traffic, box * 1.0, device)
    vol = normalize(density_map(st, traffic, shape, 1.0, seed, False))
    dens = _windows(vol, core, halo)
    keep = torch.nonzero(dens.flatten(1).amax(1) >= float(traffic["min_density_max"]))[:, 0]
    g = generator(derived_seed(seed, 3), device)
    pick = keep[torch.randperm(len(keep), generator=g, device=device)[:int(traffic["windows"])]]
    pick = pick.sort().values
    out = {"density": dens[pick].contiguous().cpu().numpy()}
    out["af3"] = _windows(af3_encoding(st, shape, 1.0), core, halo)[pick].contiguous().cpu().numpy()
    for key, lab in zip(("bb", "ca", "aa"), label_volumes(st, shape, 1.0)):
        out[key] = _windows(lab, core, halo)[pick].contiguous().cpu().numpy()
    return out


# ---- weights -------------------------------------------------------------

def weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 weights for ``shapes``: xavier-normal convs and dense layers
    (std sqrt(2 / ((fan_out + fan_in) * receptive field))), zero biases,
    the FPN's fusion weights 1/3; one draw on the device for all of them."""
    g = generator(derived_seed(seed, 4), device)
    sizes = {k: int(np.prod(s)) for k, s in shapes.items()
             if not k.endswith(".bias") and k != "fpn.weights"}
    flat = torch.randn(sum(sizes.values()), generator=g, device=device)
    out, ofs = {}, 0
    for k, s in shapes.items():
        if k == "fpn.weights":
            out[k] = torch.full(s, 1.0 / 3.0, device=device)
        elif k.endswith(".bias"):
            out[k] = torch.zeros(s, device=device)
        else:
            n = sizes[k]
            std = math.sqrt(2.0 / ((s[0] + s[1]) * math.prod(s[2:])))
            out[k] = (flat[ofs:ofs + n] * std).reshape(s)
            ofs += n
    return out
