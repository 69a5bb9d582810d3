"""The port's training-label masks and window decomposition against the
JAX package's, on the CPU.

Masks are numpy on both sides and must be equal, element for element: on a
``make_scenario`` chain with backbone and side-chain atoms, and on atoms
that collide in one voxel (an atom over a shell, a backbone atom over a
side-chain one, two CAs of different types), in the unit geometry and at a
non-zero origin and nstart with a 1.3 A voxel.  ``extract_windows`` and
``stitch_windows`` must equal the JAX functions exactly on odd shapes, with
and without a channel axis, at two core/halo settings, and
``stitch(extract(v))`` returns ``v``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mica_tpu.ops import masks as jmasks
from mica_tpu.ops import window as jwindow
from mica_tpu_torch.io import pdb as pdb_io
from mica_tpu_torch.ops import masks, window
from mica_tpu_torch.utils.synthetic import make_scenario

SHAPE = (40, 36, 44)
GEOMETRIES = {"unit": dict(origin=(0.0, 0.0, 0.0), voxel_size=1.0, nstart=(0.0, 0.0, 0.0)),
              "shifted": dict(origin=(5.0, -3.0, 2.5), voxel_size=1.3, nstart=(2.0, 1.0, 3.0))}


def _atoms(tmp_path, kind: str, geom: dict) -> np.ndarray:
    """A parsed PDB whose atoms sit at voxel positions of ``SHAPE`` under
    ``geom``: each scenario residue's N, CA, C, O and CB, or a handful of
    atoms placed to collide."""
    if kind == "scenario":
        ca, seq, _ = make_scenario(n_res=30, shape=SHAPE, seed=5)
        res = [pdb_io.ONE_TO_THREE[c] for c in seq]
        offsets = {"N": (-1.2, 0.6, 0.2), "CA": (0, 0, 0), "C": (1.3, 0.5, -0.3),
                   "O": (1.9, 1.4, -0.6), "CB": (-0.4, -1.4, 0.9)}
        rows = [(name, res[i], i + 1, c + np.asarray(off))
                for i, c in enumerate(ca) for name, off in offsets.items()]
    else:
        base = np.array([10.0, 12.0, 9.0])
        rows = [("CB", "LEU", 1, base), ("CA", "LEU", 1, base + 0.2),   # one voxel
                ("N", "LEU", 1, base + (1.0, 0, 0)),                  # over CA's shell
                ("CA", "TRP", 2, base + (0.1, 0.1, -0.1)),            # a second CA there
                ("CA", "ALA", 3, base + (2.0, 0, 0)),                 # neighbourhoods overlap
                ("CA", "GLY", 4, (0.2, 0.1, 43.8)),                   # at the volume's edge
                ("O", "GLY", 4, (0.4, 0.3, 43.6))]
    scale = geom["voxel_size"]
    lines = []
    for serial, (name, res, seq_id, vox) in enumerate(rows, 1):
        xyz = (np.asarray(vox) + geom["nstart"]) * scale + geom["origin"]
        lines.append(pdb_io.format_atom_line(serial, name, res, "A", seq_id, xyz, 1.0, 0.0,
                                             name[0]))
    path = tmp_path / f"{kind}.pdb"
    path.write_text("\n".join(lines) + "\nEND\n")
    return pdb_io.parse_pdb(path)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("kind", ["scenario", "collisions"])
def test_masks_equal_jax(tmp_path, kind, geometry):
    geom = GEOMETRIES[geometry]
    atoms = _atoms(tmp_path, kind, geom)
    for name in ("backbone_mask", "carbon_alpha_mask", "amino_acid_mask"):
        got = getattr(masks, name)(atoms, SHAPE, **geom)
        want = getattr(jmasks, name)(atoms, SHAPE, **geom)
        assert got.dtype == want.dtype and got.shape == SHAPE, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    bb = masks.backbone_mask(atoms, SHAPE, **geom)
    aa = masks.amino_acid_mask(atoms, SHAPE, **geom)
    if kind == "scenario":
        assert set(np.unique(bb).tolist()) == {0, 1, 2, 3}
    else:
        # CA over CB in one voxel: the backbone atom wins; the voxel between
        # the colliding CAs and the ALA takes the lowest type, the CAs' 0
        assert bb[10, 12, 9] == 3 and aa[10, 12, 9] == 0
        assert aa[11, 12, 9] == min(pdb_io.AMINO_ACIDS.index(r) + 1
                                    for r in ("LEU", "TRP", "ALA"))
    assert aa.max() > 0


@pytest.mark.parametrize("shape,core,halo", [((50, 37, 61), 12, 3), ((70, 53, 49), 48, 8)])
def test_windows_equal_jax(shape, core, halo):
    rng = np.random.default_rng(1)
    vol = rng.standard_normal(shape).astype(np.float32)
    chans = rng.standard_normal((3,) + shape).astype(np.float32)

    got = window.extract_windows(torch.from_numpy(vol), core, halo)
    want = np.asarray(jwindow.extract_windows(jnp.asarray(vol), core, halo))
    np.testing.assert_array_equal(got.numpy(), want)
    got_c = window.extract_windows(torch.from_numpy(chans), core, halo)
    want_c = np.stack([np.asarray(jwindow.extract_windows(jnp.asarray(c), core, halo))
                       for c in chans], axis=1)
    np.testing.assert_array_equal(got_c.numpy(), want_c)

    preds = rng.standard_normal(want.shape).astype(np.float32)
    preds_c = rng.standard_normal(want_c.shape).astype(np.float32)
    for p in (preds, preds_c):
        np.testing.assert_array_equal(
            window.stitch_windows(torch.from_numpy(p), shape, core, halo).numpy(),
            np.asarray(jwindow.stitch_windows(jnp.asarray(p), shape, core, halo)))

    assert torch.equal(window.stitch_windows(got, shape, core, halo), torch.from_numpy(vol))
    assert torch.equal(window.stitch_windows(got_c, shape, core, halo), torch.from_numpy(chans))


def test_extract_windows_keeps_integer_dtypes():
    vol = torch.arange(9 * 10 * 11, dtype=torch.int32).reshape(9, 10, 11)
    wins = window.extract_windows(vol.to(torch.uint8), 4, 2)
    assert wins.dtype == torch.uint8 and wins.shape == (3 * 3 * 3, 8, 8, 8)
    assert torch.equal(window.stitch_windows(wins, (9, 10, 11), 4, 2), vol.to(torch.uint8))
