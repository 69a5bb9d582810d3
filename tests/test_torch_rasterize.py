"""The port's AF3 bitfield rasterizer (``ops.rasterize.rasterize_af3_bits``)
on the CPU: bit for bit the words the engine packs from the nearest splat's
(24, X, Y, Z) volume, in the port and in the JAX package."""

import numpy as np
import pytest

from mica_tpu.infer.engine import pack_af_encoding as jpack_af_encoding
from mica_tpu.ops import rasterize as jrasterize
from mica_tpu_torch.infer.engine import pack_af_encoding
from mica_tpu_torch.io.pdb import AMINO_ACIDS, ATOM_DTYPE
from mica_tpu_torch.ops import rasterize

NAMES = ["CA", "N", "C", "O", "CB", "CG", "OXT"]
RES = AMINO_ACIDS + ["UNK"]


def _atoms(xyz, names, res):
    rows = [(i + 1, n, "", r, "A", i // 4 + 1, "", x, y, z, 1.0, 0.0, n[:1], False)
            for i, ((x, y, z), n, r) in enumerate(zip(xyz, names, res))]
    return np.array(rows, dtype=ATOM_DTYPE)


def _random(rng, n, lo, hi):
    xyz = rng.uniform(lo, hi, (n, 3))
    return _atoms(xyz, rng.choice(NAMES, n), rng.choice(RES, n))


def _stacked(rng):
    """Atoms of every name and type on two voxels, so one voxel takes many
    channels and many atoms write each bit."""
    n = 3 * len(RES)
    xyz = np.where(np.arange(n)[:, None] % 2, [3.2, 4.9, 1.1], [5.4, 2.1, 6.6])
    return _atoms(xyz, [NAMES[i % len(NAMES)] for i in range(n)], RES * 3)


def _clipped(rng):
    """Atoms beyond every face and edge of the box (and on it)."""
    faces = [(-7.0, 4.0, 4.0), (40.0, 4.0, 4.0), (4.0, -0.6, 4.0), (4.0, 9.7, 4.0),
             (4.0, 4.0, -30.0), (4.0, 4.0, 10.4), (-2.0, -2.0, -2.0), (50.0, 50.0, 50.0),
             (0.0, 0.0, 0.0), (8.6, 9.4, 10.2)]
    return _atoms(faces, [NAMES[i % 4] for i in range(len(faces))],
                  [RES[i] for i in range(len(faces))])


CASES = {
    "stacked": (_stacked, (8, 8, 8), {}),
    "clipped": (_clipped, (9, 10, 11), {}),
    "geometry": (lambda rng: _random(rng, 300, -3.0, 40.0), (13, 17, 11),
                 dict(origin=(2.5, -4.0, 7.25), voxel_size=1.7, nstart=(3, -2, 1))),
    "non_cubic": (lambda rng: _random(rng, 500, -2.0, 30.0), (31, 7, 19), {}),
    "empty": (lambda rng: _atoms([], [], []), (6, 5, 4), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bits_equal_the_packed_encoding(case):
    make, shape, geom = CASES[case]
    atoms = make(np.random.default_rng(5))
    bits = rasterize.rasterize_af3_bits(atoms, shape, **geom)
    assert bits.shape == shape and bits.dtype == np.uint32
    enc = rasterize.rasterize_af3_encoding(atoms, shape, **geom)
    np.testing.assert_array_equal(bits, pack_af_encoding(enc))
    want = jpack_af_encoding(jrasterize.rasterize_af3_encoding(atoms, shape, **geom))
    np.testing.assert_array_equal(bits, want)
    if case == "empty":
        assert not bits.any()
    else:
        assert bits.any()
    if case == "stacked":
        # both voxels hold every backbone channel and every residue type
        assert sorted(np.unique(bits).tolist()) == [0, (1 << 24) - 1]
