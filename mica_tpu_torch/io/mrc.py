"""Self-contained MRC2014 volume I/O (numpy only).

The port's own copy of ``mica_tpu/io/mrc.py``: the two packages share no
code, so the reader and writer are duplicated here unchanged.

Canonical in-memory layout
--------------------------
MRC stores data as (sections, rows, columns) with the header words
``mapc``/``mapr``/``maps`` declaring which crystallographic axis (1=X, 2=Y,
3=Z) each of columns/rows/sections corresponds to.  Downstream code (grid
windowing, candidate extraction, PDB coordinate emission) always works in a
*canonical XYZ layout*: ``volume[x, y, z]`` with a per-axis voxel offset
(from ``nxstart``/``nystart``/``nzstart``) and an origin in Angstroms.  This
mirrors the axis normalization the reference performs in
create_grids.py:67-122 (its ``transpose`` + offset reorder), which is
load-bearing for final PDB coordinates.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Tuple, Union

import numpy as np

_HEADER_SIZE = 1024
_MAP_MAGIC = b"MAP "

# MRC mode -> numpy dtype
_MODE_DTYPES = {
    0: np.dtype(np.int8),
    1: np.dtype(np.int16),
    2: np.dtype(np.float32),
    6: np.dtype(np.uint16),
    12: np.dtype(np.float16),
}
_DTYPE_MODES = {v: k for k, v in _MODE_DTYPES.items()}


@dataclasses.dataclass
class MrcHeader:
    """Subset of the MRC2014 header the pipeline cares about."""

    nx: int = 0  # columns
    ny: int = 0  # rows
    nz: int = 0  # sections
    mode: int = 2
    nxstart: int = 0
    nystart: int = 0
    nzstart: int = 0
    mx: int = 1
    my: int = 1
    mz: int = 1
    cella: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    cellb: Tuple[float, float, float] = (90.0, 90.0, 90.0)
    mapc: int = 1
    mapr: int = 2
    maps: int = 3
    dmin: float = 0.0
    dmax: float = 0.0
    dmean: float = 0.0
    ispg: int = 1
    nsymbt: int = 0
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rms: float = 0.0
    nversion: int = 20140

    @property
    def voxel_size(self) -> np.ndarray:
        """Spacing along crystal X/Y/Z in Angstroms."""
        return np.array(
            [
                self.cella[0] / max(self.mx, 1),
                self.cella[1] / max(self.my, 1),
                self.cella[2] / max(self.mz, 1),
            ],
            dtype=np.float64,
        )


@dataclasses.dataclass
class MrcVolume:
    """An MRC volume: raw (sections, rows, cols) data + header."""

    data: np.ndarray
    header: MrcHeader

    @property
    def voxel_size(self) -> np.ndarray:
        return self.header.voxel_size

    # ---- canonical XYZ layout -------------------------------------------
    def to_xyz(self) -> Tuple[np.ndarray, np.ndarray]:
        """Return ``(volume[x, y, z], offset_xyz)``.

        ``offset_xyz`` is the (nxstart, nystart, nzstart) voxel offset
        reordered to XYZ; the reference computes the same pair in
        create_grids.py:119-122 and uses it as the voxel->Angstrom shift
        when emitting PDB coordinates.
        """
        order = self.xyz_order()
        h = self.header
        start_of_dim = [float(h.nzstart), float(h.nystart), float(h.nxstart)]
        offset = [start_of_dim[d] for d in order]
        return np.transpose(self.data, order), np.asarray(offset, dtype=np.float64)

    def xyz_order(self) -> list:
        """Data-dim permutation such that ``transpose(data, order)`` is the
        canonical ``[x, y, z]`` layout; invert with ``np.argsort(order)``."""
        h = self.header
        # crystal axis (0-based) of each data dim: dim0=sections, 1=rows, 2=cols
        axis_of_dim = [h.maps - 1, h.mapr - 1, h.mapc - 1]
        return [axis_of_dim.index(a) for a in range(3)]

    @property
    def origin_xyz(self) -> np.ndarray:
        return np.asarray(self.header.origin, dtype=np.float64)


def read_mrc(path: Union[str, Path]) -> MrcVolume:
    """Read an MRC/CCP4 map file."""
    raw = Path(path).read_bytes()
    if len(raw) < _HEADER_SIZE:
        raise ValueError(f"{path}: file too small for an MRC header")

    magic = raw[208:212]
    machst = raw[212:216]
    # Machine stamp: 0x44 0x44/0x41 -> little endian, 0x11 -> big endian.
    if machst[:1] == b"\x11":
        bo = ">"
    else:
        bo = "<"
    if magic not in (_MAP_MAGIC, b"MAP\x00"):
        # Tolerate pre-2014 CCP4 maps without the magic but sane dims.
        pass

    def ints(off, n):
        return struct.unpack(f"{bo}{n}i", raw[off : off + 4 * n])

    def floats(off, n):
        return struct.unpack(f"{bo}{n}f", raw[off : off + 4 * n])

    nx, ny, nz, mode = ints(0, 4)
    nxstart, nystart, nzstart = ints(16, 3)
    mx, my, mz = ints(28, 3)
    cella = floats(40, 3)
    cellb = floats(52, 3)
    mapc, mapr, maps = ints(64, 3)
    dmin, dmax, dmean = floats(76, 3)
    ispg, nsymbt = ints(88, 2)
    originx, originy, originz = floats(196, 3)
    rms = floats(216, 1)[0]
    nversion = ints(108, 1)[0]

    if mode not in _MODE_DTYPES:
        raise ValueError(f"{path}: unsupported MRC mode {mode}")
    if not (1 <= mapc <= 3 and 1 <= mapr <= 3 and 1 <= maps <= 3):
        raise ValueError(f"{path}: invalid axis order {mapc},{mapr},{maps}")
    if sorted((mapc, mapr, maps)) != [1, 2, 3]:
        raise ValueError(f"{path}: axis order is not a permutation: {mapc},{mapr},{maps}")

    dtype = _MODE_DTYPES[mode].newbyteorder(bo)
    data_offset = _HEADER_SIZE + nsymbt
    count = nx * ny * nz
    flat = np.frombuffer(raw, dtype=dtype, count=count, offset=data_offset)
    data = flat.reshape(nz, ny, nx)
    if bo == ">":
        data = data.astype(data.dtype.newbyteorder("<"))
    else:
        # frombuffer over bytes is read-only; copy so data is writable
        # regardless of file endianness (the BE branch copies via astype)
        data = data.copy()

    header = MrcHeader(
        nx=nx, ny=ny, nz=nz, mode=mode,
        nxstart=nxstart, nystart=nystart, nzstart=nzstart,
        mx=mx, my=my, mz=mz,
        cella=tuple(cella), cellb=tuple(cellb),
        mapc=mapc, mapr=mapr, maps=maps,
        dmin=dmin, dmax=dmax, dmean=dmean,
        ispg=ispg, nsymbt=0,
        origin=(originx, originy, originz),
        rms=rms, nversion=nversion,
    )
    return MrcVolume(data=np.ascontiguousarray(data), header=header)


def write_mrc(
    path: Union[str, Path],
    data: np.ndarray,
    voxel_size: Union[float, Tuple[float, float, float]] = 1.0,
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    nstart: Tuple[int, int, int] = (0, 0, 0),
    axis_order: Tuple[int, int, int] = (1, 2, 3),
) -> None:
    """Write ``data`` (sections, rows, cols) as an MRC2014 file.

    Mirrors what the reference persists via mrcfile in
    preprocessing.py:138-148: voxel size, origin, nstart and axis order are
    all preserved so coordinates survive a round-trip.
    """
    data = np.asarray(data)
    if data.ndim != 3:
        raise ValueError("MRC data must be 3-D (sections, rows, cols)")
    dt = np.dtype(data.dtype)
    if dt not in _DTYPE_MODES:
        data = data.astype(np.float32)
        dt = np.dtype(np.float32)
    mode = _DTYPE_MODES[dt]

    nz, ny, nx = data.shape
    if np.isscalar(voxel_size):
        voxel_size = (float(voxel_size),) * 3
    # Samples along each *crystal* axis: cols carry axis `mapc`, rows `mapr`,
    # sections `maps`. cella = spacing * samples per crystal axis.
    counts_by_axis = [0, 0, 0]
    for count, axis in ((nx, axis_order[0]), (ny, axis_order[1]), (nz, axis_order[2])):
        counts_by_axis[axis - 1] = count
    mxyz = tuple(counts_by_axis)
    cella = tuple(voxel_size[a] * mxyz[a] for a in range(3))

    finite = data[np.isfinite(data)] if not np.issubdtype(dt, np.integer) else data
    dmin = float(finite.min()) if finite.size else 0.0
    dmax = float(finite.max()) if finite.size else 0.0
    dmean = float(finite.mean()) if finite.size else 0.0
    rms = float(finite.std()) if finite.size else 0.0

    hdr = bytearray(_HEADER_SIZE)

    def put_i(off, *vals):
        struct.pack_into(f"<{len(vals)}i", hdr, off, *[int(v) for v in vals])

    def put_f(off, *vals):
        struct.pack_into(f"<{len(vals)}f", hdr, off, *[float(v) for v in vals])

    put_i(0, nx, ny, nz, mode)
    put_i(16, nstart[0], nstart[1], nstart[2])
    put_i(28, *mxyz)  # sampling grid matches the data grid
    put_f(40, *cella)
    put_f(52, 90.0, 90.0, 90.0)
    put_i(64, axis_order[0], axis_order[1], axis_order[2])
    put_f(76, dmin, dmax, dmean)
    put_i(88, 1, 0)  # ispg, nsymbt
    put_i(108, 20140)  # nversion
    put_f(196, *origin)
    hdr[208:212] = _MAP_MAGIC
    hdr[212:216] = b"\x44\x44\x00\x00"  # little-endian machine stamp
    put_f(216, rms)
    put_i(220, 1)  # nlabl
    hdr[224 : 224 + 80] = b"Created by mica_tpu_torch".ljust(80)

    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(np.ascontiguousarray(data).tobytes())



def write_mrc_like(
    path: Union[str, Path], data: np.ndarray, like: MrcVolume,
    voxel_size: Union[float, Tuple[float, float, float], None] = None,
) -> None:
    """Write ``data`` reusing origin/nstart/axis-order metadata from ``like``."""
    h = like.header
    vs = like.voxel_size if voxel_size is None else voxel_size
    write_mrc(
        path, data,
        voxel_size=vs if np.ndim(vs) else (float(vs),) * 3,
        origin=h.origin,
        nstart=(h.nxstart, h.nystart, h.nzstart),
        axis_order=(h.mapc, h.mapr, h.maps),
    )
