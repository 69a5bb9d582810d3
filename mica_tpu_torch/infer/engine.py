"""Sliding-window inference engine, on one card or on every rank of a
data-parallel world.

Port of ``mica_tpu/infer/engine.py`` without its chunked dispatch (a
JAX remedy for per-dispatch RPC latency).  The padded map stays on the
device; each batch

  1. gathers its 64^3 windows (density + bit-packed 24-channel AF3
     encoding, unpacked on the device) out of the padded volumes: K9,
  2. runs the MICA forward (bf16 by default),
  3. slices the logits to the 48^3 core and applies the softmax
     post-process (the aa head slices inside the model, before its 1x1),
  4. writes each core into the output volumes (cores tile the volume): K10.

The window starts go to the device once per map.  Average blend
accumulates overlapping windows and a fractional AF3 encoding cannot be
bit-packed; neither is what K9/K10 compute, so those two modes move their
windows with torch slices.

All-zero windows give identical outputs, so in core blend the volumes
start as a tiling of the all-zero window's core and only nonempty windows
are computed.

With a ``mesh`` (``parallel/mesh.py``), each rank computes its share of
every batch's windows (K9 gathers only those), the computed outputs go to
every rank (``parallel.distributed.exchange_rows``), and K10 pastes them:
in the replicated mode every rank pastes every core and returns the same
full volumes; with ``shard_volumes`` each rank holds an X slab of the
volumes (the X core count padded to a multiple of the world size) and
pastes only the cores whose X start falls in it, chosen on the host and
shifted by the slab's offset.  Without a mesh nothing is exchanged.

``dump_windows_dir`` writes each window's outputs to ``.npz`` files, the
empty windows' from the all-zero window: ``"compact"``, one file a window
with what the forward returned; ``"reference"``, the original's per-grid
layout, four files a window with the full window's ``data`` and its
``metadata``.  In the reference layout the forward returns full windows;
K9 still gathers them and K10 pastes their cores.  Only the dump copies
to the host.  Under a mesh only rank 0 writes dumps.
"""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.convert import state_dict_from_jax_params
from ..models.mica import MICA
from ..ops.window import CORE, HALO, window_counts, window_starts
from ..ops.window_copy import gather_windows, scatter_cores, starts_tensor
from ..parallel import distributed
from ..parallel.mesh import make_mesh, pad_to_multiple
from ..utils.spans import count, span

NUM_AA = 20
NUM_AF_CHANNELS = 24


def pack_af_encoding(af: np.ndarray) -> np.ndarray:
    """Pack a binary (24, X, Y, Z) AF3 encoding into uint32 bitfields."""
    af = np.asarray(af)
    packed = np.zeros(af.shape[1:], np.uint32)
    for c in range(af.shape[0]):
        packed |= (af[c] > 0).astype(np.uint32) << np.uint32(c)
    return packed


def unpack_af_bits(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(...) int32 bitfields (the uint32 words viewed as int32; 24 bits are
    used) -> (..., 24) channels-last floats."""
    shifts = torch.arange(NUM_AF_CHANNELS, device=packed.device, dtype=packed.dtype)
    return ((packed[..., None] >> shifts) & 1).to(dtype)


def auto_batch_size(max_batch: int = 8, device=None) -> int:
    """Largest batch up to ``max_batch`` whose activations (~1.5 GB per
    bf16 64^3 window) fit 70 % of the card's memory."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return max_batch
    total = torch.cuda.get_device_properties(dev).total_memory
    return int(max(1, min(max_batch, 0.7 * total // (1.5 * 1024 ** 3))))


def best_core(shape, halo: int = HALO, candidates=(48, 64, 112),
              max_batch: int = 8) -> Tuple[int, int]:
    """Window geometry with the fewest computed voxels for ``shape``
    (``prod(ceil(s/core)) * window^3``), the batch scaled to keep the
    activation footprint of ``max_batch`` 64^3 windows.  The card's rate
    per geometry is not measured yet, so it is not weighed in.  Per-window
    InstanceNorm makes a non-default geometry's output differ slightly."""
    best = None
    for core in candidates:
        win = core + 2 * halo
        cost = int(np.prod([-(-s // core) for s in shape])) * win ** 3
        if best is None or cost < best[0]:
            best = (cost, core, max(1, int(max_batch * 64 ** 3 / win ** 3)))
    return best[1], best[2]


def _window_nonempty(padded: np.ndarray, counts, core: int, halo: int) -> np.ndarray:
    """Per-window occupancy flags over a halo-padded volume (3-D, or 4-D
    channels-last), in ``window_starts`` order: a blockwise any plus a
    separable running max over the window footprint."""
    win = core + 2 * halo
    g = int(np.gcd(core, 2 * halo)) if halo else core
    a = padded
    if a.ndim == 4:
        a = (a != 0).any(axis=-1)
    occ = a != 0
    gx, gy, gz = (s // g for s in occ.shape)
    r = occ[: gx * g, : gy * g, : gz * g].reshape(gx, g, gy, g, gz, g).any(axis=(1, 3, 5))
    wb, sb = win // g, core // g
    out = r
    for ax, n in enumerate(counts):
        idx = sb * np.arange(n)
        out = np.maximum.reduce([np.take(out, idx + k, axis=ax) for k in range(wb)])
    return out.reshape(-1)


def postprocess_logits(bb: torch.Tensor, ca: torch.Tensor, aa: torch.Tensor):
    """(bb_prob, ca_prob, aa_prob), shapes (..., 1/1/20): bb/ca keep
    P(class 3) of the softmax over classes {0, 2, 3}; aa is the softmax
    over classes 1..20."""
    def p_atom(x):
        x0, x2, x3 = x[..., 0], x[..., 2], x[..., 3]
        m = torch.maximum(torch.maximum(x0, x2), x3)
        e0, e2, e3 = torch.exp(x0 - m), torch.exp(x2 - m), torch.exp(x3 - m)
        return e3 / (e0 + e2 + e3)

    return p_atom(bb)[..., None], p_atom(ca)[..., None], torch.softmax(aa[..., 1:], dim=-1)


def _core_of(t: torch.Tensor, halo: int, core: int, batched: bool = True) -> torch.Tensor:
    """The core cube of full windows (n, w, w, w[, A]), or of one window."""
    c = slice(halo, halo + core)
    return t[:, c, c, c] if batched else t[c, c, c]


def _dump_window(dump_dir: Path, reference: bool, bb: np.ndarray, ca: np.ndarray,
                 aa: np.ndarray, start, core: int, shape) -> None:
    """One window's dump files; ``aa`` is channels-last."""
    i, j, k = (int(v) for v in start)
    if not reference:
        np.savez_compressed(dump_dir / f"win_i{i}_j{j}_k{k}.npz", backbone=bb,
                            carbon_alpha=ca, amino_acid=aa,
                            start=np.asarray(start, np.int32))
        return
    stem = f"grid_i{i}_j{j}_k{k}"
    aa_first = np.moveaxis(aa, -1, 0)
    quantities = {
        "backbone_probability": bb,
        "carbon_alpha_probability": ca,
        "amino_acid_probability": aa_first,
        "amino_acid_prediction": np.argmax(aa_first, axis=0),
    }
    meta = {
        "i": i, "j": j, "k": k,
        "di": int(min(core, shape[0] - i)),
        "dj": int(min(core, shape[1] - j)),
        "dk": int(min(core, shape[2] - k)),
        "orig_shape": np.asarray(shape),
        "filename": stem,
    }
    for key, data in quantities.items():
        np.savez(dump_dir / f"{stem}_{key}.npz", data=data, metadata=meta)


def _to_host(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Tensors of one device on the host as numpy arrays, their bytes
    counted.  From a card each lands, in C order, in page-locked memory
    from torch's caching host allocator: made contiguous on the card one
    at a time (at most one device temporary alive), its copy enqueued on
    the current stream, and one synchronize after the last.  A pinned
    block goes back to the cache once every array on it is dropped, so the
    next call's volumes reuse it; arrays that are kept stay pinned."""
    if tensors[0].device.type != "cuda":
        out = [t.cpu().numpy() for t in tensors]
    else:
        pinned = []
        for t in tensors:
            a = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            a.copy_(t.contiguous(), non_blocking=True)
            pinned.append(a)
        torch.cuda.current_stream(tensors[0].device).synchronize()
        out = [a.numpy() for a in pinned]
    count("d2h_bytes", sum(a.nbytes for a in out))
    return out


def _as_state_dict(params) -> Mapping:
    """A torch state dict as is; a JAX parameter tree (nested mappings,
    no dotted keys) through the weight carrier."""
    if any("." in str(k) for k in params) or not any(
            isinstance(v, Mapping) for v in params.values()):
        return params
    return state_dict_from_jax_params(params)




class SlidingWindowPredictor:
    """Batched sliding-window predictor for arbitrary-size volumes."""

    def __init__(self, params_or_state_dict, batch_size: int = 8,
                 dtype: torch.dtype = torch.bfloat16, base_filters: int = 64,
                 core: int = CORE, halo: int = HALO, blend: str = "core",
                 device=None, mesh=None, use_mesh: bool = False,
                 shard_volumes: bool = False):
        """``params_or_state_dict``: a ``MICA`` module, a torch state dict
        or a JAX parameter tree.  ``blend``: 'core' pastes each window's
        core; 'average' accumulates full windows and divides by the count.
        ``device`` None means the card (the mesh's, given a mesh), and
        raises where there is none.

        ``mesh``: the data-parallel world (``parallel.mesh.make_mesh``;
        ``use_mesh`` makes it when none is given); ``batch_size`` is then
        the global batch, rounded up to a multiple of the world size.
        ``shard_volumes``: each rank keeps an X slab of the volumes, not
        the whole (needs a mesh and blend='core')."""
        if blend not in ("core", "average"):
            raise ValueError(f"unknown blend mode {blend!r}")
        if mesh is None and use_mesh:
            mesh = make_mesh(device)
        self.shard_volumes = bool(shard_volumes)
        if self.shard_volumes and (mesh is None or blend != "core"):
            raise ValueError("shard_volumes requires a mesh and blend='core'")
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None and device is None
                                     else device)
        self.blend = blend
        if isinstance(params_or_state_dict, MICA):
            model = params_or_state_dict
            model.dtype = dtype
        else:
            model = MICA(base=base_filters, dtype=dtype)
            model.load_state_dict(_as_state_dict(params_or_state_dict), strict=True)
        self.model = model.to(self.device).eval()
        self.core, self.halo = int(core), int(halo)
        self.window = self.core + 2 * self.halo
        self.batch_size = int(batch_size)
        if mesh is not None:
            self.batch_size = pad_to_multiple(self.batch_size, mesh.size)
        self.timing: Dict[str, float] = {}
        self.n_forwards = 0
        self._zero_cores: Dict = {}

    @property
    def _exchanges(self) -> bool:
        """Ranks exchange outputs: a process group is up."""
        return self.mesh is not None and self.mesh.distributed

    @torch.no_grad()
    def _forward(self, windows: torch.Tensor, af: Optional[torch.Tensor], full: bool):
        """(n, w, w, w) f32 windows (+ packed or float AF windows) ->
        (bb (n,S,S,S), ca, aa (n,S,S,S,20)) probabilities, S = core (or
        the window when ``full``)."""
        if af is not None:
            af = (unpack_af_bits(af, torch.float32) if af.dtype == torch.int32
                  else af.float())
        sl = slice(None) if full else slice(self.halo, self.halo + self.core)
        bb, ca, aa = self.model(windows[..., None], af, out_slice=None if full else sl)
        self.n_forwards += 1
        bb_p, ca_p, aa_p = postprocess_logits(bb[:, sl, sl, sl], ca[:, sl, sl, sl], aa)
        return bb_p[..., 0], ca_p[..., 0], aa_p

    def _zero_core(self, with_af: bool, af_float: bool, full: bool):
        """The all-zero window's outputs; under a mesh rank 0's, so every
        rank tiles the same values."""
        key = (with_af, af_float, full)
        if key not in self._zero_cores:
            w = self.window
            wins = torch.zeros((1, w, w, w), dtype=torch.float32, device=self.device)
            af = None
            if with_af:
                af = (torch.zeros((1, w, w, w, NUM_AF_CHANNELS), device=self.device)
                      if af_float else torch.zeros((1, w, w, w), dtype=torch.int32,
                                                   device=self.device))
            z = tuple(t[0] for t in self._forward(wins, af, full))
            if self._exchanges:
                distributed.broadcast_(z)
            self._zero_cores[key] = z
        return self._zero_cores[key]

    def _no_rows(self, full: bool):
        """A rank's outputs when a short batch leaves it no window."""
        s = self.window if full else self.core
        z = torch.empty((0, s, s, s), device=self.device)
        return z, z, torch.empty((0, s, s, s, NUM_AA), device=self.device)

    def predict_volume(self, volume: np.ndarray,
                       af_encoding: Optional[np.ndarray] = None,
                       keep_on_device: bool = False,
                       dump_windows_dir: Optional[str] = None,
                       dump_format: str = "compact") -> Dict:
        """Predict BB/CA/AA volumes for a normalized ``volume[x, y, z]``;
        ``af_encoding`` is (24, X, Y, Z), its (X, Y, Z) uint32 bitfield
        (``pack_af_encoding``'s words) or None.  Returns
        ``backbone_probability``, ``carbon_alpha_probability`` (X,Y,Z),
        ``amino_acid_probability`` (20,X,Y,Z) and ``amino_acid_prediction``
        (X,Y,Z; argmax 0..19) as numpy arrays, or with ``keep_on_device``
        as tensors on the predictor's device (nothing is copied to the
        host; candidate extraction reads them there).  From a card the
        numpy volumes are C-ordered and live in page-locked host memory
        from torch's caching host allocator, which a later call reuses once
        they are dropped; volumes the caller holds stay pinned, so a caller
        that keeps several maps' volumes keeps that many blocks pinned
        (each rounded up to a power of two bytes).  Under a mesh every
        rank calls this together and gets the same volumes; with
        ``shard_volumes`` the numpy volumes are gathered slab by slab
        through the host, and ``keep_on_device`` returns this rank's slab
        (its X rows inside the volume) with its first row under
        ``x_offset``.

        ``dump_windows_dir``: also write every window's outputs there in
        ``dump_format``, ``"compact"`` (``win_i{i}_j{j}_k{k}.npz``: what
        the forward returned, the core or in average blend the full window,
        channels-last AA, and ``start``) or ``"reference"`` (four
        ``grid_i{i}_j{j}_k{k}_<quantity>.npz`` a window, each the full
        window's ``data``, AA channels-first, and a ``metadata`` dict of
        i/j/k, the core extents di/dj/dk inside the volume, ``orig_shape``
        and ``filename``)."""
        if dump_format not in ("compact", "reference"):
            raise ValueError(f"unknown dump_format {dump_format!r}")
        dump_dir = None if dump_windows_dir is None else Path(dump_windows_dir)
        dump_reference = dump_dir is not None and dump_format == "reference"
        if dump_reference and self.shard_volumes:
            raise ValueError("reference-layout dumps need replicated outputs")
        with span("engine.setup") as setup:
            dev = self.device
            mesh, exchanges = self.mesh, self._exchanges
            writes = mesh is None or mesh.is_main
            core_n, halo, win = self.core, self.halo, self.window
            shape = tuple(volume.shape)
            counts = window_counts(shape, core_n)
            padded_shape = tuple(n * core_n for n in counts)
            pads = [(halo, (padded_shape[a] - core_n) + win - halo - shape[a]) for a in range(3)]
            with span("engine.pad"):
                np_padded = np.pad(np.asarray(volume, np.float32), pads)
            with span("engine.h2d"):
                padded_map = torch.from_numpy(np_padded).to(dev)
                count("h2d_bytes", np_padded.nbytes)

            np_af, padded_af, af_float = None, None, False
            if af_encoding is not None:
                with span("engine.pack"):
                    if af_encoding.ndim == 3 and af_encoding.dtype == np.uint32:
                        packed = af_encoding
                        count("af_prepacked", 1)
                    else:
                        af_arr = np.asarray(af_encoding)
                        if af_arr.dtype.kind in "iub":
                            binary = af_arr.min() >= 0 and af_arr.max() <= 1
                        else:
                            binary = bool(((af_arr == 0) | (af_arr == 1)).all())
                        if binary:
                            packed = pack_af_encoding(af_arr)
                            count("af_repacked", 1)
                        else:
                            # fractional encodings cannot be bit-packed
                            packed = np.moveaxis(af_arr.astype(np.float32), 0, -1)
                            af_float = True
                    if not af_float:
                        # 24 bits used: the int32 view of the bitfield is exact
                        packed = packed.view(np.int32)
                with span("engine.pad"):
                    np_af = np.pad(packed, pads + [(0, 0)] if af_float else pads)
                with span("engine.h2d"):
                    padded_af = torch.from_numpy(np_af).to(dev)
                    count("h2d_bytes", np_af.nbytes)
            with_af = np_af is not None

            starts = window_starts(shape, core_n)
            with span("engine.occupancy"):
                nonempty = _window_nonempty(np_padded, counts, core_n, halo)
                if with_af:
                    nonempty |= _window_nonempty(np_af, counts, core_n, halo)
            compute_starts = starts[nonempty]
            empty_starts = starts[~nonempty]
            self.timing["n_empty"] = int(len(empty_starts))

            # this rank's X slab of the volumes: all of them unless sharded
            x0, x_local = 0, padded_shape[0]
            if self.shard_volumes:
                x_local = pad_to_multiple(counts[0], mesh.size) // mesh.size * core_n
                x0 = mesh.rank * x_local

            average = self.blend == "average"
            full = average or dump_reference
            forwards0 = self.n_forwards
            need_zero = not average or len(empty_starts)
            z = self._zero_core(with_af, af_float, full) if need_zero else None
            if average:
                acc_shape = tuple(np_padded.shape)
                bb_v = torch.zeros(acc_shape, device=dev)
                ca_v = torch.zeros(acc_shape, device=dev)
                aa_v = torch.zeros(acc_shape + (NUM_AA,), device=dev)
                cnt_v = torch.zeros(acc_shape, device=dev)
                vols = (bb_v, ca_v, aa_v, cnt_v)
            else:
                reps = (x_local // core_n,) + tuple(counts[1:])
                zc = tuple(_core_of(v, halo, core_n, batched=False) for v in z) if full else z
                bb_v = zc[0].repeat(reps)
                ca_v = zc[1].repeat(reps)
                aa_v = zc[2].repeat(reps + (1,))
                vols = (bb_v, ca_v, aa_v)
            self.timing["acc_bytes_per_device"] = int(sum(v.numel() * v.element_size()
                                                          for v in vols))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.timing["setup"] = setup.seconds

        def paste(bb_c, ca_c, aa_c, s):
            x, y, zz = (int(v) for v in s)
            if average:
                w = bb_c.shape[0]
                bb_v[x:x + w, y:y + w, zz:zz + w] += bb_c
                ca_v[x:x + w, y:y + w, zz:zz + w] += ca_c
                aa_v[x:x + w, y:y + w, zz:zz + w] += aa_c
                cnt_v[x:x + w, y:y + w, zz:zz + w] += 1.0
            elif x0 <= x < x0 + x_local:
                c, x = core_n, x - x0
                bb_v[x:x + c, y:y + c, zz:zz + c] = bb_c
                ca_v[x:x + c, y:y + c, zz:zz + c] = ca_c
                aa_v[x:x + c, y:y + c, zz:zz + c] = aa_c

        if dump_dir is not None and writes:
            dump_dir.mkdir(parents=True, exist_ok=True)

        def dump(outs, batch):
            if dump_dir is None or not writes:
                return
            bb_c, ca_c, aa_c = (v.cpu().numpy() for v in outs)
            for i, s in enumerate(batch):
                _dump_window(dump_dir, dump_reference, bb_c[i], ca_c[i], aa_c[i], s,
                             core_n, shape)

        with span("engine.inference") as inference:
            bsz = self.batch_size
            copy_kernels = not average and not af_float
            if copy_kernels and len(compute_starts):
                # a window's origin in the padded frame is its core's start
                dev_starts = starts_tensor(compute_starts, padded_map.shape, win, dev)
                # the cores K10 pastes into this rank's slab, shifted into it;
                # starts run x-major, so a batch's share is one run of rows
                in_slab = (compute_starts[:, 0] >= x0) & (compute_starts[:, 0] < x0 + x_local)
                slab_starts = dev_starts
                if self.shard_volumes:
                    slab_starts = starts_tensor(compute_starts[in_slab] - np.array([x0, 0, 0]),
                                                bb_v.shape, core_n, dev)
                slab_before = np.concatenate([[0], np.cumsum(in_slab)])
            for ofs in range(0, len(compute_starts), bsz):
                batch = compute_starts[ofs:ofs + bsz]
                mine = mesh.rows(len(batch)) if mesh is not None else slice(0, len(batch))
                if mine.stop == mine.start:
                    outs = self._no_rows(full)
                elif copy_kernels:
                    got = gather_windows(padded_map, padded_af,
                                         dev_starts[ofs + mine.start:ofs + mine.stop], win)
                    wins, afs = got if with_af else (got, None)
                    outs = self._forward(wins, afs, full)
                else:
                    wins = torch.stack([padded_map[x:x + win, y:y + win, zz:zz + win]
                                        for x, y, zz in batch[mine]])
                    afs = None
                    if with_af:
                        afs = torch.stack([padded_af[x:x + win, y:y + win, zz:zz + win]
                                           for x, y, zz in batch[mine]])
                    outs = self._forward(wins, afs, full)
                if exchanges:
                    outs = distributed.exchange_rows(outs, mine, len(batch))
                dump(outs, batch)
                if full and not average:
                    outs = tuple(_core_of(v, halo, core_n) for v in outs)
                if copy_kernels:
                    a, b = slab_before[ofs], slab_before[ofs + len(batch)]
                    if b > a:
                        r0 = int(np.argmax(in_slab[ofs:ofs + len(batch)]))
                        scatter_cores((bb_v, ca_v, aa_v),
                                      tuple(c[r0:r0 + b - a].contiguous() for c in outs),
                                      slab_starts[a:b], int(b - a), core_n)
                    continue
                for i, s in enumerate(batch):
                    paste(outs[0][i], outs[1][i], outs[2][i], s)
            if average:
                for s in empty_starts:
                    paste(z[0], z[1], z[2], s)
            if dump_dir is not None and writes and len(empty_starts):
                # identical (all-zero) inputs give identical outputs
                zb, zca, zaa = (v.cpu().numpy() for v in z)
                for s in empty_starts:
                    _dump_window(dump_dir, dump_reference, zb, zca, zaa, s, core_n, shape)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.timing["inference"] = inference.seconds
        self.timing["n_windows"] = int(len(starts))
        self.timing["n_forwards"] = self.n_forwards - forwards0

        with span("engine.reconstruction") as reconstruction:
            if average:
                safe = torch.clamp(cnt_v, min=1.0)
                bb_v, ca_v, aa_v = bb_v / safe, ca_v / safe, aa_v / safe[..., None]
                sl = tuple(slice(halo, halo + s) for s in shape)
            else:
                sl = tuple(slice(0, s) for s in shape)
            if self.shard_volumes:
                out = self._gather_slabs((bb_v, ca_v, aa_v), shape, x0, keep_on_device)
            else:
                aa_c = aa_v[sl]
                out = {
                    "backbone_probability": bb_v[sl],
                    "carbon_alpha_probability": ca_v[sl],
                    "amino_acid_probability": torch.movedim(aa_c, -1, 0),
                    "amino_acid_prediction": torch.argmax(aa_c, dim=-1),
                }
                if keep_on_device:
                    out = {k: v.contiguous() for k, v in out.items()}
                else:
                    with span("engine.d2h"):
                        out = dict(zip(out, _to_host(list(out.values()))))
        self.timing["reconstruction"] = reconstruction.seconds
        return out

    def _gather_slabs(self, slabs, shape, x0: int, keep_on_device: bool) -> Dict:
        """The sharded volumes' outputs: this rank's slab on the device, or
        the whole volumes in numpy, each rank's slab broadcast in turn and
        copied to the host."""
        mesh = self.mesh
        x_local = slabs[0].shape[0]
        if keep_on_device:
            rows = slice(0, max(0, min(x_local, shape[0] - x0)))
            bb, ca, aa = (v[rows, :shape[1], :shape[2]] for v in slabs)
            return {"backbone_probability": bb.contiguous(),
                    "carbon_alpha_probability": ca.contiguous(),
                    "amino_acid_probability": torch.movedim(aa, -1, 0).contiguous(),
                    "amino_acid_prediction": torch.argmax(aa, dim=-1),
                    "x_offset": x0}
        host = [np.empty((mesh.size * x_local,) + tuple(v.shape[1:]), np.float32)
                for v in slabs]
        with span("engine.d2h"):
            for r in range(mesh.size):
                bufs = list(slabs) if r == mesh.rank else [torch.empty_like(v) for v in slabs]
                if self._exchanges:
                    distributed.broadcast_(bufs, src=r)
                for h, b in zip(host, _to_host(bufs)):
                    h[r * x_local:(r + 1) * x_local] = b
        sl = tuple(slice(0, s) for s in shape)
        aa = np.moveaxis(host[2][sl], -1, 0)
        return {"backbone_probability": host[0][sl],
                "carbon_alpha_probability": host[1][sl],
                "amino_acid_probability": aa,
                "amino_acid_prediction": np.argmax(aa, axis=0)}
