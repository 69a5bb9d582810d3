"""Sliding-window inference engine on one card.

Port of ``mica_tpu/infer/engine.py`` without the mesh, sharding and
chunked dispatch.  The padded map stays on the device; each batch

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
"""

from __future__ import annotations

import time
from collections.abc import Mapping
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.convert import state_dict_from_jax_params
from ..models.mica import MICA
from ..ops.window import CORE, HALO, window_counts, window_starts
from ..ops.window_copy import gather_windows, scatter_cores, starts_tensor

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
                 device=None):
        """``params_or_state_dict``: a ``MICA`` module, a torch state dict
        or a JAX parameter tree.  ``blend``: 'core' pastes each window's
        core; 'average' accumulates full windows and divides by the count.
        ``device`` None means the card, and raises where there is none."""
        if blend not in ("core", "average"):
            raise ValueError(f"unknown blend mode {blend!r}")
        self.device = resolve_device(device)
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
        self.timing: Dict[str, float] = {}
        self.n_forwards = 0
        self._zero_cores: Dict = {}

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
        key = (with_af, af_float, full)
        if key not in self._zero_cores:
            w = self.window
            wins = torch.zeros((1, w, w, w), dtype=torch.float32, device=self.device)
            af = None
            if with_af:
                af = (torch.zeros((1, w, w, w, NUM_AF_CHANNELS), device=self.device)
                      if af_float else torch.zeros((1, w, w, w), dtype=torch.int32,
                                                   device=self.device))
            self._zero_cores[key] = tuple(t[0] for t in self._forward(wins, af, full))
        return self._zero_cores[key]

    def predict_volume(self, volume: np.ndarray,
                       af_encoding: Optional[np.ndarray] = None,
                       keep_on_device: bool = False) -> Dict:
        """Predict BB/CA/AA volumes for a normalized ``volume[x, y, z]``;
        ``af_encoding`` is (24, X, Y, Z) or None.  Returns
        ``backbone_probability``, ``carbon_alpha_probability`` (X,Y,Z),
        ``amino_acid_probability`` (20,X,Y,Z) and ``amino_acid_prediction``
        (X,Y,Z; argmax 0..19) as numpy arrays, or with ``keep_on_device``
        as tensors on the predictor's device (nothing is copied to the
        host; candidate extraction reads them there)."""
        t0 = time.time()
        dev = self.device
        core_n, halo, win = self.core, self.halo, self.window
        shape = tuple(volume.shape)
        counts = window_counts(shape, core_n)
        padded_shape = tuple(n * core_n for n in counts)
        pads = [(halo, (padded_shape[a] - core_n) + win - halo - shape[a]) for a in range(3)]
        np_padded = np.pad(np.asarray(volume, np.float32), pads)
        padded_map = torch.from_numpy(np_padded).to(dev)

        np_af, padded_af, af_float = None, None, False
        if af_encoding is not None:
            if af_encoding.ndim == 3 and af_encoding.dtype == np.uint32:
                np_af = np.pad(af_encoding, pads)
            else:
                af_arr = np.asarray(af_encoding)
                if af_arr.dtype.kind in "iub":
                    binary = af_arr.min() >= 0 and af_arr.max() <= 1
                else:
                    binary = bool(((af_arr == 0) | (af_arr == 1)).all())
                if binary:
                    np_af = np.pad(pack_af_encoding(af_arr), pads)
                else:
                    # fractional encodings cannot be bit-packed
                    np_af = np.pad(np.moveaxis(af_arr.astype(np.float32), 0, -1),
                                   pads + [(0, 0)])
                    af_float = True
            if not af_float:
                # 24 bits used: the int32 view of the bitfield is exact
                np_af = np_af.view(np.int32)
            padded_af = torch.from_numpy(np_af).to(dev)
        with_af = np_af is not None

        starts = window_starts(shape, core_n)
        nonempty = _window_nonempty(np_padded, counts, core_n, halo)
        if with_af:
            nonempty |= _window_nonempty(np_af, counts, core_n, halo)
        compute_starts = starts[nonempty]
        empty_starts = starts[~nonempty]
        self.timing["n_empty"] = int(len(empty_starts))

        average = self.blend == "average"
        forwards0 = self.n_forwards
        need_zero = not average or len(empty_starts)
        z = self._zero_core(with_af, af_float, average) if need_zero else None
        if average:
            acc_shape = tuple(np_padded.shape)
            bb_v = torch.zeros(acc_shape, device=dev)
            ca_v = torch.zeros(acc_shape, device=dev)
            aa_v = torch.zeros(acc_shape + (NUM_AA,), device=dev)
            cnt_v = torch.zeros(acc_shape, device=dev)
        else:
            reps = counts
            bb_v = z[0].repeat(reps)
            ca_v = z[1].repeat(reps)
            aa_v = z[2].repeat(reps + (1,))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.timing["setup"] = time.time() - t0

        def paste(bb_c, ca_c, aa_c, s):
            x, y, zz = (int(v) for v in s)
            if average:
                w = bb_c.shape[0]
                bb_v[x:x + w, y:y + w, zz:zz + w] += bb_c
                ca_v[x:x + w, y:y + w, zz:zz + w] += ca_c
                aa_v[x:x + w, y:y + w, zz:zz + w] += aa_c
                cnt_v[x:x + w, y:y + w, zz:zz + w] += 1.0
            else:
                c = core_n
                bb_v[x:x + c, y:y + c, zz:zz + c] = bb_c
                ca_v[x:x + c, y:y + c, zz:zz + c] = ca_c
                aa_v[x:x + c, y:y + c, zz:zz + c] = aa_c

        t1 = time.time()
        bsz = self.batch_size
        copy_kernels = not average and not af_float
        if copy_kernels and len(compute_starts):
            # a window's origin in the padded frame is its core's start
            dev_starts = starts_tensor(compute_starts, padded_map.shape, win, dev)
        for ofs in range(0, len(compute_starts), bsz):
            batch = compute_starts[ofs:ofs + bsz]
            if copy_kernels:
                st = dev_starts[ofs:ofs + bsz]
                got = gather_windows(padded_map, padded_af, st, win)
                wins, afs = got if with_af else (got, None)
                cores = self._forward(wins, afs, False)
                scatter_cores((bb_v, ca_v, aa_v), tuple(c.contiguous() for c in cores),
                              st, len(batch), core_n)
                continue
            wins = torch.stack([padded_map[x:x + win, y:y + win, zz:zz + win]
                                for x, y, zz in batch])
            afs = None
            if with_af:
                afs = torch.stack([padded_af[x:x + win, y:y + win, zz:zz + win]
                                   for x, y, zz in batch])
            bb_c, ca_c, aa_c = self._forward(wins, afs, average)
            for i, s in enumerate(batch):
                paste(bb_c[i], ca_c[i], aa_c[i], s)
        if average:
            for s in empty_starts:
                paste(z[0], z[1], z[2], s)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.timing["inference"] = time.time() - t1
        self.timing["n_windows"] = int(len(starts))
        self.timing["n_forwards"] = self.n_forwards - forwards0

        t2 = time.time()
        if average:
            safe = torch.clamp(cnt_v, min=1.0)
            bb_v, ca_v, aa_v = bb_v / safe, ca_v / safe, aa_v / safe[..., None]
            sl = tuple(slice(halo, halo + s) for s in shape)
        else:
            sl = tuple(slice(0, s) for s in shape)
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
            out = {k: v.cpu().numpy() for k, v in out.items()}
        self.timing["reconstruction"] = time.time() - t2
        return out
