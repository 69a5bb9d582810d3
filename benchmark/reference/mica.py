"""Plain f32 reference of the MICA network (jianlin-cheng/MICA,
``models/model.py`` class ``MICA``), its training loss, its augmentation
and dropout, and an Adam step.

Channels-first ``F.conv3d`` and ``F.linear`` on a state dict under the
original network's torch key names, everything in f32.  Callers hold
cuDNN's and cuBLAS's TF32 off (``exact_f32``).  ``q``, where given, rounds
every conv and dense operand (input and weight) before the product: the
lower-precision control.  Dropout and augmentation draw from generators
seeded as the trainer seeds its own, in the same order and shapes, so a
training step here sees the masks and crops the trainer's step saw.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Q = Optional[Callable[[torch.Tensor], torch.Tensor]]
N_UNITS = 12
BB_W = (0.03, 0.001, 0.3, 1.0)
CA_W = (0.01, 0.001, 0.1, 1.0)
AA_W = (0.001, 1.0, 1.8, 1.1, 1.1, 1.3, 1.0, 1.6, 1.1, 1.1, 0.9,
        1.7, 1.2, 1.2, 1.3, 1.1, 1.0, 1.1, 1.0, 2.2, 1.4)


def param_shapes(base: int) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of MICA at width ``base``, by torch key."""
    s: Dict[str, Tuple[int, ...]] = {}

    def conv(name, ci, co, k, groups=1):
        s[name + ".weight"] = (co, ci // groups, k, k, k)
        s[name + ".bias"] = (co,)

    def dense(name, ci, co):
        s[name + ".weight"] = (co, ci)
        s[name + ".bias"] = (co,)

    b = base
    for i, k in enumerate((3, 5, 7, 9)):
        conv(f"input_processing.exp_convs.{i}", 1, b // 2, k)
    conv("input_processing.exp_attention.1", 2 * b, b, 1)
    conv("input_processing.exp_attention.3", b, 2 * b, 1)
    conv("input_processing.exp_downsizing", 2 * b, b, 1)
    conv("input_processing.feat_conv", 24, b, 3)
    conv("input_processing.feat_gate.0", b, b // 4, 1)
    conv("input_processing.feat_gate.2", b // 4, 1, 1)
    conv("input_processing.fusion", 3 * b, b, 1)
    for i in range(3):
        c, p = b * 2 ** i, f"encoder.{i}"
        conv(f"{p}.dense_block.conv1.0", c, c // 2, 3)
        conv(f"{p}.dense_block.conv2.0", c + c // 2, c // 2, 3)
        conv(f"{p}.dense_block.conv3.0", 2 * c, c, 3)
        dense(f"{p}.dense_block.se.fc.0", c, c // 16)
        dense(f"{p}.dense_block.se.fc.3", c // 16, c)
        conv(f"{p}.dual_attn.local_attn.0", c, c, 3, groups=c)
        conv(f"{p}.dual_attn.global_attn.1", c, c // 4, 1)
        conv(f"{p}.dual_attn.global_attn.4", c // 4, c, 1)
        conv(f"{p}.dual_attn.fusion", 2 * c, c, 1)
        conv(f"{p}.transition.0", c, 2 * c, 3)
    s["fpn.weights"] = (3,)
    for i in range(3):
        conv(f"fpn.lateral.{i}", b * 2 ** (i + 1), b, 1)
    for i in range(3):
        conv(f"fpn.smooth.{i}.0", b, b, 3)
    for name, extra, n_cls in (("backbone_head", 0, 4), ("ca_head", 4, 4), ("aa_head", 8, 21)):
        conv(f"{name}.conv1", 3 * b + extra, 64, 3)
        conv(f"{name}.conv2", 64, 32, 3)
        conv(f"{name}.calibration.1", 32, 8, 1)
        conv(f"{name}.calibration.4", 8, 32, 1)
        conv(f"{name}.final", 32, n_cls, 1)
    return s


@contextlib.contextmanager
def exact_f32():
    """cuDNN convs and cuBLAS matmuls in full f32 for the duration."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class _RoundTrip(torch.autograd.Function):
    """x rounded to float8 e4m3 under a per-tensor scale (amax to 448),
    back in f32; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _RoundTrip.apply(x)


class Masks:
    """The dropout masks of one unit: drawn in the unit's order from a
    generator on ``device`` seeded with the unit's seed, at the whole
    batch's channels-last shapes, then cut to ``rows``."""

    def __init__(self, seed: int, rows: slice, total: int, device):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.rows, self.total, self.device = rows, total, device

    def _keep(self, shape, rate):
        u = torch.rand((self.total,) + tuple(shape), generator=self.gen, device=self.device)
        return u[self.rows] >= rate

    def channels(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """x (n, C, ...): whole channels of a sample."""
        if rate == 0.0:
            return x
        keep = self._keep((1, 1, 1, x.shape[1]), rate)          # (n, 1, 1, 1, C)
        keep = keep.permute(0, 4, 1, 2, 3).reshape((x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2))
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))

    def elements(self, y: torch.Tensor, rate: float) -> torch.Tensor:
        """y (n, C)."""
        if rate == 0.0:
            return y
        return torch.where(self._keep(y.shape[1:], rate), y / (1.0 - rate),
                           torch.zeros((), device=y.device))


def _conv(x, sd, name, q: Q, groups=1, weight=None, bias=None):
    w = sd[name + ".weight"] if weight is None else weight
    b = sd[name + ".bias"] if bias is None else bias
    if q is not None:
        x, w = q(x), q(w)
    return F.conv3d(x, w, b, padding=w.shape[-1] // 2, groups=groups)


def _dense(y, sd, name, q: Q):
    w = sd[name + ".weight"]
    if q is not None:
        y, w = q(y), q(w)
    return F.linear(y, w, sd[name + ".bias"])


def _in(x, eps=1e-5):
    mean = x.mean(dim=(2, 3, 4), keepdim=True)
    var = x.var(dim=(2, 3, 4), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def _gap(x):
    return x.mean(dim=(2, 3, 4), keepdim=True)


def _cir(x, sd, name, q):
    return torch.relu(_in(_conv(x, sd, name, q)))


def forward(sd, exp, af=None, *, q: Q = None, rate: float = 0.0,
            masks: Optional[Sequence[Optional[Masks]]] = None,
            out_slice: Optional[slice] = None):
    """(exp (n, 1, D, H, W), af (n, 24, D, H, W) or None) -> the backbone,
    CA and amino-acid logits (n, 4 / 4 / 21, D, H, W), the last cropped to
    ``out_slice``.  ``masks``: one ``Masks`` a unit (the stem, the RDB,
    DualAttention and transition of each stage, the FPN, the heads), with
    ``rate`` the dropout rate (heads twice it, transitions and FPN half)."""
    m = list(masks) if masks is not None else [None] * N_UNITS
    p = "input_processing."
    if m[0] is not None:
        exp = m[0].channels(exp, rate)
    x_exp = torch.cat([_conv(exp, sd, f"{p}exp_convs.{i}", q) for i in range(4)], 1)
    a = torch.relu(_conv(_gap(x_exp), sd, p + "exp_attention.1", q))
    a = torch.sigmoid(_conv(a, sd, p + "exp_attention.3", q))
    x_enh = x_exp * a
    x = _conv(x_enh, sd, p + "exp_downsizing", q)
    if af is not None:
        af_zero = af.abs().sum(dim=(1, 2, 3, 4)) < 1e-6
        if m[0] is not None:
            af = m[0].channels(af, rate)
        feat = _conv(af, sd, p + "feat_conv", q)
        g = torch.relu(_conv(feat, sd, p + "feat_gate.0", q))
        g = torch.sigmoid(_conv(g, sd, p + "feat_gate.2", q))
        fused = _conv(torch.cat([x_enh, feat * g], 1), sd, p + "fusion", q)
        x = torch.where(af_zero.reshape(-1, 1, 1, 1, 1), x, fused)

    feats = []
    for i in range(3):
        e = f"encoder.{i}."
        d = m[1 + 3 * i]

        def drop(h):
            return h if d is None else d.channels(h, rate)

        x1 = drop(_cir(x, sd, e + "dense_block.conv1.0", q))
        x2 = drop(_cir(torch.cat([x, x1], 1), sd, e + "dense_block.conv2.0", q))
        x3 = drop(_cir(torch.cat([x, x1, x2], 1), sd, e + "dense_block.conv3.0", q))
        y = torch.relu(_dense(_gap(x3).flatten(1), sd, e + "dense_block.se.fc.0", q))
        if d is not None:
            y = d.elements(y, rate)
        y = torch.sigmoid(_dense(y, sd, e + "dense_block.se.fc.3", q))
        x = x3 * y[:, :, None, None, None]

        d = m[2 + 3 * i]
        c = x.shape[1]
        local = torch.relu(_in(_conv(x, sd, e + "dual_attn.local_attn.0", q, groups=c)))
        g = torch.relu(_conv(_gap(x), sd, e + "dual_attn.global_attn.1", q))
        if d is not None:
            local = d.channels(local, rate)
            g = d.channels(g, rate)
        g = torch.sigmoid(_conv(g, sd, e + "dual_attn.global_attn.4", q))
        x = _conv(torch.cat([local, g * x], 1), sd, e + "dual_attn.fusion", q)

        x = _cir(x, sd, e + "transition.0", q)
        if m[3 + 3 * i] is not None:
            x = m[3 + 3 * i].channels(x, rate * 0.5)
        feats.append(x)

    w = torch.softmax(sd["fpn.weights"], 0)
    fpn = []
    for i, f in enumerate(feats):
        y = _conv(f, sd, f"fpn.lateral.{i}", q)
        y = _conv(y, sd, f"fpn.smooth.{i}.0", q, weight=sd[f"fpn.smooth.{i}.0.weight"] * w[i],
                  bias=sd[f"fpn.smooth.{i}.0.bias"] * w[i])
        fpn.append(y if m[10] is None else m[10].channels(y, rate * 0.5))
    f = torch.cat(fpn, 1)
    nf = f.shape[1]
    d, hr = m[11], 2 * rate

    def rest(name, h1, crop=None):
        x = torch.relu(_in(h1))
        x = torch.relu(_in(_conv(x, sd, name + ".conv2", q)))
        if d is not None:
            x = d.channels(x, hr)
        cal = torch.relu(_conv(_gap(x), sd, name + ".calibration.1", q))
        if d is not None:
            cal = d.channels(cal, hr)
        x = x * torch.sigmoid(_conv(cal, sd, name + ".calibration.4", q))
        if crop is not None:
            x = x[:, :, crop, crop, crop]
        return _conv(x, sd, name + ".final", q)

    def head_conv1(name, extra):
        wt = sd[name + ".conv1.weight"]
        h = _conv(f, sd, name + ".conv1", q, weight=wt[:, :nf], bias=sd[name + ".conv1.bias"])
        if extra is not None:
            h = h + _conv(extra, sd, name + ".conv1", q, weight=wt[:, nf:],
                          bias=torch.zeros_like(sd[name + ".conv1.bias"]))
        return h

    bb = rest("backbone_head", head_conv1("backbone_head", None))
    ca = rest("ca_head", head_conv1("ca_head", bb))
    aa = rest("aa_head", head_conv1("aa_head", torch.cat([bb, ca], 1)), out_slice)
    return bb, ca, aa


def probabilities(bb, ca, aa):
    """bb, ca: P(class 3) of the softmax over classes 0, 2, 3; aa: softmax
    over classes 1..20.  Channels-first in, (n, ...) and (n, 20, ...) out."""
    def p3(x):
        return torch.softmax(x[:, [0, 2, 3]], 1)[:, 2]

    return p3(bb), p3(ca), torch.softmax(aa[:, 1:], 1)


def unit_masks(seeds: Sequence[int], rows: slice, total: int, device) -> List[Masks]:
    return [Masks(s, rows, total, device) for s in seeds]


# ---- loss ------------------------------------------------------------------

def loss_parts(logits, targets, denominators):
    """Per-task class-weighted cross-entropies sum_i w[y_i] nll_i / denominator;
    logits channels-first, targets (n, D, H, W) int64."""
    out = []
    for x, y, w, den in zip(logits, targets, (BB_W, CA_W, AA_W), denominators):
        wt = torch.tensor(w, dtype=torch.float32, device=x.device)
        nll = -torch.log_softmax(x, 1).gather(1, y[:, None])[:, 0]
        out.append((wt[y] * nll).sum() / den)
    return out


def denominators(targets):
    return [torch.tensor(w, dtype=torch.float32, device=y.device)[y].sum()
            for y, w in zip(targets, (BB_W, CA_W, AA_W))]


def task_weights(epoch: float = 0.0):
    """The cosine ramp of the task weights from (0.6, 0.25, 0.15) to (0.25,
    0.4, 0.35) over 25 epochs, summing to 1."""
    p = 0.0 if epoch <= 0 else 1.0 if epoch >= 25 else 0.5 * (1 - math.cos(math.pi * epoch / 25))
    lam = [s + (t - s) * p for s, t in zip((0.6, 0.25, 0.15), (0.25, 0.4, 0.35))]
    return [v / sum(lam) for v in lam]


# ---- augmentation (the reference's recipe, the trainer's draws) -----------

_ROT_AXES = ((1, 2), (1, 3), (2, 3))


def _blur3(x, sigma):
    w = torch.exp(-0.5 * (torch.tensor([-1.0, 0.0, 1.0]) / sigma) ** 2)
    w = (w / w.sum()).tolist()
    for dim in (1, 2, 3):
        pad = [0, 0] * (x.dim() - dim - 1) + [1, 1]
        xp = F.pad(x, pad)
        n = x.shape[dim]
        x = w[0] * xp.narrow(dim, 0, n) + w[1] * xp.narrow(dim, 1, n) + w[2] * xp.narrow(dim, 2, n)
    return x


def augment(gen: torch.Generator, density, af3, targets):
    """Per sample of density (n, 1, D, H, W), af3 (n, 24, ...), targets
    (n, 3, ...): with p 0.4, noise sigma 0.03 (p 0.7), brightness +-0.05
    (p 0.5), contrast 0.9-1.1 (p 0.5), then with p 0.6 a rot90 (p 0.5, one
    of 9), a flip (p 0.3) and a +-2 voxel roll (p 0.4) of inputs and targets
    together, then a 3-tap blur of sigma 0.5-1 (p 0.2) of the density.
    The choices are one (n, 17) uniform draw, then each noise draw."""
    n = density.shape[0]
    draws = torch.rand((n, 17), generator=gen, device=density.device).tolist()
    outs = []
    for i in range(n):
        u, d, a, t = draws[i], density[i], af3[i], targets[i]
        if u[0] < 0.4:
            if u[1] < 0.7:
                d = d + 0.03 * torch.randn(d.shape, generator=gen, device=d.device)
            if u[2] < 0.5:
                d = d + (-0.05 + 0.1 * u[3])
            if u[4] < 0.5:
                mean = d.mean()
                d = (d - mean) * (0.9 + 0.2 * u[5]) + mean
            if u[14] < 0.6:
                x = torch.cat([d, a], 0)
                if u[6] < 0.5:
                    v = min(int(u[7] * 9), 8)
                    x = torch.rot90(x, v % 3 + 1, _ROT_AXES[v // 3])
                    t = torch.rot90(t, v % 3 + 1, _ROT_AXES[v // 3])
                if u[8] < 0.3:
                    ax = min(int(u[9] * 3), 2) + 1
                    x, t = torch.flip(x, (ax,)), torch.flip(t, (ax,))
                if u[10] < 0.4:
                    sh = [min(int(u[c] * 5), 4) - 2 for c in (11, 12, 13)]
                    x = torch.roll(x, sh, dims=(1, 2, 3))
                    t = torch.roll(t, sh, dims=(1, 2, 3))
                d, a = x[:1], x[1:]
            if u[15] < 0.2:
                d = _blur3(d, 0.5 + 0.5 * u[16])
        outs.append((d, a, t))
    return tuple(torch.stack([o[k] for o in outs]) for k in range(3))


# ---- Adam -------------------------------------------------------------------

class Adam:
    """Adam (lr, betas 0.9 / 0.999, eps 1e-8), bias-corrected."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params, grads):
        self.t += 1
        b1, b2 = 0.9, 0.999
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mh = self.m[k] / (1 - b1 ** self.t)
            vh = self.v[k] / (1 - b2 ** self.t)
            params[k] -= self.lr * mh / (vh.sqrt() + 1e-8)
