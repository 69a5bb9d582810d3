"""The MICA multi-task 3-D network as a PyTorch module (channels-last).

Port of ``mica_tpu/models/mica.py``, inference and training.  Activations stay
(B, D, H, W, C) at every public boundary; a library conv takes
``x.permute(0, 4, 1, 2, 3)``, an NCDHW view with channels-last strides.
Parameters are f32 and named after the original network's torch keys
(``models/convert.py``), so ``load_state_dict(strict=True)`` takes a JAX
parameter tree's conversion or an original checkpoint.  Compute runs in
``dtype`` (bf16 by default) with f32 InstanceNorm statistics.

Kernel routing, in bf16 compute (``kernel_route``):

  * every RDB conv1/2/3 and every transition: ``conv3d_in_relu`` (K1 + K2);
  * the heads' fused conv1 over the three FPN parts: K1, bias and
    statistics off;
  * ``DualAttention``'s local conv: K3;
  * the stem's four Cin=1 convs at inference: K8;
  * the rest (``feat_conv``, FPN laterals and smooths, head conv2,
    the cascade corrections, the 1x1s) are library convs and matmuls, as
    they were XLA ops outside any Pallas kernel in the JAX package.

In f32 compute every one of those sites takes the library formulation
the JAX package's f32 takes (``F.conv3d``, grouped for the depthwise,
then ``instance_norm`` and ReLU), with TF32 off (``exact_f32``): the JAX
package runs f32 at ``precision="highest"`` and never reaches a Pallas
kernel in it.  This is a choice by dtype made once a forward, before any
launch; the kernel wrappers still refuse f32 tensors on the card.

Training (``train=True``) keeps that routing through autograd functions
with hand-written backward kernels: ``conv3d_in_relu_ad`` (K1 + K4
forward; K5, K6, K1 for dx and a library weight-grad conv backward) and
``depthwise_conv3_ad`` (K3 forward; K3 and K7 backward).  As in the JAX
package under training, the stem emits the compute dtype and the heads'
fused conv1 is a library conv.  ``dropout_rate`` drives channel dropout
(Dropout3d) at the reference's sites and the SE block's elementwise
dropout; the heads use twice the rate, the transitions and FPN smooths
half.  ``MICA(remat=True)`` recomputes each RDB, each DualAttention and
the heads in the backward (``torch.utils.checkpoint``), the JAX
package's ``remat_scope="blocks"``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import stem as stem_ops
from ..ops.conv3d_in import conv3d, conv3d_in_relu, conv3d_in_relu_ad
from ..ops.depthwise import depthwise_conv3_ad

# dropout units of one forward: the stem, (RDB, DualAttention, transition)
# of each stage, the FPN and the heads
_N_UNITS = 12


def kernel_route(dtype: torch.dtype) -> bool:
    """The routing rule: the hand-written kernels (K1/K2, K3, K8 and the
    training passes behind them) serve bf16 compute; any other dtype takes
    the library formulations, on every device.  It mirrors the JAX
    package's gates: ``self.dtype == jnp.bfloat16`` before its depthwise
    kernel (``mica_tpu/models/mica.py:347-352``) and the bf16-only fused
    conv kernel (``mica_tpu/ops/wino_pallas.py:859-860``); its f32 convs
    are XLA's at ``precision="highest"``."""
    return dtype == torch.bfloat16


@contextlib.contextmanager
def exact_f32(dtype: torch.dtype):
    """In f32, cuDNN's convs and cuBLAS's matmuls run in full f32 (TF32
    off) for the duration and the flags are restored after, as the JAX
    package's f32 runs at ``precision="highest"``.  A training step holds
    it over its backward too.  Other dtypes leave the flags alone: the bf16
    training stem's TF32 conv takes bf16-rounded inputs, which TF32
    multiplies exactly."""
    if dtype != torch.float32:
        yield
        return
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over (D, H, W), no affine: f32 E[x^2] - E[x]^2 clamped
    at 0; in low precision the mean and scale are cast to the compute dtype
    before the apply."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=(1, 2, 3), keepdim=True)
    sq_mean = (xf * xf).mean(dim=(1, 2, 3), keepdim=True)
    var = torch.clamp(sq_mean - mean * mean, min=0.0)
    scale = torch.rsqrt(var + eps)
    if dt == torch.float32:
        return (x - mean) * scale
    return (x - mean.to(dt)) * scale.to(dt)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over (D, H, W) in f32, keepdims, cast back."""
    return x.float().mean(dim=(1, 2, 3), keepdim=True).to(x.dtype)


class Dropout:
    """The dropout masks of one unit of the network (the stem, a block, the
    FPN, the heads), drawn at first use from a generator seeded with
    ``seed`` on the activations' device.  ``torch.utils.checkpoint``
    restores the default generators for a recomputation, never an explicit
    one, so a checkpointed unit builds a new ``Dropout`` from the same seed
    and draws the same masks again.  Kept values are x / (1 - rate) with
    1 - rate rounded to x's dtype first, as flax's ``x / keep_prob`` takes
    its Python scalar; only the quotient is rounded after that."""

    def __init__(self, seed: int):
        self.seed = seed
        self._gen: Optional[torch.Generator] = None

    def _drop(self, x: torch.Tensor, shape, rate: float) -> torch.Tensor:
        if rate == 0.0:
            return x
        if self._gen is None:
            self._gen = torch.Generator(device=x.device).manual_seed(self.seed)
        keep = torch.rand(shape, generator=self._gen, device=x.device) >= rate
        keep_prob = torch.tensor(1.0 - rate, dtype=x.dtype).item()
        return torch.where(keep, x / keep_prob, 0)

    def channels(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """Dropout3d: whole channels of a sample, one (B, 1, 1, 1, C) mask."""
        return self._drop(x, (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],), rate)

    def elements(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        return self._drop(x, x.shape, rate)


def _unit(module: nn.Module, x: torch.Tensor, rate: float, seed: Optional[int],
          train: bool, remat: bool, kernels: bool) -> torch.Tensor:
    """``module(x, rate, drop, train, kernels)`` with its own ``Dropout``,
    under ``torch.utils.checkpoint`` when ``remat``."""
    def run(x):
        return module(x, rate, None if seed is None else Dropout(seed), train, kernels)

    if remat:
        return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
    return run(x)


class Conv(nn.Module):
    """Parameter holder of a Conv3d: weight (Co, Ci/groups, k, k, k), bias."""

    def __init__(self, ci: int, co: int, k: int, groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(co, ci // groups, k, k, k))
        self.bias = nn.Parameter(torch.zeros(co))

    def forward(self, x: torch.Tensor, weight=None, bias=None) -> torch.Tensor:
        """SAME conv in x's dtype, then bias in that dtype (flax's order)."""
        return conv_same(x, self.weight if weight is None else weight,
                         self.bias if bias is None else bias)


class Dense(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(co, ci))
        self.bias = nn.Parameter(torch.zeros(co))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


def conv_same(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None, groups: int = 1) -> torch.Tensor:
    """Stride-1 SAME conv of channels-last ``x`` with an OIDHW weight cast
    to x's dtype; a 1x1 is a matmul over channels."""
    dt = x.dtype
    w = weight.to(dt)
    if w.shape[2:] == (1, 1, 1) and groups == 1:
        y = F.linear(x, w.reshape(w.shape[0], w.shape[1]))
    else:
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=w.shape[-1] // 2, groups=groups)
        # channels-last in, channels-last out: a no-op copy that guarantees
        # the contiguous (B, D, H, W, C) the kernels take
        y = y.permute(0, 2, 3, 4, 1).contiguous()
    if bias is not None:
        y = y + bias.to(dt)
    return y


def conv_in_relu_library(parts, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """relu(instance_norm(conv3x3(concat(parts)) + bias)) from library
    ops: the f32 route of the RDB and transition convs, as the JAX
    package's f32 computes them."""
    x = parts[0] if len(parts) == 1 else torch.cat(list(parts), dim=-1)
    return torch.relu(instance_norm(conv_same(x, weight, bias)))


def _conv_in_relu(train: bool, kernels: bool):
    """The conv + IN + ReLU of an RDB or transition site on this route."""
    if not kernels:
        return conv_in_relu_library
    return conv3d_in_relu_ad if train else conv3d_in_relu


def depthwise_library(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The DualAttention local conv as a grouped library conv (f32 route)."""
    return conv_same(x, weight, bias, groups=x.shape[-1])


def _slots(**mods) -> nn.ModuleDict:
    """Numbered children, so state-dict keys read ``<name>.<index>.weight``."""
    return nn.ModuleDict({k.lstrip("_"): v for k, v in mods.items()})


def _fold_s2d(x: torch.Tensor, s: int = 2) -> torch.Tensor:
    """(B, 1, D, H, W) -> (B, s^3, D/s, H/s, W/s); channel qz*s^2+qy*s+qx."""
    b, _, d, h, w = x.shape
    x = x.reshape(b, d // s, s, h // s, s, w // s, s).permute(0, 2, 4, 6, 1, 3, 5)
    return x.reshape(b, s ** 3, d // s, h // s, w // s)


def _unfold_s2d(y: torch.Tensor, s: int = 2) -> torch.Tensor:
    """(B, s^3*C, D/s, H/s, W/s), channels (pz, py, px, c) -> (B, C, D, H, W)."""
    b, sc, dz, hy, wx = y.shape
    c = sc // s ** 3
    y = y.reshape(b, s, s, s, c, dz, hy, wx).permute(0, 4, 5, 1, 6, 2, 7, 3)
    return y.reshape(b, c, dz * s, hy * s, wx * s)


def _fold_kernel_s2d(w: torch.Tensor, s: int = 2) -> torch.Tensor:
    """Polyphase fold of a (C, 1, k, k, k) kernel: (s^3*C, s^3, T, T, T) with
    W'[(p, c), q, u] = w[c, s*u + q - p + k//2] (0 out of range), so a SAME
    conv of the folded input equals the SAME conv of the input."""
    c, _, k = w.shape[0], w.shape[1], w.shape[-1]
    half = k // 2
    u_max = max(-(-half // s), (s - 1 + half) // s)
    u = torch.arange(-u_max, u_max + 1, device=w.device)
    t = len(u)
    q = torch.arange(s, device=w.device)
    idx = s * u[:, None, None] + q[None, :, None] - q[None, None, :] + half  # (T, q, p)
    valid = ((idx >= 0) & (idx < k)).to(w.dtype)
    idx = idx.clamp(0, k - 1).reshape(-1)
    wk = w[:, 0]                                                     # (C, k, k, k)
    wk = wk[:, idx].reshape(c, t, s, s, k, k) * valid.reshape(1, t, s, s, 1, 1)
    wk = wk[:, :, :, :, idx].reshape(c, t, s, s, t, s, s, k)
    wk = wk * valid.reshape(1, 1, 1, 1, t, s, s, 1)
    wk = wk[..., idx].reshape(c, t, s, s, t, s, s, t, s, s)
    wk = wk * valid.reshape(1, 1, 1, 1, 1, 1, 1, t, s, s)
    # (c, uz, qz, pz, uy, qy, py, ux, qx, px) -> (pz, py, px, c, qz, qy, qx, uz, uy, ux)
    wk = wk.permute(3, 6, 9, 0, 2, 5, 8, 1, 4, 7)
    return wk.reshape(s ** 3 * c, s ** 3, t, t, t)


class MultiScaleInput(nn.Module):
    """Stem: k=3/5/7/9 Cin=1 convs + SE attention + the AF3 gate, selected
    per sample on the "AF3 all zero" predicate."""

    def __init__(self, base: int):
        super().__init__()
        self.exp_convs = nn.ModuleList([Conv(1, base // 2, k) for k in (3, 5, 7, 9)])
        self.exp_attention = _slots(_1=Conv(2 * base, base, 1), _3=Conv(base, 2 * base, 1))
        self.exp_downsizing = Conv(2 * base, base, 1)
        self.feat_conv = Conv(24, base, 3)
        self.feat_gate = _slots(_0=Conv(base, base // 4, 1), _2=Conv(base // 4, 1, 1))
        self.fusion = Conv(3 * base, base, 1)
        self._stem_cache = None

    def _packed_stem_weight(self, dt: torch.dtype) -> torch.Tensor:
        """The four kernels as K8's packed weight in ``dt``, derived
        again only when a kernel was written to, replaced or moved (its
        version counter, storage or device changed).  Where autograd records
        the kernels it is derived anew, attached to them, and not kept."""
        ws = [conv.weight for conv in self.exp_convs]
        if torch.is_grad_enabled() and any(w.requires_grad for w in ws):
            return stem_ops.pack_weight(ws, dt)
        key = (dt,) + tuple((w._version, w.data_ptr(), w.device) for w in ws)
        if self._stem_cache is None or self._stem_cache[0] != key:
            with torch.no_grad():
                self._stem_cache = (key, stem_ops.pack_weight(ws, dt))
        return self._stem_cache[1]

    def stem(self, x: torch.Tensor, train: bool = False, kernels: bool = True) -> torch.Tensor:
        """The four convs as one 9^3 conv (kernels zero-embedded, rounded
        to x's dtype as the JAX stem does), f32 accumulation and bias, cast
        to x's dtype: K8 when not training and ``kernels``.  K8, like the
        kernel it replaces, has no backward (on the card its wrapper refuses
        tensors that autograd records), so training keeps a library conv: at
        even sizes the JAX package's space-to-depth form (fold 2 per axis:
        Cin 8, a 5^3 kernel), which a Cin=1 library conv runs far below its
        rate.  The f32 route (``kernels`` False) takes that library conv
        too, as the JAX package's f32 stem is XLA's.  Under training the
        conv's output is cast first and the bias added in x's dtype, as the
        JAX training path emits the compute dtype."""
        dt = x.dtype
        b = torch.cat([conv.bias for conv in self.exp_convs]).float()
        if not train and kernels:
            return stem_ops.stem_conv(x[..., 0], self._packed_stem_weight(dt), b)
        w = stem_ops.combine_weights([conv.weight.to(dt).float() for conv in self.exp_convs])
        xin = x.float().permute(0, 4, 1, 2, 3)        # (B, 1, D, H, W)
        if all(n % 2 == 0 for n in xin.shape[2:]):
            y = _unfold_s2d(F.conv3d(_fold_s2d(xin), _fold_kernel_s2d(w), padding=2))
        else:
            y = F.conv3d(xin, w, padding=4)
        return y.permute(0, 2, 3, 4, 1).to(dt) + b.to(dt)

    def forward(self, exp_map: torch.Tensor, af: Optional[torch.Tensor], rate: float = 0.0,
                drop: Optional[Dropout] = None, train: bool = False,
                kernels: bool = True) -> torch.Tensor:
        if drop is not None:
            exp_map = drop.channels(exp_map, rate)
        x_exp = self.stem(exp_map, train, kernels)
        a = torch.relu(self.exp_attention["1"](global_avg_pool(x_exp)))
        a = torch.sigmoid(self.exp_attention["3"](a))
        x_exp_enh = x_exp * a
        exp_only = self.exp_downsizing(x_exp_enh)
        if af is None:
            return exp_only
        af_zero = torch.sum(torch.abs(af.float()), dim=(1, 2, 3, 4)) < 1e-6
        if drop is not None:
            af = drop.channels(af, rate)
        x_feat = self.feat_conv(af)
        g = torch.relu(self.feat_gate["0"](x_feat))
        g = torch.sigmoid(self.feat_gate["2"](g))
        fused = self.fusion(torch.cat([x_exp_enh, x_feat * g], dim=-1))
        return torch.where(af_zero.reshape(-1, 1, 1, 1, 1), exp_only, fused)


class SEBlock(nn.Module):
    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.fc = _slots(_0=Dense(c, c // reduction), _3=Dense(c // reduction, c))

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                drop: Optional[Dropout] = None) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        y = global_avg_pool(x).reshape(b, c)
        y = torch.relu(self.fc["0"](y))
        if drop is not None:
            y = drop.elements(y, rate)
        y = torch.sigmoid(self.fc["3"](y))
        return x * y.reshape(b, 1, 1, 1, c)


class ResidualDenseBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = _slots(_0=Conv(c, c // 2, 3))
        self.conv2 = _slots(_0=Conv(c + c // 2, c // 2, 3))
        self.conv3 = _slots(_0=Conv(2 * c, c, 3))
        self.se = SEBlock(c)

    def forward(self, x: torch.Tensor, rate: float = 0.0, drop: Optional[Dropout] = None,
                train: bool = False, kernels: bool = True) -> torch.Tensor:
        fused = _conv_in_relu(train, kernels)

        def block(parts, slot):
            conv = slot["0"]
            h = fused(parts, conv.weight, conv.bias)
            return h if drop is None else drop.channels(h, rate)

        x1 = block([x], self.conv1)
        x2 = block([x, x1], self.conv2)
        x3 = block([x, x1, x2], self.conv3)
        return self.se(x3, rate, drop)


class DualAttention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.local_attn = _slots(_0=Conv(c, c, 3, groups=c))
        self.global_attn = _slots(_1=Conv(c, c // 4, 1), _4=Conv(c // 4, c, 1))
        self.fusion = Conv(2 * c, c, 1)

    def forward(self, x: torch.Tensor, rate: float = 0.0, drop: Optional[Dropout] = None,
                train: bool = False, kernels: bool = True) -> torch.Tensor:
        lc = self.local_attn["0"]
        conv = depthwise_conv3_ad if kernels else depthwise_library
        local = torch.relu(instance_norm(conv(x, lc.weight, lc.bias)))
        g = torch.relu(self.global_attn["1"](global_avg_pool(x)))
        if drop is not None:
            local = drop.channels(local, rate)
            g = drop.channels(g, rate)
        g = torch.sigmoid(self.global_attn["4"](g))
        return self.fusion(torch.cat([local, g * x], dim=-1))


class EncoderStage(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.dense_block = ResidualDenseBlock(ci)
        self.dual_attn = DualAttention(ci)
        self.transition = _slots(_0=Conv(ci, co, 3))

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                seeds: Sequence[Optional[int]] = (None, None, None), train: bool = False,
                remat: bool = False, kernels: bool = True) -> torch.Tensor:
        """``seeds``: the dropout seeds of the RDB, the DualAttention and
        the transition; ``remat`` checkpoints the RDB and the
        DualAttention."""
        x = _unit(self.dense_block, x, rate, seeds[0], train, remat, kernels)
        x = _unit(self.dual_attn, x, rate, seeds[1], train, remat, kernels)
        t = self.transition["0"]
        h = _conv_in_relu(train, kernels)([x], t.weight, t.bias)
        return h if seeds[2] is None else Dropout(seeds[2]).channels(h, rate * 0.5)


class FPN(nn.Module):
    """Softmax-weighted fusion of the three equal-size encoder outputs; the
    weights fold into the smooth convs' parameters.  Returns the three
    parts of the logical channel concat."""

    def __init__(self, base: int):
        super().__init__()
        self.weights = nn.Parameter(torch.full((3,), 1.0 / 3.0))
        self.lateral = nn.ModuleList([Conv(base * 2 ** (i + 1), base, 1) for i in range(3)])
        self.smooth = nn.ModuleList([_slots(_0=Conv(base, base, 3)) for _ in range(3)])

    def forward(self, feats, rate: float = 0.0, drop: Optional[Dropout] = None):
        w = torch.softmax(self.weights.float(), dim=0)
        out = []
        for i, c in enumerate(feats):
            s = self.smooth[i]["0"]
            y = s(self.lateral[i](c), s.weight * w[i], s.bias * w[i])
            out.append(y if drop is None else drop.channels(y, rate * 0.5))
        return tuple(out)


class TaskHead(nn.Module):
    """Parameters of one head; the forward is assembled in ``MICA.heads``."""

    def __init__(self, ci: int, n_cls: int):
        super().__init__()
        self.conv1 = Conv(ci, 64, 3)
        self.conv2 = Conv(64, 32, 3)
        self.calibration = _slots(_1=Conv(32, 8, 1), _4=Conv(8, 32, 1))
        self.final = Conv(32, n_cls, 1)

    def rest(self, h1: torch.Tensor, out_slice: Optional[slice] = None, rate: float = 0.0,
             drop: Optional[Dropout] = None) -> torch.Tensor:
        """IN -> relu -> conv2 -> IN -> relu -> dropout -> calibration ->
        final 1x1 in f32.  ``out_slice`` crops before the 1x1, which is
        exact."""
        x = torch.relu(instance_norm(h1))
        x = torch.relu(instance_norm(self.conv2(x)))
        if drop is not None:
            x = drop.channels(x, rate)
        cal = torch.relu(self.calibration["1"](global_avg_pool(x)))
        if drop is not None:
            cal = drop.channels(cal, rate)
        x = x * torch.sigmoid(self.calibration["4"](cal))
        if out_slice is not None:
            x = x[:, out_slice, out_slice, out_slice, :]
        return self.final(x.float())


class MICA(nn.Module):
    """``(exp_map, af) -> (backbone, ca, aa)`` logits in f32, each
    (B, D, H, W, n_cls) with n_cls 4/4/21; ``exp_map`` (B, D, H, W, 1),
    ``af`` (B, D, H, W, 24) or None."""

    def __init__(self, base: int = 64, dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False):
        super().__init__()
        self.base = base
        self.dtype = dtype
        self.remat = remat
        self.input_processing = MultiScaleInput(base)
        self.encoder = nn.ModuleList(
            [EncoderStage(base * 2 ** i, base * 2 ** (i + 1)) for i in range(3)])
        self.fpn = FPN(base)
        fpn_ch = 3 * base
        self.backbone_head = TaskHead(fpn_ch, 4)
        self.ca_head = TaskHead(fpn_ch + 4, 4)
        self.aa_head = TaskHead(fpn_ch + 8, 21)

    def init_weights(self, generator: torch.Generator) -> "MICA":
        """Xavier-normal conv and dense weights, zero biases, FPN weights
        1/3 (the JAX package's ``init_params_fast`` rule), drawn from
        ``generator`` on the parameters' device."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name == "fpn.weights":
                    p.fill_(1.0 / 3.0)
                elif name.endswith(".bias"):
                    p.zero_()
                else:
                    receptive = math.prod(p.shape[2:])
                    std = math.sqrt(2.0 / ((p.shape[0] + p.shape[1]) * receptive))
                    p.normal_(0.0, std, generator=generator)
        return self

    def heads(self, fpn, out_slice: Optional[slice], rate: float = 0.0,
              drop: Optional[Dropout] = None, train: bool = False, kernels: bool = True):
        """The three cascaded heads over one fused 192-out conv1 of the FPN
        parts (K1, no bias, no statistics; a library conv of their concat
        under training or on the f32 route, as in the JAX package); bb/ca
        logits (f32) are cast back to the compute dtype for the cascade
        corrections."""
        dt = fpn[0].dtype
        fpn_ch = sum(p.shape[-1] for p in fpn)
        bb_h, ca_h, aa_h = self.backbone_head, self.ca_head, self.aa_head
        k_big = torch.cat([bb_h.conv1.weight, ca_h.conv1.weight[:, :fpn_ch],
                           aa_h.conv1.weight[:, :fpn_ch]], dim=0)
        if train or not kernels:
            big = conv_same(torch.cat(list(fpn), dim=-1), k_big)
        else:
            big, _ = conv3d(list(fpn), k_big, None, with_stats=False)

        backbone = bb_h.rest(big[..., :64] + bb_h.conv1.bias.to(dt), None, rate, drop)
        bb_f = backbone.to(dt)
        h_ca = (big[..., 64:128] + conv_same(bb_f, ca_h.conv1.weight[:, fpn_ch:])
                + ca_h.conv1.bias.to(dt))
        ca = ca_h.rest(h_ca, None, rate, drop)
        h_aa = (big[..., 128:192]
                + conv_same(torch.cat([bb_f, ca.to(dt)], dim=-1),
                            aa_h.conv1.weight[:, fpn_ch:])
                + aa_h.conv1.bias.to(dt))
        aa = aa_h.rest(h_aa, out_slice, rate, drop)
        return backbone, ca, aa

    def forward(self, exp_map: torch.Tensor, af: Optional[torch.Tensor] = None,
                out_slice: Optional[slice] = None, *, dropout_rate: float = 0.0,
                train: bool = False, generator: Optional[torch.Generator] = None):
        """``train`` takes the differentiable kernels; with
        ``dropout_rate`` > 0 it also drops, drawing one seed per unit from
        ``generator`` (a CPU generator draws them without a device sync).
        The route (kernels in bf16, library ops otherwise) is decided here
        once, from ``self.dtype``."""
        dt = self.dtype
        seeds = [None] * _N_UNITS
        if train and dropout_rate > 0.0:
            if generator is None:
                raise ValueError("dropout needs a generator")
            seeds = torch.randint(0, 2 ** 62, (_N_UNITS,), generator=generator,
                                  device=generator.device).tolist()
        rate = dropout_rate if train else 0.0
        remat = self.remat and train
        kernels = kernel_route(dt)

        def drop(i):
            return None if seeds[i] is None else Dropout(seeds[i])

        def heads(*parts):
            return self.heads(parts, out_slice, 2 * rate, drop(11), train, kernels)

        with exact_f32(dt):
            x = self.input_processing(exp_map.to(dt), None if af is None else af.to(dt),
                                      rate, drop(0), train, kernels)
            feats = []
            for i, stage in enumerate(self.encoder):
                x = stage(x, rate, seeds[1 + 3 * i:4 + 3 * i], train, remat, kernels)
                feats.append(x)
            fpn = self.fpn(feats, rate, drop(10))
            if remat:
                return checkpoint(heads, *fpn, use_reentrant=False, preserve_rng_state=False)
            return heads(*fpn)


def dropout_rate_for_epoch(epoch: int, schedule=(0.01, 0.05, 0.1)) -> float:
    """The reference's epoch-gated dropout schedule."""
    if epoch < 35:
        return schedule[0]
    if epoch < 50:
        return schedule[1]
    return schedule[2]
