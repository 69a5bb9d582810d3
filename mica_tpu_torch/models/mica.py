"""The MICA multi-task 3-D network as a PyTorch module (channels-last).

Port of ``mica_tpu/models/mica.py`` for inference.  Activations stay
(B, D, H, W, C) at every public boundary; a library conv takes
``x.permute(0, 4, 1, 2, 3)``, an NCDHW view with channels-last strides.
Parameters are f32 and named after the original network's torch keys
(``models/convert.py``), so ``load_state_dict(strict=True)`` takes a JAX
parameter tree's conversion or an original checkpoint.  Compute runs in
``dtype`` (bf16 by default) with f32 InstanceNorm statistics.

Kernel routing:

  * every RDB conv1/2/3 and every transition: ``conv3d_in_relu`` (K1 + K2);
  * the heads' fused conv1 over the three FPN parts: K1, bias and
    statistics off;
  * ``DualAttention``'s local conv: K3;
  * the rest (stem, ``feat_conv``, FPN laterals and smooths, head conv2,
    the cascade corrections, the 1x1s) are library convs and matmuls, as
    they were XLA ops outside any Pallas kernel in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3d_in import conv3d, conv3d_in_relu
from ..ops.depthwise import depthwise_conv3


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
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1 SAME conv of channels-last ``x`` with an OIDHW weight cast
    to x's dtype; a 1x1 is a matmul over channels."""
    dt = x.dtype
    w = weight.to(dt)
    if w.shape[2:] == (1, 1, 1):
        y = F.linear(x, w.reshape(w.shape[0], w.shape[1]))
    else:
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=w.shape[-1] // 2)
        # channels-last in, channels-last out: a no-op copy that guarantees
        # the contiguous (B, D, H, W, C) the kernels take
        y = y.permute(0, 2, 3, 4, 1).contiguous()
    if bias is not None:
        y = y + bias.to(dt)
    return y


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

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """The four convs as one 9^3 conv (kernels zero-embedded, rounded
        to x's dtype as the JAX stem does), f32 accumulation and bias, cast
        to x's dtype.  At even sizes it runs as the JAX package's
        space-to-depth conv (fold 2 per axis: Cin 8, a 5^3 kernel), which
        a Cin=1 library conv runs far below its rate."""
        dt = x.dtype
        ws = []
        for conv in self.exp_convs:
            pad = (9 - conv.weight.shape[-1]) // 2
            ws.append(F.pad(conv.weight.to(dt).float(), (pad,) * 6))
        w = torch.cat(ws, dim=0)                      # (Ctot, 1, 9, 9, 9)
        b = torch.cat([conv.bias for conv in self.exp_convs]).float()
        xin = x.float().permute(0, 4, 1, 2, 3)        # (B, 1, D, H, W)
        if all(n % 2 == 0 for n in xin.shape[2:]):
            y = _unfold_s2d(F.conv3d(_fold_s2d(xin), _fold_kernel_s2d(w), padding=2))
        else:
            y = F.conv3d(xin, w, padding=4)
        return (y.permute(0, 2, 3, 4, 1) + b).to(dt)

    def forward(self, exp_map: torch.Tensor, af: Optional[torch.Tensor]) -> torch.Tensor:
        x_exp = self.stem(exp_map)
        a = torch.relu(self.exp_attention["1"](global_avg_pool(x_exp)))
        a = torch.sigmoid(self.exp_attention["3"](a))
        x_exp_enh = x_exp * a
        exp_only = self.exp_downsizing(x_exp_enh)
        if af is None:
            return exp_only
        af_zero = torch.sum(torch.abs(af.float()), dim=(1, 2, 3, 4)) < 1e-6
        x_feat = self.feat_conv(af)
        g = torch.relu(self.feat_gate["0"](x_feat))
        g = torch.sigmoid(self.feat_gate["2"](g))
        fused = self.fusion(torch.cat([x_exp_enh, x_feat * g], dim=-1))
        return torch.where(af_zero.reshape(-1, 1, 1, 1, 1), exp_only, fused)


class SEBlock(nn.Module):
    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.fc = _slots(_0=Dense(c, c // reduction), _3=Dense(c // reduction, c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        y = global_avg_pool(x).reshape(b, c)
        y = torch.sigmoid(self.fc["3"](torch.relu(self.fc["0"](y))))
        return x * y.reshape(b, 1, 1, 1, c)


class ResidualDenseBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = _slots(_0=Conv(c, c // 2, 3))
        self.conv2 = _slots(_0=Conv(c + c // 2, c // 2, 3))
        self.conv3 = _slots(_0=Conv(2 * c, c, 3))
        self.se = SEBlock(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def block(parts, slot):
            conv = slot["0"]
            return conv3d_in_relu(parts, conv.weight, conv.bias)

        x1 = block([x], self.conv1)
        x2 = block([x, x1], self.conv2)
        x3 = block([x, x1, x2], self.conv3)
        return self.se(x3)


class DualAttention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.local_attn = _slots(_0=Conv(c, c, 3, groups=c))
        self.global_attn = _slots(_1=Conv(c, c // 4, 1), _4=Conv(c // 4, c, 1))
        self.fusion = Conv(2 * c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lc = self.local_attn["0"]
        local = torch.relu(instance_norm(depthwise_conv3(x, lc.weight, lc.bias)))
        g = torch.relu(self.global_attn["1"](global_avg_pool(x)))
        g = torch.sigmoid(self.global_attn["4"](g))
        return self.fusion(torch.cat([local, g * x], dim=-1))


class EncoderStage(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.dense_block = ResidualDenseBlock(ci)
        self.dual_attn = DualAttention(ci)
        self.transition = _slots(_0=Conv(ci, co, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dual_attn(self.dense_block(x))
        t = self.transition["0"]
        return conv3d_in_relu([x], t.weight, t.bias)


class FPN(nn.Module):
    """Softmax-weighted fusion of the three equal-size encoder outputs; the
    weights fold into the smooth convs' parameters.  Returns the three
    parts of the logical channel concat."""

    def __init__(self, base: int):
        super().__init__()
        self.weights = nn.Parameter(torch.full((3,), 1.0 / 3.0))
        self.lateral = nn.ModuleList([Conv(base * 2 ** (i + 1), base, 1) for i in range(3)])
        self.smooth = nn.ModuleList([_slots(_0=Conv(base, base, 3)) for _ in range(3)])

    def forward(self, feats):
        w = torch.softmax(self.weights.float(), dim=0)
        out = []
        for i, c in enumerate(feats):
            s = self.smooth[i]["0"]
            out.append(s(self.lateral[i](c), s.weight * w[i], s.bias * w[i]))
        return tuple(out)


class TaskHead(nn.Module):
    """Parameters of one head; the forward is assembled in ``MICA.heads``."""

    def __init__(self, ci: int, n_cls: int):
        super().__init__()
        self.conv1 = Conv(ci, 64, 3)
        self.conv2 = Conv(64, 32, 3)
        self.calibration = _slots(_1=Conv(32, 8, 1), _4=Conv(8, 32, 1))
        self.final = Conv(32, n_cls, 1)

    def rest(self, h1: torch.Tensor, out_slice: Optional[slice] = None) -> torch.Tensor:
        """IN -> relu -> conv2 -> IN -> relu -> calibration -> final 1x1 in
        f32.  ``out_slice`` crops before the 1x1, which is exact."""
        x = torch.relu(instance_norm(h1))
        x = torch.relu(instance_norm(self.conv2(x)))
        cal = torch.relu(self.calibration["1"](global_avg_pool(x)))
        x = x * torch.sigmoid(self.calibration["4"](cal))
        if out_slice is not None:
            x = x[:, out_slice, out_slice, out_slice, :]
        return self.final(x.float())


class MICA(nn.Module):
    """``(exp_map, af) -> (backbone, ca, aa)`` logits in f32, each
    (B, D, H, W, n_cls) with n_cls 4/4/21; ``exp_map`` (B, D, H, W, 1),
    ``af`` (B, D, H, W, 24) or None."""

    def __init__(self, base: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.base = base
        self.dtype = dtype
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

    def heads(self, fpn, out_slice: Optional[slice]):
        """The three cascaded heads over one fused 192-out conv1 (K1, no
        bias, no statistics) of the FPN parts; bb/ca logits (f32) are cast
        back to the compute dtype for the cascade corrections."""
        dt = fpn[0].dtype
        fpn_ch = sum(p.shape[-1] for p in fpn)
        bb_h, ca_h, aa_h = self.backbone_head, self.ca_head, self.aa_head
        k_big = torch.cat([bb_h.conv1.weight, ca_h.conv1.weight[:, :fpn_ch],
                           aa_h.conv1.weight[:, :fpn_ch]], dim=0)
        big, _ = conv3d(list(fpn), k_big, None, with_stats=False)

        backbone = bb_h.rest(big[..., :64] + bb_h.conv1.bias.to(dt))
        bb_f = backbone.to(dt)
        h_ca = (big[..., 64:128] + conv_same(bb_f, ca_h.conv1.weight[:, fpn_ch:])
                + ca_h.conv1.bias.to(dt))
        ca = ca_h.rest(h_ca)
        h_aa = (big[..., 128:192]
                + conv_same(torch.cat([bb_f, ca.to(dt)], dim=-1),
                            aa_h.conv1.weight[:, fpn_ch:])
                + aa_h.conv1.bias.to(dt))
        aa = aa_h.rest(h_aa, out_slice)
        return backbone, ca, aa

    def forward(self, exp_map: torch.Tensor, af: Optional[torch.Tensor] = None,
                out_slice: Optional[slice] = None):
        dt = self.dtype
        x = self.input_processing(exp_map.to(dt), None if af is None else af.to(dt))
        feats = []
        for stage in self.encoder:
            x = stage(x)
            feats.append(x)
        return self.heads(self.fpn(feats), out_slice)
