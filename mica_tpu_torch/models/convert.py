"""Weight carrier: JAX parameter trees and original-format checkpoints to
the port's ``state_dict``.

Keys are the original MICA network's torch names, so one ``MICA`` module
loads both sources with ``load_state_dict(strict=True)``.  Layouts:

  * conv kernel DHWIO ``(kd, kh, kw, in/groups, out)`` -> OIDHW
  * dense kernel ``(in, out)`` -> ``(out, in)``
  * ``fpn.weights`` as is.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _head_map(torch_prefix: str, jax_prefix: str) -> Dict[str, tuple]:
    return {
        f"{torch_prefix}.conv1": (f"{jax_prefix}/conv1/Conv_0", "conv"),
        f"{torch_prefix}.conv2": (f"{jax_prefix}/conv2/Conv_0", "conv"),
        f"{torch_prefix}.calibration.1": (f"{jax_prefix}/cal0/Conv_0", "conv"),
        f"{torch_prefix}.calibration.4": (f"{jax_prefix}/cal1/Conv_0", "conv"),
        f"{torch_prefix}.final": (f"{jax_prefix}/final/Conv_0", "conv"),
    }


def layer_map() -> Dict[str, tuple]:
    """torch module path -> (JAX parameter path, kind); kinds conv | dense."""
    m: Dict[str, tuple] = {}
    ip = "input_processing"
    for i in range(4):
        m[f"{ip}.exp_convs.{i}"] = (f"{ip}/exp_conv{i}/Conv_0", "conv")
    m[f"{ip}.feat_conv"] = (f"{ip}/feat_conv/Conv_0", "conv")
    m[f"{ip}.exp_attention.1"] = (f"{ip}/exp_attn0/Conv_0", "conv")
    m[f"{ip}.exp_attention.3"] = (f"{ip}/exp_attn1/Conv_0", "conv")
    m[f"{ip}.exp_downsizing"] = (f"{ip}/exp_downsizing/Conv_0", "conv")
    m[f"{ip}.feat_gate.0"] = (f"{ip}/feat_gate0/Conv_0", "conv")
    m[f"{ip}.feat_gate.2"] = (f"{ip}/feat_gate1/Conv_0", "conv")
    m[f"{ip}.fusion"] = (f"{ip}/fusion/Conv_0", "conv")

    for i in range(3):
        e, f = f"encoder.{i}", f"encoder{i}"
        for c in (1, 2, 3):
            m[f"{e}.dense_block.conv{c}.0"] = (f"{f}/dense_block/conv{c}/Conv_0", "conv")
        m[f"{e}.dense_block.se.fc.0"] = (f"{f}/dense_block/se/Dense_0", "dense")
        m[f"{e}.dense_block.se.fc.3"] = (f"{f}/dense_block/se/Dense_1", "dense")
        m[f"{e}.dual_attn.local_attn.0"] = (f"{f}/dual_attn/local_conv/Conv_0", "conv")
        m[f"{e}.dual_attn.global_attn.1"] = (f"{f}/dual_attn/global0/Conv_0", "conv")
        m[f"{e}.dual_attn.global_attn.4"] = (f"{f}/dual_attn/global1/Conv_0", "conv")
        m[f"{e}.dual_attn.fusion"] = (f"{f}/dual_attn/fusion/Conv_0", "conv")
        m[f"{e}.transition.0"] = (f"{f}/transition/Conv_0", "conv")

    for i in range(3):
        m[f"fpn.lateral.{i}"] = (f"fpn/lateral{i}/Conv_0", "conv")
        m[f"fpn.smooth.{i}.0"] = (f"fpn/smooth{i}/Conv_0", "conv")

    m.update(_head_map("backbone_head", "backbone_head"))
    m.update(_head_map("ca_head", "ca_head"))
    m.update(_head_map("aa_head", "aa_head"))
    return m


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, p))
        else:
            flat[p] = np.array(v, np.float32)  # a writable copy
    return flat


def state_dict_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of arrays) -> torch state dict."""
    flat = _flatten(params)
    out: Dict[str, torch.Tensor] = {}
    for tpath, (jpath, kind) in layer_map().items():
        w = flat[f"{jpath}/kernel"]
        w = np.transpose(w, (4, 3, 0, 1, 2)) if kind == "conv" else w.T
        out[f"{tpath}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        b = flat.get(f"{jpath}/bias")
        if b is not None:
            out[f"{tpath}.bias"] = torch.from_numpy(np.ascontiguousarray(b))
    out["fpn.weights"] = torch.from_numpy(np.ascontiguousarray(flat["fpn/weights"]))
    return out


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A network checkpoint -> state dict (f32, no ``module.`` prefix).

    Takes the three layouts the port meets, whatever the file's name:

      * the original trainer's ``.pth``: the weights under
        ``model_state_dict``, keys prefixed ``module.`` by ``DataParallel``;
      * the port trainer's checkpoint (``train.trainer.save_checkpoint``,
        what ``cli.train`` writes): the weights under ``model``;
      * a bare state dict.

    Anything else raises ``ValueError`` naming the keys it found."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, Mapping):
        raise ValueError(f"{path}: a checkpoint is a dict, got {type(ckpt).__name__}")
    for key in ("model_state_dict", "model"):
        if isinstance(ckpt.get(key), Mapping):
            sd = ckpt[key]
            break
    else:
        sd = ckpt
    if not sd or not all(isinstance(v, torch.Tensor) for v in sd.values()):
        raise ValueError(
            f"{path}: not a network checkpoint (neither 'model_state_dict', 'model' nor a "
            f"bare state dict of tensors); its keys: {sorted(map(str, ckpt))[:12]}")
    return {(k[len("module."):] if k.startswith("module.") else k): v.float()
            for k, v in sd.items()}


def _carry(flat: Dict[str, np.ndarray], module_path) -> Dict[str, torch.Tensor]:
    """Flat flax leaves ``a/b/leaf`` -> torch keys: ``module_path`` maps the
    module segments to a dotted torch path; a dense ``kernel`` (in, out)
    becomes ``weight`` (out, in), a LayerNorm ``scale`` becomes ``weight``,
    other leaves keep their names and layouts."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in flat.items():
        *mods, leaf = path.split("/")
        if leaf == "kernel":
            leaf, v = "weight", v.T
        elif leaf == "scale":
            leaf = "weight"
        key = ".".join([m for m in [module_path(mods)] if m] + [leaf])
        out[key] = torch.from_numpy(np.ascontiguousarray(v))
    return out


_MERIZO_MODULES = {"transition_gru": "transition.layers.0",
                   "transition_ln": "transition.layer_norm",
                   "qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def _merizo_path(mods) -> str:
    return ".".join(f"blocks.{m[5:]}" if m.startswith("block") else _MERIZO_MODULES.get(m, m)
                    for m in mods)


def merizo_state_dict_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's Merizo trees ``{"merizo": ..., "confidence": ...}``
    -> the original torch network's state dict (``models.merizo.Merizo``);
    the confidence head's GRU and dense sit under ``decoder_head``."""
    sd = _carry(_flatten(params["merizo"]), _merizo_path)
    sd["decoder_head.cls_emb"] = sd["decoder_head.cls_emb"][None]
    sd.update(_carry(_flatten(params["confidence"]),
                     lambda mods: "decoder_head." + ".".join(mods)))
    return sd


def segmenter_state_dict_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``DomainSegmenter`` tree -> the state dict of
    ``models.segmenter.DomainSegmenter`` (``ipa{i}`` -> ``blocks.{i}``,
    its ``LayerNorm_0/1`` -> ``norm1/2``)."""
    norms = {"LayerNorm_0": "norm1", "LayerNorm_1": "norm2"}
    return _carry(_flatten(params), lambda mods: ".".join(
        f"blocks.{m[3:]}" if m.startswith("ipa") else norms.get(m, m) for m in mods))
