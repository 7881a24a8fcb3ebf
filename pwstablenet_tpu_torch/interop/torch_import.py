"""Weights in the reference's PyTorch ``.pth`` layout into the port, and
back.

The reference layout is ``interop.torch_ref``'s (``stages.{s}.downs.{i}``,
``dnorms``, ``ups.{l}``, ``unorms``, ``head_up``, ``head``; ``convs.{k}``
for the feature extractor).  The port's modules are the same torch
``Conv2d`` and ``ConvTranspose2d`` layers under the JAX package's names
(``stage{s}.down{i}.conv``, ``.norm``, ``up{l}.deconv``, ``head_up``,
``head``; ``conv{i}a``, ``conv{i}b``), so a checkpoint maps by name
alone: no tensor is transposed or flipped.  Every mapping checks the
stage count, each name and each shape against the model that ``cfg``
builds, and raises on a key it does not know.
"""

from __future__ import annotations

import pickle
import re
from typing import Callable, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from pwstablenet_tpu_torch.config import ModelConfig

_Rules = Sequence[Tuple["re.Pattern[str]", str]]

# reference name -> port name
_TO_PORT: _Rules = tuple((re.compile(p), r) for p, r in (
    (r"^stages\.(\d+)\.downs\.(\d+)\.(weight|bias)$", r"stage\1.down\2.conv.\3"),
    (r"^stages\.(\d+)\.dnorms\.(\d+)\.(weight|bias)$", r"stage\1.down\2.norm.\3"),
    (r"^stages\.(\d+)\.ups\.(\d+)\.(weight|bias)$", r"stage\1.up\2.deconv.\3"),
    (r"^stages\.(\d+)\.unorms\.(\d+)\.(weight|bias)$", r"stage\1.up\2.norm.\3"),
    (r"^stages\.(\d+)\.(head_up|head)\.(weight|bias)$", r"stage\1.\2.\3"),
))
# port name -> reference name
_TO_TORCH: _Rules = tuple((re.compile(p), r) for p, r in (
    (r"^stage(\d+)\.down(\d+)\.conv\.(weight|bias)$", r"stages.\1.downs.\2.\3"),
    (r"^stage(\d+)\.down(\d+)\.norm\.(weight|bias)$", r"stages.\1.dnorms.\2.\3"),
    (r"^stage(\d+)\.up(\d+)\.deconv\.(weight|bias)$", r"stages.\1.ups.\2.\3"),
    (r"^stage(\d+)\.up(\d+)\.norm\.(weight|bias)$", r"stages.\1.unorms.\2.\3"),
    (r"^stage(\d+)\.(head_up|head)\.(weight|bias)$", r"stages.\1.\2.\3"),
))


def _tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))


def _generator_shapes(cfg: ModelConfig) -> Dict[str, torch.Size]:
    """Names and shapes of the port's generator for ``cfg`` (built on
    the meta device: no memory, no initialisation)."""
    from pwstablenet_tpu_torch.models.generator import CascadedGenerator

    with torch.device("meta"):
        return {k: v.shape for k, v in CascadedGenerator(cfg).state_dict().items()}


def _feature_shapes(cfg: ModelConfig) -> Dict[str, torch.Size]:
    from pwstablenet_tpu_torch.models.features import FeatureExtractor

    with torch.device("meta"):
        return {k: v.shape for k, v in FeatureExtractor(cfg).state_dict().items()}


def _rename(key: str, rules: _Rules) -> str:
    for pattern, repl in rules:
        new, n = pattern.subn(repl, key)
        if n:
            return new
    raise KeyError(f"unknown key {key!r} in a generator state dict")


def _check_stages(keys, cfg: ModelConfig) -> None:
    stages = {int(m.group(1)) for k in keys if (m := re.match(r"^stages\.(\d+)\.", k))}
    if stages != set(range(cfg.num_stages)):
        raise ValueError(
            f"state dict has stages {sorted(stages)}; the config expects "
            f"{list(range(cfg.num_stages))}"
        )


def _checked(sd: Mapping[str, torch.Tensor], expect: Dict[str, torch.Size],
             name_of: Callable[[str], str]) -> Dict[str, torch.Tensor]:
    """``sd`` (keys in ``expect``'s naming) in ``expect``'s order, after
    checking that it has every name and no other, and each shape;
    ``name_of`` gives a key's name in the caller's layout, for the
    error messages."""
    unknown = [name_of(k) for k in sd if k not in expect]
    if unknown:
        raise KeyError(f"keys the config has no parameter for: {unknown}")
    missing = [name_of(k) for k in expect if k not in sd]
    if missing:
        raise KeyError(f"state dict lacks {missing}")
    out = {}
    for k, shape in expect.items():
        t = _tensor(sd[k])
        if t.shape != shape:
            raise ValueError(
                f"{name_of(k)} has shape {tuple(t.shape)}; the config "
                f"expects {tuple(shape)}"
            )
        out[k] = t
    return out


def torch_state_dict_to_port(state_dict: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A ``TorchCascadedGenerator`` state dict (the reference's ``.pth``
    layout) -> the port's ``CascadedGenerator`` state dict (float32 CPU
    tensors)."""
    _check_stages(state_dict.keys(), cfg)
    renamed = {_rename(k, _TO_PORT): v for k, v in state_dict.items()}
    return _checked(renamed, _generator_shapes(cfg), lambda k: _rename(k, _TO_TORCH))


def port_to_torch_state_dict(state_dict: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Inverse of ``torch_state_dict_to_port``: the port's generator
    state dict -> the reference's ``.pth`` layout (float32 CPU tensors,
    for ``torch.save``)."""
    checked = _checked(state_dict, _generator_shapes(cfg), lambda k: k)
    return {_rename(k, _TO_TORCH): v for k, v in checked.items()}


def feat_state_dict_to_port(state_dict: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A ``TorchFeatureExtractor`` state dict (``convs.{k}``) -> the port's
    ``FeatureExtractor`` state dict (``conv{k // 2}a`` / ``b``)."""
    renamed = {}
    for key, value in state_dict.items():
        m = re.match(r"^convs\.(\d+)\.(weight|bias)$", key)
        if m is None:
            raise KeyError(f"unknown key {key!r} in a feature-extractor state dict")
        k = int(m.group(1))
        renamed[f"conv{k // 2}{'ab'[k % 2]}.{m.group(2)}"] = value

    def reference_name(key: str) -> str:
        m = re.match(r"^conv(\d+)([ab])\.(weight|bias)$", key)
        return f"convs.{2 * int(m.group(1)) + 'ab'.index(m.group(2))}.{m.group(3)}"

    return _checked(renamed, _feature_shapes(cfg), reference_name)


def torchvision_vgg_to_port(vgg_state_dict: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The leading convs of a torchvision VGG ``features`` state dict
    (``features.N.weight`` / ``.bias``) -> the port's ``FeatureExtractor``
    state dict.

    The extractor has two 3x3 convs a scale, as VGG's first blocks do;
    with ``feat_channels=(64, 128)`` (VGG's block widths) a torchvision
    VGG16/19 checkpoint imports without loss.  Convs are taken in
    ``features.N`` order, two a scale; a shape that does not fit (for
    example more scales than two-conv blocks) raises."""
    convs = sorted(
        int(k.split(".")[1]) for k in vgg_state_dict
        if k.startswith("features.") and k.endswith(".weight")
    )
    out: Dict[str, torch.Tensor] = {}
    ch = cfg.in_channels
    for i, f in enumerate(cfg.feat_channels):
        for j, tag in enumerate("ab"):
            if 2 * i + j >= len(convs):
                raise ValueError(
                    f"the VGG state dict has {len(convs)} convs; "
                    f"feat_channels={cfg.feat_channels} needs "
                    f"{2 * len(cfg.feat_channels)}"
                )
            idx = convs[2 * i + j]
            w = _tensor(vgg_state_dict[f"features.{idx}.weight"])
            expect_in = ch if tag == "a" else f
            if tuple(w.shape) != (f, expect_in, 3, 3):
                raise ValueError(
                    f"VGG conv features.{idx} has shape {tuple(w.shape)}; "
                    f"feat_channels={cfg.feat_channels} expects "
                    f"({f}, {expect_in}, 3, 3) at scale {i}{tag} — use "
                    "VGG block widths, e.g. feat_channels=(64, 128)"
                )
            out[f"conv{i}{tag}.weight"] = w
            out[f"conv{i}{tag}.bias"] = _tensor(vgg_state_dict[f"features.{idx}.bias"])
        ch = f
    return out


def load_torch_checkpoint(path: str, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A ``.pth`` / ``.pt`` file -> the port's generator state dict.

    The file holds the reference layout's state dict, a dict that holds
    one under ``state_dict``, ``generator``, ``G`` or ``model``, or a
    pickled module.  A state dict is read without running any pickled
    code; a pickled module is unpickled in full, which runs code from
    the file, so pass only files from a source you trust."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    for key in ("state_dict", "generator", "G", "model"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    return torch_state_dict_to_port(obj, cfg)
