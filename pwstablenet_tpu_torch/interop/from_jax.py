"""Weights from the JAX package's models into the port, and back.

``jax_params_to_state_dict`` takes the flax ``CascadedGenerator``
parameter tree as nested dicts of numpy arrays (no JAX needed) and
returns a ``state_dict`` for ``models.CascadedGenerator``;
``tree_to_state_dict`` does the same for the ``PatchDiscriminator`` and
the ``FeatureExtractor`` (convs and norm scales only, no stage check).
The port's modules carry the flax names (``stage0.down1.conv``,
``stage1.up2.deconv``, ``stage0.head_up``, ``conv1``, ``norm1``,
``score``, ``conv0a``, ...), so only the leaves change:

- conv ``kernel`` (kh, kw, I, O) -> ``weight`` (O, I, kh, kw);
- transposed-conv ``kernel`` (kh, kw, I, O) -> ``weight`` (I, O, kh, kw),
  spatially flipped by 180 degrees: torch's ConvTranspose2d is the
  gradient of Conv2d, flax's ConvTranspose a fractionally strided conv
  with an unflipped kernel;
- norm ``scale`` -> ``weight``; ``bias`` stays ``bias``.

``state_dict_to_jax_params`` and ``state_dict_to_tree`` are the
inverses.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pwstablenet_tpu_torch.config import ModelConfig

# parents whose "kernel" is a transposed conv
_DECONV = ("deconv", "head_up")


def _conv_to_torch(k: np.ndarray) -> np.ndarray:
    return k.transpose(3, 2, 0, 1)


def _deconv_to_torch(k: np.ndarray) -> np.ndarray:
    return k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]


def _conv_to_jax(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 1, 0)


def _deconv_to_jax(w: np.ndarray) -> np.ndarray:
    return w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)


def _check_stages(names, cfg: ModelConfig) -> None:
    expect = {f"stage{s}" for s in range(cfg.num_stages)}
    if set(names) != expect:
        raise ValueError(
            f"parameter tree has stages {sorted(names)}; the config "
            f"expects {sorted(expect)}"
        )


def tree_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (nested dicts of arrays) -> a ``state_dict``
    of float32 CPU tensors.  Any of the three models; the generator's
    entry point, ``jax_params_to_state_dict``, adds its stage check."""
    tree = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}

    def walk(node, prefix, parent):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{key}.", key)
                continue
            a = np.asarray(value, dtype=np.float32)
            name = key
            if key == "kernel":
                a = _deconv_to_torch(a) if parent in _DECONV else _conv_to_torch(a)
                name = "weight"
            elif key == "scale":
                name = "weight"
            sd[prefix + name] = torch.from_numpy(np.array(a, order="C"))

    walk(tree, "", "")
    return sd


def state_dict_to_tree(state_dict) -> Dict:
    """Inverse of ``tree_to_state_dict``: a ``state_dict`` ->
    ``{"params": nested dicts of numpy arrays}``."""
    tree: Dict = {}
    for key, value in state_dict.items():
        path = key.split(".")
        a = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        parent, leaf = path[-2], path[-1]
        if leaf == "weight" and a.ndim == 4:
            a = _deconv_to_jax(a) if parent in _DECONV else _conv_to_jax(a)
            leaf = "kernel"
        elif leaf == "weight":
            leaf = "scale"
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return {"params": tree}


def jax_params_to_state_dict(params, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """flax ``CascadedGenerator`` params (nested dicts of arrays) ->
    the port's ``state_dict`` (float32 CPU tensors)."""
    _check_stages(params.get("params", params).keys(), cfg)
    return tree_to_state_dict(params)


def state_dict_to_jax_params(state_dict, cfg: ModelConfig) -> Dict:
    """Inverse of ``jax_params_to_state_dict``: the port's ``state_dict``
    -> ``{"params": nested dicts of numpy arrays}``."""
    tree = state_dict_to_tree(state_dict)
    _check_stages(tree["params"].keys(), cfg)
    return tree
