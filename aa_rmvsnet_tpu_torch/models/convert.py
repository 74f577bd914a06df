"""Weight bridge between the port, the reference torch checkpoints and the
JAX package's flax parameter tree.

The port's ``state_dict`` keys are the reference torch names (90 tensors,
187,203 parameters under ``feature`` / ``omega`` /
``cost_regularization``), so a reference ``.ckpt`` loads with
``load_state_dict(strict=True)`` (:func:`load_reference_checkpoint`).
:func:`params_from_jax` maps a flax tree (as numpy arrays) to such a state
dict; it is the inverse of the JAX package's ``convert_state_dict``:

- flax ``HWIO`` conv kernel -> torch ``OIHW``;
- the equivalent-forward-conv deconv kernel -> ``ConvTranspose2d``
  ``(I, O, kh, kw)`` (transpose back, undo the spatial flip);
- GroupNorm ``scale`` -> ``weight``.

The rules table is this package's own copy of the one in
``aa_rmvsnet_tpu/models/convert.py``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _deform(k):
    return [
        (f"feature.intraAA.deformconv{k}.0.conv", (f"feature/intraAA/deformconv{k}/deform", "conv")),
        (f"feature.intraAA.deformconv{k}.0.p_conv", (f"feature/intraAA/deformconv{k}/deform/p_conv", "conv")),
        (f"feature.intraAA.deformconv{k}.0.m_conv", (f"feature/intraAA/deformconv{k}/deform/m_conv", "conv")),
        (f"feature.intraAA.deformconv{k}.1", (f"feature/intraAA/deformconv{k}/gn", "gn")),
        (f"feature.intraAA.conv{k}.0", (f"feature/intraAA/conv{k}/conv", "conv")),
        (f"feature.intraAA.conv{k}.1", (f"feature/intraAA/conv{k}/gn", "gn")),
    ]


# torch module prefix -> (flax path, kind); kind: conv | deconv | gn
RULES: list[tuple[str, tuple[str, str]]] = (
    [
        ("feature.init_conv.0.0", ("feature/init_conv0/conv", "conv")),
        ("feature.init_conv.0.1", ("feature/init_conv0/gn", "gn")),
        ("feature.init_conv.1.0", ("feature/init_conv1/conv", "conv")),
        ("feature.init_conv.1.1", ("feature/init_conv1/gn", "gn")),
        ("feature.conv0.0", ("feature/conv0/conv", "conv")),
        ("feature.conv0.1", ("feature/conv0/gn", "gn")),
        ("feature.conv1.0", ("feature/conv1/conv", "conv")),
        ("feature.conv1.1", ("feature/conv1/gn", "gn")),
        ("feature.conv2.0", ("feature/conv2/conv", "conv")),
        ("feature.conv2.1", ("feature/conv2/gn", "gn")),
    ]
    + _deform(0)
    + _deform(1)
    + _deform(2)
    + [
        ("omega.reweight_network.0.0", ("omega/rw0/conv", "conv")),
        ("omega.reweight_network.0.1", ("omega/rw0/gn", "gn")),
        ("omega.reweight_network.1.stem.0.0", ("omega/rw1/stem0/conv", "conv")),
        ("omega.reweight_network.1.stem.0.1", ("omega/rw1/stem0/gn", "gn")),
        ("omega.reweight_network.1.stem.1", ("omega/rw1/stem1", "conv")),
        ("omega.reweight_network.1.stem.2", ("omega/rw1/gn", "gn")),
        ("omega.reweight_network.2", ("omega/rw2", "conv")),
        ("cost_regularization.cell_list.0.conv", ("cost_regularization/cell0/conv", "conv")),
        ("cost_regularization.cell_list.1.conv", ("cost_regularization/cell1/conv", "conv")),
        ("cost_regularization.cell_list.2.conv", ("cost_regularization/cell2/conv", "conv")),
        ("cost_regularization.cell_list.3.conv", ("cost_regularization/cell3/conv", "conv")),
        ("cost_regularization.cell_list.4.conv", ("cost_regularization/cell4/conv", "conv")),
        ("cost_regularization.deconv_0.conv", ("cost_regularization/deconv0", "deconv")),
        ("cost_regularization.deconv_0.gn", ("cost_regularization/deconv0/gn", "gn")),
        ("cost_regularization.deconv_1.conv", ("cost_regularization/deconv1", "deconv")),
        ("cost_regularization.deconv_1.gn", ("cost_regularization/deconv1/gn", "gn")),
        ("cost_regularization.conv_0", ("cost_regularization/conv_out", "conv")),
    ]
)


def _node(tree: Mapping, path: str) -> Mapping:
    for part in path.split("/"):
        tree = tree[part]
    return tree


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax parameter tree (``{'params': ...}`` or its inner dict, numpy
    leaves) -> port ``state_dict`` with the reference torch key names."""
    params = tree["params"] if "params" in tree else tree
    state: dict[str, torch.Tensor] = {}
    for prefix, (path, kind) in RULES:
        node = _node(params, path)
        if kind == "gn":
            weight = np.asarray(node["scale"], np.float32)
        elif kind == "conv":  # HWIO -> OIHW
            weight = np.transpose(np.asarray(node["kernel"], np.float32), (3, 2, 0, 1))
        else:  # deconv: forward-conv HWIO -> ConvTranspose2d (I, O, kh, kw)
            k = np.transpose(np.asarray(node["kernel"], np.float32), (2, 3, 0, 1))
            weight = k[:, :, ::-1, ::-1]
        state[prefix + ".weight"] = torch.from_numpy(np.array(weight, order="C"))
        state[prefix + ".bias"] = torch.from_numpy(
            np.array(node["bias"], np.float32, order="C")
        )
    return state


def load_reference_checkpoint(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load a reference ``.ckpt`` (``{'epoch', 'model', 'optimizer'}`` or a
    bare state dict) into ``model`` with ``strict=True``.

    DataParallel ``module.`` prefixes are stripped; ``evidential.*`` tensors
    (the uncertainty head, not part of the core) are dropped.
    """
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state = payload["model"] if "model" in payload else payload
    state = {k.removeprefix("module."): v for k, v in state.items()}
    state = {k: v for k, v in state.items() if not k.startswith("evidential.")}
    model.load_state_dict(state, strict=True)
    return model
