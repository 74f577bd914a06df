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

:func:`evidential_params_from_jax` does the same for the evidential head
(3D kernels and BatchNorm), the inverse of ``convert_evidential_state_dict``,
and :func:`load_evidential_checkpoint` reads the head from a torch
``.ckpt``.  The rules tables are this package's own copies of the ones in
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


def _checkpoint_state(path) -> dict[str, torch.Tensor]:
    """The state dict of a torch ``.ckpt`` (``{'epoch', 'model', ...}`` or a
    bare state dict), DataParallel ``module.`` prefixes stripped."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state = payload["model"] if "model" in payload else payload
    return {k.removeprefix("module."): v for k, v in state.items()}


def load_reference_checkpoint(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load a reference ``.ckpt`` (``{'epoch', 'model', 'optimizer'}`` or a
    bare state dict) into ``model`` with ``strict=True``.

    DataParallel ``module.`` prefixes are stripped; ``evidential.*`` tensors
    (the uncertainty head, not part of the core) are dropped.
    """
    state = {k: v for k, v in _checkpoint_state(path).items()
             if not k.startswith("evidential.")}
    model.load_state_dict(state, strict=True)
    return model


# ---------------------------------------------------------------------------
# The evidential head (this package's own copy of the JAX package's
# ``_evidential_rules``, ``aa_rmvsnet_tpu/models/convert.py:158-209``)
# ---------------------------------------------------------------------------


def _evidential_rules() -> list[tuple[str, str, str]]:
    """(torch prefix, flax path, kind) for the evidential head; kind:
    conv3d | deconv3d | bn."""
    rules: list[tuple[str, str, str]] = []

    def convbn(tp, fp):
        rules.append((tp + ".0", fp + "/conv", "conv3d"))
        rules.append((tp + ".1", fp + "/bn", "bn"))

    def deconvbn(tp, fp):
        rules.append((tp + ".0", fp, "deconv3d"))
        rules.append((tp + ".1", fp + "/bn", "bn"))

    for name in ("dres0", "dres1", "conv_vol2", "conv_vol3"):
        convbn(f"{name}.0", f"{name}_0")
        convbn(f"{name}.2", f"{name}_1")

    rules.append(("combine1.conv1", "combine1/conv1/conv", "conv3d"))
    convbn("combine1.conv2.0", "combine1/conv2")
    rules.append(("combine1.conv3", "combine1/conv3/conv", "conv3d"))
    convbn("combine1.conv4.0", "combine1/conv4")
    deconvbn("combine1.conv8", "combine1/conv8")
    deconvbn("combine1.conv9", "combine1/conv9")
    convbn("combine1.combine1.0", "combine1/combine1")
    convbn("combine1.combine2.0", "combine1/combine2")
    for r in ("redir1", "redir2", "redir3"):
        convbn(f"combine1.{r}", f"combine1/{r}")

    for hg in ("dres2", "dres3"):
        for c in ("conv1", "conv2", "conv3", "conv4"):
            convbn(f"{hg}.{c}.0", f"{hg}/{c}")
        deconvbn(f"{hg}.conv5", f"{hg}/conv5")
        deconvbn(f"{hg}.conv6", f"{hg}/conv6")
        convbn(f"{hg}.redir1", f"{hg}/redir1")
        convbn(f"{hg}.redir2", f"{hg}/redir2")

    for k in range(3):
        convbn(f"classif{k}.0", f"classif{k}_0")
        rules.append((f"classif{k}.2", f"classif{k}_1", "conv3d"))
    return rules


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def evidential_params_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax variables of the JAX ``EvidentialHead`` (``{'params': ...,
    'batch_stats': ...}``, numpy leaves) -> port head ``state_dict``; the
    inverse of the JAX package's ``convert_evidential_state_dict``:

    - conv3d ``DHWIO`` -> ``OIDHW``;
    - deconv3d: the equivalent forward conv's ``DHWIO`` kernel ->
      ``ConvTranspose3d`` ``(I, O, kd, kh, kw)`` (transpose back, undo the
      flip of all three spatial axes);
    - BN ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
      ``running_mean``/``running_var``, ``num_batches_tracked`` 0.
    """
    params, stats = variables["params"], variables["batch_stats"]
    state: dict[str, torch.Tensor] = {}
    for prefix, path, kind in _evidential_rules():
        if kind == "conv3d":
            kernel = np.asarray(_node(params, path)["kernel"], np.float32)
            state[prefix + ".weight"] = _tensor(np.transpose(kernel, (4, 3, 0, 1, 2)))
        elif kind == "deconv3d":
            kernel = np.transpose(np.asarray(_node(params, path)["kernel"], np.float32),
                                  (3, 4, 0, 1, 2))
            state[prefix + ".weight"] = _tensor(kernel[:, :, ::-1, ::-1, ::-1])
        else:
            affine, running = _node(params, path), _node(stats, path)
            state[prefix + ".weight"] = _tensor(affine["scale"])
            state[prefix + ".bias"] = _tensor(affine["bias"])
            state[prefix + ".running_mean"] = _tensor(running["mean"])
            state[prefix + ".running_var"] = _tensor(running["var"])
            state[prefix + ".num_batches_tracked"] = torch.tensor(0)
    return state


def load_evidential_checkpoint(head: torch.nn.Module, path) -> torch.nn.Module:
    """Load evidential-head weights from a torch ``.ckpt`` into ``head``
    with ``strict=True``, as the JAX CLI's ``_load_evidential`` reads one
    (``aa_rmvsnet_tpu/cli.py:270-286``): ``module.`` and ``evidential.``
    prefixes are stripped, and a whole-model file keeps only the head's
    tensors.  The JAX CLI also reads an orbax directory; the port does not
    yet (it imports no orbax) and raises ``NotImplementedError``."""
    path = str(path)
    if not path.endswith(".ckpt"):
        raise NotImplementedError(
            f"{path}: only a torch .ckpt is read; an orbax checkpoint is not "
            "ported yet to aa_rmvsnet_tpu_torch")
    state = _checkpoint_state(path)
    head_only = {k.removeprefix("evidential."): v for k, v in state.items()
                 if k.startswith("evidential.")}
    head.load_state_dict(head_only or state, strict=True)
    return head
