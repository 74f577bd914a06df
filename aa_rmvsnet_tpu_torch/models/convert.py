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
and :func:`load_evidential_checkpoint` reads the head.  The rules tables
are this package's own copies of the ones in
``aa_rmvsnet_tpu/models/convert.py``.

Both loaders take a torch ``.ckpt`` or an orbax checkpoint directory, as
the JAX CLI's ``--loadckpt``, ``--evidential_ckpt`` and ``--head_ckpt`` do.
:func:`read_orbax` reads orbax's on-disk format (an OCDBT key-value store of
zarr arrays, described by the JSON ``_METADATA``) with the tensorstore
package alone, since ``orbax.checkpoint`` imports JAX; tensorstore is
imported on use, and a host without it gets :class:`UnreadableCheckpoint`.
:func:`convert_orbax_checkpoint` (``cli convert``) writes such a directory
as a torch ``.ckpt`` under the reference key names.
"""

from __future__ import annotations

import json
import os
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


def params_to_jax(state: Mapping[str, torch.Tensor]) -> dict:
    """Port (or reference) ``state_dict`` -> the flax parameter tree
    ``{'params': ...}`` of numpy arrays, the inverse of
    :func:`params_from_jax` (the JAX package's ``convert_state_dict``)."""
    tree: dict = {}
    for prefix, (path, kind) in RULES:
        node = tree
        for part in path.split("/"):
            node = node.setdefault(part, {})
        weight = state[prefix + ".weight"].detach().cpu().float().numpy()
        if kind == "gn":
            node["scale"] = weight
        elif kind == "conv":  # OIHW -> HWIO
            node["kernel"] = np.ascontiguousarray(np.transpose(weight, (2, 3, 1, 0)))
        else:  # ConvTranspose2d (I, O, kh, kw) -> forward-conv HWIO
            node["kernel"] = np.ascontiguousarray(
                np.transpose(weight[:, :, ::-1, ::-1], (2, 3, 0, 1)))
        node["bias"] = state[prefix + ".bias"].detach().cpu().float().numpy()
    return {"params": tree}


def _checkpoint_state(path) -> dict[str, torch.Tensor]:
    """The state dict of a torch ``.ckpt`` (``{'epoch', 'model', ...}`` or a
    bare state dict), DataParallel ``module.`` prefixes stripped."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state = payload["model"] if "model" in payload else payload
    return {k.removeprefix("module."): v for k, v in state.items()}


# ---------------------------------------------------------------------------
# Orbax checkpoints, read without orbax
# ---------------------------------------------------------------------------

#: The orbax value types that hold an array in the store.
_ORBAX_ARRAYS = ("np.ndarray", "jax.Array")


class UnreadableCheckpoint(Exception):
    """A checkpoint path that no loader of this package reads: neither a
    torch ``.ckpt`` nor an orbax directory, or an orbax directory on a host
    without tensorstore."""


def orbax_item(path) -> str:
    """The orbax item directory (the one holding ``_METADATA``) that
    ``path`` names: the directory itself (a params directory, as JAX ``cli
    convert`` and ``scripts/train_evidential_head.py`` write it), its
    ``params`` item (a step of JAX ``cli train``), or, for a JAX train logdir,
    the ``params`` of its highest step (as ``restore_latest`` picks it)."""
    path = str(path)
    if os.path.isfile(os.path.join(path, "_METADATA")):
        return path
    if os.path.isfile(os.path.join(path, "params", "_METADATA")):
        return os.path.join(path, "params")
    steps = sorted(int(name) for name in (os.listdir(path) if os.path.isdir(path) else ())
                   if name.isdigit()
                   and os.path.isfile(os.path.join(path, name, "params", "_METADATA")))
    if steps:
        return os.path.join(path, str(steps[-1]), "params")
    raise UnreadableCheckpoint(
        f"{path}: neither a torch .ckpt nor an orbax checkpoint directory (no "
        "_METADATA in it, in its params/ or in a params/ of a numbered step)")


def read_orbax(path) -> dict:
    """The array tree of an orbax checkpoint as nested dicts of numpy arrays
    (the tree ``orbax.checkpoint.StandardCheckpointer().restore`` gives, on
    the host).  ``path`` is any directory :func:`orbax_item` takes.

    ``_METADATA``'s ``tree_metadata`` lists every leaf's key path; each
    array is the zarr array (zarr3 where ``use_zarr3``) under the key path
    joined by ``"."`` in the item's OCDBT store.  Leaves orbax did not
    store (``None``) are left out.
    """
    item = orbax_item(path)
    try:
        import tensorstore as ts
    except ImportError:
        raise UnreadableCheckpoint(
            f"{item}: reading an orbax checkpoint needs the tensorstore package, "
            "which this host lacks; convert it to a torch .ckpt with 'cli convert' "
            "where tensorstore is installed") from None
    with open(os.path.join(item, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", True):
        raise UnreadableCheckpoint(f"{item}: an orbax checkpoint without OCDBT is not read")
    store = {"driver": "ocdbt", "base": "file://" + os.path.abspath(item)}
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        kind = entry["value_metadata"]["value_type"]
        if kind == "None":
            continue
        if kind not in _ORBAX_ARRAYS:
            raise UnreadableCheckpoint(f"{item}: leaf {'/'.join(keys)} holds an orbax "
                                       f"{kind!r}, which is not read")
        spec = {"driver": driver, "kvstore": {**store, "path": ".".join(keys) + "/"}}
        leaves.append((keys, ts.open(spec, open=True, read=True)))
    tree: dict = {}
    for keys, opened in leaves:
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = np.asarray(opened.result().read().result())
    return tree


def orbax_value_count(tree: Mapping) -> int:
    """The number of values in an array tree (what JAX ``cli convert``
    prints for the same tree)."""
    return sum(orbax_value_count(v) if isinstance(v, Mapping) else int(np.asarray(v).size)
               for v in tree.values())


def _convert_orbax(path, convert) -> tuple[dict[str, torch.Tensor], dict]:
    """``(convert(tree), tree)`` of the orbax checkpoint at ``path``; a
    tree that lacks a parameter the conversion needs raises
    :class:`UnreadableCheckpoint` naming it."""
    tree = read_orbax(path)
    try:
        return convert(tree), tree
    except KeyError as exc:
        raise UnreadableCheckpoint(
            f"{path}: not a checkpoint of these weights: its orbax tree has no "
            f"{exc.args[0]!r} ({convert.__name__})") from None


def _read_state(path, convert) -> dict[str, torch.Tensor]:
    """The state dict of the checkpoint at ``path``: a torch file as it is,
    an orbax directory through ``convert`` (a flax tree -> state dict)."""
    if os.path.isdir(path):
        return _convert_orbax(path, convert)[0]
    return _checkpoint_state(path)


def core_state_from_orbax(tree: Mapping) -> dict[str, torch.Tensor]:
    """:func:`params_from_jax` of the core's flax tree in an orbax tree: the
    tree itself, or its ``core`` in a JAX ``cli train --evidential`` step
    (``aa_rmvsnet_tpu/pipeline/train.py:make_evidential_state``)."""
    return params_from_jax(tree["core"] if "core" in tree else tree)


def head_state_from_orbax(tree: Mapping) -> dict[str, torch.Tensor]:
    """:func:`evidential_params_from_jax` of the head's flax variables in an
    orbax tree: the tree itself, or the ``head`` and ``batch_stats`` of a
    JAX ``cli train --evidential`` step."""
    if "head" in tree:
        tree = {"params": tree["head"], "batch_stats": tree["batch_stats"]}
    return evidential_params_from_jax(tree)


def load_reference_checkpoint(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load the core's weights into ``model`` with ``strict=True``, from a
    reference ``.ckpt`` (``{'epoch', 'model', 'optimizer'}`` or a bare state
    dict) or an orbax directory of the JAX package's flax tree
    (:func:`orbax_item`; the flax tree, or the ``core`` of a JAX ``cli
    train --evidential`` step, converted by :func:`params_from_jax`).

    DataParallel ``module.`` prefixes are stripped; ``evidential.*`` tensors
    (the uncertainty head, not part of the core) are dropped.  A path that
    is neither raises :class:`UnreadableCheckpoint`.
    """
    state = {k: v for k, v in _read_state(str(path), core_state_from_orbax).items()
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
    """Load evidential-head weights into ``head`` with ``strict=True``, as
    the JAX CLI's ``_load_evidential`` reads them
    (``aa_rmvsnet_tpu/cli.py:270-289``): from a torch ``.ckpt``, with
    ``module.`` and ``evidential.`` prefixes stripped and a whole-model
    file keeping only the head's tensors, or from an orbax directory of the
    head's flax variables, or of a JAX ``cli train --evidential`` step
    (converted by :func:`evidential_params_from_jax`).
    A path that is neither raises :class:`UnreadableCheckpoint`."""
    state = _read_state(str(path), head_state_from_orbax)
    head_only = {k.removeprefix("evidential."): v for k, v in state.items()
                 if k.startswith("evidential.")}
    head.load_state_dict(head_only or state, strict=True)
    return head


def convert_orbax_checkpoint(path, out, evidential: bool = False) -> int:
    """``cli convert``: the orbax checkpoint at ``path`` (:func:`orbax_item`)
    as a torch ``.ckpt`` at ``out``, ``{'model': state_dict}`` under the
    reference key names; with ``evidential`` the head's flax variables,
    their keys under the reference's ``evidential.`` prefix.  Both the
    port's strict loaders and the JAX CLI's ``.ckpt`` readers take the
    file.  Returns the number of values in the orbax tree."""
    if evidential:
        head, tree = _convert_orbax(path, head_state_from_orbax)
        state = {"evidential." + k: v for k, v in head.items()}
    else:
        state, tree = _convert_orbax(path, core_state_from_orbax)
    torch.save({"model": state}, out)
    return orbax_value_count(tree)
