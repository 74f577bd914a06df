"""Colour-mapped PNG previews of depth and uncertainty maps (reference
datasets/data_io.py:77-128), and the model's module summary and parameter
graph (the JAX package's ``utils/visualize.py``; reference
evidential/visu.py:1-63 draws torchviz graphs of stand-in models, here the
real modules are drawn).  matplotlib is imported on use.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
from torch import nn

from .optional import pyplot


def save_depth_png(path, array: np.ndarray, mode: str = "depth") -> None:
    """Write a jet-colour-mapped preview, as the JAX package's
    ``save_depth_png``: ``mode='depth'`` inverts the values (near is warm),
    ``mode='relative'`` normalises them to their min and max; non-finite
    values are 0."""
    plt = pyplot("the PNG previews (cli eval --save_png)")
    arr = np.asarray(array, dtype=np.float32)
    valid = np.isfinite(arr)
    vmin = float(arr[valid].min()) if valid.any() else 0.0
    vmax = float(arr[valid].max()) if valid.any() else 1.0
    if mode == "depth":
        arr = np.where(valid, (vmax - arr) + vmin, 0.0)
    else:
        arr = np.where(valid, (arr - vmin) / max(vmax - vmin, 1e-12), 0.0)
    plt.imsave(path, arr, cmap="jet")


def _module_table(model: nn.Module, title: str) -> str:
    """One line per module of ``model``'s tree, indented by depth: its path,
    its class and the parameters it holds with its children."""
    rows = [(name, type(module).__name__, sum(p.numel() for p in module.parameters()))
            for name, module in model.named_modules()]
    width = max(2 * name.count(".") + len(name.rsplit(".", 1)[-1]) for name, _, _ in rows) + 2
    lines = [f"{title}: {rows[0][2]:,} parameters",
             f"{'module':<{width}} {'class':<16} {'parameters':>12}"]
    for name, kind, count in rows[1:]:
        label = "  " * name.count(".") + name.rsplit(".", 1)[-1]
        lines.append(f"{label:<{width}} {kind:<16} {count:>12,}")
    return "\n".join(lines)


def model_summary(maxdisp: int = 32) -> str:
    """The module trees of the core and of the evidential head at
    ``maxdisp`` with their parameter counts (the JAX package's flax
    ``tabulate`` summaries)."""
    import torch

    from ..models.evidential import EvidentialHead
    from ..models.network import AARMVSNetCore

    # Their own generator: a summary leaves torch's global one alone.
    core = AARMVSNetCore(generator=torch.Generator())
    head = EvidentialHead(maxdisp, generator=torch.Generator())
    return (_module_table(core, "AARMVSNetCore") + "\n\n"
            + _module_table(head, f"EvidentialHead(maxdisp={maxdisp})") + "\n")


def model_graph_dot(params: Mapping) -> str:
    """Graphviz DOT of the module hierarchy with per-module parameter
    counts, from a flax-path parameter tree (nested mappings of arrays:
    :func:`..models.convert.params_to_jax` of a state dict, or what
    :func:`..models.convert.read_orbax` reads); the JAX package's function,
    so the same weights give the same graph."""
    counts: dict[str, int] = {}
    edges: set[tuple[str, str]] = set()

    def visit(tree, path):
        if hasattr(tree, "items"):
            for key, sub in tree.items():
                child = f"{path}/{key}" if path else str(key)
                if path:
                    edges.add((path, child))
                visit(sub, child)
        else:
            n = int(np.prod(np.asarray(tree).shape))
            p = path
            while True:
                counts[p] = counts.get(p, 0) + n
                if "/" not in p:
                    break
                p = p.rsplit("/", 1)[0]

    visit(params, "")
    lines = ["digraph model {", "  rankdir=LR;", "  node [shape=box];"]
    for node, n in sorted(counts.items()):
        label = node.rsplit("/", 1)[-1]
        lines.append(f'  "{node}" [label="{label}\\n{n:,} params"];')
    for a, b in sorted(edges):
        lines.append(f'  "{a}" -> "{b}";')
    lines.append("}")
    return "\n".join(lines)
