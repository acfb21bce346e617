"""Weight bridge to and from the JAX package's parameter trees.

``from_jax_params`` is the inverse of the JAX converter's layout transform
(``sam2_video_tpu/training/convert.py`` ``_layout_transform``): the flat
names stay, conv kernels go HWIO -> OIHW, transposed-conv kernels
HWIO -> IOHW, and the Hiera pos-embeds NHWC -> NCHW. ``to_jax_params`` goes
back. ``load_npz`` reads the single-file dumps written by the JAX package's
``save_params_npz`` (and by ``training/checkpoint.py``'s). Derived entries
that are not parameters (memory attention's ``_qp``/``_kp``) are not
carried.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .ops.common import ParamTree

def flatten(tree, prefix: str = "") -> dict:
    """Nested dict -> {dotted path: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + str(k)] = v
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def _is_derived(name: str) -> bool:
    return any(part.startswith("_") for part in name.split("."))


def _to_torch_layout(name: str, a: np.ndarray) -> np.ndarray:
    """Layout of one leaf, decided by its path (also for subtrees)."""
    parts = name.split(".")
    if a.ndim != 4 or parts[-1] == "maskmem_tpos_enc":  # [M, 1, 1, mem_dim]
        return a
    if parts[-1] in ("pos_embed", "pos_embed_window"):
        return a.transpose(0, 3, 1, 2)        # NHWC -> NCHW
    if "output_upscaling" in parts:
        return a.transpose(2, 3, 0, 1)        # deconv HWIO -> IOHW
    return a.transpose(3, 2, 0, 1)            # conv HWIO -> OIHW


def _to_jax_layout(name: str, a: np.ndarray) -> np.ndarray:
    """The inverse of ``_to_torch_layout``."""
    parts = name.split(".")
    if a.ndim != 4 or parts[-1] == "maskmem_tpos_enc":
        return a
    if parts[-1] in ("pos_embed", "pos_embed_window"):
        return a.transpose(0, 2, 3, 1)        # NCHW -> NHWC
    if "output_upscaling" in parts:
        return a.transpose(2, 3, 0, 1)        # deconv IOHW -> HWIO
    return a.transpose(2, 3, 1, 0)            # conv OIHW -> HWIO


def to_jax_params(params) -> dict:
    """A ParamTree or flat ``state_dict`` -> flat {JAX path: float32 numpy
    array in JAX layout}, the form the JAX package's ``save_params_npz``
    writes."""
    if isinstance(params, ParamTree):
        params = dict(params.named_parameters())
    return {name: np.ascontiguousarray(_to_jax_layout(
                name, t.detach().float().cpu().numpy()))
            for name, t in params.items() if not _is_derived(name)}


def from_jax_params(tree) -> dict:
    """Nested JAX parameter tree (numpy or jax leaves) -> flat float32
    ``state_dict`` in torch layout, keyed by the flattened JAX paths."""
    sd = {}
    for name, leaf in flatten(tree).items():
        if _is_derived(name):
            continue
        a = np.asarray(leaf, dtype=np.float32)
        sd[name] = torch.tensor(_to_torch_layout(name, a))
    return sd


def load_npz(path: str | Path) -> dict:
    """``save_params_npz`` file -> flat torch ``state_dict``."""
    with np.load(path) as data:
        return from_jax_params(unflatten({k: data[k] for k in data.files}))


def to_param_tree(params) -> ParamTree:
    """Accept a ParamTree, a flat ``state_dict`` (dotted names, torch
    layout) or a nested JAX tree, and return a ParamTree."""
    if isinstance(params, ParamTree):
        return params
    if any(isinstance(v, dict) for v in params.values()):
        params = from_jax_params(params)
    return ParamTree(unflatten(dict(params)))
