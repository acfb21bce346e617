"""Checkpoints (counterpart of ``sam2_video_tpu/training/checkpoint.py``):
the parameters, the whole optimizer state and the step, saved with
``torch.save``, keeping the best ``save_top_k`` by a metric plus ``last``
(the reference's ModelCheckpoint). Each checkpoint is a directory
(``last/``, ``step00000042/``) holding ``state.pt``; ``index.json`` lists
the kept ones, best first.

The npz files are the interchange with the JAX package, both ways: JAX
names and JAX layouts (``convert.py`` ``to_jax_params`` /
``from_jax_params``), so ``save_params_npz`` here writes a file the JAX
package's ``load_params_npz`` reads, and ``load_params_npz`` reads the
JAX package's files.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from ..convert import load_npz, to_jax_params, to_param_tree
from .optimizer import OptState

STATE_FILE = "state.pt"


def save_params_npz(params, path: str | Path) -> None:
    """A ParamTree or flat ``state_dict`` -> one npz of JAX names and
    layouts."""
    np.savez(path, **to_jax_params(params))


def load_params_npz(path: str | Path) -> dict:
    """An npz of JAX names and layouts -> flat ``state_dict`` (torch
    layout)."""
    return load_npz(path)


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def state_dict_of(state) -> dict:
    """A TrainState as plain containers of CPU tensors and ints."""
    opt = state.opt_state
    return {"params": _cpu(dict(state.params.named_parameters())),
            "opt_state": {f.name: _cpu(getattr(opt, f.name))
                          for f in dataclasses.fields(opt)},
            "step": int(state.step)}


class Checkpointer:
    """Top-k by metric plus ``last``."""

    def __init__(self, directory: str | Path, save_top_k: int = 3,
                 mode: str = "min"):
        self.dir = Path(directory).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.save_top_k = save_top_k
        self.mode = mode
        self._records: list[dict] = []
        self._index_path = self.dir / "index.json"
        if self._index_path.exists():
            self._records = json.loads(self._index_path.read_text())

    def _save_tree(self, path: Path, payload: dict):
        tmp = path.with_name(path.name + ".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        torch.save(payload, tmp / STATE_FILE)
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)

    def save(self, state, metric: float | None = None, epoch: int = 0):
        payload = state_dict_of(state)
        step = payload["step"]
        self._save_tree(self.dir / "last", payload)
        if metric is None:
            return
        name = f"step{step:08d}"
        self._save_tree(self.dir / name, payload)
        self._records.append({"name": name, "metric": float(metric),
                              "step": step, "epoch": epoch})
        sign = 1 if self.mode == "min" else -1
        self._records.sort(key=lambda r: sign * r["metric"])
        while len(self._records) > self.save_top_k:
            drop = self._records.pop()
            p = self.dir / drop["name"]
            if p.exists():
                shutil.rmtree(p)
        self._index_path.write_text(json.dumps(self._records, indent=1))

    @property
    def best_path(self) -> Path | None:
        if not self._records:
            return None
        return self.dir / self._records[0]["name"]

    def restore(self, path: str | Path | None = None,
                device: str | torch.device = "cpu") -> dict:
        """{"params": ParamTree, "opt_state": OptState, "step": int} of the
        checkpoint at ``path`` (the best, else ``last``, by default), its
        tensors on ``device``."""
        path = Path(path) if path else (self.best_path or self.dir / "last")
        raw = torch.load(path / STATE_FILE, map_location="cpu",
                         weights_only=True)
        params = to_param_tree(raw["params"]).to(device)
        opt_state = OptState(**_to(raw["opt_state"], device))
        return {"params": params, "opt_state": opt_state,
                "step": int(raw["step"])}
