"""The config engine (counterpart of ``sam2_video_tpu/config.py``): YAML
composition, dotted overrides and interpolation, with the reference's
layout and knob names, and the typed model and loss configs built from
the resolved tree. It supports:

- ``defaults`` lists (``- data: cholecseg8k``, ``- config``, ``- _self_``);
- config groups under ``configs/<group>/<option>.yaml``; a file headed by
  ``# @package _global_`` merges at the root (the loss overlays);
- overrides on the command line: dotted (``optimizer.lr=1e-5``) and group
  selections (``data=endovis17``, ``loss=focal_main``);
- ``${a.b}`` interpolation after merging.

``configs/`` holds copies of the JAX package's YAML files (``config``,
``best``, ``overfit``, ``memory_overfit``, ``eval_pipeline_test``,
``data/*``, ``losses/*``, the ``combo/<dataset>/<n>`` selections of
``combo=...``), byte for byte but one comment line of ``config.yaml``
that named the reference by a path on another machine.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any

import yaml

CONFIG_DIR = Path(__file__).resolve().parent / "configs"

_GLOBAL_PACKAGE_RE = re.compile(r"^\s*#\s*@package\s+_global_")


class Config(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def get_path(self, path: str, default=None):
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, path: str, value):
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value


def _deep_merge(base: dict, overlay: dict) -> dict:
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _read_yaml(path: Path) -> tuple[dict, bool]:
    text = path.read_text()
    is_global = bool(_GLOBAL_PACKAGE_RE.match(
        text.splitlines()[0] if text else ""))
    return yaml.safe_load(text) or {}, is_global


def _load_tree(name: str, config_dir: Path) -> dict:
    """configs/<name>.yaml with its defaults list resolved recursively."""
    data, _ = _read_yaml(config_dir / f"{name}.yaml")
    defaults = data.pop("defaults", None)
    if defaults is None:
        return data
    merged: dict = {}
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            merged = _deep_merge(merged, data)
            self_merged = True
        elif isinstance(entry, str):
            merged = _deep_merge(merged, _load_tree(entry, config_dir))
        elif isinstance(entry, dict):
            for group, option in entry.items():
                merged = _deep_merge(
                    merged, _load_group(group, str(option), config_dir))
    if not self_merged:
        merged = _deep_merge(merged, data)
    return merged


def _load_group(group: str, option: str, config_dir: Path) -> dict:
    data, is_global = _read_yaml(config_dir / group / f"{option}.yaml")
    defaults = data.pop("defaults", None)
    merged: dict = {}
    # a group file may pull another group's option in: "- /data/<name>@data"
    for entry in defaults or []:
        if isinstance(entry, str) and "@" in entry:
            src, _, dst = entry.partition("@")
            g, opt = src.strip("/").split("/", 1)
            sub, _ = _read_yaml(config_dir / g / f"{opt}.yaml")
            sub.pop("defaults", None)
            merged = _deep_merge(merged, {dst: sub})
    merged = _deep_merge(merged, data)
    return merged if is_global else {group: merged}


_INTERP_RE = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")
_INTERP_PART_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _resolve_interpolations(tree: dict) -> Config:
    root = Config.wrap(tree)

    def resolve(v, depth=0):
        if depth > 10:
            return v
        if isinstance(v, str):
            m = _INTERP_RE.match(v)
            if m:
                return resolve(root.get_path(m.group(1)), depth + 1)
            return _INTERP_PART_RE.sub(
                lambda mm: str(resolve(root.get_path(mm.group(1)), depth + 1)),
                v)
        return v

    def walk(node):
        if isinstance(node, dict):
            return Config({k: walk(v) for k, v in node.items()})
        if isinstance(node, list):
            return [walk(v) for v in node]
        return resolve(node)

    return walk(root)


def _parse_value(s: str):
    try:
        v = yaml.safe_load(s)
    except yaml.YAMLError:
        return s
    if isinstance(v, str):
        # YAML 1.1 reads '5e-5' as a string: take bare scientific notation
        # as a float, as Hydra does
        try:
            return float(v)
        except ValueError:
            return v
    return v


def load_config(name: str = "config", overrides: list[str] | None = None,
                config_dir: str | Path | None = None) -> Config:
    config_dir = Path(config_dir) if config_dir else CONFIG_DIR
    tree = _load_tree(name, config_dir)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, _, val = ov.partition("=")
        key = key.strip()
        # `loss=focal_main` selects an overlay under configs/losses/
        group_name = {"loss": "losses"}.get(key, key)
        if "." not in key and (config_dir / group_name).is_dir():
            tree = _deep_merge(tree, _load_group(group_name, val.strip(),
                                                 config_dir))
        else:
            cfg = Config.wrap(tree)
            cfg.set_path(key, _parse_value(val.strip()))
            tree = cfg
    return _resolve_interpolations(tree)


# ---------------------------------------------------------------------------
# Typed configs
# ---------------------------------------------------------------------------


def model_config(cfg: Config):
    """The port's ``VideoModelConfig`` (with its ``SAM2Config``) from the
    same keys as the JAX package's ``model_config``."""
    from .models.sam2 import SAM2Config
    from .models.video_model import VideoModelConfig

    m = cfg.model
    sam2 = SAM2Config(
        backbone=m.get("backbone", "tiny"),
        image_size=int(cfg.data.image_size),
        use_activation_checkpoint=bool(m.get("use_activation_checkpoint",
                                             False)),
        remat_mode=str(m.get("remat_mode", "") or ""),
        compute_dtype=m.get("compute_dtype", "bfloat16"),
        detach_memory_bank=bool(m.get("detach_memory_bank", True)),
        num_maskmem=int(m.get("num_maskmem", 7)),
        memory_temporal_stride_for_eval=int(
            m.get("memory_temporal_stride_for_eval", 1)),
        use_flash_attention=bool(m.get("use_flash_attention", True)),
        scan_unroll=int(m.get("scan_unroll", 0)),
    )
    return VideoModelConfig(sam2=sam2, prompt_type=m.get("prompt_type",
                                                         "point"))


def loss_config(cfg: Config):
    """The port's ``LossConfig`` from the same keys as the JAX package's."""
    from .training.losses import LossConfig

    lc = cfg.loss
    wd = {k: float(v) for k, v in lc.get("weight_dict", {}).items()}
    pw = lc.get("bce_pos_weight", None)
    return LossConfig(
        type=str(lc.get("type", "multi_step")),
        gt_stride=int(lc.get("gt_stride", 1)),
        weight_dict=wd or LossConfig().weight_dict,
        supervise_all_iou=bool(lc.get("supervise_all_iou", True)),
        iou_use_l1_loss=bool(lc.get("iou_use_l1_loss", True)),
        pred_obj_scores=bool(lc.get("pred_obj_scores", False)),
        focal_gamma_obj_score=float(lc.get("focal_gamma_obj_score", 0.0)),
        focal_alpha_obj_score=float(lc.get("focal_alpha_obj_score", -1.0)),
        multistep_logit_temperature=float(
            lc.get("multistep_logit_temperature", 1.0)),
        bce_logit_temperature=float(lc.get("bce_logit_temperature", 1.0)),
        bce_pos_weight=tuple(pw) if pw else None,
        bce_reduction=str(lc.get("bce_reduction", "mean")),
    )
