"""PyTorch SAM2 checkpoints into the port's parameters (counterpart of
``sam2_video_tpu/training/convert.py``). The port's parameter names are
the checkpoint's and its layouts are torch's, so a tensor loads as it is
when its name and shape match the template; the JAX package's layout
transforms have nothing to do here.

Also handled as there: a state dict stored under a ``model`` (Meta's
releases) or ``state_dict`` key, a leading ``model.`` prefix (Lightning),
and fine-tuned partial loads (``load_finetuned``): an npz of JAX names and
layouts, a path containing "all" (the full state dict, non-strict), or a
mask-decoder state dict with an optional ``*_prompt_encoder.torch``
companion.

Checkpoint files are read with ``torch.load(weights_only=True)``: tensors
and plain containers, no other pickled objects.

As a command, it writes a checkpoint as the npz that the JAX package's
converter writes (JAX names and layouts, ``training/checkpoint.py``
``save_params_npz``), which both packages' loaders read:

    python -m sam2_video_tpu_torch.training.convert <ckpt.pt> <out.npz>
        [--backbone {tiny,small,base_plus,large}] [--image-size 384]
        [--no-strict]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..convert import load_npz
from ..ops.common import ParamTree
from .checkpoint import save_params_npz


def _load_torch_state_dict(path: str | Path) -> dict:
    """{name: numpy array} of a torch checkpoint file."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj and isinstance(
            obj["model"], dict):
        obj = obj["model"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    out = {}
    for k, v in obj.items():
        if k.startswith("model."):
            k = k[len("model."):]
        out[k] = (v.detach().cpu().numpy() if hasattr(v, "detach")
                  else np.asarray(v))
    return out


def _flat(params) -> dict:
    if isinstance(params, ParamTree):
        return dict(params.named_parameters())
    return dict(params)


def convert_state_dict(state_dict: dict, template_params,
                       strict: bool = False):
    """(flat ``state_dict`` of the template's names, report): each tensor
    of ``state_dict`` whose name and shape the template has, in the
    template's dtype; the template's own tensor elsewhere. The report
    lists matched, missing, unexpected and mismatched names; ``strict``
    raises when any of the last three is not empty."""
    template = _flat(template_params)
    out = {k: v.detach().clone() for k, v in template.items()}
    matched, mismatched, unexpected = [], [], []
    for name, src in state_dict.items():
        if name not in template:
            unexpected.append(name)
            continue
        dst = template[name]
        src = torch.as_tensor(np.asarray(src))
        if tuple(src.shape) != tuple(dst.shape):
            mismatched.append((name, tuple(src.shape), tuple(dst.shape)))
            continue
        out[name] = src.to(dst.dtype).clone()
        matched.append(name)
    missing = sorted(set(template) - set(matched))
    report = {"matched": matched, "missing": missing,
              "unexpected": sorted(unexpected), "mismatched": mismatched}
    if strict and (missing or unexpected or mismatched):
        raise ValueError(
            f"strict conversion failed: {len(missing)} missing, "
            f"{len(unexpected)} unexpected, {len(mismatched)} mismatched\n"
            f"missing[:10]={missing[:10]}\nunexpected[:10]="
            f"{report['unexpected'][:10]}\nmismatched[:10]={mismatched[:10]}")
    return out, report


def convert_checkpoint(ckpt_path: str | Path, backbone: str = "tiny",
                       image_size: int = 384, strict: bool = True,
                       template_params=None):
    """A full SAM2 torch checkpoint against the port's init (or
    ``template_params``) -> (flat state_dict, report)."""
    from ..models import sam2 as sam2_mod

    if template_params is None:
        template_params = sam2_mod.init(sam2_mod.SAM2Config(
            backbone=backbone, image_size=image_size))
    return convert_state_dict(_load_torch_state_dict(ckpt_path),
                              template_params, strict=strict)


def load_finetuned(params, finetuned_path: str | Path) -> dict:
    """``params`` with fine-tuned weights grafted on, as a flat state_dict:
    an npz (JAX names and layouts) updates the names it holds; a path
    containing "all" loads a full state dict non-strictly; otherwise a
    mask-decoder state dict, with its ``*_prompt_encoder.torch``
    companion when that exists, must load without unexpected or
    mismatched names."""
    finetuned_path = str(finetuned_path)
    flat = {k: v.detach().clone() for k, v in _flat(params).items()}
    if finetuned_path.endswith(".npz"):
        flat.update({k: v for k, v in load_npz(finetuned_path).items()
                     if k in flat})
        return flat
    if "all" in Path(finetuned_path).name or "all" in finetuned_path:
        converted, _ = convert_state_dict(
            _load_torch_state_dict(finetuned_path), flat, strict=False)
        return converted
    sd = {f"sam_mask_decoder.{k}": v
          for k, v in _load_torch_state_dict(finetuned_path).items()}
    pe_path = finetuned_path.replace(".torch", "_prompt_encoder.torch")
    if Path(pe_path).exists():
        sd.update({f"sam_prompt_encoder.{k}": v
                   for k, v in _load_torch_state_dict(pe_path).items()})
    converted, report = convert_state_dict(sd, flat, strict=False)
    if report["unexpected"] or report["mismatched"]:
        raise ValueError(f"finetuned load failed: {report['unexpected'][:5]} "
                         f"{report['mismatched'][:5]}")
    return converted


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt")
    ap.add_argument("out")
    ap.add_argument("--backbone", default="tiny",
                    choices=["tiny", "small", "base_plus", "large"])
    ap.add_argument("--image-size", type=int, default=384)
    ap.add_argument("--no-strict", action="store_true")
    args = ap.parse_args(argv)
    params, report = convert_checkpoint(
        args.ckpt, args.backbone, args.image_size, strict=not args.no_strict)
    save_params_npz(params, args.out)
    print(f"converted {len(report['matched'])} tensors "
          f"({len(report['missing'])} missing, "
          f"{len(report['unexpected'])} unexpected) -> {args.out}")


if __name__ == "__main__":
    main()
