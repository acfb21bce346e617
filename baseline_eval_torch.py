"""Batch baseline evaluation over combo configs with the PyTorch/CUDA port
(the counterpart of ``baseline_eval.py``): discover the combo configs of
``sam2_video_tpu_torch/configs/combo/``, load each combo with its data
config, load the weights (``--checkpoint``, else the combo's
``model.checkpoint_path``, else the port's seeded init) and any fine-tuned
weights, run the inference and the evaluation, and write each combo's
``metrics.json`` and a summary CSV.

    python baseline_eval_torch.py [--combos endovis18/1 endovis18/4 ...]
        [--combo-file list.txt] [--checkpoint ckpt.npz]
        [--out-dir baseline_results] [--override device=cpu ...]

The inference runs on the card (``cuda``) unless an override gives
``device=cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path

COMBO_DIR = (Path(__file__).resolve().parent
             / "sam2_video_tpu_torch/configs/combo")


def load_weights(cfg, sam2_cfg, checkpoint: str | None):
    """The weights to evaluate: ``checkpoint`` or the config's
    ``model.checkpoint_path`` (an npz of JAX names and layouts, or a torch
    SAM2 checkpoint, converted), else the port's init from seed 0."""
    from sam2_video_tpu_torch.models import sam2 as sam2_mod
    from sam2_video_tpu_torch.training import convert as convert_mod
    from sam2_video_tpu_torch.training.checkpoint import load_params_npz

    ckpt = checkpoint or cfg.model.get("checkpoint_path")
    if ckpt and str(ckpt).endswith(".npz"):
        return load_params_npz(ckpt)
    if ckpt and Path(str(ckpt)).exists():
        params, _ = convert_mod.convert_checkpoint(
            ckpt, backbone=cfg.model.get("backbone", "tiny"),
            image_size=sam2_cfg.image_size, strict=False,
            template_params=sam2_mod.init(sam2_cfg, seed=0))
        return params
    return sam2_mod.init(sam2_cfg, seed=0).state_dict()


def device_of(cfg):
    """The config's ``device`` (``cuda`` by default); raises without a card
    unless it is ``cpu``."""
    import torch

    device = torch.device(str(cfg.get("device") or "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=cpu to run on the CPU")
    return device


def run_combo(combo: str, checkpoint: str | None, out_root: Path,
              overrides: list[str]) -> dict:
    from sam2_video_tpu_torch.config import load_config, model_config
    from sam2_video_tpu_torch.eval.inference import inference
    from sam2_video_tpu_torch.eval.metrics import evaluate
    from sam2_video_tpu_torch.training import convert as convert_mod

    cfg = load_config("config", [f"combo={combo}"] + list(overrides))
    sam2_cfg = model_config(cfg).sam2
    device = device_of(cfg)
    params = load_weights(cfg, sam2_cfg, checkpoint)
    if cfg.model.get("fintuned_model_path"):
        params = convert_mod.load_finetuned(params,
                                            cfg.model.fintuned_model_path)

    run_dir = out_root / combo.replace("/", "_")
    run_dir.mkdir(parents=True, exist_ok=True)
    predict_path, _ = inference(
        params, sam2_cfg, cfg.eval.coco_path, run_dir,
        prompt_type=cfg.eval.get("prompt_type", "points"),
        clip_length=cfg.eval.get("clip_length"),
        variable_cats=bool(cfg.eval.get("variable_cats", False)),
        num_points=int(cfg.eval.get("num_points", 1)),
        num_neg_points=int(cfg.eval.get("num_neg_points", 0)),
        include_center=bool(cfg.eval.get("include_center", True)),
        max_objects=int(cfg.model.get("max_objects", 8)),
        image_root=cfg.data.get("image_root"), device=device)
    result = evaluate(predict_path, cfg.eval.coco_path, run_dir)
    metrics = {"combo": combo, "name": cfg.get("combo", {}).get("name"),
               "avg_scores": result["avg_scores"],
               "cat_scores": {str(k): v
                              for k, v in result["cat_scores"].items()}}
    (run_dir / "metrics.json").write_text(json.dumps(metrics, indent=2,
                                                     default=float))
    return metrics


def discover_combos() -> list[str]:
    return sorted(f"{p.parent.name}/{p.stem}"
                  for p in COMBO_DIR.glob("*/*.yaml"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--combos", nargs="*", default=None)
    ap.add_argument("--combo-file", default=None,
                    help="text file with one combo per line")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out-dir", default="baseline_results")
    ap.add_argument("--override", nargs="*", default=[])
    args = ap.parse_args(argv)

    combos = args.combos
    if args.combo_file:
        combos = [line.strip() for line in Path(args.combo_file).read_text()
                  .splitlines() if line.strip() and not line.startswith("#")]
    if combos is None:
        combos = discover_combos()

    out_root = Path(args.out_dir)
    rows = []
    for combo in combos:
        print(f"=== {combo}")
        try:
            metrics = run_combo(combo, args.checkpoint, out_root,
                                args.override)
            rows.append(metrics)
            a = metrics["avg_scores"]
            print(f"    dice={a['dice']:.4f} iou={a['iou']:.4f} "
                  f"mae={a['mae']:.4f}")
        except Exception as e:  # keep the batch going like the reference
            traceback.print_exc()
            print(f"    FAILED: {type(e).__name__}: {e}", file=sys.stderr)

    if rows:
        import csv
        with open(out_root / "summary.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["combo", "name", "dice", "iou", "mae"])
            for r in rows:
                a = r["avg_scores"]
                w.writerow([r["combo"], r["name"], a["dice"], a["iou"],
                            a["mae"]])
        print(f"summary -> {out_root / 'summary.csv'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
