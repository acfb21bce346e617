"""Threshold search with the PyTorch/CUDA port (the counterpart of
``grid_search_threshold.py``): run the inference of a fixed checkpoint with
the probability maps dumped, grid-search the binarization threshold on
them (``eval/tune_threshold.py``), export the predictions at the best
threshold (``eval/export_predict_from_probs.py``) and evaluate them.

    python grid_search_threshold_torch.py checkpoint=<params.npz>
        [data=endovis18] [eval.prompt_type=points] [min=0.2] [max=0.8]
        [step=0.05] [device=cpu]

Writes ``outputs/<date>/<time>-thr/`` with ``eval/probs/``,
``best_threshold.json`` and the evaluation at the best threshold. The
inference runs on the card unless ``device=cpu`` is given.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides, kw = [], {}
    for a in argv:
        k, _, v = a.partition("=")
        if k in ("checkpoint", "min", "max", "step", "config"):
            kw[k] = v
        else:
            overrides.append(a)

    from baseline_eval_torch import device_of, load_weights
    from sam2_video_tpu_torch.config import load_config, model_config
    from sam2_video_tpu_torch.eval.export_predict_from_probs import \
        export_predict
    from sam2_video_tpu_torch.eval.inference import inference
    from sam2_video_tpu_torch.eval.metrics import evaluate
    from sam2_video_tpu_torch.eval.tune_threshold import grid_search

    cfg = load_config(kw.get("config", "config"), overrides)
    sam2_cfg = model_config(cfg).sam2
    device = device_of(cfg)
    params = load_weights(cfg, sam2_cfg, kw.get("checkpoint"))

    run_dir = Path("outputs") / time.strftime("%Y-%m-%d/%H-%M-%S-thr")
    run_dir.mkdir(parents=True, exist_ok=True)
    inference(
        params, sam2_cfg, cfg.eval.coco_path, run_dir,
        prompt_type=cfg.eval.get("prompt_type", "points"),
        clip_length=cfg.eval.get("clip_length"),
        variable_cats=bool(cfg.eval.get("variable_cats", False)),
        num_points=int(cfg.eval.get("num_points", 1)),
        num_neg_points=int(cfg.eval.get("num_neg_points", 0)),
        include_center=bool(cfg.eval.get("include_center", True)),
        probs_out_dir="probs",
        max_objects=int(cfg.model.get("max_objects", 8)),
        image_root=cfg.data.get("image_root"), device=device)

    probs_dir = run_dir / "eval" / "probs"
    best_thr, best_dice, curve = grid_search(
        probs_dir, cfg.eval.coco_path,
        float(kw.get("min", 0.2)), float(kw.get("max", 0.8)),
        float(kw.get("step", 0.05)))
    (run_dir / "best_threshold.json").write_text(json.dumps({
        "best_threshold": best_thr, "best_dice": best_dice,
        "threshold_curve": curve}, indent=2))
    predict_path = export_predict(probs_dir, best_thr)
    result = evaluate(predict_path, cfg.eval.coco_path, run_dir)
    print(f"best threshold {best_thr:.3f}; dice at best "
          f"{result['avg_scores']['dice']:.4f} -> {run_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
