"""IoU / Dice / MAE evaluation with image -> video -> global nanmean
aggregation (counterpart of ``sam2_video_tpu/eval/metrics.py``, reference
eval.py:16-277): instance masks OR-merged per image and category, IoU and
Dice with 1e-7 added to the denominator, MAE over the binary maps;
category averages per image, nanmeans up through videos to the global
result; ``eval.pkl`` with the nested structure, and ``eval.json``.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path

import numpy as np

from ..data import rle as rle_mod


def calculate_iou(pred, gt):
    inter = np.logical_and(pred, gt).sum()
    union = np.logical_or(pred, gt).sum() + 1e-7
    return inter / union


def calculate_dice(pred, gt):
    inter = np.sum(pred * gt)
    return (2.0 * inter) / (np.sum(pred) + np.sum(gt) + 1e-7)


def calculate_mae(y_true, y_pred):
    return np.mean(np.abs(np.asarray(y_true, np.float64) -
                          np.asarray(y_pred, np.float64)))


def _merge_cat_masks(anns, hw):
    if not anns:
        return None
    m = np.zeros(hw, bool)
    for ann in anns:
        m |= rle_mod.decode(ann["segmentation"]).astype(bool)
    return m.astype(np.uint8)


def _nanmean(vals):
    vals = [v for v in vals]
    if not vals:
        return float("nan")
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return float(np.nanmean(np.asarray(vals, np.float64)))


def get_image_scores(gt_images, gt_anns_by_image, dt_anns_by_image, cat_ids):
    video_id_set = set()
    img_scores = []
    for img in gt_images:
        if img.get("is_det_keyframe", True) is False:
            continue
        hw = (img["height"], img["width"])
        anns_dt = dt_anns_by_image.get(img["id"], [])
        anns_gt = gt_anns_by_image.get(img["id"], [])
        img_score = {
            "video_id": img["video_id"],
            "order_in_video": img.get("order_in_video", 0),
            "cat_scores": {c: {"iou": np.nan, "mae": np.nan, "dice": np.nan}
                           for c in cat_ids},
            "avg_scores": {},
        }
        per_cat = {}
        for c in cat_ids:
            cdt = [a for a in anns_dt if a["category_id"] == c]
            cgt = [a for a in anns_gt if a["category_id"] == c]
            if not cdt and not cgt:
                continue
            mdt = _merge_cat_masks(cdt, hw)
            mgt = _merge_cat_masks(cgt, hw)
            if mdt is None:
                mdt = np.zeros_like(mgt)
            if mgt is None:
                mgt = np.zeros_like(mdt)
            per_cat[c] = {"iou": calculate_iou(mdt, mgt),
                          "mae": calculate_mae(mdt, mgt),
                          "dice": calculate_dice(mdt, mgt)}
            img_score["cat_scores"][c] = per_cat[c]
        for k in ("iou", "mae", "dice"):
            img_score["avg_scores"][k] = _nanmean(
                [img_score["cat_scores"][c][k] for c in cat_ids])
        video_id_set.add(img["video_id"])
        img_scores.append(img_score)
    return video_id_set, img_scores


def _aggregate(children, cat_ids):
    """nanmean each category over children's cat_scores, then nanmean cats."""
    out = {"cat_scores": {}, "avg_scores": {}}
    for c in cat_ids:
        out["cat_scores"][c] = {
            k: _nanmean([ch["cat_scores"][c][k] for ch in children])
            for k in ("iou", "mae", "dice")}
    for k in ("iou", "mae", "dice"):
        out["avg_scores"][k] = _nanmean(
            [out["cat_scores"][c][k] for c in cat_ids])
    return out


def get_video_scores(video_id_set, img_scores, cat_ids):
    video_scores = []
    for video_id in video_id_set:
        frames = [s for s in img_scores if s["video_id"] == video_id]
        v = _aggregate(frames, cat_ids)
        v["video_id"] = video_id
        v["frames"] = frames
        video_scores.append(v)
    return video_scores


def get_result(video_scores, cat_ids):
    result = _aggregate(video_scores, cat_ids)
    result["videos"] = video_scores
    return result


def evaluate(predict_path, coco_path, output_path,
             remove_background: bool = False) -> dict:
    """eval() parity (:261-277): writes <output_path>/eval.pkl (+ .json) and
    returns the result dict."""
    gt = json.loads(Path(coco_path).read_text())
    dt = json.loads(Path(predict_path).read_text())
    if isinstance(dt, dict):
        dt = dt.get("annotations", [])
    cat_ids = sorted(c["id"] for c in gt["categories"])
    if remove_background and 0 in cat_ids:
        cat_ids.remove(0)

    gt_anns, dt_anns = {}, {}
    for a in gt["annotations"]:
        gt_anns.setdefault(a["image_id"], []).append(a)
    for a in dt:
        dt_anns.setdefault(a["image_id"], []).append(a)

    video_ids, img_scores = get_image_scores(gt["images"], gt_anns, dt_anns,
                                             cat_ids)
    video_scores = get_video_scores(video_ids, img_scores, cat_ids)
    result = get_result(video_scores, cat_ids)

    out = Path(output_path)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "eval.pkl", "wb") as f:
        pickle.dump(result, f)
    summary = {"avg_scores": result["avg_scores"],
               "cat_scores": {str(c): result["cat_scores"][c]
                              for c in cat_ids}}
    (out / "eval.json").write_text(json.dumps(summary, indent=2,
                                              default=float))
    return result
