"""Baseline deltas (the port's copy of the root ``baseline_utils.py``,
which imports nothing of the JAX package but lives outside the port):
the frozen zero-shot metrics of the current dataset and memory combo,
``baseline_results/<dataset>/<n>_mem/metrics.json`` at the repository
root, and the current metrics' differences from them (reference
baseline_utils.py:13-75).
"""

from __future__ import annotations

import json
from pathlib import Path

# the directory of the root baseline_utils.py: baseline_results/ at the
# repository root
BASELINE_ROOT = Path(__file__).resolve().parents[2] / "baseline_results"


def parse_combo_name(combo_name: str):
    """'<dataset>/<n>_mem[_sfx]' or '<n>_mem' -> (dataset, n)."""
    parts = str(combo_name).split("/")
    name = parts[-1]
    dataset = parts[-2] if len(parts) > 1 else None
    num = name.split("_")[0]
    return dataset, num


def baseline_metrics_path(dataset: str, combo_num: str) -> Path:
    return BASELINE_ROOT / dataset / f"{combo_num}_mem" / "metrics.json"


def load_baseline_metrics(dataset: str, combo_num: str):
    path = baseline_metrics_path(dataset, combo_num)
    if not path.exists():
        return None
    return json.loads(path.read_text())


def compute_baseline_deltas(cfg, avg_scores: dict) -> dict:
    """Diff current avg scores against the frozen baseline, if present.
    Returns {} when no baseline is recorded (keeps train.py flowing)."""
    dataset = None
    try:
        dataset = cfg.data.name
    except Exception:
        pass
    combo = None
    try:
        combo = cfg.get("combo_name")
    except Exception:
        pass
    if combo:
        ds, num = parse_combo_name(combo)
        dataset = ds or dataset
    else:
        num = "1"
    if dataset is None:
        return {}
    baseline = load_baseline_metrics(dataset, num)
    if baseline is None:
        return {}
    base_avg = baseline.get("avg_scores", baseline)
    out = {}
    for k in ("dice", "iou", "mae"):
        if k in base_avg and k in avg_scores:
            out[f"baseline_delta/{k}"] = float(avg_scores[k]) - float(
                base_avg[k])
            out[f"baseline/{k}"] = float(base_avg[k])
    return out


def save_baseline_metrics(dataset: str, combo_num: str, avg_scores: dict,
                          cat_scores: dict | None = None):
    path = baseline_metrics_path(dataset, combo_num)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"avg_scores": avg_scores}
    if cat_scores is not None:
        payload["cat_scores"] = cat_scores
    path.write_text(json.dumps(payload, indent=2))
    return path
