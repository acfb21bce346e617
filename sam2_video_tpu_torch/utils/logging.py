"""Metrics logging (counterpart of ``sam2_video_tpu/utils/logging.py``):
a local JSONL file always, and wandb only when it imports."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

LOGGER_NAME = "sam2_video_tpu_torch"


class MetricsLogger:
    def __init__(self, run_dir: str | Path, project: str = "sam2-video-tpu",
                 name: str | None = None, config: dict | None = None,
                 use_wandb: bool = True):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.run_dir / "metrics.jsonl"
        self._fh = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(project=project, name=name,
                                         config=config or {},
                                         dir=str(self.run_dir))
            except Exception:
                self._wandb = None
        if config is not None:
            (self.run_dir / "config.json").write_text(
                json.dumps(config, indent=1, default=str))

    def log(self, record: dict):
        record = {"_time": time.time(), **record}
        self._fh.write(json.dumps(record, default=float) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(record)

    def summary(self, record: dict):
        path = self.run_dir / "summary.json"
        existing = json.loads(path.read_text()) if path.exists() else {}
        existing.update(record)
        path.write_text(json.dumps(existing, indent=1, default=float))
        if self._wandb is not None:
            for k, v in record.items():
                self._wandb.summary[k] = v

    def close(self):
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()


def setup_file_logging(run_dir: str | Path, level: str = "INFO"):
    """stderr plus a rotating ``training.log`` in ``run_dir``. A second
    call points the file handler at the new run directory."""
    import logging
    from logging.handlers import RotatingFileHandler

    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    root = logging.getLogger(LOGGER_NAME)
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.propagate = False
    fmt = logging.Formatter(
        "%(asctime)s | %(levelname)s | %(name)s - %(message)s")
    for h in list(root.handlers):
        if isinstance(h, RotatingFileHandler):
            root.removeHandler(h)
            h.close()
    if not root.handlers:
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        root.addHandler(sh)
    fh = RotatingFileHandler(run_dir / "training.log", maxBytes=10_000_000,
                             backupCount=10)
    fh.setFormatter(fmt)
    root.addHandler(fh)
    return root
