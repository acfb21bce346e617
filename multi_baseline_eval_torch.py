"""Parallel baseline evaluation with the PyTorch/CUDA port (the counterpart
of ``multi_baseline_eval.py``): the combos split into shards, one worker
process per shard running ``baseline_eval_torch.py`` on its shard. On a
host with cards, worker i sees card i mod (number of cards) alone
(``CUDA_VISIBLE_DEVICES``), as the reference pins one GPU per worker.

    python multi_baseline_eval_torch.py [--workers 2] [--out-dir D]
        [--combos endovis18/1 ...] [--checkpoint ckpt.npz]
        [--override device=cpu ...]

Exits with the largest of the workers' exit codes.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent


def run_shard(combo_file: Path, out_dir: str, env_extra: dict,
              extra_args: list) -> int:
    env = dict(os.environ)
    env.update(env_extra)
    cmd = [sys.executable, str(HERE / "baseline_eval_torch.py"),
           "--combo-file", str(combo_file), "--out-dir", out_dir,
           *extra_args]
    return subprocess.run(cmd, env=env).returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--out-dir", default="baseline_results")
    ap.add_argument("--combos", nargs="*", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--override", nargs="*", default=[])
    args = ap.parse_args(argv)

    from baseline_eval_torch import discover_combos
    from sam2_video_tpu_torch.parallel.dist import card_env
    combos = args.combos or discover_combos()
    shards = [s for s in (combos[i::args.workers]
                          for i in range(args.workers)) if s]
    tmp = Path(".combo_shards")
    tmp.mkdir(exist_ok=True)
    files = []
    for i, shard in enumerate(shards):
        p = tmp / f"shard{i}.txt"
        p.write_text("\n".join(shard))
        files.append(p)
    extra = (["--checkpoint", args.checkpoint] if args.checkpoint else [])
    if args.override:
        extra += ["--override", *args.override]

    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        futs = [pool.submit(run_shard, f, args.out_dir, card_env(i), extra)
                for i, f in enumerate(files)]
        return max(f.result() for f in futs)


if __name__ == "__main__":
    sys.exit(main())
