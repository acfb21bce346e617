"""Hyperparameter sweeps over W&B-style sweep YAMLs with the PyTorch/CUDA
port (the counterpart of ``sweep.py``): grid enumeration or random search
locally, results in JSONL, or a hand-off to ``wandb agent`` when the
package is available. Each run is ``python <program> <overrides>``, where
``program`` is ``--program``, else the sweep YAML's own ``program:`` with
the JAX package's ``train.py`` (which the repository's ``sweeps/*.yaml``
name) read as the port's ``train_torch.py``, else ``train_torch.py``.

The YAML format is the reference's (``method`` grid | bayes | random,
``parameters.<dotted.key>.values`` lists, ``+combo`` group selection); the
workers (``--workers``) run that many runs at once, as the reference's
multi_gpu_train.sh runs one agent per device: on a host with cards, the
run in worker slot i sees card i mod (number of cards) alone
(``CUDA_VISIBLE_DEVICES``, ``parallel/dist.py`` ``card_env``).

    python sweep_torch.py sweeps/loss_sweep.yaml [--workers 1] [--max-runs N]
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import queue
import random
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import yaml

PROGRAM = "train_torch.py"


def expand_grid(parameters: dict):
    keys, value_lists = [], []
    for key, spec in parameters.items():
        if "values" in spec:
            keys.append(key)
            value_lists.append(spec["values"])
        elif "value" in spec:
            keys.append(key)
            value_lists.append([spec["value"]])
    for combo in itertools.product(*value_lists):
        yield dict(zip(keys, combo))


def sample_random(parameters: dict, rng: random.Random):
    out = {}
    for key, spec in parameters.items():
        if "values" in spec:
            out[key] = rng.choice(spec["values"])
        elif "value" in spec:
            out[key] = spec["value"]
        elif "min" in spec and "max" in spec:
            lo, hi = float(spec["min"]), float(spec["max"])
            if spec.get("distribution", "").startswith("log"):
                out[key] = math.exp(rng.uniform(math.log(lo), math.log(hi)))
            else:
                out[key] = rng.uniform(lo, hi)
    return out


def to_overrides(assignment: dict) -> list[str]:
    """'+combo' style keys select config groups; others are dotted."""
    return [f"{k.lstrip('+')}={v}" for k, v in assignment.items()]


def assignments_of(spec: dict, max_runs: int | None, seed: int) -> list:
    """The runs of a sweep: the grid, or ``max_runs`` (20 by default)
    random draws for bayes / random; at most ``max_runs``."""
    params = spec.get("parameters", {})
    if spec.get("method", "grid") == "grid":
        runs = list(expand_grid(params))
    else:  # bayes/random -> random search locally
        rng = random.Random(seed)
        runs = [sample_random(params, rng) for _ in range(max_runs or 20)]
    return runs[:max_runs] if max_runs else runs


def program_of(spec: dict, override: str | None) -> str:
    """The script of each run: ``override``, else the YAML's ``program:``
    (its JAX CLI mapped to the port's), else ``PROGRAM``."""
    if override:
        return override
    program = spec.get("program", PROGRAM)
    return PROGRAM if program == "train.py" else program


def run_one(program: str, overrides: list[str], log_path: Path,
            env_extra: dict | None = None) -> int:
    cmd = [sys.executable, program] + overrides
    env = {**os.environ, **(env_extra or {})}
    with open(log_path, "w") as f:
        f.write(f"# {' '.join(cmd)}\n")
        f.flush()
        return subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                              env=env).returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sweep_yaml")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--max-runs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--use-wandb-agent", action="store_true")
    ap.add_argument("--program", default=None,
                    help="the script of each run, in place of the YAML's")
    args = ap.parse_args(argv)

    spec = yaml.safe_load(Path(args.sweep_yaml).read_text())
    if args.use_wandb_agent:
        try:
            import wandb  # noqa: F401
            subprocess.run(["wandb", "sweep", args.sweep_yaml], check=True)
            return 0
        except ImportError:
            print("wandb unavailable; falling back to local sweep")

    from sam2_video_tpu_torch.parallel.dist import card_env

    program = program_of(spec, args.program)
    assignments = assignments_of(spec, args.max_runs, args.seed)

    sweep_dir = Path("outputs") / "sweeps" / time.strftime("%Y%m%d-%H%M%S")
    sweep_dir.mkdir(parents=True, exist_ok=True)
    (sweep_dir / "sweep.yaml").write_text(yaml.safe_dump(spec))
    results_path = sweep_dir / "runs.jsonl"
    print(f"{len(assignments)} runs -> {sweep_dir}")

    # worker slots: a run takes a free one and gives it back; no more runs
    # than slots are in flight, so one is always free
    slots = queue.SimpleQueue()
    for s in range(args.workers):
        slots.put(s)

    def launch(i_assignment):
        i, assignment = i_assignment
        overrides = to_overrides(assignment)
        slot = slots.get()
        try:
            env = card_env(slot)
            rc = run_one(program, overrides, sweep_dir / f"run{i:03d}.log",
                         env)
        finally:
            slots.put(slot)
        rec = {"run": i, "overrides": overrides, "returncode": rc,
               "slot": slot, **env}
        with open(results_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"run {i}: rc={rc} {overrides}")
        return rc

    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        rcs = list(pool.map(launch, enumerate(assignments)))
    return max(rcs) if rcs else 0


if __name__ == "__main__":
    sys.exit(main())
