"""The reference's single-clip convergence check (tests/test_overfit.py) on
the port: train memory attention, memory encoder, mask decoder and prompt
encoder with mask prompts and the bce loss, AdamW lr 1e-3 without weight
decay or schedule, for 150 steps on one T=2 clip, then read the tracked
frame's Dice in the eval forward. Run from the repository root:

    python3 -m sam2_video_tpu_torch.overfit_check [--device cuda|cpu]
        [--size 384] [--dtype bfloat16] [--seed 0] [--obj-score-bias 10]
        [--repeat 1] [--deterministic]

The clip is that test's (``tests/test_training.py make_batch`` at 64 px)
with its geometry scaled to ``--size``. The weights are the port's seeded
init with the object-score head's last bias set to ``--obj-score-bias``
(``none`` leaves the init's). The recipe has no objectness loss: the head
gets no gradient, and only the sign of its output is read, so the bias
changes nothing until a score would cross zero; there it keeps the object
present, where a negative score would pin the mask logits at -1024 for
good (bce 41.00002). ``--repeat`` trains that many times from the same
weights and says whether the losses repeat bit for bit;
``--deterministic`` turns on ``torch.use_deterministic_algorithms`` and
prints the error of the first operation that has no deterministic
version. ``chip_smoke.py`` runs ``overfit_run`` as its last check.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from unittest import mock

import numpy as np
import torch

from .data.types import FIELDS, VideoClipBatch
from .models import mask_decoder
from .models import sam2 as sam2_mod
from .models.video_model import VideoModelConfig, forward_train
from .training.loop import TrainState, make_train_step
from .training.losses import LossConfig
from .training.optimizer import make_optimizer

STEPS, LR, DICE = 150, 1e-3, 0.9
TRAINABLE = ["memory_attention", "memory_encoder", "mask_decoder",
             "prompt_encoder"]


def reference_clip(seed: int, size: int = 64) -> dict:
    """The clip of tests/test_overfit.py (``tests/test_training.py``
    ``make_batch`` at ``tiny_cfg``'s 64 px, T=2), its geometry scaled by
    size / 64: normal images, categories 0 and 1 as the squares
    [8:24, 8:24] and [36:56, 36:56] on both frames, two objects, a third
    category empty. numpy arrays with a batch axis."""
    rng = np.random.default_rng(seed)
    s = size // 64
    images = rng.standard_normal((1, 2, size, size, 3)).astype(np.float32)
    cat_masks = np.zeros((1, 2, 3, size, size), bool)
    cat_masks[:, :, 0, 8 * s:24 * s, 8 * s:24 * s] = True
    cat_masks[:, :, 1, 36 * s:56 * s, 36 * s:56 * s] = True
    obj_masks = np.zeros((1, 2, size, size), np.float32)
    obj_masks[:, 0] = cat_masks[0, 0, 0]
    obj_masks[:, 1] = cat_masks[0, 0, 1]
    return dict(images=images, cat_masks=cat_masks, obj_masks=obj_masks,
                obj_to_cat=np.asarray([[0, 1]], np.int32),
                point_coords=np.asarray([[[[16 * s, 16 * s]],
                                          [[45 * s, 45 * s]]]], np.float32),
                point_labels=np.ones((1, 2, 1), np.int32))


def overfit_run(seed: int, device: str, size: int, dtype: str,
                obj_score_bias: float | None) -> dict:
    """STEPS steps of the recipe on ``reference_clip(seed, size)``. Returns
    the losses, the tracked frame's Dice by category in the eval forward
    (``training=False``, which the test reads) and in the forward the steps
    train (``training=True``), and the stability scores of the eval
    forward's single-mask outputs per decoder call and object (below 0.98
    the decoder takes the best multimask token's output instead)."""
    sample = reference_clip(seed, size)
    batch = VideoClipBatch(**{k: torch.from_numpy(sample[k])
                              for k in FIELDS}).to(device)
    cfg = sam2_mod.SAM2Config(image_size=size, compute_dtype=dtype,
                              use_activation_checkpoint=False)
    params = sam2_mod.init(cfg, seed=seed)
    if obj_score_bias is not None:
        with torch.no_grad():
            params["sam_mask_decoder"]["pred_obj_score_head"]["layers"][
                "2"]["bias"].fill_(obj_score_bias)
    params = params.to(device)
    tx = make_optimizer(params, {"lr": LR, "type": "AdamW",
                                 "weight_decay": 0.0},
                        {"enabled": False}, total_steps=STEPS,
                        trainable_modules=TRAINABLE, gradient_clip_val=1.0)
    mcfg = VideoModelConfig(sam2=cfg, prompt_type="mask")
    step = make_train_step(mcfg, LossConfig(type="bce"), tx,
                           trainable_modules=TRAINABLE, device=device)
    state = TrainState.create(params, tx)
    t0 = time.perf_counter()
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(m["total_loss"])
    losses = [float(x) for x in losses]
    secs = time.perf_counter() - t0
    gt = sample["cat_masks"][0, 1:]
    dice, stability = {}, []
    plain_scores = mask_decoder._stability_scores

    def scores(c, logits):
        out = plain_scores(c, logits)
        stability.append([round(float(x), 4) for x in out.flatten()])
        return out

    for training in (False, True):
        with torch.no_grad(), mock.patch.object(
                mask_decoder, "_stability_scores", scores):
            _, per_cat = forward_train(
                sam2_mod.prepare(state.params, cfg), mcfg, batch.clip(0),
                training=training)
        pred = (per_cat["high_res_masks"][1:, :, 0] > 0).cpu().numpy()
        dice[training] = {c: float(
            2 * (pred[:, c] & gt[:, c]).sum()
            / max(pred[:, c].sum() + gt[:, c].sum(), 1))
            for c in range(gt.shape[1]) if gt[:, c].any()}
    return {"losses": losses, "secs": secs, "dice": dice[False],
            "dice_trained_forward": dice[True], "stability": stability}


def converged(r: dict) -> bool:
    """tests/test_overfit.py's criteria: finite losses, the last below 0.1
    of the first and below the first three, and the eval forward's Dice
    above DICE for every category the clip holds."""
    losses = r["losses"]
    return bool(np.isfinite(losses).all() and losses[-1] < 0.1 * losses[0]
                and losses[-1] < min(losses[:3])
                and all(d > DICE for d in r["dice"].values()))


def summary(r: dict) -> str:
    losses = r["losses"]
    return (f"({STEPS} steps, {r['secs']:.1f} s): loss every 10 steps "
            + ", ".join(f"{x:.5g}" for x in losses[::10])
            + f", last {losses[-1]:.5g}; tracked-frame Dice by category "
            + json.dumps(r["dice"]) + " (the trained forward: "
            + json.dumps(r["dice_trained_forward"]) + "); the eval "
            "forward's single-mask stability per decoder call "
            + json.dumps(r["stability"]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=384)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obj-score-bias", default="10")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args()
    bias = (None if args.obj_score_bias == "none"
            else float(args.obj_score_bias))
    if args.deterministic:
        # cuBLAS is deterministic only with a fixed workspace
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    runs = []
    for i in range(args.repeat):
        try:
            r = overfit_run(args.seed, args.device, args.size, args.dtype,
                            bias)
        except RuntimeError as e:
            print(f"run {i}: {e}", flush=True)
            return 1
        runs.append(r)
        print(f"run {i} at {args.size} px, {args.dtype}, seed {args.seed}, "
              f"object-score bias {args.obj_score_bias}: {summary(r)} "
              + ("PASS" if converged(r) else "did not converge"),
              flush=True)
    if len(runs) > 1:
        first = np.asarray(runs[0]["losses"])
        for i, r in enumerate(runs[1:], 1):
            diff = np.flatnonzero(np.asarray(r["losses"]) != first)
            print(f"run {i} against run 0: losses "
                  + (f"first differ at step {diff[0] + 1}" if diff.size
                     else "equal bit for bit"), flush=True)
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(card.stdout.strip() or torch.cuda.get_device_name(0),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
