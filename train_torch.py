"""Training entry point of the PyTorch/CUDA port (the counterpart of
``train.py``):

    python train_torch.py [config=best] [data=endovis17] [loss=focal_main] \\
        [optimizer.lr=1e-5] [trainer.max_epochs=3] [device=cpu] ...

The same config tree and overrides as ``train.py``, plus a top-level
``device=`` (``cuda`` by default; ``device=cpu`` trains on the CPU through
the kernels' plain versions). Flow: resolve the config, build the
datasets, load or initialise the weights, then fit (training and
validation, top-k and last checkpoints, JSONL metrics) in
``outputs/<date>/<time>/``, which holds ``training.log``,
``metrics.jsonl``, ``config.json``, ``summary.json`` and ``checkpoints/``.
With ``eval.enabled`` (the default) the best checkpoint then runs the
post-fit inference over ``eval.coco_path`` (reverse and forward
propagation of every clip) and the evaluation: ``eval/predict.json``,
``eval/prompt.pkl``, ``eval/eval.pkl`` and ``eval/metrics.json`` (Dice,
IoU and MAE, with baseline deltas where a baseline is recorded).

Weights: ``model.checkpoint_path`` names an ``.npz`` (JAX names and
layouts) or a torch SAM2 checkpoint (converted); without one the port's
seeded init is used, with a warning. ``model.fintuned_model_path``,
``model.random_init_memory_modules`` and ``trainer.resume_from`` (a run's
``checkpoints/`` directory, restored from its best checkpoint, else
``last``) work as in ``train.py``. A knob whose code is not ported raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

NOT_PORTED = "is not ported yet: see ROADMAP.md, queue 1, item {}"


def check_ported(cfg) -> None:
    """Raise for every enabled knob whose code the port lacks."""
    if bool(cfg.visualization.get("enabled", False)):
        raise NotImplementedError(
            "visualization.enabled=true (utils/viz.py) "
            + NOT_PORTED.format(9) + "; pass visualization.enabled=false")
    dist = cfg.trainer.get("distributed") or {}
    if int(cfg.trainer.get("devices", 1)) > 1 or bool(
            dist.get("enabled", False)):
        raise NotImplementedError(
            "data-parallel training (trainer.devices > 1 or "
            "trainer.distributed.enabled) " + NOT_PORTED.format(8))


def load_params(cfg, sam2_cfg, seed: int, log):
    """The run's starting weights as a flat state_dict on the CPU."""
    from sam2_video_tpu_torch.models import sam2 as sam2_mod
    from sam2_video_tpu_torch.training import convert as convert_mod
    from sam2_video_tpu_torch.training.checkpoint import load_params_npz

    ckpt_path = cfg.model.get("checkpoint_path")
    if ckpt_path and str(ckpt_path).endswith(".npz"):
        params = load_params_npz(ckpt_path)
        log.info(f"loaded converted checkpoint {ckpt_path}")
    elif ckpt_path and Path(str(ckpt_path)).exists():
        params, report = convert_mod.convert_checkpoint(
            ckpt_path, backbone=cfg.model.get("backbone", "tiny"),
            image_size=sam2_cfg.image_size, strict=False,
            template_params=sam2_mod.init(sam2_cfg, seed=seed))
        log.info(f"converted torch checkpoint {ckpt_path}: "
                 f"{len(report['matched'])} tensors")
    else:
        params = sam2_mod.init(sam2_cfg, seed=seed).state_dict()
        log.warning("no pretrained checkpoint: training from the seeded "
                    "random init")
    if cfg.model.get("fintuned_model_path"):
        params = convert_mod.load_finetuned(params,
                                            cfg.model.fintuned_model_path)
        log.info(f"grafted finetuned weights {cfg.model.fintuned_model_path}")
    if cfg.model.get("random_init_memory_modules"):
        fresh = sam2_mod.init(sam2_cfg, seed=seed + 1).state_dict()
        params = dict(params)
        for k, v in fresh.items():
            if k.startswith(("memory_attention.", "memory_encoder.")):
                params[k] = v
        log.info("random-initialised memory modules")
    return params


def inference_kwargs(cfg, seed: int) -> dict:
    """The keyword arguments of ``eval/inference.py inference`` that
    train.py's post-fit eval takes from the config."""
    return dict(
        prompt_type=cfg.eval.get("prompt_type", "points"),
        clip_length=cfg.eval.get("clip_length"),
        variable_cats=bool(cfg.eval.get("variable_cats", False)),
        num_points=int(cfg.eval.get("num_points", 1)),
        num_neg_points=int(cfg.eval.get("num_neg_points", 0)),
        include_center=bool(cfg.eval.get("include_center", True)),
        noised_prompt=bool(cfg.eval.get("noised_prompt", False)),
        noise_intensity=float(cfg.eval.get("noise_intensity", 0.1)),
        bbox_noise_type=cfg.eval.get("bbox_noise_type", "shift_scale"),
        grid_spacing=cfg.eval.get("grid_spacing"),
        probs_out_dir=cfg.eval.get("probs_out_dir"),
        max_objects=int(cfg.model.get("max_objects", 8)),
        image_root=cfg.data.get("image_root"), seed=seed,
        batch_videos=int(cfg.eval.get("batch_videos", 1)))


def post_fit_eval(cfg, sam2_cfg, run_dir: Path, params, seed: int,
                  device, logger, log) -> dict:
    """train.py's post-fit inference and evaluation with ``params``:
    ``inference`` over ``eval.coco_path`` with every ``eval.*`` knob,
    ``evaluate``, the eval/* summary (per category under
    ``eval.log_per_category``) with the baseline deltas, and
    ``eval/metrics.json``. Returns the summary."""
    import json

    from sam2_video_tpu_torch.eval.baseline import compute_baseline_deltas
    from sam2_video_tpu_torch.eval.inference import inference
    from sam2_video_tpu_torch.eval.metrics import evaluate

    predict_path, _ = inference(params, sam2_cfg, cfg.eval.coco_path,
                                run_dir, device=device,
                                **inference_kwargs(cfg, seed))
    eval_result = evaluate(predict_path, cfg.eval.coco_path,
                           run_dir / "eval")
    avg = eval_result["avg_scores"]
    log.info(f"eval: dice={avg['dice']:.4f} iou={avg['iou']:.4f} "
             f"mae={avg['mae']:.4f}")
    summary = {f"eval/{k}": v for k, v in avg.items()}
    if bool(cfg.eval.get("log_per_category", False)):
        for c, sc in eval_result["cat_scores"].items():
            summary.update({f"eval/cat{c}/{k}": v for k, v in sc.items()})
    summary.update(compute_baseline_deltas(cfg, avg))
    logger.summary(summary)
    (run_dir / "eval" / "metrics.json").write_text(
        json.dumps({**summary, "avg_scores": avg,
                    "name": cfg.get("combo", {}).get("name")},
                   indent=2, default=float))
    return summary


def run(argv=None, step_timer: list | None = None,
        wait_timer: list | None = None):
    """Train as ``main`` does; returns (run directory, FitResult).
    ``step_timer`` and ``wait_timer`` get each train step's seconds and
    the seconds its batch was waited for (``fit``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    config_name = "config"
    overrides = []
    for a in argv:
        if a.startswith("config="):
            config_name = a.split("=", 1)[1]
        else:
            overrides.append(a)

    import numpy as np
    import torch

    from sam2_video_tpu_torch.config import (load_config, loss_config,
                                             model_config)
    from sam2_video_tpu_torch.convert import to_param_tree
    from sam2_video_tpu_torch.data.coco import COCOIndex
    from sam2_video_tpu_torch.data.pipeline import (ClipDataset,
                                                    ClipDatasetConfig,
                                                    ClipLoader)
    from sam2_video_tpu_torch.training.checkpoint import Checkpointer
    from sam2_video_tpu_torch.training.loop import (TrainState, fit,
                                                    make_eval_step,
                                                    make_train_step)
    from sam2_video_tpu_torch.training.optimizer import make_optimizer
    from sam2_video_tpu_torch.utils.logging import (MetricsLogger,
                                                    setup_file_logging)

    cfg = load_config(config_name, overrides)
    check_ported(cfg)
    device = torch.device(str(cfg.get("device") or "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=cpu to train on the "
                           "CPU")

    run_dir = Path("outputs") / time.strftime("%Y-%m-%d/%H-%M-%S")
    run_dir.mkdir(parents=True, exist_ok=True)
    log = setup_file_logging(run_dir, cfg.get("log_level", "INFO"))
    logger = MetricsLogger(run_dir, project=cfg.wandb.get("project"),
                           name=cfg.wandb.get("name"), config=dict(cfg))
    log.info(f"run dir: {run_dir}, device {device}")

    seed = int(cfg.get("seed", 42))
    np.random.seed(seed)

    # ---- data -------------------------------------------------------------
    mcfg = model_config(cfg)
    dcfg = ClipDatasetConfig(
        clip_length=int(cfg.data.video_clip_length),
        stride=int(cfg.data.stride),
        prompt_type=cfg.model.prompt_type,
        max_objects=int(cfg.model.get("max_objects", 8)),
        num_pos_points=int(cfg.model.get("num_pos_points", 1)),
        num_neg_points=int(cfg.model.get("num_neg_points", 0)),
        include_center=bool(cfg.model.get("include_center", True)),
        image_root=cfg.data.get("image_root"),
        uint8_images=bool(cfg.data.get("uint8_images", True)))
    batch_size = int(cfg.data.get("batch_size", 1))
    num_workers = int(cfg.data.get("num_workers", 2))
    cache_mb = float(cfg.data.get("frame_cache_mb", 0) or 0)
    num_cats = int(cfg.data.get("num_categories") or 0) or None
    image_size = int(cfg.data.image_size)
    train_ds = ClipDataset(COCOIndex(cfg.data.train_path, image_size,
                                     num_cats, frame_cache_mb=cache_mb), dcfg)
    val_ds = ClipDataset(COCOIndex(cfg.data.val_path, image_size, num_cats,
                                   frame_cache_mb=cache_mb), dcfg)
    train_loader = ClipLoader(train_ds, batch_size=batch_size, shuffle=True,
                              seed=seed, num_workers=num_workers)
    val_loader = ClipLoader(val_ds, batch_size=batch_size, shuffle=False,
                            seed=seed, num_workers=num_workers)
    log.info(f"train clips: {len(train_ds)}, val clips: {len(val_ds)}")

    # ---- model ------------------------------------------------------------
    params = to_param_tree(load_params(cfg, mcfg.sam2, seed, log)).to(device)

    # ---- optimizer / steps ------------------------------------------------
    lcfg = loss_config(cfg)
    trainable = list(cfg.model.get("trainable_modules", []))
    max_epochs = int(cfg.trainer.get("max_epochs", 1))
    limit_train = cfg.trainer.get("limit_train_batches")
    steps_per_epoch = (min(len(train_loader), limit_train)
                       if limit_train else len(train_loader))
    accum = int(cfg.trainer.get("accumulate_grad_batches", 1))
    total_steps = max(1, max_epochs * steps_per_epoch // accum)
    tx = make_optimizer(
        params, cfg.optimizer, cfg.scheduler, total_steps,
        trainable_modules=trainable,
        gradient_clip_val=float(cfg.trainer.get("gradient_clip_val", 1.0)),
        accumulate_grad_batches=accum)
    state = TrainState.create(params, tx)
    train_step = make_train_step(mcfg, lcfg, tx, trainable_modules=trainable,
                                 device=device)
    eval_step = make_eval_step(mcfg, lcfg, device=device)

    checkpointer = None
    if bool(cfg.trainer.get("enable_checkpointing", True)):
        checkpointer = Checkpointer(
            run_dir / "checkpoints",
            save_top_k=int(cfg.trainer.get("save_top_k", 3)))

    # resume from a previous run's checkpoint dir (params+opt state+step)
    resume_path = cfg.trainer.get("resume_from")
    if resume_path:
        restored = Checkpointer(Path(resume_path)).restore(device=device)
        state = TrainState(params=restored["params"],
                           opt_state=restored["opt_state"],
                           step=restored["step"])
        log.info(f"resumed from {resume_path} at step {state.step}")

    result = fit(
        state, train_step, eval_step, train_loader, val_loader,
        max_epochs=max_epochs, limit_train_batches=limit_train,
        limit_val_batches=cfg.trainer.get("limit_val_batches"),
        log_every=int(cfg.trainer.get("log_every_n_steps", 20)),
        logger=logger, checkpointer=checkpointer,
        val_check_interval=float(cfg.trainer.get("val_check_interval")
                                 or 1.0),
        step_timer=step_timer, wait_timer=wait_timer)
    log.info(f"training done; best val loss {result.best_val:.4f}")
    logger.summary({"best_val_loss": result.best_val})

    # ---- post-fit inference + eval, from the best checkpoint ------------
    if bool(cfg.eval.get("enabled", True)):
        best = result.state.params
        if checkpointer is not None and checkpointer.best_path is not None:
            best = checkpointer.restore(device=device)["params"]
            log.info(f"reloaded best checkpoint {checkpointer.best_path}")
        post_fit_eval(cfg, mcfg.sam2, run_dir, best, seed, device, logger,
                      log)
    logger.close()
    return run_dir, result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
