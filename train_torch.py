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
``last``) work as in ``train.py``. ``visualization.enabled`` writes a GIF of
clip 0 of the batch (image, ground truth, prompts, the eval forward's
prediction) every ``visualization.train_every_n_steps`` steps to
``<run>/viz/stepNNNNNN.gif``.

Data parallelism (``parallel/dist.py``), as ``train.py``'s:
``data.batch_size`` is the global batch, raised to the device count when
it is smaller; each rank loads its ``batch_size // world`` share and the
gradients are averaged over the ranks every step.

- ``trainer.devices=N`` (without ``trainer.distributed``): this process
  starts N ranks on this host (``launch``), as Lightning DDP does: each
  rank on a card of its own under NCCL, or all on one card under gloo when
  there are fewer cards than ranks (gloo on the CPU too).
- ``torchrun --nproc_per_node N train_torch.py ...`` or
  ``trainer.distributed.enabled=true`` with torchrun's variables (or
  ``trainer.distributed.coordinator_address`` / ``num_processes`` /
  ``process_id``): this process is one rank of a job started elsewhere.

Rank 0 writes ``outputs/<date>/<time>/`` (metrics, checkpoints, the
post-fit eval); rank r > 0 logs to its ``proc<r>/`` below it. All ranks
meet at a barrier before they exit, after rank 0's eval.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

# data.batch_size < devices: train.py's warning
BATCH_RAISED = (
    "data.batch_size={} < devices={}: raising the global batch to {} (1 "
    "clip/device) so every device gets a shard. This changes the effective "
    "optimization (LR schedule, steps/epoch) vs the configured batch — set "
    "data.batch_size explicitly to silence this.")


def global_batch(cfg, world: int, distributed: bool, log) -> int:
    """The global batch (``data.batch_size``), raised to the device count
    (``trainer.devices``, the world size when distributed) with
    ``train.py``'s warning when smaller; raises unless the ``world``
    processes can share it evenly."""
    batch_size = int(cfg.data.get("batch_size", 1))
    num_devices = world if distributed else int(cfg.trainer.get("devices", 1))
    if num_devices > 1 and batch_size < num_devices:
        log.warning(BATCH_RAISED.format(batch_size, num_devices, num_devices))
        batch_size = num_devices
    if batch_size % world != 0:
        raise ValueError(f"global batch_size={batch_size} must be divisible "
                         f"by the process count {world}")
    return batch_size


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


def needs_launch(cfg) -> bool:
    """``trainer.devices > 1`` in a process that is not already a rank:
    this process starts the ranks."""
    from sam2_video_tpu_torch.parallel import dist as dist_mod

    enabled = bool((cfg.trainer.get("distributed") or {}).get("enabled"))
    return (int(cfg.trainer.get("devices", 1)) > 1 and not enabled
            and not dist_mod.env_launched())


def build_native(device_type: str) -> None:
    """Build the CUDA kernels (on a card) and the data pipeline's host
    helpers that are missing or stale, so that ranks started afterwards
    load them instead of each running the compilers."""
    from sam2_video_tpu_torch.data import host_build

    for name in host_build.SOURCES:
        host_build.build(name)
    if device_type == "cuda":
        from sam2_video_tpu_torch.ops import kernel_build

        kernel_build.build()


def run_dir_name() -> str:
    return time.strftime("%Y-%m-%d/%H-%M-%S")


def _rank_main(local_rank: int, world: int, port: int, argv: list,
               run_name: str, rank_fn) -> None:
    import os

    from sam2_video_tpu_torch.parallel import dist as dist_mod

    os.environ.update(dist_mod.rank_env(local_rank, world, port))
    rank_fn(argv, run_name)


def run_rank(argv: list, run_name: str) -> None:
    """A rank that ``launch`` started: train as ``run`` does."""
    run(argv, run_name=run_name)


def launch(argv, nprocs: int, rank_fn=run_rank, device_type: str = "cuda",
           run_name: str | None = None) -> Path:
    """Start ``nprocs`` ranks of this host (the spawn start method: CUDA
    forbids fork), meeting at localhost on a free port, each calling
    ``rank_fn(argv, run_name)`` with torchrun's variables set; wait for all.
    The kernels are built here first. A rank that fails ends the others and
    raises here. Returns rank 0's run directory."""
    import torch.multiprocessing as mp

    from sam2_video_tpu_torch.parallel import dist as dist_mod

    build_native(device_type)
    run_name = run_name or run_dir_name()
    mp.spawn(_rank_main, nprocs=nprocs, join=True,
             args=(nprocs, dist_mod.free_port(), list(argv), run_name,
                   rank_fn))
    return Path("outputs") / run_name


def make_viz_fn(cfg, mcfg, run_dir: Path, device):
    """``fit``'s visualization hook: the eval forward's ``high_res_masks``
    of clip 0 of the batch, composited with its frames, ground truth and
    prompts into ``<run_dir>/viz/step<N>.gif`` (``utils/viz.py``)."""
    import torch

    from sam2_video_tpu_torch.data.types import FIELDS, VideoClip
    from sam2_video_tpu_torch.models import sam2 as sam2_mod
    from sam2_video_tpu_torch.models.video_model import forward_train
    from sam2_video_tpu_torch.utils.viz import create_visualization_gif

    viz_dir = run_dir / "viz"
    viz_dir.mkdir(exist_ok=True)
    max_len = int(cfg.visualization.get("max_length", 4))
    stride = int(cfg.visualization.get("stride", 1))

    @torch.no_grad()
    def viz_fn(params, batch, step):
        clip0 = batch.clip(0)
        on_device = VideoClip(**{f: getattr(clip0, f).to(device)
                                 for f in FIELDS})
        _, per_cat = forward_train(sam2_mod.prepare(params, mcfg.sam2), mcfg,
                                   on_device, training=False)
        create_visualization_gif(
            clip0.images.numpy(), clip0.cat_masks.numpy(),
            per_cat["high_res_masks"].float().cpu().numpy(),
            point_coords=clip0.point_coords.numpy(),
            point_labels=clip0.point_labels.numpy(),
            max_length=max_len, stride=stride,
            path=viz_dir / f"step{step:06d}.gif")

    return viz_fn


def run(argv=None, step_timer: list | None = None,
        wait_timer: list | None = None, run_name: str | None = None):
    """Train as ``main`` does; returns (run directory, FitResult). With
    ``trainer.devices > 1`` outside a rank it starts the ranks
    (``launch``) and returns (rank 0's run directory, None). ``step_timer``
    and ``wait_timer`` get each train step's seconds and the seconds its
    batch was waited for (``fit``); ``run_name`` is the run directory under
    ``outputs/`` (the launcher's, for its ranks; rank 0's time by
    default)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    config_name = "config"
    overrides = []
    for a in argv:
        if a.startswith("config="):
            config_name = a.split("=", 1)[1]
        else:
            overrides.append(a)

    import torch

    from sam2_video_tpu_torch.config import load_config
    from sam2_video_tpu_torch.parallel import dist as dist_mod

    cfg = load_config(config_name, overrides)
    device_type = str(cfg.get("device") or "cuda")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=cpu to train on the "
                           "CPU")
    if needs_launch(cfg):
        return launch(argv, int(cfg.trainer.devices),
                      device_type=device_type), None

    owns_group = not torch.distributed.is_initialized()
    distributed = dist_mod.maybe_initialize_distributed(
        cfg.trainer.get("distributed"), device_type)
    try:
        return _train(cfg, device_type, distributed, step_timer, wait_timer,
                      run_name)
    finally:
        if distributed and owns_group:
            dist_mod.destroy()


def _train(cfg, device_type: str, distributed: bool, step_timer,
           wait_timer, run_name: str | None):
    """``run``'s body in one process (a rank when ``distributed``)."""
    import numpy as np
    import torch

    from sam2_video_tpu_torch.config import loss_config, model_config
    from sam2_video_tpu_torch.convert import to_param_tree
    from sam2_video_tpu_torch.data.coco import COCOIndex
    from sam2_video_tpu_torch.data.pipeline import (ClipDataset,
                                                    ClipDatasetConfig,
                                                    ClipLoader)
    from sam2_video_tpu_torch.parallel import dist as dist_mod
    from sam2_video_tpu_torch.training.checkpoint import Checkpointer
    from sam2_video_tpu_torch.training.loop import (TrainState, fit,
                                                    make_eval_step,
                                                    make_train_step)
    from sam2_video_tpu_torch.training.optimizer import make_optimizer
    from sam2_video_tpu_torch.utils.logging import (MetricsLogger,
                                                    setup_file_logging)
    from sam2_video_tpu_torch.utils.profiling import log_compile_time

    mcfg, lcfg = model_config(cfg), loss_config(cfg)
    rank, world = dist_mod.rank(), dist_mod.world_size()
    is_main = rank == 0
    group = torch.distributed.group.WORLD if distributed else None
    if distributed and dist_mod.local_layout()[0] == 0:
        build_native(device_type)       # once per host, before the ranks
    device = (dist_mod.rank_device(device_type) if distributed
              else torch.device(device_type))
    if distributed:
        dist_mod.barrier()
        run_name = dist_mod.broadcast_object(run_name or run_dir_name())
    run_dir = Path("outputs") / (run_name or run_dir_name())
    if not is_main:
        run_dir = run_dir / f"proc{rank}"
    run_dir.mkdir(parents=True, exist_ok=True)
    log = setup_file_logging(run_dir, cfg.get("log_level", "INFO"))
    logger = MetricsLogger(run_dir, project=cfg.wandb.get("project"),
                           name=cfg.wandb.get("name"),
                           config=dict(cfg)) if is_main else None
    log.info(f"run dir: {run_dir}, device {device}")
    if distributed:
        log.info(f"distributed: rank {rank}/{world}, backend "
                 f"{torch.distributed.get_backend()}, device {device}")

    seed = int(cfg.get("seed", 42))
    np.random.seed(seed)

    # ---- data -------------------------------------------------------------
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
    # each rank loads ONLY its share of the global batch
    local_batch = global_batch(cfg, world, distributed, log) // world
    num_workers = int(cfg.data.get("num_workers", 2))
    cache_mb = float(cfg.data.get("frame_cache_mb", 0) or 0)
    num_cats = int(cfg.data.get("num_categories") or 0) or None
    image_size = int(cfg.data.image_size)
    train_ds = ClipDataset(COCOIndex(cfg.data.train_path, image_size,
                                     num_cats, frame_cache_mb=cache_mb), dcfg)
    val_ds = ClipDataset(COCOIndex(cfg.data.val_path, image_size, num_cats,
                                   frame_cache_mb=cache_mb), dcfg)
    shard = dict(seed=seed, num_workers=num_workers, process_index=rank,
                 process_count=world)
    train_loader = ClipLoader(train_ds, batch_size=local_batch, shuffle=True,
                              **shard)
    val_loader = ClipLoader(val_ds, batch_size=local_batch, shuffle=False,
                            **shard)
    log.info(f"train clips: {len(train_ds)}, val clips: {len(val_ds)}")

    # ---- model ------------------------------------------------------------
    params = to_param_tree(load_params(cfg, mcfg.sam2, seed, log)).to(device)

    # ---- optimizer / steps ------------------------------------------------
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
    train_step = log_compile_time(
        make_train_step(mcfg, lcfg, tx, trainable_modules=trainable,
                        device=device, group=group), log, "train step")
    eval_step = make_eval_step(mcfg, lcfg, device=device, group=group)

    checkpointer = None
    if bool(cfg.trainer.get("enable_checkpointing", True)) and is_main:
        checkpointer = Checkpointer(
            run_dir / "checkpoints",
            save_top_k=int(cfg.trainer.get("save_top_k", 3)))

    # resume from a previous run's checkpoint dir (params+opt state+step);
    # every rank restores it
    resume_path = cfg.trainer.get("resume_from")
    if resume_path:
        restored = Checkpointer(Path(resume_path)).restore(device=device)
        state = TrainState(params=restored["params"],
                           opt_state=restored["opt_state"],
                           step=restored["step"])
        log.info(f"resumed from {resume_path} at step {state.step}")
    if distributed:
        dist_mod.broadcast_params(dict(state.params.named_parameters()))

    viz_fn, viz_every = None, 0
    if bool(cfg.visualization.get("enabled", False)):
        viz_fn = make_viz_fn(cfg, mcfg, run_dir, device)
        viz_every = int(cfg.visualization.get("train_every_n_steps", 0))

    result = fit(
        state, train_step, eval_step, train_loader, val_loader,
        max_epochs=max_epochs, limit_train_batches=limit_train,
        limit_val_batches=cfg.trainer.get("limit_val_batches"),
        log_every=int(cfg.trainer.get("log_every_n_steps", 20)),
        logger=logger, checkpointer=checkpointer,
        val_check_interval=float(cfg.trainer.get("val_check_interval")
                                 or 1.0),
        step_timer=step_timer, wait_timer=wait_timer, viz_fn=viz_fn,
        viz_every_n_steps=viz_every, group=group)
    log.info(f"training done; best val loss {result.best_val:.4f}")

    # ---- post-fit inference + eval, from the best checkpoint, rank 0 -----
    if is_main:
        logger.summary({"best_val_loss": result.best_val})
        if bool(cfg.eval.get("enabled", True)):
            best = result.state.params
            if checkpointer is not None and checkpointer.best_path is not None:
                best = checkpointer.restore(device=device)["params"]
                log.info(f"reloaded best checkpoint {checkpointer.best_path}")
            post_fit_eval(cfg, mcfg.sam2, run_dir, best, seed, device,
                          logger, log)
        logger.close()
    if distributed:
        # every rank waits here for rank 0's eval (dist.TIMEOUT)
        dist_mod.barrier()
    return run_dir, result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
