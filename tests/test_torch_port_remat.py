"""The rematerialised frame loop of the PyTorch port
(``models/video_model.py``, ``models/sam2.py`` ``remat``) held against the
JAX package on the CPU, in float32:

- one all-trainable train step (``[memory_attention, memory_encoder,
  mask_decoder, prompt_encoder, image_encoder]``, SAM2-tiny at 128 px, T=4,
  O=2, C=2, B=1, point prompts, AdamW at lr 1e-4) of the port with remat
  "body" (each tracked frame under one checkpoint), "modules" (the
  decoder, memory encoder and memory attention checkpointed one by one)
  and ``stacked_frame_grads`` (per-frame parameter views), each against
  JAX ``make_train_step`` at remat "body" (its ``lax.scan`` over the
  fixed-shape ring, the invalid slots masked): the losses and the
  gradient of every trainable leaf. The three modes compute the same
  function, in JAX as in the port, so the JAX step is compiled once for
  the file (``jax_body_step``); compiling it takes most of a case's time;
- the port's "body_dots" (a selective checkpoint that keeps the products)
  and remat "none" with ``scan_unroll=2`` (which changes nothing in the
  port) against its "body": the same operations on the same values, so
  loss and gradients equal bit for bit;
- ``SAM2Config()``'s defaults (``use_activation_checkpoint=True``, which
  resolves to "body", bf16, the kernels' path) train;
- ``train_torch.py`` with ``model.use_activation_checkpoint=true``: one
  step on the CPU whose logged losses equal those of the same run without
  it, bit for bit (the checkpoint recomputes the same operations).

Tolerances, as tests/test_torch_port_train_all.py states them: values
1e-4 and gradients 2e-4 of max(1, max|JAX|) of each tensor, and the trunk's
q-pool flips (at most 1% of a leaf outside, within 2e-2 relative L2). At
T=4 frame 3 attends a tracked memory and pointer beside the conditioning
frame's; under JAX's "body" two of its six ring slots are masked, which
the port's valid prefix leaves out (a masked key adds an exact zero).
"""

import dataclasses
import json

import jax
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _example_clip
from sam2_video_tpu.data.synthetic import make_synthetic_dataset
from sam2_video_tpu.models import sam2 as jsam2
from sam2_video_tpu.models.video_model import \
    VideoModelConfig as JVideoModelConfig
from sam2_video_tpu.training import loop as jloop
from sam2_video_tpu.training import optimizer as jopt
from sam2_video_tpu.training.losses import LossConfig as JLossConfig
from sam2_video_tpu_torch.convert import to_param_tree
from sam2_video_tpu_torch.data.synthetic import example_clip
from sam2_video_tpu_torch.models import sam2 as tsam2
from sam2_video_tpu_torch.models.video_model import VideoModelConfig
from sam2_video_tpu_torch.training import loop as tloop
from sam2_video_tpu_torch.training import optimizer as topt
from sam2_video_tpu_torch.training.losses import LossConfig
from test_torch_port_models import jax_tree
from test_torch_port_train import FAST_COMPILE
from test_torch_port_train_all import GRAD, VAL, _close

IMG, T_STEP, LR = 128, 4, 1e-4
KW = dict(image_size=IMG, compute_dtype="float32", use_flash_attention=True)
TRAINABLE = ["memory_attention", "memory_encoder", "mask_decoder",
             "prompt_encoder", "image_encoder"]
MODES = {"body": dict(remat_mode="body"),
         "modules": dict(remat_mode="modules"),
         "stacked_frame_grads": dict(use_activation_checkpoint=False,
                                     stacked_frame_grads=True)}
LOSS_KEYS = ("total_loss", "loss_mask", "loss_dice", "loss_iou")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_step(kw: dict, seed: int = 9, jp=None):
    """One all-trainable step of the port from ``jp`` (a JAX tree) or the
    seeded init: (metrics, gradients)."""
    cfg = tsam2.SAM2Config(**kw)
    params = (to_param_tree(jax.tree.map(np.array, jp)) if jp is not None
              else tsam2.init(cfg, seed=seed))
    tx = topt.make_optimizer(params, {"lr": LR, "type": "AdamW"},
                             {"enabled": False}, total_steps=1000,
                             trainable_modules=TRAINABLE)
    step = tloop.make_train_step(VideoModelConfig(sam2=cfg), LossConfig(),
                                 tx, trainable_modules=TRAINABLE,
                                 device="cpu")
    _, metrics, grads = step.with_grads(
        tloop.TrainState.create(params, tx),
        example_clip(IMG, T=T_STEP, O=2, C=2, B=1))
    return metrics, grads


@pytest.fixture(scope="module")
def jax_body_step():
    """JAX's all-trainable step at remat "body" from ``jax_tree(KW, 9)``,
    with exact GELU and its gradients returned in place of their global
    norm (``optax.global_norm`` patched to the identity): (the JAX tree,
    its metrics, its gradients by the port's names)."""
    jp = jax_tree(KW, seed=9)
    jcfg = jsam2.SAM2Config(**KW, remat_mode="body")
    with pytest.MonkeyPatch.context() as mp:
        exact = jax.nn.gelu
        mp.setattr(jax.nn, "gelu",
                   lambda x, approximate=True: exact(x, approximate=False))
        mp.setattr(optax, "global_norm", lambda g: g)
        tx = jopt.make_optimizer(jp, {"lr": LR, "type": "AdamW"},
                                 {"enabled": False}, total_steps=1000,
                                 trainable_modules=TRAINABLE)
        jstep = jloop.make_train_step(JVideoModelConfig(sam2=jcfg),
                                      JLossConfig(), tx,
                                      trainable_modules=TRAINABLE)
        args = (jloop.TrainState.create(jp, tx),
                _example_clip(IMG, T=T_STEP, O=2, C=2, B=1))
        _, jm = jstep.lower(*args).compile(FAST_COMPILE)(*args)
    jgrads = dict(to_param_tree(jax.tree.map(np.asarray, jm["grad_norm"]))
                  .named_parameters())
    return jp, jm, jgrads


@pytest.mark.parametrize("mode", sorted(MODES))
def test_remat_step_matches_jax(jax_body_step, mode):
    kw = dict(KW, **MODES[mode])
    assert tsam2.SAM2Config(**kw).resolved_remat_mode() == \
        jsam2.SAM2Config(**kw).resolved_remat_mode()
    jp, jm, jgrads = jax_body_step
    metrics, grads = _port_step(kw, jp=jp)
    for k in LOSS_KEYS:
        _close(metrics[k], jm[k], VAL, k)
    assert grads and set(grads) <= set(jgrads)
    for name, g in grads.items():
        _close(g, jgrads[name], GRAD, name,
               pool_flips=name.startswith("image_encoder."))
    assert any(g.any() for n, g in grads.items()
               if n.startswith("memory_attention."))


@pytest.mark.parametrize("other", [dict(remat_mode="body_dots"),
                                   dict(use_activation_checkpoint=False,
                                        scan_unroll=2)],
                         ids=["body_dots", "scan_unroll_2"])
def test_checkpoints_equal_body(other):
    """Another checkpoint, or none: the forward and the recomputed forward
    are the same operations on the same values, so every number is
    equal."""
    want_m, want_g = _port_step(dict(KW, remat_mode="body"))
    got_m, got_g = _port_step(dict(KW, **other))
    for k in LOSS_KEYS:
        assert torch.equal(got_m[k], want_m[k]), k
    assert sorted(got_g) == sorted(want_g)
    for name in want_g:
        assert torch.equal(got_g[name], want_g[name]), name


def test_default_config_trains():
    """``SAM2Config()``'s defaults (at 128 px to keep the test small)
    resolve to remat "body" and train: finite losses, finite gradients,
    and a gradient on every trunk leaf."""
    cfg = tsam2.SAM2Config(image_size=IMG)
    assert cfg.resolved_remat_mode() == "body"
    assert cfg.compute_dtype == "bfloat16" and cfg.use_flash_attention
    metrics, grads = _port_step(dataclasses.asdict(cfg))
    assert all(np.isfinite(float(metrics[k])) for k in LOSS_KEYS)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    trunk = [n for n in grads if n.startswith("image_encoder.trunk.")]
    assert trunk and all(grads[n].any() for n in trunk)


def test_train_cli_with_activation_checkpoint(tmp_path, monkeypatch):
    """``train_torch.py model.use_activation_checkpoint=true device=cpu``
    trains one step; its logged losses equal the run's without it, bit
    for bit."""
    import train_torch

    data = make_synthetic_dataset(tmp_path / "ds", num_videos=1,
                                  frames_per_video=4, image_hw=(96, 128),
                                  num_categories=2)
    common = [f"data.train_path={data}", f"data.val_path={data}",
              "data.image_size=64", "data.num_categories=2",
              "data.video_clip_length=4", "data.stride=4",
              "data.batch_size=1", "model.compute_dtype=float32",
              "model.max_objects=4", "trainer.max_epochs=1",
              "trainer.limit_train_batches=1", "trainer.limit_val_batches=1",
              "trainer.log_every_n_steps=1",
              "trainer.enable_checkpointing=false", "eval.enabled=false",
              "visualization.enabled=false", "device=cpu"]
    logs = {}
    for remat in ("true", "false"):
        cwd = tmp_path / remat
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        run_dir, result = train_torch.run(
            common + [f"model.use_activation_checkpoint={remat}"])
        assert result.state.step == 1
        logs[remat] = [json.loads(line) for line in
                       (cwd / run_dir / "metrics.jsonl").read_text()
                       .splitlines()]
    assert [r["split"] for r in logs["true"]] == ["train", "val"]
    for got, want in zip(logs["true"], logs["false"]):
        for k, w in want.items():
            if k.startswith(("train/", "val/")):
                assert got[k] == w, k
