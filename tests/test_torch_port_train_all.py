"""The all-trainable fine-tuning step of the PyTorch port held against the
JAX package on the CPU, in float32: one step of ``make_train_step`` with
trainable ``[memory_attention, memory_encoder, mask_decoder,
prompt_encoder, image_encoder]`` (the reference's ``mem+md+pe+ie`` set,
``bench.py``'s second configuration), SAM2-tiny at 128 px, T=3, O=2, C=2,
B=2, point prompts, AdamW at lr 1e-4, against JAX ``make_train_step``
with the same modules. It checks the losses, the gradient of every
trainable leaf (the Hiera trunk, patch embed and pos-embeds, the FPN
neck, conv_s0 / conv_s1, the prompt encoder and the two-way decoder
included), the updated parameters and the frozen ones left as they were.

On the card the trunk's blocks run kernel #1 forward and kernel #6
backward (``SAM2Config.fused_backbone_vjp``, set by ``make_train_step``);
on these CPU tensors they run the plain blocks, as the JAX step runs its
XLA blocks on the CPU. GELU: ``exact_gelu`` makes the JAX Hiera MLP use
erf, as the port does. The JAX step is compiled without XLA's expensive
LLVM passes (``FAST_COMPILE``).

Tolerances, as ``tests/test_torch_port_train.py`` states them: values
1e-4 and gradients 2e-4 of max(1, max|JAX|) of each tensor; updates 1e-2
lr where the gradient's sign is sure, 2 lr elsewhere. The trunk has three
q-pool blocks, whose 2x2 max may order a near-tied cell differently in
the two float32 forwards; a leaf where that moved a gradient contribution
may have at most 1% of its elements outside the limit and must lie within
2e-2 relative L2 of JAX's (``tests/test_hiera_fused.py``
``allow_pool_flips``).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _example_clip
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
from test_torch_port_models import exact_gelu, jax_tree  # noqa: F401
from test_torch_port_train import FAST_COMPILE

IMG = 128
KW = dict(image_size=IMG, compute_dtype="float32", use_flash_attention=True,
          use_activation_checkpoint=False)
TRAINABLE = ["memory_attention", "memory_encoder", "mask_decoder",
             "prompt_encoder", "image_encoder"]
FROZEN = ("obj_ptr_proj", "obj_ptr_tpos_proj")
LR, EPS = 1e-4, 1e-8
VAL, GRAD = 1e-4, 2e-4
FLIP_FRACTION, FLIP_REL_L2 = 0.01, 2e-2
T_STEP = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, tol, name="", pool_flips=False):
    a = t.detach().double().numpy()
    b = np.asarray(j, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max()))
    bad = np.abs(a - b) > tol * scale
    if not pool_flips or not bad.any():
        assert not bad.any(), (name, float(np.abs(a - b).max()), tol * scale)
        return
    rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
    assert bad.mean() <= FLIP_FRACTION and rel <= FLIP_REL_L2, (
        name, int(bad.sum()), rel)


def test_optimizer_labels_all_five_modules():
    """make_optimizer labels the five modules' entries and the bare
    parameters "train" and the two pointer projections "freeze"."""
    cfg = tsam2.SAM2Config(**KW)
    params = tsam2.init(cfg, seed=0)
    tops = {n.split(".")[0] for n, _ in params.named_parameters()}
    labels = {t: topt.top_level_label(t, TRAINABLE) for t in tops}
    assert {t for t, lab in labels.items() if lab == "freeze"} == set(FROZEN)
    for t in ("image_encoder", "memory_attention", "memory_encoder",
              "sam_mask_decoder", "sam_prompt_encoder", "maskmem_tpos_enc",
              "no_mem_embed", "no_obj_ptr"):
        assert labels[t] == "train", t


def test_all_trainable_step_matches_jax(exact_gelu, monkeypatch):  # noqa: F811
    """One step; the JAX step returns its gradients in place of their
    global norm (``optax.global_norm`` patched to the identity), so one
    compile gives loss, gradients and updated parameters."""
    jp = jax_tree(KW, seed=9)
    jcfg = jsam2.SAM2Config(**KW)
    tx = jopt.make_optimizer(jp, {"lr": LR, "type": "AdamW"},
                             {"enabled": False}, total_steps=1000,
                             trainable_modules=TRAINABLE)
    monkeypatch.setattr(optax, "global_norm", lambda g: g)
    jstep = jloop.make_train_step(JVideoModelConfig(sam2=jcfg), JLossConfig(),
                                  tx, trainable_modules=TRAINABLE)
    args = (jloop.TrainState.create(jp, tx),
            _example_clip(IMG, T=T_STEP, O=2, C=2, B=2))
    jstate, jm = jstep.lower(*args).compile(FAST_COMPILE)(*args)
    jgrads = dict(to_param_tree(jax.tree.map(np.asarray, jm["grad_norm"]))
                  .named_parameters())
    jnew = dict(to_param_tree(jax.tree.map(np.asarray, jstate.params))
                .named_parameters())

    tcfg = tsam2.SAM2Config(**KW)
    params = to_param_tree(jax.tree.map(np.array, jp))    # a copy
    before = {n: t.detach().clone() for n, t in params.named_parameters()}
    ttx = topt.make_optimizer(params, {"lr": LR, "type": "AdamW"},
                              {"enabled": False}, total_steps=1000,
                              trainable_modules=TRAINABLE)
    tstep = tloop.make_train_step(VideoModelConfig(sam2=tcfg), LossConfig(),
                                  ttx, trainable_modules=TRAINABLE,
                                  device="cpu")
    state, metrics, grads = tstep.with_grads(
        tloop.TrainState.create(params, ttx),
        example_clip(IMG, T=T_STEP, O=2, C=2, B=2))
    assert state.step == 1
    for k in ("total_loss", "loss_mask", "loss_dice", "loss_iou"):
        _close(metrics[k], jm[k], VAL, k)

    assert set(grads) == {n for n in before
                          if n.split(".")[0] not in FROZEN}
    for name, g in grads.items():
        _close(g, jgrads[name], GRAD, name,
               pool_flips=name.startswith("image_encoder."))
    # every leaf of the trunk gets a gradient through its blocks; the
    # neck's high-resolution convs only through the mask logits, which
    # these random weights replace by NO_OBJ_SCORE where an object reads
    # absent (JAX's gradients are zero there too)
    trunk = [n for n in grads if n.startswith("image_encoder.trunk.")]
    assert trunk and all(grads[n].any() for n in trunk), [
        n for n in trunk if not grads[n].any()]
    for top in ("sam_mask_decoder", "sam_prompt_encoder"):
        assert any(g.any() for n, g in grads.items()
                   if n.startswith(top + ".")), top

    for name, p in params.named_parameters():
        if name not in grads:
            assert torch.equal(p, before[name]), name
            continue
        g = grads[name].abs()
        noise = (grads[name] - torch.from_numpy(jgrads[name].numpy())).abs()
        sure = g > max(1e-3 * float(g.max()), 10 * float(noise.max()),
                       100 * EPS)
        diff = (p.detach() - torch.from_numpy(jnew[name].numpy())).abs()
        assert (diff[sure] <= 1e-2 * LR).all(), name
        assert (diff <= 2 * LR).all(), name
