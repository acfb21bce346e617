"""Box and mask prompts of the port held against the JAX package on the
CPU, SAM2-tiny at 128 px, float32, one JAX parameter tree:

- the streaming predictor with ``add_new_points_or_box(box=...)`` and with
  ``add_new_mask`` on frame 0 of a 6-frame video, at the predictor test's
  tolerances (logits 2e-3, scores 1e-4), and the mask prompt as the model
  gets it (resized to 128 x 128 as Pillow's BILINEAR does, then > 127)
  bit for bit;
- one train step with ``prompt_type="box"`` (frame 0 through the SAM heads
  with box corners, labels 2 / 3) and with ``"mask"`` (frame 0's mask used
  as its output, ``use_mask_input_as_output_without_sam``), trainable
  memory attention, memory encoder, mask decoder and prompt encoder, T=2,
  B=1: the losses at the train test's VAL and every trainable leaf's
  gradient at its GRAD.

The decoder's ReLU MLPs have 2048 hidden units over a few dozen tokens, so
a pre-activation within float32 summation noise of zero is likely, and
where the two packages round it to opposite signs the unit's whole
first-layer gradient row differs (one such unit sat at 3.2e-5 on the
tracked frame of the box step; moving its bias by -5e-5 gave the port
JAX's gradient to the last digit). Before the step, every unit whose
pre-activation comes within RELU_BAND of zero for some token, in one
forward of the port, has its bias raised by RELU_SHIFT in the tree both
packages use, until no unit is left in the band.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from scipy import ndimage

from sam2_video_tpu.data.types import VideoClipBatch as JBatch
from sam2_video_tpu.eval import predictor as jpred_mod
from sam2_video_tpu.models import sam2 as jsam2
from sam2_video_tpu.models.video_model import \
    VideoModelConfig as JVideoModelConfig
from sam2_video_tpu.training import loop as jloop
from sam2_video_tpu.training import optimizer as jopt
from sam2_video_tpu.training.losses import LossConfig as JLossConfig
from sam2_video_tpu.utils import prompts as jprompts
from sam2_video_tpu_torch.convert import to_param_tree
from sam2_video_tpu_torch.data.types import FIELDS, VideoClipBatch
from sam2_video_tpu_torch.eval.predictor import VideoPredictor
from sam2_video_tpu_torch.models import mask_decoder as tmd
from sam2_video_tpu_torch.models import sam2 as tsam2
from sam2_video_tpu_torch.models.video_model import (VideoModelConfig,
                                                     forward_train)
from sam2_video_tpu_torch.ops import common as tnn
from sam2_video_tpu_torch.training import loop as tloop
from sam2_video_tpu_torch.training import optimizer as topt
from sam2_video_tpu_torch.training.losses import LossConfig
from test_torch_port_predictor import JCFG, KW, O, POINTS, TCFG, _video
from test_torch_port_predictor import jax_params  # noqa: F401
from test_torch_port_train import FAST_COMPILE, GRAD, LR, VAL, _close
from test_torch_port_train import jp  # noqa: F401
from test_torch_port_models import one_torch_thread  # noqa: F401

IMG = 128
TRAINABLE = ["memory_attention", "memory_encoder", "mask_decoder",
             "prompt_encoder"]
RELU_BAND, RELU_SHIFT = 1e-4, 1e-3


def _disk(hw, centre, r):
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    return ((xx - centre[0]) ** 2 + (yy - centre[1]) ** 2) < r * r


def _prompt(pred, state, kind):
    hw = state.orig_hw
    for o, ((cx, cy),) in enumerate(POINTS):
        if kind == "box":
            pred.add_new_points_or_box(state, 0, o, box=[cx - 21, cy - 19,
                                                        cx + 20, cy + 22])
        else:
            pred.add_new_mask(state, 0, o, _disk(hw, (cx + 0.5, cy), 20.5))


def _run(pred, frames, kind):
    state = pred.init_state(frames)
    _prompt(pred, state, kind)
    return state, list(pred.propagate_in_video(state))


@pytest.mark.parametrize("kind", ["box", "mask"])
def test_video_predictor_box_and_mask_match_jax(jax_params, monkeypatch,
                                                kind):
    exact = jax.nn.gelu
    monkeypatch.setattr(jax.nn, "gelu",
                        lambda x, approximate=True: exact(x,
                                                          approximate=False))
    frames = _video()
    key = ("seq", JCFG, O, 1)
    jpred_mod._JIT_BUNDLES.pop(key, None)
    try:
        jstate, want = _run(jpred_mod.VideoPredictor(jax_params, JCFG,
                                                     max_objects=O),
                            frames, kind)
    finally:
        jpred_mod._JIT_BUNDLES.pop(key, None)
    tstate, got = _run(VideoPredictor(jax_params, TCFG, max_objects=O,
                                      device="cpu"), frames, kind)
    for o in range(O):
        a, b = tstate.prompts[0][o], jstate.prompts[0][o]
        assert a[0] == b[0] == ("points" if kind == "box" else "mask")
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
        if kind == "box":
            np.testing.assert_array_equal(a[2], b[2])
    assert [g[0] for g in got] == [w[0] for w in want] == list(range(6))
    for (_, ids_g, lg_g, sc_g), (_, ids_w, lg_w, sc_w) in zip(got, want):
        assert ids_g == ids_w == [0, 1]
        np.testing.assert_allclose(lg_g.astype(np.float32),
                                   lg_w.astype(np.float32),
                                   atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(sc_g, np.asarray(sc_w), atol=1e-4)


@pytest.mark.parametrize("hw", [(160, 192), (434, 340), (91, 500)])
def test_mask_prompt_matches_jax(jax_params, hw):
    """add_new_mask's prompt as the model gets it (resized to 128 x 128 as
    Pillow's BILINEAR does, then > 127) equals the JAX predictor's, bit
    for bit, on smooth random masks, down- and upscaled."""
    g = np.random.default_rng(hw[0])
    preds = (VideoPredictor(jax_params, TCFG, max_objects=4, device="cpu"),
             jpred_mod.VideoPredictor(jax_params, JCFG, max_objects=4))
    for o in range(4):
        mask = ndimage.gaussian_filter(g.random(hw), 4.0) > 0.5
        got = []
        for pred in preds:
            pred._add = lambda state, f, obj, payload: got.append(payload)
            pred.add_new_mask(None, 0, o, mask)
        (kind_t, m_t, _), (kind_j, m_j, _) = got
        assert kind_t == kind_j == "mask"
        np.testing.assert_array_equal(np.asarray(m_t), np.asarray(m_j))


def _clip(kind: str, T: int = 2):
    """One clip of the example's layout (two square objects in categories 0
    and 1, two padding objects) with box or mask prompts."""
    g = np.random.default_rng(8)
    H, Ob = IMG, 4
    images = g.standard_normal((1, T, H, H, 3)).astype(np.float32)
    cat_masks = np.zeros((1, T, 2, H, H), bool)
    obj_masks = np.zeros((1, Ob, H, H), np.float32)
    for c, (a, b) in enumerate(((H // 8, H // 3), (H // 2, 7 * H // 8))):
        cat_masks[:, :, c, a:b, a + 3:b + 5] = True
        obj_masks[:, c, a:b, a + 3:b + 5] = 1.0
    obj_to_cat = np.asarray([[0, 1, -1, -1]], np.int32)
    if kind == "box":
        coords, labels = jprompts.generate_box_prompt(obj_masks[0])
        coords, labels = coords[None], labels[None]
    else:
        coords = np.zeros((1, Ob, 1, 2), np.float32)
        labels = -np.ones((1, Ob, 1), np.int32)
    return dict(images=images, cat_masks=cat_masks, obj_masks=obj_masks,
                obj_to_cat=obj_to_cat, point_coords=coords,
                point_labels=labels)


def _relu_units_in_band(tree, mcfg, clip, monkeypatch) -> dict:
    """{bias name: hidden units whose pre-activation comes within
    RELU_BAND of zero for some token} over the mask decoder's ReLU MLPs,
    in one forward of the port on ``tree``."""
    params = to_param_tree(jax.tree.map(np.array, tree))
    names = {t.data_ptr(): n for n, t in params.named_parameters()}
    low = {}
    plain = tnn.mlp

    def spy(p, x, activation="relu", sigmoid_output=False):
        if activation == "relu":
            h = x
            for i in range(len(p["layers"]) - 1):
                layer = p["layers"][str(i)]
                h = tnn.linear(layer, h)
                a = h.detach().abs().reshape(-1, h.shape[-1]).min(0).values
                n = names[layer["bias"].data_ptr()]
                low[n] = torch.minimum(low[n], a) if n in low else a
                h = F.relu(h)
        return plain(p, x, activation, sigmoid_output)

    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(tmd.nn, "mlp", spy)
        forward_train(params, mcfg, clip, training=True)
    return {n: (a < RELU_BAND).numpy() for n, a in low.items()
            if (a < RELU_BAND).any()}


def _clear_relu_band(tree, mcfg, clip, monkeypatch):
    """A copy of ``tree`` with no decoder ReLU unit in the band."""
    tree = jax.tree.map(np.array, tree)
    for _ in range(5):
        band = _relu_units_in_band(tree, mcfg, clip, monkeypatch)
        if not band:
            return tree
        for name, units in band.items():
            node = tree
            for part in name.split(".")[:-1]:
                node = node[part]
            node["bias"][units] += RELU_SHIFT
    raise AssertionError(f"decoder ReLU units still in the band: {band}")


@pytest.mark.parametrize("kind", ["box", "mask"])
def test_train_step_box_and_mask_match_jax(jp, monkeypatch, kind):
    """The JAX step returns its gradients in place of their global norm
    (``optax.global_norm`` patched to the identity), as in the train test."""
    arrays = _clip(kind)
    batch = VideoClipBatch(**{k: torch.from_numpy(arrays[k])
                              for k in FIELDS})
    tcfg = tsam2.SAM2Config(**{**KW, "use_flash_attention": True})
    jp = _clear_relu_band(jp, VideoModelConfig(sam2=tcfg, prompt_type=kind),
                          batch.clip(0), monkeypatch)
    jcfg = jsam2.SAM2Config(**{**KW, "use_flash_attention": True})
    tx = jopt.make_optimizer(jp, {"lr": LR, "type": "AdamW"},
                             {"enabled": False}, total_steps=1000,
                             trainable_modules=TRAINABLE)
    monkeypatch.setattr(optax, "global_norm", lambda g: g)
    jstep = jloop.make_train_step(JVideoModelConfig(sam2=jcfg,
                                                    prompt_type=kind),
                                  JLossConfig(), tx,
                                  trainable_modules=TRAINABLE)
    args = (jloop.TrainState.create(jp, tx),
            JBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    _, jm = jstep.lower(*args).compile(FAST_COMPILE)(*args)
    jgrads = dict(to_param_tree(jax.tree.map(np.asarray, jm["grad_norm"]))
                  .named_parameters())

    params = to_param_tree(jax.tree.map(np.array, jp))
    ttx = topt.make_optimizer(params, {"lr": LR, "type": "AdamW"},
                              {"enabled": False}, total_steps=1000,
                              trainable_modules=TRAINABLE)
    tstep = tloop.make_train_step(VideoModelConfig(sam2=tcfg,
                                                   prompt_type=kind),
                                  LossConfig(), ttx,
                                  trainable_modules=TRAINABLE, device="cpu")
    _, metrics, grads = tstep.with_grads(
        tloop.TrainState.create(params, ttx), batch)
    for k in ("total_loss", "loss_mask", "loss_dice", "loss_iou"):
        _close(metrics[k], jm[k], VAL, k)
    assert grads
    for name, g in grads.items():
        _close(g, jgrads[name], GRAD, name)
    moved = [n for n, g in grads.items() if g.abs().max() > 0]
    assert any(n.startswith("sam_mask_decoder.") for n in moved)
    if kind == "box":
        assert any(n.startswith("sam_prompt_encoder.point_embeddings")
                   for n in moved)
