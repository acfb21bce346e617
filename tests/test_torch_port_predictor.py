"""The port's streaming VideoPredictor held against the JAX VideoPredictor
on the CPU: SAM2-tiny at image_size=128, float32, use_flash_attention=False,
2 objects point-prompted on frame 0 of a 6-frame synthetic video, the same
JAX parameter tree on both sides (``from_jax_params`` for the port).

Both predictors get the same raw frames: the port's squash-resize
computes cv2.INTER_LINEAR's fixed-point arithmetic, which the JAX
predictor calls, so both models see the same pixels (held bit for bit
against cv2 below); the JAX Hiera MLP is made exact-erf as in the models
test. Tolerances: logits cross the host as float16, whose spacing is 2^-11
relative, so 2e-3 relative (a float32 difference may flip one rounding)
and 2e-3 absolute near zero; scores are float32 means of sigmoids, 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from sam2_video_tpu.eval import predictor as jpred_mod
from sam2_video_tpu.models import sam2 as jsam2
from sam2_video_tpu_torch.eval import predictor as tpred_mod
from sam2_video_tpu_torch.eval.predictor import VideoPredictor
from sam2_video_tpu_torch.models import sam2 as tsam2
from test_torch_port_models import jax_tree, one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

IMG, T, O = 128, 6, 2
KW = dict(image_size=IMG, compute_dtype="float32", use_flash_attention=False,
          use_activation_checkpoint=False)
JCFG = jsam2.SAM2Config(**KW)
TCFG = tsam2.SAM2Config(**KW)
POINTS = [[[60.0, 50.0]], [[140.0, 110.0]]]      # (x, y) at video res


def _video(hw=(160, 192)):
    rng = np.random.default_rng(21)
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W]
    frames = np.empty((T, H, W, 3), np.uint8)
    for t in range(T):
        img = np.stack([xx * 255 // W, yy * 255 // H,
                        np.full_like(xx, 90)], -1).astype(np.float32)
        for o, ((cx, cy),) in enumerate(POINTS):
            inside = ((xx - cx - 3 * t) ** 2 + (yy - cy) ** 2) < 20 ** 2
            img[inside] = (230, 40 + 150 * o, 60)
        frames[t] = np.clip(img + rng.normal(0, 6, img.shape), 0, 255)
    return frames


@pytest.fixture(scope="module")
def jax_params():
    p = jax_tree(KW, seed=5)
    for k in ("maskmem_tpos_enc", "no_obj_ptr", "no_obj_embed_spatial"):
        p[k] = p[k] * 25.0
    # objects present on every frame: compare logits, not a score threshold
    p["sam_mask_decoder"]["pred_obj_score_head"]["layers"]["2"]["bias"] = \
        np.full((1,), 10.0, np.float32)
    return p


def _run(pred, frames):
    state = pred.init_state(frames)
    for o, pts in enumerate(POINTS):
        pred.add_new_points_or_box(state, 0, o, points=pts, labels=[1])
    return state, list(pred.propagate_in_video(state))


def test_video_predictor_matches_jax(jax_params, monkeypatch):
    exact = jax.nn.gelu
    monkeypatch.setattr(jax.nn, "gelu",
                        lambda x, approximate=True: exact(x,
                                                          approximate=False))
    key = ("seq", JCFG, O, 1)
    jpred_mod._JIT_BUNDLES.pop(key, None)
    try:
        frames = _video()
        _, want = _run(jpred_mod.VideoPredictor(jax_params, JCFG,
                                                max_objects=O), frames)
    finally:
        jpred_mod._JIT_BUNDLES.pop(key, None)
    state, got = _run(VideoPredictor(jax_params, TCFG, max_objects=O,
                                     device="cpu"), frames)
    assert [g[0] for g in got] == [w[0] for w in want] == list(range(T))
    for (_, ids_g, lg_g, sc_g), (_, ids_w, lg_w, sc_w) in zip(got, want):
        assert ids_g == ids_w == [0, 1]
        assert lg_g.shape == lg_w.shape == (O, 1, IMG // 4, IMG // 4)
        np.testing.assert_allclose(lg_g.astype(np.float32),
                                   lg_w.astype(np.float32),
                                   atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(sc_g, np.asarray(sc_w), atol=1e-4)
    assert sorted(state.mem_bank) == list(range(1, T))


@pytest.mark.parametrize("hw", [(480, 854), (1024, 1280), (256, 320)])
def test_frame_resize_matches_cv2(hw):
    """Squash-resize of uint8 frames to 384 x 384 equals cv2.INTER_LINEAR
    bit for bit (its 11-bit fixed-point weights and integer passes), on the
    synthetic video at 480x854 and on random frames at 1024x1280 and at
    256x320 (an upscale, where cv2 clamps the edge rows' indices but not
    their weights)."""
    if hw == (480, 854):
        frames = _video(hw)[:2]
    else:
        frames = np.random.default_rng(7).integers(
            0, 256, (2, *hw, 3), dtype=np.uint8)
    got = tpred_mod.resize_frames(torch.from_numpy(frames), 384).numpy()
    want = np.stack([cv2.resize(f, (384, 384),
                                interpolation=cv2.INTER_LINEAR)
                     for f in frames])
    np.testing.assert_array_equal(got, want)


def test_logits_to_orig_matches_jax():
    """Float32 bilinear upsample to the video resolution: equal to cv2 to
    float32 rounding (2e-5), masks equal away from the zero crossing,
    probabilities within float16 spacing."""
    rng = np.random.default_rng(3)
    logits = (4.0 * rng.standard_normal((2, 1, 32, 32))).astype(np.float16)
    m_t, p_t = tpred_mod.logits_to_orig(logits, (150, 210), want_probs=True)
    m_j, p_j = jpred_mod.logits_to_orig(logits, (150, 210), want_probs=True)
    up = np.stack([cv2.resize(logits[i, 0].astype(np.float32), (210, 150),
                              interpolation=cv2.INTER_LINEAR)
                   for i in range(2)])[:, None]
    away = np.abs(up) > 2e-5
    np.testing.assert_array_equal(m_t[away], m_j[away])
    np.testing.assert_allclose(p_t.astype(np.float32),
                               p_j.astype(np.float32), atol=1e-3)


def test_out_of_slice_features_raise(jax_params):
    frames = _video()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VideoPredictor(jax_params, TCFG, max_objects=O, device="cpu",
                       max_cond_frames=2)
    # the usual use_flash_attention=True is served (kernels #3-#5; their
    # plain versions on the CPU)
    flash = tsam2.SAM2Config(**{**KW, "use_flash_attention": True})
    pred = VideoPredictor(jax_params, flash, max_objects=O, device="cpu")
    state = pred.init_state(frames[:3])
    pred.add_new_points_or_box(state, 0, "a", points=POINTS[0], labels=[1])
    with pytest.raises(NotImplementedError, match="reverse"):
        next(pred.propagate_in_video(state, reverse=True))
    list(pred.propagate_in_video(state))
    pred.add_new_points_or_box(state, 2, "a", points=POINTS[0], labels=[1])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        next(pred.propagate_in_video(state))
