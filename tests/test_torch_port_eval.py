"""The port's evaluation building blocks held against the JAX package on
the CPU:

- ``ops/resize.py resize_bilinear`` (interpolation products) against
  ``jax.image.resize(method="linear")``, values and the gradient, where
  both packages upscale mask logits and shrink mask prompts;
- the streaming predictor's features beyond one forward pass: reverse
  propagation from a middle prompt frame and a forward pass after it, two
  conditioning frames, consolidation of a partly prompted conditioning
  frame, re-prompting a tracked frame, a memory-conditioned correction
  click and the ``max_cond_frames`` budget, as in tests/test_multicond.py,
  against the JAX VideoPredictor (SAM2-tiny, 128 px, float32, the same
  JAX parameter tree; the JAX Hiera MLP made exact-erf as in the models
  test);
- ``eval/utils.py mask_to_masks`` against the JAX function's OpenCV
  branch and ``eval/noise.py PromptObjNoiseAdder`` against the JAX class,
  bit for bit, and their OpenCV pieces against OpenCV directly.

Tolerances: the resize 2e-5 relative to the largest value (float32
products of up to 96 terms summed in another order; the weights are
computed as JAX computes them, in float32); the predictor's logits cross
the host as float16 (spacing 2^-11 relative), 2e-3 relative and absolute,
and its scores (float32 means of sigmoids) 1e-4, as in
tests/test_torch_port_predictor.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam2_video_tpu.eval import noise as jnoise
from sam2_video_tpu.eval import predictor as jpred_mod
from sam2_video_tpu.eval import utils as jutils
from sam2_video_tpu.models import sam2 as jsam2
from sam2_video_tpu.ops.resize import resize_bilinear as jresize
from sam2_video_tpu_torch.eval import noise as tnoise
from sam2_video_tpu_torch.eval import utils as tutils
from sam2_video_tpu_torch.eval.predictor import VideoPredictor
from sam2_video_tpu_torch.models import sam2 as tsam2
from sam2_video_tpu_torch.ops.resize import resize_bilinear as tresize
from test_torch_port_models import jax_tree, one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

RESIZE_RTOL = 2e-5
LOGIT_TOL = dict(atol=2e-3, rtol=2e-3)
SCORE_ATOL = 1e-4

IMG, T, O = 128, 6, 2
KW = dict(image_size=IMG, compute_dtype="float32", use_flash_attention=False,
          use_activation_checkpoint=False)
POINTS = [(60.0, 50.0), (140.0, 110.0)]      # (x, y) at video resolution
HW = (160, 192)


# ---------------------------------------------------------------------------
# resize_bilinear
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [
    ((96, 96), (384, 384)),      # low-res logits to the image size
    ((384, 384), (96, 96)),      # a mask prompt shrunk (antialiased)
    ((256, 256), (1024, 1024)),
    ((96, 96), (480, 854)),      # the predictor's output resize
    ((37, 50), (37, 20)),        # one axis shrunk, the other left alone
])
def test_resize_bilinear_matches_jax(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    x = (4.0 * rng.standard_normal((3, 1) + src)).astype(np.float32)
    cot = rng.standard_normal((3, 1) + dst).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jresize(a, dst), jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    got = tresize(xt, dst)
    got.backward(torch.from_numpy(cot))
    for g, w in ((got.detach().numpy(), np.asarray(want)),
                 (xt.grad.numpy(), np.asarray(want_grad))):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RESIZE_RTOL,
                                   atol=RESIZE_RTOL * np.abs(w).max())


# ---------------------------------------------------------------------------
# the predictor against JAX's
# ---------------------------------------------------------------------------


def _video():
    rng = np.random.default_rng(21)
    H, W = HW
    yy, xx = np.mgrid[0:H, 0:W]
    frames = np.empty((T, H, W, 3), np.uint8)
    for t in range(T):
        img = np.stack([xx * 255 // W, yy * 255 // H,
                        np.full_like(xx, 90)], -1).astype(np.float32)
        for o, (cx, cy) in enumerate(POINTS):
            img[_disc(t, o)] = (230, 40 + 150 * o, 60)
        frames[t] = np.clip(img + rng.normal(0, 6, img.shape), 0, 255)
    return frames


def _disc(t, o):
    H, W = HW
    yy, xx = np.mgrid[0:H, 0:W]
    cx, cy = POINTS[o]
    return ((xx - cx - 3 * t) ** 2 + (yy - cy) ** 2) < 20 ** 2


def _click(pred, state, f, o, dx=0.0):
    cx, cy = POINTS[o]
    pred.add_new_points_or_box(state, f, o, points=[[cx + 3 * f + dx, cy]],
                               labels=[1])


def _mask(pred, state, f, o):
    pred.add_new_mask(state, f, o, _disc(f, o).astype(np.uint8))


def _passes(pred, state, *directions):
    return [list(pred.propagate_in_video(state, reverse=r))
            for r in directions]


# each scenario: (max_cond_frames, memory stride, run(pred, frames) ->
# list of propagation passes)
def _reverse_then_forward(pred, frames):
    state = pred.init_state(frames)
    for o in range(O):
        _click(pred, state, 3, o)
    return _passes(pred, state, True, False)


def _forward_then_reverse(pred, frames):
    """The reverse pass then finds tracked memories on both sides of each
    frame: its r-stride slots and pointer rows come from the later
    frames."""
    state = pred.init_state(frames)
    for o in range(O):
        _click(pred, state, 2, o)
    return _passes(pred, state, False, True)


def _two_cond_frames(pred, frames):
    state = pred.init_state(frames)
    for f in (0, 3):
        for o in range(O):
            _mask(pred, state, f, o)
    return _passes(pred, state, False)


def _partial_coverage(pred, frames):
    state = pred.init_state(frames)
    _mask(pred, state, 0, 0)
    _click(pred, state, 2, 1)
    return _passes(pred, state, False, True)


def _interactive_reprompt(pred, frames):
    state = pred.init_state(frames)
    for o in range(O):
        _mask(pred, state, 0, o)
    out = _passes(pred, state, False)
    _click(pred, state, 3, 1)
    return out + _passes(pred, state, False)


def _correction_click(pred, frames):
    state = pred.init_state(frames)
    _mask(pred, state, 0, 0)
    out = _passes(pred, state, False)
    _click(pred, state, 3, 0)
    out += _passes(pred, state, False)
    _click(pred, state, 3, 0, dx=4.0)        # a second click refines it
    return out + _passes(pred, state, False)


SCENARIOS = {
    "reverse_then_forward": (1, 1, _reverse_then_forward),
    "forward_then_reverse": (1, 1, _forward_then_reverse),
    "forward_then_reverse_stride_2": (1, 2, _forward_then_reverse),
    "two_cond_frames": (2, 1, _two_cond_frames),
    "partial_coverage": (2, 1, _partial_coverage),
    "interactive_reprompt": (2, 1, _interactive_reprompt),
    "correction_click": (2, 1, _correction_click),
}


@pytest.fixture(scope="module")
def predictors():
    """(max_cond_frames, stride) -> (JAX predictor, port predictor), made
    on first use. The JAX jit bundles are traced with the exact GELU and
    dropped afterwards, so no other test reuses them."""
    jp = jax_tree(KW, seed=5)
    for k in ("maskmem_tpos_enc", "no_obj_ptr", "no_obj_embed_spatial"):
        jp[k] = jp[k] * 25.0
    # objects present on every frame: compare logits, not a score threshold
    jp["sam_mask_decoder"]["pred_obj_score_head"]["layers"]["2"]["bias"] = \
        np.full((1,), 10.0, np.float32)
    exact = jax.nn.gelu
    made, keys = {}, []

    def get(n_cond, stride):
        if (n_cond, stride) not in made:
            kw = dict(KW, memory_temporal_stride_for_eval=stride)
            jcfg = jsam2.SAM2Config(**kw)
            keys.append(("seq", jcfg, O, n_cond))
            jpred_mod._JIT_BUNDLES.pop(keys[-1], None)
            made[n_cond, stride] = (
                jpred_mod.VideoPredictor(jp, jcfg, max_objects=O,
                                         max_cond_frames=n_cond),
                VideoPredictor(jp, tsam2.SAM2Config(**kw), max_objects=O,
                               max_cond_frames=n_cond, device="cpu"))
        return made[n_cond, stride]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.nn, "gelu",
                   lambda x, approximate=True: exact(x, approximate=False))
        yield get
    for key in keys:
        jpred_mod._JIT_BUNDLES.pop(key, None)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_predictor_features_match_jax(predictors, name):
    """Each pass yields the same frames in the same order as the JAX
    predictor's, with the same object ids, logits within LOGIT_TOL and
    scores within SCORE_ATOL."""
    n_cond, stride, run = SCENARIOS[name]
    jpred, tpred = predictors(n_cond, stride)
    frames = _video()
    want, got = run(jpred, frames), run(tpred, frames)
    assert len(got) == len(want)
    for gp, wp in zip(got, want):
        assert [g[0] for g in gp] == [w[0] for w in wp]
        for (t, ids_g, lg_g, sc_g), (_, ids_w, lg_w, sc_w) in zip(gp, wp):
            assert ids_g == ids_w
            assert lg_g.shape == lg_w.shape == (len(ids_w), 1, IMG // 4,
                                                IMG // 4)
            np.testing.assert_allclose(lg_g.astype(np.float32),
                                       np.asarray(lg_w, np.float32),
                                       err_msg=f"frame {t}", **LOGIT_TOL)
            np.testing.assert_allclose(sc_g, np.asarray(sc_w),
                                       atol=SCORE_ATOL, err_msg=f"frame {t}")
    if name == "partial_coverage":
        # the unprompted rows of each conditioning frame are NO_OBJ
        # placeholders: B's at frame 0, A's at frame 2
        first = {t: lg for t, _, lg, _ in got[0]}
        assert first[0][1].max() <= -100 and first[2][0].max() <= -100


def test_cond_frame_budget_raises_as_jax(predictors):
    """Two prompted frames on a predictor with one conditioning slot."""
    frames = _video()[:3]
    for pred in predictors(1, 1):
        state = pred.init_state(frames)
        _click(pred, state, 0, 0)
        _click(pred, state, 2, 0)
        with pytest.raises(ValueError, match="max_cond_frames"):
            next(pred.propagate_in_video(state))


# ---------------------------------------------------------------------------
# OpenCV's pieces: mask_to_masks and the prompt noise
# ---------------------------------------------------------------------------


def _random_masks(n: int, seed: int):
    """Discs that touch or overlap, speckles under min_area, empty masks
    and odd-sized frames."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        H, W = rng.integers(15, 130, 2) | (i % 2)
        yy, xx = np.mgrid[:H, :W]
        m = np.zeros((H, W), np.uint8)
        for _ in range(rng.integers(0, 6)):
            cy, cx = rng.integers(0, H), rng.integers(0, W)
            r = rng.integers(1, 14)
            m[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 1
        m |= (rng.random((H, W)) < rng.choice([0.0, 0.005, 0.03])
              ).astype(np.uint8)
        yield m


def test_mask_to_masks_matches_jax_cv2_branch():
    """The JAX function runs OpenCV here (its scipy fallback labels
    differently): the same components, in the same order, as uint8 masks
    equal bit for bit, on 240 masks."""
    assert jutils._HAS_CV2
    n_comps = 0
    for m in _random_masks(240, seed=0):
        want, got = jutils.mask_to_masks(m), tutils.mask_to_masks(m)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.uint8
            np.testing.assert_array_equal(g, w)
        n_comps += len(want)
    assert n_comps > 200


def test_morphology_matches_cv2():
    """The closing of mask_to_masks and the square dilation / erosion of
    the noise against cv2 itself."""
    for i, m in enumerate(_random_masks(120, seed=1)):
        np.testing.assert_array_equal(
            tutils.close_square(m),
            cv2.morphologyEx(m, cv2.MORPH_CLOSE,
                             np.ones((10, 10), np.uint8)) > 0)
        k = 3 + 2 * (i % 4)
        kernel = cv2.getStructuringElement(cv2.MORPH_RECT, (k, k))
        for erode, op in ((False, cv2.dilate), (True, cv2.erode)):
            np.testing.assert_array_equal(
                tutils.morph_square(m, k, k // 2, erode), op(m, kernel) > 0)


def test_warp_affine_matches_cv2():
    """warpAffine(INTER_NEAREST) of random binary images under the noise's
    shift, scale and rotation, at widths on both sides of the vector
    blocks; the rotation matrix against cv2.getRotationMatrix2D."""
    rng = np.random.default_rng(2)
    for _ in range(300):
        H, W = (int(v) for v in rng.integers(8, 200, 2))
        src = (rng.random((H, W)) < 0.5).astype(np.uint8)
        ni = rng.choice([0.1, 0.3])
        angle, scale = rng.uniform(-45 * ni, 45 * ni), 1 + rng.uniform(-ni,
                                                                       ni)
        m = tnoise.rotation_matrix((W / 2, H / 2), angle, scale)
        np.testing.assert_allclose(
            m, cv2.getRotationMatrix2D((W / 2, H / 2), angle, scale),
            rtol=0, atol=1e-12)
        m[:, 2] += (rng.uniform(-ni, ni) * W, rng.uniform(-ni, ni) * H)
        np.testing.assert_array_equal(
            tnoise.warp_affine_nearest(src, m, (W, H)),
            cv2.warpAffine(src, m, (W, H), flags=cv2.INTER_NEAREST))


@pytest.mark.parametrize("intensity", [0.1, 0.3])
@pytest.mark.parametrize("kind", ["mask", "bbox"])
def test_prompt_noise_matches_jax(kind, intensity):
    """120 seeds, each noising four prompts in turn from one random.Random:
    the same masks bit for bit, the same boxes, the same drops."""
    dropped = changed = 0
    for seed in range(120):
        H, W = 90 + seed % 7, 120 + seed % 13
        m = np.zeros((H, W), bool)
        m[20 + seed % 9: 50 + seed % 20, 30 + seed % 5: 70 + seed % 30] = True
        fields = dict(mask=m, bbox=jutils.mask_to_bbox(m),
                      points=np.zeros((1, 2), np.float32), obj_id=1,
                      pos_or_neg_label=np.ones(1))
        jn = jnoise.PromptObjNoiseAdder("shift_scale", intensity, seed)
        tn = tnoise.PromptObjNoiseAdder("shift_scale", intensity, seed)
        for _ in range(4):
            want = jn.add_noise_to_obj(
                jutils.PromptObj(**copy.deepcopy(fields)), kind)
            got = tn.add_noise_to_obj(
                tutils.PromptObj(**copy.deepcopy(fields)), kind)
            assert (got is None) == (want is None)
            if want is None:
                dropped += 1
                continue
            assert got.mask.dtype == want.mask.dtype
            np.testing.assert_array_equal(got.mask, want.mask)
            assert got.bbox == want.bbox
            changed += (not np.array_equal(want.mask, m)
                        or want.bbox != fields["bbox"])
    assert changed > 100
