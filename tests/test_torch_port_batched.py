"""The port's lockstep batched predictor (``eval/batched_predictor.py``) and
the grouped runner (``eval/inference.py``, ``batch_videos > 1``) held
against the JAX package on the CPU (SAM2-tiny, 128 px, float32, one JAX
parameter tree, the JAX Hiera MLP made exact-erf as in the models test):

- ``BatchedVideoPredictor`` against JAX's at G=2, max_objects=2: mask and
  point prompts mixed across the videos and objects, a video with one
  object (a padding row), reverse then forward; with and without
  ``non_overlap_masks_for_mem_enc`` (the case that catches a non-overlap
  step folded across the group's videos);
- the port's batched predictor against the port's sequential one, video by
  video, on the kernels' path (``use_flash_attention=True``, their plain
  versions on these CPU tensors);
- the ``ValueError``s JAX raises: a group of the wrong size, a second
  prompt frame, more than max_objects objects;
- ``inference(..., batch_videos=G)`` against JAX's (the three cases of
  tests/test_batched_inference.py): the same clip jobs and group keys; G=2
  with mask prompts and noise on, where full groups and left-over clips
  mix (equal ``prompt.pkl``, ``predict.json`` masks equal after decoding,
  scores within SCORE_ATOL, the probability maps within PROBS_ATOL); and
  G=3 on clips that come only in pairs, so every clip runs sequentially.

Tolerances, as in tests/test_torch_port_eval.py: logits cross the host as
float16, 2e-3 relative and absolute; scores (float32 means of sigmoids)
1e-4; probability maps (float16 sigmoids) 2e-3 absolute.
"""

import functools
import json
import pickle
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from sam2_video_tpu.data.synthetic import make_synthetic_dataset
from sam2_video_tpu.eval import batched_predictor as jbat_mod
from sam2_video_tpu.eval import predictor as jpred_mod
from sam2_video_tpu.eval.inference import InferenceConfig as JInferenceConfig
from sam2_video_tpu.eval.inference import InferenceRunner as JRunner
from sam2_video_tpu.eval.inference import inference as jinference
from sam2_video_tpu.models import sam2 as jsam2
from sam2_video_tpu_torch.data import rle as trle
from sam2_video_tpu_torch.eval.batched_predictor import BatchedVideoPredictor
from sam2_video_tpu_torch.eval.inference import InferenceConfig
from sam2_video_tpu_torch.eval.inference import InferenceRunner
from sam2_video_tpu_torch.eval.inference import inference as tinference
from sam2_video_tpu_torch.eval.predictor import VideoPredictor
from sam2_video_tpu_torch.models import sam2 as tsam2
from test_torch_port_models import jax_tree, one_torch_thread  # noqa: F401

pytest.importorskip("cv2")

LOGIT_TOL = dict(atol=2e-3, rtol=2e-3)
SCORE_ATOL = 1e-4
PROBS_ATOL = 2e-3
NOISE_SEED = 11

IMG, G, O, T = 128, 2, 2, 5
HW = (160, 192)
KW = dict(image_size=IMG, compute_dtype="float32", use_flash_attention=False,
          use_activation_checkpoint=False)
CENTRES = [[(60.0, 50.0), (140.0, 110.0)], [(100.0, 70.0)]]   # (x, y)


def _disc(t, cx, cy):
    H, W = HW
    yy, xx = np.mgrid[0:H, 0:W]
    return ((xx - cx - 3 * t) ** 2 + (yy - cy) ** 2) < 20 ** 2


def _videos():
    rng = np.random.default_rng(31)
    H, W = HW
    yy, xx = np.mgrid[0:H, 0:W]
    out = np.empty((G, T, H, W, 3), np.uint8)
    for g in range(G):
        for t in range(T):
            img = np.stack([xx * 255 // W, yy * 255 // H,
                            np.full_like(xx, 90 + 60 * g)], -1).astype(
                np.float32)
            for o, (cx, cy) in enumerate(CENTRES[g]):
                img[_disc(t, cx, cy)] = (230, 40 + 150 * o, 60)
            out[g, t] = np.clip(img + rng.normal(0, 6, img.shape), 0, 255)
    return out


PROMPT_FRAME = 2


def _prompts():
    """Per video: (kind, obj_id, payload). Video 0 prompts a mask and a
    click, video 1 one click (its second row is padding); every click is
    one point, so the group's point rows pad to the sequential runs'
    count."""
    (a, b), (c,) = CENTRES
    f = PROMPT_FRAME
    return [[("mask", 11, _disc(f, *a).astype(np.uint8)),
             ("points", 12, ([[b[0] + 3 * f, b[1]]], [1]))],
            [("points", 21, ([[c[0] + 3 * f, c[1]]], [1]))]]


def _run_batched(pred, frames, prompts):
    state = pred.init_group(frames)
    for g, objs in enumerate(prompts):
        for kind, obj_id, payload in objs:
            if kind == "mask":
                pred.add_new_mask(state, g, PROMPT_FRAME, obj_id, payload)
            else:
                pred.add_new_points_or_box(state, g, PROMPT_FRAME, obj_id,
                                           points=payload[0],
                                           labels=payload[1])
    return [list(pred.propagate_in_group(state, reverse=r))
            for r in (True, False)]


def _run_sequential(pred, frames, objs):
    state = pred.init_state(frames)
    for kind, obj_id, payload in objs:
        if kind == "mask":
            pred.add_new_mask(state, PROMPT_FRAME, obj_id, payload)
        else:
            pred.add_new_points_or_box(state, PROMPT_FRAME, obj_id,
                                       points=payload[0], labels=payload[1])
    return [list(pred.propagate_in_video(state, reverse=r))
            for r in (True, False)]


@pytest.fixture(scope="module")
def tree():
    jp = jax_tree(KW, seed=7)
    for k in ("maskmem_tpos_enc", "no_obj_ptr", "no_obj_embed_spatial"):
        jp[k] = jp[k] * 25.0
    # objects present on every frame: compare logits, not a score threshold
    jp["sam_mask_decoder"]["pred_obj_score_head"]["layers"]["2"]["bias"] = \
        np.full((1,), 10.0, np.float32)
    return jp


@pytest.fixture
def exact_jax(monkeypatch):
    """The JAX Hiera MLP's GELU made exact; the jit bundles traced under it
    are dropped afterwards, so no other test reuses them."""
    exact = jax.nn.gelu
    monkeypatch.setattr(jax.nn, "gelu",
                        lambda x, approximate=True: exact(x,
                                                          approximate=False))
    before = set(jpred_mod._JIT_BUNDLES)
    yield
    for key in set(jpred_mod._JIT_BUNDLES) - before:
        jpred_mod._JIT_BUNDLES.pop(key, None)


@pytest.mark.parametrize("non_overlap", [False, True])
def test_batched_predictor_matches_jax(tree, exact_jax, non_overlap):
    """Every lockstep yield: the same frames in the same order, the same
    object ids per video, the whole [G, n_max] logits (padding row
    included) within LOGIT_TOL and scores within SCORE_ATOL."""
    kw = dict(KW, non_overlap_masks_for_mem_enc=non_overlap)
    jpred = jbat_mod.BatchedVideoPredictor(tree, jsam2.SAM2Config(**kw),
                                           max_objects=O, group_size=G)
    tpred = BatchedVideoPredictor(tree, tsam2.SAM2Config(**kw),
                                  max_objects=O, group_size=G, device="cpu")
    frames = _videos()
    want = _run_batched(jpred, frames, _prompts())
    got = _run_batched(tpred, frames, _prompts())
    assert [len(p) for p in got] == [PROMPT_FRAME + 1, T - PROMPT_FRAME]
    for gp, wp in zip(got, want):
        assert [y[0] for y in gp] == [y[0] for y in wp]
        for (t, ids_g, lg_g, sc_g), (_, ids_w, lg_w, sc_w) in zip(gp, wp):
            assert ids_g == ids_w == [[11, 12], [21]]
            assert lg_g.dtype == np.float16
            assert lg_g.shape == lg_w.shape == (G, O, 1, IMG // 4, IMG // 4)
            np.testing.assert_allclose(lg_g.astype(np.float32),
                                       np.asarray(lg_w, np.float32),
                                       err_msg=f"frame {t}", **LOGIT_TOL)
            np.testing.assert_allclose(sc_g, np.asarray(sc_w),
                                       atol=SCORE_ATOL, err_msg=f"frame {t}")


def test_batched_predictor_matches_sequential(tree):
    """The port's two predictors on the kernels' path: each video's rows
    of every yield against that video's sequential run."""
    cfg = tsam2.SAM2Config(**dict(KW, use_flash_attention=True))
    frames = _videos()
    prompts = [[("points", o, ([[cx + 3 * PROMPT_FRAME, cy]], [1]))
                for o, (cx, cy) in enumerate(c)] for c in CENTRES]
    got = _run_batched(BatchedVideoPredictor(tree, cfg, max_objects=O,
                                             group_size=G, device="cpu"),
                       frames, prompts)
    seq = VideoPredictor(tree, cfg, max_objects=O, device="cpu")
    for g in range(G):
        want = _run_sequential(seq, frames[g], prompts[g])
        for gp, wp in zip(got, want):
            assert [y[0] for y in gp] == [y[0] for y in wp]
            for (t, ids_g, lg_g, sc_g), (_, ids_w, lg_w, sc_w) in zip(gp,
                                                                      wp):
                n = len(ids_w)
                assert ids_g[g] == ids_w
                np.testing.assert_allclose(
                    lg_g[g, :n].astype(np.float32),
                    lg_w.astype(np.float32), err_msg=f"video {g} frame {t}",
                    **LOGIT_TOL)
                np.testing.assert_allclose(sc_g[g, :n], sc_w,
                                           atol=SCORE_ATOL)


def test_batched_predictor_raises_as_jax(tree, exact_jax):
    cfgs = (jsam2.SAM2Config(**KW), tsam2.SAM2Config(**KW))
    frames = (np.random.default_rng(0).random((3, 2, 32, 32, 3)) * 255
              ).astype(np.uint8)
    for pred in (jbat_mod.BatchedVideoPredictor(tree, cfgs[0], max_objects=1,
                                                group_size=2),
                 BatchedVideoPredictor(tree, cfgs[1], max_objects=1,
                                       group_size=2, device="cpu")):
        with pytest.raises(ValueError, match="group_size=2"):
            pred.init_group(frames)
        state = pred.init_group(frames[:2])
        pred.add_new_points_or_box(state, 0, 1, "a", points=[[5, 5]],
                                   labels=[1])
        with pytest.raises(ValueError, match="ONE prompt frame"):
            pred.add_new_points_or_box(state, 1, 0, "b", points=[[5, 5]],
                                       labels=[1])
        with pytest.raises(ValueError, match="max_objects=1"):
            pred.add_new_points_or_box(state, 0, 1, "c", points=[[5, 5]],
                                       labels=[1])


# ---------------------------------------------------------------------------
# the grouped runner
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tree):
    """Both packages' ``inference`` runs, made on first use: 96x128 frames,
    5 per video, clip_length 3, so every video gives a clip of 3 frames and
    one of 2 (two group keys). Both runners seed the noise from the OS;
    one seed for both here."""
    root = tmp_path_factory.mktemp("grouped")
    jcfg, tcfg = jsam2.SAM2Config(**KW), tsam2.SAM2Config(**KW)
    exact = jax.nn.gelu
    before = set(jpred_mod._JIT_BUNDLES)
    made, sets = {}, {}

    def data(videos):
        if videos not in sets:
            sets[videos] = make_synthetic_dataset(
                root / f"ds{videos}", num_videos=videos, frames_per_video=5,
                image_hw=(96, 128), num_categories=2)
        return sets[videos]

    def run(videos, batch, **kw):
        key = (videos, batch)
        if key not in made:
            kw = dict(kw, clip_length=3, max_objects=3, batch_videos=batch)
            jdir, tdir = root / f"{key}" / "jax", root / f"{key}" / "port"
            made[key] = (jinference(tree, jcfg, data(videos), jdir, **kw),
                         tinference(tree, tcfg, data(videos), tdir,
                                    device="cpu", **kw),
                         jdir / "eval", tdir / "eval")
        return made[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.nn, "gelu",
                   lambda x, approximate=True: exact(x, approximate=False))
        for mod in (sys.modules["sam2_video_tpu.eval.inference"],
                    sys.modules["sam2_video_tpu_torch.eval.inference"]):
            mp.setattr(mod, "PromptObjNoiseAdder", functools.partial(
                mod.PromptObjNoiseAdder, seed=NOISE_SEED))
        yield data, run
    for key in set(jpred_mod._JIT_BUNDLES) - before:
        jpred_mod._JIT_BUNDLES.pop(key, None)


def test_grouping_keys_match_jax(runs, tree, tmp_path):
    """Both runners schedule the same clip jobs, record the same prompts
    while collecting them, and key them alike: each video's clips of 3
    and 2 frames, prompted on their first frame."""
    data, _ = runs
    path = data(3)
    cfg = dict(prompt_type="points", clip_length=3, max_objects=3,
               batch_videos=2)
    jr = JRunner(tree, jsam2.SAM2Config(**KW), JInferenceConfig(**cfg),
                 path, tmp_path / "jax")
    tr = InferenceRunner(tree, tsam2.SAM2Config(**KW), InferenceConfig(**cfg),
                         path, tmp_path / "port", device="cpu")
    jjobs, tjobs = jr._collect_clip_jobs(), tr._collect_clip_jobs()
    assert len(tjobs) == len(tr.prompt_info) == 6
    keys = [tr._job_group_key(j) for j in tjobs]
    assert keys == [jr._job_group_key(j) for j in jjobs]
    assert sorted(set(keys)) == [(2, 0, 96, 128), (3, 0, 96, 128)]
    for a, b in zip(tjobs, jjobs):
        assert a[0] == b[0]
        assert (a[3].start_idx, a[3].end_idx) == (b[3].start_idx,
                                                  b[3].end_idx)
        assert [o.obj_id for o in a[2][0].prompt_objs] == \
            [o.obj_id for o in b[2][0].prompt_objs]


def _assert_outputs_match(tpaths, jpaths, tdir, jdir):
    (tpred, tprompt), (jpred, jprompt) = tpaths, jpaths
    with open(tprompt, "rb") as f:
        got_p = pickle.load(f)
    with open(jprompt, "rb") as f:
        want_p = pickle.load(f)
    assert [(p.video_id, p.frame_idx, [o.obj_id for o in p.prompt_objs])
            for p in got_p] == [(p.video_id, p.frame_idx,
                                 [o.obj_id for o in p.prompt_objs])
                                for p in want_p]
    want = {(a["image_id"], a["category_id"]): a
            for a in json.loads(Path(jpred).read_text())}
    got = {(a["image_id"], a["category_id"]): a
           for a in json.loads(Path(tpred).read_text())}
    assert want and sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(trle.decode(got[k]["segmentation"]),
                                      trle.decode(w["segmentation"]),
                                      err_msg=str(k))
        assert abs(got[k]["score"] - w["score"]) <= SCORE_ATOL, k
    files = sorted(p.name for p in (jdir / "probs").glob("*.npz"))
    assert files == sorted(p.name for p in (tdir / "probs").glob("*.npz"))
    for name in files:
        g, w = np.load(tdir / "probs" / name), np.load(jdir / "probs" / name)
        np.testing.assert_array_equal(g["obj_ids"], w["obj_ids"])
        np.testing.assert_allclose(g["probs"].astype(np.float32),
                                   w["probs"].astype(np.float32),
                                   atol=PROBS_ATOL, rtol=0)


def test_grouped_inference_matches_jax(runs):
    """G=2 over 3 videos: per key one full group and one clip left over
    for the sequential path; mask prompts with noise, drawn group by group
    and then for the left-over clips; the probability maps written by both
    paths."""
    _, run = runs
    jout, tout, jdir, tdir = run(3, 2, prompt_type="mask",
                                 noised_prompt=True, noise_intensity=0.1,
                                 probs_out_dir="probs")
    _assert_outputs_match(tout, jout, tdir, jdir)
    assert len(list((tdir / "probs").glob("*.npz"))) == 15


def test_group_nothing_fills_runs_sequentially(runs, tree, monkeypatch,
                                               tmp_path):
    """G=3 over 2 videos: each key has two clips, so no group fills and
    every clip runs on the sequential predictor (the port's batched
    predictor is never built); the output matches JAX's."""
    data, run = runs
    jout, tout, jdir, tdir = run(2, 3, prompt_type="points",
                                 probs_out_dir="probs")
    _assert_outputs_match(tout, jout, tdir, jdir)
    built = []
    monkeypatch.setattr(
        sys.modules["sam2_video_tpu_torch.eval.inference"],
        "BatchedVideoPredictor", lambda *a, **k: built.append(1))
    tinference(tree, tsam2.SAM2Config(**KW), data(2), tmp_path,
               device="cpu", prompt_type="points", clip_length=3,
               max_objects=3, batch_videos=3)
    assert not built
