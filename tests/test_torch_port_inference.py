"""The port's evaluation path end to end, held against the JAX package on
the CPU on one ``make_synthetic_dataset`` tree (2 videos x 5 PNG frames of
96x128, 2 categories; category 1 left out of video 0's first two frames,
so that ``variable_cats`` opens a clip where it appears):

- ``eval/inference.py inference`` (``InferenceRunner``, reverse then
  forward propagation of every clip) with point (two positive, one
  negative, on a grid), box and mask prompts, mask prompts with noise, and
  ``clip_length`` with ``variable_cats``, against JAX ``inference``
  (SAM2-tiny, 128 px, float32, one JAX parameter tree, the JAX Hiera MLP
  made exact-erf): the same ``prompt.pkl`` objects and ids, the float16
  probability maps within PROBS_ATOL, each ``predict.json`` annotation's
  mask within MIN_IOU of its JAX twin and its score within SCORE_ATOL;
- ``evaluate``, ``grid_search`` (and the ``tune_threshold`` CLI) and
  ``export_predict`` run by both packages on the same files: equal
  results and equal JSON;
- ``train_torch.py`` with ``eval.enabled=true`` against JAX ``train.py``
  on one tree and one npz: the same ``eval/metrics.json``.

Tolerances: the maps are float16 sigmoids of logits that agree to ~1e-4
(the predictor test's 2e-3 on logits), so 2e-3 absolute; a mask pixel
flips only where a logit sits within that noise of 0, so IoU >= 0.999
(a few pixels of a disc-sized mask); scores are float32 means, 1e-4. The
metrics are computed from the thresholded masks, 1e-3 absolute.
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
from sam2_video_tpu.eval import export_predict_from_probs as jexport
from sam2_video_tpu.eval.inference import inference as jinference
from sam2_video_tpu.eval import metrics as jmetrics
from sam2_video_tpu.eval import predictor as jpred_mod
from sam2_video_tpu.eval import tune_threshold as jtune
from sam2_video_tpu.eval import utils as jutils
from sam2_video_tpu.models import sam2 as jsam2
from sam2_video_tpu.training import checkpoint as jckpt
from sam2_video_tpu_torch.data import rle as trle
from sam2_video_tpu_torch.eval import export_predict_from_probs as texport
from sam2_video_tpu_torch.eval.inference import inference as tinference
from sam2_video_tpu_torch.eval import metrics as tmetrics
from sam2_video_tpu_torch.eval import tune_threshold as ttune
from sam2_video_tpu_torch.eval import utils as tutils
from sam2_video_tpu_torch.models import sam2 as tsam2
from test_torch_port_models import jax_tree, one_torch_thread  # noqa: F401

pytest.importorskip("cv2")

PROBS_ATOL = 2e-3
MIN_IOU = 0.999
SCORE_ATOL = 1e-4
METRIC_ATOL = 1e-3
NOISE_SEED = 7

IMG, MAX_OBJECTS = 128, 3
KW = dict(image_size=IMG, compute_dtype="float32", use_flash_attention=False,
          use_activation_checkpoint=False)
CASES = {
    "points": dict(prompt_type="points", num_points=2, num_neg_points=1,
                   grid_spacing=3),
    "bbox": dict(prompt_type="bbox"),
    "mask": dict(prompt_type="mask"),
    "mask_noised": dict(prompt_type="mask", noised_prompt=True,
                        noise_intensity=0.1),
    "clip_length_variable_cats": dict(prompt_type="points", clip_length=2,
                                      variable_cats=True),
}


def _dataset(root: Path, hw=(96, 128), frames=5) -> Path:
    path = make_synthetic_dataset(root, num_videos=2,
                                  frames_per_video=frames, image_hw=hw,
                                  num_categories=2)
    data = json.loads(Path(path).read_text())
    late = {im["id"] for im in data["images"]
            if im["video_id"] == "vid0" and im["order_in_video"] < 2}
    data["annotations"] = [a for a in data["annotations"]
                           if not (a["image_id"] in late
                                   and a["category_id"] == 1)]
    Path(path).write_text(json.dumps(data))
    return Path(path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The dataset, the JAX tree, and both packages' runs of each case,
    made on first use. The JAX jit bundle is traced with the exact GELU
    and dropped afterwards."""
    root = tmp_path_factory.mktemp("inference")
    data = _dataset(root / "ds")
    jp = jax_tree(KW, seed=5)
    for k in ("maskmem_tpos_enc", "no_obj_ptr", "no_obj_embed_spatial"):
        jp[k] = jp[k] * 25.0
    jp["sam_mask_decoder"]["pred_obj_score_head"]["layers"]["2"]["bias"] = \
        np.full((1,), 10.0, np.float32)
    jcfg, tcfg = jsam2.SAM2Config(**KW), tsam2.SAM2Config(**KW)
    key = ("seq", jcfg, MAX_OBJECTS, 1)
    exact = jax.nn.gelu
    runs = {}

    def run(case):
        if case not in runs:
            kw = dict(CASES[case], probs_out_dir="probs",
                      max_objects=MAX_OBJECTS)
            jdir, tdir = root / case / "jax", root / case / "port"
            runs[case] = (jinference(jp, jcfg, data, jdir, **kw),
                          tinference(jp, tcfg, data, tdir, device="cpu",
                                     **kw),
                          jdir / "eval", tdir / "eval")
        return runs[case]

    jpred_mod._JIT_BUNDLES.pop(key, None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.nn, "gelu",
                   lambda x, approximate=True: exact(x, approximate=False))
        # both runners seed their noise from the OS; one seed for both
        for mod in (sys.modules["sam2_video_tpu.eval.inference"],
                    sys.modules["sam2_video_tpu_torch.eval.inference"]):
            mp.setattr(mod, "PromptObjNoiseAdder", functools.partial(
                mod.PromptObjNoiseAdder, seed=NOISE_SEED))
        yield data, run
    jpred_mod._JIT_BUNDLES.pop(key, None)
    # both packages keep the point grid in a module global
    jutils._GRID = tutils._GRID = None


def _prompt_fields(info):
    return (info.frame_idx, info.prompt_type, info.video_id, info.path,
            (info.clip_range.start_idx, info.clip_range.end_idx))


def _assert_prompts_equal(got_path, want_path):
    with open(want_path, "rb") as f:
        want = pickle.load(f)
    with open(got_path, "rb") as f:
        got = pickle.load(f)
    assert [_prompt_fields(p) for p in got] == \
        [_prompt_fields(p) for p in want]
    for g, w in zip(got, want):
        assert len(g.prompt_objs) == len(w.prompt_objs) > 0
        for go, wo in zip(g.prompt_objs, w.prompt_objs):
            assert go.obj_id == wo.obj_id and go.bbox == wo.bbox
            for field in ("mask", "points", "pos_or_neg_label"):
                a, b = getattr(go, field), getattr(wo, field)
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    return want


def _assert_probs_close(got_dir: Path, want_dir: Path):
    meta_g = json.loads((got_dir / "meta.json").read_text())
    meta_w = json.loads((want_dir / "meta.json").read_text())
    assert sorted(meta_g.pop("image_ids")) == sorted(meta_w.pop("image_ids"))
    assert meta_g == meta_w
    files = sorted(p.name for p in want_dir.glob("*.npz"))
    assert files and files == sorted(p.name for p in got_dir.glob("*.npz"))
    for name in files:
        g, w = np.load(got_dir / name), np.load(want_dir / name)
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            if k == "probs":
                assert g[k].dtype == w[k].dtype == np.float16
                np.testing.assert_allclose(g[k].astype(np.float32),
                                           w[k].astype(np.float32),
                                           atol=PROBS_ATOL, rtol=0)
            else:
                np.testing.assert_array_equal(g[k], w[k])


def _assert_predictions_close(got_path, want_path):
    want = json.loads(Path(want_path).read_text())
    got = json.loads(Path(got_path).read_text())

    def by_key(anns):
        return {(a["image_id"], a["category_id"]): a for a in anns}

    want, got = by_key(want), by_key(got)
    assert want and sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        mg, mw = trle.decode(g["segmentation"]), trle.decode(w["segmentation"])
        inter = np.logical_and(mg, mw).sum()
        iou = inter / max(np.logical_or(mg, mw).sum(), 1)
        assert iou >= MIN_IOU, (k, iou)
        assert abs(g["score"] - w["score"]) <= SCORE_ATOL, k


@pytest.mark.parametrize("case", sorted(CASES))
def test_inference_matches_jax(setup, case):
    _, run = setup
    (jpred, jprompt), (tpred, tprompt), jdir, tdir = run(case)
    prompts = _assert_prompts_equal(tprompt, jprompt)
    if case == "clip_length_variable_cats":
        # video 0 opens a clip where category 1 appears (frame 2)
        assert [p.clip_range.start_idx for p in prompts
                if p.video_id == "vid0"] == [0, 2, 4]
    _assert_probs_close(tdir / "probs", jdir / "probs")
    _assert_predictions_close(tpred, jpred)


def _same(a, b):
    """Equal nested results; NaN equals NaN."""
    if isinstance(a, dict):
        return sorted(a, key=str) == sorted(b, key=str) and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, (float, np.floating)):
        return (np.isnan(a) and np.isnan(b)) or a == b
    return a == b


def test_metrics_tools_match_jax_on_the_same_files(setup, tmp_path,
                                                   monkeypatch):
    """The JAX run's predict.json and probability maps (points case)
    through both packages' evaluate, grid_search, tune_threshold CLI and
    export_predict."""
    data, run = setup
    (jpred, _), _, jdir, _ = run("points")
    probs = jdir / "probs"
    want = jmetrics.evaluate(jpred, data, tmp_path / "jax")
    got = tmetrics.evaluate(jpred, data, tmp_path / "port")
    assert _same(got, want)
    assert 0 < got["avg_scores"]["dice"] <= 1
    assert (tmp_path / "port" / "eval.json").read_text() == \
        (tmp_path / "jax" / "eval.json").read_text()
    with open(tmp_path / "port" / "eval.pkl", "rb") as f:
        assert _same(pickle.load(f), want)
    for kw in (dict(), dict(t_min=0.1, t_max=0.9, t_step=0.1,
                            exclude_background=True)):
        assert _same(ttune.grid_search(probs, data, **kw),
                     jtune.grid_search(probs, data, **kw))
    for name, mod in (("jax", jtune), ("port", ttune)):
        monkeypatch.setattr(sys, "argv", [
            "tune_threshold", "--probs-dir", str(probs), "--coco-path",
            str(data), "--output-json", str(tmp_path / f"{name}_best.json")])
        mod.main()
    assert (tmp_path / "port_best.json").read_text() == \
        (tmp_path / "jax_best.json").read_text()
    for thr, skip in ((0.5, False), (0.3, True)):
        out = [mod.export_predict(probs, thr, tmp_path / f"{n}_{thr}.json",
                                  exclude_background=skip)
               for n, mod in (("jax", jexport), ("port", texport))]
        texts = [Path(p).read_text() for p in out]
        assert texts[0] == texts[1] and json.loads(texts[0])


def test_train_cli_eval_matches_jax(tmp_path, monkeypatch):
    """JAX ``train.main`` and ``train_torch.run(device=cpu)`` with
    ``eval.enabled=true`` on one tree and one npz (64 px, T=2, float32,
    one train step and one validation batch, the best checkpoint reloaded
    for the eval, per-category logging and the probability maps on):
    the same keys in eval/metrics.json and the same Dice, IoU and MAE."""
    exact = jax.nn.gelu
    monkeypatch.setattr(jax.nn, "gelu",
                        lambda x, approximate=True: exact(x,
                                                          approximate=False))
    kw = dict(image_size=64, compute_dtype="float32",
              use_activation_checkpoint=False)
    data = _dataset(tmp_path / "ds", hw=(96, 128), frames=4)
    jp = jax_tree(kw, seed=5)
    # objects present: the eval's masks are not empty
    jp["sam_mask_decoder"]["pred_obj_score_head"]["layers"]["2"]["bias"] = \
        np.full((1,), 10.0, np.float32)
    jckpt.save_params_npz(jp, tmp_path / "w.npz")
    common = [f"data.train_path={data}", f"data.val_path={data}",
              "data.image_size=64", "data.num_categories=2",
              "data.video_clip_length=2", "data.stride=2",
              "data.batch_size=1", f"model.checkpoint_path={tmp_path}/w.npz",
              "model.compute_dtype=float32", "model.max_objects=4",
              "trainer.max_epochs=1", "trainer.limit_train_batches=1",
              "trainer.limit_val_batches=1", "trainer.log_every_n_steps=1",
              "scheduler.enabled=false", "visualization.enabled=false",
              "eval.enabled=true", "eval.log_per_category=true",
              "eval.probs_out_dir=probs"]
    import train
    import train_torch

    metrics = {}
    for name in ("jax", "port"):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        jpred_mod._JIT_BUNDLES.clear()
        if name == "jax":
            assert train.main(common) == 0
        else:
            train_torch.run(common + ["device=cpu"])
        (run_dir,) = cwd.glob("outputs/*/*")
        for f in ("predict.json", "prompt.pkl", "eval.pkl", "probs/meta.json"):
            assert (run_dir / "eval" / f).exists(), f
        metrics[name] = json.loads(
            (run_dir / "eval" / "metrics.json").read_text())
    jpred_mod._JIT_BUNDLES.clear()
    got, want = metrics["port"], metrics["jax"]
    assert sorted(got) == sorted(want)
    assert any(k.startswith("eval/cat1/") for k in want)
    for k, w in want.items():
        if isinstance(w, dict):
            for m in w:
                assert abs(got[k][m] - w[m]) <= METRIC_ATOL, (k, m)
        elif isinstance(w, float):
            assert np.isnan(w) == np.isnan(got[k]), k
            if not np.isnan(w):
                assert abs(got[k] - w) <= METRIC_ATOL, k
        else:
            assert got[k] == w, k
    assert 0 < want["eval/dice"] <= 1
