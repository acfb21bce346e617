"""The port's visualization, profiling, combo configs and root tools
(``utils/viz.py``, ``utils/profiling.py``, ``configs/combo/``,
``baseline_eval_torch.py``, ``grid_search_threshold_torch.py``,
``multi_baseline_eval_torch.py``, ``sweep_torch.py``) held against the JAX
package on the CPU:

- the 2x2 composites bit-equal to JAX ``create_visualization_gif``'s
  returned array for the same inputs (normalised frames, every prompt
  label, ``stride`` and ``max_length``);
- the port's own GIF89a decoded by Pillow (the JAX package writes through
  imageio): each frame the composite's palette colours, within the
  quantiser's ``QUANT_STEP`` of the composite, with the frame count and
  delay of JAX's file;
- ``baseline_eval_torch.py`` and ``grid_search_threshold_torch.py`` on the
  ``_synthtest/1`` combo (its data paths pointed at a
  ``make_synthetic_dataset`` tree) against ``baseline_eval.py`` and
  ``grid_search_threshold.py`` from one npz (the JAX Hiera MLP made
  exact-erf): Dice / IoU / MAE within ``test_torch_port_inference.py``'s
  METRIC_ATOL and the same best threshold; ``multi_baseline_eval_torch.py``
  over two workers;
- ``sweep_torch.py``'s runs equal to ``sweep.py``'s on every
  ``sweeps/*.yaml``, a local sweep end to end, and each repository sweep
  run as ``train_torch.py`` (``--program`` still wins) with worker slot i
  on card i mod 4 of four (``torch.cuda`` made to report them);
- the port's ``combo/`` tree: the same combos discovered as the JAX
  package's tool discovers (the count never written down), each resolving
  to the same config tree in both packages;
- ``utils/profiling.py``: the chrome trace, the step timer and the
  first-call time;
- the JAX-free data-prep and report tools against their JAX twins on
  synthetic trees: ``convert_endovis_to_coco_torch.py`` (the same JSON
  from palette, grey and RGB class-id masks),
  ``apply_morphological_opening_torch.py`` (the same JSON for k 1-7, masks
  on the border), ``visualize_cv_torch.py`` (the same composites over PNG
  and JPEG frames, its GIF within the quantiser step) and
  ``generate_combo_yamls_torch.py`` (the same files as the JAX generator,
  and as the committed ``configs/combo/``).
"""

import json
import logging
import random
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from sam2_video_tpu import config as jconfig
from sam2_video_tpu.data.synthetic import make_synthetic_dataset
from sam2_video_tpu.eval import predictor as jpred_mod
from sam2_video_tpu.training import checkpoint as jckpt
from sam2_video_tpu.utils import viz as jviz
from sam2_video_tpu_torch import config as tconfig
from sam2_video_tpu_torch.utils import profiling
from sam2_video_tpu_torch.utils import viz as tviz
from test_torch_port_inference import METRIC_ATOL
from test_torch_port_models import jax_tree, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
SWEEPS = sorted(REPO.glob("sweeps/*.yaml"))
COMBO = "_synthtest/1"


def _viz_inputs(seed=0, T=5, C=3, H=32, W=40):
    g = np.random.default_rng(seed)
    frames = g.standard_normal((T, H, W, 3)).astype(np.float32)
    gt = g.random((T, C, H, W)) > 0.6
    gt[:, 2] = False                       # a category with no pixels
    logits = (g.standard_normal((T, C, 1, H, W)) * 3).astype(np.float32)
    coords = np.asarray([[[5.4, 6.6], [38.7, 1.2]], [[0.0, 31.0], [20, 20]],
                         [[3, 3], [4, 4]]], np.float32)
    labels = np.asarray([[1, 0], [2, 3], [-1, -1]], np.int32)
    return frames, gt, logits, coords, labels


@pytest.mark.parametrize("stride,max_length,points", [
    (1, 4, True), (2, 3, True), (1, 10, False)])
def test_viz_composites_equal_jax(stride, max_length, points):
    frames, gt, logits, coords, labels = _viz_inputs()
    kw = dict(point_coords=coords if points else None,
              point_labels=labels if points else None,
              max_length=max_length, stride=stride)
    want = jviz.create_visualization_gif(frames, gt, logits, **kw)
    got = tviz.create_visualization_gif(torch.from_numpy(frames),
                                        torch.from_numpy(gt),
                                        torch.from_numpy(logits), **kw)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    u8 = (np.abs(frames[0]) * 60).astype(np.uint8)
    assert tviz.denormalize_image(u8) is u8       # uint8 frames pass as is


def test_gif_decodes_within_the_quantiser_step(tmp_path):
    frames, gt, logits, coords, labels = _viz_inputs(seed=1)
    kw = dict(point_coords=coords, point_labels=labels, max_length=4)
    comps = tviz.create_visualization_gif(frames, gt, logits,
                                          path=tmp_path / "port.gif", **kw)
    jviz.create_visualization_gif(frames, gt, logits,
                                  path=tmp_path / "jax.gif", **kw)
    port, ref = Image.open(tmp_path / "port.gif"), Image.open(
        tmp_path / "jax.gif")
    assert port.n_frames == ref.n_frames == len(comps) == 4
    assert port.size == ref.size == comps.shape[2:0:-1]
    pal = tviz.palette()
    for i in range(port.n_frames):
        port.seek(i)
        ref.seek(i)
        assert port.info["duration"] == ref.info["duration"] == 500
        got = np.asarray(port.convert("RGB")).astype(np.int64)
        np.testing.assert_array_equal(got, pal[tviz.quantize(comps[i])])
        assert np.abs(got - comps[i]).max() <= tviz.QUANT_STEP
    assert "loop" not in port.info and "loop" not in ref.info


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """One video of 4 frames at 96x128 (the combo's 96 px, 2 categories)
    and an npz of one weight tree for both packages, with
    ``test_torch_port_inference.py``'s lifts: the constant embeddings
    scaled and the object-score bias at +10, so that objects read present
    and the masks (and Dice) are not empty."""
    root = tmp_path_factory.mktemp("tools")
    data = make_synthetic_dataset(root / "ds", num_videos=1,
                                  frames_per_video=4, image_hw=(96, 128),
                                  num_categories=2)
    jp = jax_tree(dict(image_size=96, compute_dtype="float32",
                       use_activation_checkpoint=False), seed=5)
    for k in ("maskmem_tpos_enc", "no_obj_ptr", "no_obj_embed_spatial"):
        jp[k] = jp[k] * 25.0
    jp["sam_mask_decoder"]["pred_obj_score_head"]["layers"]["2"]["bias"] = \
        np.full((1,), 10.0, np.float32)
    jckpt.save_params_npz(jp, root / "w.npz")
    return root, data, root / "w.npz"


@pytest.fixture
def exact_gelu(monkeypatch):
    """The JAX Hiera MLP's GELU made exact-erf, with the JAX predictor's
    cache of traced steps emptied for the test and restored after it, so
    that no trace of the tanh form is reused and none of the exact one
    leaks."""
    exact = jax.nn.gelu
    monkeypatch.setattr(jax.nn, "gelu",
                        lambda x, approximate=True: exact(x,
                                                          approximate=False))
    saved = dict(jpred_mod._JIT_BUNDLES)
    jpred_mod._JIT_BUNDLES.clear()
    yield
    jpred_mod._JIT_BUNDLES.clear()
    jpred_mod._JIT_BUNDLES.update(saved)


def _close_scores(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])


def test_baseline_eval_and_threshold_search_match_jax(synth, tmp_path,
                                                      monkeypatch,
                                                      exact_gelu):
    import baseline_eval
    import baseline_eval_torch
    import grid_search_threshold
    import grid_search_threshold_torch

    root, data, npz = synth
    paths = [f"data.train_path={data}", f"data.val_path={data}"]
    for tool, extra in ((baseline_eval, []),
                        (baseline_eval_torch, ["device=cpu"])):
        assert tool.main(["--combos", COMBO, "--checkpoint", str(npz),
                          "--out-dir", str(tmp_path / tool.__name__),
                          "--override", *paths, *extra]) == 0
    metrics = [json.loads((tmp_path / name / "_synthtest_1" / "metrics.json")
                          .read_text())
               for name in ("baseline_eval", "baseline_eval_torch")]
    want, got = metrics
    assert got["name"] == want["name"] == "_synthtest_point_mem"
    _close_scores(got["avg_scores"], want["avg_scores"])
    assert sorted(got["cat_scores"]) == sorted(want["cat_scores"])
    for c in want["cat_scores"]:
        _close_scores(got["cat_scores"][c], want["cat_scores"][c])
    csv = (tmp_path / "baseline_eval_torch" / "summary.csv").read_text()
    assert csv.splitlines()[0] == "combo,name,dice,iou,mae"

    results = {}
    for tool, extra in ((grid_search_threshold, []),
                        (grid_search_threshold_torch, ["device=cpu"])):
        cwd = tmp_path / ("thr_" + tool.__name__)
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        assert tool.main([f"checkpoint={npz}", f"combo={COMBO}", *paths,
                          "step=0.1", *extra]) == 0
        (run,) = cwd.glob("outputs/*/*-thr")
        results[tool.__name__] = (
            json.loads((run / "best_threshold.json").read_text()),
            json.loads((run / "eval.json").read_text()))
    (jbest, jeval), (tbest, teval) = (results["grid_search_threshold"],
                                      results["grid_search_threshold_torch"])
    assert tbest["best_threshold"] == jbest["best_threshold"]
    assert abs(tbest["best_dice"] - jbest["best_dice"]) <= METRIC_ATOL
    assert [t for t, _ in tbest["threshold_curve"]] == [
        t for t, _ in jbest["threshold_curve"]]
    _close_scores(teval["avg_scores"], jeval["avg_scores"])


def test_multi_baseline_eval_runs_its_shards(synth, tmp_path, monkeypatch):
    import multi_baseline_eval_torch

    root, data, npz = synth
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "results"
    assert multi_baseline_eval_torch.main([
        "--workers", "2", "--combos", COMBO, "--out-dir", str(out),
        "--checkpoint", str(npz), "--override", f"data.train_path={data}",
        f"data.val_path={data}", "device=cpu"]) == 0
    metrics = json.loads((out / "_synthtest_1" / "metrics.json").read_text())
    assert np.isfinite(metrics["avg_scores"]["dice"])
    # one combo over two workers: the empty shard starts no worker
    assert [p.name for p in (tmp_path / ".combo_shards").iterdir()] == [
        "shard0.txt"]
    assert sorted(p.name for p in out.iterdir()) == ["_synthtest_1",
                                                     "summary.csv"]


@pytest.mark.parametrize("path", SWEEPS, ids=lambda p: p.stem)
def test_sweep_runs_equal_jax(path):
    import sweep
    import sweep_torch

    spec = yaml.safe_load(path.read_text())
    params = spec.get("parameters", {})
    want = [sweep.to_overrides(a) for a in sweep.expand_grid(params)]
    got = [sweep_torch.to_overrides(a) for a in sweep_torch.expand_grid(params)]
    assert got == want and got
    want = [sweep.sample_random(params, r) for r in [random.Random(3)] * 5]
    got = [sweep_torch.sample_random(params, r)
           for r in [random.Random(3)] * 5]
    assert got == want
    if spec.get("method", "grid") == "grid":
        assert sweep_torch.assignments_of(spec, None, 0) == list(
            sweep.expand_grid(params))


def test_local_sweep_end_to_end(tmp_path, monkeypatch):
    import sweep_torch

    monkeypatch.chdir(tmp_path)
    (tmp_path / "prog.py").write_text(
        "import sys, pathlib\n"
        "pathlib.Path('seen.txt').open('a').write(' '.join(sys.argv[1:])"
        " + '\\n')\n")
    (tmp_path / "s.yaml").write_text(yaml.safe_dump({
        "method": "grid", "program": "train.py", "parameters": {
            "optimizer.lr": {"values": [1e-4, 1e-5]},
            "+combo": {"value": "endovis18/1"}}}))
    assert sweep_torch.main(["s.yaml", "--workers", "2", "--program",
                             "prog.py"]) == 0
    (runs,) = tmp_path.glob("outputs/sweeps/*/runs.jsonl")
    recs = [json.loads(line) for line in runs.read_text().splitlines()]
    assert sorted(r["run"] for r in recs) == [0, 1]
    assert all(r["returncode"] == 0 for r in recs)
    assert sorted((tmp_path / "seen.txt").read_text().splitlines()) == [
        "combo=endovis18/1 optimizer.lr=0.0001",
        "combo=endovis18/1 optimizer.lr=1e-05"]


def test_combo_discovery_matches_jax():
    """The same combos as ``baseline_eval.py`` discovers, as many as the
    JAX package's tree holds (``test_torch_port_config.py`` holds the files
    byte for byte)."""
    import baseline_eval
    import baseline_eval_torch

    combos = baseline_eval_torch.discover_combos()
    assert combos == baseline_eval.discover_combos()
    jroot = REPO / "sam2_video_tpu/configs/combo"
    assert len(combos) == len(list(jroot.glob("*/*.yaml"))) > 0
    assert "endovis18/1" in combos and COMBO in combos


def test_every_combo_resolves_as_in_jax():
    import baseline_eval_torch

    for combo in baseline_eval_torch.discover_combos():
        got = tconfig.load_config("config", [f"combo={combo}"])
        want = jconfig.load_config("config", [f"combo={combo}"])
        assert got == want, combo
        assert got.combo.name == want.combo.name, combo
        assert tconfig.model_config(got).sam2.image_size == int(
            want.data.image_size)


def test_profiling_hooks(tmp_path, caplog):
    with profiling.trace(tmp_path / "tr") as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert prof is not None
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])

    timer = profiling.StepTimer()
    for _ in range(3):
        timer.start()
        timer.stop(torch.ones(2).sum())
    s = timer.summary()
    assert s["n"] == 2 and 0 <= s["p50_s"] <= s["p90_s"]
    timer.save(tmp_path / "t.json")
    assert len(json.loads((tmp_path / "t.json").read_text())["times"]) == 3

    calls = []
    log = logging.getLogger("test_profiling_hooks")
    fn = profiling.log_compile_time(lambda x: calls.append(x) or x, log,
                                    "step")
    assert fn.first_call_s is None
    with caplog.at_level(logging.INFO):
        assert fn(1) == 1 and fn(2) == 2
    assert calls == [1, 2] and fn.first_call_s >= 0
    assert caplog.text.count("step: first call") == 1
    if not torch.cuda.is_available():
        assert profiling.memory_stats() == {}


def _four_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)


def test_card_env_keeps_to_the_parents_visible_cards(monkeypatch):
    """Started with ``CUDA_VISIBLE_DEVICES=4,5,6,7`` (four cards seen), slot
    i runs on the (i mod 4)-th of those cards, never on one the parent
    was kept off."""
    from sam2_video_tpu_torch.parallel.dist import card_env

    _four_cards(monkeypatch)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    assert [card_env(i) for i in range(6)] == [
        {"CUDA_VISIBLE_DEVICES": c} for c in "456745"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert card_env(0) == {}


@pytest.mark.parametrize("path", SWEEPS, ids=lambda p: p.stem)
def test_sweep_runs_the_port_one_card_per_slot(path, tmp_path, monkeypatch):
    """Each repository sweep (``program: train.py``) runs
    ``train_torch.py``; on four cards, the run in worker slot i sees card
    i mod 4; ``--program`` still wins."""
    import sweep_torch

    from sam2_video_tpu_torch.parallel.dist import card_env

    _four_cards(monkeypatch)
    assert [card_env(i) for i in range(6)] == [
        {"CUDA_VISIBLE_DEVICES": str(c)} for c in (0, 1, 2, 3, 0, 1)]
    monkeypatch.chdir(tmp_path)
    seen = []
    monkeypatch.setattr(sweep_torch, "run_one",
                        lambda prog, ov, log, env: seen.append(
                            (prog, ov, env)) or 0)
    yaml_path = str(path)
    assert sweep_torch.main([yaml_path, "--workers", "6",
                             "--max-runs", "6"]) == 0
    assert seen and {p for p, _, _ in seen} == {"train_torch.py"}
    for runs in tmp_path.glob("outputs/sweeps/*/runs.jsonl"):
        for line in runs.read_text().splitlines():
            rec = json.loads(line)
            assert 0 <= rec["slot"] < 6
            assert rec["CUDA_VISIBLE_DEVICES"] == str(rec["slot"] % 4)
    assert {e["CUDA_VISIBLE_DEVICES"] for _, _, e in seen} <= {
        "0", "1", "2", "3"}
    seen.clear()
    assert sweep_torch.main([yaml_path, "--max-runs", "2", "--program",
                             "other.py"]) == 0
    assert [p for p, _, _ in seen] == ["other.py", "other.py"]
    assert [e for _, _, e in seen] == [{"CUDA_VISIBLE_DEVICES": "0"}] * 2


def test_local_sweep_pins_a_card_per_slot(tmp_path, monkeypatch):
    """Real runs of a program the YAML names (it runs as named), six
    workers on four cards: each run's environment holds its slot's card,
    slot mod 4."""
    import sweep_torch

    _four_cards(monkeypatch)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "prog.py").write_text(
        "import os, sys, time, pathlib\n"
        "time.sleep(0.5)\n"
        "pathlib.Path('seen.txt').open('a').write(sys.argv[1] + ' '"
        " + os.environ['CUDA_VISIBLE_DEVICES'] + '\\n')\n")
    (tmp_path / "s.yaml").write_text(yaml.safe_dump({
        "method": "grid", "program": "prog.py", "parameters": {
            "optimizer.lr": {"values": [1, 2, 3, 4, 5, 6]}}}))
    assert sweep_torch.main(["s.yaml", "--workers", "6"]) == 0
    (runs,) = tmp_path.glob("outputs/sweeps/*/runs.jsonl")
    recs = {json.loads(line)["overrides"][0]: json.loads(line)
            for line in runs.read_text().splitlines()}
    seen = dict(line.split() for line in
                (tmp_path / "seen.txt").read_text().splitlines())
    assert sorted(seen) == sorted(recs) == [f"optimizer.lr={i}"
                                           for i in range(1, 7)]
    for run, card in seen.items():
        assert 0 <= recs[run]["slot"] < 6
        assert card == recs[run]["CUDA_VISIBLE_DEVICES"] == str(
            recs[run]["slot"] % 4)


def _endovis_tree(root: Path, mode: str) -> None:
    """Two sequences of 3 frames at 36x52 (RGB frames, one frame without a
    mask file) with class-id masks written by Pillow in ``mode``: "P"
    (palette indices), "L" (grey), "RGB" (the id in every channel) or
    "I;16" (16-bit grey, the ids 1 and 3 written as 300 and 4660)."""
    g = np.random.default_rng(7)
    big = {1: 300, 3: 4660} if mode == "I;16" else {1: 1, 3: 3}
    labels = [{"name": "background", "classid": 0},
              {"name": "shaft", "classid": big[1]},
              {"name": "wrist", "classid": big[3]}, {"name": "clasper"}]
    (root / "images").mkdir(parents=True)
    (root / "annotations").mkdir()
    (root / "labels.json").write_text(json.dumps(labels))
    for seq in (1, 10):
        for f in range(3):
            name = f"seq_{seq}_frame{f:03d}.png"
            Image.fromarray(g.integers(0, 256, (36, 52, 3), dtype=np.uint8)
                            ).save(root / "images" / name)
            if seq == 10 and f == 2:
                continue
            ids = np.zeros((36, 52), np.uint8)
            ids[g.integers(0, 30):, :g.integers(5, 50)] = 1
            ids[5:15, 20 + f:40] = 3
            ids[0, 0] = 2 if f else 0
            if mode == "RGB":
                im = Image.fromarray(np.repeat(ids[..., None], 3, -1))
            elif mode == "I;16":
                wide = ids.astype(np.uint16)
                for small, large in big.items():
                    wide[ids == small] = large
                im = Image.fromarray(wide)          # uint16: mode I;16
            elif mode == "P":
                im = Image.fromarray(ids, "P")
                im.putpalette(g.integers(0, 256, 768).tolist())
            else:
                im = Image.fromarray(ids, "L")
            im.save(root / "annotations" / name)


@pytest.mark.parametrize("mode", ["P", "L", "RGB", "I;16"])
def test_endovis_converter_equals_jax(mode, tmp_path):
    sys.path.insert(0, str(REPO / "data_tools"))
    import convert_endovis_to_coco as jtool
    import convert_endovis_to_coco_torch as ttool
    from sam2_video_tpu_torch.data import image_io

    _endovis_tree(tmp_path / "src", mode)
    mask = tmp_path / "src" / "annotations" / "seq_1_frame000.png"
    assert Image.open(mask).mode == mode
    np.testing.assert_array_equal(image_io.read_raw(mask),
                                  np.asarray(Image.open(mask)))
    jtool.convert(tmp_path / "src", tmp_path / "jax.json", 2)
    ttool.main([str(tmp_path / "src"), str(tmp_path / "port.json"),
                "--n-jobs", "2"])
    got = (tmp_path / "port.json").read_text()
    assert got == (tmp_path / "jax.json").read_text()
    data = json.loads(got)
    assert len(data["images"]) == 6 and len(data["annotations"]) >= 10
    assert sum(not im["is_det_keyframe"] for im in data["images"]) == 1


def _border_masks() -> dict:
    """A COCO JSON of masks that touch every border, thin lines that an
    opening removes, blobs and an annotation without a segmentation."""
    from sam2_video_tpu_torch.data import rle as trle

    g = np.random.default_rng(11)
    anns = []
    for i in range(8):
        m = np.zeros((29, 37), np.uint8)
        if i % 4 == 0:
            m[:g.integers(3, 12), :] = 1             # the top border
        elif i % 4 == 1:
            m[:, -g.integers(1, 9):] = 1             # the right border
            m[g.integers(0, 29), :] = 1              # a one-pixel line
        elif i % 4 == 2:
            m = (g.random((29, 37)) > 0.35).astype(np.uint8)
        else:
            yy, xx = np.mgrid[0:29, 0:37]
            m = (((yy - 28) ** 2 + (xx - 2) ** 2) < 120).astype(np.uint8)
        anns.append({"id": i, "image_id": 0, "category_id": i % 3,
                     "segmentation": trle.encode(m), "area": int(m.sum())})
    anns.append({"id": 8, "image_id": 0, "category_id": 0, "bbox": [0, 0, 1,
                                                                     1]})
    return {"images": [{"id": 0, "height": 29, "width": 37}],
            "annotations": anns, "categories": [{"id": 0}, {"id": 1},
                                                {"id": 2}]}


@pytest.mark.parametrize("k", range(1, 8))
def test_opening_equals_jax(k, tmp_path):
    sys.path.insert(0, str(REPO / "data_tools"))
    import apply_morphological_opening as jtool
    import apply_morphological_opening_torch as ttool

    src = tmp_path / "in.json"
    src.write_text(json.dumps(_border_masks()))
    want = jtool.apply_opening(json.loads(src.read_text()), k)
    ttool.main([str(src), str(tmp_path / "out.json"), "--kernel-size",
                str(k)])
    assert (tmp_path / "out.json").read_text() == json.dumps(want)
    assert 1 <= len(want["annotations"]) <= 9


@pytest.mark.parametrize("frames", ["png", "jpeg"])
def test_visualize_cv_equals_jax(frames, tmp_path, monkeypatch):
    """The JAX tool's composites (what it hands to imageio) equal the
    port's, over PNG frames (``make_synthetic_dataset``) and over the JPEG
    fixture video (no ``path``: read from the working directory); the
    port's GIF decodes within the quantiser step of them."""
    import imageio

    sys.path.insert(0, str(REPO / "reports"))
    import visualize_cv as jtool
    import visualize_cv_torch as ttool
    from jpeg_fixtures import ROOT

    if frames == "png":
        coco = make_synthetic_dataset(tmp_path / "ds", num_videos=2,
                                      frames_per_video=3, image_hw=(96, 112),
                                      num_categories=3)
    else:
        coco = ROOT / "video" / "annotations.json"
        monkeypatch.chdir(ROOT / "video" / "images")
    gt = json.loads(coco.read_text())
    preds = [dict(a, category_id=(a["category_id"] + 1) % 3)
             for a in gt["annotations"][::2]]
    (tmp_path / "predict.json").write_text(json.dumps(preds))
    args = ["--predict", str(tmp_path / "predict.json"), "--coco", str(coco),
            "--max-frames", "3", "--fps", "4"]
    captured = {}
    monkeypatch.setattr(imageio, "mimsave", lambda path, comps, **kw:
                        captured.update({Path(path).name: (comps, kw)}))
    monkeypatch.setattr(sys, "argv", ["visualize_cv.py", *args, "--out-dir",
                                      str(tmp_path / "jax")])
    jtool.main()
    ttool.main([*args, "--out-dir", str(tmp_path / "port")])
    assert sorted(captured) == sorted(
        p.name for p in (tmp_path / "port").iterdir()) and len(captured) == 2
    pal = tviz.palette()
    for name, (comps, kw) in captured.items():
        assert kw["duration"] == 250
        comps = np.stack(comps)
        gif = Image.open(tmp_path / "port" / name)
        assert gif.n_frames == len(comps) == 3
        for i in range(gif.n_frames):
            gif.seek(i)
            assert gif.info["duration"] == 250
            got = np.asarray(gif.convert("RGB")).astype(np.int64)
            np.testing.assert_array_equal(got, pal[tviz.quantize(comps[i])])
            assert np.abs(got - comps[i]).max() <= tviz.QUANT_STEP
    vids = ttool.composites(gt, preds, 3)
    for vid, comps in vids.items():
        want = np.stack(captured[f"{str(vid).strip('_')}.gif"][0])
        np.testing.assert_array_equal(comps, want)


def test_combo_generator_equals_jax_and_the_committed_tree(tmp_path,
                                                           monkeypatch):
    """Both generators (their output roots moved under ``tmp_path``), the
    21 combos of each dataset and the fine-tuned variants of an eval list:
    the same files byte for byte, and the combos equal to the committed
    ``sam2_video_tpu_torch/configs/combo/`` (and to the JAX tree)."""
    import generate_combo_yamls as jgen
    import generate_combo_yamls_torch as tgen

    monkeypatch.setattr(jgen, "OUT_ROOT", tmp_path / "jax")
    monkeypatch.setattr(tgen, "OUT_ROOT", tmp_path / "port")
    jgen.generate()
    tgen.main([])
    files = sorted(p.relative_to(tmp_path / "jax").as_posix()
                   for p in (tmp_path / "jax").rglob("*.yaml"))
    assert len(files) == 21 * len(jgen.DATASETS)
    for rel in files:
        body = (tmp_path / "port" / rel).read_bytes()
        assert body == (tmp_path / "jax" / rel).read_bytes(), rel
        for tree in ("sam2_video_tpu_torch", "sam2_video_tpu"):
            assert body == (REPO / tree / "configs" / "combo" / rel
                            ).read_bytes(), (tree, rel)
    (tmp_path / "eval_list.md").write_text(
        "- /ck/cholecseg8k_point_pe/cholecseg8k_point_pe_10.torch\n"
        "- /ck/endovis18_bbox/endovis18_bbox_3.torch\n")
    jgen.generate_from_eval_list(tmp_path / "eval_list.md")
    tgen.main(["--datasets", "--eval-list", str(tmp_path / "eval_list.md")])
    variants = sorted(p.relative_to(tmp_path / "jax").as_posix()
                      for p in (tmp_path / "jax").rglob("*_*.yaml"))
    assert len(variants) == 6
    for rel in variants:
        assert (tmp_path / "port" / rel).read_bytes() == (
            tmp_path / "jax" / rel).read_bytes(), rel
