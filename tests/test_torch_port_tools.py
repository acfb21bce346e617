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
  ``sweeps/*.yaml``, and a local sweep end to end;
- the port's ``combo/`` tree: the same combos discovered as the JAX
  package's tool discovers (the count never written down), each resolving
  to the same config tree in both packages;
- ``utils/profiling.py``: the chrome trace, the step timer and the
  first-call time.
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
