"""Checkpoints, conversion, the fit loop and the train CLI of the port
(``training/checkpoint.py``, ``training/convert.py``, ``training/loop.py``
``fit``, ``train_torch.py``) held against the JAX package on the CPU:

- the Checkpointer's top-k, ``last`` and ``index.json`` against the JAX
  Checkpointer's for one metric sequence, and a bit-exact restore of the
  parameters, the whole optimizer state (AdamW with AMSGrad and gradient
  accumulation part way) and the step;
- npz files JAX -> port -> JAX bit for bit;
- ``convert_state_dict`` against the JAX converter on a state dict from the
  port's init (prefixes, nested dicts, a missing, an unexpected and a
  mismatched tensor, the strict raise), and ``load_finetuned``'s three
  cases;
- one step of the CLI with each knob that once raised NotImplementedError
  (the grouped post-fit eval, the training GIFs, two gloo ranks, a
  distributed world of one, the rematerialised frame loop);
- the slice as a whole: JAX ``train.main`` and ``train_torch.main`` with
  ``device=cpu`` on one synthetic dataset (1 video, 64 px, T=2, float32,
  the same npz, 2 train steps and 1 validation batch, or one after each
  step): every logged loss within 1e-3 relative; then the port resumes
  from its checkpoints, and where the best is not ``last`` both packages
  resume from the best alike.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam2_video_tpu.data.synthetic import make_synthetic_dataset
from sam2_video_tpu.training import checkpoint as jckpt
from sam2_video_tpu.training import convert as jconvert
from sam2_video_tpu.training import loop as jloop
from sam2_video_tpu_torch.convert import from_jax_params, to_param_tree
from sam2_video_tpu_torch.models import sam2 as tsam2
from sam2_video_tpu_torch.ops.common import ParamTree
from sam2_video_tpu_torch.training import checkpoint as tckpt
from sam2_video_tpu_torch.training import convert as tconvert
from sam2_video_tpu_torch.training import loop as tloop
from sam2_video_tpu_torch.training.optimizer import make_optimizer
from test_torch_port_models import jax_tree, one_torch_thread  # noqa: F401

KW = dict(image_size=64, compute_dtype="float32", use_activation_checkpoint=False)
LOSS_RTOL = 1e-3


@pytest.fixture(scope="module")
def jp():
    return jax_tree(KW, seed=5)


def _assert_trees_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            _assert_trees_equal(x, y)
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


def _opt_fields(opt) -> dict:
    return {f.name: getattr(opt, f.name) for f in dataclasses.fields(opt)}


def test_checkpointer_top_k_and_bit_exact_restore(tmp_path):
    g = torch.Generator().manual_seed(0)
    params = ParamTree({
        "memory_attention": {"w": torch.randn(3, 4, generator=g)},
        "image_encoder": {"w": torch.randn(5, generator=g)},
        "no_mem_embed": torch.randn(1, 1, 4, generator=g)})
    tx = make_optimizer(params, {"lr": 1e-2, "type": "AdamW",
                                 "amsgrad": True, "weight_decay": 0.01},
                        {"enabled": True, "warmup_steps": 2}, 20,
                        trainable_modules=["memory_attention"],
                        accumulate_grad_batches=2)
    state = tloop.TrainState.create(params, tx)
    named = dict(params.named_parameters())

    def update(state):
        grads = {n: torch.randn(t.shape, generator=g)
                 for n, t in named.items()}
        with torch.no_grad():
            upd, opt = tx.update(grads, state.opt_state, named)
            for n, t in named.items():
                t.add_(upd[n])
        return tloop.TrainState(params=params, opt_state=opt,
                                step=state.step + 1)

    metrics = [3.0, 1.0, 2.0, 0.5, 4.0]
    ours = tckpt.Checkpointer(tmp_path / "port", save_top_k=2)
    theirs = jckpt.Checkpointer(tmp_path / "jax", save_top_k=2)
    for m in metrics:
        state = update(state)
        ours.save(state, metric=m, epoch=1)
        theirs.save(jloop.TrainState(params={"w": np.zeros(2)}, opt_state={},
                                     step=jnp.int32(state.step)),
                    metric=m, epoch=1)
    assert state.opt_state.mini_step == 1    # halfway through accumulating
    index = json.loads((ours.dir / "index.json").read_text())
    assert index == json.loads((theirs.dir / "index.json").read_text())
    assert [r["step"] for r in index] == [4, 2]
    assert sorted(p.name for p in ours.dir.iterdir()) == [
        "index.json", "last", "step00000002", "step00000004"]
    reopened = tckpt.Checkpointer(tmp_path / "port")
    assert reopened.best_path == ours.dir / "step00000004"

    got = reopened.restore(ours.dir / "last")
    assert got["step"] == state.step == 5
    _assert_trees_equal(dict(got["params"].named_parameters()),
                        dict(params.named_parameters()))
    _assert_trees_equal(_opt_fields(got["opt_state"]),
                        _opt_fields(state.opt_state))
    best = reopened.restore()
    assert best["step"] == 4 and best["opt_state"].mini_step == 0


def test_npz_round_trip_jax_port_jax(jp, tmp_path):
    """JAX save_params_npz -> port load / save -> JAX load_params_npz: the
    same names, layouts and bits; the port's tensors are the
    from_jax_params of the tree."""
    jckpt.save_params_npz(jp, tmp_path / "a.npz")
    sd = tckpt.load_params_npz(tmp_path / "a.npz")
    _assert_trees_equal(sd, from_jax_params(jp))
    tckpt.save_params_npz(to_param_tree(sd), tmp_path / "b.npz")
    back = jckpt._flatten(jckpt.load_params_npz(tmp_path / "b.npz"))
    want = jckpt._flatten(jp)
    assert sorted(back) == sorted(want)
    for k in want:
        assert back[k].dtype == want[k].dtype and back[k].shape == \
            want[k].shape, k
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def _torch_files(tmp_path, sd: dict):
    """A Meta-style {"model": ...} file, a Lightning-style
    {"state_dict": {"model.<name>": ...}} file, and the bare dict."""
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    files = {"meta.pt": {"model": t},
             "lightning.pt": {"state_dict": {f"model.{k}": v
                                             for k, v in t.items()}},
             "bare.pt": t}
    for name, obj in files.items():
        torch.save(obj, tmp_path / name)
    return list(files)


def test_convert_state_dict_matches_jax(jp, tmp_path):
    init = tsam2.init(tsam2.SAM2Config(**KW), seed=11)
    sd = {k: v.numpy() for k, v in init.state_dict().items()}
    sd.pop("no_mem_embed")                                   # missing
    sd["extra.weight"] = np.ones(3, np.float32)              # unexpected
    sd["memory_encoder.out_proj.bias"] = np.ones(7, np.float32)  # mismatched
    for name in _torch_files(tmp_path, sd):
        jsd = jconvert._load_torch_state_dict(tmp_path / name)
        tsd = tconvert._load_torch_state_dict(tmp_path / name)
        assert sorted(jsd) == sorted(tsd) == sorted(sd)
        jout, jrep = jconvert.convert_state_dict(jsd, jp)
        tout, trep = tconvert.convert_state_dict(tsd, to_param_tree(jp))
        assert {k: sorted(v) for k, v in trep.items()} == {
            k: sorted(v) for k, v in jrep.items()}
        assert trep["missing"] == ["memory_encoder.out_proj.bias",
                                   "no_mem_embed"]
        _assert_trees_equal(tout, from_jax_params(jout))
        for conv in (jconvert, tconvert):
            with pytest.raises(ValueError, match="1 mismatched"):
                conv.convert_state_dict(jsd, jp if conv is jconvert
                                        else to_param_tree(jp), strict=True)


@pytest.mark.parametrize("case", ["npz", "all", "mask_decoder"])
def test_load_finetuned_matches_jax(jp, tmp_path, monkeypatch, case):
    """An npz grafts the names it holds; a path with "all" loads a whole
    state dict non-strictly; otherwise a mask-decoder dict with its
    ``_prompt_encoder.torch`` companion (a stray name raises). Relative
    file names, so that only the file's own name can hold "all"."""
    monkeypatch.chdir(tmp_path)
    other = tsam2.init(tsam2.SAM2Config(**KW), seed=12).state_dict()
    if case == "npz":
        path = "ft.npz"
        tckpt.save_params_npz({k: v for k, v in other.items()
                               if k.startswith("sam_mask_decoder.")}, path)
    elif case == "all":
        path = "sam2_all.pt"
        torch.save({"model": other}, path)
    else:
        path = "md.torch"
        pre = ("sam_mask_decoder.", "sam_prompt_encoder.")
        for p, name in zip(pre, (path, "md_prompt_encoder.torch")):
            torch.save({k[len(p):]: v for k, v in other.items()
                        if k.startswith(p)}, name)
    want = from_jax_params(jconvert.load_finetuned(jp, path))
    got = tconvert.load_finetuned(to_param_tree(jp), path)
    _assert_trees_equal(got, want)
    before = from_jax_params(jp)
    changed = {k for k in got if not torch.equal(got[k], before[k])}
    assert changed and all(k.startswith(("sam_mask_decoder.",
                                         "sam_prompt_encoder."))
                           or case == "all" for k in changed)
    if case == "mask_decoder":
        torch.save({"stray.weight": torch.ones(2)}, "md2.torch")
        with pytest.raises(ValueError, match="finetuned load failed"):
            tconvert.load_finetuned(to_param_tree(jp), "md2.torch")


# every knob that once raised, with the overrides that exercise it
PORTED = {"eval.enabled=true": ["eval.batch_videos=2"],
          "visualization.enabled=true": [
              "visualization.train_every_n_steps=1"],
          "trainer.devices=2": ["data.batch_size=2"],
          "trainer.distributed.enabled=true": [],
          "model.use_activation_checkpoint=true": []}


@pytest.mark.parametrize("override,item", [
    ("eval.enabled=true", 7), ("visualization.enabled=true", 9),
    ("trainer.devices=2", 8), ("trainer.distributed.enabled=true", 8),
    ("model.use_activation_checkpoint=true", 4)])
def test_cli_runs_every_knob_that_once_raised(override, item, tmp_path,
                                              monkeypatch):
    """Each knob that raised ``NotImplementedError`` here until its ROADMAP
    queue 1 item was ported (item 7, eval; item 4, remat; item 8, data
    parallel; item 9, visualization) runs one train step on the CPU (64 px, T=2): item 7 with the grouped post-fit eval
    (``eval.batch_videos=2``, the two clips of one shape form one lockstep
    group), item 9 writing the step's GIF, item 8 as two gloo ranks
    (``trainer.devices=2``, one clip each, rank 1 logging under
    ``proc1/``) and as a world of one under torchrun's variables
    (``trainer.distributed.enabled=true``), item 4 with the
    rematerialised frame loop."""
    import train_torch
    from sam2_video_tpu_torch.parallel import dist as tdist

    data = make_synthetic_dataset(tmp_path / "ds", num_videos=2,
                                  frames_per_video=2, image_hw=(96, 128),
                                  num_categories=2)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    if override == "trainer.distributed.enabled=true":
        for k, v in tdist.rank_env(0, 1, tdist.free_port()).items():
            monkeypatch.setenv(k, v)
    off = [o for o in ("eval.enabled=false", "visualization.enabled=false")
           if o.split("=")[0] != override.split("=")[0]]
    run_dir, result = train_torch.run(off + [
        "device=cpu", f"data.train_path={data}", f"data.val_path={data}",
        "data.image_size=64", "data.num_categories=2",
        "data.video_clip_length=2", "data.stride=2", "data.batch_size=1",
        "model.compute_dtype=float32", "model.max_objects=4",
        "trainer.max_epochs=1", "trainer.limit_train_batches=1",
        "trainer.limit_val_batches=0", "trainer.log_every_n_steps=1",
        "trainer.enable_checkpointing=false", override] + PORTED[override])
    (rec,) = _log(tmp_path / run_dir)
    assert rec["step"] == 1 and np.isfinite(rec["train/total_loss"])
    assert not torch.distributed.is_initialized()
    if override == "trainer.devices=2":
        assert result is None
        assert (tmp_path / run_dir / "proc1" / "training.log").exists()
    else:
        assert result.state.step == 1
    if item == 7:
        assert (tmp_path / run_dir / "eval" / "metrics.json").exists()
    if item == 9:
        assert (tmp_path / run_dir / "viz" / "step000001.gif").exists()


def test_cli_needs_a_card_unless_told_cpu(monkeypatch):
    import train_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cpu"):
        train_torch.main(["eval.enabled=false",
                          "visualization.enabled=false"])


def _log(run_dir: Path) -> list:
    return [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]


def _run_dir(cwd: Path) -> Path:
    runs = sorted(cwd.glob("outputs/*/*"))
    assert len(runs) == 1, runs
    return runs[0]


@pytest.mark.parametrize("validations", [1, 2])
def test_train_cli_matches_jax(jp, tmp_path, monkeypatch, validations):
    """The slice end to end. Each run works in a directory of its own, so
    the outputs/<date>/<time> folders cannot collide. The JAX Hiera MLP's
    GELU is made exact (as in the models test). With one validation the
    best checkpoint is ``last``; with two (after each step) the first is
    the best, and both packages' resumed runs start again from it."""
    exact = jax.nn.gelu
    monkeypatch.setattr(jax.nn, "gelu",
                        lambda x, approximate=True: exact(x,
                                                          approximate=False))
    data = make_synthetic_dataset(tmp_path / "ds", num_videos=1,
                                  frames_per_video=4, image_hw=(96, 128),
                                  num_categories=2)
    jckpt.save_params_npz(jp, tmp_path / "w.npz")
    common = [f"data.train_path={data}", f"data.val_path={data}",
              "data.image_size=64", "data.num_categories=2",
              "data.video_clip_length=2", "data.stride=2",
              "data.batch_size=1", f"model.checkpoint_path={tmp_path}/w.npz",
              "model.compute_dtype=float32", "model.max_objects=4",
              "trainer.max_epochs=1", "trainer.limit_train_batches=2",
              "trainer.limit_val_batches=1", "trainer.log_every_n_steps=1",
              "scheduler.enabled=false", "visualization.enabled=false",
              "eval.enabled=false"]
    if validations == 2:
        common.append("trainer.val_check_interval=0.5")
    import train
    import train_torch

    runs = ["jax", "port", "resume"] + (["jax_resume"] if validations == 2
                                        else [])
    logs, results = {}, {}
    for name in runs:
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        first = _run_dir(tmp_path / ("jax" if name == "jax_resume"
                                     else "port")) if "resume" in name \
            else None
        resume = ([f"trainer.resume_from={first}/checkpoints"] if first
                  else [])
        if name.startswith("jax"):
            assert train.main(common + resume) == 0
        else:
            results[name] = train_torch.run(common + resume + ["device=cpu"])
            assert results[name][0].resolve() == _run_dir(cwd).resolve()
        logs[name] = _log(_run_dir(cwd))
        assert (_run_dir(cwd) / "checkpoints" / "last").is_dir()

    def records(log):
        return [(r["split"], r["step"]) for r in log]

    def assert_logs_agree(got_log, want_log):
        assert records(got_log) == records(want_log)
        for got, want in zip(got_log, want_log):
            keys = [k for k in want if k.startswith(("train/", "val/"))]
            assert sorted(keys) == sorted(
                k for k in got if k.startswith(("train/", "val/")))
            for k in keys:
                assert abs(got[k] - want[k]) <= LOSS_RTOL * max(
                    abs(want[k]), 1e-6), k

    assert_logs_agree(logs["port"], logs["jax"])
    run_dir, fitted = results["port"]
    run_dir = tmp_path / "port" / run_dir
    assert (run_dir / "config.json").exists()
    assert (run_dir / "training.log").exists()
    assert json.loads((run_dir / "summary.json").read_text())[
        "best_val_loss"] == fitted.best_val
    ckpts = tckpt.Checkpointer(run_dir / "checkpoints")
    saved = ckpts.restore(run_dir / "checkpoints" / "last")
    assert saved["step"] == fitted.state.step == 2
    _assert_trees_equal(dict(saved["params"].named_parameters()),
                        dict(fitted.state.params.named_parameters()))
    _assert_trees_equal(_opt_fields(saved["opt_state"]),
                        _opt_fields(fitted.state.opt_state))
    steps1 = [r["step"] for r in logs["port"] if r["split"] == "train"]
    steps2 = [r["step"] for r in logs["resume"] if r["split"] == "train"]
    if validations == 1:
        assert records(logs["port"]) == [("train", 1), ("train", 2),
                                         ("val", 2)]
        # tests/test_resume.py's condition for the JAX CLI
        assert steps2 == [3, 4] and min(steps2) > max(steps1) - 1
        assert results["resume"][1].state.step == 4
    else:
        assert records(logs["port"]) == [("train", 1), ("val", 1),
                                         ("train", 2), ("val", 2)]
        vals = [r["val/total_loss"] for r in logs["port"]
                if r["split"] == "val"]
        assert vals[0] < vals[1], "the case needs best != last"
        assert ckpts.best_path.name == "step00000001"
        assert_logs_agree(logs["resume"], logs["jax_resume"])
        assert steps2 == [2, 3]
        assert results["resume"][1].state.step == 3
