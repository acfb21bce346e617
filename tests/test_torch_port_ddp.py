"""Data-parallel training of the port (``parallel/dist.py``, the process
group in ``training/loop.py``, ``train_torch.py``'s launcher and
``parallel/dryrun.py``) held against the JAX package's mesh on the CPU:

- two gloo ranks in subprocesses (``tests/_ddp_worker.py``, torchrun's
  variables), 3 steps of SAM2-tiny at 64 px in float32, memory attention
  trainable, each rank loading its half of a global batch of 4 clips of
  ``tests/_mp_common.py``'s index-deterministic dataset: the losses and
  the updated parameters against JAX's step on a 2-device mesh
  (``make_mesh(num_data=2)`` over the conftest's CPU devices) at the same
  global batches and weights (``from_jax_params``), within
  ``test_torch_port_train.py``'s VAL / GRAD of max(1, |JAX|); the losses
  against the port's single-process step at the global batch within 1e-5
  relative; the two ranks' parameters bit-equal;
- ``maybe_initialize_distributed``: off without a flag or torchrun's
  variables, the ``ValueError`` of an address without the process count
  and rank, idempotence;
- the global batch raised to the device count with ``train.py``'s
  warning, and the divisibility check;
- the dry run at 2 ranks on the CPU;
- ``train_torch.py trainer.devices=2 data.batch_size=2 device=cpu``
  against ``train.py trainer.devices=2 data.batch_size=2`` on one
  ``make_synthetic_dataset`` tree at 64 px in float32 with centre-point
  prompts (no random draw, so the ranks' prompts are the single process's):
  the train and validation losses within ``test_torch_port_fit.py``'s
  LOSS_RTOL; rank 1's ``proc1/`` without checkpoints, rank 0's
  ``eval/metrics.json``.

Adam moves a leaf by about lr a step, so where a float32 gradient's sign
is noise the two packages can move it up to 2 lr apart a step: at lr 3e-5
three steps stay within GRAD (1.8e-4). The losses of steps 2 and 3 see the
updates.
"""

import logging
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sam2_video_tpu.data.pipeline import ClipLoader as JClipLoader
from sam2_video_tpu.data.synthetic import make_synthetic_dataset
from sam2_video_tpu.models import sam2 as jsam2
from sam2_video_tpu.models.video_model import \
    VideoModelConfig as JVideoModelConfig
from sam2_video_tpu.parallel import mesh as jmesh
from sam2_video_tpu.training import checkpoint as jckpt
from sam2_video_tpu.training import loop as jloop
from sam2_video_tpu.training import optimizer as jopt
from sam2_video_tpu.training.losses import LossConfig as JLossConfig
from sam2_video_tpu_torch.config import load_config
from sam2_video_tpu_torch.convert import to_param_tree
from sam2_video_tpu_torch.parallel import dist as tdist
from sam2_video_tpu_torch.parallel import dryrun
from tests import _ddp_worker as W
from tests._mp_common import SEED, STEPS, DeterministicClipDataset
from test_torch_port_fit import LOSS_RTOL, _log
from test_torch_port_models import jax_tree, one_torch_thread  # noqa: F401
from test_torch_port_train import FAST_COMPILE, GRAD, VAL

REPO = Path(__file__).resolve().parents[1]
SINGLE_RTOL = 1e-5      # two ranks against one process: float32 sums


@pytest.fixture
def exact_gelu(monkeypatch):
    """The JAX Hiera MLP's GELU made exact-erf, as the port's."""
    exact = jax.nn.gelu
    monkeypatch.setattr(jax.nn, "gelu",
                        lambda x, approximate=True: exact(x,
                                                          approximate=False))


def _spawn_ranks(world: int, args: list, tmp_path: Path) -> list:
    port = tdist.free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   **tdist.rank_env(r, world, port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests._ddp_worker", *args,
             str(tmp_path / f"rank{r}.pt")], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _jax_mesh_run(jp):
    """JAX's train step on a 2-device mesh, STEPS global batches."""
    mesh = jmesh.make_mesh(num_data=2)
    tx = jopt.make_optimizer(jp, {"lr": W.LR, "type": "AdamW"},
                             {"enabled": False}, total_steps=STEPS,
                             trainable_modules=W.TRAINABLE)
    state = jmesh.replicate(mesh, jloop.TrainState.create(jp, tx))
    step = jloop.make_train_step(
        JVideoModelConfig(sam2=jsam2.SAM2Config(**W.KW)), JLossConfig(), tx,
        mesh=mesh, trainable_modules=W.TRAINABLE)
    loader = JClipLoader(DeterministicClipDataset(),
                         batch_size=W.GLOBAL_BATCH, shuffle=True, seed=SEED,
                         num_workers=1)
    losses, compiled = [], None
    for _, batch in zip(range(STEPS), loader):
        batch = jmesh.shard_batch(mesh, batch)
        if compiled is None:
            compiled = step.lower(state, batch).compile(FAST_COMPILE)
        state, metrics = compiled(state, batch)
        losses.append(float(metrics["total_loss"]))
    trained = dict(to_param_tree(jax.tree.map(np.asarray, state.params))
                   .named_parameters())
    return losses, trained


def test_two_gloo_ranks_match_jax_mesh_and_one_process(tmp_path,
                                                       exact_gelu):
    jp = jax_tree(W.KW, seed=5)
    jckpt.save_params_npz(jp, tmp_path / "w.npz")
    procs = _spawn_ranks(2, [str(tmp_path / "w.npz")], tmp_path)
    try:
        jlosses, jtrained = _jax_mesh_run(jp)
        losses1, trained1 = W.run_steps(
            to_param_tree(jax.tree.map(np.array, jp)),
            W.make_loader(W.GLOBAL_BATCH, 0, 1), STEPS)
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    assert [(r["rank"], r["world"], r["backend"]) for r in ranks] == [
        (0, 2, "gloo"), (1, 2, "gloo")]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for name, t in ranks[0]["params"].items():
        assert torch.equal(t, ranks[1]["params"][name]), name

    losses = ranks[0]["losses"]
    assert len(losses) == STEPS
    for got, single, want in zip(losses, losses1, jlosses):
        assert abs(got - want) <= VAL * max(1.0, abs(want)), (got, want)
        assert abs(got - single) <= SINGLE_RTOL * abs(single), (got, single)
    before = dict(to_param_tree(jax.tree.map(np.array, jp))
                  .named_parameters())
    moved = 0
    for name, t in ranks[0]["params"].items():
        want = jtrained[name].detach().numpy().astype(np.float64)
        err = float(np.abs(t.double().numpy() - want).max())
        assert err <= GRAD * max(1.0, float(np.abs(want).max())), (name, err)
        assert torch.allclose(t, trained1[name], rtol=0,
                              atol=GRAD * max(1.0, float(
                                  trained1[name].abs().max()))), name
        moved += int(not torch.equal(t, before[name]))
    assert moved > 0


def test_maybe_initialize_distributed(monkeypatch):
    for k in tdist.rank_env(0, 1, 0):
        monkeypatch.delenv(k, raising=False)
    assert tdist.maybe_initialize_distributed(None, "cpu") is False
    assert tdist.maybe_initialize_distributed(
        {"enabled": False, "coordinator_address": "localhost:99"},
        "cpu") is False
    with pytest.raises(ValueError, match="num_processes and process_id"):
        tdist.maybe_initialize_distributed(
            {"enabled": True, "coordinator_address": "localhost:1234"}, "cpu")
    with pytest.raises(ValueError, match="torchrun's environment"):
        tdist.maybe_initialize_distributed({"enabled": True}, "cpu")
    assert not torch.distributed.is_initialized()
    for k, v in tdist.rank_env(0, 1, tdist.free_port()).items():
        monkeypatch.setenv(k, v)
    try:
        assert tdist.maybe_initialize_distributed({}, "cpu") is True
        assert tdist.maybe_initialize_distributed({"enabled": True},
                                                  "cpu") is True
        assert (tdist.rank(), tdist.world_size(), tdist.is_main()) == (
            0, 1, True)
        assert torch.distributed.get_backend() == "gloo"
        x = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.tensor(2.5)}
        y = tdist.all_reduce_mean(x)
        assert all(torch.equal(x[k], y[k]) for k in x)
    finally:
        tdist.destroy()
    assert not torch.distributed.is_initialized()


def test_global_batch_raised_to_devices(caplog):
    import train_torch

    log = logging.getLogger("test_global_batch")
    cfg = load_config("config", ["trainer.devices=2", "data.batch_size=1"])
    with caplog.at_level(logging.WARNING):
        assert train_torch.global_batch(cfg, 1, False, log) == 2
    assert "raising the global batch to 2 (1 clip/device)" in caplog.text
    cfg = load_config("config", ["data.batch_size=3"])
    with pytest.raises(ValueError, match="divisible by the process count 2"):
        train_torch.global_batch(cfg, 2, True, log)
    assert train_torch.global_batch(cfg, 1, False, log) == 3


def test_dryrun_two_ranks_on_the_cpu(capfd, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert dryrun.main(["--ranks", "2", "--device", "cpu"]) == 0
    out = capfd.readouterr().out
    assert "dryrun(2 ranks, gloo, cpu)" in out and "(decreasing)" in out


def _run_dir(cwd: Path) -> Path:
    runs = sorted(p for p in cwd.glob("outputs/*/*") if p.is_dir())
    assert len(runs) == 1, runs
    return runs[0]


def test_train_cli_two_devices_matches_jax(tmp_path, monkeypatch,
                                           exact_gelu):
    """Both CLIs with trainer.devices=2: JAX's one process over a 2-device
    mesh, the port's two gloo ranks; two train steps of 2 clips, then one
    validation batch of 2."""
    import train
    import train_torch

    data = make_synthetic_dataset(tmp_path / "ds", num_videos=2,
                                  frames_per_video=4, image_hw=(96, 128),
                                  num_categories=2)
    jckpt.save_params_npz(jax_tree(W.KW, seed=5), tmp_path / "w.npz")
    common = [f"data.train_path={data}", f"data.val_path={data}",
              "data.image_size=64", "data.num_categories=2",
              "data.video_clip_length=2", "data.stride=2",
              "data.batch_size=2", "trainer.devices=2",
              f"model.checkpoint_path={tmp_path}/w.npz",
              "model.compute_dtype=float32", "model.max_objects=4",
              "model.num_pos_points=1", "trainer.max_epochs=1",
              "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
              "trainer.log_every_n_steps=1", "scheduler.enabled=false",
              "visualization.enabled=false"]
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    assert train.main(common + ["eval.enabled=false"]) == 0
    want = _log(_run_dir(tmp_path / "jax"))

    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    run_dir, result = train_torch.run(common + ["device=cpu"])
    assert result is None
    run_dir = tmp_path / "port" / run_dir
    assert run_dir == _run_dir(tmp_path / "port")
    got = _log(run_dir)
    assert [(r["split"], r["step"]) for r in got] == [
        (r["split"], r["step"]) for r in want] == [
        ("train", 1), ("train", 2), ("val", 2)]
    for g, w in zip(got, want):
        for k in w:
            if k.startswith(("train/", "val/")):
                assert abs(g[k] - w[k]) <= LOSS_RTOL * max(abs(w[k]),
                                                           1e-6), k
    assert (run_dir / "checkpoints" / "last").is_dir()
    assert (run_dir / "eval" / "metrics.json").exists()
    proc1 = run_dir / "proc1"
    assert (proc1 / "training.log").exists()
    assert not (proc1 / "checkpoints").exists()
    assert not (proc1 / "metrics.jsonl").exists()
    assert not (proc1 / "eval").exists()
