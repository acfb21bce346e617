"""How ``chip_smoke.py`` holds a bf16 train step against a float32 one
(its train_cpu phase and the presets phase's card-vs-CPU step), on the
CPU, with the port's plain versions standing in for the card's kernels:

- ``synthetic_params(only_constant=True)`` gives the noise of
  ``synthetic_params`` (the same draws) to the parameters that ``init``
  sets to one constant, and leaves every other one at ``init``'s value;
- ``ops/common.relu_decisions``: a run that takes the decisions it
  recorded repeats itself bit for bit, values and gradients; ReLUs that do
  not match the list in count or shape raise; the blocks do not nest;
- the comparison: one all-trainable step (T=3, O=4, C=2, B=1, point
  prompts, 128 px) in bf16 that takes the float32 step's ReLU decisions,
  from ``synthetic_params(only_constant=True)``, has every top-level
  gradient within COND_TOL (relative L2) of the float32 step's, at tiny,
  small and large; at ``synthetic_params`` and with each run deciding for
  itself, the same bf16 step lands several times farther away
  (``FREE_FACTOR``): the switching ReLU units, not the kernels' rounding,
  are what a flat limit there would measure.
"""

import copy
import dataclasses

import pytest
import torch

from sam2_video_tpu_torch.data.synthetic import example_clip, synthetic_params
from sam2_video_tpu_torch.models import sam2 as sam2_mod
from sam2_video_tpu_torch.models.video_model import VideoModelConfig
from sam2_video_tpu_torch.ops.common import relu_decisions
from sam2_video_tpu_torch.training.loop import TrainState, make_train_step
from sam2_video_tpu_torch.training.losses import LossConfig
from sam2_video_tpu_torch.training.optimizer import make_optimizer

IMG, T, O, C, B = 128, 3, 4, 2, 1
ALL = ["memory_attention", "memory_encoder", "mask_decoder",
       "prompt_encoder", "image_encoder"]
# chip_smoke.py's limits are 0.1 (0.2 for a bare embedding); the
# conditioned comparison must leave them most of their room
COND_TOL = 0.05
# the free-deciding bf16 step's largest module distance is at least this
# many times the conditioned one's
FREE_FACTOR = 3.0


def _cfg(name: str, dtype: str = "float32"):
    return sam2_mod.SAM2Config(backbone=name, image_size=IMG,
                               compute_dtype=dtype,
                               use_activation_checkpoint=False)


def _step(cfg, params):
    """(loss, {name: gradient}) of one all-trainable step on the CPU."""
    tx = make_optimizer(params, {"lr": 1e-4, "type": "AdamW"},
                        {"enabled": False}, total_steps=1000,
                        trainable_modules=ALL)
    step = make_train_step(VideoModelConfig(sam2=cfg, prompt_type="point"),
                           LossConfig(), tx, trainable_modules=ALL,
                           device="cpu")
    _, m, grads = step.with_grads(TrainState.create(params, tx),
                                  example_clip(IMG, T=T, O=O, C=C, B=B))
    return float(m["total_loss"]), {n: g.detach().float()
                                    for n, g in grads.items()}


def _rel_by_top(got: dict, want: dict) -> dict:
    """top-level entry -> relative L2 of its gradients (nonzero ones)."""
    out = {}
    for top in {n.split(".")[0] for n in want}:
        names = [n for n in want if n.split(".")[0] == top]
        a = torch.cat([got[n].flatten() for n in names])
        b = torch.cat([want[n].flatten() for n in names])
        if float(b.norm()) > 0:
            out[top] = float((a - b).norm() / b.norm())
    return out


def test_only_constant_moves_only_constant_parameters():
    cfg = _cfg("tiny")
    init = dict(sam2_mod.init(cfg, seed=0).named_parameters())
    full = dict(synthetic_params(cfg, 0).named_parameters())
    only = dict(synthetic_params(cfg, 0, only_constant=True)
                .named_parameters())
    adjusted = {n for n in init if ".fuser." in n and n.endswith("gamma")}
    adjusted.add("sam_mask_decoder.pred_obj_score_head.layers.2.bias")
    moved = 0
    for n, t in init.items():
        if n in adjusted:
            assert torch.equal(only[n], full[n]), n
        elif bool((t == t.flatten()[0]).all()):
            assert torch.equal(only[n], full[n]), n
            moved += 1
        else:
            assert torch.equal(only[n], t), n
    assert moved > 0


def test_relu_decisions_repeat_a_run():
    cfg = _cfg("tiny")
    params = synthetic_params(cfg, 0)
    with relu_decisions() as decisions:
        loss, grads = _step(cfg, copy.deepcopy(params))
    assert decisions and all(d.dtype == torch.bool for d in decisions)
    with relu_decisions(decisions):
        again, grads_again = _step(cfg, copy.deepcopy(params))
    assert again == loss
    for n, g in grads.items():
        assert torch.equal(grads_again[n], g), n


@pytest.mark.parametrize("fault", ["short", "long", "shape", "nested"])
def test_relu_decisions_raise_on_a_mismatch(fault):
    from sam2_video_tpu_torch.ops import common as nn

    p = {"layers": {"0": {"weight": torch.randn(5, 3)},
                    "1": {"weight": torch.randn(2, 5)}}}
    x = torch.randn(4, 3)
    with relu_decisions() as rec:
        nn.mlp(p, x)
        nn.mlp(p, x)
    take = {"short": rec[:1], "long": rec + rec[:1],
            "shape": [rec[0][:2], rec[1]], "nested": rec}[fault]
    with pytest.raises(RuntimeError, match="relu_decisions"):
        with relu_decisions(take):
            if fault == "nested":
                with relu_decisions():
                    pass
            nn.mlp(p, x)
            nn.mlp(p, x)


@pytest.mark.parametrize("name", ["tiny", "small", "large"])
def test_shared_decisions_condition_the_step(name):
    cfg, low = _cfg(name), _cfg(name, "bfloat16")
    params = synthetic_params(cfg, 0, only_constant=True)
    with relu_decisions() as decisions:
        _, want = _step(cfg, copy.deepcopy(params))
    with relu_decisions(decisions):
        _, got = _step(low, copy.deepcopy(params))
    shared = _rel_by_top(got, want)
    assert max(shared.values()) <= COND_TOL, shared

    params = synthetic_params(cfg, 0)
    _, want = _step(cfg, copy.deepcopy(params))
    _, got = _step(low, params)
    free = _rel_by_top(got, want)
    assert max(free.values()) >= FREE_FACTOR * max(shared.values()), (
        free, shared)
