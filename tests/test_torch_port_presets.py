"""SAM2-small, SAM2-base+ and SAM2-large of the PyTorch port held against
the JAX package on the CPU, the whole model at each preset's published
widths and depths: image_size=128, float32, one JAX parameter tree per
preset (``jax_tree``: the port's seeded init through the JAX package's
strict converter) carried over with ``from_jax_params``, inputs from a
numpy seed, the JAX Hiera MLP with the exact erf GELU as the port's (see
``tests/test_torch_port_models.py`` ``exact_gelu``).

- the port's parameter names and shapes are the flattened JAX tree's, and
  ``from_jax_params`` carries every value across unchanged;
- ``forward_image``: every FPN level (the neck at 768-, 896- and 1152-
  channel inputs; base+'s 14x14 background pos-embed resized bicubically)
  and ``vision_pos_enc``;
- ``forward_train`` through the train step (T=2, O=2, C=2, B=1, point
  prompts): memory-only at each preset (the loss and the memory modules'
  gradients), all-trainable at small and base+ (the loss and every
  gradient leaf; large's trainable trunk is held block by block in
  ``tests/test_torch_port_hiera_bwd.py``);
- base+'s ``VideoPredictor`` on 3 frames and 2 objects.

The JAX reference of a step is the JAX package's ``batched_loss_fn``
under ``jax.value_and_grad`` over the trainable subtrees, as its
``make_train_step`` computes them (``partition_params``, the frozen part
under ``stop_gradient``, the same trunk routing), without the optimizer
update, whose trace is a third of the step's: one compile per preset gives
the loss and the gradients. The references are traced and compiled on
three worker threads from the first test on, while the port's side runs. Small's and base+'s memory-only gradients are
held to their all-trainable reference's memory-module entries: a leaf's
gradient does not depend on which other leaves are differentiated. Compiled
without XLA's expensive LLVM passes (``FAST_COMPILE``).

Tolerances, as the tiny tests state them: FPN levels 5e-4 (``DEEP_TOL``),
losses 1e-4 and gradients 2e-4 of max(1, max|JAX|), a q-pool block's
near-tied 2x2 cells allowed to route a few trunk gradient elements apart
(``test_torch_port_train_all._close``); predictor logits 2e-3 (float16 on
the host), scores 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_clip
from sam2_video_tpu.eval import predictor as jpred_mod
from sam2_video_tpu.models import sam2 as jsam2
from sam2_video_tpu.models.video_model import \
    VideoModelConfig as JVideoModelConfig
from sam2_video_tpu.training import loop as jloop
from sam2_video_tpu.training.losses import LossConfig as JLossConfig
from sam2_video_tpu.training.optimizer import partition_params
from sam2_video_tpu_torch.convert import (flatten, from_jax_params,
                                          to_param_tree)
from sam2_video_tpu_torch.data.synthetic import example_clip
from sam2_video_tpu_torch.eval.predictor import VideoPredictor
from sam2_video_tpu_torch.models import sam2 as tsam2
from sam2_video_tpu_torch.models.video_model import VideoModelConfig
from sam2_video_tpu_torch.training import loop as tloop
from sam2_video_tpu_torch.training import optimizer as topt
from sam2_video_tpu_torch.training.losses import LossConfig
from test_torch_port_models import (DEEP_TOL, MOD_TOL,  # noqa: F401
                                    jax_tree, one_torch_thread)
from test_torch_port_predictor import POINTS, _run, _video
from test_torch_port_train import FAST_COMPILE
from test_torch_port_train_all import GRAD, VAL, _close

IMG, T, O, C, B = 128, 2, 2, 2, 1
PRESETS = ("small", "base_plus", "large")
MEMORY = ["memory_attention", "memory_encoder"]
ALL = MEMORY + ["mask_decoder", "prompt_encoder", "image_encoder"]
SEED = 9
KW = dict(image_size=IMG, compute_dtype="float32", use_flash_attention=True,
          use_activation_checkpoint=False)
LOSSES = ("total_loss", "loss_mask", "loss_dice", "loss_iou")


def _kw(name: str) -> dict:
    return {**KW, "backbone": name}


@pytest.fixture(scope="module", autouse=True)
def exact_gelu_module():
    """The JAX Hiera MLP with the exact erf GELU for the whole module: the
    JAX references below are traced on worker threads, outside any one
    test's ``exact_gelu``."""
    exact = jax.nn.gelu
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.nn, "gelu", lambda x, approximate=True: exact(
            x, approximate=False))
        yield


@pytest.fixture(scope="module")
def trees(exact_gelu_module):
    """name -> the JAX parameter tree of each preset."""
    return {name: jax_tree(_kw(name), seed=SEED) for name in PRESETS}


@pytest.fixture(scope="module")
def jax_refs(trees):
    """The compiled JAX references, traced and compiled on worker threads
    (XLA's compile leaves the interpreter free, so the three presets'
    compiles overlap each other and the port's side): ("image", name) ->
    forward_image's outputs, ("step", name) -> ``_jax_step``'s. Each test
    waits for its own."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=3)
    jobs = {("step", n): pool.submit(_jax_step, trees[n],
                                     MEMORY if n == "large" else ALL, n)
            for n in PRESETS}
    jobs.update({("image", n): pool.submit(_jax_image, trees[n], n)
                 for n in PRESETS})
    yield jobs
    pool.shutdown(wait=True)


def _frames() -> np.ndarray:
    return np.random.default_rng(2).integers(0, 256, (2, IMG, IMG, 3),
                                             dtype=np.uint8)


def _jax_image(jp: dict, name: str) -> dict:
    cfg = jsam2.SAM2Config(**_kw(name))
    img = jnp.asarray(_frames())
    fn = jax.jit(lambda p, v: jsam2.forward_image(p, cfg, v,
                                                  allow_fused=False))
    return jax.tree.map(np.asarray,
                        fn.lower(jp, img).compile(FAST_COMPILE)(jp, img))


def _jax_step(jp: dict, trainable, name: str) -> tuple[dict, dict]:
    """(metrics, gradients by the port's dotted names) of the JAX package's
    loss on ``_example_clip`` at preset ``name``, differentiated over
    ``trainable`` as its ``make_train_step`` does."""
    cfg = jsam2.SAM2Config(**_kw(name))
    # make_train_step's routing of the trunk: the forward-only fused block
    # for a frozen encoder, the custom-VJP one for a trainable encoder (on
    # the CPU both fall back to the XLA block)
    flag = ("fused_backbone_vjp" if "image_encoder" in trainable
            else "fused_backbone")
    cfg = dataclasses.replace(cfg, **{flag: True})
    loss_fn = jloop.batched_loss_fn(JVideoModelConfig(sam2=cfg),
                                    JLossConfig(), training=True)

    def grads(params, batch):
        train_p, frozen_p = partition_params(params, trainable)
        frozen_p = jax.lax.stop_gradient(frozen_p)
        (_, metrics), g = jax.value_and_grad(
            lambda tp: loss_fn({**frozen_p, **tp}, batch),
            has_aux=True)(train_p)
        return metrics, g

    args = (jp, _example_clip(IMG, T=T, O=O, C=C, B=B))
    metrics, g = jax.jit(grads).lower(*args).compile(FAST_COMPILE)(*args)
    return ({k: float(v) for k, v in metrics.items()},
            dict(to_param_tree(jax.tree.map(np.asarray, g))
                 .named_parameters()))


def _port_step(jp: dict, name: str, trainable):
    """The port's train step at preset ``name`` (float32, CPU) from the JAX
    tree ``jp``: (metrics, gradients by name)."""
    tcfg = tsam2.SAM2Config(**_kw(name))
    params = to_param_tree(jax.tree.map(np.array, jp))
    tx = topt.make_optimizer(params, {"lr": 1e-4, "type": "AdamW"},
                             {"enabled": False}, total_steps=1000,
                             trainable_modules=trainable)
    step = tloop.make_train_step(VideoModelConfig(sam2=tcfg), LossConfig(),
                                 tx, trainable_modules=trainable,
                                 device="cpu")
    _, metrics, grads = step.with_grads(
        tloop.TrainState.create(params, tx),
        example_clip(IMG, T=T, O=O, C=C, B=B))
    return metrics, grads


@pytest.mark.parametrize("name", PRESETS)
def test_parameters_are_the_jax_tree(trees, jax_refs, name):
    """Names and shapes of the port's init equal the flattened JAX tree's
    (in the port's layout), and the tree carried back by
    ``from_jax_params`` holds the port's values bit for bit."""
    jp = trees[name]
    template = jax.eval_shape(lambda k: jsam2.init(k, jsam2.SAM2Config(
        **_kw(name))), jax.random.PRNGKey(0))
    want = {n: tuple(s.shape) for n, s in flatten(template).items()}
    assert {n: a.shape for n, a in flatten(jp).items()} == want
    port = tsam2.init(tsam2.SAM2Config(**_kw(name)), seed=SEED).state_dict()
    carried = from_jax_params(jp)
    assert sorted(carried) == sorted(port) == sorted(want)
    for n, t in port.items():
        assert carried[n].shape == t.shape, n
        assert torch.equal(carried[n], t), n
    trunk = tsam2.SAM2Config(backbone=name).trunk_config
    blocks = {n.split(".")[3] for n in port
              if n.startswith("image_encoder.trunk.blocks.")}
    assert len(blocks) == sum(trunk.stages)


@pytest.mark.parametrize("name", PRESETS)
def test_forward_image_matches_jax(trees, jax_refs, name):
    """uint8 frames through the preset's trunk, the FPN neck at its
    channel widths and conv_s0/conv_s1; base+ resizes its 14x14
    background pos-embed to the 32x32 grid."""
    got = tsam2.forward_image(to_param_tree(trees[name]),
                              tsam2.SAM2Config(**_kw(name)),
                              torch.from_numpy(_frames()))
    want = jax_refs[("image", name)].result()
    assert len(got["backbone_fpn"]) == len(want["backbone_fpn"]) == 3
    for a, b in zip(got["backbone_fpn"], want["backbone_fpn"]):
        np.testing.assert_allclose(a.numpy(), b, **DEEP_TOL)
    for a, b in zip(got["vision_pos_enc"], want["vision_pos_enc"]):
        np.testing.assert_allclose(a.numpy(), b, **MOD_TOL)


@pytest.mark.parametrize("name", PRESETS)
def test_memory_only_step_matches_jax(trees, jax_refs, name):
    """The memory-only step (trainable memory attention and memory
    encoder, the trunk frozen): the losses and every gradient it returns,
    which are the memory modules' and the bare embeddings'."""
    metrics, grads = _port_step(trees[name], name, MEMORY)
    jm, jg = jax_refs[("step", name)].result()
    for k in LOSSES:
        _close(metrics[k], jm[k], VAL, k)
    frozen = ("image_encoder", "sam_mask_decoder", "sam_prompt_encoder",
              "obj_ptr_proj", "obj_ptr_tpos_proj")
    assert set(grads) == {n for n in jg if n.split(".")[0] not in frozen}
    assert {"memory_attention", "memory_encoder"} <= {
        n.split(".")[0] for n in grads}
    for n, g in grads.items():
        _close(g, jg[n], GRAD, n)
    assert any(g.any() for n, g in grads.items()
               if n.startswith("memory_attention."))


@pytest.mark.parametrize("name", ("small", "base_plus"))
def test_all_trainable_step_matches_jax(trees, jax_refs, name):
    """The all-trainable step (memory attention, memory encoder, mask
    decoder, prompt encoder, image encoder): the losses and every gradient
    leaf, the trunk's blocks at every depth included."""
    metrics, grads = _port_step(trees[name], name, ALL)
    jm, jg = jax_refs[("step", name)].result()
    for k in LOSSES:
        _close(metrics[k], jm[k], VAL, k)
    assert set(grads) == set(jg)
    for n, g in grads.items():
        _close(g, jg[n], GRAD, n, pool_flips=n.startswith("image_encoder."))
    trunk = [n for n in grads if n.startswith("image_encoder.trunk.")]
    assert trunk and all(grads[n].any() for n in trunk), [
        n for n in trunk if not grads[n].any()]


def test_base_plus_predictor_matches_jax(trees, jax_refs):
    """Base+'s streaming predictor, 2 objects point-prompted on frame 0 of
    3 frames, against the JAX VideoPredictor on the same tree (objects
    present on every frame: the object-score head's last bias at 10)."""
    for job in jax_refs.values():       # the JAX predictor's compiles alone
        job.result()
    kw = {**_kw("base_plus"), "use_flash_attention": False}
    jcfg, tcfg = jsam2.SAM2Config(**kw), tsam2.SAM2Config(**kw)
    p = jax.tree.map(np.array, trees["base_plus"])
    for k in ("maskmem_tpos_enc", "no_obj_ptr", "no_obj_embed_spatial"):
        p[k] = p[k] * 25.0
    p["sam_mask_decoder"]["pred_obj_score_head"]["layers"]["2"]["bias"] = \
        np.full((1,), 10.0, np.float32)
    frames = _video()[:3]
    key = ("seq", jcfg, O, 1)
    jpred_mod._JIT_BUNDLES.pop(key, None)
    try:
        _, want = _run(jpred_mod.VideoPredictor(p, jcfg, max_objects=O),
                       frames)
    finally:
        jpred_mod._JIT_BUNDLES.pop(key, None)
    _, got = _run(VideoPredictor(p, tcfg, max_objects=O, device="cpu"),
                  frames)
    assert [g[0] for g in got] == [w[0] for w in want] == [0, 1, 2]
    assert len(POINTS) == O
    for (_, ids_g, lg_g, sc_g), (_, ids_w, lg_w, sc_w) in zip(got, want):
        assert ids_g == ids_w == [0, 1]
        assert lg_g.shape == lg_w.shape == (O, 1, IMG // 4, IMG // 4)
        np.testing.assert_allclose(lg_g.astype(np.float32),
                                   lg_w.astype(np.float32),
                                   atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(sc_g, np.asarray(sc_w), atol=1e-4)
