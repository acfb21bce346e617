"""Each model module of the PyTorch port held against its JAX counterpart
on the CPU: SAM2-tiny at image_size=128 (which keeps the memory encoder's
space-to-depth geometry, 8x8 features), float32, one JAX parameter tree
(``jax_tree``) carried over with ``from_jax_params``, inputs from a numpy
seed.

GELU: the JAX package's ``mlp(activation="gelu")`` (the Hiera MLP) calls
``jax.nn.gelu`` with its default tanh approximation, while the torch SAM2
reference, the JAX TPU kernels and the port use the exact erf. The
``exact_gelu`` fixture makes the JAX side exact so that the comparison
holds the algorithm, not that difference.

Tolerances: 1e-4 (absolute and relative) for one module in float32, where
products of up to 2048 terms are summed in different orders; 5e-4 for the
whole 12-block trunk and for the SAM heads, whose upscaled mask logits
come from several stacked products.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam2_video_tpu.models import hiera as jhiera
from sam2_video_tpu.models import image_encoder as jie
from sam2_video_tpu.models import mask_decoder as jmd
from sam2_video_tpu.models import memory_attention as jma
from sam2_video_tpu.models import memory_encoder as jme
from sam2_video_tpu.models import prompt_encoder as jpenc
from sam2_video_tpu.models import sam2 as jsam2
from sam2_video_tpu.ops.position_encoding import sine_pe_2d as jsine
from sam2_video_tpu.training.convert import convert_state_dict
from sam2_video_tpu_torch.convert import to_param_tree
from sam2_video_tpu_torch.models import hiera as thiera
from sam2_video_tpu_torch.models import image_encoder as tie
from sam2_video_tpu_torch.models import mask_decoder as tmd
from sam2_video_tpu_torch.models import memory_attention as tma
from sam2_video_tpu_torch.models import memory_encoder as tme
from sam2_video_tpu_torch.models import prompt_encoder as tpenc
from sam2_video_tpu_torch.models import sam2 as tsam2
from sam2_video_tpu_torch.ops import common as tnn

IMG = 128
MOD_TOL = dict(atol=1e-4, rtol=1e-4)
DEEP_TOL = dict(atol=5e-4, rtol=5e-4)
KW = dict(image_size=IMG, compute_dtype="float32", use_flash_attention=False,
          use_activation_checkpoint=False)
JCFG = jsam2.SAM2Config(**KW)
TCFG = tsam2.SAM2Config(**KW)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes are small, and the tier-1 run shares the host's cores
    among its workers: one intra-op thread for the port's side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def exact_gelu(monkeypatch):
    exact = jax.nn.gelu
    monkeypatch.setattr(jax.nn, "gelu",
                        lambda x, approximate=True: exact(x,
                                                          approximate=False))


def jax_tree(kw: dict, seed: int) -> dict:
    """A JAX parameter tree for ``SAM2Config(**kw)``: the port's seeded init
    carried into the JAX layout by the JAX package's strict converter, so
    every name and shape is checked against a ``sam2.init`` template
    (``jax.eval_shape``). The eager ``sam2.init`` would cost ~26 s of
    per-op compiles in each test process for the same check."""
    cfg = jsam2.SAM2Config(**kw)
    shapes = jax.eval_shape(lambda k: jsam2.init(k, cfg),
                            jax.random.PRNGKey(0))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = tsam2.init(tsam2.SAM2Config(**kw), seed=seed).state_dict()
    tree, _ = convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                 template, strict=True)
    return tree


@pytest.fixture(scope="module")
def params():
    jp = jax_tree(KW, seed=3)
    # lift the constant-initialised embeddings so their wiring shows
    for k in ("maskmem_tpos_enc", "no_mem_embed", "no_obj_ptr",
              "no_obj_embed_spatial"):
        jp[k] = jp[k] * 25.0
    return jp, to_param_tree(jp)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _jit(fn, *args):
    """``fn(*args)`` compiled whole by ``jax.jit``: one compile in place of
    one per eager op, which is most of a test's time. ``fn`` closes over
    the configs and the other static arguments."""
    return jax.jit(fn)(*args)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


def _rng(seed):
    return np.random.default_rng(seed)


TRUNK = JCFG.trunk_config


def _block_inputs():
    """(block index, spec, grid) along the 128-px trunk."""
    H, out = IMG // 4, []
    for i, spec in enumerate(TRUNK.block_specs()):
        out.append((i, spec, H))
        if spec["q_pool"]:
            H //= 2
    return out


@pytest.mark.parametrize("i", range(len(TRUNK.block_specs())))
def test_hiera_block_matches_jax(params, exact_gelu, i):
    """Every block of the tiny trunk at the 128-px geometry: window sizes
    larger than the grid (pad 8 -> 14), q-pool with an odd pooled window
    (14 -> 7, cropped), global blocks."""
    jp, tp = params
    _, spec, H = _block_inputs()[i]
    x = _rng(i).standard_normal((1, H, H, spec["dim"]))
    bj = jp["image_encoder"]["trunk"]["blocks"][str(i)]
    want = _jit(lambda b, v: jhiera._block(b, v, spec, TRUNK.q_stride),
                bj, jnp.asarray(x, jnp.float32))
    got = thiera._block(tp["image_encoder"]["trunk"]["blocks"][str(i)],
                        _t(x), spec, TRUNK.q_stride)
    _close(got, want, MOD_TOL)


def test_hiera_trunk_matches_jax(params, exact_gelu):
    jp, tp = params
    x = _rng(1).standard_normal((1, IMG, IMG, 3))
    want = _jit(lambda p, v: jhiera.apply(p, v, TRUNK),
                jp["image_encoder"]["trunk"], jnp.asarray(x, jnp.float32))
    got = thiera.apply(tp["image_encoder"]["trunk"], _t(x), TRUNK)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        _close(a, b, DEEP_TOL)


def test_forward_image_matches_jax(params, exact_gelu):
    """uint8 frames through normalisation, trunk, FPN neck (scalp=1,
    top-down levels 2, 3) and conv_s0/conv_s1."""
    jp, tp = params
    img = _rng(2).integers(0, 256, (1, IMG, IMG, 3), dtype=np.uint8)
    want = _jit(lambda p, v: jsam2.forward_image(p, JCFG, v,
                                                 allow_fused=False),
                jp, jnp.asarray(img))
    got = tsam2.forward_image(tp, TCFG, torch.from_numpy(img))
    for a, b in zip(got["backbone_fpn"], want["backbone_fpn"]):
        _close(a, b, DEEP_TOL)
    for a, b in zip(got["vision_pos_enc"], want["vision_pos_enc"]):
        _close(a, b, MOD_TOL)


def test_prompt_encoder_matches_jax(params):
    jp, tp = params
    pj, pt = jp["sam_prompt_encoder"], tp["sam_prompt_encoder"]
    cfg_j, cfg_t = JCFG.prompt_encoder_config, TCFG.prompt_encoder_config
    g = _rng(3)
    coords = g.uniform(0, IMG, (3, 2, 2)).astype(np.float32)
    labels = np.asarray([[1, 0], [2, 3], [1, -1]], np.int32)
    masks = g.standard_normal((2, IMG // 4, IMG // 4, 1))
    want = _jit(lambda p, c, lb, m: (
        jpenc.embed_points(p, cfg_j, c, lb), jpenc.embed_masks(p, m),
        jpenc.get_dense_pe(p, cfg_j), jpenc.no_mask_dense(p, cfg_j, 2)),
        pj, jnp.asarray(coords), jnp.asarray(labels),
        jnp.asarray(masks, jnp.float32))
    got = (tpenc.embed_points(pt, cfg_t, _t(coords), torch.tensor(labels)),
           tpenc.embed_masks(pt, _t(masks)), tpenc.get_dense_pe(pt, cfg_t),
           tpenc.no_mask_dense(pt, cfg_t, 2))
    for a, b in zip(got, want):
        _close(a, b, MOD_TOL)


@pytest.mark.parametrize("multimask", [False, True])
def test_mask_decoder_matches_jax(params, multimask):
    """predict_masks with the image PE shared as [HW, C], then the
    multimask selection or the eval-time stability fallback."""
    jp, tp = params
    g = _rng(4)
    F, C, B = IMG // 16, 256, 2
    emb = g.standard_normal((B, F, F, C))
    pe = g.standard_normal((F, F, C))
    sparse = g.standard_normal((B, 3, C))
    dense = g.standard_normal((B, F, F, C))
    hr = (g.standard_normal((B, 4 * F, 4 * F, C // 8)),
          g.standard_normal((B, 2 * F, 2 * F, C // 4)))
    want = _jit(lambda p, *a: jmd.apply(
        p, JCFG.mask_decoder_config, *a[:4], multimask_output=multimask,
        high_res_features=a[4:], training=False),
        jp["sam_mask_decoder"],
        *(jnp.asarray(a, jnp.float32) for a in (emb, pe, sparse, dense, *hr)))
    got = tmd.apply(tp["sam_mask_decoder"], TCFG.mask_decoder_config,
                    *(_t(a) for a in (emb, pe, sparse, dense)),
                    multimask_output=multimask,
                    high_res_features=tuple(_t(a) for a in hr),
                    training=False)
    for a, b in zip(got, want):
        _close(a, b, DEEP_TOL)


def test_memory_attention_matches_jax(params):
    """Plain path: RoPE self-attention, cross-attention over 2 spatial
    slots + 4 pointer tokens with the v-commute and a key_valid bias."""
    jp, tp = params
    g = _rng(5)
    F, C, D, O = IMG // 16, 256, 64, 2
    HW = F * F
    nsp, nptr = 2 * HW, 4
    curr = g.standard_normal((O, HW, C))
    mem = g.standard_normal((O, nsp + nptr, D))
    cpos = g.standard_normal((1, HW, C))
    mpos = g.standard_normal((O, nsp + nptr, D))
    valid = np.ones(nsp + nptr, bool)
    valid[HW:2 * HW] = False
    valid[-1] = False
    want = _jit(lambda p, v, *a: jma.apply(
        p, JCFG.memory_attention_config, *a, feat_hw=(F, F),
        num_spatial_k=nsp, key_valid=v),
        jp["memory_attention"], jnp.asarray(valid),
        *(jnp.asarray(a, jnp.float32) for a in (curr, mem, cpos, mpos)))
    got = tma.apply(tp["memory_attention"], TCFG.memory_attention_config,
                    *(_t(a) for a in (curr, mem, cpos, mpos)),
                    feat_hw=(F, F), num_spatial_k=nsp,
                    key_valid=torch.from_numpy(valid))
    _close(got, want, MOD_TOL)


def test_prepare_derives_entries_over_the_same_parameters(params):
    """``prepare`` adds the derived entries (the kernels' packed operands,
    memory attention's permuted q/k projections) over the same tensors:
    the state_dict, the given tree and the outputs stay as they were."""
    _, tp = params
    pp = tsam2.prepare(tp, TCFG)
    assert set(pp.state_dict()) == set(tp.state_dict())
    for (n, a), (m, b) in zip(pp.named_parameters(), tp.named_parameters()):
        assert n == m and a.data_ptr() == b.data_ptr()
    block = "image_encoder.trunk.blocks.0"
    assert "_ops" in pp.get_submodule(block)
    assert "_ops" not in tp.get_submodule(block)
    assert "_ops" in pp["memory_encoder"]
    assert "_qp" in pp["memory_attention"]["layers"]["0"]["cross_attn_image"]
    g = _rng(12)
    F, C, D = IMG // 16, 256, 64
    args = (_t(g.standard_normal((2, F * F, C))),
            _t(g.standard_normal((2, F * F + 4, D))),
            _t(g.standard_normal((1, F * F, C))),
            _t(g.standard_normal((2, F * F + 4, D))))
    kw = dict(feat_hw=(F, F), num_spatial_k=F * F)
    cfg = TCFG.memory_attention_config
    assert torch.equal(tma.apply(pp["memory_attention"], cfg, *args, **kw),
                       tma.apply(tp["memory_attention"], cfg, *args, **kw))
    # a bfloat16 model also gets every product's weight and bias cast once
    pb = tsam2.prepare(tp, dataclasses.replace(TCFG,
                                               compute_dtype="bfloat16"))
    lin = pb["sam_mask_decoder"]["iou_prediction_head"]["layers"]["0"]
    assert lin["_weight"].dtype == lin["_bias"].dtype == torch.bfloat16
    assert "_weight" not in pb["memory_attention"]["layers"]["0"]["norm1"]
    x = args[0].to(torch.bfloat16)
    raw = tp["sam_mask_decoder"]["iou_prediction_head"]["layers"]["0"]
    assert torch.equal(tnn.linear(lin, x), tnn.linear(raw, x))
    conv = pb["sam_mask_decoder"]["conv_s0"]
    feat = _t(g.standard_normal((1, 4, 4, 256))).to(torch.bfloat16)
    assert torch.equal(tnn.conv2d(conv, feat),
                       tnn.conv2d(tp["sam_mask_decoder"]["conv_s0"], feat))


def test_memory_encoder_matches_jax(params):
    """The port's apply (the kernel's wrapper, plain on the CPU) against
    the JAX plain path (space-to-depth downsampler, CXBlocks, out_proj)."""
    jp, tp = params
    g = _rng(6)
    pix = g.standard_normal((2, IMG // 16, IMG // 16, 256))
    masks = 20.0 / (1.0 + np.exp(-3 * g.standard_normal((2, IMG, IMG, 1)))) \
        - 10.0
    want, wpos = _jit(lambda p, x, m: jme.apply(
        p, JCFG.memory_encoder_config, x, m, allow_fused=False),
        jp["memory_encoder"], jnp.asarray(pix, jnp.float32),
        jnp.asarray(masks, jnp.float32))
    got, gpos = tme.apply(tp["memory_encoder"], TCFG.memory_encoder_config,
                          _t(pix), _t(masks))
    _close(got, want, MOD_TOL)
    _close(gpos, wpos, MOD_TOL)


def _heads_inputs(seed):
    g = _rng(seed)
    F, C, O = IMG // 16, 256, 2
    feats = g.standard_normal((O, F, F, C))
    hr = (g.standard_normal((O, 4 * F, 4 * F, C // 8)),
          g.standard_normal((O, 2 * F, 2 * F, C // 4)))
    coords = np.asarray([[[40.0, 30.0]], [[90.0, 100.0]]], np.float32)
    labels = np.ones((O, 1), np.int32)
    return feats, hr, coords, labels


def test_sam_heads_match_jax(params):
    jp, tp = params
    feats, hr, coords, labels = _heads_inputs(7)
    want = _jit(lambda p, f, c, lb, *h: jsam2.forward_sam_heads(
        p, JCFG, f, c, lb, high_res_features=h, training=False),
        jp, jnp.asarray(feats, jnp.float32), jnp.asarray(coords),
        jnp.asarray(labels), *(jnp.asarray(a, jnp.float32) for a in hr))
    got = tsam2.forward_sam_heads(
        tp, TCFG, _t(feats), _t(coords), torch.from_numpy(labels),
        high_res_features=tuple(_t(a) for a in hr), training=False)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], DEEP_TOL)


def test_use_mask_as_output_matches_jax(params):
    jp, tp = params
    feats, hr, _, _ = _heads_inputs(8)
    masks = np.zeros((2, IMG, IMG, 1), np.float32)
    masks[0, 20:70, 30:90] = 1.0
    want = _jit(lambda p, f, m, *h: jsam2.use_mask_as_output(
        p, JCFG, f, h, m, training=False),
        jp, jnp.asarray(feats, jnp.float32), jnp.asarray(masks),
        *(jnp.asarray(a, jnp.float32) for a in hr))
    got = tsam2.use_mask_as_output(tp, TCFG, _t(feats),
                                   tuple(_t(a) for a in hr), _t(masks),
                                   training=False)
    for k in want:
        _close(got[k], want[k], DEEP_TOL)


@pytest.mark.parametrize("non_overlap", [False, True])
def test_encode_new_memory_matches_jax(params, non_overlap):
    jp, tp = params
    g = _rng(9)
    feats = g.standard_normal((3, IMG // 16, IMG // 16, 256))
    hr_masks = 8.0 * g.standard_normal((3, 1, IMG, IMG))
    scores = np.asarray([[2.0], [-1.0], [0.5]], np.float32)
    want, wpos = _jit(lambda p, *a: jsam2.encode_new_memory(
        p, JCFG, *a, training=False, apply_non_overlap=non_overlap),
        jp, *(jnp.asarray(a, jnp.float32) for a in (feats, hr_masks, scores)))
    got, gpos = tsam2.encode_new_memory(tp, TCFG, _t(feats), _t(hr_masks),
                                        _t(scores),
                                        apply_non_overlap=non_overlap)
    _close(got, want, MOD_TOL)
    _close(gpos, wpos, MOD_TOL)


def test_fuse_memory_matches_jax(params):
    """The fixed-shape bank: 7 spatial slots (two invalid), 16 pointer
    slots (signed temporal distances, some invalid), slot tpos indices."""
    jp, tp = params
    g = _rng(10)
    F, C, D, O = IMG // 16, 256, 64, 2
    HW = F * F
    layout_j = jsam2.memory_layout(JCFG, 16)
    layout_t = tsam2.memory_layout(TCFG, 16)
    assert layout_t == tsam2.MemoryLayout(**vars(layout_j))
    M, P = layout_j.num_maskmem, layout_j.num_ptrs
    curr = g.standard_normal((O, HW, C))
    curr_pos = np.asarray(jsine(F, F, C)).reshape(HW, C)
    spatial = g.standard_normal((M, O, HW, D))
    sv = np.asarray([True, True, False, True, True, False, True])
    mem_pos = np.asarray(jsine(F, F, D)).reshape(HW, D)
    tpos = np.asarray([6, 5, 4, 3, 2, 1, 0], np.int32)
    ptrs = g.standard_normal((P, O, C))
    pv = np.arange(P) < 9
    ptpos = np.arange(P, dtype=np.float32)
    want = _jit(lambda p, *a: jsam2.fuse_memory(
        p, JCFG, layout_j, *a, training=False, t_diff_max=15),
        jp, *(jnp.asarray(a, jnp.float32) for a in (curr, curr_pos, spatial)),
        jnp.asarray(sv), jnp.asarray(mem_pos, jnp.float32),
        jnp.asarray(tpos), jnp.asarray(ptrs, jnp.float32), jnp.asarray(pv),
        jnp.asarray(ptpos))
    got = tsam2.fuse_memory(
        tp, TCFG, layout_t, _t(curr), _t(curr_pos), _t(spatial),
        torch.from_numpy(sv), _t(mem_pos), torch.from_numpy(tpos).long(),
        _t(ptrs), torch.from_numpy(pv), _t(ptpos), t_diff_max=15)
    _close(got, want, MOD_TOL)


def test_apply_non_overlapping_constraints_matches_jax():
    x = _rng(11).standard_normal((4, 1, 16, 16)) * 10
    _close(tsam2.apply_non_overlapping_constraints(_t(x)),
           jsam2.apply_non_overlapping_constraints(jnp.asarray(x,
                                                               jnp.float32)),
           MOD_TOL)


def test_block_specs_and_presets_match_jax():
    for name, cfg in jhiera.HIERA_PRESETS.items():
        tcfg = thiera.HIERA_PRESETS[name]
        assert tcfg.block_specs() == cfg.block_specs()
        assert tcfg.channel_list == cfg.channel_list
    assert tie.ImageEncoderConfig().backbone_channel_list == \
        jie.ImageEncoderConfig().backbone_channel_list


def test_fuse_memory_with_flash_attention_matches_jax(params):
    """use_flash_attention=True: the port's fused layer path (the plain
    versions of kernels #3-#5 on the CPU) against the JAX package's
    fuse_memory, over 3 spatial slots (one invalid) and 4 pointer slots."""
    jp, tp = params
    kw = dict(KW, use_flash_attention=True)
    jcfg, tcfg = jsam2.SAM2Config(**kw), tsam2.SAM2Config(**kw)
    assert tma.fused_eligible(tcfg.memory_attention_config)
    g = _rng(13)
    F, C, D, O = IMG // 16, 256, 64, 2
    HW = F * F
    layout_j = jsam2.MemoryLayout(num_maskmem=3, tokens_per_slot=HW,
                                  num_ptrs=4, tokens_per_ptr=4)
    layout_t = tsam2.MemoryLayout(**vars(layout_j))
    curr = g.standard_normal((O, HW, C))
    curr_pos = np.asarray(jsine(F, F, C)).reshape(HW, C)
    spatial = g.standard_normal((3, O, HW, D))
    sv = np.asarray([True, False, True])
    mem_pos = np.asarray(jsine(F, F, D)).reshape(HW, D)
    tpos = np.asarray([6, 0, 1], np.int32)
    ptrs = g.standard_normal((4, O, C))
    pv = np.asarray([True, True, True, False])
    ptpos = np.asarray([3.0, 1.0, 2.0, 3.0], np.float32)
    want = _jit(lambda p, *a: jsam2.fuse_memory(
        p, jcfg, layout_j, *a, training=False, t_diff_max=3),
        jp, *(jnp.asarray(a, jnp.float32) for a in (curr, curr_pos, spatial)),
        jnp.asarray(sv), jnp.asarray(mem_pos, jnp.float32),
        jnp.asarray(tpos), jnp.asarray(ptrs, jnp.float32), jnp.asarray(pv),
        jnp.asarray(ptpos))
    got = tsam2.fuse_memory(
        tp, tcfg, layout_t, _t(curr), _t(curr_pos), _t(spatial),
        torch.from_numpy(sv), _t(mem_pos), torch.from_numpy(tpos).long(),
        _t(ptrs), torch.from_numpy(pv), _t(ptpos), t_diff_max=3)
    _close(got, want, MOD_TOL)
