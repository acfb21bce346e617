"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on a card. Every test here is marked ``cuda`` and skips without a CUDA
device (a CUDA kernel has no CPU mode). The file imports torch and the port
only, so it also runs where JAX is not installed:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_port_cuda.py

The weights are ``synthetic_params``: the seeded init moved off its
constants (LayerNorm ones and zeros, the CXBlock layer scales of 1e-6,
which would hide both CXBlocks of the memory encoder).

Tolerance: 2e-2 of max(1, |plain|). Both sides run in bf16, but the plain
version rounds to bf16 after every op and the kernels once per fused
epilogue, so they differ by a few bf16 ulps (2^-8 relative each).
``flash_attention_kproj``'s output and its dq, dkin and dv are softmax
averages well below 1 in size, so its limit is 2e-2 of max|plain| of each
tensor, with no floor of 1.
"""

import copy
import dataclasses

import pytest
import torch

from sam2_video_tpu_torch.data.synthetic import synthetic_params
from sam2_video_tpu_torch.models import memory_encoder as me
from sam2_video_tpu_torch.models import sam2 as sam2_mod
from sam2_video_tpu_torch.ops import common as nn
from sam2_video_tpu_torch.ops import hiera_block_kernel as hbk
from sam2_video_tpu_torch.ops import memory_encoder_kernel as mek

TOL = 2e-2
# fused_tail_block's 512 px gradients against float32, relative L2: within
# REL_L2, or within REL_RATIO times the plain bf16 version's own distance
# (dy and da sit ~4% from float32 in both: ReLU units near zero flip)
REL_L2, REL_RATIO = 2e-2, 1.5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = sam2_mod.SAM2Config(image_size=384, use_flash_attention=False)
    return cfg, synthetic_params(cfg, seed=0).to("cuda")


def _assert_close(got, want, floor=1.0, msg=None):
    got, want = got.float(), want.float()
    assert got.shape == want.shape, msg
    assert torch.isfinite(got).all(), msg
    scale = max(floor, want.abs().max().item())
    assert (got - want).abs().max().item() <= TOL * scale, msg


@pytest.mark.cuda
@pytest.mark.parametrize("image_size", [384, 512])
def test_fused_block_matches_plain(card, image_size):
    """Every block of the tiny trunk at 384 px (windows with and without
    pad, even and odd pooled windows, global, stage 4) and at 512 px."""
    cfg, params = card
    tcfg = cfg.trunk_config
    trunk = params["image_encoder"]["trunk"]
    gen = torch.Generator().manual_seed(image_size)
    H = image_size // 4
    launches = hbk.fused_block.launches
    for i, spec in enumerate(tcfg.block_specs()):
        x = torch.randn((2, H, H, spec["dim"]), generator=gen).to(
            "cuda", torch.bfloat16)
        bp = trunk["blocks"][str(i)]
        _assert_close(hbk.fused_block(bp, x, spec, tcfg.q_stride),
                      hbk.fused_block_plain(bp, x, spec, tcfg.q_stride))
        if spec["q_pool"]:
            H //= 2
    assert hbk.fused_block.launches == launches + len(tcfg.block_specs())


@pytest.mark.cuda
@pytest.mark.parametrize("image_size, frames", [
    (384, 1), (384, 10),    # one frame; the train steps' 10 frames
    # 96 px: stage grids 24 / 12 / 6 / 3, windows larger than their grid
    # (stage 3's 14 over 6, stage 4's 7 over 3) and a 3 x 3 grid pooled to
    # 1 x 1 (an odd crop)
    (96, 2),
    (1024, 1),              # stage 3's global blocks over 4,096 keys
])
def test_fused_block_edges(card, image_size, frames):
    """Every block of the tiny trunk at the kernel's edges, against the
    plain block; a second run gives the same bits."""
    cfg, params = card
    tcfg = cfg.trunk_config
    trunk = params["image_encoder"]["trunk"]
    gen = torch.Generator().manual_seed(image_size + frames)
    H = image_size // 4
    for i, spec in enumerate(tcfg.block_specs()):
        x = torch.randn((frames, H, H, spec["dim"]), generator=gen).to(
            "cuda", torch.bfloat16)
        bp = trunk["blocks"][str(i)]
        got = hbk.fused_block(bp, x, spec, tcfg.q_stride)
        _assert_close(got, hbk.fused_block_plain(bp, x, spec, tcfg.q_stride),
                      msg=f"block {i}")
        assert torch.equal(got, hbk.fused_block(bp, x, spec, tcfg.q_stride)), \
            f"block {i}: two runs differ"
        if spec["q_pool"]:
            H //= 2


@pytest.mark.cuda
def test_fused_memory_encoder_matches_plain(card):
    cfg, params = card
    mcfg = cfg.memory_encoder_config
    p = params["memory_encoder"]
    gen = torch.Generator().manual_seed(1)
    masks = (torch.sigmoid(8 * torch.randn((3, 384, 384, 1), generator=gen))
             * 20 - 10).to("cuda", torch.bfloat16)
    pix = torch.randn((3, 24, 24, 256), generator=gen).to("cuda",
                                                          torch.bfloat16)
    pix_proj = nn.conv2d(p["pix_feat_proj"], pix)
    launches = mek.fused_memory_encoder.launches
    _assert_close(mek.fused_memory_encoder(p, mcfg, pix_proj, masks),
                  me.apply_unfused(p, mcfg, pix_proj, masks))
    assert mek.fused_memory_encoder.launches == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("objects, image_size", [
    (1, 384), (8, 384), (16, 384),   # one object's 576 rows: 9 MLP blocks
    (8, 1024),                       # a 64 x 64 grid
])
def test_fused_memory_encoder_sizes(card, objects, image_size):
    """Kernel #2 against the plain path at other object counts and a larger
    grid; a second run gives the same bits."""
    cfg, params = card
    mcfg = cfg.memory_encoder_config
    p = params["memory_encoder"]
    gen = torch.Generator().manual_seed(objects + image_size)
    h = image_size // 16
    masks = (torch.sigmoid(8 * torch.randn((objects, image_size, image_size,
                                            1), generator=gen))
             * 20 - 10).to("cuda", torch.bfloat16)
    pix = torch.randn((objects, h, h, 256), generator=gen).to(
        "cuda", torch.bfloat16)
    pix_proj = nn.conv2d(p["pix_feat_proj"], pix)
    got = mek.fused_memory_encoder(p, mcfg, pix_proj, masks)
    _assert_close(got, me.apply_unfused(p, mcfg, pix_proj, masks))
    assert torch.equal(got, mek.fused_memory_encoder(p, mcfg, pix_proj,
                                                     masks))


@pytest.mark.cuda
def test_kernels_refuse_float32_on_the_card(card):
    cfg, params = card
    tcfg = cfg.trunk_config
    x = torch.zeros((1, 96, 96, 96), device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        hbk.fused_block(params["image_encoder"]["trunk"]["blocks"]["0"], x,
                        tcfg.block_specs()[0], tcfg.q_stride)


def _vjp(fn, inputs, cots):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return outs, torch.autograd.grad(outs, leaves, cots)


def _rel_l2(got, want):
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def _check_vjp(kernel_fn, plain_fn, inputs, cots, floor=1.0,
               grads_vs_f32=False):
    """Outputs and the VJP of the same cotangents of the kernel and of the
    plain version (autograd through its forward), each within TOL of
    max(floor, max|plain|). With ``grads_vs_f32`` the gradients are held
    instead to the plain version run in float32 on the same values, by
    relative L2: within REL_L2, or within REL_RATIO times the plain bf16
    version's own distance from float32."""
    outs, grads = _vjp(kernel_fn, inputs, cots)
    p_outs, p_grads = _vjp(plain_fn, inputs, cots)
    for got, want in zip(outs, p_outs, strict=True):
        _assert_close(got, want, floor)
    if not grads_vs_f32:
        for got, want in zip(grads, p_grads, strict=True):
            _assert_close(got, want, floor)
        return
    _, f_grads = _vjp(plain_fn, [t.float() for t in inputs],
                      [c.float() for c in cots])
    bad = []
    for i, (got, plain, want) in enumerate(zip(grads, p_grads, f_grads,
                                               strict=True)):
        assert torch.isfinite(got).all()
        rel, rel_plain = _rel_l2(got, want), _rel_l2(plain, want)
        print(f"gradient {i}: rel_l2 to float32: kernel {rel:.4g}, "
              f"plain bf16 {rel_plain:.4g}")
        if rel > max(REL_L2, REL_RATIO * rel_plain):
            bad.append((i, rel, rel_plain))
    assert not bad, bad


def _layer(params, cfg):
    from sam2_video_tpu_torch.models import memory_attention as ma
    return ma.prepare(params["memory_attention"],
                      cfg.memory_attention_config)["layers"]["1"]


def _memattn_fns(params, cfg, grid_w, grid_h):
    """(self leaves, self_fn, tail leaves, tail_fn) of layer 1 on a grid_w x
    grid_h token grid: ``self_fn(fn)`` / ``tail_fn(fn)`` wrap a
    fused_*_block (kernel or plain) as a function of its inputs and
    leaves."""
    from sam2_video_tpu_torch.ops.position_encoding import \
        axial_rope_table_half

    lp = _layer(params, cfg)
    sp, cp = lp["self_attn"], lp["cross_attn_image"]
    cos, sin = axial_rope_table_half(256, grid_w, grid_h, device="cuda")
    w = [lp["norm1"]["weight"], lp["norm1"]["bias"], sp["_qp"]["weight"],
         sp["_qp"]["bias"], sp["_kp"]["weight"], sp["_kp"]["bias"],
         sp["v_proj"]["weight"], sp["v_proj"]["bias"],
         sp["out_proj"]["weight"], sp["out_proj"]["bias"],
         lp["norm2"]["weight"], lp["norm2"]["bias"], cp["_qp"]["weight"],
         cp["_qp"]["bias"]]

    def self_fn(fn):
        def run(x, *w):
            lin = lambda i: {"weight": w[i], "bias": w[i + 1]}  # noqa: E731
            return fn({"q": lin(2), "k": lin(4), "v": lin(6),
                       "out": lin(8)}, lin(12), lin(0), lin(10), x, cos, sin)
        return run

    t = [cp["v_proj"]["weight"], cp["v_proj"]["bias"],
         cp["out_proj"]["weight"], cp["out_proj"]["bias"],
         lp["norm3"]["weight"], lp["norm3"]["bias"],
         lp["linear1"]["weight"], lp["linear1"]["bias"],
         lp["linear2"]["weight"], lp["linear2"]["bias"]]

    def tail_fn(fn):
        def run(y, a, *w):
            lin = lambda i: {"weight": w[i], "bias": w[i + 1]}  # noqa: E731
            return fn(lin(0), lin(2), lin(4), lin(6), lin(8), y, a)
        return run

    return w, self_fn, t, tail_fn


def _check_memattn(params, cfg, grid_w, grid_h, objects, seed,
                   grads_vs_f32=False):
    """#4 and #5 forward and backward against their plain versions on one
    grid (the tail's gradients by relative L2 to float32 with
    ``grads_vs_f32``); each wrapper launches once each way."""
    from sam2_video_tpu_torch.ops import memattn_layer_kernel as mlk

    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)

    w, self_fn, t, tail_fn = _memattn_fns(params, cfg, grid_w, grid_h)
    x = rnd(objects, grid_w * grid_h, 256)
    launches = (mlk.fused_self_block.launches,
                mlk.fused_self_block.backward_launches)
    _check_vjp(self_fn(mlk.fused_self_block),
               self_fn(mlk.fused_self_block_plain), [x] + w,
               [rnd(*x.shape), rnd(*x.shape)])
    assert (mlk.fused_self_block.launches,
            mlk.fused_self_block.backward_launches) == \
        (launches[0] + 1, launches[1] + 1)
    _check_vjp(tail_fn(mlk.fused_tail_block),
               tail_fn(mlk.fused_tail_block_plain),
               [x, rnd(objects, grid_w * grid_h, 64)] + t, [rnd(*x.shape)],
               grads_vs_f32=grads_vs_f32)


@pytest.mark.cuda
@pytest.mark.parametrize("image_size, objects", [(384, 8), (512, 16),
                                                (96, 2), (448, 3)])
def test_memattn_blocks_match_plain(card, image_size, objects):
    """Kernels #4 and #5, forward and backward, at the 384 px training
    grid (576 tokens, 8 objects), the 512 px one (1024 tokens, two clips
    of 8 objects stacked) and two grids whose token count is not a multiple
    of 32 (96 px: 36 tokens, 448 px: 784), which the wrappers pad.

    The tail's ReLU backward is discontinuous: where a pre-activation
    rounds to zero in one product and not in the other (the kernel and
    cuBLAS sum in different orders), the two masks differ, and one such
    unit moves a row of the gradient by |dr| |W1| ~ 0.5. At 512 px with 16
    objects (34M pre-activations) that reached 2.6% of the max-abs scale
    on the card. So at 512 px the tail's gradients are held to the plain
    version in float32 by relative L2, where a few flipped units weigh
    what they are, and a wrong mask or a lost partial does not pass."""
    cfg, params = card
    F = image_size // 16
    _check_memattn(params, cfg, F, F, objects, image_size,
                   grads_vs_f32=image_size == 512)


# token grids of the new design's edges: (grid w, grid h, objects). One
# object of 32 tokens (one wgmma row tile, half of it past the object); 3
# objects of 40 tokens (padded to 64: N L = 192 rows, not a multiple of the
# GEMMs' 128-row block tile, pad keys in every attention tile); and the
# K-chunk rule's edges (sm90_gemm.cuh gm_k_splits: chunks of at least 8
# 64-row tiles): 15 and 16 objects of 64 tokens (15 and 16 row tiles: one
# chunk, then two, for every 256 x 256 weight gradient), 71 x 64 and 72 x
# 64 rows (8 chunks of 9 tiles, then 9 of 8).
MEMATTN_EDGES = ((8, 4, 1), (8, 5, 3), (8, 8, 15), (8, 8, 16), (8, 8, 71),
                 (8, 8, 72))


@pytest.mark.cuda
@pytest.mark.parametrize("grid_w, grid_h, objects", MEMATTN_EDGES)
def test_memattn_blocks_edges(card, grid_w, grid_h, objects):
    """#4 and #5 at the edges of their tiles and K chunks (MEMATTN_EDGES),
    each tensor within 2e-2 of max(1, |plain|); the split counts are the
    rule's. The K-chunk edges take 960-4608 rows, where one ReLU unit that
    rounds to zero on one side only moves a row of the tail's gradients
    by more than the max-abs bound (test_memattn_blocks_match_plain), so
    there the tail's gradients are held to float32 by relative L2."""
    from sam2_video_tpu_torch.ops import memattn_layer_kernel as mlk

    cfg, params = card
    rows = objects * -(-grid_w * grid_h // mlk.ROW_MULTIPLE) * \
        mlk.ROW_MULTIPLE
    tiles = -(-rows // 64)
    want = {15: 1, 16: 2, 71: 8, 72: 9}.get(tiles)
    if want is not None:
        assert mlk.k_splits(256, 256, rows) == want
    _check_memattn(params, cfg, grid_w, grid_h, objects, 1000 + objects,
                   grads_vs_f32=want is not None)


@pytest.mark.cuda
def test_memattn_blocks_same_bits_twice(card):
    """The same inputs give the same bits twice in every output and
    gradient of #4 and #5 (no float atomics; partials added in a fixed
    order), at the training shape."""
    from sam2_video_tpu_torch.ops import memattn_layer_kernel as mlk

    cfg, params = card
    w, self_fn, t, tail_fn = _memattn_fns(params, cfg, 24, 24)
    gen = torch.Generator().manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)

    x = rnd(8, 576, 256)
    for fn, inputs, cots in (
            (self_fn(mlk.fused_self_block), [x] + w,
             [rnd(*x.shape), rnd(*x.shape)]),
            (tail_fn(mlk.fused_tail_block), [x, rnd(8, 576, 64)] + t,
             [rnd(*x.shape)])):
        first = _vjp(fn, inputs, cots)
        again = _vjp(fn, inputs, cots)
        for a, b in zip([*first[0], *first[1]], [*again[0], *again[1]],
                        strict=True):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "image_size, objects, queries, slots, ptr_tokens, masked, plan_want", [
        (384, 8, None, 1, 4, False, None),   # training, frame 1: Lk = 580
        (384, 8, None, 7, 36, False, None),  # training, frame 9: Lk = 4068
        (384, 8, None, 7, 64, True, None),   # serving: Lk = 4096, two
                                             # invalid slots
        (512, 16, None, 7, 36, False, None),  # two clips stacked: Lk 7204
        # 448 px: slots of 784 keys straddle key tiles, and the last tile
        # holds the end of the last slot and the pointer keys (Lk 5524)
        (448, 3, None, 7, 36, False, None),
        # the split rule's edges (kproj_plan, tests/test_torch_port_kproj.py)
        # on 12 x 12 slots of 144 keys, 100 queries: the most keys without
        # a split (Lk 320, 5 tiles), two splits of 3 tiles exactly (384),
        # one key past them (385: two of 4 and 3 tiles, the last holding
        # one key); plan_want: splits of the forward and of the dq pass,
        # warpgroups per dq block
        (192, 2, 100, 2, 32, False, (1, 1, 2)),
        (192, 2, 100, 2, 96, True, (2, 2, 2)),
        (192, 2, 100, 2, 97, False, (2, 2, 2)),
        # the dq pass's warpgroup edges (KPROJ_DQ_MAX_ROPE_ROWS): 34 x 34
        # slots, the largest with two warpgroups per dq block (their RoPE
        # rows fill shared memory to the byte); 35 x 35, one past it; 64 x
        # 64 (1024 px), the largest grid whose RoPE rows the kernel keeps
        # in shared memory
        (544, 2, 100, 2, 4, False, (10, 10, 2)),
        (560, 2, 100, 2, 4, True, (13, 13, 1)),
        (1024, 2, 100, 1, 4, False, (13, 13, 1)),
        # 72 x 72 slots (1152 px): the passes read the RoPE table in device
        # memory; one slot, and two with the pointer keys masked
        (1152, 2, 100, 1, 4, False, (17, 17, 1)),
        (1152, 1, 100, 2, 4, True, (24, 24, 1)),
    ])
def test_flash_attention_kproj_matches_plain(card, image_size, objects,
                                             queries, slots, ptr_tokens,
                                             masked, plan_want):
    """Kernel #3 forward and backward (autograd through the plain forward
    with the same cotangent); the launch counters move by one each way, and
    a second backward gives the same bits for dq, dkin, dv, dWk and dbk."""
    from sam2_video_tpu_torch.ops import flash_attention as fa

    cfg, params = card
    kp = _layer(params, cfg)["cross_attn_image"]["_kp"]
    F = image_size // 16
    HW = F * F
    Lq = queries or HW
    nsp = slots * HW
    Lk = nsp + ptr_tokens
    if plan_want is not None:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = fa.kproj_plan(objects, Lq, Lk, (F, F), sms)
        assert (plan.fwd[0], plan.dq[0], plan.dq_warpgroups) == plan_want, \
            plan
    gen = torch.Generator().manual_seed(Lk)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)

    bias = None
    if masked:
        valid = torch.ones(Lk, dtype=torch.bool)
        valid[2 * HW: 4 * HW] = False
        bias = torch.where(valid, 0.0, -1e9).float().cuda()

    def run(fn):
        return lambda q, kin, v, w, b: fn(q, kin, v, w, b, bias, nsp, (F, F))

    inputs = [rnd(objects, Lq, 256), rnd(objects, Lk, 64),
              rnd(objects, Lk, 64), kp["weight"], kp["bias"]]
    cots = [rnd(objects, Lq, 64)]
    launches = (fa.flash_attention_kproj.launches,
                fa.flash_attention_kproj.backward_launches)
    _check_vjp(run(fa.flash_attention_kproj),
               run(fa.flash_attention_kproj_plain), inputs, cots, floor=0.0)
    assert (fa.flash_attention_kproj.launches,
            fa.flash_attention_kproj.backward_launches) == (launches[0] + 1,
                                                            launches[1] + 1)
    first = _vjp(run(fa.flash_attention_kproj), inputs, cots)
    again = _vjp(run(fa.flash_attention_kproj), inputs, cots)
    for a, b in zip([*first[0], *first[1]], [*again[0], *again[1]],
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_memattn_kernels_refuse_float32_on_the_card(card):
    from sam2_video_tpu_torch.ops import flash_attention as fa
    from sam2_video_tpu_torch.ops import memattn_layer_kernel as mlk

    x = torch.zeros((1, 64, 256), device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        mlk.fused_tail_block(None, None, None, {"weight": x}, None, x,
                             x[..., :64])
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention_kproj(x, x[..., :64], x[..., :64], None, None,
                                 None, 64, (8, 8))


@pytest.mark.cuda
def test_fused_memory_attention_runs_a_ragged_grid_on_the_card(card):
    """Memory attention on the fused path at a 6x6 grid (36 tokens, the
    96 px synthetic combo) and a 28x28 grid (784 tokens, 448 px), whose
    token counts are not multiples of 32: kernels #3-#5 run forward and
    backward on the card, and the output and the gradients of the current
    features and the memory agree with the plain layers in float32 on the
    CPU (relative L2 0.05 and 0.1: bf16 through four layers)."""
    from sam2_video_tpu_torch.models import memory_attention as ma
    from sam2_video_tpu_torch.ops import memattn_layer_kernel as mlk

    cfg, params = card
    mcfg = dataclasses.replace(cfg.memory_attention_config, use_flash=True)
    assert ma.fused_eligible(mcfg)
    for side in (6, 28):
        HW = side * side
        gen = torch.Generator().manual_seed(side)
        curr = torch.randn((2, HW, 256), generator=gen)
        mem = torch.randn((2, 2 * HW + 4, 64), generator=gen)
        cot = torch.randn((2, HW, 256), generator=gen)
        valid = torch.ones(2 * HW + 4, dtype=torch.bool)
        valid[HW: 2 * HW] = False
        res = []
        for dev, dt in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
            tree = params["memory_attention"]
            if dev == "cpu":
                tree = copy.deepcopy(tree).to("cpu")
            p = ma.prepare(tree, mcfg)
            x, m = (t.to(dev, dt).requires_grad_(True) for t in (curr, mem))
            before = (mlk.fused_self_block.launches,
                      mlk.fused_tail_block.backward_launches)
            out = ma.apply(p, mcfg, x, m, None, m, feat_hw=(side, side),
                           num_spatial_k=2 * HW,
                           key_valid=valid.to(dev))
            out.backward(cot.to(dev, dt))
            res.append([t.detach().float().cpu()
                        for t in (out, x.grad, m.grad)])
            if dev == "cuda":
                assert (mlk.fused_self_block.launches,
                        mlk.fused_tail_block.backward_launches) == (
                    before[0] + mcfg.num_layers,
                    before[1] + mcfg.num_layers)
        for i, (got, want) in enumerate(zip(*res, strict=True)):
            assert torch.isfinite(got).all()
            assert _rel_l2(got, want) < (0.05 if i == 0 else 0.1), (side, i)


# kernel #6 on q-pool blocks: the gradients a 2x2 max-pool routes (dx, the
# LN1 weight's, the qkv weight's, the shortcut weight's) by relative L2 (a
# tie in a 2x2 cell routes to another element under torch's max_pool2d
# autograd than under the kernel's JAX rule; each such cell moves one whole
# contribution between two tokens), and within POOL_WALK_REL_L2 of the plain
# block with the kernel's walk (``fused_block_trainable_walk``: the JAX
# rule and the kernel's rounding points, so that the tie cells agree)
POOL_REL_L2 = 5e-2
POOL_WALK_REL_L2 = 1e-2
POOL_ROUTED = ("x", "norm1.weight", "attn.qkv.weight", "proj.weight")


def _trainable_block(hbb, fn, spec, tcfg):
    def run(x, *w):
        return fn(hbb.block_params(w, spec), x, spec, tcfg.q_stride,
                  tcfg.mlp_ratio)
    return run


def _check_trainable_block(hbb, tcfg, bp, spec, x, gen, label,
                           ref="plain"):
    """Kernel #6 (B1 + B2 through ``fused_block_trainable``) on one block
    against autograd through the plain bf16 block, one random cotangent:
    dx and every parameter gradient within TOL of max(1, max|plain|) (with
    ``ref="f32"``: of the plain block run in float32 on the same values,
    within TOL of max(1, max|float32|)), those a 2x2 max-pool routes on
    q-pool blocks within POOL_REL_L2 of plain and POOL_WALK_REL_L2 of the
    kernel walk; a second backward run gives the same bits (no
    atomics)."""
    inputs = [x] + hbb.leaves(bp, spec)
    plain = _trainable_block(hbb, hbb.fused_block_trainable_plain, spec, tcfg)
    kernel = _trainable_block(hbb, hbb.fused_block_trainable, spec, tcfg)
    with torch.no_grad():
        shape = plain(*inputs).shape
    cot = torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)
    outs, grads = _vjp(kernel, inputs, [cot])
    _, again = _vjp(kernel, inputs, [cot])
    p_outs, p_grads = _vjp(plain, inputs, [cot])
    walk = want = p_grads
    if ref == "f32":
        _, want = _vjp(plain, [t.float() for t in inputs], [cot.float()])
    if spec["q_pool"]:
        _, walk = _vjp(_trainable_block(
            hbb, hbb.fused_block_trainable_walk, spec, tcfg), inputs, [cot])
    _assert_close(outs[0], p_outs[0], msg=(label, "out"))
    names = ["x"] + [".".join(pt) for pt in hbb.paths(spec)]
    for name, got, same, pl, kw, ok in zip(names, grads, again, p_grads, walk,
                                           want, strict=True):
        assert torch.equal(got, same), (label, name)
        if spec["q_pool"] and name in POOL_ROUTED:
            assert torch.isfinite(got).all()
            assert _rel_l2(got, pl) <= POOL_REL_L2, (label, name)
            assert _rel_l2(got, kw) <= POOL_WALK_REL_L2, (label, name)
        else:
            if ref == "f32":
                scale = max(1.0, ok.abs().max().item())
                print(f"{label} {name}: max err / scale to float32: kernel "
                      f"{(got.float() - ok).abs().max().item() / scale:.4g}, "
                      f"plain bf16 "
                      f"{(pl.float() - ok).abs().max().item() / scale:.4g}")
            _assert_close(got, ok, msg=(label, name))


@pytest.mark.cuda
@pytest.mark.parametrize("image_size, frames, ref", [
    (384, 2, "plain"), (512, 2, "plain"), (448, 2, "plain"), (96, 2, "f32"),
    (448, 1, "plain")])
def test_trainable_block_backward_matches_plain(card, image_size, frames,
                                                ref):
    """Kernel #6 on every block of the tiny trunk (every geometry class:
    windows with and without pad, q-pool with even and odd pooled windows,
    global 24x24 and 32x32, stage 4; at 448 px no pad and global windows
    of 784 keys; at 96 px stage grids 24 / 12 / 6 / 3, windows of 14 and 7
    over grids of 6 and 3, an odd q-pool crop 7 -> 3, and 9 windows a frame
    at stages 1 and 2, not a multiple of the 4 or 16 small windows packed
    to a tile; at 448 px one frame, 196 windows of 4 x 4 at stage 2, 12
    packs of 16 and one of 4), as ``_check_trainable_block``. At 96 px the
    stage-4 block holds 18 real tokens in two frames, so its weight
    gradients are sums over 18 rows where the two bf16 versions' rounding
    does not average out: there the plain bf16 block's own distance from
    float32 comes close to TOL (printed), and the two bf16 versions sat
    just over TOL apart. That case holds the unrouted gradients to the
    float32 plain block instead, with the same TOL."""
    from sam2_video_tpu_torch.ops import hiera_block_bwd as hbb

    cfg, params = card
    tcfg = cfg.trunk_config
    trunk = params["image_encoder"]["trunk"]
    gen = torch.Generator().manual_seed(image_size + 6 + frames)
    H = image_size // 4
    launches = hbb.fused_block_trainable.launches
    for i, spec in enumerate(tcfg.block_specs()):
        x = torch.randn((frames, H, H, spec["dim"]), generator=gen).to(
            "cuda", torch.bfloat16)
        _check_trainable_block(hbb, tcfg, trunk["blocks"][str(i)], spec, x,
                               gen, i, ref)
        if spec["q_pool"]:
            H //= 2
    assert hbb.fused_block_trainable.launches == launches + 2 * 2 * 12


PRESET_PARAMS: dict = {}


def _preset(backbone):
    """(cfg, synthetic_params on the card) of a SAM2 preset at 384 px, made
    once per test process."""
    if backbone not in PRESET_PARAMS:
        cfg = sam2_mod.SAM2Config(backbone=backbone, image_size=384,
                                  use_flash_attention=False)
        PRESET_PARAMS[backbone] = (cfg, synthetic_params(cfg, seed=0).to(
            "cuda"))
    return PRESET_PARAMS[backbone]


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", ["base_plus", "large"])
@pytest.mark.parametrize("frames", [1, 10])
def test_preset_blocks_match_plain(card, backbone, frames):
    """Kernels #1 and #6 at SAM2-base+ (widths 112-896, head dim 56) and
    SAM2-large (144-1152, head dim 72), 384 px, at the first block of each
    geometry class (windows 8 / 4 / 14 or 16 / 7 or 8, global, the three
    q-pool blocks, stage 4): #1 against the plain block within TOL and
    bit-equal on a second run; #6 as ``_check_trainable_block`` (TOL, the
    pool and walk limits, a second run's bits)."""
    from sam2_video_tpu_torch.ops import hiera_block_bwd as hbb

    cfg, params = _preset(backbone)
    tcfg = cfg.trunk_config
    trunk = params["image_encoder"]["trunk"]
    gen = torch.Generator().manual_seed(frames * 7 + len(backbone))
    H = cfg.image_size // 4
    seen = set()
    for i, spec in enumerate(tcfg.block_specs()):
        geom = hbb.geometry(spec, H, H)
        if geom not in seen:
            seen.add(geom)
            x = torch.randn((frames, H, H, spec["dim"]), generator=gen).to(
                "cuda", torch.bfloat16)
            bp = trunk["blocks"][str(i)]
            got = hbk.fused_block(bp, x, spec, tcfg.q_stride, tcfg.mlp_ratio)
            _assert_close(got, hbk.fused_block_plain(bp, x, spec,
                                                     tcfg.q_stride),
                          msg=(backbone, i))
            assert torch.equal(got, hbk.fused_block(
                bp, x, spec, tcfg.q_stride, tcfg.mlp_ratio)), (backbone, i)
            _check_trainable_block(hbb, tcfg, bp, spec, x, gen, (backbone, i))
        if spec["q_pool"]:
            H //= 2
    assert len(seen) >= 8


@pytest.mark.cuda
@pytest.mark.parametrize("block", [2, 11])
def test_trainable_block_backward_split_edges(card, block):
    """Kernel #6 on one block of the 384 px trunk at the two frame counts
    between which the K-split rule (``hbb.k_splits``) first changes the
    number of row chunks of dW1, dW2 or dWproj (sums over the output
    rows): block 2 (48 x 48, 192 wide) at 1 and 2 frames (dW1's chunks),
    block 11 (12 x 12, 768 wide, hidden 3072) at 6 and 7 (dWproj's), as
    ``_check_trainable_block``."""
    from sam2_video_tpu_torch.ops import hiera_block_bwd as hbb

    cfg, params = card
    tcfg = cfg.trunk_config
    specs = tcfg.block_specs()
    spec = specs[block]
    H = cfg.image_size // 4 // 2 ** sum(s["q_pool"] for s in specs[:block])
    C, hid = spec["dim_out"], int(spec["dim_out"] * tcfg.mlp_ratio)
    Ho = H // 2 if spec["q_pool"] else H
    splits = [tuple(hbb.k_splits(m, k, n * Ho * Ho)
                    for m, k in ((hid, C), (C, hid), (C, C)))
              for n in range(1, 17)]
    edge = next(n for n in range(1, 16) if splits[n] != splits[n - 1])
    print(f"block {block}: dW1, dW2, dWproj splits by frames 1-16 {splits}")
    gen = torch.Generator().manual_seed(block)
    for frames in (edge, edge + 1):
        x = torch.randn((frames, H, H, spec["dim"]), generator=gen).to(
            "cuda", torch.bfloat16)
        _check_trainable_block(hbb, tcfg, params["image_encoder"]["trunk"][
            "blocks"][str(block)], spec, x, gen, (block, frames))


# Kernel #6's B1 against the float32 plain block (exact-erf GELU). The
# weights put every MLP pre-activation at -2.1 +- ~0.4, where the tanh
# form of GELU's derivative sits 0.5-1.2% from the erf form with one sign;
# the cotangent and the second layer's weights have one sign per hidden
# unit and the LN2 output one sign per channel, so that dW1's and db1's sums
# over the rows are coherent: the bf16 rounding noise averages out there
# and a wrong derivative does not. The attention projection is zero, so dx
# is B1's dx1 (dy plus the LN2 branch). Every weight is exact in bf16, so
# the three versions share their values. Held: the kernel's relative L2
# distance from float32, of dW1, db1 and the branch dx - dy, at most
# GELU_F32_RATIO times the plain bf16 block's. The CPU's emulation of a
# tanh GELU' read 1.05% on dW1 and db1 against the plain bf16 block's
# 0.16-0.17%.
GELU_F32_RATIO = 2.0
GELU_HELD = ("x", "mlp.layers.0.weight", "mlp.layers.0.bias")


def _gelu_probe_leaves(hbb, w, spec, mlp_ratio, gen, centre=-2.1):
    C = spec["dim_out"]
    hid = int(C * mlp_ratio)
    d = dict(zip(hbb.paths(spec), [t.detach().float().clone() for t in w]))

    def sign(n):
        return torch.where(torch.rand(n, generator=gen) < 0.5, -1.0, 1.0)

    d["attn", "proj", "weight"].zero_()
    d["norm2", "weight"].fill_(0.125)
    ln2b = sign(C)
    d["norm2", "bias"] = ln2b
    w1 = (torch.randn(hid, C, generator=gen) / C ** 0.5).bfloat16().float()
    d["mlp", "layers", "0", "weight"] = w1
    d["mlp", "layers", "0", "bias"] = (
        centre + 0.3 * (torch.rand(hid, generator=gen) - 0.5) - w1 @ ln2b)
    d["mlp", "layers", "1", "weight"] = (
        torch.randn(C, hid, generator=gen).abs() * sign(hid) * (1000.0 / C))
    return [d[p].bfloat16().float().to("cuda") for p in hbb.paths(spec)]


@pytest.mark.cuda
@pytest.mark.parametrize("block, frames", [(0, 1), (11, 4)])
def test_trainable_block_backward_gelu_derivative(card, block, frames):
    """B1's dx1, dW1 and db1 against the float32 plain block on the probe
    weights above (96 and 768 wide), within GELU_F32_RATIO of the plain
    bf16 block's distance from float32."""
    from sam2_video_tpu_torch.ops import hiera_block_bwd as hbb

    cfg, params = card
    tcfg = cfg.trunk_config
    specs = tcfg.block_specs()
    spec = specs[block]
    H = cfg.image_size // 4 // 2 ** sum(s["q_pool"] for s in specs[:block])
    gen = torch.Generator().manual_seed(block + 60)
    w = _gelu_probe_leaves(hbb, hbb.leaves(
        params["image_encoder"]["trunk"]["blocks"][str(block)], spec), spec,
        tcfg.mlp_ratio, gen)
    x = torch.randn((frames, H, H, spec["dim"]), generator=gen).to(
        "cuda", torch.bfloat16)
    cot = torch.randn((frames, H, H, spec["dim_out"]),
                      generator=gen).abs().to("cuda", torch.bfloat16)
    _, grads = _vjp(_trainable_block(hbb, hbb.fused_block_trainable, spec,
                                     tcfg), [x] + w, [cot])
    plain = _trainable_block(hbb, hbb.fused_block_trainable_plain, spec, tcfg)
    _, p_grads = _vjp(plain, [x] + w, [cot])
    _, f_grads = _vjp(plain, [x.float()] + w, [cot.float()])
    names = ["x"] + [".".join(pt) for pt in hbb.paths(spec)]
    bad = []
    for name in GELU_HELD:
        i = names.index(name)
        got, want, ref = grads[i].float(), p_grads[i].float(), f_grads[i]
        if name == "x":
            got, want, ref = (got - cot.float(), want - cot.float(),
                              ref - cot.float())
        assert torch.isfinite(got).all()
        rel, rel_plain = _rel_l2(got, ref), _rel_l2(want, ref)
        print(f"block {block} {name}: rel_l2 to float32: kernel {rel:.4g}, "
              f"plain bf16 {rel_plain:.4g}")
        if rel > GELU_F32_RATIO * rel_plain:
            bad.append((name, rel, rel_plain))
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("block, frames", [(0, 1), (11, 4)])
def test_fused_block_gelu_probe(card, block, frames):
    """Kernel #1's output against the float32 plain block on the probe
    weights above with pre-activations near -3, where a tanh GELU is ~10%
    off erf (near -2, where its derivative is, its value is as close as a
    bf16 rounding), within GELU_F32_RATIO of the plain bf16 block's
    distance from float32: the W1 epilogue of the fused MLP (96 wide) and
    of the GEMM (768 wide)."""
    from sam2_video_tpu_torch.ops import hiera_block_bwd as hbb

    cfg, params = card
    tcfg = cfg.trunk_config
    specs = tcfg.block_specs()
    spec = specs[block]
    H = cfg.image_size // 4 // 2 ** sum(s["q_pool"] for s in specs[:block])
    gen = torch.Generator().manual_seed(block + 70)
    w = _gelu_probe_leaves(hbb, hbb.leaves(
        params["image_encoder"]["trunk"]["blocks"][str(block)], spec), spec,
        tcfg.mlp_ratio, gen, centre=-3.0)
    x = torch.randn((frames, H, H, spec["dim"]), generator=gen).to(
        "cuda", torch.bfloat16)
    p = hbb.block_params(w, spec)
    got = hbk.fused_block(p, x, spec, tcfg.q_stride).float()
    want = hbk.fused_block_plain(p, x, spec, tcfg.q_stride).float()
    ref = hbk.fused_block_plain(p, x.float(), spec, tcfg.q_stride)
    assert torch.isfinite(got).all()
    rel, rel_plain = _rel_l2(got, ref), _rel_l2(want, ref)
    print(f"block {block}: rel_l2 to float32: kernel {rel:.4g}, plain bf16 "
          f"{rel_plain:.4g}")
    assert rel <= GELU_F32_RATIO * rel_plain, (rel, rel_plain)


@pytest.mark.cuda
def test_all_trainable_step_runs_on_the_card(card):
    """make_train_step with every module trainable on CUDA tensors (it
    raised before kernel #6): the trunk's backward runs the kernel (B1 and
    B2 once per block and clip), the loss is finite and every trunk leaf
    moves."""
    from sam2_video_tpu_torch.data.synthetic import example_clip
    from sam2_video_tpu_torch.models.video_model import VideoModelConfig
    from sam2_video_tpu_torch.ops import hiera_block_bwd as hbb
    from sam2_video_tpu_torch.training import loop
    from sam2_video_tpu_torch.training.losses import LossConfig
    from sam2_video_tpu_torch.training.optimizer import make_optimizer

    cfg = dataclasses.replace(card[0], image_size=128,
                              use_flash_attention=True,
                              use_activation_checkpoint=False)
    params = synthetic_params(cfg, seed=1).to("cuda")
    trainable = ["memory_attention", "memory_encoder", "mask_decoder",
                 "prompt_encoder", "image_encoder"]
    tx = make_optimizer(params, {"lr": 1e-4, "type": "AdamW"},
                        {"enabled": False}, total_steps=10,
                        trainable_modules=trainable)
    step = loop.make_train_step(VideoModelConfig(sam2=cfg), LossConfig(), tx,
                                trainable_modules=trainable)
    before = {n: t.clone() for n, t in params.named_parameters()
              if n.startswith("image_encoder.trunk.")}
    launches = hbb.fused_block_trainable.launches
    _, metrics = step(loop.TrainState.create(params, tx),
                      example_clip(128, T=2, O=2, C=2, B=2))
    assert torch.isfinite(metrics["total_loss"])
    assert hbb.fused_block_trainable.launches == launches + 2 * 12 * 2
    for n, t in before.items():
        assert not torch.equal(dict(params.named_parameters())[n], t), n


# kernel #8: each attention's key-bias gradient is zero in exact arithmetic
# (softmax ignores q . bk, the same for every key of a query), so the kernel
# and the plain bf16 block both return rounding noise there; those three
# are held to the float32 plain block: the kernel's L2 distance from it at
# most ZERO_GRAD_RATIO times the plain bf16 version's (chip_smoke.py).
TWOWAY_ZERO_GRADS = ("self_attn.k_proj.bias",
                     "cross_attn_token_to_image.k_proj.bias",
                     "cross_attn_image_to_token.k_proj.bias")
ZERO_GRAD_RATIO = 3.0


@pytest.mark.cuda
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("O, N, HW", [
    (8, 8, 576), (3, 9, 784),
    (1, 7, 576),       # one object: T = 7 token rows, one split per key tile
    (16, 9, 576),      # T = 144: three 64-row token tiles
    (2, 8, 4096),      # 1024 px: 64 x 64 image rows per object
])
def test_twoway_block_matches_plain(card, first, O, N, HW):
    """Kernel #8 forward and backward against the plain bf16 block (the
    decoder's first or second block, synthetic weights) at the 384 px slice
    shape, a ragged 448 px one, one object, more token rows than one 64-row
    tile, and 1024 px: both outputs and the MLP's hidden activation
    (ReLU'd) within TOL of max(1, max|plain|); the gradients of every
    weight, queries, keys, qpe and kpe within TOL of the plain backward
    taken through the kernel's ReLU mask (a mask bit that differs, which
    the hidden check allows only at pre-activations within TOL of 0, moves
    a whole hidden gradient), the three key-bias gradients against float32
    through the same mask; two backward runs give the same bits (no
    atomics)."""
    from sam2_video_tpu_torch.ops import twoway_kernel as twk

    cfg, params = card
    layer = params["sam_mask_decoder"]["transformer"]["layers"][
        "0" if first else "1"]
    gen = torch.Generator().manual_seed(O * 1000 + HW + first)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)

    inputs = [rnd(O, N, 256), rnd(O, HW, 256), rnd(O, N, 256),
              rnd(HW, 256)] + twk.leaves(layer)
    cots = [rnd(O, N, 256), rnd(O, HW, 256)]

    def block(fn):
        def run(q, k, qpe, kpe, *w):
            return fn(twk.block_params(w), q, k, qpe, kpe, first)
        return run

    probe = [t.detach().clone().requires_grad_(True) for t in inputs]
    hidden = twk.relu_hidden(block(twk.fused_twoway_block)(*probe)[0]).clone()
    mask = hidden > 0
    launches = (twk.fused_twoway_block.launches,
                twk.fused_twoway_block.backward_launches)
    outs, grads = _vjp(block(twk.fused_twoway_block), inputs, cots)
    _, again = _vjp(block(twk.fused_twoway_block), inputs, cots)
    with torch.no_grad(), twk.PlainReluMask(None) as plain:
        p_outs = block(twk.twoway_block_plain)(*inputs)
    with twk.PlainReluMask(mask):
        _, p_grads = _vjp(block(twk.twoway_block_plain), inputs, cots)
        _, f_grads = _vjp(block(twk.twoway_block_plain),
                          [t.float() for t in inputs],
                          [c.float() for c in cots])
    assert (twk.fused_twoway_block.launches,
            twk.fused_twoway_block.backward_launches) == (
        launches[0] + 2, launches[1] + 2)
    for got, want in zip(outs, p_outs, strict=True):
        _assert_close(got, want)
    _assert_close(hidden, torch.relu(plain.pre), msg="MLP hidden")
    names = ["queries", "keys", "qpe", "kpe"] + [".".join(p)
                                                 for p in twk.LEAVES]
    for name, got, same, want, f32 in zip(names, grads, again, p_grads,
                                          f_grads, strict=True):
        assert torch.equal(got, same), name
        if name in TWOWAY_ZERO_GRADS:
            assert torch.isfinite(got).all()
            d_k = (got.float() - f32).norm().item()
            d_p = (want.float() - f32).norm().item()
            assert d_k <= ZERO_GRAD_RATIO * d_p, (name, d_k, d_p)
        else:
            _assert_close(got, want)


def _tree_sum(v):
    """v[..., 0] after v[..., i] += v[..., i + off] for off = W / 2 .. 1: a
    butterfly's sum over the last axis as lane 0 sees it."""
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [7, 8, 9, 576, 784, 4096])
def test_torch_softmax_sum_order(card, D):
    """Kernel #8 sums its softmax denominators in the order of torch's CUDA
    softmax (``csrc/twoway_block.cu`` ``sm_width``, fitted to torch
    2.11.0+cu128), so that its probabilities mostly round as the plain
    block's: torch.softmax of float32 rows of D values equals exp(x - max)
    / L, L summed in that order, bit for bit. D <= 1024: min(32, next power
    of two of D) lanes, lane l adding j = l, l + width, .., then a
    butterfly; above: 1024 threads, a butterfly per warp, then over the 32
    warps. A failure says the torch build sums otherwise: not a kernel
    fault (``test_twoway_block_matches_plain`` holds the gradients through
    the kernel's own ReLU mask, whatever the order), but the kernel's order
    should then follow torch's."""
    rows = 64
    gen = torch.Generator().manual_seed(D)
    x = (3 * torch.randn((rows, D), generator=gen)).to("cuda")
    e = torch.exp(x - x.amax(-1, keepdim=True))
    W = 1024 if D > 1024 else min(32, 1 << (D - 1).bit_length())
    n = -(-D // W)
    part = torch.nn.functional.pad(e, (0, n * W - D)).view(rows, n, W)
    acc = part[:, 0]
    for i in range(1, n):
        acc = acc + part[:, i]
    L = _tree_sum(_tree_sum(acc.view(rows, 32, 32)) if W > 32 else acc)
    assert torch.equal(torch.softmax(x, -1), e / L[:, None])


@pytest.mark.cuda
def test_twoway_kernel_refuses_other_geometries_on_the_card(card):
    """A CUDA tensor of a geometry the kernel does not take raises (the
    JAX package would take its XLA block; the port does not fall back)."""
    from sam2_video_tpu_torch.ops import twoway_kernel as twk

    _, params = card
    layer = params["sam_mask_decoder"]["transformer"]["layers"]["1"]
    x = [torch.zeros(s, device="cuda", dtype=torch.bfloat16)
         for s in ((2, 8, 256), (2, 64, 256), (2, 8, 256), (64, 256))]
    launches = twk.fused_twoway_block.launches
    with pytest.raises(NotImplementedError, match="8 heads"):
        twk.fused_twoway_block(layer, *x, False, heads=4)
    with pytest.raises(NotImplementedError, match="kpe"):
        twk.fused_twoway_block(layer, *x[:3], x[3][:32], False)
    with pytest.raises(TypeError, match="bfloat16"):
        twk.fused_twoway_block(layer, *(t.float() for t in x), False)
    assert twk.fused_twoway_block.launches == launches


# kernel #7, the generic flash attention: its output and dq, dk, dv are
# softmax averages well below 1, so, as for flash_attention_kproj, each is
# held to TOL of its own max|plain| (floor 0)
@pytest.mark.cuda
@pytest.mark.parametrize("lead, Lq, Lk, D, Dv, masked", [
    ((3, 2), 100, 70, 128, 128, False),     # 2 heads, ragged Lq and Lk
    ((2, 2), 64, 580, 128, 128, True),      # one slot + 4 pointers, masked
    ((2,), 33, 130, 256, 128, True),        # one head over 128 channels
    ((2, 4), 40, 200, 64, 64, False),       # 4 heads of d_model 256
    ((1,), 17, 65, 256, 256, False),
    ((2,), 70, 129, 64, 256, True),
])
def test_flash_attention_matches_plain(card, lead, Lq, Lk, D, Dv, masked):
    """Kernel #7 forward and backward (autograd through the plain forward
    with the same cotangent) at small ragged shapes of every width class;
    two backward runs give the same bits."""
    from sam2_video_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(Lq * Lk + D + Dv)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)

    bias = None
    if masked:
        bias = torch.zeros(Lk)
        bias[Lk // 4: Lk // 2] = -1e9
        bias = bias.cuda()
    inputs = [rnd(*lead, Lq, D), rnd(*lead, Lk, D), rnd(*lead, Lk, Dv)]
    cots = [rnd(*lead, Lq, Dv)]

    def run(fn):
        return lambda q, k, v: fn(q, k, v, bias)

    launches = (fa.flash_attention.launches,
                fa.flash_attention.backward_launches)
    _check_vjp(run(fa.flash_attention), run(fa.flash_attention_plain),
               inputs, cots, floor=0.0)
    assert (fa.flash_attention.launches,
            fa.flash_attention.backward_launches) == (launches[0] + 1,
                                                      launches[1] + 1)
    _, first = _vjp(run(fa.flash_attention), inputs, cots)
    _, again = _vjp(run(fa.flash_attention), inputs, cots)
    for a, b in zip(first, again, strict=True):
        assert torch.equal(a, b)


def _flash_case(lead, Lq, Lk, D, Dv, masked, seed):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)

    bias = None
    if masked:
        bias = torch.zeros(Lk)
        bias[Lk // 4: Lk // 2] = -1e9
        bias = bias.cuda()
    return (bias, [rnd(*lead, Lq, D), rnd(*lead, Lk, D), rnd(*lead, Lk, Dv)],
            [rnd(*lead, Lq, Dv)])


def _check_flash(lead, Lq, Lk, D, Dv, masked, splits):
    """Kernel #7 against its plain version, forward and backward, with
    ``splits`` (S of the forward, S of the dq pass) checked first; the
    launch counters move by one each way, and a second run gives the same
    bits."""
    from sam2_video_tpu_torch.ops import flash_attention as fa

    BH = 1
    for n in lead:
        BH *= n
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    got = fa.flash_splits(BH, Lq, Lk, D, Dv, sms)
    assert (got[0][0], got[1][0]) == splits, got
    bias, inputs, cots = _flash_case(lead, Lq, Lk, D, Dv, masked, Lk + Lq)

    def run(fn):
        return lambda q, k, v: fn(q, k, v, bias)

    launches = (fa.flash_attention.launches,
                fa.flash_attention.backward_launches)
    _check_vjp(run(fa.flash_attention), run(fa.flash_attention_plain),
               inputs, cots, floor=0.0)
    assert (fa.flash_attention.launches,
            fa.flash_attention.backward_launches) == (launches[0] + 1,
                                                      launches[1] + 1)
    first = _vjp(run(fa.flash_attention), inputs, cots)
    again = _vjp(run(fa.flash_attention), inputs, cots)
    for a, b in zip([*first[0], *first[1]], [*again[0], *again[1]],
                    strict=True):
        assert torch.equal(a, b)


# the split edges of the split rule on a small grid (2 x 2 batch-heads of
# 100 queries, Lq not a multiple of 64; tests/test_torch_port_flash.py
# test_flash_split_rule): below one split, exactly two of 8 tiles, one key
# past them (two of 9 and 8 tiles, the last holding one key), and D 256
# (two dq column blocks) one key past them
@pytest.mark.cuda
@pytest.mark.parametrize("Lk, D, Dv, masked, splits", [
    (8 * 64 - 1, 128, 128, False, (1, 1)),
    (16 * 64, 128, 128, True, (2, 2)),
    (16 * 64 + 1, 128, 128, False, (2, 2)),
    (16 * 64 + 1, 256, 64, True, (2, 2)),
])
def test_flash_attention_split_edges(card, Lk, D, Dv, masked, splits):
    _check_flash((2, 2), 100, Lk, D, Dv, masked, splits)


# the two-head path's shapes (8 objects x 2 heads, 576 queries, width 128)
# with the split rule: Lk 580 (frame 1, one split), 4068 (frame 9) and
# 4096 (serving, two invalid slots), where the keys split five ways
@pytest.mark.cuda
@pytest.mark.parametrize("Lk, masked, splits", [
    (580, False, (1, 1)), (4068, False, (5, 5)), (4096, True, (5, 5))])
def test_flash_attention_path_shapes(card, Lk, masked, splits):
    _check_flash((8, 2), 576, Lk, 128, 128, masked, splits)


@pytest.mark.cuda
def test_flash_attention_refuses_other_widths_on_the_card(card):
    """A head or value width outside 64 / 128 / 256, or float32, raises on
    a CUDA tensor (the JAX package would take XLA's sdpa; the port does
    not fall back)."""
    from sam2_video_tpu_torch.ops import flash_attention as fa

    x = torch.zeros((2, 16, 96), device="cuda", dtype=torch.bfloat16)
    y = torch.zeros((2, 16, 128), device="cuda", dtype=torch.bfloat16)
    launches = fa.flash_attention.launches
    with pytest.raises(NotImplementedError, match=r"\(64, 128, 256\)"):
        fa.flash_attention(x, x, y)
    with pytest.raises(NotImplementedError, match="Dv 96"):
        fa.flash_attention(y, y, x)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(y.float(), y.float(), y.float())
    assert fa.flash_attention.launches == launches


@pytest.mark.cuda
def test_two_head_memory_attention_runs_flash_attention(card):
    """Memory attention with two heads and use_flash=True on CUDA tensors:
    the cross-attention launches kernel #7 forward in every layer and, under
    autograd, backward; kernels #3-#5 do not run."""
    from sam2_video_tpu_torch.models import memory_attention as ma
    from sam2_video_tpu_torch.ops import flash_attention as fa
    from sam2_video_tpu_torch.ops import memattn_layer_kernel as mlk

    cfg, params = card
    cfg = dataclasses.replace(cfg, use_flash_attention=True,
                              memory_attention_num_heads=2)
    mcfg = cfg.memory_attention_config
    assert mcfg.num_heads == 2 and not ma.fused_eligible(mcfg)
    p = ma.prepare(params["memory_attention"], mcfg)
    gen = torch.Generator().manual_seed(2)
    HW = cfg.num_spatial_tokens
    curr = torch.randn((2, HW, 256), generator=gen).to(
        "cuda", torch.bfloat16).requires_grad_(True)
    mem = torch.randn((2, 2 * HW + 8, 64), generator=gen).to(
        "cuda", torch.bfloat16)
    valid = torch.ones(2 * HW + 8, dtype=torch.bool, device="cuda")
    valid[HW: 2 * HW] = False
    before = (fa.flash_attention.launches,
              fa.flash_attention.backward_launches,
              fa.flash_attention_kproj.launches, mlk.fused_self_block.launches)
    out = ma.apply(p, mcfg, curr, mem, None, mem, feat_hw=(24, 24),
                   num_spatial_k=2 * HW, key_valid=valid)
    out.float().square().sum().backward()
    assert torch.isfinite(out.float()).all()
    assert torch.isfinite(curr.grad.float()).all()
    layers = mcfg.num_layers
    assert (fa.flash_attention.launches,
            fa.flash_attention.backward_launches,
            fa.flash_attention_kproj.launches,
            mlk.fused_self_block.launches) == (
        before[0] + layers, before[1] + layers, before[2], before[3])
