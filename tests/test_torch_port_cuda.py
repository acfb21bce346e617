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


def _assert_close(got, want, floor=1.0):
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    scale = max(floor, want.abs().max().item())
    assert (got - want).abs().max().item() <= TOL * scale


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
    from sam2_video_tpu_torch.ops import memattn_layer_kernel as mlk
    from sam2_video_tpu_torch.ops.position_encoding import \
        axial_rope_table_half

    cfg, params = card
    lp = _layer(params, cfg)
    sp, cp = lp["self_attn"], lp["cross_attn_image"]
    F = image_size // 16
    gen = torch.Generator().manual_seed(image_size)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)

    cos, sin = axial_rope_table_half(256, F, F, device="cuda")
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

    x = rnd(objects, F * F, 256)
    launches = (mlk.fused_self_block.launches,
                mlk.fused_self_block.backward_launches)
    _check_vjp(self_fn(mlk.fused_self_block),
               self_fn(mlk.fused_self_block_plain), [x] + w,
               [rnd(*x.shape), rnd(*x.shape)])
    assert (mlk.fused_self_block.launches,
            mlk.fused_self_block.backward_launches) == \
        (launches[0] + 1, launches[1] + 1)

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

    _check_vjp(tail_fn(mlk.fused_tail_block),
               tail_fn(mlk.fused_tail_block_plain),
               [x, rnd(objects, F * F, 64)] + t, [rnd(*x.shape)],
               grads_vs_f32=image_size == 512)


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
        # 64 (1024 px), the largest grid the kernel takes
        (544, 2, 100, 2, 4, False, (10, 10, 2)),
        (560, 2, 100, 2, 4, True, (13, 13, 1)),
        (1024, 2, 100, 1, 4, False, (13, 13, 1)),
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
# contribution between two tokens)
POOL_REL_L2 = 5e-2
POOL_ROUTED = ("x", "norm1.weight", "attn.qkv.weight", "proj.weight")


@pytest.mark.cuda
@pytest.mark.parametrize("image_size", [384, 512])
def test_trainable_block_backward_matches_plain(card, image_size):
    """Kernel #6 (B1 + B2 through ``fused_block_trainable``) against
    autograd through the plain bf16 block, every block of the tiny trunk
    (every geometry class: windows with and without pad, q-pool with even
    and odd pooled windows, global 24x24 and 32x32, stage 4), two frames:
    dx and every parameter gradient within TOL of max(1, max|plain|), those
    a 2x2 max-pool routes on q-pool blocks within POOL_REL_L2. Two
    backward runs give the same bits (no atomics)."""
    from sam2_video_tpu_torch.ops import hiera_block_bwd as hbb

    cfg, params = card
    tcfg = cfg.trunk_config
    trunk = params["image_encoder"]["trunk"]
    gen = torch.Generator().manual_seed(image_size + 6)
    H = image_size // 4
    launches = hbb.fused_block_trainable.launches
    for i, spec in enumerate(tcfg.block_specs()):
        bp = trunk["blocks"][str(i)]
        x = torch.randn((2, H, H, spec["dim"]), generator=gen).to(
            "cuda", torch.bfloat16)

        def block(fn):
            def run(x, *w):
                return fn(hbb.block_params(w, spec), x, spec, tcfg.q_stride,
                          tcfg.mlp_ratio)
            return run

        inputs = [x] + hbb.leaves(bp, spec)
        with torch.no_grad():
            shape = block(hbb.fused_block_trainable_plain)(*inputs).shape
        cot = torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)
        outs, grads = _vjp(block(hbb.fused_block_trainable), inputs, [cot])
        _, again = _vjp(block(hbb.fused_block_trainable), inputs, [cot])
        p_outs, p_grads = _vjp(block(hbb.fused_block_trainable_plain),
                               inputs, [cot])
        _assert_close(outs[0], p_outs[0])
        names = ["x"] + [".".join(pt) for pt in hbb.paths(spec)]
        for name, got, same, want in zip(names, grads, again, p_grads,
                                         strict=True):
            assert torch.equal(got, same), (i, name)
            if spec["q_pool"] and name in POOL_ROUTED:
                assert torch.isfinite(got).all()
                assert _rel_l2(got, want) <= POOL_REL_L2, (i, name)
            else:
                _assert_close(got, want)
        if spec["q_pool"]:
            H //= 2
    assert hbb.fused_block_trainable.launches == launches + 2 * 2 * 12


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
@pytest.mark.parametrize("O, N, HW", [(8, 8, 576), (3, 9, 784)])
def test_twoway_block_matches_plain(card, first, O, N, HW):
    """Kernel #8 forward and backward against the plain bf16 block (the
    decoder's first or second block, synthetic weights) at the 384 px slice
    shape and a ragged 448 px one: both outputs and the gradients of every
    weight, queries, keys, qpe and kpe within TOL of max(1, max|plain|),
    the three key-bias gradients against float32; two backward runs give
    the same bits (no atomics)."""
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

    launches = (twk.fused_twoway_block.launches,
                twk.fused_twoway_block.backward_launches)
    outs, grads = _vjp(block(twk.fused_twoway_block), inputs, cots)
    _, again = _vjp(block(twk.fused_twoway_block), inputs, cots)
    p_outs, p_grads = _vjp(block(twk.twoway_block_plain), inputs, cots)
    _, f_grads = _vjp(block(twk.twoway_block_plain),
                      [t.float() for t in inputs], [c.float() for c in cots])
    assert (twk.fused_twoway_block.launches,
            twk.fused_twoway_block.backward_launches) == (
        launches[0] + 2, launches[1] + 2)
    for got, want in zip(outs, p_outs, strict=True):
        _assert_close(got, want)
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
