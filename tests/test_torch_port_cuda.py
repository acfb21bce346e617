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
"""

import pytest
import torch

from sam2_video_tpu_torch.data.synthetic import synthetic_params
from sam2_video_tpu_torch.models import memory_encoder as me
from sam2_video_tpu_torch.models import sam2 as sam2_mod
from sam2_video_tpu_torch.ops import common as nn
from sam2_video_tpu_torch.ops import hiera_block_kernel as hbk
from sam2_video_tpu_torch.ops import memory_encoder_kernel as mek

TOL = 2e-2


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = sam2_mod.SAM2Config(image_size=384, use_flash_attention=False)
    return cfg, synthetic_params(cfg, seed=0).to("cuda")


def _assert_close(got, want):
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    scale = max(1.0, want.abs().max().item())
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
