"""Hiera multi-scale vision trunk (counterpart of
``sam2_video_tpu/models/hiera.py``), NHWC activations.

``_block`` is the plain PyTorch block and the plain version of the
hand-written block kernels (``ops/hiera_block_kernel.py`` forward,
``ops/hiera_block_bwd.py`` backward); ``apply`` sends every block through
one of their wrappers.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops import common as nn
from ..ops.attention import merge_heads, sdpa, split_heads
from ..ops.resize import resize_bicubic_torch


@dataclasses.dataclass(frozen=True)
class HieraConfig:
    embed_dim: int = 96
    num_heads: int = 1
    stages: tuple = (2, 3, 16, 3)
    global_att_blocks: tuple = (12, 16, 20)
    window_pos_embed_bkg_spatial_size: tuple = (14, 14)
    window_spec: tuple = (8, 4, 14, 7)
    q_stride: tuple = (2, 2)
    q_pool: int = 3
    dim_mul: float = 2.0
    head_mul: float = 2.0
    mlp_ratio: float = 4.0

    @property
    def depth(self) -> int:
        return sum(self.stages)

    @property
    def stage_ends(self) -> tuple:
        return tuple(sum(self.stages[: i + 1]) - 1
                     for i in range(len(self.stages)))

    @property
    def q_pool_blocks(self) -> tuple:
        return tuple(x + 1 for x in self.stage_ends[:-1])[: self.q_pool]

    def block_specs(self):
        """Per block: dict(dim, dim_out, num_heads, window_size, q_pool)."""
        specs = []
        embed_dim, num_heads = self.embed_dim, self.num_heads
        cur_stage = 1
        for i in range(self.depth):
            dim_out = embed_dim
            window_size = self.window_spec[cur_stage - 1]
            if i in self.global_att_blocks:
                window_size = 0
            if i - 1 in self.stage_ends:
                dim_out = int(embed_dim * self.dim_mul)
                num_heads = int(num_heads * self.head_mul)
                cur_stage += 1
            specs.append(dict(dim=embed_dim, dim_out=dim_out,
                              num_heads=num_heads, window_size=window_size,
                              q_pool=i in self.q_pool_blocks))
            embed_dim = dim_out
        return specs

    @property
    def channel_list(self) -> tuple:
        specs = self.block_specs()
        return tuple(specs[i]["dim_out"] for i in self.stage_ends[::-1])


# Published SAM2.1 presets (sam2.1_hiera_{t,s,b+,l}.yaml).
HIERA_PRESETS = {
    "tiny": HieraConfig(embed_dim=96, num_heads=1, stages=(1, 2, 7, 2),
                        global_att_blocks=(5, 7, 9),
                        window_pos_embed_bkg_spatial_size=(7, 7)),
    "small": HieraConfig(embed_dim=96, num_heads=1, stages=(1, 2, 11, 2),
                         global_att_blocks=(7, 10, 13),
                         window_pos_embed_bkg_spatial_size=(7, 7)),
    "base_plus": HieraConfig(embed_dim=112, num_heads=2, stages=(2, 3, 16, 3),
                             global_att_blocks=(12, 16, 20),
                             window_pos_embed_bkg_spatial_size=(14, 14)),
    "large": HieraConfig(embed_dim=144, num_heads=2, stages=(2, 6, 36, 4),
                         global_att_blocks=(23, 33, 43),
                         window_spec=(8, 4, 16, 8),
                         window_pos_embed_bkg_spatial_size=(7, 7)),
}


def init(gen: torch.Generator, cfg: HieraConfig):
    p = {
        "patch_embed": {"proj": nn.conv2d_init(gen, 3, cfg.embed_dim, 7)},
        # torch layout [1, C, h, w]
        "pos_embed": torch.zeros(
            (1, cfg.embed_dim, *cfg.window_pos_embed_bkg_spatial_size)),
        "pos_embed_window": torch.zeros(
            (1, cfg.embed_dim, cfg.window_spec[0], cfg.window_spec[0])),
        "blocks": {},
    }
    for i, spec in enumerate(cfg.block_specs()):
        blk = {
            "norm1": nn.layer_norm_init(spec["dim"]),
            "attn": {
                "qkv": nn.linear_init(gen, spec["dim"], spec["dim_out"] * 3),
                "proj": nn.linear_init(gen, spec["dim_out"], spec["dim_out"]),
            },
            "norm2": nn.layer_norm_init(spec["dim_out"]),
            "mlp": nn.mlp_init(gen, spec["dim_out"],
                               int(spec["dim_out"] * cfg.mlp_ratio),
                               spec["dim_out"], num_layers=2),
        }
        if spec["dim"] != spec["dim_out"]:
            blk["proj"] = nn.linear_init(gen, spec["dim"], spec["dim_out"])
        p["blocks"][str(i)] = blk
    return p


# ---------------------------------------------------------------------------
# Windowing
# ---------------------------------------------------------------------------


def _window_partition(x: torch.Tensor, ws: int):
    """[B, H, W, C] -> [B*nW, ws, ws, C] and the padded (Hp, Wp). The pad
    is zeros after norm1, so pad tokens are real keys (k = bk, v = bv)."""
    B, H, W, C = x.shape
    pad_h = (ws - H % ws) % ws
    pad_w = (ws - W % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)
    return x, (Hp, Wp)


def _window_unpartition(windows: torch.Tensor, ws: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    C = windows.shape[-1]
    B = windows.shape[0] // (Hp * Wp // ws // ws)
    x = windows.reshape(B, Hp // ws, Wp // ws, ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return x[:, :H, :W]


def _attention(p, x: torch.Tensor, num_heads: int, q_pool: bool, q_stride):
    """qkv (row-sliced into three projections) -> optional 2x2 q max-pool
    -> sdpa -> proj. x [B, H, W, Cin] -> [B, H', W', Cout]."""
    B, H, W, _ = x.shape
    w, b = p["qkv"]["weight"], p["qkv"].get("bias")
    dim_out = w.shape[0] // 3
    q, k, v = (
        nn.linear({"weight": w[i * dim_out:(i + 1) * dim_out],
                   **({"bias": b[i * dim_out:(i + 1) * dim_out]}
                      if b is not None else {})}, x)
        for i in range(3))
    if q_pool:
        q = nn.max_pool2d(q, q_stride[0], q_stride[0])
        H, W = q.shape[1], q.shape[2]
    q = q.reshape(B, H * W, dim_out)
    k = k.reshape(B, -1, dim_out)
    v = v.reshape(B, -1, dim_out)
    if num_heads > 1:
        q, k, v = (split_heads(t, num_heads) for t in (q, k, v))
    out = sdpa(q, k, v)
    if num_heads > 1:
        out = merge_heads(out)
    return nn.linear(p["proj"], out.reshape(B, H, W, dim_out))


def _block(p, x: torch.Tensor, spec, q_stride) -> torch.Tensor:
    """One Hiera block, plain PyTorch (hieradet.py MultiScaleBlock)."""
    shortcut = x
    x = nn.layer_norm(p["norm1"], x, eps=1e-6)
    if spec["dim"] != spec["dim_out"]:
        s = nn.linear(p["proj"], x)
        if spec["q_pool"]:
            s = nn.max_pool2d(s, q_stride[0], q_stride[0])
        shortcut = s

    ws = spec["window_size"]
    if ws > 0:
        H, W = x.shape[1], x.shape[2]
        x, pad_hw = _window_partition(x, ws)

    x = _attention(p["attn"], x, spec["num_heads"], spec["q_pool"], q_stride)
    if spec["q_pool"]:
        ws = spec["window_size"] // q_stride[0]
        H, W = shortcut.shape[1], shortcut.shape[2]
        pad_h = (ws - H % ws) % ws if ws > 0 else 0
        pad_w = (ws - W % ws) % ws if ws > 0 else 0
        pad_hw = (H + pad_h, W + pad_w)

    if spec["window_size"] > 0:
        x = _window_unpartition(x, ws, pad_hw, (H, W))

    x = shortcut + x
    return x + nn.mlp(p["mlp"], nn.layer_norm(p["norm2"], x, eps=1e-6),
                      activation="gelu")


def _get_pos_embed(p, hw):
    h, w = hw
    bkg = resize_bicubic_torch(p["pos_embed"].permute(0, 2, 3, 1), (h, w))
    win = p["pos_embed_window"].permute(0, 2, 3, 1)
    return bkg + win.repeat(1, h // win.shape[1], w // win.shape[2], 1)


def apply(p, x: torch.Tensor, cfg: HieraConfig,
          fused_vjp: bool = False) -> list[torch.Tensor]:
    """x [B, H, W, 3] -> per-stage NHWC features, high-res first (strides
    4, 8, 16, 32). Every block runs through a kernel's wrapper, which takes
    the kernel on a CUDA tensor and its plain version on a CPU tensor: the
    forward-only block kernel (``ops/hiera_block_kernel.py``), or, with
    ``fused_vjp``, the trainable block whose backward is a kernel too
    (``ops/hiera_block_bwd.py``; the JAX package's ``fused_vjp``)."""
    if fused_vjp:
        from ..ops.hiera_block_bwd import fused_block_trainable as block
    else:
        from ..ops.hiera_block_kernel import fused_block as block

    x = nn.conv2d(p["patch_embed"]["proj"], x, stride=4, padding=3)
    x = x + _get_pos_embed(p, x.shape[1:3]).to(x.dtype)
    outputs = []
    stage_ends = set(cfg.stage_ends)
    for i, spec in enumerate(cfg.block_specs()):
        x = block(p["blocks"][str(i)], x, spec, cfg.q_stride, cfg.mlp_ratio)
        if i in stage_ends:
            outputs.append(x)
    return outputs
