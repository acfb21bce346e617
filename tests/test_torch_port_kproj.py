"""Kernel #3 (``flash_attention_kproj``) of the PyTorch port: what its
wrapper decides on the host, on the CPU. The kernel itself runs only on a
card (``tests/test_torch_port_cuda.py``); its plain version is held to the
JAX Pallas kernel in ``tests/test_torch_port_train_ops.py``.

- ``kproj_plan``: the key splits of the forward and of the dq pass
  (``split_tiles`` with one block per SM), warpgroups per dq block and the
  blocks of the dWk pass, at the paths' shapes and at the split and
  warpgroup edges that the card tests run, on 132 SMs (an H100 SXM); its
  slot-grid limits are those of the CUDA source;
- ``kproj_rope_axes``: the kernel's RoPE factors, one row per slot column
  x and one per slot row y, rebuild the plain version's table bit for bit
  when indexed as the kernel indexes them.
"""

import pathlib
import re

import pytest
import torch

from sam2_video_tpu_torch.ops import flash_attention as tfa


@pytest.mark.parametrize("BH, Lq, Lk, side, want", [
    # the one-head path at 384 px, 8 objects of 576 queries: frame 9 of a
    # training clip (64 key tiles; 40 blocks of 128 queries each way, split
    # 3 ways: 13 splits of 5 tiles would take 4 waves of 5, 20 tiles, but
    # cost 13 combine shares; 509 dWk row tiles, 4 per block)
    (8, 576, 4068, 24, ((3, 22), 2, (3, 22), (128, 4))),
    # frame 1: 10 key tiles, 3 splits of 4 (the last of 2)
    (8, 576, 580, 24, ((3, 4), 2, (3, 4), (73, 1))),
    # frame 3: 28 tiles, 3 splits of 10
    (8, 576, 1732, 24, ((3, 10), 2, (3, 10), (109, 2))),
    # serving: 7 slots and 64 pointer tokens
    (8, 576, 4096, 24, ((3, 22), 2, (3, 22), (128, 4))),
    # 512 px, two clips stacked: 128 blocks already fill the card
    (16, 1024, 7204, 32, ((1, 113), 2, (1, 113), (129, 14))),
    # 448 px, 3 objects: slots of 784 keys straddle key tiles
    (3, 784, 5524, 28, ((6, 15), 2, (6, 15), (130, 2))),
    # 1024 px: two warpgroups do not fit the dq pass's shared memory, so
    # its 64 blocks of 64 queries fill the card without a split
    (2, 4096, 4100, 64, ((2, 33), 1, (1, 65), (129, 1))),
    # the card tests' split edges (2 objects x 100 queries, 2 blocks): 5
    # tiles, no split; 6 tiles, two of 3; 7 tiles, two of 4 and 3 (the
    # last tile holding one key)
    (2, 100, 320, 12, ((1, 5), 2, (1, 5), (10, 1))),
    (2, 100, 384, 12, ((2, 3), 2, (2, 3), (12, 1))),
    (2, 100, 385, 12, ((2, 4), 2, (2, 4), (13, 1))),
    # the card tests' dq warpgroup edges: 34 x 34 slots (w + h = 68, the
    # most two warpgroups take), 35 x 35 (one warpgroup, 4 dq blocks) and
    # 64 x 64 (w + h = 128, the largest grid)
    (2, 100, 2316, 34, ((10, 4), 2, (10, 4), (73, 1))),
    (2, 100, 2454, 35, ((13, 3), 1, (13, 3), (77, 1))),
    (2, 100, 4100, 64, ((13, 5), 1, (13, 5), (129, 1))),
])
def test_kproj_plan(BH, Lq, Lk, side, want):
    plan = tfa.kproj_plan(BH, Lq, Lk, (side, side), sms=132)
    assert tuple(plan) == want
    # every split and every dWk block has work, and they cover the tiles
    tiles, rows = -(-Lk // 64), -(-BH * Lk // 64)
    for S, tps in (plan.fwd, plan.dq):
        assert (S - 1) * tps < tiles <= S * tps
    blocks, per = plan.dw
    assert (blocks - 1) * per < rows <= blocks * per


@pytest.mark.parametrize("name, constant", [
    ("MAX_ROPE_ROWS", "KPROJ_MAX_ROPE_ROWS"),
    ("DQ2_MAX_ROPE_ROWS", "KPROJ_DQ_MAX_ROPE_ROWS"),
])
def test_kproj_grid_limits_match_the_kernel(name, constant):
    """The wrapper plans with the slot-grid limits that the CUDA source
    checks (and static_asserts against its shared memory)."""
    src = (pathlib.Path(tfa.__file__).parent.parent / "csrc" /
           "flash_kproj.cu").read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", src)
    assert found == [str(getattr(tfa, constant))]


@pytest.mark.parametrize("grid_wh", [(6, 6), (12, 12), (24, 24), (28, 28),
                                     (32, 32), (64, 64), (20, 12)])
def test_kproj_rope_axes_rebuild_the_slot_table(grid_wh):
    """Pairs 0..63 of slot position p read row p % w, pairs 64..127 row
    w + p // w: the same bits as the table of the whole slot."""
    gw, gh = grid_wh
    cos, sin = tfa.kproj_rope_tables(256, grid_wh, 10000.0, torch.bfloat16,
                                     "cpu")
    axes = tfa.kproj_rope_axes(cos, sin, gw, gh)
    assert axes.dtype == torch.bfloat16 and axes.shape == (gw + gh, 128)
    axes = axes.float()
    pos = torch.arange(gw * gh)
    x, y = pos % gw, gw + pos // gw
    assert torch.equal(torch.cat([axes[x, :64], axes[y, :64]], 1), cos)
    assert torch.equal(torch.cat([axes[x, 64:], axes[y, 64:]], 1), sin)
