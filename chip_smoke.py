#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (sam2_video_tpu_torch) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py [--seed 0]
        [--phases build,kernels,train,train_all,train_cpu,serve,cpu]

Phases (all by default):
  build      compile every CUDA kernel from csrc/ (one nvcc per source, all
             started together)
  kernels    each kernel against its plain PyTorch version at the shapes
             the training and serving paths give it, with error, tolerance
             and CUDA-event times: #1 fused_block (12 trunk blocks, one
             8-frame encode chunk at 384 px; device ms and device
             operations per block beside plain's, a second run
             bit-equal), #2 fused_memory_encoder (8 objects, the same; and
             checked at 1, 3 and 16 objects and on a 1024 px mask, a 64 x
             64 grid, MEMENC_SIZES), and, forward and backward (autograd through the
             plain forward, one random cotangent), #4 fused_self_block and
             #5 fused_tail_block (8 objects, 576 tokens; also 3 x 784
             tokens at 448 px and 2 x 36 at 96 px, which the wrappers pad
             to a multiple of 32; device ms and device operations of one
             call beside plain's, a second run bit-equal) and #3
             flash_attention_kproj (Lk 580 and
             4068 in training, 4096 with two invalid slots in serving; its
             limit is 2e-2 of max|plain| of each tensor, the others' of
             max(1, max|plain|)); #6, the
             trunk's backward (B1 + B2 of fused_block_trainable), for each
             of the 12 blocks (every geometry class) at 10 frames of 384 px,
             dx and every parameter gradient (on q-pool blocks, those a 2x2
             max-pool routes by relative L2, POOL_REL_L2); #8
             fused_twoway_block, forward and backward, the decoder's first
             and second block at 8 objects x 8 tokens x 576 keys, 3 x 9
             x 784 (448 px), 1 x 7 x 576, 16 x 9 x 576 and 2 x 8 x 4096
             (1024 px), every output and gradient (the three key-bias
             gradients, zero in exact arithmetic, against float32:
             TWOWAY_ZERO_GRADS), and its device operations per call
             against the plain block's; #7 flash_attention, forward and
             backward, at the two-head path's shapes (8 objects x 2 heads,
             576 queries, head and value width 128, Lk 580 and 4068 in
             training, 4096 with two invalid slots in serving) and one head
             over 128-channel memory (8 x 1, width 256, values 128), and at
             the split rule's edges on a small grid, each tensor within
             2e-2 of its own max|plain|, with the key splits, the device
             operations, launches and device ms of one call, beside
             F.scaled_dot_product_attention forward and backward (CUDA
             events and device ms);
             and SAM2-base+ and SAM2-large (phase_presets): forward_image
             at 384 px, 2 frames, against the CPU float32 trunk, a
             trainable trunk pass, #1 / #6 per trunk pass and #6 per
             geometry class against plain
  train      the headline train step (SAM2-tiny 384 px, bf16, T=10, O=8,
             C=7, B=2, point prompts, trainable memory attention and memory
             encoder, AdamW lr 1e-4): 1 warm-up and 5 timed steps; finite
             losses, frozen leaves bit-for-bit unchanged, every memory
             attention leaf moved, every kernel (and the three backward
             programs) launched but #6, #7 and #8; then the same step with
             two memory-attention heads (memory_attention_num_heads=2: the
             cross-attention through #7 forward and backward, 72 calls
             each per step, and #3-#5 not launched)
  train_all  the all-trainable step (the same shapes, every module but the
             pointer projections trainable: the trunk runs #1 forward and
             #6 backward): 1 warm-up and 5 timed steps; finite losses,
             every image encoder leaf moved and every decoder and prompt
             encoder leaf with a gradient, every kernel launched but #8;
             then the same step with fused_twoway=True against it unfused
             on the card (loss, each top-level gradient; #8 forward and
             backward launched), 3 timed steps of each in turns, and the
             memory-only step fused (#8's backward for the input
             gradients)
  train_cpu  one step of a short clip (T=3, O=4, 384 px) on the card (bf16)
             and on the CPU (float32, plain versions), memory-only,
             all-trainable and memory-only with two memory-attention heads:
             loss and each trainable top-level entry's gradient must agree
  serve      the streaming VideoPredictor in the usual configuration
             (use_flash_attention=True, 384 px, bf16, 8 objects, 7 memory
             slots): 2 synthetic 480x854 videos, point prompts on frame 0,
             propagate; encode and propagate frames/s; every forward kernel
             but #8 must have launched; then 4 frames with
             use_flash_attention=False (plain memory attention); then one
             8-frame video with fused_twoway=True (#8 forward in the
             conditioning and every tracked step) beside it unfused:
             logits within relative L2 0.1, propagate frames/s and device
             operations per tracked frame of each; then one 8-frame video
             with two memory-attention heads (#7 forward, 4 calls per
             tracked frame, #3-#5 not launched) beside one head, in turns
  cpu        the first 4 frames of one video on the card and on the CPU in
             float32 (plain versions), with one and with two memory-
             attention heads; low-res logits must agree

Weights are ``synthetic_params``: the port's seeded random init moved off
its constants (every parameter + 0.05 N(0, 1), the memory encoder's CXBlock
layer scales, 1e-6 at init, drawn O(1), so the kernel check sees both
CXBlocks) and the object-score head's last bias at +10, so every object
reads present and the card-vs-CPU check compares mask logits rather than a
presence threshold. TF32 is off for both matmuls and cuDNN. The last lines
are the card's name and power limit, a JSON line of per-kernel numbers
(``launches`` from the train phase, #6's from train_all, #7's from the
two-head train steps, #8's from the fused all-trainable steps, else the
serve phase, else null), and
{"ok": true, "device": ...}.
The script needs the repository beside it and a CUDA device; without
either it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from sam2_video_tpu_torch.data.synthetic import (prompt_all, synthetic_params,
                                                 synthetic_video)
from sam2_video_tpu_torch.models import memory_encoder as me

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
KERNEL_TOL = 2e-2             # of max(1, |plain|): bf16 rounding points differ
# the attention kernels' outputs and input gradients (#3's out, dq, dkin,
# dv; #7's out, dq, dk, dv) are softmax averages of O(1) values, well below
# 1: their limit is KERNEL_TOL of max|plain| itself
ATTENTION_FLOOR = 0.0
CPU_REL_L2_TOL = 0.1          # card bf16 vs CPU float32, over 4 frames
PHASES = ("build", "kernels", "train", "train_all", "train_cpu", "serve",
          "cpu")
DEVICE = "cuda"
FRAMES, OBJECTS, CHUNK = 16, 8, 8   # frames per video, objects, encode chunk
TINY_GEOMETRY = {0: "window 8, no pad", 1: "q-pool, even window 8",
                 4: "window 14, pad 24->28", 5: "global 24x24",
                 10: "q-pool, odd pooled window 7", 11: "stage 4, pad 12->14"}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ---------------------------------------------------------------------------
# kernels vs plain
# ---------------------------------------------------------------------------


def block_cost(spec, B: int, H: int, W: int, mlp_ratio: float, bp, x, out):
    """(flops, bytes) of one Hiera block at this geometry. Products: qkv
    (and the dim-change shortcut) over the B*H*W input tokens; attention
    for the queries that survive the crop (B*H'*W', pooled where q-pool),
    each against every key of its window, pad keys included (they are real
    keys); out projection and MLP over the output tokens. Bytes: the
    activation and the bf16 weights read once, the output written once."""
    ci, co = spec["dim"], spec["dim_out"]
    hid = int(co * mlp_ratio)
    ws = spec["window_size"]
    keys = H * W if ws == 0 else ws * ws
    Mi, Mo = B * H * W, out.shape[0] * out.shape[1] * out.shape[2]
    flops = 2 * Mi * ci * 3 * co + 2 * Mo * co * co + 4 * Mo * co * hid
    flops += 4 * Mo * keys * co                        # QK^T and PV, all heads
    if ci != co:
        flops += 2 * Mi * ci * co
    weights = sum(2 * t.numel() for t in bp.parameters())
    return flops, _nbytes(x, out) + weights


def memory_encoder_cost(mcfg, masks, pix, out, p):
    """(flops, bytes) of the memory encoder from the s2d mask and the
    projected pixels: each k3/s2 downsampler conv at its own output
    resolution (9 taps x Cin x Cout per output pixel), the final 1x1, two
    CXBlocks (depthwise 7x7, 256 -> 1024 -> 256) and out_proj; every
    product counted at the bf16 tensor-core peak. Bytes: inputs, output
    and the bf16 weights the function uses, each once."""
    N, h, w, out_dim = out.shape
    M, C = N * h * w, mcfg.fuser_dim
    flops = sum(2 * 9 * N * (h * go) * (w * go) * co * ci
                for ci, _, co, go in me.GEOMETRY)
    flops += 2 * M * C * C
    flops += mcfg.fuser_num_layers * (
        2 * M * C * mcfg.fuser_kernel ** 2 + 2 * 2 * M * C * 4 * C)
    flops += 2 * M * C * out_dim
    weights = sum(2 * t.numel() for n, t in p.named_parameters()
                  if not n.startswith("pix_feat_proj"))
    return flops, _nbytes(masks, pix, out) + weights


# kernel #2's other sizes in phase_kernels: (objects, image size)
MEMENC_SIZES = ((1, 384), (3, 384), (16, 384), (8, 1024))


def phase_kernels(params, cfg, seed: int, chunk: int, objects: int):
    from sam2_video_tpu_torch.ops import common as nn
    from sam2_video_tpu_torch.ops import hiera_block_kernel as hbk
    from sam2_video_tpu_torch.ops import memory_encoder_kernel as mek

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    trunk_cfg = cfg.trunk_config
    trunk = params["image_encoder"]["trunk"]
    rows = []

    # fused_block: every block of the trunk, one encode chunk at 384 px
    H = cfg.image_size // 4
    k_ms = p_ms = b_ms = dk_ms = dp_ms = 0.0
    worst_abs, worst_rel, flops_all, bytes_all = 0.0, 0.0, 0.0, 0.0
    for i, spec in enumerate(trunk_cfg.block_specs()):
        bp = trunk["blocks"][str(i)]
        x = torch.randn((chunk, H, H, spec["dim"]), generator=gen).to(
            dev, torch.bfloat16)
        got = hbk.fused_block(bp, x, spec, trunk_cfg.q_stride,
                              trunk_cfg.mlp_ratio)
        want = hbk.fused_block_plain(bp, x, spec, trunk_cfg.q_stride,
                                     trunk_cfg.mlp_ratio)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = max(1.0, want.float().abs().max().item())
        finite = bool(torch.isfinite(got.float()).all())
        same = torch.equal(got, hbk.fused_block(bp, x, spec,
                                                trunk_cfg.q_stride,
                                                trunk_cfg.mlp_ratio))
        ok = finite and err <= KERNEL_TOL * scale and same
        t_k = cuda_ms(lambda: hbk.fused_block(bp, x, spec, trunk_cfg.q_stride,
                                              trunk_cfg.mlp_ratio))
        t_p = cuda_ms(lambda: hbk.fused_block_plain(bp, x, spec,
                                                    trunk_cfg.q_stride))
        l_k = _device_launches(lambda: hbk.fused_block(
            bp, x, spec, trunk_cfg.q_stride, trunk_cfg.mlp_ratio))
        l_p = _device_launches(lambda: hbk.fused_block_plain(
            bp, x, spec, trunk_cfg.q_stride))
        fl, nb = block_cost(spec, chunk, H, H, trunk_cfg.mlp_ratio, bp, x, got)
        b, by = bound_ms(fl, nb)
        k_ms, p_ms, b_ms = k_ms + t_k, p_ms + t_p, b_ms + b
        dk_ms, dp_ms = dk_ms + l_k[2], dp_ms + l_p[2]
        flops_all, bytes_all = flops_all + fl, bytes_all + nb
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale)
        print(f"fused_block[{i:2d}] {TINY_GEOMETRY.get(i, ''):28s} "
              f"x{tuple(x.shape)} max_abs_err={err:.4g} "
              f"tol={KERNEL_TOL * scale:.4g} kernel_ms={t_k:.4f} "
              f"plain_ms={t_p:.4f} bound_ms={b:.4f}({by}) "
              f"{_ops_text(l_k, l_p)} same_bits_twice={same} "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"fused_block block {i} disagrees with its "
                             f"plain version ({err} > {KERNEL_TOL * scale}) "
                             f"or with itself on a second run")
        if spec["q_pool"]:
            H //= 2
    _, by_all = bound_ms(flops_all, bytes_all)
    rows.append(dict(name="fused_block", route="cuda",
                     source="sam2_video_tpu_torch/csrc/hiera_block.cu",
                     replaces="sam2_video_tpu/ops/hiera_block_kernel.py:399",
                     max_abs_err=worst_abs, ms=k_ms, plain_ms=p_ms,
                     bound_ms=b_ms, bound_by=by_all, library_ms=None))
    print(f"fused_block trunk total (12 blocks, {chunk} frames): "
          f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} "
          f"device_ms={dk_ms:.4f} (plain {dp_ms:.4f}) "
          f"max_abs_err={worst_abs:.4g} max_err/scale={worst_rel:.4g}",
          flush=True)

    # fused_memory_encoder at O objects, 384 px (the JSON row), then at
    # other object counts and a 64 x 64 grid (1024 px)
    mcfg = cfg.memory_encoder_config
    pme = params["memory_encoder"]
    for O, S in ((objects, cfg.image_size), *MEMENC_SIZES):
        h = S // 16
        logits = 8.0 * torch.randn((O, S, S, 1), generator=gen)
        masks = (torch.sigmoid(logits) * 20.0 - 10.0).to(dev, torch.bfloat16)
        pix = torch.randn((O, h, h, 256), generator=gen).to(
            dev, torch.bfloat16)
        pix_proj = nn.conv2d(pme["pix_feat_proj"], pix)
        got = mek.fused_memory_encoder(pme, mcfg, pix_proj, masks)
        want = mek.fused_memory_encoder_plain(pme, mcfg, pix_proj, masks)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = max(1.0, want.float().abs().max().item())
        same = torch.equal(got, mek.fused_memory_encoder(pme, mcfg, pix_proj,
                                                         masks))
        ok = (bool(torch.isfinite(got.float()).all())
              and err <= KERNEL_TOL * scale and same)
        label = (f"fused_memory_encoder O={O} masks{tuple(masks.shape)} "
                 f"max_abs_err={err:.4g} tol={KERNEL_TOL * scale:.4g} "
                 f"same_bits_twice={same}")
        if O != objects or S != cfg.image_size:
            print(f"{label} {'OK' if ok else 'FAIL'}", flush=True)
        else:
            t_k = cuda_ms(lambda: mek.fused_memory_encoder(pme, mcfg,
                                                           pix_proj, masks))
            t_p = cuda_ms(lambda: mek.fused_memory_encoder_plain(
                pme, mcfg, pix_proj, masks))
            l_k = _device_launches(lambda: mek.fused_memory_encoder(
                pme, mcfg, pix_proj, masks))
            l_p = _device_launches(lambda: mek.fused_memory_encoder_plain(
                pme, mcfg, pix_proj, masks))
            fl, nb = memory_encoder_cost(mcfg, masks, pix_proj, got, pme)
            b, by = bound_ms(fl, nb)
            print(f"{label} kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
                  f"bound_ms={b:.4f}({by}) {_ops_text(l_k, l_p)} "
                  f"{'OK' if ok else 'FAIL'}", flush=True)
            rows.append(dict(name="fused_memory_encoder", route="cuda",
                             source="sam2_video_tpu_torch/csrc/"
                                    "memory_encoder.cu",
                             replaces=("sam2_video_tpu/ops/"
                                       "memory_encoder_kernel.py:273"),
                             max_abs_err=err, ms=t_k, plain_ms=t_p,
                             bound_ms=b, bound_by=by, library_ms=None))
        if not ok:
            raise SystemExit(f"fused_memory_encoder at O={O}, {S} px "
                             f"disagrees with its plain version ({err} > "
                             f"{KERNEL_TOL * scale}) or with itself on a "
                             f"second run")
    return rows


def kproj_cost(BH, Lq, Lk, backward: bool, tensors):
    """(flops, bytes) of flash_attention_kproj. Forward: the key projection
    once per key (2 Lk 64 256), QK^T (2 Lq Lk 256) and PV (2 Lq Lk 64) per
    object. Backward, from the saved q, kin, v, out and lse: the projection
    and QK^T again, dP, dV (2 Lq Lk 64 each), dQ, dK (2 Lq Lk 256 each),
    dkin and dWk (2 Lk 256 64 each). Bytes: every input read once, every
    output written once."""
    proj, qk, pv = 2 * Lk * 64 * 256, 2 * Lq * Lk * 256, 2 * Lq * Lk * 64
    flops = proj + qk + pv if not backward else \
        3 * proj + 3 * qk + 2 * pv
    return BH * flops, _nbytes(*tensors)


def flash_cost(BH, Lq, Lk, D, Dv, backward: bool, tensors):
    """(flops, bytes) of flash_attention. Forward: QK^T (2 Lq Lk D) and PV
    (2 Lq Lk Dv) per batch-head. Backward, from the saved q, k, v, out and
    lse: QK^T again, dQ and dK (2 Lq Lk D each), dP and dV (2 Lq Lk Dv
    each). Bytes: every input read once, every output written once."""
    qk, pv = 2 * Lq * Lk * D, 2 * Lq * Lk * Dv
    flops = qk + pv if not backward else 3 * qk + 2 * pv
    return BH * flops, _nbytes(*tensors)


def self_block_cost(N, L, backward: bool, tensors):
    """(flops, bytes) of fused_self_block: forward qkv (2 L 256 768), the
    scores and PV (2 L L 256 each), out-proj and the cross q-proj (2 L 256
    256 each) per object; backward recomputes all but the q-proj and adds
    the q-proj's two products, out-proj's two, the attention's four L x L
    products and qkv's two (2 L 256 768 each)."""
    D = 256
    lin, qkv, att = 2 * L * D * D, 2 * L * D * 3 * D, 2 * L * L * D
    flops = qkv + 2 * att + 2 * lin if not backward else \
        (qkv + 2 * att + lin) + 4 * lin + 4 * att + 2 * qkv
    return N * flops, _nbytes(*tensors)


def tail_block_cost(N, L, kv, hid, backward: bool, tensors):
    """(flops, bytes) of fused_tail_block: v-proj (2 L kv 256), out-proj
    (2 L 256 256), linear1 and linear2 (2 L 256 hid each) per object;
    backward recomputes all but linear2 and adds two products for each of
    the four linears."""
    D = 256
    vp, op, mlp = 2 * L * kv * D, 2 * L * D * D, 2 * L * D * hid
    flops = vp + op + 2 * mlp if not backward else \
        (vp + op + mlp) + 2 * (vp + op + 2 * mlp)
    return N * flops, _nbytes(*tensors)


def _check_grads(label, got, want, failures, floor: float = 1.0):
    """Worst err / scale over the tensors of one kernel call; a tensor
    outside KERNEL_TOL of max(floor, max|plain|) is added to
    ``failures``."""
    worst_err, worst_rel, each = 0.0, 0.0, []
    for name, a, b in zip(label, got, want, strict=True):
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        scale = max(floor, b.abs().max().item())
        each.append(f"{name}: {err / scale:.3g}")
        if not (bool(torch.isfinite(a).all()) and err <= KERNEL_TOL * scale):
            failures.append(f"{name}: kernel disagrees with its plain "
                            f"version: max_abs_err {err:.4g} > "
                            f"{KERNEL_TOL * scale:.4g}")
            print("FAIL " + failures[-1], flush=True)
        worst_err = max(worst_err, err)
        worst_rel = max(worst_rel, err / scale)
    print("  err/scale " + ", ".join(each), flush=True)
    return worst_err, worst_rel


def _leaves(tensors):
    return [t.detach().clone().requires_grad_(True) for t in tensors]


def _time_backward(outs, inputs, cots):
    """ms of one backward through the graph of ``outs``."""
    return cuda_ms(lambda: torch.autograd.grad(outs, inputs, cots,
                                               retain_graph=True))


def _kernel_row(name, source, replaces, err, t_k, t_p, cost, library=None):
    b, by = bound_ms(*cost)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b,
                bound_by=by, library_ms=library)


def _ops_text(k, p) -> str:
    """Device operations / launches and device ms of one kernel call and
    one plain call (_device_launches)."""
    return (f"device_ops/launches={k[0]}/{k[1]} device_ms={k[2]:.4f} "
            f"(plain {p[0]}/{p[1]}, {p[2]:.4f})")


def _print_row(label, err, rel, r):
    print(f"{label} max_abs_err={err:.4g} max_err/scale={rel:.4g} "
          f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
          f"bound_ms={r['bound_ms']:.4f}({r['bound_by']})"
          + (f" library_ms={r['library_ms']:.4f}" if r["library_ms"]
             else ""), flush=True)


def _twice_same(label, outs, grads, again, failures):
    """A failure for each tensor of a second run (outputs, then gradients)
    that is not bit-equal to the first."""
    for i, (a, b) in enumerate(zip([*outs, *grads], [*again[0], *again[1]],
                                   strict=True)):
        if not torch.equal(a, b):
            failures.append(f"{label} tensor {i}: two runs differ")
            print("FAIL " + failures[-1], flush=True)


def phase_memattn_kernels(params, cfg, seed: int, objects: int):
    """Kernels #4 and #5, forward and backward, against their plain
    versions (backward: autograd through the plain forward with the same
    random cotangent) at the training shapes: 8 objects, 576 tokens; also
    at 3 objects x 784 tokens (448 px) and 2 x 36 (96 px), which the
    wrappers pad to a multiple of 32. For kernel and plain version, each
    way: CUDA-event ms, and the device operations, launches and device ms
    of one call (torch.profiler); a second kernel run must give the same
    bits in every output and gradient. Returns the rows of the JSON line
    (576 tokens)."""
    from sam2_video_tpu_torch.models import memory_attention as ma
    from sam2_video_tpu_torch.ops import memattn_layer_kernel as mlk
    from sam2_video_tpu_torch.ops.position_encoding import \
        axial_rope_table_half

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(seed + 7)
    mcfg = cfg.memory_attention_config
    lp = ma.prepare(params["memory_attention"], mcfg)["layers"]["0"]
    sp, cp = lp["self_attn"], lp["cross_attn_image"]
    F_, O = cfg.feat_size, objects
    D, KV = cfg.d_model, cfg.mem_dim

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(
            dev, torch.bfloat16)

    rows, failures = [], []
    src = "sam2_video_tpu_torch/csrc/memattn_layer.cu"
    rep = "sam2_video_tpu/ops/memattn_layer_kernel.py"

    # ---- fused_self_block and fused_tail_block (hidden 2048) at the
    # training grid (the JSON rows) and at two token counts that are not
    # multiples of 32, which the wrappers pad: 28 x 28 (448 px) and 6 x 6
    # (96 px, the synthetic combo)
    names = ["ln1w", "ln1b", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
             "ln2w", "ln2b", "wqc", "bqc"]
    qp, kp = sp["_qp"], sp["_kp"]
    w0 = [lp["norm1"]["weight"], lp["norm1"]["bias"], qp["weight"],
          qp["bias"], kp["weight"], kp["bias"], sp["v_proj"]["weight"],
          sp["v_proj"]["bias"], sp["out_proj"]["weight"],
          sp["out_proj"]["bias"], lp["norm2"]["weight"],
          lp["norm2"]["bias"], cp["_qp"]["weight"], cp["_qp"]["bias"]]
    t0 = [cp["v_proj"]["weight"], cp["v_proj"]["bias"],
          cp["out_proj"]["weight"], cp["out_proj"]["bias"],
          lp["norm3"]["weight"], lp["norm3"]["bias"],
          lp["linear1"]["weight"], lp["linear1"]["bias"],
          lp["linear2"]["weight"], lp["linear2"]["bias"]]
    HID = t0[6].shape[0]

    def self_args(w):
        lin = lambda i: {"weight": w[i], "bias": w[i + 1]}  # noqa: E731
        return ({"q": lin(2), "k": lin(4), "v": lin(6), "out": lin(8)},
                lin(12), lin(0), lin(10))

    def tail_args(w):
        lin = lambda i: {"weight": w[i], "bias": w[i + 1]}  # noqa: E731
        return lin(0), lin(2), lin(4), lin(6), lin(8)

    for side, nobj in ((F_, O), (28, 3), (6, 2)):
        Lg = side * side
        cs, sn = axial_rope_table_half(D, side, side, mcfg.rope_theta,
                                       device=dev)
        x = rnd(nobj, Lg, D)
        cots = [rnd(nobj, Lg, D), rnd(nobj, Lg, D)]
        res = {}
        for kind, fn in (("kernel", mlk.fused_self_block),
                         ("plain", mlk.fused_self_block_plain)):
            w, xl = _leaves(w0), x.detach().clone().requires_grad_(True)
            outs = fn(*self_args(w), xl, cs, sn)
            grads = torch.autograd.grad(outs, [xl] + w, cots,
                                        retain_graph=True)
            t_f = cuda_ms(lambda: fn(*self_args(w), xl, cs, sn))
            t_b = _time_backward(outs, [xl] + w, cots)
            ops = (_device_launches(lambda: fn(*self_args(w), xl, cs, sn)),
                   _device_launches(lambda: torch.autograd.grad(
                       outs, [xl] + w, cots, retain_graph=True)))
            if kind == "kernel":
                o2 = fn(*self_args(w), xl, cs, sn)
                _twice_same(f"self L={Lg}", outs, grads,
                            (o2, torch.autograd.grad(o2, [xl] + w, cots)),
                            failures)
            res[kind] = (outs, grads, t_f, t_b, ops)
        torch.cuda.synchronize()
        (ko, kg, kf, kb, kops), (po, pg, pf, pb, pops) = (res["kernel"],
                                                          res["plain"])
        err, rel = _check_grads([f"self out L={Lg}", f"self q3 L={Lg}"], ko,
                                po, failures)
        wb = _nbytes(*w0) // 2
        fl, nb = self_block_cost(nobj, Lg, False, [x, *ko])
        r = _kernel_row("fused_self_block", src, f"{rep}:382", err, kf, pf,
                        (fl, nb + wb))
        _print_row(f"fused_self_block x{tuple(x.shape)} "
                   f"{_ops_text(kops[0], pops[0])}; events:", err, rel, r)
        if side == F_:
            rows.append(r)
        err, rel = _check_grads(
            [f"self d{n} L={Lg}" for n in ["x"] + names], kg, pg, failures)
        fl, nb = self_block_cost(nobj, Lg, True, [x, *cots, *kg])
        r = _kernel_row("fused_self_block_bwd", src, f"{rep}:402", err, kb,
                        pb, (fl, nb + wb))
        _print_row(f"fused_self_block backward L={Lg} "
                   f"{_ops_text(kops[1], pops[1])}; events:", err, rel, r)
        if side == F_:
            rows.append(r)

        y, a = rnd(nobj, Lg, D), rnd(nobj, Lg, KV)
        cot = rnd(nobj, Lg, D)
        res = {}
        for kind, fn in (("kernel", mlk.fused_tail_block),
                         ("plain", mlk.fused_tail_block_plain)):
            w = _leaves(t0)
            yl, al = (t.detach().clone().requires_grad_(True) for t in (y, a))
            out = fn(*tail_args(w), yl, al)
            grads = torch.autograd.grad(out, [yl, al] + w, cot,
                                        retain_graph=True)
            t_f = cuda_ms(lambda: fn(*tail_args(w), yl, al))
            t_b = _time_backward(out, [yl, al] + w, cot)
            ops = (_device_launches(lambda: fn(*tail_args(w), yl, al)),
                   _device_launches(lambda: torch.autograd.grad(
                       out, [yl, al] + w, cot, retain_graph=True)))
            if kind == "kernel":
                o2 = fn(*tail_args(w), yl, al)
                _twice_same(f"tail L={Lg}", [out], grads,
                            ([o2], torch.autograd.grad(o2, [yl, al] + w,
                                                       cot)), failures)
            res[kind] = (out, grads, t_f, t_b, ops)
        torch.cuda.synchronize()
        (ko, kg, kf, kb, kops), (po, pg, pf, pb, pops) = (res["kernel"],
                                                          res["plain"])
        err, rel = _check_grads([f"tail out L={Lg}"], [ko], [po], failures)
        wb = _nbytes(*t0) // 2
        fl, nb = tail_block_cost(nobj, Lg, KV, HID, False, [y, a, ko])
        r = _kernel_row("fused_tail_block", src, f"{rep}:482", err, kf, pf,
                        (fl, nb + wb))
        _print_row(f"fused_tail_block y{tuple(y.shape)} hid={HID} "
                   f"{_ops_text(kops[0], pops[0])}; events:", err, rel, r)
        if side == F_:
            rows.append(r)
        err, rel = _check_grads(
            [f"tail d{n} L={Lg}" for n in ("y", "a", "wv", "bv", "wo", "bo",
                                           "ln3w", "ln3b", "w1", "b1", "w2",
                                           "b2")], kg, pg, failures)
        fl, nb = tail_block_cost(nobj, Lg, KV, HID, True, [y, a, cot, *kg])
        r = _kernel_row("fused_tail_block_bwd", src, f"{rep}:502", err, kb,
                        pb, (fl, nb + wb))
        _print_row(f"fused_tail_block backward L={Lg} "
                   f"{_ops_text(kops[1], pops[1])}; events:", err, rel, r)
        if side == F_:
            rows.append(r)

    if failures:
        raise SystemExit(f"{len(failures)} kernel outputs disagree with "
                         "their plain versions:\n" + "\n".join(failures))
    return rows


# kernel #3 at the shapes its paths give it: (label, objects, queries (None:
# one slot's), slot side, slots, pointer tokens, masked). The first three
# are the one-head path's at 384 px (Lk 580, 4068 and 4096, two of seven
# slots masked by -1e9), the fourth 448 px, where a slot of 784 keys
# straddles key tiles and the last tile mixes spatial and pointer keys; the
# next three the split rule's edges (kproj_plan) on a small grid (2
# objects x 100 queries, 12 x 12 slots of 144 keys, so tiles straddle
# slots too): the most keys without a split (Lk 320, 5 tiles), exactly two
# splits of 3 tiles (384), one key past them (385: two of 4 and 3 tiles,
# the last holding one key); the last three the dq pass's warpgroup edges
# (KPROJ_DQ_MAX_ROPE_ROWS) at 2 objects x 100 queries: 34 x 34 slots, the
# largest with two warpgroups per dq block, 35 x 35, one past it, and 64 x
# 64 (1024 px), the largest grid the kernel takes.
KPROJ_CASES = (
    ("training, frame 1", 8, None, 24, 1, 4, False),
    ("training, frame 9", 8, None, 24, 7, 36, False),
    ("serving", 8, None, 24, 7, 64, True),
    ("448 px, frame 9", 3, None, 28, 7, 36, False),
    ("split edge: no split", 2, 100, 12, 2, 32, False),
    ("split edge: two splits exactly", 2, 100, 12, 2, 96, True),
    ("split edge: one key past two splits", 2, 100, 12, 2, 97, False),
    ("dq edge: two warpgroups, 34 x 34 slots", 2, 100, 34, 2, 4, False),
    ("dq edge: one warpgroup, 35 x 35 slots", 2, 100, 35, 2, 4, True),
    ("dq edge: one warpgroup, 64 x 64 slots", 2, 100, 64, 1, 4, False),
)
KPROJ = ("flash_attention_kproj", "flash_attention_kproj_bwd")


def _kproj_keys(kin, kw, kbias, nsp, side, theta, fa):
    """The keys kernel #3 projects, k = RoPE(kin Wk^T + bk), in bf16: the
    library yardstick's input (sdpa over pre-projected keys)."""
    with torch.no_grad():
        cos, sin = fa.kproj_rope_tables(256, (side, side), theta,
                                        torch.bfloat16, kin.device)
        Lk = kin.shape[-2]
        reps = nsp // cos.shape[0]
        c = torch.cat([cos.repeat(reps, 1), cos.new_ones((Lk - nsp, 128))])
        s = torch.cat([sin.repeat(reps, 1), sin.new_zeros((Lk - nsp, 128))])
        kpre = kin.float() @ kw.float().t() + kbias.float()
        k1, k2 = kpre[..., :128], kpre[..., 128:]
        return torch.cat([k1 * c - k2 * s, k2 * c + k1 * s], -1).to(
            torch.bfloat16)


def phase_kproj_kernels(params, cfg, seed: int):
    """Kernel #3 forward and backward against its plain version (backward:
    autograd through the plain forward with the same random cotangent) at
    KPROJ_CASES, each tensor within KERNEL_TOL of its own max|plain|, with
    the plan (key splits of the forward and of the dq pass, warpgroups
    per dq block), CUDA-event ms, the device operations, launches and
    device ms of one forward and one backward call, beside
    F.scaled_dot_product_attention forward and backward on the keys
    projected beforehand (4-D, a boolean mask; events and device ms); a
    second backward must give the same bits. Returns the JSON rows: the
    training shape at frame 9 (Lk 4068), the worst error of all cases."""
    from sam2_video_tpu_torch.models import memory_attention as ma
    from sam2_video_tpu_torch.ops import flash_attention as fa

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(seed + 13)
    mcfg = cfg.memory_attention_config
    cp = ma.prepare(params["memory_attention"], mcfg)["layers"]["0"][
        "cross_attn_image"]
    kw, kbias = cp["_kp"]["weight"], cp["_kp"]["bias"]
    src = "sam2_video_tpu_torch/csrc/flash_kproj.cu"
    rep = "sam2_video_tpu/ops/flash_attention.py"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    failures, rows, worst = [], {}, {"fwd": 0.0, "bwd": 0.0}

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    for i, (label, O, L, side, slots, ptr, masked) in enumerate(KPROJ_CASES):
        HW = side * side
        L = L or HW
        nsp = slots * HW
        Lk = nsp + ptr
        q, kin, v, cot = rnd(O, L, 256), rnd(O, Lk, 64), rnd(O, Lk, 64), \
            rnd(O, L, 64)
        valid = bias = None
        if masked:
            valid = torch.ones(Lk, dtype=torch.bool, device=dev)
            valid[2 * HW: 4 * HW] = False
            bias = torch.where(valid, 0.0, -1e9).float()
        res = {}
        for kind, fn in (("kernel", fa.flash_attention_kproj),
                         ("plain", fa.flash_attention_kproj_plain)):
            leaves = _leaves((q, kin, v, kw, kbias))
            args = lambda: (*leaves, bias, nsp, (side, side),  # noqa: E731
                            mcfg.rope_theta)
            out = fn(*args())
            grads = torch.autograd.grad(out, leaves, cot, retain_graph=True)
            t_f = cuda_ms(lambda: fn(*args()))
            t_b = _time_backward(out, leaves, cot)
            if kind == "kernel":
                ops = (_device_launches(lambda: fn(*args())),
                       _device_launches(lambda: torch.autograd.grad(
                           out, leaves, cot, retain_graph=True)))
                again = torch.autograd.grad(out, leaves, cot,
                                            retain_graph=True)
                for n, a, b in zip(("dq", "dkin", "dv", "dwk", "dbk"),
                                   grads, again, strict=True):
                    if not torch.equal(a, b):
                        failures.append(f"kproj {n} Lk={Lk}: two backward "
                                        "runs differ")
                        print("FAIL " + failures[-1], flush=True)
            res[kind] = (out, grads, t_f, t_b)
        k = _kproj_keys(kin, kw, kbias, nsp, side, mcfg.rope_theta, fa)
        lib_f, lib_b, dev_f, dev_b = _library_attention_ms(
            q[:, None], k[:, None], v[:, None], valid, cot[:, None])
        torch.cuda.synchronize()
        plan = fa.kproj_plan(O, L, Lk, (side, side), sms)
        (ko, kg, kf, kb), (po, pg, pf, pb) = res["kernel"], res["plain"]
        tag = f"O={O} Lq={L} Lk={Lk} slot {side}x{side}"
        err_f, rel_f = _check_grads([f"kproj out {tag}"], [ko], [po],
                                    failures, ATTENTION_FLOOR)
        wb = 2 * kw.numel()
        fl, nb = kproj_cost(O, L, Lk, False, [q, kin, v, bias, ko])
        r_f = _kernel_row(KPROJ[0], src, f"{rep}:391", err_f, kf, pf,
                          (fl, nb + wb), lib_f)
        _print_row(f"flash_attention_kproj {label}: {tag} "
                   f"splits={plan.fwd[0]} "
                   f"device_ops/launches={ops[0][0]}/{ops[0][1]} device_ms="
                   f"{ops[0][2]:.4f} (sdpa {dev_f:.4f}); events:", err_f,
                   rel_f, r_f)
        err_b, rel_b = _check_grads(
            [f"kproj d{n} {tag}" for n in ("q", "kin", "v", "wk", "bk")], kg,
            pg, failures, ATTENTION_FLOOR)
        fl, nb = kproj_cost(O, L, Lk, True, [q, kin, v, bias, ko, cot, *kg])
        r_b = _kernel_row(KPROJ[1], src, f"{rep}:440", err_b, kb, pb,
                          (fl, nb + wb), lib_b)
        _print_row(f"flash_attention_kproj backward {label}: {tag} dq "
                   f"warpgroups={plan.dq_warpgroups} splits={plan.dq[0]} "
                   f"dWk blocks={plan.dw[0]} "
                   f"device_ops/launches={ops[1][0]}/{ops[1][1]} device_ms="
                   f"{ops[1][2]:.4f} (sdpa {dev_b:.4f}); events:", err_b,
                   rel_b, r_b)
        worst["fwd"] = max(worst["fwd"], err_f)
        worst["bwd"] = max(worst["bwd"], err_b)
        if i == 1:
            rows = {"fwd": r_f, "bwd": r_b}
        del res, ko, kg, po, pg
    if failures:
        raise SystemExit(f"{len(failures)} kernel #3 tensors disagree with "
                         "the plain version:\n" + "\n".join(failures))
    for key in ("fwd", "bwd"):
        rows[key]["max_abs_err"] = worst[key]
    return [rows["fwd"], rows["bwd"]]


# kernel #7 at the shapes its paths give it: (label, objects, heads, head
# width, value width, queries, key count, masked keys). The first four are
# the paths' shapes (the serving case with two invalid slots); the last
# four the split rule's edges on a small grid with Lq not a multiple of 64
# (a quarter of the keys masked where marked): below one split, exactly
# two splits of 8 key tiles, one key past them (two of 9 and 8 tiles, the
# last holding one key), and D 256 (two dq column blocks) one key past.
L384 = (384 // 16) ** 2
FLASH_CASES = (
    ("2 heads, training, frame 1", 8, 2, 128, 128, L384, L384 + 4, False),
    ("2 heads, training, frame 9", 8, 2, 128, 128, L384, 7 * L384 + 36,
     False),
    ("2 heads, serving", 8, 2, 128, 128, L384, 7 * L384 + 64, True),
    ("1 head over 128-channel memory, frame 9", 8, 1, 256, 128, L384,
     7 * L384 + 18, False),
    ("split edge: below one split", 2, 2, 128, 128, 100, 8 * 64 - 1, False),
    ("split edge: two splits exactly", 2, 2, 128, 128, 100, 16 * 64, True),
    ("split edge: one key past two splits", 2, 2, 128, 128, 100,
     16 * 64 + 1, False),
    ("split edge: one key past two splits, D 256", 2, 2, 256, 64, 100,
     16 * 64 + 1, True),
)
FLASH = ("flash_attention", "flash_attention_bwd")


def _library_attention_ms(q, k, v, valid, cot):
    """ms of F.scaled_dot_product_attention (bf16, the keys that ``valid``
    marks), forward and backward, on the kernel's inputs: the yardstick of
    the JSON line, used nowhere in the port. Returns (forward, backward)
    by CUDA events and (forward, backward) device ms from the profiler."""
    import torch.nn.functional as F

    mask = None if valid is None else valid[None, None, None, :]
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
        *leaves, attn_mask=mask)
    bwd = lambda: torch.autograd.grad(  # noqa: E731
        out, leaves, cot, retain_graph=True)
    return (cuda_ms(fwd), _time_backward(out, leaves, cot),
            _device_launches(fwd)[2], _device_launches(bwd)[2])


def phase_flash_kernels(seed: int):
    """Kernel #7 forward and backward against its plain version (backward:
    autograd through the plain forward with the same random cotangent) at
    FLASH_CASES, with F.scaled_dot_product_attention timed on the same
    tensors, the split counts (forward, dq pass) and the device operations
    and kernel launches of one forward and one backward call. Returns the
    JSON rows: the two-head training shape at frame 9 (Lk 4068), the worst
    error of all cases."""
    from sam2_video_tpu_torch.ops import flash_attention as fa

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(seed + 17)
    src = "sam2_video_tpu_torch/csrc/flash_attention.cu"
    rep = "sam2_video_tpu/ops/flash_attention.py"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    failures, rows, worst = [], {}, {"fwd": 0.0, "bwd": 0.0}

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    for i, (label, O, H, D, Dv, L, Lk, masked) in enumerate(FLASH_CASES):
        q, k, v = rnd(O, H, L, D), rnd(O, H, Lk, D), rnd(O, H, Lk, Dv)
        valid = bias = None
        if masked:
            valid = torch.ones(Lk, dtype=torch.bool, device=dev)
            # the paths' two invalid slots, else a quarter of the keys
            cut = (slice(2 * L384, 4 * L384) if i < 4 else
                   slice(Lk // 4, Lk // 2))
            valid[cut] = False
            bias = torch.where(valid, 0.0, -1e9).float()
        cot = rnd(O, H, L, Dv)
        res = {}
        for kind, fn in (("kernel", fa.flash_attention),
                         ("plain", fa.flash_attention_plain)):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
            out = fn(*leaves, bias)
            grads = torch.autograd.grad(out, leaves, cot, retain_graph=True)
            t_f = cuda_ms(lambda: fn(*leaves, bias))
            t_b = _time_backward(out, leaves, cot)
            if kind == "kernel":
                ops = (_device_launches(lambda: fn(*leaves, bias)),
                       _device_launches(lambda: torch.autograd.grad(
                           out, leaves, cot, retain_graph=True)))
            res[kind] = (out, grads, t_f, t_b)
        lib_f, lib_b, dev_f, dev_b = _library_attention_ms(q, k, v, valid,
                                                           cot)
        torch.cuda.synchronize()
        (s_f, _), (s_q, _) = fa.flash_splits(O * H, L, Lk, D, Dv, sms)
        (ko, kg, kf, kb), (po, pg, pf, pb) = res["kernel"], res["plain"]
        tag = f"O={O} H={H} Lq={L} Lk={Lk} D={D} Dv={Dv}"
        err_f, rel_f = _check_grads([f"flash out {tag}"], [ko], [po],
                                    failures, ATTENTION_FLOOR)
        r_f = _kernel_row(FLASH[0], src, f"{rep}:93", err_f, kf, pf,
                          flash_cost(O * H, L, Lk, D, Dv, False,
                                     [q, k, v, bias, ko]), lib_f)
        _print_row(f"flash_attention {label}: {tag} splits={s_f} "
                   f"device_ops/launches={ops[0][0]}/{ops[0][1]} device_ms="
                   f"{ops[0][2]:.4f} (sdpa {dev_f:.4f})", err_f, rel_f, r_f)
        err_b, rel_b = _check_grads(
            [f"flash d{n} {tag}" for n in ("q", "k", "v")], kg, pg, failures,
            ATTENTION_FLOOR)
        r_b = _kernel_row(FLASH[1], src, f"{rep}:183", err_b, kb, pb,
                          flash_cost(O * H, L, Lk, D, Dv, True,
                                     [q, k, v, bias, ko, cot, *kg]), lib_b)
        _print_row(f"flash_attention backward {label}: {tag} dq "
                   f"splits={s_q} device_ops/launches={ops[1][0]}/"
                   f"{ops[1][1]} device_ms={ops[1][2]:.4f} (sdpa "
                   f"{dev_b:.4f})", err_b, rel_b, r_b)
        worst["fwd"] = max(worst["fwd"], err_f)
        worst["bwd"] = max(worst["bwd"], err_b)
        if i == 1:
            rows = {"fwd": r_f, "bwd": r_b}
        del res, ko, kg, po, pg
    if failures:
        raise SystemExit(f"{len(failures)} kernel #7 tensors disagree with "
                         "the plain version:\n" + "\n".join(failures))
    for key in ("fwd", "bwd"):
        rows[key]["max_abs_err"] = worst[key]
    return [rows["fwd"], rows["bwd"]]


def hiera_block_bwd_cost(spec, B: int, H: int, W: int, mlp_ratio: float,
                         n_params: int, tensors):
    """(flops, bytes) of kernel #6 for one block, recompute included. B1,
    over the Mo output tokens: the W1 product again, then dh, dW1, dW2 and
    dy_ln (5 x 2 Mo C hid). B2: qkv (2 Mi Cin 3C) and, on dim-change
    blocks, the shortcut (2 Mi Cin C) again; dO = dx1 Wproj and dWproj
    (2 Mo C C each); the attention's output again (S = QK^T, PV) and its
    backward (dP, dv, dq, dk): 6 products of 2 keys C per kept query,
    against every key of its window, pad keys included (the kernel's
    second pass computes S and dP again, a cost of its design, not of the
    function); dWqkv and dxn (2 Mi 3C Cin each); dWsc and its share of dxn
    (2 Mi C Cin each). Bytes: x, x1, dy and dx once, the bf16 weights read
    and their float32 gradients written once."""
    ci, co = spec["dim"], spec["dim_out"]
    hid = int(co * mlp_ratio)
    ws = spec["window_size"]
    keys = H * W if ws == 0 else ws * ws
    Ho, Wo = (H // 2, W // 2) if spec["q_pool"] else (H, W)
    Mi, Mo = B * H * W, B * Ho * Wo
    flops = (5 * 2 * Mo * co * hid + 2 * Mi * ci * 3 * co
             + 2 * 2 * Mo * co * co + 6 * 2 * Mo * keys * co
             + 2 * 2 * Mi * 3 * co * ci)
    if ci != co:
        flops += 3 * 2 * Mi * ci * co
    return flops, _nbytes(*tensors) + 6 * n_params


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _pool_rule_flips(v) -> int:
    """2x2 cells of v [B, H, W, C] (the plain version's pre-pool values)
    where torch's max_pool2d backward (first maximum in row-major order)
    and the JAX rule the kernel follows (column pair first, then the row;
    the first on a tie) route the gradient to different elements: cells
    that hold a tie."""
    B, H, W, C = v.shape
    c = v[:, :H // 2 * 2, :W // 2 * 2].float().reshape(
        B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 5, 2, 4).reshape(-1, 4)
    torch_pick = c.argmax(-1)
    col = (torch.maximum(c[:, 0], c[:, 2]) < torch.maximum(c[:, 1], c[:, 3]))
    top = torch.where(col, c[:, 1], c[:, 0])
    bot = torch.where(col, c[:, 3], c[:, 2])
    jax_pick = 2 * (top < bot).long() + col.long()
    return int((torch_pick != jax_pick).sum())


# kernel #6 on q-pool blocks: the gradients that a 2x2 max-pool routes (dx,
# the LN1 weight's, dWqkv's q rows, dWsc) are held to the plain version by
# relative L2. Where a 2x2 cell of the pre-pool values (the shortcut's s,
# attention's q) holds a tie, torch's max_pool2d autograd and the kernel's
# JAX rule route its gradient to different elements, and near-ties flip
# where the kernel and the plain version round their pre-pool values
# differently; each flip moves one whole contribution between two tokens,
# which a max-abs check reads as an error of the contribution's size. The
# routing sums (dbsc, dbqkv, the LN1 bias's) keep the max-abs check.
POOL_REL_L2 = 5e-2
POOL_ROUTED = ("dx", "dnorm1.weight", "dattn.qkv.weight", "dproj.weight")
# The same tensors against the plain version with the kernel's walk (the
# JAX pool rule, one rounding per product, so the pre-pool values agree up
# to float32 summation order, and so do the tie cells): 0.005-0.007 on the
# H100, every other tensor's level; the plain version's two roundings
# (product, then bias) tie other cells, hence its 0.04. A kernel that
# routes a tie to the last maximum instead read 0.026-0.061 there.
POOL_WALK_REL_L2 = 1e-2


# kernel #6, blocks without a dim change: dx = dy + the two branches'
# LayerNorm backwards, and the identity part, the random cotangent, is
# several times larger than the branches, so the max-abs check of dx reads
# their error against the cotangent's size. The branches' part, dx - dy,
# is held to the plain version's by relative L2 too (0.006-0.011 on the
# H100). A LayerNorm's input gradient sums to zero over the channels, so
# the row means of dx - dy are rounding noise; theirs (RMS over the rows)
# may be at most ROW_MEAN_RATIO times the plain version's. An LN1
# backward without its mean term read 0.016-0.037 by relative L2 and
# passed at the global blocks.
BRANCH_REL_L2 = 2e-2
ROW_MEAN_RATIO = 2.0


def _trunk_blocks(cfg):
    """(block index, spec, input grid side, geometry class) of every block
    of the trunk at cfg.image_size."""
    from sam2_video_tpu_torch.ops import hiera_block_bwd as hbb

    H, out = cfg.image_size // 4, []
    for i, spec in enumerate(cfg.trunk_config.block_specs()):
        out.append((i, spec, H, hbb.geometry(spec, H, H)))
        if spec["q_pool"]:
            H //= 2
    return out


def _trunk_classes(cfg) -> list:
    return list(dict.fromkeys(g for *_, g in _trunk_blocks(cfg)))


def phase_hiera_bwd_kernels(params, cfg, seed: int, frames: int,
                            classes_only: bool = False):
    """Kernel #6 (B1 + B2, through ``fused_block_trainable``'s autograd
    Function) against autograd through the plain bf16 block, for each of
    the 12 blocks of the tiny trunk (every geometry class; with
    ``classes_only`` the first block of each class of cfg's trunk) at the
    training shape: ``frames`` frames of 384 px per call, ``synthetic_params``
    weights, one random cotangent; a second kernel run (forward and
    backward) must give the same bits. Prints each block's and each
    class's device ms and device operations (kernel and plain, one
    backward, _device_launches). Returns one JSON row per geometry class:
    ms, plain ms and bound of one call, averaged over the class's blocks,
    and its worst error."""
    from sam2_video_tpu_torch.ops import common as nn
    from sam2_video_tpu_torch.ops import hiera_block_bwd as hbb

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(seed + 11)
    tcfg = cfg.trunk_config
    trunk = params["image_encoder"]["trunk"]
    failures = []
    k_ms = p_ms = b_ms = 0.0
    k_dev, p_dev = [0, 0, 0.0], [0, 0, 0.0]
    classes: dict = {}
    seen, summed = set(), 0
    for i, spec, H, geom in _trunk_blocks(cfg):
        if classes_only and geom in seen:
            continue
        seen.add(geom)
        summed += 1
        bp = trunk["blocks"][str(i)]
        names = [".".join(pt) for pt in hbb.paths(spec)]
        w0 = hbb.leaves(bp, spec)
        x = torch.randn((frames, H, H, spec["dim"]), generator=gen).to(
            dev, torch.bfloat16)
        res = {}
        runs = [("kernel", hbb.fused_block_trainable),
                ("plain", hbb.fused_block_trainable_plain)]
        if spec["q_pool"]:
            runs.append(("kernel_walk", hbb.fused_block_trainable_walk))
        for kind, fn in runs:
            w = _leaves(w0)
            xl = x.detach().clone().requires_grad_(True)
            out = fn(hbb.block_params(w, spec), xl, spec, tcfg.q_stride,
                     tcfg.mlp_ratio)
            if kind == "kernel":
                cot = torch.randn(out.shape, generator=gen).to(
                    dev, torch.bfloat16)
            grads = torch.autograd.grad(out, [xl] + w, cot, retain_graph=True)
            t_b = ops = None
            if kind != "kernel_walk":
                t_b = _time_backward(out, [xl] + w, cot)
                ops = _device_launches(lambda: torch.autograd.grad(
                    out, [xl] + w, cot, retain_graph=True))
            if kind == "kernel":
                o2 = fn(hbb.block_params(w, spec), xl, spec, tcfg.q_stride,
                        tcfg.mlp_ratio)
                _twice_same(f"block {i}", [out], grads,
                            ([o2], torch.autograd.grad(o2, [xl] + w, cot)),
                            failures)
                del o2
            res[kind] = (out, grads, t_b, ops)
            del out
        torch.cuda.synchronize()
        (ko, kg, kb, kops), (po, pg, pb, pops) = res["kernel"], res["plain"]
        labels = ["dx"] + ["d" + n for n in names]
        rel_checked = set(POOL_ROUTED) if spec["q_pool"] else set()
        each, errs = [], []
        for name, a, b in zip(labels, kg, pg, strict=True):
            a32, b32 = a.float(), b.float()
            err = (a32 - b32).abs().max().item()
            scale = max(1.0, b32.abs().max().item())
            rel = _rel_l2(a32, b32)
            finite = bool(torch.isfinite(a32).all())
            if name in rel_checked:
                ok = finite and rel <= POOL_REL_L2
                kw = res["kernel_walk"][1][labels.index(name)].float()
                rel_kw = _rel_l2(a32, kw)
                ok = ok and rel_kw <= POOL_WALK_REL_L2
                each.append(f"{name}: rel_l2 {rel:.3g} (err/scale "
                            f"{err / scale:.3g}; to the kernel walk: rel_l2 "
                            f"{rel_kw:.3g}, err/scale "
                            f"{(a32 - kw).abs().max().item() / scale:.3g})")
            else:
                ok = finite and err <= KERNEL_TOL * scale
                errs.append(err)
                each.append(f"{name}: {err / scale:.3g} (rel_l2 {rel:.3g})")
            if name == "dx" and a.shape == cot.shape:
                ka, pa = a32 - cot.float(), b32 - cot.float()
                rel_br = _rel_l2(ka, pa)
                top = max(pa.abs().max().item(), 1e-30)
                k_mean = float(ka.mean(-1).square().mean().sqrt())
                p_mean = float(pa.mean(-1).square().mean().sqrt())
                ok = (ok and rel_br <= BRANCH_REL_L2
                      and k_mean <= ROW_MEAN_RATIO * p_mean)
                each[-1] += (f" [branches dx - dy: rel_l2 {rel_br:.3g} <= "
                             f"{BRANCH_REL_L2}, err/max "
                             f"{(ka - pa).abs().max().item() / top:.3g}; "
                             f"row means rms {k_mean:.3g} <= "
                             f"{ROW_MEAN_RATIO} x plain {p_mean:.3g}]")
            if not ok:
                failures.append(f"block {i} {name}: max_abs_err {err:.4g} "
                                f"(limit {KERNEL_TOL * scale:.4g}), rel_l2 "
                                f"{rel:.4g} (see {each[-1]})")
                print("FAIL " + failures[-1], flush=True)
        flips = ""
        if spec["q_pool"]:
            with torch.no_grad():
                xn = nn.layer_norm(bp["norm1"], x, eps=1e-6)
                s_pre = nn.linear(bp["proj"], xn)
                co = spec["dim_out"]
                q_pre = nn.linear({"weight": bp["attn"]["qkv"]["weight"][:co],
                                   "bias": bp["attn"]["qkv"]["bias"][:co]},
                                  xn)
            flips = (f" tie cells routed apart: shortcut "
                     f"{_pool_rule_flips(s_pre)}, q {_pool_rule_flips(q_pre)}"
                     f" of {s_pre.numel() // 4}; "
                     f"{', '.join(POOL_ROUTED)} by rel_l2 <= {POOL_REL_L2}, "
                     f"to the kernel walk <= {POOL_WALK_REL_L2}")
        fl, nb = hiera_block_bwd_cost(spec, frames, H, H, tcfg.mlp_ratio,
                                      sum(t.numel() for t in w0),
                                      [x, ko, cot, kg[0]])
        b, by = bound_ms(fl, nb)
        k_ms, p_ms, b_ms = k_ms + kb, p_ms + pb, b_ms + b
        k_dev = [u + v for u, v in zip(k_dev, kops)]
        p_dev = [u + v for u, v in zip(p_dev, pops)]
        c = classes.setdefault(geom, dict(ms=[], plain=[], bound=[], err=0.0,
                                          by=by, blocks=[], ops=[], pops=[]))
        c["ms"].append(kb)
        c["plain"].append(pb)
        c["ops"].append(kops)
        c["pops"].append(pops)
        c["bound"].append(b)
        c["err"] = max([c["err"]] + errs)
        c["blocks"].append(i)
        print(f"fused_block_trainable_bwd[{i:2d}] {geom:32s} "
              f"x{tuple(x.shape)} kernel_ms={kb:.4f} plain_ms={pb:.4f} "
              f"bound_ms={b:.4f}({by}) {_ops_text(kops, pops)}{flips}",
              flush=True)
        print("  err/scale " + ", ".join(each), flush=True)
        del res, ko, kg, po, pg
    what = "trunk total" if not classes_only else "first block of each class"
    print(f"fused_block_trainable_bwd {what} ({summed} blocks, "
          f"{frames} frames): kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
          f"bound_ms={b_ms:.4f} {_ops_text(k_dev, p_dev)}", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} kernel #6 gradients disagree "
                         "with the plain version:\n" + "\n".join(failures))
    rows = []
    for geom, c in classes.items():
        rows.append(dict(
            name=f"fused_block_trainable_bwd[{geom}]", route="cuda",
            source="sam2_video_tpu_torch/csrc/hiera_block_bwd.cu",
            replaces="sam2_video_tpu/ops/hiera_block_bwd.py:353",
            max_abs_err=c["err"], ms=float(np.mean(c["ms"])),
            plain_ms=float(np.mean(c["plain"])),
            bound_ms=float(np.mean(c["bound"])), bound_by=c["by"],
            library_ms=None))
        ko_, po_ = (np.mean(c["ops"], axis=0), np.mean(c["pops"], axis=0))
        print(f"{rows[-1]['name']} blocks {c['blocks']}: kernel_ms "
              f"{rows[-1]['ms']:.4f} plain_ms {rows[-1]['plain_ms']:.4f} "
              f"bound_ms {rows[-1]['bound_ms']:.4f} device_ms "
              f"{ko_[2]:.4f} (plain {po_[2]:.4f}) device_ops {ko_[0]:g} "
              f"(plain {po_[0]:g})", flush=True)
    return rows


PRESETS = ("base_plus", "large")
PRESET_FRAMES = 2


def phase_presets(cfg, seed: int):
    """SAM2-base+ and SAM2-large (widths 112-896 / 144-1152, head dims 56 /
    72; ``synthetic_params``) at cfg.image_size, PRESET_FRAMES frames:
      - forward_image on the card, kernel #1 at every block of the trunk
        (its launches counted), against the same on the CPU in float32
        (plain blocks): each FPN level and vision_pos_enc within relative L2
        CPU_REL_L2_TOL;
      - one trainable trunk pass on the card (fused_backbone_vjp, the
        gradient of every trunk leaf from a random cotangent per FPN
        level): kernel #6 at every block, finite gradients;
      - #1 and #6 per block on random inputs of each block's shape: #1
        against its plain block within KERNEL_TOL; CUDA-event ms, device
        ms and operations (kernel and plain) and the bound, summed per
        trunk pass;
      - #6 against its plain version at the first block of each geometry
        class, with #6's limits (phase_hiera_bwd_kernels).
    Returns the JSON rows (#1 and #6 per trunk pass of each preset). Their
    launches stay null: neither preset runs on a training step or in
    serving; the counts of the two card passes above are checked and
    printed only."""
    from sam2_video_tpu_torch.models import sam2 as sam2_mod
    from sam2_video_tpu_torch.ops import hiera_block_bwd as hbb
    from sam2_video_tpu_torch.ops import hiera_block_kernel as hbk

    rows = []
    S = cfg.image_size
    for name in PRESETS:
        pcfg = dataclasses.replace(cfg, backbone=name)
        tcfg = pcfg.trunk_config
        blocks = _trunk_blocks(pcfg)
        params = synthetic_params(pcfg, seed).to(DEVICE)
        rng = np.random.default_rng(seed + 21)
        images = torch.from_numpy(rng.integers(
            0, 256, (PRESET_FRAMES, S, S, 3), dtype=np.uint8))
        n1 = hbk.fused_block.launches
        with torch.no_grad():
            card = sam2_mod.forward_image(sam2_mod.prepare(params, pcfg),
                                          pcfg, images.to(DEVICE))
        torch.cuda.synchronize()
        n1 = hbk.fused_block.launches - n1
        cpu_cfg = dataclasses.replace(pcfg, compute_dtype="float32")
        with torch.no_grad():
            ref = sam2_mod.forward_image(synthetic_params(cpu_cfg, seed),
                                         cpu_cfg, images)
        pairs = [(f"fpn[{k}]", a, b) for k, (a, b) in enumerate(zip(
            card["backbone_fpn"], ref["backbone_fpn"]))]
        pairs += [(f"pos[{k}]", a, b) for k, (a, b) in enumerate(zip(
            card["vision_pos_enc"], ref["vision_pos_enc"]))]
        rel = {k: _rel_l2(a.cpu(), b) for k, a, b in pairs}
        finite = all(bool(torch.isfinite(a.float()).all()) for _, a, _ in pairs)
        ok = finite and n1 == len(blocks) and max(rel.values()) <= CPU_REL_L2_TOL
        print(f"preset {name} forward_image ({PRESET_FRAMES} frames, {S} px) "
              f"card vs cpu float32: rel_l2 " + ", ".join(
                  f"{k} {v:.4g}" for k, v in rel.items())
              + f" (tol {CPU_REL_L2_TOL}); fused_block launches {n1} of "
              f"{len(blocks)} blocks {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"{name}: the card's image features disagree "
                             f"with the CPU's, or a block skipped kernel #1")
        del card, ref

        # a trainable trunk pass: kernel #6 at every block
        vcfg = dataclasses.replace(pcfg, fused_backbone_vjp=True)
        leaves = list(params["image_encoder"]["trunk"].parameters())
        for t in leaves:
            t.requires_grad_(True)
        n6 = hbb.fused_block_trainable.launches
        out = sam2_mod.forward_image(params, vcfg, images.to(DEVICE))
        fpn = out["backbone_fpn"]
        gen = torch.Generator().manual_seed(seed + 22)
        cots = [torch.randn(f.shape, generator=gen).to(DEVICE, f.dtype)
                for f in fpn]
        grads = torch.autograd.grad(fpn, leaves, cots, allow_unused=True)
        torch.cuda.synchronize()
        n6 = hbb.fused_block_trainable.launches - n6
        for t in leaves:
            t.requires_grad_(False)
        finite = all(g is None or bool(torch.isfinite(g).all())
                     for g in grads)
        ok = finite and n6 == 2 * len(blocks)
        print(f"preset {name} trainable trunk pass: kernel #6 launches {n6} "
              f"(B1 + B2 of {len(blocks)} blocks), finite gradients "
              f"{finite} {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"{name}: the trainable trunk pass failed")
        del out, fpn, grads

        # #1 and #6 per block, summed per trunk pass
        trunk = params["image_encoder"]["trunk"]
        f_sum = np.zeros(7)        # ms, plain ms, bound, dev ms, dev ops, plain dev ms, plain ops
        b_sum = np.zeros(7)
        f_by, b_by, f_err = set(), set(), 0.0
        gen = torch.Generator().manual_seed(seed + 23)
        for i, spec, H, geom in blocks:
            bp = trunk["blocks"][str(i)]
            x = torch.randn((PRESET_FRAMES, H, H, spec["dim"]),
                            generator=gen).to(DEVICE, torch.bfloat16)
            q = tcfg.q_stride
            with torch.no_grad():
                got = hbk.fused_block(bp, x, spec, q, tcfg.mlp_ratio)
                want = hbk.fused_block_plain(bp, x, spec, q, tcfg.mlp_ratio)
                err = (got.float() - want.float()).abs().max().item()
                scale = max(1.0, want.float().abs().max().item())
                if not (bool(torch.isfinite(got.float()).all())
                        and err <= KERNEL_TOL * scale):
                    raise SystemExit(f"{name} block {i} ({geom}): kernel #1 "
                                     f"disagrees with plain ({err} > "
                                     f"{KERNEL_TOL * scale})")
                f_err = max(f_err, err)
                t_k = cuda_ms(lambda: hbk.fused_block(bp, x, spec, q,
                                                      tcfg.mlp_ratio))
                t_p = cuda_ms(lambda: hbk.fused_block_plain(bp, x, spec, q))
                l_k = _device_launches(lambda: hbk.fused_block(
                    bp, x, spec, q, tcfg.mlp_ratio))
                l_p = _device_launches(lambda: hbk.fused_block_plain(
                    bp, x, spec, q))
            b, by = bound_ms(*block_cost(spec, PRESET_FRAMES, H, H,
                                         tcfg.mlp_ratio, bp, x, got))
            f_by.add(by)
            f_sum += [t_k, t_p, b, l_k[2], l_k[0], l_p[2], l_p[0]]
            w0 = hbb.leaves(bp, spec)
            res = []
            for fn in (hbb.fused_block_trainable,
                       hbb.fused_block_trainable_plain):
                w = _leaves(w0)
                xl = x.detach().clone().requires_grad_(True)
                o = fn(hbb.block_params(w, spec), xl, spec, q, tcfg.mlp_ratio)
                cot = torch.randn(o.shape, generator=gen).to(DEVICE, o.dtype)
                res.append((_time_backward(o, [xl] + w, cot),
                            _device_launches(lambda: torch.autograd.grad(
                                o, [xl] + w, cot, retain_graph=True))))
                if fn is hbb.fused_block_trainable:
                    dx = torch.autograd.grad(o, xl, cot, retain_graph=True)[0]
                del o
            (tb, lb), (tpb, lpb) = res
            b, by = bound_ms(*hiera_block_bwd_cost(
                spec, PRESET_FRAMES, H, H, tcfg.mlp_ratio,
                sum(t.numel() for t in w0), [x, got, got, dx]))
            b_by.add(by)
            b_sum += [tb, tpb, b, lb[2], lb[0], lpb[2], lpb[0]]
        for kind, sm, bys, cnt in (("fused_block", f_sum, f_by, n1),
                                   ("fused_block_trainable_bwd", b_sum, b_by,
                                    n6)):
            rname = f"{kind}[{name} trunk pass]"
            src = ("hiera_block.cu" if kind == "fused_block"
                   else "hiera_block_bwd.cu")
            rep_ = ("sam2_video_tpu/ops/hiera_block_kernel.py:399"
                    if kind == "fused_block"
                    else "sam2_video_tpu/ops/hiera_block_bwd.py:353")
            rows.append(dict(name=rname, route="cuda",
                             source=f"sam2_video_tpu_torch/csrc/{src}",
                             replaces=rep_,
                             max_abs_err=f_err if kind == "fused_block"
                             else None,
                             ms=float(sm[0]), plain_ms=float(sm[1]),
                             bound_ms=float(sm[2]),
                             bound_by="operations" if "operations" in bys
                             else "bytes", library_ms=None))
            print(f"{rname} ({len(blocks)} blocks, {PRESET_FRAMES} frames, "
                  f"{S} px; launches in the card pass {cnt}, not on the "
                  f"main path): kernel_ms={sm[0]:.4f} plain_ms={sm[1]:.4f} "
                  f"bound_ms={sm[2]:.4f} device_ms={sm[3]:.4f} (plain "
                  f"{sm[5]:.4f}) device_ops={sm[4]:g} (plain {sm[6]:g})",
                  flush=True)
        cls = phase_hiera_bwd_kernels(params, pcfg, seed, PRESET_FRAMES,
                                      classes_only=True)
        rows[-1]["max_abs_err"] = max(r["max_abs_err"] for r in cls)
        del params, trunk
        torch.cuda.empty_cache()
    return rows


def twoway_cost(O, N, HW, backward: bool, tensors, n_weights: int):
    """(flops, bytes) of one fused_twoway_block call (C 256, self internal
    256, cross internal 128, MLP 2048). Forward products per object: self
    q, k, v and out-proj (2 N C 1024), t2i q and out-proj and i2t k and v
    (4 x 2 N C 128), the MLP (2 x 2 N C 2048), t2i k and v and i2t q and
    out-proj over the image rows (4 x 2 HW C 128); attention S and PV over
    all heads (2 x 2 Lq Lk internal: N x N x 256, N x HW x 128 twice).
    Backward, from the kept activations: two products per projection
    (input and weight gradient); per attention dP, dV, dQ, dK and S again,
    which the backward's row pass recomputes (5 x 2 Lq Lk internal). Bytes:
    the inputs (and cotangents) read once, the outputs (and gradients, the
    weights' in f32) written once, the bf16 weights read once."""
    C = 256
    proj = (2 * N * C * 1024 + 4 * 2 * N * C * 128 + 2 * 2 * N * C * 2048
            + 4 * 2 * HW * C * 128)
    att = 2 * N * N * 256 + 2 * 2 * N * HW * 128
    flops = proj + 2 * att if not backward else 2 * proj + 5 * att
    wbytes = 2 * n_weights + (4 * n_weights if backward else 0)
    return O * flops, _nbytes(*tensors) + wbytes


def _device_launches(fn) -> tuple[int, int, float]:
    """(device operations, kernel launch calls, device ms) of one call of
    ``fn``, from torch.profiler: the device-side events (kernels, copies,
    sets), the host's cudaLaunchKernel calls, and the sum of the device
    events' durations (no host time in it). A trace now and then misses a
    device event, so of three traces the one with the most counts."""
    from torch.profiler import ProfilerActivity, profile

    best = (-1, 0, 0.0)
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        avgs = prof.key_averages()
        on_dev = [e for e in avgs
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        host = sum(e.count for e in avgs if e.key.startswith(
            ("cudaLaunchKernel", "cuLaunchKernel")))
        dev_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
        best = max(best, (sum(e.count for e in on_dev), host, dev_ms))
    return best


# (O, N, HW): 384 px, 448 px, one object (7 token rows), 144 token rows
# (more than one 64-row tile), 1024 px
TWOWAY_SHAPES = ((8, 8, 576), (3, 9, 784), (1, 7, 576), (16, 9, 576),
                 (2, 8, 4096))
TWOWAY = ("fused_twoway_block", "fused_twoway_block_bwd")
# Kernel #8: each attention's key-bias gradient is zero in exact
# arithmetic (adding q . bk to every logit of a query leaves its softmax
# as it is), so both bf16 versions return rounding noise: the kernel sums
# its bf16 dK rows, as the TPU kernel does (dbk += sum(dkh)), and the plain
# version sums its own bf16 dK rows. On the H100 the two sat 0.04-0.22
# apart against a 2e-2 limit, noise against noise. These three are held to
# the float32 plain block on the same values instead: the kernel's L2
# distance from it at most ZERO_GRAD_RATIO times the plain bf16 version's
# (the kernel rounds ds before the sum too: 1.22-1.61x on the H100).
TWOWAY_ZERO_GRADS = ("self_attn.k_proj.bias",
                     "cross_attn_token_to_image.k_proj.bias",
                     "cross_attn_image_to_token.k_proj.bias")
ZERO_GRAD_RATIO = 3.0


def phase_twoway_kernels(params, cfg, seed: int):
    """Kernel #8 forward and backward against the plain bf16 block
    (backward: autograd through the plain forward with the same random
    cotangent), the decoder's first block (first=True) and second, at the
    slice's shape (8 objects, 8 tokens, 576 image keys) and a ragged one
    (3 objects, 9 tokens, 784 keys: 448 px): both outputs and the
    gradients of queries, keys, qpe, kpe and every weight within
    KERNEL_TOL of max(1, max|plain|), the key-bias gradients against
    float32 (TWOWAY_ZERO_GRADS). The MLP's hidden activation (ReLU'd)
    within KERNEL_TOL of the plain block's, so a ReLU mask bit may differ
    only where the pre-activation is that near 0; a differing bit moves a
    whole hidden gradient, so the gradients are held to the plain
    backward (bf16 and float32) taken through the kernel's ReLU mask
    (twk.PlainReluMask). Each side runs as the main path runs it: the
    kernel with its packed operands, the plain block with bf16 weight
    copies. Device launches of one call, kernel against plain.
    Returns the JSON rows (the slice's shape, second block; the worst error
    of all four cases)."""
    from sam2_video_tpu_torch.ops import common as nn
    from sam2_video_tpu_torch.ops import twoway_kernel as twk

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(seed + 13)
    layers = params["sam_mask_decoder"]["transformer"]["layers"]
    src = "sam2_video_tpu_torch/csrc/twoway_block.cu"
    rep = "sam2_video_tpu/ops/twoway_kernel.py"
    names = [".".join(p) for p in twk.LEAVES] + ["queries", "keys", "qpe",
                                                  "kpe"]
    failures, rows = [], {}
    worst = {"fwd": 0.0, "bwd": 0.0}

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    def tree(kind, w):
        t = twk.block_params(w)
        if kind == "kernel":
            with torch.no_grad():
                t["_ops"] = twk.pack(t)
        else:
            nn.add_compute_casts(t, torch.bfloat16)
        return t

    for O, N, HW in TWOWAY_SHAPES:
        for first in (True, False):
            w0 = twk.leaves(layers["0" if first else "1"])
            x = [rnd(O, N, 256), rnd(O, HW, 256), rnd(O, N, 256),
                 rnd(HW, 256)]
            cots = [rnd(O, N, 256), rnd(O, HW, 256)]
            res = {}
            for kind, fn in (("kernel", twk.fused_twoway_block),
                             ("plain", twk.twoway_block_plain)):
                w, xl = _leaves(w0), _leaves(x)
                t = tree(kind, w)
                run = lambda: fn(t, *xl, first)  # noqa: E731
                if kind == "kernel":
                    outs = run()
                    hidden = twk.relu_hidden(outs[0]).clone()
                    grads = torch.autograd.grad(outs, w + xl, cots,
                                                retain_graph=True)
                else:
                    with twk.PlainReluMask(None) as rec:
                        outs = run()
                    with twk.PlainReluMask(hidden > 0):
                        grads = torch.autograd.grad(run(), w + xl, cots)
                t_f = cuda_ms(run)
                t_b = _time_backward(outs, w + xl, cots)
                with torch.no_grad():
                    l_f = _device_launches(run)
                l_b = _device_launches(lambda: torch.autograd.grad(
                    outs, w + xl, cots, retain_graph=True))
                res[kind] = (outs, grads, t_f, t_b, l_f, l_b)
            w, xl = _leaves(w0), _leaves([t.float() for t in x])
            with twk.PlainReluMask(hidden > 0):
                f32 = torch.autograd.grad(
                    twk.twoway_block_plain(twk.block_params(w), *xl, first),
                    w + xl, [c.float() for c in cots])
            torch.cuda.synchronize()
            (ko, kg, kf, kb, klf, klb) = res["kernel"]
            (po, pg, pf, pb, plf, plb) = res["plain"]
            label = f"O={O} N={N} HW={HW} first={first}"
            err_f, rel_f = _check_grads(["twoway queries'", "twoway keys'"],
                                        ko, po, failures)
            _check_grads(["twoway MLP hidden"], [hidden],
                         [torch.relu(rec.pre)], failures)
            flips = int(((hidden > 0) != (rec.pre > 0)).sum())
            print(f"  ReLU mask bits that differ from the plain block's: "
                  f"{flips} of {hidden.numel()} (the gradients are held to "
                  f"the plain backward through the kernel's mask)",
                  flush=True)
            zero = [names.index(n) for n in TWOWAY_ZERO_GRADS]
            rest = [i for i in range(len(names)) if i not in zero]
            err_b, rel_b = _check_grads(
                [f"twoway d{names[i]}" for i in rest], [kg[i] for i in rest],
                [pg[i] for i in rest], failures)
            each = []
            for i in zero:
                d_k = float((kg[i].float() - f32[i]).norm())
                d_p = float((pg[i].float() - f32[i]).norm())
                each.append(f"{names[i]}: kernel {d_k:.4g}, plain {d_p:.4g}"
                            f" (|float32| {float(f32[i].norm()):.3g})")
                if not d_k <= ZERO_GRAD_RATIO * d_p:
                    failures.append(f"twoway d{names[i]}: L2 distance from "
                                    f"float32 {d_k:.4g} > {ZERO_GRAD_RATIO}"
                                    f" x the plain bf16 version's {d_p:.4g}")
                    print("FAIL " + failures[-1], flush=True)
            print("  zero-valued key-bias gradients, L2 distance from the "
                  "float32 plain block: " + "; ".join(each), flush=True)
            print("  relative L2 from the float32 plain block, kernel / "
                  "plain bf16: " + ", ".join(
                      f"{names[i]} {_rel_l2(kg[i], f32[i]):.3g} / "
                      f"{_rel_l2(pg[i], f32[i]):.3g}" for i in rest),
                  flush=True)
            worst["fwd"] = max(worst["fwd"], err_f)
            worst["bwd"] = max(worst["bwd"], err_b)
            nw = sum(t.numel() for t in w0)
            r_f = _kernel_row("fused_twoway_block", src, f"{rep}:576", err_f,
                              kf, pf, twoway_cost(O, N, HW, False,
                                                  [*x, *ko], nw))
            r_b = _kernel_row("fused_twoway_block_bwd", src, f"{rep}:601",
                              err_b, kb, pb,
                              twoway_cost(O, N, HW, True,
                                          [*x, *cots, *kg[-4:]], nw))
            _print_row(f"fused_twoway_block {label}", err_f, rel_f, r_f)
            _print_row(f"fused_twoway_block backward {label}", err_b, rel_b,
                       r_b)
            print(f"  device operations per call (kernels, copies, sets) / "
                  f"cudaLaunchKernel calls: forward kernel {klf[0]} / "
                  f"{klf[1]}, plain {plf[0]} / {plf[1]}; backward kernel "
                  f"{klb[0]} / {klb[1]}, plain {plb[0]} / {plb[1]}",
                  flush=True)
            if (O, N, HW) == TWOWAY_SHAPES[0] and not first:
                rows = {"fwd": r_f, "bwd": r_b}
            del res, ko, kg, po, pg
    if failures:
        raise SystemExit(f"{len(failures)} kernel #8 tensors disagree with "
                         "the plain version:\n" + "\n".join(failures))
    for k in ("fwd", "bwd"):
        rows[k]["max_abs_err"] = worst[k]
    return [rows["fwd"], rows["bwd"]]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def run_video(pred, video, centres):
    """init_state + 8 point prompts on frame 0 + forward propagation.
    Returns (encode_s, propagate_s, logits [T, O, 1, h, w])."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = pred.init_state(video)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prompt_all(pred, state, centres)
    outs = [lg for _, _, lg, _ in pred.propagate_in_video(state)]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return t1 - t0, t2 - t1, np.stack(outs)


def _counters():
    """Every kernel wrapper's launch counter: name -> (wrapper, attribute);
    the backward programs of kernels #3-#5, #7 and #8 count on their own, kernel #6
    (the trunk's backward, B1 and B2 per block) on the trainable block's
    wrapper."""
    from sam2_video_tpu_torch.ops import flash_attention as fa
    from sam2_video_tpu_torch.ops import hiera_block_kernel as hbk
    from sam2_video_tpu_torch.ops import memattn_layer_kernel as mlk
    from sam2_video_tpu_torch.ops import memory_encoder_kernel as mek
    from sam2_video_tpu_torch.ops import twoway_kernel as twk

    from sam2_video_tpu_torch.ops import hiera_block_bwd as hbb

    out = {"fused_block": (hbk.fused_block, "launches"),
           "fused_block_trainable_bwd": (hbb.fused_block_trainable,
                                         "launches"),
           "fused_memory_encoder": (mek.fused_memory_encoder, "launches")}
    for name, fn in (("flash_attention_kproj", fa.flash_attention_kproj),
                     ("flash_attention", fa.flash_attention),
                     ("fused_self_block", mlk.fused_self_block),
                     ("fused_tail_block", mlk.fused_tail_block),
                     ("fused_twoway_block", twk.fused_twoway_block)):
        out[name] = (fn, "launches")
        out[name + "_bwd"] = (fn, "backward_launches")
    return out


def reset_counts():
    from sam2_video_tpu_torch.ops import hiera_block_bwd as hbb

    for fn, attr in _counters().values():
        setattr(fn, attr, 0)
    hbb.fused_block_trainable.launches_by_geometry.clear()


def read_counts() -> dict:
    """Every counter of ``_counters``, then kernel #6's launches per
    geometry class (``fused_block_trainable_bwd[<class>]``, the classes
    launched)."""
    from sam2_video_tpu_torch.ops import hiera_block_bwd as hbb

    counts = {name: getattr(fn, attr) for name, (fn, attr)
              in _counters().items()}
    for key, n in hbb.fused_block_trainable.launches_by_geometry.items():
        counts[f"fused_block_trainable_bwd[{key}]"] = n
    return counts


def _require(counts: dict, names, path: str):
    print(f"kernels launched on the {path} path " + json.dumps(counts),
          flush=True)
    for name in names:
        if counts.get(name, 0) <= 0:
            raise SystemExit(f"kernel {name} never launched on the {path} "
                             "path")


def phase_serve(params, cfg, seed: int, frames: int, objects: int):
    """The usual configuration (use_flash_attention=True: kernels #1-#5
    forward) on two videos, then a shorter pass of one video with
    use_flash_attention=False (the plain memory attention)."""
    from sam2_video_tpu_torch import VideoPredictor

    pred = VideoPredictor(params, cfg, max_objects=objects, device=DEVICE)
    videos = [synthetic_video(seed + v, frames, objects=objects)
              for v in range(2)]
    reset_counts()
    for v, (video, centres) in enumerate(videos):
        enc_s, prop_s, logits = run_video(pred, video, centres)
        S4 = cfg.image_size // 4
        if logits.shape != (frames, objects, 1, S4, S4) or \
                not np.isfinite(logits.astype(np.float32)).all():
            raise SystemExit(f"video {v}: bad logits {logits.shape}")
        print(f"serve video {v}: {frames} frames 480x854 -> "
              f"{cfg.image_size}px, {objects} objects: encode "
              f"{frames / enc_s:.2f} frames/s ({enc_s:.3f} s), propagate "
              f"{frames / prop_s:.2f} frames/s ({prop_s:.3f} s), "
              f"logits {logits.shape} finite", flush=True)
    counts = read_counts()
    _require(counts, [n for n in counts if "_bwd" not in n
                      and n not in TWOWAY + FLASH], "serving")
    if counts["fused_twoway_block"]:
        raise SystemExit("serving with fused_twoway=False ran kernel #8")
    if counts[FLASH[0]]:
        raise SystemExit("one-head serving ran kernel #7")
    plain_cfg = dataclasses.replace(cfg, use_flash_attention=False)
    pred = VideoPredictor(params, plain_cfg, max_objects=objects,
                          device=DEVICE)
    video, centres = synthetic_video(seed + 50, frames // 4,
                                     objects=objects)
    reset_counts()
    _, _, logits = run_video(pred, video, centres)
    if not np.isfinite(logits.astype(np.float32)).all():
        raise SystemExit("use_flash_attention=False: non-finite logits")
    plain = read_counts()
    print(f"serve use_flash_attention=False: {frames // 4} frames, logits "
          f"{logits.shape} finite", flush=True)
    _require(plain, ["fused_block", "fused_memory_encoder"], "plain-memory"
             "-attention serving")
    if (plain["fused_self_block"] or plain["flash_attention_kproj"]
            or plain[FLASH[0]]):
        raise SystemExit("use_flash_attention=False ran a memory-attention "
                         "kernel")
    return counts


def phase_serve_fused(params, cfg, seed: int, frames: int, objects: int):
    """The predictor with fused_twoway=True (kernel #8 forward in the
    conditioning step and in every tracked step) beside the same predictor
    unfused, on one synthetic video of ``frames`` frames and ``objects``
    objects: kernel #8 launched on the fused pass and on no other, low-res
    logits within relative L2 CPU_REL_L2_TOL of the unfused pass. Each
    predictor runs one warm-up pass, then two timed passes in turns
    (unfused, fused, fused, unfused); then device operations and kernel
    launch calls per tracked frame (torch.profiler over the tracked
    frames). Returns the fused pass's counts."""
    from sam2_video_tpu_torch import VideoPredictor

    video, centres = synthetic_video(seed + 200, frames, objects=objects)
    preds = {"unfused": cfg,
             "fused": dataclasses.replace(cfg, fused_twoway=True)}
    preds = {k: VideoPredictor(params, c, max_objects=objects, device=DEVICE)
             for k, c in preds.items()}
    logits, fps, counts = {}, {"unfused": [], "fused": []}, {}
    for label, pred in preds.items():
        reset_counts()
        _, _, logits[label] = run_video(pred, video, centres)
        counts[label] = read_counts()
    for label in ("unfused", "fused", "fused", "unfused"):
        _, prop_s, _ = run_video(preds[label], video, centres)
        fps[label].append(frames / prop_s)
    per_frame = {}
    for label, pred in preds.items():
        state = pred.init_state(video)
        prompt_all(pred, state, centres)
        pred._ensure_cond_outputs(state)
        d, h, _ = _device_launches(
            lambda: list(pred.propagate_in_video(state)))
        per_frame[label] = (d / (frames - 1), h / (frames - 1))
    rel = _rel_l2(*(torch.from_numpy(logits[k].astype(np.float32))
                    for k in ("fused", "unfused")))
    for label in preds:
        print(f"serve fused_twoway={label == 'fused'}: {frames} frames, "
              f"{objects} objects: propagate frames/s "
              + ", ".join(f"{f:.2f}" for f in fps[label])
              + f"; per tracked frame {per_frame[label][0]:.1f} device "
              f"operations, {per_frame[label][1]:.1f} cudaLaunchKernel "
              f"calls; kernel #8 launches {counts[label][TWOWAY[0]]}",
              flush=True)
    print(f"serve fused vs unfused low-res logits: rel_l2 {rel:.4g} (tol "
          f"{CPU_REL_L2_TOL}) {'OK' if rel <= CPU_REL_L2_TOL else 'FAIL'}",
          flush=True)
    if not np.isfinite(logits["fused"].astype(np.float32)).all():
        raise SystemExit("serving with fused_twoway=True: non-finite logits")
    _require(counts["fused"], [TWOWAY[0], "fused_block",
                               "fused_memory_encoder"],
             "fused-two-way serving")
    if counts["unfused"][TWOWAY[0]]:
        raise SystemExit("serving with fused_twoway=False ran kernel #8")
    if not rel <= CPU_REL_L2_TOL:
        raise SystemExit(f"fused and unfused serving disagree: rel_l2 {rel}")
    return counts["fused"]


# kernels #3-#5, which a one-head memory attention runs and a multi-head one
# does not (its cross-attention takes #7)
MEMATTN_FUSED = ("flash_attention_kproj", "flash_attention_kproj_bwd",
                 "fused_self_block", "fused_self_block_bwd",
                 "fused_tail_block", "fused_tail_block_bwd")
HEADS = 2


def phase_serve_heads(params, cfg, seed: int, frames: int, objects: int):
    """The predictor with HEADS memory-attention heads (#7 forward in the
    cross-attention of each of the 4 layers of every tracked step) beside
    the usual one head, on one synthetic video of ``frames`` frames and
    ``objects`` objects: a pass of each with every counter at 0 just before
    it (the two-head pass launches #1, #2 and #7 and none of #3-#5), then
    two timed passes of each in turns (1, 2, 2, 1 heads). Returns the two-
    head pass's counts."""
    from sam2_video_tpu_torch import VideoPredictor

    video, centres = synthetic_video(seed + 300, frames, objects=objects)
    cfgs = {1: cfg, HEADS: dataclasses.replace(
        cfg, memory_attention_num_heads=HEADS)}
    preds = {h: VideoPredictor(params, c, max_objects=objects, device=DEVICE)
             for h, c in cfgs.items()}
    counts, enc, prop = {}, {h: [] for h in cfgs}, {h: [] for h in cfgs}
    S4 = cfg.image_size // 4
    for h, pred in preds.items():
        reset_counts()
        _, _, logits = run_video(pred, video, centres)
        counts[h] = read_counts()
        if logits.shape != (frames, objects, 1, S4, S4) or \
                not np.isfinite(logits.astype(np.float32)).all():
            raise SystemExit(f"serving with {h} heads: bad logits "
                             f"{logits.shape}")
    for h in (1, HEADS, HEADS, 1):
        enc_s, prop_s, _ = run_video(preds[h], video, centres)
        enc[h].append(frames / enc_s)
        prop[h].append(frames / prop_s)
    for h in cfgs:
        print(f"serve memory_attention_num_heads={h}: {frames} frames "
              f"480x854 -> {cfg.image_size}px, {objects} objects: encode "
              f"frames/s " + ", ".join(f"{f:.2f}" for f in enc[h])
              + "; propagate frames/s " + ", ".join(f"{f:.2f}"
                                                    for f in prop[h])
              + f"; kernel #7 launches {counts[h][FLASH[0]]}", flush=True)
    _require(counts[HEADS], ["fused_block", "fused_memory_encoder",
                             FLASH[0]], "two-head serving")
    ran = [n for n in MEMATTN_FUSED + (FLASH[1],) if counts[HEADS][n]]
    if ran or counts[1][FLASH[0]]:
        raise SystemExit(f"two-head serving ran {ran}, or one-head serving "
                         "ran kernel #7")
    return counts[HEADS]


def phase_cpu(params, cfg, seed: int, objects: int):
    """4 frames on the card (bf16, kernels) and on the CPU (float32, plain
    versions, the same weights made again from ``seed``); relative L2 of
    the low-res logits."""
    from sam2_video_tpu_torch import VideoPredictor

    video, centres = synthetic_video(seed + 100, 4, objects=objects)
    card = VideoPredictor(params, cfg, max_objects=objects, device="cuda")
    _, _, on_card = run_video(card, video, centres)
    cpu_cfg = dataclasses.replace(cfg, compute_dtype="float32")
    cpu = VideoPredictor(synthetic_params(cpu_cfg, seed), cpu_cfg,
                         max_objects=objects, device="cpu")
    state = cpu.init_state(video)
    prompt_all(cpu, state, centres)
    on_cpu = np.stack([lg for _, _, lg, _ in cpu.propagate_in_video(state)])
    a, b = on_card.astype(np.float32), on_cpu.astype(np.float32)
    rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))
    agree = float(((a > 0) == (b > 0)).mean())
    print(f"card vs cpu (4 frames, {objects} objects, memory attention "
          f"heads {cfg.memory_attention_num_heads}): rel_l2={rel:.4g} "
          f"tol={CPU_REL_L2_TOL} max_abs_err={np.abs(a - b).max():.4g} "
          f"|cpu| max={np.abs(b).max():.4g} sign_agreement={agree:.4f} "
          f"{'OK' if rel <= CPU_REL_L2_TOL else 'FAIL'}", flush=True)
    if not rel <= CPU_REL_L2_TOL:
        raise SystemExit(f"card and CPU disagree: rel_l2 {rel}")


TRAINABLE = ["memory_attention", "memory_encoder"]
TRAIN_T, TRAIN_O, TRAIN_C, TRAIN_B = 10, 8, 7, 2
TRAIN_STEPS = 5
TRAIN_CPU_LOSS_TOL = 5e-2     # relative; bf16 through 4 layers, 2 frames
TRAIN_CPU_GRAD_TOL = 0.1      # relative L2 of a trainable module's gradient
# a bare embedding's gradient sums the bf16-rounded contributions of every
# position of the grid (maskmem_tpos_enc, no_mem_embed): 0.103 and 0.111
# in the first card run, so its limit is 0.2
TRAIN_CPU_BARE_TOL = 0.2
# the all-trainable combo (the reference's mem+md+pe+ie, bench.py's second
# configuration): every module but the two pointer projections trains
TRAINABLE_ALL = ["memory_attention", "memory_encoder", "mask_decoder",
                 "prompt_encoder", "image_encoder"]


def _train_setup(cfg, params, device, T, O, C, B, trainable=TRAINABLE):
    from sam2_video_tpu_torch.data.synthetic import example_clip
    from sam2_video_tpu_torch.models.video_model import VideoModelConfig
    from sam2_video_tpu_torch.training.loop import (TrainState,
                                                    make_train_step)
    from sam2_video_tpu_torch.training.losses import LossConfig
    from sam2_video_tpu_torch.training.optimizer import make_optimizer

    tx = make_optimizer(params, {"lr": 1e-4, "type": "AdamW"},
                        {"enabled": False}, total_steps=1000,
                        trainable_modules=trainable)
    step = make_train_step(VideoModelConfig(sam2=cfg, prompt_type="point"),
                           LossConfig(), tx, trainable_modules=trainable,
                           device=device)
    batch = example_clip(cfg.image_size, T=T, O=O, C=C, B=B).to(device)
    return TrainState.create(params, tx), step, batch


def phase_train(cfg, seed: int):
    """The headline train step (bench.py's _build_step): SAM2-tiny 384 px,
    bf16, T=10, O=8, C=7, B=2, point prompts, trainable memory attention
    and memory encoder, AdamW lr 1e-4 without a schedule. One warm-up step,
    then TRAIN_STEPS timed steps with every launch counter at 0 just before
    them. With one memory-attention head every kernel but #6, #7 and #8
    must launch; with several (``cfg.memory_attention_num_heads``) #1, #2
    and #7 forward and backward, and none of #3-#5. Returns (the counts,
    median step ms)."""
    heads = cfg.memory_attention_num_heads
    label = "train" if heads == 1 else f"train {heads} heads"
    params = synthetic_params(cfg, seed).to(DEVICE)
    state, step, batch = _train_setup(cfg, params, DEVICE, TRAIN_T, TRAIN_O,
                                      TRAIN_C, TRAIN_B)
    before = {n: t.detach().clone() for n, t in params.named_parameters()}
    state, m = step(state, batch)
    torch.cuda.synchronize()
    print(f"{label} warm-up step: loss {float(m['total_loss']):.6g}",
          flush=True)
    reset_counts()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["total_loss"]))
    counts = read_counts()
    ms = 1e3 * float(np.median(times))
    print(f"{label} B={TRAIN_B} T={TRAIN_T} O={TRAIN_O} {cfg.image_size}px "
          f"{cfg.compute_dtype}: step ms median {ms:.3f} (each: "
          + ", ".join(f"{1e3 * t:.3f}" for t in times) + f"), clips/s "
          f"{TRAIN_B / (ms / 1e3):.3f}; losses "
          + ", ".join(f"{x:.6g}" for x in losses)
          + f"; grad_norm {float(m['grad_norm']):.6g}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    if not all(np.isfinite(losses)):
        raise SystemExit(f"{label}: non-finite loss {losses}")
    moved = frozen_changed = 0
    for n, t in params.named_parameters():
        same = torch.equal(t, before[n])
        if n.split(".")[0] in ("image_encoder", "sam_prompt_encoder",
                               "sam_mask_decoder", "obj_ptr_proj",
                               "obj_ptr_tpos_proj"):
            frozen_changed += not same
        elif n.startswith("memory_attention."):
            if same:
                raise SystemExit(f"{label}: memory_attention leaf {n} did "
                                 "not move")
            moved += 1
    if frozen_changed:
        raise SystemExit(f"{label}: {frozen_changed} frozen leaves changed")
    print(f"{label}: all {moved} memory_attention leaves moved, frozen "
          "leaves bit-for-bit unchanged", flush=True)
    if heads == 1:
        required = [n for n in counts
                    if not n.startswith("fused_block_trainable_bwd")
                    and n not in TWOWAY + FLASH]
        absent = FLASH
    else:
        required, absent = ["fused_block", "fused_memory_encoder",
                            *FLASH], MEMATTN_FUSED
    _require(counts, required, label)
    ran = [n for n in absent + ("fused_block_trainable_bwd",) if counts[n]]
    if ran:
        raise SystemExit(f"{label} ran {ran}")
    return counts, ms


def phase_train_all(cfg, seed: int):
    """The all-trainable step (bench.py's second configuration, the
    reference's mem+md+pe+ie): the headline shapes (SAM2-tiny 384 px, bf16,
    T=10, O=8, C=7, B=2, point prompts, AdamW lr 1e-4) with every module
    but the two pointer projections trainable, so every trunk block runs
    kernel #1 forward and kernel #6 backward. One warm-up step, then
    TRAIN_STEPS timed steps with every launch counter at 0 just before
    them; finite losses, every image encoder leaf moved and every mask
    decoder and prompt encoder leaf that got a gradient, the pointer
    projections unchanged, every kernel launched. Returns the counts."""
    params = synthetic_params(cfg, seed).to(DEVICE)
    state, step, batch = _train_setup(cfg, params, DEVICE, TRAIN_T, TRAIN_O,
                                      TRAIN_C, TRAIN_B, TRAINABLE_ALL)
    before = {n: t.detach().clone() for n, t in params.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    used = set()        # leaves that got a nonzero gradient in some step

    def run(state):
        state, m, grads = step.with_grads(state, batch)
        used.update(n for n, g in grads.items() if bool(g.any()))
        return state, m

    state, m = run(state)
    torch.cuda.synchronize()
    print(f"train_all warm-up step: loss {float(m['total_loss']):.6g}",
          flush=True)
    reset_counts()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = run(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["total_loss"]))
    counts = read_counts()
    ms = 1e3 * float(np.median(times))
    print(f"train_all B={TRAIN_B} T={TRAIN_T} O={TRAIN_O} {cfg.image_size}px "
          f"{cfg.compute_dtype}: step ms median {ms:.3f} (each: "
          + ", ".join(f"{1e3 * t:.3f}" for t in times) + f"), clips/s "
          f"{TRAIN_B / (ms / 1e3):.3f}; losses "
          + ", ".join(f"{x:.6g}" for x in losses)
          + f"; grad_norm {float(m['grad_norm']):.6g}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    if not all(np.isfinite(losses)):
        raise SystemExit(f"train_all: non-finite loss {losses}")
    # every leaf with a gradient moves (AdamW without weight decay leaves a
    # leaf whose gradient is exactly zero where it is: the prompt encoder's
    # mask and box embeddings, the unused multimask heads); every trunk
    # and neck leaf must have one
    moved, unused, still = {}, {}, []
    for n, t in params.named_parameters():
        top = n.split(".")[0]
        same = torch.equal(t, before[n])
        if top in ("obj_ptr_proj", "obj_ptr_tpos_proj"):
            if not same:
                raise SystemExit(f"train_all: frozen leaf {n} changed")
        elif top in ("image_encoder", "sam_mask_decoder",
                     "sam_prompt_encoder"):
            moved[top] = moved.get(top, 0) + (not same)
            if n not in used and top != "image_encoder":
                unused[top] = unused.get(top, 0) + 1
                if not same:
                    raise SystemExit(f"train_all: {n} moved without a "
                                     "gradient")
            elif same:
                still.append(n)
    if still:
        raise SystemExit(f"train_all: {len(still)} leaves did not move: "
                         + ", ".join(still[:10]))
    print("train_all: every leaf with a gradient moved (" + ", ".join(
        f"{k} {v}" for k, v in sorted(moved.items())) + "; without one, "
        "unchanged: " + ", ".join(f"{k} {v}" for k, v in sorted(
            unused.items())) + "), pointer projections bit-for-bit "
        "unchanged", flush=True)
    _require(counts, [n for n in counts if n not in TWOWAY + FLASH] + [
        f"fused_block_trainable_bwd[{g}]" for g in _trunk_classes(cfg)],
        "all-trainable training")
    return counts, ms


def phase_train_cpu(cfg, seed: int):
    """One step of a short clip (T=3, O=4, B=1, 384 px) on the card in bf16
    (kernels) and on the CPU in float32 (plain versions), from the same
    weights and clip, for the memory-only and the all-trainable combos and
    the memory-only combo with HEADS memory-attention heads: the loss and
    each trainable top-level entry's gradient must agree."""
    for trainable in (TRAINABLE, TRAINABLE_ALL):
        _train_cpu(cfg, seed, trainable)
    _train_cpu(dataclasses.replace(cfg, memory_attention_num_heads=HEADS),
               seed, TRAINABLE)


def _train_cpu(cfg, seed: int, trainable):
    out = {}
    for dev, c in ((DEVICE, cfg),
                   ("cpu", dataclasses.replace(cfg, compute_dtype="float32"))):
        params = synthetic_params(c, seed).to(dev)
        state, step, batch = _train_setup(c, params, dev, 3, 4, 2, 1,
                                          trainable)
        _, m, grads = step.with_grads(state, batch)
        out[dev] = (float(m["total_loss"]),
                    {n: g.detach().float().cpu() for n, g in grads.items()})
        del params, state, step, grads
    _compare_steps(f"train card vs cpu, trainable {'+'.join(trainable)}, "
                   f"memory attention heads {cfg.memory_attention_num_heads}",
                   out[DEVICE], out["cpu"])


def _compare_steps(title: str, got, want):
    """Loss within relative TRAIN_CPU_LOSS_TOL and each trainable top-level
    entry's gradient within relative L2 TRAIN_CPU_GRAD_TOL
    (TRAIN_CPU_BARE_TOL for a bare embedding) of ``want``; each a (loss,
    {name: gradient on the CPU}) pair, ``want`` the reference."""
    (lc, gc), (lp, gp) = got, want
    rel = abs(lc - lp) / max(abs(lp), 1e-12)
    print(f"{title}: loss {lc:.6g} vs {lp:.6g} rel {rel:.4g} (tol "
          f"{TRAIN_CPU_LOSS_TOL})", flush=True)
    bad = [] if rel <= TRAIN_CPU_LOSS_TOL else [f"loss rel {rel}"]
    for top in sorted({n.split(".")[0] for n in gp}):
        names = [n for n in gp if n.split(".")[0] == top]
        a = torch.cat([gc[n].flatten() for n in names])
        b = torch.cat([gp[n].flatten() for n in names])
        nb = float(b.norm())
        if nb == 0.0:
            ok = float(a.norm()) == 0.0
            print(f"  grad {top}: zero in the reference, here norm "
                  f"{float(a.norm()):.4g} {'OK' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                bad.append(f"{top}: nonzero gradient")
            continue
        r = float((a - b).norm()) / nb
        tol = TRAIN_CPU_GRAD_TOL if len(names) > 1 else TRAIN_CPU_BARE_TOL
        print(f"  grad {top}: rel_l2 {r:.4g} (|reference| {nb:.4g}, tol "
              f"{tol})",
              flush=True)
        if not r <= tol:
            bad.append(f"{top}: rel_l2 {r}")
    if bad:
        raise SystemExit(f"{title}: " + "; ".join(bad))


FUSED_STEPS = 3


def phase_train_fused(cfg, seed: int):
    """The all-trainable step with fused_twoway=True (kernel #8 forward and
    backward in both blocks of every decoder call: 2 clips x 10 frames x 2
    blocks) against the same step unfused on the card, from the same
    weights and batch: loss and each trainable top-level gradient as in the
    card-vs-CPU check; both kernel #8 counters launched in the fused step
    and not in the unfused one. Then FUSED_STEPS timed steps of each in
    turns, kernel #8's counters at 0 just before them; then the memory-only
    step fused, whose frozen decoder still runs #8's backward for the input
    gradients. Returns (the timed steps' counts, fused step ms)."""
    runs = {}
    for label, c in (("unfused", cfg),
                     ("fused", dataclasses.replace(cfg, fused_twoway=True))):
        params = synthetic_params(c, seed).to(DEVICE)
        state, step, batch = _train_setup(c, params, DEVICE, TRAIN_T,
                                          TRAIN_O, TRAIN_C, TRAIN_B,
                                          TRAINABLE_ALL)
        reset_counts()
        state, m, grads = step.with_grads(state, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        runs[label] = [state, step, batch, (
            float(m["total_loss"]),
            {n: g.detach().float().cpu() for n, g in grads.items()})]
        print(f"train_all fused_twoway={label == 'fused'}: kernel #8 "
              f"launches {counts[TWOWAY[0]]} forward, {counts[TWOWAY[1]]} "
              "backward in one step", flush=True)
        if label == "fused":
            _require(counts, TWOWAY, "fused-two-way all-trainable training")
        elif counts[TWOWAY[0]] or counts[TWOWAY[1]]:
            raise SystemExit("train_all with fused_twoway=False ran #8")
        del grads
    _compare_steps("train_all fused vs unfused on the card",
                   runs["fused"][3], runs["unfused"][3])
    times = {"unfused": [], "fused": []}
    reset_counts()
    for i in range(FUSED_STEPS):
        for label in (("unfused", "fused") if i % 2 == 0
                      else ("fused", "unfused")):
            state, step, batch, _ = runs[label]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[label][0], _ = step(state, batch)
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
    counts = read_counts()
    ms = {k: 1e3 * float(np.median(v)) for k, v in times.items()}
    for label in ("unfused", "fused"):
        print(f"train_all fused_twoway={label == 'fused'} B={TRAIN_B} "
              f"T={TRAIN_T} O={TRAIN_O}: step ms median {ms[label]:.3f} "
              "(each: " + ", ".join(f"{1e3 * t:.3f}" for t in times[label])
              + f"), clips/s {TRAIN_B / (ms[label] / 1e3):.3f}", flush=True)
    print(f"train_all fused: kernel #8 launches over {FUSED_STEPS} steps: "
          f"{counts[TWOWAY[0]]} forward, {counts[TWOWAY[1]]} backward",
          flush=True)
    del runs
    c = dataclasses.replace(cfg, fused_twoway=True)
    params = synthetic_params(c, seed).to(DEVICE)
    state, step, batch = _train_setup(c, params, DEVICE, TRAIN_T, TRAIN_O,
                                      TRAIN_C, TRAIN_B)
    reset_counts()
    _, m = step(state, batch)
    mem = read_counts()
    print(f"train (memory-only) fused_twoway=True: loss "
          f"{float(m['total_loss']):.6g}; kernel #8 launches "
          f"{mem[TWOWAY[0]]} forward, {mem[TWOWAY[1]]} backward", flush=True)
    if not np.isfinite(float(m["total_loss"])):
        raise SystemExit("memory-only fused step: non-finite loss")
    _require(mem, TWOWAY, "fused-two-way memory-only training")
    return counts, ms["fused"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from sam2_video_tpu_torch.models import sam2 as sam2_mod
    from sam2_video_tpu_torch.ops import kernel_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    if "build" in phases:
        t0 = time.perf_counter()
        logs = kernel_build.build(force=True)
        print(f"build: {len(logs)} kernels in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    # the usual configuration; training turns rematerialisation off
    cfg = sam2_mod.SAM2Config(backbone="tiny", image_size=384,
                              compute_dtype="bfloat16", num_maskmem=7,
                              use_flash_attention=True,
                              use_activation_checkpoint=False)
    params = synthetic_params(cfg, args.seed).to("cuda")

    rows = []
    if "kernels" in phases:
        with torch.no_grad():
            rows = phase_kernels(sam2_mod.prepare(params, cfg), cfg,
                                 args.seed, CHUNK, OBJECTS)
        rows += phase_memattn_kernels(params, cfg, args.seed, OBJECTS)
        rows += phase_kproj_kernels(params, cfg, args.seed)
        rows += phase_hiera_bwd_kernels(params, cfg, args.seed, TRAIN_T)
        rows += phase_twoway_kernels(params, cfg, args.seed)
        rows += phase_flash_kernels(args.seed)
        rows += phase_presets(cfg, args.seed)
    heads_cfg = dataclasses.replace(cfg, memory_attention_num_heads=HEADS)
    launches = {}
    if "train" in phases:
        launches, _ = phase_train(cfg, args.seed)
        heads, _ = phase_train(heads_cfg, args.seed)
        launches.update({k: heads[k] for k in FLASH})
    if "train_all" in phases:
        trained_all, _ = phase_train_all(cfg, args.seed)
        fused, _ = phase_train_fused(cfg, args.seed)
        launches = {**launches, **{
            k: v for k, v in trained_all.items()
            if k.startswith("fused_block_trainable_bwd")},
            **{k: fused[k] for k in TWOWAY}}
    if "train_cpu" in phases:
        phase_train_cpu(cfg, args.seed)
    if "serve" in phases:
        served = phase_serve(params, cfg, args.seed, FRAMES, OBJECTS)
        served_fused = phase_serve_fused(params, cfg, args.seed, CHUNK,
                                         OBJECTS)
        served_heads = phase_serve_heads(params, cfg, args.seed, CHUNK,
                                         OBJECTS)
        launches = {**served, **{k: served_fused[k] for k in TWOWAY},
                    **{k: served_heads[k] for k in FLASH}, **launches}
    if "cpu" in phases:
        phase_cpu(params, cfg, args.seed, OBJECTS)
        phase_cpu(params, heads_cfg, args.seed, OBJECTS)

    # each kernel's launches on its training path (#1-#5: the memory-only
    # step, #6 per geometry class: the all-trainable step, #7 the two-head
    # memory-only step, #8 the fused all-trainable steps), else serving's
    # (#7: the two-head pass, #8: the fused pass), else null (the base+ and
    # large rows: no path here runs them)
    for r in rows:
        r["launches"] = launches.get(r["name"])
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
