#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (sam2_video_tpu_torch) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py [--seed 0]
        [--phases build,kernels,presets,train,train_all,train_remat,
                  train_cpu,serve,cpu,fit,frames,eval,ddp]

Phases (all by default):
  build      compile every CUDA kernel from csrc/ (one nvcc per source, all
             started together) and the data pipeline's host C++ helpers
             (the RLE codec, the PNG unfilter, the JPEG decoder, the
             raster, WebP and simple-format decoders' loops) with g++
  kernels    each kernel against its plain PyTorch version at the shapes
             the training and serving paths give it, with error, tolerance
             and CUDA-event times: #1 fused_block (12 trunk blocks, one
             8-frame encode chunk at 384 px; device ms and device
             operations per block beside plain's, a second run
             bit-equal), #2 fused_memory_encoder (8 objects, the same; and
             checked at 1, 3, 16 and 32 objects and on a 1024 px mask, a
             64 x 64 grid, MEMENC_SIZES), and, forward and backward
             (autograd through the plain forward, one random cotangent),
             #4 fused_self_block and #5 fused_tail_block (8 objects, 576
             tokens; also 32 x 576, the batched predictor's lockstep step,
             3 x 784 tokens at 448 px and 2 x 36 at 96 px, which the
             wrappers pad to a multiple of 32; device ms and device
             operations of one call beside plain's, a second run
             bit-equal) and #3 flash_attention_kproj (Lk 580 and 4068 in
             training, 4072 on a full masked ring at T=10,
             4096 with two invalid slots in serving, at 8 and at 32
             objects; its
             limit is 2e-2 of max|plain| of each tensor, the others' of
             max(1, max|plain|)); #6, the
             trunk's backward (B1 + B2 of fused_block_trainable), for each
             of the 12 blocks (every geometry class) at 10 frames of 384 px,
             dx and every parameter gradient (on q-pool blocks, those a 2x2
             max-pool routes by relative L2, POOL_REL_L2); #8
             fused_twoway_block, forward and backward, the decoder's first
             and second block at 8 objects x 8 tokens x 576 keys, 3 x 9
             x 784 (448 px), 1 x 7 x 576, 16 x 9 x 576, 2 x 8 x 4096
             (1024 px) and 32 x 8 x 576 (a lockstep step of the batched
             predictor), a second run bit-equal, every output and
             gradient (the three key-bias
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
             and SAM2-small, base+ and large (phase_preset_blocks): #1
             against plain at every block of each trunk (2 frames, 384
             px), #1 / #6 timed per trunk pass and #6 against plain at the
             first block of each geometry class
  presets    SAM2-small, SAM2-base+ and SAM2-large at 384 px, bf16, full
             width and depth: forward_image against the CPU in float32 (#1
             at every block), the memory-only and all-trainable train steps
             at the headline shapes with the train and train_all phases'
             checks (median step ms, device ms, busy share, peak memory,
             #1-#6 launches per step), one all-trainable step at train_cpu's
             shapes against the CPU in float32 (train_cpu's check and
             limits); then train_torch.py
             (small: data=endovis17 loss=focal_main, 2 x 20 frames of
             1024x1280, 4 steps, a validation batch, the post-fit eval),
             grid_search_threshold_torch.py (base+: probability maps, the
             best threshold, the evaluation at it) and the predictor
             (large: the serve phase's videos and checks, 4 frames against
             the CPU in float32)
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
  train_remat the all-trainable step (the same shapes, weights and batch)
             with remat "none", "body", "body_dots", "modules" and with
             stacked_frame_grads: loss, gradients, peak memory, device ms
             and kernel launches (the recompute's included) of each;
             "modules" and stacked_frame_grads against "none" and
             "body_dots" against "body": loss bit for bit, gradients
             within REMAT_ORDER_REL_L2 (the same sums in another order);
             "body" against "none" within the card-vs-CPU limits; "body"'s
             peak below "none"'s
  train_cpu  one step of a short clip (T=3, O=4, 384 px) on the card (bf16)
             and on the CPU (float32, plain versions), memory-only,
             all-trainable and memory-only with two memory-attention heads:
             loss and each trainable top-level entry's gradient must agree;
             the card's step takes the CPU step's ReLU decisions, and the
             weights are synthetic_params(only_constant=True)
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
  fit        the port's train CLI (train_torch.py) on a COCO-RLE dataset
             that the port writes to disk (2 videos x 20 PNG frames of
             480x854, 7 categories, every PNG row filter), config.yaml at
             384 px, T=10, B=2, 8 objects, from an npz of the weights: 2
             epochs of 2 train and 1 validation batches with finite losses,
             last / top-k checkpoints and index.json, kernels #1-#5 launched
             (counts at 0 just before the run); a second run resumed from
             the best checkpoint (bit-exact restore, steps continue from
             it); the fit loop's clips/s with the loader's waits and the
             loader's ms per batch beside the step's; then the single-clip
             overfit check of tests/test_overfit.py (150 steps, mask
             prompts, bce, lr 1e-3, Dice of the eval forward) on that
             test's T=2 clip scaled to 384 px, beside which one CPU step of
             the CLI in float32 runs as a second process (the first
             batch's loss against the card's); one CLI step with
             model.use_activation_checkpoint=true (the remat loop), its
             loss within TRAIN_CPU_LOSS_TOL of the run's first
  frames     every frame format the port reads, one committed fixture set
             at a time (sam2_video_tpu_torch/data/fixtures/: jpeg, formats,
             raster, webp, simple): (a) every fixture read by the C++
             helpers, which must build, equal to its digests (Pillow's
             convert("RGB"), the eval's OpenCV reader, read_raw, the size;
             ValueError where the library raises); (b) decode ms per frame
             of each kind beside an 8-bit PNG of the same pixels (and large
             frames up to 1280x1024), with the host's CPU; (c) the converter
             CLI (npz equal to the checkpoint's weights) and the EndoVis
             converter (JSON equal to the JAX converter's sha256); (d)
             train_torch.py from the converted npz on one video of each set
             in one dataset (T=4, B=2, 5 steps that read every frame, a
             validation batch) with its post-fit eval, fit clips/s and the
             loader's ms per batch; (e) the same fit on a PNG copy of the
             loader's frames: losses bit-equal; (f) kernels #1-#5 launched
  eval       the evaluation path: (a) the predictor at the serve cell's
             sizes on one 12-frame 480x854 video, every object prompted
             at frame 8, reverse to frame 0 then forward; then a
             predictor with max_cond_frames=2, all objects at frame 0 and
             half again at frame 10 (a partly prompted conditioning frame)
             and a correction click on tracked frame 5; reverse and
             forward frames/s, #1 in each encode and #2-#5 in each pass,
             low-res logits and scores against the same sequences on the
             CPU in float32 (relative L2 0.1); (b) train_torch.py with
             eval.enabled=true on the fit phase's dataset cut to 10
             frames per video, and its npz (one train and one validation
             batch): predict.json, prompt.pkl and
             eval/metrics.json with finite Dice / IoU / MAE, #1-#5
             launched by the eval, its wall and frames/s; the same
             inference() + evaluate from the best checkpoint under
             torch.profiler without the probability maps (busy share)
             and on the CPU in float32 (each frame's probability maps
             within relative L2 0.1); the CLI again with
             eval.batch_videos=2 (clips of 3 frames, the second video cut
             to 9: full lockstep groups and one clip left for the
             sequential path); (c) the batched predictor: 4 clips of 12
             frames (the first (a)'s), 8 objects each, prompted at frame
             8, reverse then forward in lockstep, each video against the
             sequential predictor on the card (logits relative L2 2e-2,
             scores 1e-2) and the first against (a)'s CPU run (0.1);
             launches per lockstep frame, grouped video-frames/s beside
             sequential frames/s, the busy share
  ddp        data-parallel training through train_torch.py at the fit
             phase's shapes (2 train steps and a validation batch of 2
             clips, centre-point prompts, a training GIF at step 2):
             the plain run; (a) trainer.distributed.enabled=true under
             torchrun's variables, a world of one under NCCL, its
             metrics.jsonl and last checkpoint bit-equal to the plain run's;
             (b) trainer.devices=2, two ranks sharing the card under gloo
             (train_torch.launch), the train losses within 1e-3 of the plain
             run's, the final trainable parameters within relative L2 1e-3
             and bit-equal between the ranks, checkpoints and the post-fit
             eval from rank 0 alone, #1-#5 launched on each rank; (c) every
             GIF's frame count, size and delay from its own blocks; each
             layout's step ms, gradient all-reduce ms per step and fit
             clips/s

Weights are ``synthetic_params``: the port's seeded random init moved off
its constants (every parameter + 0.05 N(0, 1), the memory encoder's CXBlock
layer scales, 1e-6 at init, drawn O(1), so the kernel check sees both
CXBlocks) and the object-score head's last bias at +10, so every object
reads present and the card-vs-CPU check compares mask logits rather than a
presence threshold. TF32 is off for both matmuls and cuDNN. The last lines
are the card's name and power limit, a JSON line of per-kernel numbers
(``launches`` from the train phase, #6's from train_all, #7's from the
two-head train steps, #8's from the fused all-trainable steps, each
preset's trunk-pass rows from its steps in the presets phase, else the
serve phase, else null), and
{"ok": true, "device": ...}.
The script needs the repository beside it and a CUDA device; without
either it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import copy
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
PHASES = ("build", "kernels", "presets", "train", "train_all",
          "train_remat", "train_cpu", "serve", "cpu", "fit", "frames", "eval",
          "ddp")
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


# kernel #2's other sizes in phase_kernels: (objects, image size); 32 rows
# are a lockstep step of the batched predictor (4 videos x 8 objects)
MEMENC_SIZES = ((1, 384), (3, 384), (16, 384), (32, 384), (8, 1024))


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
        if S != cfg.image_size or O not in (objects, 4 * objects):
            print(f"{label} {'OK' if ok else 'FAIL'}", flush=True)
        else:
            # timed at the paths' rows: the predictor's and train steps'
            # objects, and a lockstep step of the batched predictor
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
        if (O, S) == (objects, cfg.image_size):
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
    at 32 x 576 (a lockstep step of the batched predictor), 3 objects x 784
    tokens (448 px) and 2 x 36 (96 px), which the wrappers pad to a
    multiple of 32. For kernel and plain version, each
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
    # training grid (the JSON rows), at 4 x 8 objects (a lockstep step of
    # the batched predictor) and at two token counts that are not
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

    for side, nobj in ((F_, O), (F_, 4 * O), (28, 3), (6, 2)):
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
        if (side, nobj) == (F_, O):
            rows.append(r)
        err, rel = _check_grads(
            [f"self d{n} L={Lg}" for n in ["x"] + names], kg, pg, failures)
        fl, nb = self_block_cost(nobj, Lg, True, [x, *cots, *kg])
        r = _kernel_row("fused_self_block_bwd", src, f"{rep}:402", err, kb,
                        pb, (fl, nb + wb))
        _print_row(f"fused_self_block backward L={Lg} "
                   f"{_ops_text(kops[1], pops[1])}; events:", err, rel, r)
        if (side, nobj) == (F_, O):
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
        if (side, nobj) == (F_, O):
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
        if (side, nobj) == (F_, O):
            rows.append(r)

    if failures:
        raise SystemExit(f"{len(failures)} kernel outputs disagree with "
                         "their plain versions:\n" + "\n".join(failures))
    return rows


# kernel #3 at the shapes its paths give it: (label, objects, queries (None:
# one slot's), slot side, slots, pointer tokens, masked). The first three
# are the one-head path's at 384 px (Lk 580, 4068 and 4096, two of seven
# slots masked by -1e9), the fourth 448 px, where a slot of 784 keys
# straddles key tiles and the last tile mixes spatial and pointer keys; a
# lockstep step of the batched predictor (4 videos x 8 objects) and a full
# ring at T=10 (7 slots and 10 pointers, Lk 4072, two slots masked), the
# shape that the JAX package's scanned frame loop attends every frame; the
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
    ("serving, 4 videos", 32, None, 24, 7, 64, True),
    ("training ring, masked", 8, None, 24, 7, 40, True),
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


# SAM2-small, base+ and large (widths 96-768 / 112-896 / 144-1152, head dims
# 96 / 56 / 72): their trunk blocks in the kernels phase, the whole model in
# the presets phase
PRESETS = ("small", "base_plus", "large")
PRESET_FRAMES = 2


def phase_preset_blocks(cfg, seed: int):
    """#1 and #6 at every block of each preset's trunk (``synthetic_params``,
    cfg.image_size, PRESET_FRAMES frames of random input): #1 against its
    plain block within KERNEL_TOL; CUDA-event ms and the bound per block,
    summed per trunk pass, and device ms and operations of the whole pass
    (kernel and plain, one profiler trace over all its blocks' calls);
    then #6 against its plain version at the first block of each geometry
    class, with #6's limits (phase_hiera_bwd_kernels). Returns the JSON rows
    (#1 and #6 per trunk pass of each preset); their launches are the
    presets phase's steps'."""
    from sam2_video_tpu_torch.ops import hiera_block_bwd as hbb
    from sam2_video_tpu_torch.ops import hiera_block_kernel as hbk

    rows = []
    S = cfg.image_size
    for name in PRESETS:
        pcfg = dataclasses.replace(cfg, backbone=name)
        tcfg = pcfg.trunk_config
        q, ratio = tcfg.q_stride, tcfg.mlp_ratio
        blocks = _trunk_blocks(pcfg)
        params = weights(pcfg, seed).to(DEVICE)
        trunk = params["image_encoder"]["trunk"]
        f_sum = np.zeros(3)        # kernel ms, plain ms, bound
        b_sum = np.zeros(3)
        f_by, b_by, f_err = set(), set(), 0.0
        calls = {"fwd": [], "fwd_plain": [], "bwd": [], "bwd_plain": []}
        gen = torch.Generator().manual_seed(seed + 23)
        for i, spec, H, geom in blocks:
            bp = trunk["blocks"][str(i)]
            x = torch.randn((PRESET_FRAMES, H, H, spec["dim"]),
                            generator=gen).to(DEVICE, torch.bfloat16)
            with torch.no_grad():
                got = hbk.fused_block(bp, x, spec, q, ratio)
                want = hbk.fused_block_plain(bp, x, spec, q, ratio)
                err = (got.float() - want.float()).abs().max().item()
                scale = max(1.0, want.float().abs().max().item())
                if not (bool(torch.isfinite(got.float()).all())
                        and err <= KERNEL_TOL * scale):
                    raise SystemExit(f"{name} block {i} ({geom}): kernel #1 "
                                     f"disagrees with plain ({err} > "
                                     f"{KERNEL_TOL * scale})")
                f_err = max(f_err, err)
                fwd = (lambda bp=bp, x=x, spec=spec:
                       hbk.fused_block(bp, x, spec, q, ratio))
                fwd_plain = (lambda bp=bp, x=x, spec=spec:
                             hbk.fused_block_plain(bp, x, spec, q))
                t_k, t_p = cuda_ms(fwd), cuda_ms(fwd_plain)
            calls["fwd"].append(fwd)
            calls["fwd_plain"].append(fwd_plain)
            b, by = bound_ms(*block_cost(spec, PRESET_FRAMES, H, H, ratio,
                                         bp, x, got))
            f_by.add(by)
            f_sum += [t_k, t_p, b]
            w0 = hbb.leaves(bp, spec)
            times = []
            for kind, fn in (("bwd", hbb.fused_block_trainable),
                             ("bwd_plain", hbb.fused_block_trainable_plain)):
                w = _leaves(w0)
                xl = x.detach().clone().requires_grad_(True)
                o = fn(hbb.block_params(w, spec), xl, spec, q, ratio)
                cot = torch.randn(o.shape, generator=gen).to(DEVICE, o.dtype)
                times.append(_time_backward(o, [xl] + w, cot))
                calls[kind].append(
                    lambda o=o, ins=[xl] + w, cot=cot: torch.autograd.grad(
                        o, ins, cot, retain_graph=True))
                if kind == "bwd":
                    dx = torch.autograd.grad(o, xl, cot, retain_graph=True)[0]
            b, by = bound_ms(*hiera_block_bwd_cost(
                spec, PRESET_FRAMES, H, H, ratio,
                sum(t.numel() for t in w0), [x, got, got, dx]))
            b_by.add(by)
            b_sum += [times[0], times[1], b]
        dev = {}
        for kind, fns in calls.items():
            with torch.no_grad() if kind.startswith("fwd") else \
                    torch.enable_grad():
                dev[kind] = _device_launches(
                    lambda fns=fns: [fn() for fn in fns], traces=1)
        del calls
        for kind, sm, bys, k in (("fused_block", f_sum, f_by, "fwd"),
                                 ("fused_block_trainable_bwd", b_sum, b_by,
                                  "bwd")):
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
            kd, pd = dev[k], dev[k + "_plain"]
            print(f"{rname} ({len(blocks)} blocks, {PRESET_FRAMES} frames, "
                  f"{S} px): kernel_ms={sm[0]:.4f} plain_ms={sm[1]:.4f} "
                  f"bound_ms={sm[2]:.4f} device_ms={kd[2]:.4f} (plain "
                  f"{pd[2]:.4f}) device_ops={kd[0]:g} (plain {pd[0]:g})",
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


def _device_launches(fn, traces: int = 3,
                     host_ops: bool = True) -> tuple[int, int, float]:
    """(device operations, kernel launch calls, device ms) of one call of
    ``fn``, from torch.profiler: the device-side events (kernels, copies,
    sets), the host's cudaLaunchKernel calls, and the sum of the device
    events' durations (no host time in it). A trace now and then misses a
    device event, so of ``traces`` traces the one with the most counts.
    Without ``host_ops`` the trace leaves out the host's operator events,
    which are most of a train step's trace and of its processing time."""
    from torch.profiler import ProfilerActivity, profile

    activities = ([ProfilerActivity.CPU] if host_ops else []) + [
        ProfilerActivity.CUDA]
    best = (-1, 0, 0.0)
    for _ in range(traces):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        best = max(best, _trace_counts(prof))
    return best


def _trace_counts(prof) -> tuple[int, int, float]:
    """``_device_launches``'s three numbers of a finished trace, summed over
    its raw events (``key_averages`` first builds every event's tree, which
    takes seconds for a train step's trace, for the same sums)."""
    n = host = ns = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            n += 1
            ns += e.duration_ns()
        elif e.name().startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            host += 1
    return n, host, ns / 1e6


# (O, N, HW): 384 px, 448 px, one object (7 token rows), 144 token rows
# (more than one 64-row tile), 1024 px, a lockstep step of the batched
# predictor (4 videos x 8 objects)
TWOWAY_SHAPES = ((8, 8, 576), (3, 9, 784), (1, 7, 576), (16, 9, 576),
                 (2, 8, 4096), (32, 8, 576))
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
    cotangent), the decoder's first block (first=True) and second, at
    TWOWAY_SHAPES (the slice's shape, 8 objects, 8 tokens, 576 image keys;
    ragged ones; 32 objects, a lockstep step): a second kernel run gives
    the same bits, and both outputs and the
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
    of all cases)."""
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
                    again = run()
                    _twice_same(f"twoway O={O} N={N} HW={HW} first={first}",
                                outs, grads, (again, torch.autograd.grad(
                                    again, w + xl, cots)), failures)
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
    cpu = VideoPredictor(weights(cpu_cfg, seed), cpu_cfg,
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


_WEIGHTS: dict = {}


def weights(cfg, seed: int):
    """A copy of ``synthetic_params(cfg, seed)`` on the CPU, made once per
    configuration but its compute dtype (the weights do not depend on it)
    and kept until ``_WEIGHTS`` is cleared."""
    key = (repr(dataclasses.replace(cfg, compute_dtype="float32")), seed)
    if key not in _WEIGHTS:
        _WEIGHTS[key] = synthetic_params(cfg, seed)
    return copy.deepcopy(_WEIGHTS[key])


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


# the #1-#6 counters whose launches per step the presets phase prints
PER_STEP = ("fused_block", "fused_memory_encoder", "flash_attention_kproj",
            "flash_attention_kproj_bwd", "fused_self_block",
            "fused_self_block_bwd", "fused_tail_block", "fused_tail_block_bwd",
            "fused_block_trainable_bwd")


def _timed_steps(label: str, cfg, run, state, profile: bool):
    """One warm-up step of ``run`` (state -> (state, metrics)), then
    TRAIN_STEPS timed steps with every launch counter at 0 just before
    them; peak memory from just before the warm-up. With ``profile`` one
    more step under torch.profiler (device operations only) gives the
    device ms of a step and its busy share (device ms over the median step
    ms). Prints the step line; returns (state, counts, info: ms, peak_gib,
    device_ms, busy)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, m = run(state)
    torch.cuda.synchronize()
    print(f"{label} warm-up step: loss {float(m['total_loss']):.6g}",
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
    info = dict(ms=1e3 * float(np.median(times)),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    extra = ""
    if profile:
        box = [state]

        def one():
            box[0], _ = run(box[0])

        ops, _, dev_ms = _device_launches(one, traces=1, host_ops=False)
        state = box[0]
        info.update(device_ms=dev_ms, busy=dev_ms / info["ms"])
        extra = (f"; device ms per step {dev_ms:.3f} ({ops} device "
                 f"operations), busy {info['busy']:.3f}; launches per step "
                 + ", ".join(f"{k} {counts[k] / TRAIN_STEPS:g}"
                             for k in PER_STEP))
    print(f"{label} B={TRAIN_B} T={TRAIN_T} O={TRAIN_O} {cfg.image_size}px "
          f"{cfg.compute_dtype}: step ms median {info['ms']:.3f} (each: "
          + ", ".join(f"{1e3 * t:.3f}" for t in times) + f"), clips/s "
          f"{TRAIN_B / (info['ms'] / 1e3):.3f}; losses "
          + ", ".join(f"{x:.6g}" for x in losses)
          + f"; grad_norm {float(m['grad_norm']):.6g}; peak memory "
          f"{info['peak_gib']:.2f} GiB" + extra, flush=True)
    if not all(np.isfinite(losses)):
        raise SystemExit(f"{label}: non-finite loss {losses}")
    return state, counts, info


def _train_label(cfg, what: str) -> str:
    heads = cfg.memory_attention_num_heads
    label = what if heads == 1 else f"{what} {heads} heads"
    return label if cfg.backbone == "tiny" else f"{cfg.backbone} {label}"


def phase_train(cfg, seed: int, profile: bool = False):
    """The headline train step (bench.py's _build_step): SAM2-tiny (or
    cfg.backbone) 384 px, bf16, T=10, O=8, C=7, B=2, point prompts,
    trainable memory attention and memory encoder, AdamW lr 1e-4 without a
    schedule. One warm-up step, then TRAIN_STEPS timed steps with every
    launch counter at 0 just before them (``_timed_steps``). With one
    memory-attention head every kernel but #6, #7 and #8 must launch; with
    several (``cfg.memory_attention_num_heads``) #1, #2 and #7 forward and
    backward, and none of #3-#5. Returns (the counts, ``_timed_steps``'s
    info)."""
    heads = cfg.memory_attention_num_heads
    label = _train_label(cfg, "train")
    params = weights(cfg, seed).to(DEVICE)
    state, step, batch = _train_setup(cfg, params, DEVICE, TRAIN_T, TRAIN_O,
                                      TRAIN_C, TRAIN_B)
    before = {n: t.detach().clone() for n, t in params.named_parameters()}
    state, counts, info = _timed_steps(label, cfg,
                                       lambda s: step(s, batch), state,
                                       profile)
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
    return counts, info


def phase_train_all(cfg, seed: int, profile: bool = False):
    """The all-trainable step (bench.py's second configuration, the
    reference's mem+md+pe+ie): the headline shapes (SAM2-tiny 384 px, bf16,
    T=10, O=8, C=7, B=2, point prompts, AdamW lr 1e-4) with every module
    but the two pointer projections trainable, so every trunk block runs
    kernel #1 forward and kernel #6 backward. One warm-up step, then
    TRAIN_STEPS timed steps with every launch counter at 0 just before
    them; finite losses, every image encoder leaf moved and every mask
    decoder and prompt encoder leaf that got a gradient, the pointer
    projections unchanged, every kernel launched. Returns (the counts,
    ``_timed_steps``'s info)."""
    params = weights(cfg, seed).to(DEVICE)
    state, step, batch = _train_setup(cfg, params, DEVICE, TRAIN_T, TRAIN_O,
                                      TRAIN_C, TRAIN_B, TRAINABLE_ALL)
    before = {n: t.detach().clone() for n, t in params.named_parameters()}
    used = set()        # leaves that got a nonzero gradient in some step
    label = _train_label(cfg, "train_all")

    def run(state):
        state, m, grads = step.with_grads(state, batch)
        used.update(n for n, g in grads.items() if bool(g.any()))
        return state, m

    state, counts, info = _timed_steps(label, cfg, run, state, profile)
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
                raise SystemExit(f"{label}: frozen leaf {n} changed")
        elif top in ("image_encoder", "sam_mask_decoder",
                     "sam_prompt_encoder"):
            moved[top] = moved.get(top, 0) + (not same)
            if n not in used and top != "image_encoder":
                unused[top] = unused.get(top, 0) + 1
                if not same:
                    raise SystemExit(f"{label}: {n} moved without a "
                                     "gradient")
            elif same:
                still.append(n)
    if still:
        raise SystemExit(f"{label}: {len(still)} leaves did not move: "
                         + ", ".join(still[:10]))
    print(f"{label}: every leaf with a gradient moved (" + ", ".join(
        f"{k} {v}" for k, v in sorted(moved.items())) + "; without one, "
        "unchanged: " + ", ".join(f"{k} {v}" for k, v in sorted(
            unused.items())) + "), pointer projections bit-for-bit "
        "unchanged", flush=True)
    _require(counts, [n for n in counts if n not in TWOWAY + FLASH] + [
        f"fused_block_trainable_bwd[{g}]" for g in _trunk_classes(cfg)],
        f"{label} all-trainable training")
    return counts, info


def phase_train_cpu(cfg, seed: int):
    """One step of a short clip (T=3, O=4, B=1, 384 px) on the card in bf16
    (kernels) and on the CPU in float32 (plain versions), from the same
    weights and clip, for the memory-only and the all-trainable combos and
    the memory-only combo with HEADS memory-attention heads: the loss and
    each trainable top-level entry's gradient must agree (``_train_cpu``)."""
    for trainable in (TRAINABLE, TRAINABLE_ALL):
        _train_cpu(cfg, seed, trainable)
    _train_cpu(dataclasses.replace(cfg, memory_attention_num_heads=HEADS),
               seed, TRAINABLE)


def _train_cpu(cfg, seed: int, trainable):
    """One step of a short clip (T=3, O=4, B=1) on the CPU in float32 (the
    plain versions; the reference, first) and on the card in bf16 (the
    kernels), from the same weights and clip: the loss and each trainable
    top-level entry's gradient must agree (``_compare_steps``). The card's
    step takes the reference's ReLU decisions (``relu_decisions``: the
    mask decoder's, the heads' and the pointer MLP's), and the weights are
    ``synthetic_params(only_constant=True)``: a unit within rounding of 0
    that switches, or a feature grown by the noise on the wide products,
    moves the gradients by as much as the limits at ``synthetic_params``,
    in any bf16 run, the plain versions' on the CPU too."""
    from sam2_video_tpu_torch.ops.common import relu_decisions

    params = synthetic_params(cfg, seed, only_constant=True)
    with relu_decisions() as decisions:
        want = _short_step(dataclasses.replace(cfg, compute_dtype="float32"),
                           copy.deepcopy(params), "cpu", trainable)
    with relu_decisions(decisions):
        got = _short_step(cfg, params.to(DEVICE), DEVICE, trainable)
    _compare_steps(f"train card vs cpu, trainable {'+'.join(trainable)}, "
                   f"memory attention heads {cfg.memory_attention_num_heads}",
                   got, want)


def _short_step(c, params, dev, trainable):
    """(loss, {name: gradient on the CPU}) of one train step at train_cpu's
    shapes on ``dev``, from ``params`` (already there)."""
    state, step, batch = _train_setup(c, params, dev, 3, 4, 2, 1, trainable)
    _, m, grads = step.with_grads(state, batch)
    return (float(m["total_loss"]),
            {n: g.detach().float().cpu() for n, g in grads.items()})


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


# the presets phase: SAM2-small, base+ and large at the headline shapes
# through both train steps and card against CPU, then one entry point each
# in BASELINE.json's pairing
PRESET_ENTRY = {"small": "train_torch.py", "base_plus":
                "grid_search_threshold_torch.py", "large": "VideoPredictor"}
# small's fit: an EndoVis17-like dataset (1024x1280 frames, 7 categories,
# clips of 10: data=endovis17, B=1), 4 train steps, one validation batch
PRESET_FIT_VIDEOS, PRESET_FIT_FRAMES, PRESET_FIT_HW = 2, 20, (1024, 1280)
PRESET_FIT_STEPS = 4
# base+'s threshold search: 2 videos of 8 480x854 frames, 7 categories
PRESET_GRID_VIDEOS, PRESET_GRID_FRAMES, PRESET_GRID_HW = 2, 8, (480, 854)


def phase_presets(cfg, seed: int, card: str) -> dict:
    """For each of PRESETS at cfg's shapes (384 px, bf16,
    ``synthetic_params``, the published widths and depths): forward_image
    on the card (#1 at every block) against the CPU in float32; the
    memory-only and all-trainable train steps at the headline shapes
    (phase_train, phase_train_all: T=10, O=8, C=7, B=2, every check of the
    tiny steps, with device ms, busy share, peak memory and #1-#6 launches
    per step); one all-trainable step at train_cpu's shapes on the card
    against the CPU in float32 (``_train_cpu``: the loss and each top-level
    gradient, memory attention and the memory encoder among them); then
    the preset's entry point (PRESET_ENTRY): ``_preset_fit``,
    ``_preset_grid``, or the predictor (phase_serve, phase_cpu). Returns the
    launches of the kernel rows of each preset's trunk pass (#1: the
    memory-only step's, #6: the all-trainable step's, over TRAIN_STEPS
    steps). Small's fit dataset is written by a second process while the
    card runs the presets' steps."""
    import shutil
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    from sam2_video_tpu_torch.data.synthetic import make_synthetic_dataset

    fit_data = _preset_work("fit_data") / "ds"
    writer = ProcessPoolExecutor(max_workers=1, mp_context=get_context(
        "spawn"))
    dataset = writer.submit(
        make_synthetic_dataset, fit_data, num_videos=PRESET_FIT_VIDEOS,
        frames_per_video=PRESET_FIT_FRAMES, image_hw=PRESET_FIT_HW,
        num_categories=FIT_CATS, seed=seed)
    writer.shutdown(wait=False)
    launches = {}
    for name in PRESETS:
        pcfg = dataclasses.replace(cfg, backbone=name)
        t0 = time.perf_counter()
        print(f"presets {name}: {len(_trunk_blocks(pcfg))} trunk blocks, "
              f"widths {pcfg.trunk_config.channel_list[::-1]}, entry point "
              f"{PRESET_ENTRY[name]}", flush=True)
        _preset_forward_image(pcfg, seed)
        mem, _ = phase_train(pcfg, seed, profile=True)
        torch.cuda.empty_cache()
        trained, _ = phase_train_all(pcfg, seed, profile=True)
        torch.cuda.empty_cache()
        launches[f"fused_block[{name} trunk pass]"] = mem["fused_block"]
        launches[f"fused_block_trainable_bwd[{name} trunk pass]"] = trained[
            "fused_block_trainable_bwd"]
        _train_cpu(pcfg, seed, TRAINABLE_ALL)
        if name == "small":
            t1 = time.perf_counter()
            json_path = dataset.result()
            print(f"presets: the fit dataset ({PRESET_FIT_VIDEOS} x "
                  f"{PRESET_FIT_FRAMES} PNG frames of {PRESET_FIT_HW[0]}x"
                  f"{PRESET_FIT_HW[1]}, written by a second process) waited "
                  f"for {time.perf_counter() - t1:.1f} s", flush=True)
            _preset_fit(pcfg, seed, card, json_path)
        elif name == "base_plus":
            _preset_grid(pcfg, seed, card)
        else:
            params = weights(pcfg, seed).to(DEVICE)
            phase_serve(params, pcfg, seed, FRAMES, OBJECTS)
            phase_cpu(params, pcfg, seed, OBJECTS)
            del params
        _WEIGHTS.clear()
        torch.cuda.empty_cache()
        print(f"presets {name}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    shutil.rmtree(fit_data.parent.parent, ignore_errors=True)
    return launches


def _preset_forward_image(pcfg, seed: int):
    """forward_image of PRESET_FRAMES random frames at pcfg.image_size on
    the card (kernel #1 at every block of the trunk, its launches counted)
    against the same on the CPU in float32 (plain blocks): each FPN level
    and vision_pos_enc within relative L2 CPU_REL_L2_TOL."""
    from sam2_video_tpu_torch.models import sam2 as sam2_mod
    from sam2_video_tpu_torch.ops import hiera_block_kernel as hbk

    S, name = pcfg.image_size, pcfg.backbone
    blocks = _trunk_blocks(pcfg)
    rng = np.random.default_rng(seed + 21)
    images = torch.from_numpy(rng.integers(
        0, 256, (PRESET_FRAMES, S, S, 3), dtype=np.uint8))
    params = weights(pcfg, seed)
    n1 = hbk.fused_block.launches
    with torch.no_grad():
        card = sam2_mod.forward_image(
            sam2_mod.prepare(copy.deepcopy(params).to(DEVICE), pcfg), pcfg,
            images.to(DEVICE))
    torch.cuda.synchronize()
    n1 = hbk.fused_block.launches - n1
    cpu_cfg = dataclasses.replace(pcfg, compute_dtype="float32")
    with torch.no_grad():
        ref = sam2_mod.forward_image(params, cpu_cfg, images)
    pairs = [(f"fpn[{k}]", a, b) for k, (a, b) in enumerate(zip(
        card["backbone_fpn"], ref["backbone_fpn"]))]
    pairs += [(f"pos[{k}]", a, b) for k, (a, b) in enumerate(zip(
        card["vision_pos_enc"], ref["vision_pos_enc"]))]
    rel = {k: _rel_l2(a.float().cpu(), b) for k, a, b in pairs}
    finite = all(bool(torch.isfinite(a.float()).all()) for _, a, _ in pairs)
    ok = finite and n1 == len(blocks) and max(rel.values()) <= CPU_REL_L2_TOL
    print(f"{name} forward_image ({PRESET_FRAMES} frames, {S} px) card vs "
          f"cpu float32: rel_l2 " + ", ".join(f"{k} {v:.4g}"
                                               for k, v in rel.items())
          + f" (tol {CPU_REL_L2_TOL}); fused_block launches {n1} of "
          f"{len(blocks)} blocks {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"{name}: the card's image features disagree with "
                         "the CPU's, or a block skipped kernel #1")


def _preset_work(name: str):
    import os
    import shutil
    from pathlib import Path

    work = Path.cwd() / "outputs" / "chip_smoke_presets" / str(
        os.getpid()) / name
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    return work


def _preset_fit(pcfg, seed: int, card: str, json_path):
    """``train_torch.py data=endovis17 model.backbone=<preset>
    loss=focal_main`` from an npz of the preset's ``synthetic_params`` on
    ``json_path``, a synthetic EndoVis17-like dataset (PRESET_FIT_VIDEOS
    videos of PRESET_FIT_FRAMES PNG frames of 1024x1280, 7 categories,
    clips of 10, B=1): PRESET_FIT_STEPS train steps, one validation batch
    and the
    post-fit eval; finite losses and metrics, kernels #1-#5 launched (counts
    at 0 just before the run), fit clips/s beside the loader's ms per
    batch."""
    import os
    import shutil

    from pathlib import Path

    import train_torch
    from sam2_video_tpu_torch.data.coco import COCOIndex
    from sam2_video_tpu_torch.data.pipeline import (ClipDataset,
                                                    ClipDatasetConfig,
                                                    ClipLoader)
    from sam2_video_tpu_torch.training.checkpoint import save_params_npz

    name, home = pcfg.backbone, os.getcwd()
    work = _preset_work(name)
    npz = work / f"{name}.npz"
    save_params_npz(weights(pcfg, seed), npz)
    argv = ["data=endovis17", "loss=focal_main", f"model.backbone={name}",
            f"data.train_path={json_path}", f"data.val_path={json_path}",
            f"data.image_size={pcfg.image_size}",
            f"model.checkpoint_path={npz}", f"model.max_objects={OBJECTS}",
            "trainer.max_epochs=1",
            f"trainer.limit_train_batches={PRESET_FIT_STEPS}",
            "trainer.limit_val_batches=1", "trainer.log_every_n_steps=1",
            "trainer.enable_checkpointing=false",
            "visualization.enabled=false", "eval.enabled=true",
            f"device={DEVICE}"]
    steps, waits = [], []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    os.chdir(work)
    try:
        run_dir, _ = train_torch.run(argv, step_timer=steps,
                                     wait_timer=waits)
    finally:
        os.chdir(home)
    wall = time.perf_counter() - t0
    counts = read_counts()
    run = work / run_dir
    log = [(r["split"], r["step"],
            r.get("train/total_loss", r.get("val/total_loss")))
           for r in _fit_log(run)]
    metrics = json.loads((run / "eval" / "metrics.json").read_text())
    m = {k: metrics[f"eval/{k}"] for k in ("dice", "iou", "mae")}
    print(f"{name} train_torch.py losses (split, step, total_loss): "
          + json.dumps(log) + "; eval metrics " + json.dumps(m), flush=True)
    losses = [v for _, _, v in log]
    if (len(log) != PRESET_FIT_STEPS + 1 or not all(np.isfinite(losses))
            or not all(np.isfinite(v) for v in m.values())):
        raise SystemExit(f"{name} fit: log {log}, eval metrics {m}")
    _require(counts, FIT_REQUIRED, f"{name} fit and post-fit eval")
    loader = ClipLoader(ClipDataset(
        COCOIndex(json_path, pcfg.image_size, FIT_CATS),
        ClipDatasetConfig(clip_length=10, stride=10, num_pos_points=2)),
        batch_size=1, seed=seed)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    loader_ms = 1e3 * (time.perf_counter() - t0) / n
    per = [w + t for w, t in zip(waits, steps)]
    print(f"{name} train_torch.py data=endovis17 loss=focal_main on "
          f"{PRESET_FIT_VIDEOS} x {PRESET_FIT_FRAMES} PNG frames of "
          f"{PRESET_FIT_HW[0]}x{PRESET_FIT_HW[1]}, B=1 T=10 O={OBJECTS} "
          f"{pcfg.image_size}px bf16: "
          f"{len(steps)} train steps, wait + step ms "
          + ", ".join(f"{1e3 * t:.3f} (wait {1e3 * w:.3f})"
                      for t, w in zip(per, waits))
          + f"; fit clips/s host-inclusive {len(per[1:]) / sum(per[1:]):.3f}"
          f" over the warm steps; step ms median "
          f"{1e3 * float(np.median(steps)):.3f}; loader ms per batch "
          f"{loader_ms:.3f} ({n} batches, 2 threads, alone); whole CLI run "
          f"with the post-fit eval {wall:.1f} s; launches " + json.dumps(
              {k: counts[k] for k in FIT_REQUIRED}) + f"; {card}",
          flush=True)
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(Path(json_path).parent.parent, ignore_errors=True)


def _preset_grid(pcfg, seed: int, card: str):
    """``grid_search_threshold_torch.py checkpoint=<npz>
    model.backbone=<preset>`` on the card on a synthetic dataset
    (PRESET_GRID_VIDEOS videos of PRESET_GRID_FRAMES 480x854 PNG frames, 7
    categories, point prompts): the inference with the probability maps
    dumped, ``best_threshold.json``, the evaluation at the best threshold
    with finite metrics, kernels #1-#5 launched (counts at 0 just before
    it); the inference's wall and frames/s and the whole CLI's wall."""
    import os
    import shutil
    from unittest import mock

    import grid_search_threshold_torch
    from sam2_video_tpu_torch.data.synthetic import make_synthetic_dataset
    from sam2_video_tpu_torch.eval import inference as inference_mod
    from sam2_video_tpu_torch.training.checkpoint import save_params_npz

    name, home = pcfg.backbone, os.getcwd()
    work = _preset_work(name)
    json_path = make_synthetic_dataset(
        work / "ds", num_videos=PRESET_GRID_VIDEOS,
        frames_per_video=PRESET_GRID_FRAMES, image_hw=PRESET_GRID_HW,
        num_categories=FIT_CATS, seed=seed + 1)
    npz = work / f"{name}.npz"
    save_params_npz(weights(pcfg, seed), npz)
    plain, timed = inference_mod.inference, []

    def inference(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain(*a, **kw)
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
        return out

    reset_counts()
    t0 = time.perf_counter()
    os.chdir(work)
    try:
        with mock.patch.object(inference_mod, "inference", inference):
            rc = grid_search_threshold_torch.main([
                f"checkpoint={npz}", f"model.backbone={name}",
                f"data.train_path={json_path}", f"data.val_path={json_path}",
                f"data.image_size={pcfg.image_size}",
                f"model.max_objects={OBJECTS}", f"device={DEVICE}"])
    finally:
        os.chdir(home)
    wall = time.perf_counter() - t0
    counts = read_counts()
    runs = sorted((work / "outputs").glob("*/*-thr"))
    if rc != 0 or len(runs) != 1 or len(timed) != 1:
        raise SystemExit(f"{name} grid_search_threshold_torch.py: exit {rc}, "
                         f"runs {runs}")
    best = json.loads((runs[0] / "best_threshold.json").read_text())
    scores = json.loads((runs[0] / "eval.json").read_text())["avg_scores"]
    probs = list((runs[0] / "eval" / "probs").rglob("*.npz"))
    frames = PRESET_GRID_VIDEOS * PRESET_GRID_FRAMES
    finite = all(np.isfinite(v) for v in scores.values()) and np.isfinite(
        best["best_threshold"]) and np.isfinite(best["best_dice"])
    print(f"{name} grid_search_threshold_torch.py on {PRESET_GRID_VIDEOS} x "
          f"{PRESET_GRID_FRAMES} frames of {PRESET_GRID_HW[0]}x"
          f"{PRESET_GRID_HW[1]} ({len(probs)} probability maps): best "
          f"threshold {best['best_threshold']:.3f}, dice there "
          f"{best['best_dice']:.6g}; evaluation at it " + json.dumps(scores)
          + f"; inference {timed[0]:.3f} s, {frames / timed[0]:.2f} frames/s;"
          f" whole CLI {wall:.1f} s; launches " + json.dumps(
              {k: counts[k] for k in FIT_REQUIRED if "_bwd" not in k})
          + f"; {card}", flush=True)
    if not finite or not probs:
        raise SystemExit(f"{name} threshold search: {best}, {scores}, "
                         f"{len(probs)} probability maps")
    _require(counts, [k for k in FIT_REQUIRED if "_bwd" not in k],
             f"{name} threshold search inference")
    shutil.rmtree(work, ignore_errors=True)


# the fit phase: the port's train CLI on a COCO-RLE dataset on disk
FIT_VIDEOS, FIT_FRAMES, FIT_HW, FIT_CATS = 2, 20, (480, 854), 7
FIT_EPOCHS, FIT_TRAIN_BATCHES, FIT_VAL_BATCHES = 2, 2, 1
FIT_REQUIRED = ("fused_block", "fused_memory_encoder",
                "flash_attention_kproj", "flash_attention_kproj_bwd",
                "fused_self_block", "fused_self_block_bwd",
                "fused_tail_block", "fused_tail_block_bwd")
# the overfit check's image size and object-score bias (overfit_check.py)
OVERFIT_SIZE, OVERFIT_OBJ_SCORE_BIAS = 384, 10.0


def fit_overrides(json_path, npz, device: str = DEVICE) -> list:
    """``train_torch.py`` overrides of the fit phase: config.yaml at the
    headline shapes (384 px, T=10, B=2, 8 objects, bf16, trainable memory
    attention and memory encoder), FIT_EPOCHS epochs of FIT_TRAIN_BATCHES
    train and FIT_VAL_BATCHES validation batches, every step logged."""
    return [f"data.train_path={json_path}", f"data.val_path={json_path}",
            "data.image_size=384", "data.video_clip_length=10",
            "data.stride=10", "data.batch_size=2",
            f"data.num_categories={FIT_CATS}", "model.max_objects=8",
            f"model.checkpoint_path={npz}", "eval.enabled=false",
            "visualization.enabled=false",
            f"trainer.max_epochs={FIT_EPOCHS}",
            f"trainer.limit_train_batches={FIT_TRAIN_BATCHES}",
            f"trainer.limit_val_batches={FIT_VAL_BATCHES}",
            "trainer.log_every_n_steps=1", f"device={device}"]


def _fit_log(run_dir) -> list:
    return [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]


def _same_state(a: dict, b: dict, what: str):
    """Raise unless two state dicts (tensors, ints, None, nested dicts)
    are equal bit for bit."""
    if sorted(a) != sorted(b):
        raise SystemExit(f"resume: {what} keys differ")
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            _same_state(x, y, f"{what}.{k}")
        elif isinstance(x, torch.Tensor):
            if not (x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())):
                raise SystemExit(f"resume: {what}.{k} differs")
        elif x != y:
            raise SystemExit(f"resume: {what}.{k} {x} != {y}")


def phase_fit(cfg, seed: int, card: str):
    """The train CLI (``train_torch.run``) on a synthetic COCO-RLE dataset
    written by the port (FIT_VIDEOS videos of FIT_FRAMES 480x854 PNG
    frames, FIT_CATS categories, every PNG row filter), from an npz of
    ``synthetic_params``: finite losses, ``last``, the top-k directories
    and ``index.json``, kernels #1-#5 launched in the fit; ``last`` equal
    bit for bit to the run's final parameters, optimizer state and step; a
    second run resumed from the first's checkpoints, which starts from the
    best one's state bit for bit and logs the steps after it; the fit
    loop's clips/s with the loader's waits, and the loader's ms per batch
    beside the step's; ``phase_overfit``, beside which the same CLI runs
    one step on the CPU in float32 as a second process: its first batch's
    loss against the card's (TRAIN_CPU_LOSS_TOL)."""
    import os
    import shutil
    from pathlib import Path
    from unittest import mock

    import train_torch
    from sam2_video_tpu_torch.data.coco import COCOIndex
    from sam2_video_tpu_torch.data.pipeline import (ClipDataset,
                                                    ClipDatasetConfig,
                                                    ClipLoader)
    from sam2_video_tpu_torch.data.synthetic import make_synthetic_dataset
    from sam2_video_tpu_torch.training.checkpoint import (Checkpointer,
                                                          save_params_npz,
                                                          state_dict_of)
    from sam2_video_tpu_torch.training import loop
    from sam2_video_tpu_torch.training.loop import TrainState

    home = Path.cwd()
    work = home / "outputs" / "chip_smoke_fit" / str(os.getpid())
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    json_path = make_synthetic_dataset(
        work / "ds", num_videos=FIT_VIDEOS, frames_per_video=FIT_FRAMES,
        image_hw=FIT_HW, num_categories=FIT_CATS, seed=seed,
        png_filters=np.arange(FIT_HW[0]) % 5)
    npz = work / "weights.npz"
    save_params_npz(synthetic_params(cfg, seed), npz)
    print(f"fit: dataset of {FIT_VIDEOS} x {FIT_FRAMES} {FIT_HW[0]}x"
          f"{FIT_HW[1]} frames and weights written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def cli(name, extra=(), device=DEVICE, step_timer=None,
            wait_timer=None):
        (work / name).mkdir()
        os.chdir(work / name)
        try:
            run_dir, result = train_torch.run(
                fit_overrides(json_path, npz, device) + list(extra),
                step_timer=step_timer, wait_timer=wait_timer)
        finally:
            os.chdir(home)
        return work / name / run_dir, result

    # the state at each checkpoint, kept in memory beside the files
    saved_states = {}
    plain_save = Checkpointer.save

    def save(self, state, metric=None, epoch=0):
        saved_states[int(state.step)] = state_dict_of(state)
        return plain_save(self, state, metric, epoch)

    steps, waits = [], []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(Checkpointer, "save", save):
        run1, res1 = cli("run1", step_timer=steps, wait_timer=waits)
    wall = time.perf_counter() - t0
    counts = read_counts()
    log1 = _fit_log(run1)
    losses = [r[k] for r in log1 for k in r if k.endswith("total_loss")]
    print("fit losses (split, step, total_loss): " + ", ".join(
        f"({r['split']}, {r['step']}, "
        f"{r.get('train/total_loss', r.get('val/total_loss')):.6g})"
        for r in log1), flush=True)
    if len(losses) != FIT_EPOCHS * (FIT_TRAIN_BATCHES + 1) or not all(
            np.isfinite(losses)):
        raise SystemExit(f"fit: losses {losses}")
    ckpt = run1 / "checkpoints"
    kept = sorted(p.name for p in ckpt.iterdir())
    index = json.loads((ckpt / "index.json").read_text())
    if "last" not in kept or not index or any(
            r["name"] not in kept for r in index):
        raise SystemExit(f"fit: checkpoints {kept}, index {index}")
    print(f"fit: checkpoints {kept}, index.json "
          + json.dumps([(r["name"], round(r["metric"], 6)) for r in index]),
          flush=True)
    _require(counts, FIT_REQUIRED, "fit")
    ran = [n for n in TWOWAY + FLASH + ("fused_block_trainable_bwd",)
           if counts[n]]
    if ran:
        raise SystemExit(f"fit ran {ran}")

    loader = ClipLoader(ClipDataset(
        COCOIndex(json_path, 384, FIT_CATS),
        ClipDatasetConfig(clip_length=10, stride=10, num_pos_points=2)),
        batch_size=2, seed=seed)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    loader_ms = 1e3 * (time.perf_counter() - t0) / n
    # each train step from the request for its batch until its loss is on
    # the host: the loader's wait, the step and the read; the first is cold
    B = 2
    per = [w + t for w, t in zip(waits, steps)]
    warm = per[1:]
    step_ms = 1e3 * float(np.median(steps))
    print(f"fit B={B} T=10 O=8 384px bf16: {len(steps)} train steps; wait "
          "for the batch + step until its loss is on the host, ms: cold "
          f"first {1e3 * per[0]:.3f} (wait {1e3 * waits[0]:.3f}), then "
          + ", ".join(f"{1e3 * t:.3f} (wait {1e3 * w:.3f})"
                      for t, w in zip(warm, waits[1:]))
          + f"; fit loop clips/s host-inclusive {B * len(warm) / sum(warm):.3f}"
          f" over the {len(warm)} warm steps, {B * len(per) / sum(per):.3f} "
          f"with the cold one; step ms median {step_ms:.3f}; whole CLI run "
          f"{wall:.1f} s (set-up, validation and checkpoints included, "
          f"{B * len(per) / wall:.3f} clips/s); loader ms per batch "
          f"{loader_ms:.3f} ({n} batches of 2 clips, 2 worker threads, cold "
          f"cache, alone) against step ms {step_ms:.3f}; {card}", flush=True)
    # the first batch on the CPU in float32: the CLI as a second process,
    # while the card runs the resumed run, the remat step and the overfit
    # check
    (work / "cpu").mkdir()
    with open(work / "cpu" / "cli.log", "w") as log:
        cpu_cli = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve().parent /
                                 "train_torch.py"),
             *fit_overrides(json_path, npz, "cpu"), "trainer.max_epochs=1",
             "trainer.limit_train_batches=1", "trainer.limit_val_batches=0",
             "model.compute_dtype=float32"], cwd=work / "cpu", stdout=log,
            stderr=subprocess.STDOUT)
    try:
        saved = Checkpointer(ckpt).restore(ckpt / "last", device=DEVICE)
        _same_state(state_dict_of(TrainState(**saved)),
                    state_dict_of(res1.state), "last checkpoint")
        # a resumed run starts from the best checkpoint (train.py's
        # resume_from): the state it starts from is the one saved there, bit
        # for bit, and its logged steps continue from that checkpoint's step
        best = index[0]
        started = []
        plain_fit = loop.fit

        def fit(state, *a, **kw):
            started.append(state_dict_of(state))
            return plain_fit(state, *a, **kw)

        with mock.patch.object(loop, "fit", fit):
            run2, _ = cli("run2", [f"trainer.resume_from={ckpt}"])
        _same_state(started[0], saved_states[best["step"]], "resumed state")
        steps1 = [r["step"] for r in log1 if r["split"] == "train"]
        steps2 = [r["step"] for r in _fit_log(run2) if r["split"] == "train"]
        if not steps2 or min(steps2) != best["step"] + 1:
            raise SystemExit(f"resume: steps {steps2} after the best "
                             f"checkpoint's step {best['step']}")
        print(f"fit resume: the last checkpoint restores the final "
              f"parameters, optimizer state and step {res1.state.step} bit "
              f"for bit; the "
              f"resumed run starts from the best checkpoint, {best['name']}, "
              f"with its parameters, optimizer state and step bit for bit: "
              f"train steps {steps1} then {steps2}", flush=True)

        card_loss = log1[0]["train/total_loss"]
        remat, _ = cli("remat", ["trainer.max_epochs=1",
                                 "trainer.limit_train_batches=1",
                                 "trainer.limit_val_batches=0",
                                 "model.use_activation_checkpoint=true"])
        remat_loss = _fit_log(remat)[0]["train/total_loss"]
        rel = abs(remat_loss - card_loss) / max(abs(card_loss), 1e-12)
        print(f"fit with model.use_activation_checkpoint=true (remat body), "
              f"first batch: loss {remat_loss:.6g} vs {card_loss:.6g} without "
              f"it, rel {rel:.4g} (tol {TRAIN_CPU_LOSS_TOL})", flush=True)
        if not (np.isfinite(remat_loss) and rel <= TRAIN_CPU_LOSS_TOL):
            raise SystemExit(f"fit with remat: loss {remat_loss}, rel {rel}")

        phase_overfit(seed, DEVICE)
    except BaseException:
        cpu_cli.kill()
        raise
    finally:
        rc = cpu_cli.wait(timeout=900)
    runs = sorted((work / "cpu" / "outputs").glob("*/*/metrics.jsonl"))
    if rc or len(runs) != 1:
        raise SystemExit(f"fit on the CPU: exit {rc}, "
                         + (work / "cpu" / "cli.log").read_text()[-2000:])
    cpu_loss = _fit_log(runs[0].parent)[0]["train/total_loss"]
    rel = abs(card_loss - cpu_loss) / max(abs(cpu_loss), 1e-12)
    print(f"fit card vs cpu, first batch: loss {card_loss:.6g} vs "
          f"{cpu_loss:.6g} rel {rel:.4g} (tol {TRAIN_CPU_LOSS_TOL})",
          flush=True)
    if not rel <= TRAIN_CPU_LOSS_TOL:
        raise SystemExit(f"fit card vs cpu: loss rel {rel}")
    shutil.rmtree(work, ignore_errors=True)


def phase_overfit(seed: int, device: str) -> None:
    """The reference's convergence check, tests/test_overfit.py, on the
    card (``overfit_check.overfit_run``): that test's T=2 clip scaled to
    OVERFIT_SIZE px, the port's seeded init with the object-score head's
    last bias at OVERFIT_OBJ_SCORE_BIAS, bf16. It passes when the losses
    are finite, the last is below 0.1 of the first and below the first
    three, and the eval forward's tracked-frame Dice is above 0.9 for every
    category the clip holds (``overfit_check.converged``). The trained
    forward's Dice and the eval forward's stability scores are printed
    beside it."""
    from sam2_video_tpu_torch import overfit_check

    r = overfit_check.overfit_run(seed, device, OVERFIT_SIZE, "bfloat16",
                                  OVERFIT_OBJ_SCORE_BIAS)
    ok = overfit_check.converged(r)
    print(f"overfit on tests/test_overfit.py's clip at {OVERFIT_SIZE} px "
          + overfit_check.summary(r)
          + (" PASS" if ok else " did not converge"), flush=True)
    if not ok:
        raise SystemExit("overfit: the check did not converge")


# the frames phase: every frame format the port reads, one fixture set each
# (digests through the C++ helpers, decode times beside PNG), then the train
# CLI with its post-fit eval on one video of each set in one dataset, beside
# a PNG copy of its frames
JPEG_FIXTURES = ("sam2_video_tpu_torch", "data", "fixtures", "jpeg")
JPEG_DECODE_REPEATS = 5       # decodes of each file; the median is printed
# the fixture sets: the C++ helpers each needs and its video's frames
FRAME_SETS = {
    "jpeg": (("jpeg_decode",), "baseline JPEG"),
    "formats": (("jpeg_decode",), "CMYK arithmetic-coded JPEG"),
    "raster": (("raster_decode", "jpeg_decode"), "LZW + predictor TIFF"),
    "webp": (("webp_decode",), "lossy WebP (quality 80)"),
    "simple": (("simple_decode",), "P6, P5, Sun RLE, TGA RLE, SGI RLE, "
               "PCX, QOI and RLE8 DIB, one frame each"),
}
FRAMES_VIDEO = "vid0"         # the video of each set in the mixed dataset
# T=4 clips at stride 4 over 8 frames: 2 clips a video, 10 in the mixed
# dataset, so its 5 train batches of 2 read every frame of every set
FRAMES_FIT = ("data.video_clip_length=4", "data.stride=4",
              "data.num_categories=3", "trainer.max_epochs=1",
              "trainer.limit_train_batches=5", "trainer.limit_val_batches=1",
              "trainer.enable_checkpointing=false")
RASTER_LARGE_HW = (1024, 1280)        # CholecSeg8k's frame size
# the video's frame kinds by file extension (frame i of each video is in
# the i-th; tests/simple_fixtures.py VIDEO_KINDS)
SIMPLE_VIDEO_KINDS = {".ppm": "P6 PPM", ".pgm": "P5 PGM",
                      ".ras": "8-bit Sun RLE with a colour map",
                      ".tga": "TGA RLE", ".sgi": "SGI RLE",
                      ".pcx": "24-bit PCX", ".qoi": "QOI",
                      ".dib": "8-bit RLE8 DIB"}


def host_cpu() -> str:
    """The host's CPU as /proc/cpuinfo names it (its model name, else its
    vendor, family and model numbers), the machine type and the logical
    core count (the decode is host work)."""
    import os
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = fields.get("model name") or " ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model")
        if k in fields) or "CPU not named in /proc/cpuinfo"
    return f"{model} ({platform.machine()}), {os.cpu_count()} logical cores"


def _median_ms(fn, arg, repeats: int = JPEG_DECODE_REPEATS) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(arg)
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def _png16(rgb16: np.ndarray) -> bytes:
    """uint16 [H, W, 3] -> a 16-bit RGB PNG (filter type 0 on every row)."""
    import struct
    import zlib

    from sam2_video_tpu_torch.data import image_io

    H, W, _ = rgb16.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), rgb16.astype(
        ">u2").reshape(H, W * 3).view(np.uint8)], 1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (image_io.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 16, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def _sha256(a: np.ndarray) -> str:
    """sha256 of an array's bytes in little-endian order (digests.json)."""
    import hashlib

    a = np.ascontiguousarray(a)
    return hashlib.sha256(a.astype(a.dtype.newbyteorder("<")).tobytes()
                          ).hexdigest()


def _tiff8(rgb: np.ndarray, lzw: bool) -> bytes:
    """uint8 [H, W, 3] -> a little-endian RGB TIFF in strips of 16 rows,
    uncompressed or LZW (MSB-first codes, early change, Clear at the
    start and when the table reaches 4094 entries)."""
    import struct

    H, W, _ = rgb.shape
    strips = [rgb[y:y + 16].tobytes() for y in range(0, H, 16)]
    if lzw:
        strips = [_lzw(s) for s in strips]
    head, body, offsets = b"II*\0", bytearray(), []
    for s in strips:
        offsets.append(8 + len(body))
        body += s + b"\0" * (len(s) % 2)
    ifd_at = 8 + len(body)
    n = len(strips)
    tags = [(256, 4, 1, W), (257, 4, 1, H), (258, 3, 3, None),
            (259, 3, 1, 5 if lzw else 1), (262, 3, 1, 2), (273, 4, n, None),
            (277, 3, 1, 3), (278, 4, 1, 16), (279, 4, n, None)]
    extra_at = ifd_at + 2 + 12 * len(tags) + 4
    extra = struct.pack("<3H", 8, 8, 8) + b"\0\0"
    arrays = {258: extra_at}
    arrays[273] = extra_at + len(extra)
    extra += struct.pack(f"<{n}I", *offsets)
    arrays[279] = extra_at + len(extra)
    extra += struct.pack(f"<{n}I", *map(len, strips))
    ifd = struct.pack("<H", len(tags))
    for tag, typ, count, value in tags:
        if value is None:
            value = (arrays[tag] if count > 1 or tag == 258 else
                     offsets[0] if tag == 273 else len(strips[0]))
        if typ == 3 and count == 1:
            ifd += struct.pack("<HHIHH", tag, typ, count, value, 0)
        else:
            ifd += struct.pack("<HHII", tag, typ, count, value)
    return (head + struct.pack("<I", ifd_at) + bytes(body) + ifd
            + b"\0\0\0\0" + extra)


def _lzw(data: bytes) -> bytes:
    """TIFF LZW of ``data`` (8-bit symbols; see ``_tiff8``). The string
    table maps (prefix code << 8 | next byte) to a code."""
    table, nxt, width = {}, 258, 9
    codes = [(256, width)]
    cur = -1
    for b in data:
        if cur < 0:
            cur = b
            continue
        code = table.get(cur << 8 | b)
        if code is not None:
            cur = code
            continue
        codes.append((cur, width))
        table[cur << 8 | b] = nxt
        nxt += 1
        if nxt >= 4094:
            codes.append((256, width))
            table, nxt, width = {}, 258, 9
        elif nxt >= (1 << width) and width < 12:  # the decoder's early
            width += 1                            # change, one code later
        cur = b
    codes.append((cur, width))
    if nxt + 1 >= (1 << width) and width < 12:
        width += 1
    codes.append((257, width))
    out, acc, nacc = bytearray(), 0, 0
    for code, w in codes:
        acc, nacc = (acc << w) | code, nacc + w
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def _p6(rgb: np.ndarray) -> bytes:
    h, w, _ = rgb.shape
    return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(
        rgb, np.uint8).tobytes()


def _tga24(rgb: np.ndarray) -> bytes:
    """An uncompressed 24-bit TGA, top row first."""
    import struct

    h, w, _ = rgb.shape
    return struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 24,
                       0x20) + np.ascontiguousarray(rgb[..., ::-1]).tobytes()


def _fixture_reads(kind: str, p, want: dict) -> tuple[dict, dict]:
    """(what the port reads of fixture ``p`` of set ``kind``, what its
    digests say), in the digests' keys: Pillow's ``convert("RGB")`` (the
    loader, ``sha256``), the JAX eval's reader (OpenCV's ``imread``, else
    Pillow), ``np.asarray(Image.open())`` (``read_raw``) and the size, as
    far as each set's digests hold them. The simple formats hold null where
    the library raises: the port must raise ValueError there."""
    from sam2_video_tpu_torch.data import image_io

    if kind == "jpeg":
        rgb = image_io.read_rgb(p)
        return ({"shape": list(rgb.shape), "sha256": _sha256(rgb)},
                {"shape": want["shape"], "sha256": want["sha256"]})
    if kind == "formats":
        got = {"sha256": _sha256(image_io.read_rgb(p)),
               "opencv": _sha256(image_io.read_rgb(p, reader="opencv"))}
        need = {"sha256": want["sha256"],
                "opencv": want["opencv_sha256"] or want["sha256"]}
        if p.suffix == ".png":
            got["raw"] = _sha256(image_io.read_raw(p))
            need["raw"] = want["raw_sha256"]
        return got, need
    if kind == "simple":
        def attempt(fn):
            try:
                return fn()
            except ValueError:
                return None

        rgb = attempt(lambda: image_io.read_rgb(p))
        cv = attempt(lambda: image_io.read_rgb(p, reader="opencv"))
        raw = attempt(lambda: image_io.read_raw(p))
        got = {"size": attempt(lambda: list(image_io.image_size(p))),
               "sha256": None if rgb is None else _sha256(rgb),
               "opencv_sha256": None if cv is None else _sha256(cv),
               "raw_sha256": None if raw is None else _sha256(raw),
               "raw_dtype": None if raw is None else raw.dtype.str}
        return got, {k: want[k] for k in got}
    got = {"opencv_sha256": _sha256(image_io.read_rgb(p, reader="opencv")),
           "size": list(image_io.image_size(p))}
    if want["sha256"] is not None:   # raster: null where Pillow cannot load
        raw = image_io.read_raw(p)
        got.update(sha256=_sha256(image_io.read_rgb(p)),
                   raw_sha256=_sha256(raw), raw_dtype=raw.dtype.str)
    return got, {k: want[k] for k in got}


def _decode_kinds(kind: str, root, work, repo) -> tuple[dict, dict, str]:
    """The decode timings of fixture set ``kind``: ({label: files} of
    240x320 frames, {label: file} of large frames, what the large frames
    are), PNG copies of the same pixels written under ``work``."""
    from sam2_video_tpu_torch.data import image_io

    def png_copies(files, suffix):
        out = []
        for p in files:
            q = work / p.name.replace(suffix, ".png")
            image_io.write_png(q, image_io.read_rgb(p))
            out.append(q)
        return out

    timing, video = root / "timing", root / "video" / "images"
    jpeg_frames = sorted((repo.joinpath(*JPEG_FIXTURES) / "video" /
                          "images").glob("*.jpg"))
    if kind == "jpeg":
        large = root / "coverage" / "large_480x854.jpg"
        return ({"240x320 JPEG frames": jpeg_frames,
                 "their PNG copies": png_copies(jpeg_frames, ".jpg")},
                {"the 480x854 JPEG": large,
                 "its PNG copy": png_copies([large], ".jpg")[0]}, "")
    if kind == "formats":
        for i, p in enumerate(jpeg_frames[::8]):
            rgb = image_io.read_rgb(p)
            image_io.write_png(work / f"png8_{i}.png", rgb)
            (work / f"png16_{i}.png").write_bytes(
                _png16(rgb.astype(np.uint16) * 257))
        return ({"baseline Huffman YCbCr 4:2:0": jpeg_frames,
                 "arithmetic-coded YCbCr 4:2:0": sorted(
                     timing.glob("arith_*.jpg")),
                 "CMYK Huffman": sorted(timing.glob("cmyk_*.jpg")),
                 "CMYK arithmetic-coded": sorted(video.glob("*.jpg")),
                 "lossless RGB": sorted(timing.glob("lossless_*.jpg")),
                 "8-bit RGB PNG": sorted(work.glob("png8_*.png")),
                 "16-bit RGB PNG": sorted(work.glob("png16_*.png"))},
                {}, "")
    if kind == "raster":
        large = image_io.resize_bilinear(image_io.read_rgb(
            repo.joinpath(*JPEG_FIXTURES) / "coverage" /
            "large_480x854.jpg"), RASTER_LARGE_HW[::-1])
        for name, data in (("large.tif", _tiff8(large, False)),
                           ("large_lzw.tif", _tiff8(large, True))):
            (work / name).write_bytes(data)
            if not np.array_equal(image_io.read_rgb(work / name), large):
                raise SystemExit(f"raster: the port's read of {name} "
                                 "differs from the frame written")
        image_io.write_png(work / "large.png", large)
        tiffs = sorted(video.glob("*.tif"))
        return ({"LZW TIFF": sorted(timing.glob("lzw_*.tif")),
                 "LZW + predictor TIFF (the video)": tiffs,
                 "PackBits TIFF": sorted(timing.glob("packbits_*.tif")),
                 "24-bit BMP": sorted(timing.glob("bmp24_*.bmp")),
                 "GIF": sorted(timing.glob("gif_*.gif")),
                 "8-bit PNG (the video's copies)": png_copies(tiffs,
                                                              ".tif")},
                {"uncompressed TIFF": work / "large.tif",
                 "LZW TIFF": work / "large_lzw.tif",
                 "8-bit PNG": work / "large.png"},
                f"{RASTER_LARGE_HW[0]}x{RASTER_LARGE_HW[1]} frame")
    if kind == "webp":
        lossless = sorted(timing.glob("lossless_*.webp"))
        png_copies(lossless + [timing / "large_lossless.webp"], ".webp")
        return ({"lossy WebP q80": sorted(timing.glob("lossy_*.webp")),
                 "lossy WebP q80 (the video)": sorted(video.glob("*.webp")),
                 "lossless WebP": lossless,
                 "8-bit PNG (the lossless frames' pixels)": sorted(
                     work.glob("lossless_*.png")),
                 "baseline JPEG (the frames the WebP were made from)":
                     jpeg_frames[::8]},
                {"lossy WebP q80": timing / "large_lossy.webp",
                 "lossless WebP": timing / "large_lossless.webp",
                 "8-bit PNG": work / "large_lossless.png",
                 "baseline JPEG q90": timing / "large.jpg"},
                "1280x1024 frame of smooth content")
    # simple: each of the video's eight kinds beside PNG copies of its
    # frames, and 1280x1024 QOI and RLE TGA beside uncompressed P6, TGA and
    # PNG of the same pixels
    kinds = {}
    for p in sorted(video.iterdir()):
        label = SIMPLE_VIDEO_KINDS[p.suffix]
        kinds.setdefault(label, []).append(p)
    for label, files in list(kinds.items()):
        kinds[f"{label} PNG copy"] = png_copies(files, files[0].suffix)
    large = image_io.read_rgb(timing / "large.qoi")
    copies = {"uncompressed P6 PPM": (work / "large.ppm", _p6(large)),
              "uncompressed TGA": (work / "large.tga", _tga24(large))}
    for label, (p, data) in copies.items():
        p.write_bytes(data)
        if not np.array_equal(image_io.read_rgb(p), large):
            raise SystemExit(f"simple: the {label} copy of the 1280x1024 "
                             "frame does not read back equal")
    image_io.write_png(work / "large.png", large)
    return (kinds, {"QOI": timing / "large.qoi",
                    "TGA RLE": timing / "large_rle.tga",
                    **{k: p for k, (p, _) in copies.items()},
                    "8-bit PNG": work / "large.png"},
            "1280x1024 frame of posterised smooth content")


def _frames_dataset(repo, work) -> tuple[Path, Path]:
    """One video of each fixture set in one COCO dataset (images copied
    under ``work/mixed``, named ``<set>_<file>``, video ids ``<set>_vid0``)
    and a PNG copy of it with the loader's decoded frames (``work/png``).
    Returns the two annotation files."""
    import shutil
    from pathlib import Path

    from sam2_video_tpu_torch.data import image_io

    out = {"images": [], "annotations": [], "categories": None}
    png = {"images": [], "annotations": out["annotations"],
           "categories": None}
    for d in ("mixed", "png"):
        (work / d / "images").mkdir(parents=True)
    for kind in FRAME_SETS:
        video = repo / "sam2_video_tpu_torch" / "data" / "fixtures" / kind \
            / "video"
        ann = json.loads((video / "annotations.json").read_text())
        out["categories"] = png["categories"] = ann["categories"]
        ids = {}
        for im in ann["images"]:
            if im["video_id"] != FRAMES_VIDEO:
                continue
            ids[im["id"]] = new = len(out["images"])
            name = f"{kind}_{im['file_name']}"
            shutil.copyfile(video / "images" / im["file_name"],
                            work / "mixed" / "images" / name)
            out["images"].append({**im, "id": new, "file_name": name,
                                  "video_id": f"{kind}_{im['video_id']}"})
            pname = Path(name).with_suffix(".png").name
            image_io.write_png(work / "png" / "images" / pname,
                               image_io.read_rgb(video / "images" /
                                                 im["file_name"]))
            png["images"].append({**out["images"][-1], "file_name": pname})
        for a in ann["annotations"]:
            if a["image_id"] in ids:
                out["annotations"].append({
                    **a, "id": len(out["annotations"]),
                    "image_id": ids[a["image_id"]]})
    for d, tree in (("mixed", out), ("png", png)):
        (work / d / "annotations.json").write_text(json.dumps(tree))
    return work / "mixed" / "annotations.json", work / "png" / \
        "annotations.json"


def phase_frames(cfg, seed: int, card: str):
    """Every frame format the port reads, one fixture set at a time from
    FRAME_SETS (JPEG; the other JPEG kinds and 16-bit PNG; TIFF, BMP and
    GIF; WebP; the simple formats ffmpeg writes):
    (a) every committed fixture of the set read by the port with its C++
    helpers, which must build (the numpy references may not stand in), equal
    to its digests (``_fixture_reads``); (b) the median decode ms per frame
    of each kind of the set beside an 8-bit PNG of the same pixels (and
    baseline JPEG, 16-bit PNG; large frames of 480x854 to 1280x1024)
    (``_decode_kinds``). Then (c) the converter CLI (``python -m
    sam2_video_tpu_torch.training.convert`` on a Meta-style checkpoint of
    ``synthetic_params``; the npz equal to the weights bit for bit) and
    ``data_tools/convert_endovis_to_coco_torch.py`` on the committed
    EndoVis tree of 16-bit masks (its JSON equal to the JAX converter's
    committed sha256); (d) ``train_torch.py`` from that npz on one video of
    each set in one dataset (``_frames_dataset``: 5 videos of 8 240x320
    frames, T=4, B=2, 5 train steps that read every frame, one validation
    batch) with its post-fit eval (OpenCV's bits; predict.json, finite
    metrics), its fit clips/s and loader waits, and the loader's ms per
    batch on the JPEG set, the mixed dataset and their PNG copies; (e) the
    same fit on a PNG copy of the loader's decoded frames, eval off: the
    losses equal bit for bit; (f) kernels #1-#5 launched in the run of
    (d), fit and eval (counts at 0 just before it)."""
    import hashlib
    import os
    import shutil
    import subprocess
    from pathlib import Path

    import train_torch
    from sam2_video_tpu_torch.data import host_build
    from sam2_video_tpu_torch.data.coco import COCOIndex
    from sam2_video_tpu_torch.data.pipeline import (ClipDataset,
                                                    ClipDatasetConfig,
                                                    ClipLoader)
    from sam2_video_tpu_torch.data import image_io
    from sam2_video_tpu_torch.training.checkpoint import load_params_npz

    repo = Path(__file__).resolve().parent
    home = Path.cwd()
    work = home / "outputs" / "chip_smoke_frames" / str(os.getpid())
    shutil.rmtree(work, ignore_errors=True)
    for kind, (helpers, _) in FRAME_SETS.items():
        for name in helpers:
            if host_build.load(name) is None:
                raise SystemExit(f"{kind}: the C++ helper csrc/{name}.cpp "
                                 "did not build with g++")
        root = repo / "sam2_video_tpu_torch" / "data" / "fixtures" / kind
        digests = json.loads((root / "digests.json").read_text())
        refused = 0
        for rel, want in digests.items():
            got, need = _fixture_reads(kind, root / rel, want)
            if got != need:
                raise SystemExit(f"{kind}: {rel} reads to {got}, not "
                                 f"{need}")
            refused += want.get("sha256", "") is None
        print(f"{kind} (a): {len(digests)} fixtures read by the C++ helpers "
              f"({', '.join(helpers)}), each equal to its digests"
              + (f" ({refused} that Pillow cannot load or refuses)"
                 if refused else ""), flush=True)
        (work / kind).mkdir(parents=True)
        kinds, large, what = _decode_kinds(kind, root, work / kind, repo)
        ms = {k: float(np.median([_median_ms(image_io.read_rgb, p)
                                  for p in files]))
              for k, files in kinds.items()}
        large_ms = {k: _median_ms(image_io.read_rgb, p)
                    for k, p in large.items()}
        print(f"{kind} (b): decode ms per 240x320 frame (read_rgb, the "
              "loader's bits), median over the files of the median of "
              f"{JPEG_DECODE_REPEATS} reads of each: "
              + ", ".join(f"{k} {v:.3f} ({len(kinds[k])} files)"
                          for k, v in ms.items())
              + ("; per " + (what or "frame") + ": " + ", ".join(
                  f"{k} {v:.3f}" for k, v in large_ms.items())
                 if large else "")
              + f"; one thread, warm page cache; host {host_cpu()}; {card}",
              flush=True)

    # (c) the converter CLI and, as a second process meanwhile, the EndoVis
    # converter
    fixtures = repo / "sam2_video_tpu_torch" / "data" / "fixtures"
    src = (fixtures / "formats" / "endovis16").relative_to(repo)
    endovis = subprocess.Popen(
        [sys.executable, "data_tools/convert_endovis_to_coco_torch.py",
         str(src), str(work / "endovis16.json"), "--n-jobs", "2"],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ckpt, npz = work / "sam2.1_hiera_tiny_synthetic.pt", work / "tiny.npz"
        weights = {k: v.detach().clone()
                   for k, v in synthetic_params(cfg, seed).named_parameters()}
        torch.save({"model": weights}, ckpt)
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "sam2_video_tpu_torch.training.convert",
             str(ckpt), str(npz), "--backbone", "tiny", "--image-size",
             str(cfg.image_size)], cwd=repo, capture_output=True, text=True,
            timeout=600)
        if out.returncode or "0 missing, 0 unexpected" not in out.stdout:
            raise SystemExit(f"formats: the converter CLI: {out.stdout} "
                             f"{out.stderr[-2000:]}")
        loaded = load_params_npz(npz)
        if sorted(loaded) != sorted(weights) or any(
                not torch.equal(loaded[k], v) for k, v in weights.items()):
            raise SystemExit("formats: the converted npz differs from the "
                             "checkpoint's weights")
        print(f"frames (c) converter CLI: {out.stdout.strip()} in "
              f"{time.perf_counter() - t0:.1f} s (beside the EndoVis "
              f"converter); the npz loads back equal to the checkpoint's "
              f"{len(weights)} tensors bit for bit", flush=True)
    except BaseException:
        endovis.kill()
        raise
    stdout, stderr = endovis.communicate(timeout=600)
    got = None if endovis.returncode else hashlib.sha256(
        (work / "endovis16.json").read_bytes()).hexdigest()
    want = (fixtures / "formats" / "endovis16.json.sha256").read_text(
        ).strip()
    if endovis.returncode or got != want:
        raise SystemExit(f"formats: the EndoVis converter on {src}: "
                         f"{stdout} {stderr[-2000:]} sha256 {got} != {want}")
    anns = json.loads((work / "endovis16.json").read_text())["annotations"]
    print(f"frames (c) EndoVis converter on 16-bit class-id masks (ids "
          f"256-65535): {len(anns)} annotations, the JSON's sha256 equal to "
          "the JAX converter's", flush=True)

    # (d)-(f) the CLI on one video of each set, beside a PNG copy
    mixed, png = _frames_dataset(repo, work)
    datasets = {"mixed": (mixed, mixed.parent / "images"),
                "png": (png, png.parent / "images")}

    def cli(name, which, evaluate, step_timer=None, wait_timer=None):
        json_path, images = datasets[which]
        (work / name).mkdir()
        os.chdir(work / name)
        try:
            run_dir, _ = train_torch.run(
                fit_overrides(json_path, npz) + list(FRAMES_FIT)
                + [f"data.image_root={images}",
                   f"eval.enabled={str(evaluate).lower()}"],
                step_timer=step_timer, wait_timer=wait_timer)
        finally:
            os.chdir(home)
        log = [(r["split"], r["step"],
                r.get("train/total_loss", r.get("val/total_loss")))
               for r in _fit_log(work / name / run_dir)]
        return log, work / name / run_dir

    steps, waits = [], []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mixed_log, run = cli("run_mixed", "mixed", True, steps, waits)
    wall = time.perf_counter() - t0
    counts = read_counts()
    metrics = json.loads((run / "eval" / "metrics.json").read_text())
    m = {k: metrics[f"eval/{k}"] for k in ("dice", "iou", "mae")}
    predict = json.loads((run / "eval" / "predict.json").read_text())
    if not predict or not all(np.isfinite(v) for v in m.values()):
        raise SystemExit(f"frames: post-fit eval {m} in {run / 'eval'}")
    png_log, _ = cli("run_png", "png", False)
    print("frames (e) losses (split, step, total_loss): mixed formats "
          + json.dumps(mixed_log) + ", PNG " + json.dumps(png_log),
          flush=True)
    losses = [v for _, _, v in mixed_log]
    if len(mixed_log) != 6 or not all(np.isfinite(losses)):
        raise SystemExit(f"frames fit: log {mixed_log}")
    if mixed_log != png_log:
        raise SystemExit("frames fit: the mixed-format run's losses differ "
                         "from the PNG copy's")
    print("frames (e): the mixed-format run's losses equal the PNG copy's "
          "bit for bit", flush=True)
    _require(counts, FIT_REQUIRED, "frames fit and post-fit eval")
    print("frames (f) launches in the mixed-format run: " + json.dumps(
        {k: counts[k] for k in FIT_REQUIRED}), flush=True)
    B = 2
    loader_ms = {}
    jpeg_video = repo.joinpath(*JPEG_FIXTURES) / "video"
    for which, (json_path, images) in (
            ("JPEG set", (jpeg_video / "annotations.json",
                          jpeg_video / "images")),
            ("JPEG set's PNG copy", (work / "jpeg" / "annotations.json",
                                     work / "jpeg")),
            ("mixed", datasets["mixed"]), ("mixed PNG copy",
                                           datasets["png"])):
        if which == "JPEG set's PNG copy":
            ann = json.loads((jpeg_video / "annotations.json").read_text())
            for im in ann["images"]:
                im["file_name"] = im["file_name"].replace(".jpg", ".png")
            json_path.write_text(json.dumps(ann))
        loader = ClipLoader(ClipDataset(
            COCOIndex(json_path, 384, 3),
            ClipDatasetConfig(clip_length=4, stride=4, num_pos_points=2,
                              image_root=str(images))),
            batch_size=B, seed=seed)
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        loader_ms[which] = 1e3 * (time.perf_counter() - t0) / n
    per = [w + t for w, t in zip(waits, steps)]
    print(f"frames (d) train_torch.py from the converted npz on "
          f"{len(FRAME_SETS)} x 8 240x320 frames ("
          + "; ".join(f"{k}: {v}" for k, (_, v) in FRAME_SETS.items())
          + f"), T=4 B={B} O=8 384px bf16, {len(steps)} steps, a validation "
          f"and the post-fit eval (OpenCV's bits, else Pillow's): "
          f"{wall:.1f} s; wait + step ms "
          + ", ".join(f"{1e3 * t:.3f} (wait {1e3 * w:.3f})"
                      for t, w in zip(per, waits))
          + f"; clips/s host-inclusive {B * len(per[1:]) / sum(per[1:]):.3f} "
          f"over the warm steps; step ms median "
          f"{1e3 * float(np.median(steps)):.3f}; loader ms per batch (alone, "
          "2 threads) " + ", ".join(f"{k} {v:.3f}"
                                    for k, v in loader_ms.items())
          + "; eval metrics " + json.dumps(m) + f"; {card}", flush=True)
    shutil.rmtree(work, ignore_errors=True)


# the eval phase: the predictor both ways, several conditioning frames, a
# correction click; then the train CLI's post-fit eval
EVAL_FRAMES, EVAL_PROMPT_FRAME = 12, 8
EVAL_REQUIRED = ("fused_memory_encoder", "flash_attention_kproj",
                 "fused_self_block", "fused_tail_block")
NO_OBJ_FLOOR = -1000.0        # NO_OBJ placeholder logits (-1024) lie below


def _timed_pass(pred, state, reverse: bool, label: str):
    """One propagation pass with every counter at 0 just before it: the
    yields, the seconds, and #2-#5 required."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = list(pred.propagate_in_video(state, reverse=reverse))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    _require(read_counts(), EVAL_REQUIRED, label)
    return out, secs


def _eval_sequences(pred, video, centres, on_card: bool):
    """The eval phase's two predictor sequences on ``video``. (1) Every
    object prompted at EVAL_PROMPT_FRAME, reverse to frame 0, then
    forward (the reference's order). (2) A predictor with two
    conditioning slots (``pred`` is a pair): every object at frame 0,
    half of them again at frame 10 (a partly prompted conditioning frame:
    the others' rows consolidated as NO_OBJ placeholders), forward; then
    a correction click on tracked frame 5 for object 2 (frame 5 becomes a
    third conditioning frame, consolidated from its tracked rows) and
    forward again. Returns {label: yields} and {label: seconds}; on the
    card every pass requires #2-#5 and each init_state #1."""
    one, two = pred
    outs, secs = {}, {}

    def init(p, label):
        reset_counts()
        t0 = time.perf_counter()
        state = p.init_state(video)
        if on_card:
            torch.cuda.synchronize()
            _require(read_counts(), ["fused_block"], label)
        secs[label] = time.perf_counter() - t0
        return state

    def run(p, state, reverse, label):
        if on_card:
            outs[label], secs[label] = _timed_pass(p, state, reverse, label)
        else:
            outs[label] = list(p.propagate_in_video(state, reverse=reverse))

    state = init(one, "eval encode")
    prompt_all(one, state, centres, frame_idx=EVAL_PROMPT_FRAME)
    run(one, state, True, "eval reverse")
    run(one, state, False, "eval forward")
    state = init(two, "eval multi-frame encode")
    prompt_all(two, state, centres, frame_idx=0)
    half = len(centres) // 2
    prompt_all(two, state, centres[:half], frame_idx=10)
    run(two, state, False, "eval two conditioning frames")
    cy, cx = centres[2]
    two.add_new_points_or_box(state, 5, 2, points=[[cx + 3.0, cy]],
                              labels=[1])
    run(two, state, False, "eval correction click")
    return outs, secs


def phase_eval_predictor(params, cfg, seed: int, objects: int):
    """(a) The predictor's eval features on the card at the serve cell's
    sizes (one 480x854 video of EVAL_FRAMES frames, ``objects`` objects):
    ``_eval_sequences``, with reverse and forward frames/s; then the same
    sequences on the CPU in float32 (plain versions, the same weights made
    again from ``seed``): each pass's low-res logits (outside the NO_OBJ
    placeholders, which must agree) and scores within relative L2
    CPU_REL_L2_TOL."""
    from sam2_video_tpu_torch import VideoPredictor

    video, centres = synthetic_video(seed + 400, EVAL_FRAMES, objects=objects)
    card = [VideoPredictor(params, cfg, max_objects=objects,
                           max_cond_frames=n, device=DEVICE) for n in (1, 2)]
    _eval_sequences(card, video, centres, True)      # warm-up
    got, secs = _eval_sequences(card, video, centres, True)
    for label in ("eval reverse", "eval forward",
                  "eval two conditioning frames", "eval correction click"):
        n = len(got[label])
        print(f"{label}: {n} frames of 480x854 -> {cfg.image_size}px, "
              f"{objects} objects: {n / secs[label]:.2f} frames/s "
              f"({secs[label]:.3f} s)", flush=True)
    cpu_cfg = dataclasses.replace(cfg, compute_dtype="float32")
    cpu_params = synthetic_params(cpu_cfg, seed)
    cpu = [VideoPredictor(cpu_params, cpu_cfg, max_objects=objects,
                          max_cond_frames=n, device="cpu") for n in (1, 2)]
    want, _ = _eval_sequences(cpu, video, centres, False)
    bad = []
    for label, ref in want.items():
        g_out = got[label]
        if [t for t, *_ in g_out] != [t for t, *_ in ref]:
            raise SystemExit(f"{label}: frames {[t for t, *_ in g_out]} on "
                             f"the card, {[t for t, *_ in ref]} on the CPU")
        bad += _logits_close(
            f"{label} card vs cpu float32 ({len(ref)} frames)",
            *((np.stack([lg for _, _, lg, _ in out]),
               np.stack([sc for *_, sc in out])) for out in (g_out, ref)),
            CPU_REL_L2_TOL, score_rel=CPU_REL_L2_TOL)
    if bad:
        raise SystemExit("eval card vs cpu: " + "; ".join(bad))
    return want


def _logits_close(label, got, want, rel_tol, score_atol=None,
                  score_rel=None):
    """Low-res logits [frames, objects, 1, h, w] within relative L2
    ``rel_tol`` outside the NO_OBJ placeholders, which must agree; scores
    [frames, objects] within ``score_atol`` absolute or ``score_rel``
    relative L2. Returns the failures."""
    a, sa = (np.asarray(x, np.float32) for x in got)
    b, sb = (np.asarray(x, np.float32) for x in want)
    placeholder = b < NO_OBJ_FLOOR
    bad = []
    if not np.array_equal(a < NO_OBJ_FLOOR, placeholder):
        bad.append(f"{label}: NO_OBJ placeholders differ")
    rel = _rel_l2(torch.from_numpy(a[~placeholder]),
                  torch.from_numpy(b[~placeholder]))
    s_err = (float(np.abs(sa - sb).max()) if score_atol is not None
             else _rel_l2(torch.from_numpy(sa), torch.from_numpy(sb)))
    s_tol = score_atol if score_atol is not None else score_rel
    print(f"{label}: logits rel_l2 {rel:.4g} (tol {rel_tol}), scores "
          f"{'max abs' if score_atol is not None else 'rel_l2'} "
          f"{s_err:.4g} (tol {s_tol}), {int(placeholder.sum())} "
          f"placeholder logits equal, sign agreement "
          f"{float(((a > 0) == (b > 0)).mean()):.4f}", flush=True)
    if not (rel <= rel_tol and s_err <= s_tol):
        bad.append(f"{label}: logits rel_l2 {rel}, scores {s_err}")
    return bad


# the batched predictor: EVAL_GROUP clips tracked in lockstep
EVAL_GROUP = 4
# each video's logits against the card's sequential run: the same kernels
# at 4x the rows, where kernel #3 may split the keys otherwise (kproj_plan)
# and so round otherwise, through EVAL_FRAMES frames of bf16 memory
BATCHED_REL_L2, BATCHED_SCORE_ATOL = 2e-2, 1e-2


def phase_eval_batched(params, cfg, seed: int, objects: int, cpu_run):
    """(c) The batched predictor (``eval/batched_predictor.py``) on
    EVAL_GROUP clips of EVAL_FRAMES 480x854 frames (the first is (a)'s),
    ``objects`` objects each, every object prompted at EVAL_PROMPT_FRAME,
    reverse to frame 0 then forward in lockstep (a warm-up group, then a
    timed one): #1 in the group's encode and #2-#5 in each pass (their
    launches per lockstep frame printed); each video's low-res logits
    within relative L2 BATCHED_REL_L2 and its scores within
    BATCHED_SCORE_ATOL of the card's sequential predictor on that clip in
    this call, NO_OBJ placeholders equal; the first video within
    CPU_REL_L2_TOL of (a)'s CPU float32 run (``cpu_run``); grouped
    video-frames/s (G x frames / wall) beside the sequential frames/s; and
    the busy share of one group's passes under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from sam2_video_tpu_torch import VideoPredictor
    from sam2_video_tpu_torch.eval.batched_predictor import \
        BatchedVideoPredictor
    from sam2_video_tpu_torch.profile_serving import report

    G = EVAL_GROUP
    clips = [synthetic_video(seed + 400 + 100 * g, EVAL_FRAMES,
                             objects=objects) for g in range(G)]
    frames = np.stack([v for v, _ in clips])
    bat = BatchedVideoPredictor(params, cfg, max_objects=objects,
                                group_size=G, device=DEVICE)
    seq = VideoPredictor(params, cfg, max_objects=objects, device=DEVICE)

    def group(timed: bool):
        secs, passes = {}, {}
        reset_counts()
        t0 = time.perf_counter()
        state = bat.init_group(frames)
        torch.cuda.synchronize()
        secs["encode"] = time.perf_counter() - t0
        if timed:
            _require(read_counts(), ["fused_block"], "batched encode")
        for g, (_, centres) in enumerate(clips):
            for o, (cy, cx) in enumerate(centres):
                bat.add_new_points_or_box(state, g, EVAL_PROMPT_FRAME, o,
                                          points=[[cx, cy]], labels=[1])
        for reverse in (True, False):
            label = f"batched {'reverse' if reverse else 'forward'}"
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            passes[reverse] = list(bat.propagate_in_group(state,
                                                          reverse=reverse))
            torch.cuda.synchronize()
            secs[label] = time.perf_counter() - t0
            if timed:
                counts = read_counts()
                _require(counts, EVAL_REQUIRED, label)
                tracked = len(passes[reverse]) - 1
                print(f"{label}: launches per lockstep frame (G={G} x "
                      f"{objects} objects) " + ", ".join(
                          f"{k} {counts[k] / tracked:g}"
                          for k in EVAL_REQUIRED), flush=True)
        return passes, secs

    group(False)                                      # warm-up
    passes, secs = group(True)
    seq_runs, seq_secs = [], 0.0
    for video, centres in clips:
        state = seq.init_state(video)
        prompt_all(seq, state, centres, frame_idx=EVAL_PROMPT_FRAME)
        run = {}
        for reverse in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run[reverse] = list(seq.propagate_in_video(state,
                                                       reverse=reverse))
            torch.cuda.synchronize()
            seq_secs += time.perf_counter() - t0
        seq_runs.append(run)
    n = sum(len(p) for p in passes.values())
    grouped = G * n / (secs["batched reverse"] + secs["batched forward"])
    print(f"eval batched G={G} x {EVAL_FRAMES} frames of 480x854 -> "
          f"{cfg.image_size}px, {objects} objects: encode "
          f"{secs['encode']:.3f} s, reverse {secs['batched reverse']:.3f} s,"
          f" forward {secs['batched forward']:.3f} s: {grouped:.2f} "
          f"video-frames/s grouped, {G * n / seq_secs:.2f} frames/s "
          f"sequential on the same clips ({seq_secs:.3f} s)", flush=True)

    bad = []
    for reverse in (True, False):
        way = "reverse" if reverse else "forward"
        got = passes[reverse]
        for g in range(G):
            want = seq_runs[g][reverse]
            if [t for t, *_ in got] != [t for t, *_ in want]:
                raise SystemExit(f"batched {way}: frames differ from the "
                                 "sequential run")
            bad += _logits_close(
                f"batched {way} video {g} vs sequential on the card",
                (np.stack([lg[g] for _, _, lg, _ in got]),
                 np.stack([sc[g] for *_, sc in got])),
                (np.stack([lg for _, _, lg, _ in want]),
                 np.stack([sc for *_, sc in want])),
                BATCHED_REL_L2, score_atol=BATCHED_SCORE_ATOL)
        ref = cpu_run[f"eval {way}"]
        bad += _logits_close(
            f"batched {way} video 0 vs cpu float32",
            (np.stack([lg[0] for _, _, lg, _ in got]),
             np.stack([sc[0] for *_, sc in got])),
            (np.stack([lg for _, _, lg, _ in ref]),
             np.stack([sc for *_, sc in ref])),
            CPU_REL_L2_TOL, score_rel=CPU_REL_L2_TOL)
    if bad:
        raise SystemExit("eval batched: " + "; ".join(bad))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        group(False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(prof, f"eval batched G={G}: encode, prompts and both passes "
           "under torch.profiler", wall, top=6)


# the train CLI with its post-fit eval: one train and one validation batch
# on the fit phase's dataset cut to EVAL_CLI_FRAMES frames per video (one
# clip of T=10 each), to keep the script's time
EVAL_CLI_FRAMES = 10
EVAL_CLI_CLIP = 3         # the grouped run's clips: 3 + 3 + 3 + 1 and 3 x 3
EVAL_CLI_OVERRIDES = ("trainer.max_epochs=1", "trainer.limit_train_batches=1",
                      "trainer.limit_val_batches=1", "eval.enabled=true",
                      "eval.probs_out_dir=probs")


def phase_eval_cli(cfg, seed: int, card: str):
    """(b) ``train_torch.py`` with ``eval.enabled=true`` (the fit phase's
    dataset at EVAL_CLI_FRAMES frames per video, its shapes and npz; one
    train and one validation batch) writes
    predict.json, prompt.pkl and eval/metrics.json with finite Dice, IoU
    and MAE, its eval launching #1-#5 (counters at 0 just before the eval,
    read just after), with the eval's wall and frames/s; then the same
    inference() + evaluate from the run's best checkpoint under
    torch.profiler on the card without the probability maps (busy share,
    as profile_fit reads it) and, with them, on the CPU in float32: each
    frame's float16 probability maps within relative L2 CPU_REL_L2_TOL of
    the CPU's, both runs' metrics printed. Then the CLI again with the
    grouped eval (``eval.batch_videos=2``, clips of EVAL_CLI_CLIP frames,
    the second video cut to 9 frames so that full groups form and one
    clip is left for the sequential path, no probability maps): finite
    metrics, lockstep and sequential frames both run, #1-#5 launched, its
    frames/s."""
    import os
    import shutil
    from pathlib import Path
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile

    import train_torch
    from sam2_video_tpu_torch.config import load_config, model_config
    from sam2_video_tpu_torch.data.synthetic import make_synthetic_dataset
    from sam2_video_tpu_torch.eval.batched_predictor import \
        BatchedVideoPredictor
    from sam2_video_tpu_torch.eval.inference import inference
    from sam2_video_tpu_torch.eval.metrics import evaluate
    from sam2_video_tpu_torch.eval.predictor import VideoPredictor
    from sam2_video_tpu_torch.profile_serving import report
    from sam2_video_tpu_torch.training.checkpoint import (Checkpointer,
                                                          save_params_npz)

    home = Path.cwd()
    work = home / "outputs" / "chip_smoke_eval" / str(os.getpid())
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    json_path = make_synthetic_dataset(
        work / "ds", num_videos=FIT_VIDEOS, frames_per_video=EVAL_CLI_FRAMES,
        image_hw=FIT_HW, num_categories=FIT_CATS, seed=seed,
        png_filters=np.arange(FIT_HW[0]) % 5)
    npz = work / "weights.npz"
    save_params_npz(synthetic_params(cfg, seed), npz)
    overrides = fit_overrides(json_path, npz) + list(EVAL_CLI_OVERRIDES)

    frames, timing = [], {}
    plain_eval = train_torch.post_fit_eval
    plain_propagate = VideoPredictor.propagate_in_video

    def counted(self, *a, **kw):
        for out in plain_propagate(self, *a, **kw):
            frames.append(out[0])
            yield out

    def timed_eval(*a, **kw):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_eval(*a, **kw)
        torch.cuda.synchronize()
        timing["wall"] = time.perf_counter() - t0
        timing["counts"] = read_counts()
        return out

    (work / "cli").mkdir()
    os.chdir(work / "cli")
    try:
        with mock.patch.object(train_torch, "post_fit_eval", timed_eval), \
                mock.patch.object(VideoPredictor, "propagate_in_video",
                                  counted):
            run_dir, _ = train_torch.run(overrides)
    finally:
        os.chdir(home)
    ev = work / "cli" / run_dir / "eval"
    missing = [f for f in ("predict.json", "prompt.pkl", "eval.pkl",
                           "metrics.json", "probs/meta.json")
               if not (ev / f).exists()]
    if missing:
        raise SystemExit(f"eval CLI: no {missing} in {ev}")
    metrics = json.loads((ev / "metrics.json").read_text())
    card_m = {k: metrics[f"eval/{k}"] for k in ("dice", "iou", "mae")}
    if not all(np.isfinite(v) for v in card_m.values()):
        raise SystemExit(f"eval CLI: metrics {card_m}")
    _require(timing["counts"], ("fused_block",) + EVAL_REQUIRED,
             "post-fit eval")
    n = len(frames)
    print(f"eval CLI ({FIT_VIDEOS} videos x {EVAL_CLI_FRAMES} frames of "
          f"{FIT_HW[0]}x{FIT_HW[1]}, reverse then forward per clip, "
          f"probability maps written): {n} frames in {timing['wall']:.3f} s "
          f"of post-fit eval, {n / timing['wall']:.2f} frames/s; metrics "
          + json.dumps(card_m) + f"; {card}", flush=True)

    tcfg = load_config("config", overrides)
    sam2_cfg = model_config(tcfg).sam2
    kw = train_torch.inference_kwargs(tcfg, int(tcfg.get("seed", 42)))
    ckpt = Checkpointer(work / "cli" / run_dir / "checkpoints")
    best = ckpt.restore(device=DEVICE)["params"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred_path, _ = inference(best, sam2_cfg, json_path, work / "prof",
                                 device=DEVICE,
                                 **dict(kw, probs_out_dir=None))
        evaluate(pred_path, json_path, work / "prof" / "eval")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(prof, f"eval inference() + evaluate under torch.profiler, {n} "
           "frames, probability maps off (config.yaml's default)", wall,
           top=8)
    print(f"eval under torch.profiler, probability maps off: "
          f"{n / wall:.2f} frames/s", flush=True)

    cpu_cfg = dataclasses.replace(sam2_cfg, compute_dtype="float32")
    cpu_best = ckpt.restore(device="cpu")["params"]
    cpu_pred, _ = inference(cpu_best, cpu_cfg, json_path, work / "cpu",
                            device="cpu", **kw)
    cpu_m = evaluate(cpu_pred, json_path, work / "cpu" / "eval")["avg_scores"]
    print("eval metrics card bf16 " + json.dumps(card_m) + ", cpu float32 "
          + json.dumps({k: float(cpu_m[k]) for k in card_m}), flush=True)
    got_dir, want_dir = ev / "probs", work / "cpu" / "eval" / "probs"
    names = sorted(q.name for q in want_dir.glob("*.npz"))
    if not names or names != sorted(q.name for q in got_dir.glob("*.npz")):
        raise SystemExit("eval CLI: the card's and the CPU's probability "
                         "maps cover different frames")
    rels = []
    for name in names:
        g, w = np.load(got_dir / name), np.load(want_dir / name)
        if not np.array_equal(g["obj_ids"], w["obj_ids"]):
            raise SystemExit(f"eval CLI {name}: object ids differ")
        rels.append(_rel_l2(*(torch.from_numpy(x["probs"].astype(np.float32))
                              for x in (g, w))))
    worst = int(np.argmax(rels))
    print(f"eval CLI probability maps card vs cpu float32, {len(rels)} "
          f"frames: rel_l2 per frame median {np.median(rels):.4g}, max "
          f"{rels[worst]:.4g} ({names[worst]}) (tol {CPU_REL_L2_TOL})",
          flush=True)
    if not max(rels) <= CPU_REL_L2_TOL:
        raise SystemExit(f"eval CLI: probability maps rel_l2 {max(rels)}")

    # the CLI again with the grouped eval: its second video cut to 9
    # frames, so that clips of EVAL_CLI_CLIP frames form full groups of
    # two and leave one clip of each video for the sequential path
    data = json.loads(Path(json_path).read_text())
    cut = {im["id"] for im in data["images"]
           if im["video_id"] == data["images"][-1]["video_id"]
           and im["order_in_video"] == EVAL_CLI_FRAMES - 1}
    data["images"] = [im for im in data["images"] if im["id"] not in cut]
    data["annotations"] = [a for a in data["annotations"]
                           if a["image_id"] not in cut]
    cut_json = work / "ds" / "annotations_cut.json"
    cut_json.write_text(json.dumps(data))
    lockstep, sequential = [], []
    plain_group = BatchedVideoPredictor.propagate_in_group

    def grouped(self, *a, **kw):
        for out in plain_group(self, *a, **kw):
            lockstep.append(len(out[1]))
            yield out

    def counted_seq(self, *a, **kw):
        for out in plain_propagate(self, *a, **kw):
            sequential.append(out[0])
            yield out

    (work / "cli_grouped").mkdir()
    os.chdir(work / "cli_grouped")
    try:
        with mock.patch.object(train_torch, "post_fit_eval", timed_eval), \
                mock.patch.object(VideoPredictor, "propagate_in_video",
                                  counted_seq), \
                mock.patch.object(BatchedVideoPredictor,
                                  "propagate_in_group", grouped):
            run_dir, _ = train_torch.run(overrides + [
                "eval.batch_videos=2", f"eval.clip_length={EVAL_CLI_CLIP}",
                f"eval.coco_path={cut_json}", "eval.probs_out_dir=null"])
    finally:
        os.chdir(home)
    ev = work / "cli_grouped" / run_dir / "eval"
    metrics = json.loads((ev / "metrics.json").read_text())
    grouped_m = {k: metrics[f"eval/{k}"] for k in ("dice", "iou", "mae")}
    if not all(np.isfinite(v) for v in grouped_m.values()) or \
            not lockstep or not sequential:
        raise SystemExit(f"eval CLI grouped: metrics {grouped_m}, "
                         f"{len(lockstep)} lockstep and {len(sequential)} "
                         "sequential frames")
    _require(timing["counts"], ("fused_block",) + EVAL_REQUIRED,
             "grouped post-fit eval")
    frames_done = sum(lockstep) + len(sequential)
    print(f"eval CLI grouped (eval.batch_videos=2, clip_length "
          f"{EVAL_CLI_CLIP}, videos of {EVAL_CLI_FRAMES} and "
          f"{EVAL_CLI_FRAMES - 1} frames, probability maps off): "
          f"{len(lockstep)} lockstep frames of 2 clips each and "
          f"{len(sequential)} sequential frames of the clips left over, "
          f"{frames_done} frames in {timing['wall']:.3f} s of post-fit eval, "
          f"{frames_done / timing['wall']:.2f} frames/s; metrics "
          + json.dumps(grouped_m) + f"; {card}", flush=True)
    shutil.rmtree(work, ignore_errors=True)


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


# the all-trainable step in each rematerialisation mode
REMAT_MODES = (("none", dict(use_activation_checkpoint=False)),
               ("body", dict(remat_mode="body")),
               ("body_dots", dict(remat_mode="body_dots")),
               ("modules", dict(remat_mode="modules")),
               ("stacked_frame_grads", dict(use_activation_checkpoint=False,
                                            stacked_frame_grads=True)))
# modes that run the same forward as their reference ("modules" and
# stacked_frame_grads as "none", "body_dots" as "body"): the loss must be
# equal bit for bit. Their gradients add the same frame contributions in
# another order (the checkpoint's recompute builds the backward's nodes
# later; stacked views sum them in one reduction), partly in bf16 (the
# compute-dtype weight copies, whose frame gradients autograd adds in
# bf16): each top-level entry within this relative L2. A frame's gradient
# lost or counted twice moves an entry by ~1/9.
REMAT_ORDER_REL_L2 = 1e-2
REMAT_SAME = {"modules": "none", "stacked_frame_grads": "none",
              "body_dots": "body"}
REMAT_COUNTED = ("fused_block", "fused_memory_encoder",
                 "flash_attention_kproj", "flash_attention_kproj_bwd",
                 "fused_self_block", "fused_self_block_bwd",
                 "fused_tail_block", "fused_tail_block_bwd")


def phase_train_remat(cfg, seed: int):
    """The all-trainable headline step (384 px, bf16, T=10, O=8, C=7, B=2,
    the same weights and batch) in each of REMAT_MODES: its first step's
    loss and gradients, the kernels' launches in it (the recompute's
    included), its peak memory (``max_memory_allocated`` after
    ``reset_peak_memory_stats``) and then its device ms per step
    (torch.profiler). "modules" and stacked_frame_grads against "none" and
    "body_dots" against "body": loss bit for bit, gradients within
    REMAT_ORDER_REL_L2; "body" against "none" within the card-vs-CPU
    limits (the same loop, each frame under a checkpoint); "body"'s peak below
    "none"'s and its forward kernels launched more often (the
    recompute)."""
    runs = {}
    start = synthetic_params(cfg, seed)     # every mode starts from a copy
    for name, kw in REMAT_MODES:
        t0 = time.perf_counter()
        c = dataclasses.replace(cfg, **kw)
        params = copy.deepcopy(start).to(DEVICE)
        state, step, batch = _train_setup(c, params, DEVICE, TRAIN_T,
                                          TRAIN_O, TRAIN_C, TRAIN_B,
                                          TRAINABLE_ALL)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        state, m, grads = step.with_grads(state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = read_counts()
        ops, launches, dev_ms = _device_launches(lambda: step(state, batch),
                                                 traces=1, host_ops=False)
        loss = float(m["total_loss"])
        runs[name] = (loss, {n: g.detach().float().cpu()
                             for n, g in grads.items()}, peak, counts)
        print(f"train_remat {name}: loss {loss:.9g}, peak memory "
              f"{peak:.3f} GiB, device ms per step {dev_ms:.3f} "
              f"({ops} device operations, {launches} launches); kernel "
              "launches in one step: " + ", ".join(
                  f"{k} {counts[k]}" for k in REMAT_COUNTED)
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        if not np.isfinite(loss):
            raise SystemExit(f"train_remat {name}: loss {loss}")
        del params, state, step, batch, grads
    bad = []
    for name, ref in REMAT_SAME.items():
        (lg, gg, *_), (lr, gr, *_) = runs[name], runs[ref]
        worst, unequal = 0.0, 0
        for top in sorted({n.split(".")[0] for n in gr}):
            names = [n for n in gr if n.split(".")[0] == top]
            a = torch.cat([gg[n].flatten() for n in names])
            b = torch.cat([gr[n].flatten() for n in names])
            unequal += sum(not torch.equal(gg[n], gr[n]) for n in names)
            if float(b.norm()) > 0:
                worst = max(worst, float((a - b).norm() / b.norm()))
            elif float(a.norm()) > 0:
                worst = float("inf")
        print(f"train_remat {name} vs {ref}: loss {lg:.9g} vs {lr:.9g} "
              f"(equal: {lg == lr}); {unequal} of {len(gr)} gradients not "
              f"bit-equal, worst top-level rel_l2 {worst:.4g} (tol "
              f"{REMAT_ORDER_REL_L2})", flush=True)
        if lg != lr or not worst <= REMAT_ORDER_REL_L2:
            bad.append(f"{name} vs {ref}: loss {lg} vs {lr}, rel_l2 "
                       f"{worst}")
    _compare_steps("train_remat body (a checkpoint per frame) vs none",
                   runs["body"][:2], runs["none"][:2])
    body, none = runs["body"], runs["none"]
    if not body[2] < none[2]:
        bad.append(f"body's peak {body[2]:.3f} GiB is not below none's "
                   f"{none[2]:.3f} GiB")
    if not body[3]["flash_attention_kproj"] > \
            none[3]["flash_attention_kproj"]:
        bad.append("body launched #3 forward no more often than none: "
                   "nothing was recomputed")
    if bad:
        raise SystemExit("train_remat: " + "; ".join(bad))



# ---------------------------------------------------------------------------
# The ddp phase: data-parallel training through train_torch.py
# ---------------------------------------------------------------------------

DDP_RANKS = 2
DDP_LOSS_RTOL = 1e-3          # 2 ranks against 1 process: float32 sums
DDP_PARAM_REL_L2 = 1e-3       # the final trainable parameters, the same
DDP_VIZ_EVERY = 2             # a GIF every 2 steps: step 2
DDP_VIZ_FRAMES = 4            # visualization.max_length's default
DDP_EPOCHS = 1                # of the fit phase's 2 train + 1 val batches
# centre-point prompts only: no random draw, whose seed depends on the
# rank (ClipLoader), so every layout sees the same prompts
DDP_OVERRIDES = ("model.num_pos_points=1", "visualization.enabled=true",
                 f"visualization.train_every_n_steps={DDP_VIZ_EVERY}",
                 f"trainer.max_epochs={DDP_EPOCHS}")


def gif_blocks(path) -> tuple:
    """(width, height, frames, delays in 1/100 s) from a GIF89a's own
    blocks (the card's machine has no Pillow)."""
    import struct

    b = path.read_bytes()
    if b[:6] != b"GIF89a":
        raise SystemExit(f"{path}: not a GIF89a")
    w, h = struct.unpack("<HH", b[6:10])
    i = 13 + (3 * (2 << (b[10] & 7)) if b[10] & 0x80 else 0)
    frames, delays = 0, []

    def skip_sub_blocks(i):
        while b[i]:
            i += b[i] + 1
        return i + 1

    while b[i] != 0x3B:
        if b[i] == 0x21:                        # an extension
            if b[i + 1] == 0xF9:
                delays.append(struct.unpack("<H", b[i + 4:i + 6])[0])
            i = skip_sub_blocks(i + 2)
        elif b[i] == 0x2C:                      # an image
            if struct.unpack("<HHHH", b[i + 1:i + 9]) != (0, 0, w, h):
                raise SystemExit(f"{path}: frame {frames} is not full-size")
            flags = b[i + 9]
            i += 10 + (3 * (2 << (flags & 7)) if flags & 0x80 else 0)
            i = skip_sub_blocks(i + 1)          # the LZW code size first
            frames += 1
        else:
            raise SystemExit(f"{path}: unknown block 0x{b[i]:02x} at {i}")
    return w, h, frames, delays


class _ReduceTimer:
    """``parallel/dist.py all_reduce_mean`` with CUDA events around the
    gradient calls (the metrics' calls pass untimed): from the moment the
    backward's work ends on the stream until the averaged gradients are
    back on it, flattening and unflattening included."""

    def __init__(self, plain):
        self.plain, self.events = plain, []

    def __call__(self, tensors, group=None):
        if "total_loss" in tensors:
            return self.plain(tensors, group)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.plain(tensors, group)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def _ddp_train(argv, run_name=None) -> dict:
    """``train_torch.run`` with its step and wait timers, the gradient
    all-reduce timed, and the launch counters at 0 just before it; returns
    the run's directory, result, counts and times."""
    from unittest import mock

    import train_torch
    from sam2_video_tpu_torch.parallel import dist as dist_mod

    steps, waits = [], []
    timer = _ReduceTimer(dist_mod.all_reduce_mean)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(dist_mod, "all_reduce_mean", timer):
        run_dir, result = train_torch.run(argv, step_timer=steps,
                                          wait_timer=waits,
                                          run_name=run_name)
    return {"run_dir": run_dir, "result": result, "counts": read_counts(),
            "steps": steps, "waits": waits, "reduce_ms": timer.ms(),
            "wall": time.perf_counter() - t0}


def _trainable(params) -> dict:
    return {n: t.detach().float().cpu() for n, t in params.named_parameters()
            if n.split(".")[0] in TRAINABLE}


def _ddp_rank(argv, run_name):
    """A rank of phase_ddp's two (``train_torch.launch``'s ``rank_fn``):
    trains as ``_ddp_train`` does and saves its counts, times and final
    trainable parameters beside its logs (``ddp_rank<r>.pt``)."""
    import os

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = _ddp_train(argv, run_name)
    rank = int(os.environ["RANK"])
    torch.save({"rank": rank, "counts": out["counts"], "steps": out["steps"],
                "waits": out["waits"], "reduce_ms": out["reduce_ms"],
                "device": str(next(iter(dict(
                    out["result"].state.params.named_parameters()).values()))
                    .device),
                "params": _trainable(out["result"].state.params)},
               out["run_dir"] / f"ddp_rank{rank}.pt")


def _ddp_timing(label, steps, waits, reduce_ms, clips, card):
    """Print a layout's step ms, all-reduce ms per step and fit clips/s
    (global clips over the warm steps' waits and steps)."""
    per = [w + t for w, t in zip(waits, steps)][1:]
    cps = clips * len(per) / sum(per)
    red = (f"{float(np.median(reduce_ms)):.3f} (median of {len(reduce_ms)}: "
           + ", ".join(f"{x:.3f}" for x in reduce_ms) + ")"
           if reduce_ms else "none")
    print(f"ddp {label}: step ms median {1e3 * float(np.median(steps)):.3f}"
          f" ({', '.join(f'{1e3 * t:.3f}' for t in steps)}); all-reduce ms "
          f"per step {red}; fit clips/s {cps:.3f} over the {len(per)} warm "
          f"steps (global batch {clips}); {card}", flush=True)
    return cps


def phase_ddp(cfg, seed: int, card: str):
    """Data parallelism through ``train_torch.py`` at the fit phase's
    headline shapes (384 px, T=10, O=8, global batch 2, bf16, memory-only,
    ``fit_overrides`` for DDP_EPOCHS epoch: 2 train steps and a validation
    batch), centre-point
    prompts and a GIF every DDP_VIZ_EVERY steps in every layout:

    - the plain single-process run;
    - (a) ``trainer.distributed.enabled=true`` under torchrun's variables,
      a world of one under NCCL (in this process): its metrics.jsonl and
      its last checkpoint bit-equal to the plain run's;
    - (b) ``trainer.devices=2``: two ranks sharing the card under gloo
      (``train_torch.launch``, spawned), one clip each, with the post-fit
      eval: the train losses within DDP_LOSS_RTOL of the plain run's at
      every step, the final trainable parameters within DDP_PARAM_REL_L2
      (relative L2) and bit-equal between the ranks, checkpoints and
      ``eval/metrics.json`` from rank 0 alone, kernels #1-#5 launched on
      each rank (counts at 0 just before each rank's run);
    - (c) the GIFs of every run: DDP_VIZ_FRAMES full-size 2x2 frames at
      JAX's delay, read from the GIF's own blocks.

    Each layout's step ms, all-reduce ms per step and fit clips/s are
    printed beside the card's name and power limit."""
    import os
    import shutil
    from pathlib import Path

    import train_torch
    from sam2_video_tpu_torch.data.synthetic import make_synthetic_dataset
    from sam2_video_tpu_torch.parallel import dist as dist_mod
    from sam2_video_tpu_torch.training.checkpoint import (Checkpointer,
                                                          save_params_npz,
                                                          state_dict_of)
    from sam2_video_tpu_torch.training.loop import TrainState

    home = Path.cwd()
    work = home / "outputs" / "chip_smoke_ddp" / str(os.getpid())
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    json_path = make_synthetic_dataset(
        work / "ds", num_videos=FIT_VIDEOS, frames_per_video=FIT_FRAMES,
        image_hw=FIT_HW, num_categories=FIT_CATS, seed=seed)
    npz = work / "weights.npz"
    save_params_npz(synthetic_params(cfg, seed), npz)
    argv = fit_overrides(json_path, npz) + list(DDP_OVERRIDES)
    B = 2

    def cli(name, extra=(), env=None, launched=False):
        (work / name).mkdir()
        os.chdir(work / name)
        saved = {k: os.environ.get(k) for k in env or {}}
        os.environ.update(env or {})
        try:
            if launched:
                run_dir = train_torch.launch(argv + list(extra), DDP_RANKS,
                                             rank_fn=_ddp_rank)
                return {"run_dir": work / name / run_dir}
            out = _ddp_train(argv + list(extra))
            out["run_dir"] = work / name / out["run_dir"]
            return out
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            os.chdir(home)

    plain = cli("plain")
    if plain["reduce_ms"]:
        raise SystemExit("ddp: the plain run reduced gradients")
    _require(plain["counts"], FIT_REQUIRED, "ddp plain")
    log0 = _fit_log(plain["run_dir"])
    losses0 = [(r["split"], r["step"], r.get("train/total_loss",
                                             r.get("val/total_loss")))
               for r in log0]
    print("ddp plain losses (split, step, total_loss): " + ", ".join(
        f"({a}, {b}, {c:.9g})" for a, b, c in losses0), flush=True)
    _ddp_timing("plain, 1 process", plain["steps"], plain["waits"], [], B,
                card)

    # (a) a world of one under NCCL, through torchrun's variables
    world1 = cli("world1", ["trainer.distributed.enabled=true"],
                 env=dist_mod.rank_env(0, 1, dist_mod.free_port()))
    if torch.distributed.is_initialized():
        raise SystemExit("ddp (a): the process group outlived the run")
    log1 = _fit_log(world1["run_dir"])
    strip = [{k: v for k, v in r.items() if k != "_time"} for r in log0]
    if [{k: v for k, v in r.items() if k != "_time"} for r in log1] != strip:
        raise SystemExit(f"ddp (a): metrics.jsonl differs from the plain "
                         f"run's: {log1} vs {log0}")
    last = [Checkpointer(r["run_dir"] / "checkpoints").restore(
        r["run_dir"] / "checkpoints" / "last", device=DEVICE)
        for r in (plain, world1)]
    _same_state(state_dict_of(TrainState(**last[1])),
                state_dict_of(TrainState(**last[0])), "ddp (a) last")
    _require(world1["counts"], FIT_REQUIRED, "ddp (a)")
    if len(world1["reduce_ms"]) != len(world1["steps"]):
        raise SystemExit("ddp (a): not one gradient all-reduce a step")
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    if (f"rank 0/1, backend {backend}, device {DEVICE}"
            not in (world1["run_dir"] / "training.log").read_text()):
        raise SystemExit(f"ddp (a): not a world of one under {backend}")
    print(f"ddp (a) trainer.distributed.enabled=true, world 1, {backend}: "
          f"metrics.jsonl ({len(log1)} records, train and val losses and "
          "every metric) and the last checkpoint (parameters, optimizer "
          "state, step) bit-equal to the plain run's", flush=True)
    _ddp_timing(f"(a) world 1, {backend}", world1["steps"], world1["waits"],
                world1["reduce_ms"], B, card)

    # (b) two ranks sharing the card under gloo
    t0 = time.perf_counter()
    run2 = cli("ranks2", [f"trainer.devices={DDP_RANKS}",
                          "eval.enabled=true"], launched=True)["run_dir"]
    wall = time.perf_counter() - t0
    rank_dirs = [run2] + [run2 / f"proc{r}" for r in range(1, DDP_RANKS)]
    ranks = [torch.load(d / f"ddp_rank{r}.pt")
             for r, d in enumerate(rank_dirs)]
    for r, d in zip(ranks, rank_dirs):
        _require(r["counts"], FIT_REQUIRED, f"ddp (b) rank {r['rank']}")
        if (f"rank {r['rank']}/{DDP_RANKS}, backend gloo"
                not in (d / "training.log").read_text()):
            raise SystemExit(f"ddp (b): rank {r['rank']} not under gloo")
    if {r["device"] for r in ranks} != {"cuda:0" if DEVICE == "cuda"
                                        else "cpu"}:
        raise SystemExit(f"ddp (b): devices {[r['device'] for r in ranks]}")
    log2 = _fit_log(run2)
    bad = []
    if [(r["split"], r["step"]) for r in log2] != [
            (a, b) for a, b, _ in losses0]:
        bad.append(f"records {[(r['split'], r['step']) for r in log2]}")
    rels = []
    for r, (split, step, want) in zip(log2, losses0):
        got = r[f"{split}/total_loss"]
        rels.append(abs(got - want) / max(abs(want), 1e-12))
        if split == "train" and not rels[-1] <= DDP_LOSS_RTOL:
            bad.append(f"{split} step {step}: loss {got} vs {want}")
    names = sorted(ranks[0]["params"])
    for r in ranks[1:]:
        for n in names:
            if not torch.equal(r["params"][n], ranks[0]["params"][n]):
                bad.append(f"rank {r['rank']} {n} differs from rank 0's")
    got = torch.cat([ranks[0]["params"][n].reshape(-1) for n in names])
    want_p = _trainable(plain["result"].state.params)
    want = torch.cat([want_p[n].reshape(-1) for n in names])
    start_p = _trainable(synthetic_params(cfg, seed))
    start = torch.cat([start_p[n].reshape(-1) for n in names])
    rel = float((got - want).norm() / want.norm())
    upd = float((got - want).norm() / (want - start).norm())
    if not rel <= DDP_PARAM_REL_L2:
        bad.append(f"parameters rel L2 {rel}")
    ckpts = sorted(p.relative_to(run2).as_posix()
                   for p in run2.rglob("checkpoints"))
    evals = sorted(p.relative_to(run2).as_posix()
                   for p in run2.rglob("eval/metrics.json"))
    if ckpts != ["checkpoints"] or evals != ["eval/metrics.json"]:
        bad.append(f"checkpoints {ckpts}, eval {evals}")
    avg = json.loads((run2 / "eval" / "metrics.json").read_text())[
        "avg_scores"]
    if not all(np.isfinite(avg[k]) for k in ("dice", "iou", "mae")):
        bad.append(f"eval {avg}")
    print(f"ddp (b) trainer.devices={DDP_RANKS}, gloo, both ranks on "
          f"{ranks[0]['device']}: losses rel to the plain run's (train limit "
          f"{DDP_LOSS_RTOL}) " + ", ".join(
              f"({s}, {t}) {x:.3g}" for (s, t, _), x in zip(losses0, rels))
          + f"; final trainable parameters rel L2 {rel:.3g} (limit "
          f"{DDP_PARAM_REL_L2}; of the update {upd:.3g}), the ranks' "
          f"bit-equal: {not any('differs' in b for b in bad)}; checkpoints "
          f"{ckpts} and {evals} from rank 0 alone, eval dice "
          f"{avg['dice']:.4f}; launches per rank " + "; ".join(
              f"rank {r['rank']} " + json.dumps(
                  {k: r["counts"][k] for k in FIT_REQUIRED})
              for r in ranks) + f"; launcher wall {wall:.1f} s", flush=True)
    if bad:
        raise SystemExit("ddp (b): " + "; ".join(bad))
    _ddp_timing(f"(b) {DDP_RANKS} ranks sharing the card, gloo",
                ranks[0]["steps"], ranks[0]["waits"], ranks[0]["reduce_ms"],
                B, card)
    for r in ranks[1:]:
        _ddp_timing(f"(b) rank {r['rank']}", r["steps"], r["waits"],
                    r["reduce_ms"], B, card)

    # (c) the GIFs of every run
    size = 2 * int(cfg.image_size)
    gifs = sorted(work.rglob("viz/*.gif"))
    steps = sorted({p.name for p in gifs})
    want_steps = [f"step{s:06d}.gif" for s in range(
        DDP_VIZ_EVERY, DDP_EPOCHS * FIT_TRAIN_BATCHES + 1, DDP_VIZ_EVERY)]
    dirs = sorted({p.parent.parent.relative_to(work).as_posix()
                   for p in gifs})
    if steps != want_steps or len(gifs) != len(want_steps) * (2 + DDP_RANKS):
        raise SystemExit(f"ddp (c): GIFs {steps} in {dirs}")
    for p in gifs:
        w, h, n, delays = gif_blocks(p)
        if (w, h, n) != (size, size, DDP_VIZ_FRAMES) or delays != [50] * n:
            raise SystemExit(f"ddp (c) {p}: {w}x{h}, {n} frames, delays "
                             f"{delays}")
    print(f"ddp (c) visualization: {len(gifs)} GIFs ({', '.join(steps)} in "
          f"each of {len(dirs)} run directories), each {DDP_VIZ_FRAMES} "
          f"frames of {size}x{size} at 50/100 s", flush=True)
    shutil.rmtree(work, ignore_errors=True)


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
    started = last = time.perf_counter()

    def lap(name):
        """The seconds a phase took, and the run's so far."""
        nonlocal last
        now = time.perf_counter()
        print(f"phase {name}: {now - last:.1f} s (run {now - started:.1f} "
              "s)", flush=True)
        last = now

    if "build" in phases:
        from sam2_video_tpu_torch.data import host_build

        t0 = time.perf_counter()
        logs = kernel_build.build(force=True)
        print(f"build: {len(logs)} kernels in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for name in host_build.SOURCES:
            if not host_build.build(name, force=True):
                raise SystemExit(f"build: the host helper {name} did not "
                                 "build with g++")
        print("build: host helpers " + ", ".join(
            str(host_build.lib_path(n).relative_to(host_build.PKG.parent))
            for n in host_build.SOURCES), flush=True)
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        lap("build")

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
        rows += phase_preset_blocks(cfg, args.seed)
        lap("kernels")
    heads_cfg = dataclasses.replace(cfg, memory_attention_num_heads=HEADS)
    launches = {}
    if "presets" in phases:
        launches.update(phase_presets(cfg, args.seed, card))
        lap("presets")
    if "train" in phases:
        launches.update(phase_train(cfg, args.seed)[0])
        heads, _ = phase_train(heads_cfg, args.seed)
        launches.update({k: heads[k] for k in FLASH})
        lap("train")
    if "train_all" in phases:
        trained_all, _ = phase_train_all(cfg, args.seed)
        fused, _ = phase_train_fused(cfg, args.seed)
        launches = {**launches, **{
            k: v for k, v in trained_all.items()
            if k.startswith("fused_block_trainable_bwd")},
            **{k: fused[k] for k in TWOWAY}}
        lap("train_all")
    if "train_remat" in phases:
        phase_train_remat(cfg, args.seed)
        lap("train_remat")
    if "train_cpu" in phases:
        phase_train_cpu(cfg, args.seed)
        lap("train_cpu")
    if "serve" in phases:
        served = phase_serve(params, cfg, args.seed, FRAMES, OBJECTS)
        served_fused = phase_serve_fused(params, cfg, args.seed, CHUNK,
                                         OBJECTS)
        served_heads = phase_serve_heads(params, cfg, args.seed, CHUNK,
                                         OBJECTS)
        launches = {**served, **{k: served_fused[k] for k in TWOWAY},
                    **{k: served_heads[k] for k in FLASH}, **launches}
        lap("serve")
    if "cpu" in phases:
        phase_cpu(params, cfg, args.seed, OBJECTS)
        phase_cpu(params, heads_cfg, args.seed, OBJECTS)
        lap("cpu")
    if "fit" in phases:
        phase_fit(cfg, args.seed, card)
        lap("fit")
    if "frames" in phases:
        phase_frames(cfg, args.seed, card)
        lap("frames")
    if "eval" in phases:
        cpu_run = phase_eval_predictor(params, cfg, args.seed, OBJECTS)
        phase_eval_batched(params, cfg, args.seed, OBJECTS, cpu_run)
        phase_eval_cli(cfg, args.seed, card)
        lap("eval")
    if "ddp" in phases:
        phase_ddp(cfg, args.seed, card)
        lap("ddp")

    # each kernel's launches on its training path (#1-#5: the memory-only
    # step, #6 per geometry class: the all-trainable step, #7 the two-head
    # memory-only step, #8 the fused all-trainable steps; each preset's
    # trunk-pass rows: its memory-only (#1) and all-trainable (#6) steps),
    # else serving's (#7: the two-head pass, #8: the fused pass), else null
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
