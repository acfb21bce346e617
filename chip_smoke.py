#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (sam2_video_tpu_torch) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--phases build,kernels,serve,cpu]

Phases (all by default):
  build    compile both CUDA kernels from csrc/ (one nvcc each, in parallel)
  kernels  each kernel against its plain PyTorch version at the shapes the
           serving path gives it (SAM2-tiny, 384 px, 8-frame encode chunk,
           8 objects), with error, tolerance and CUDA-event times
  serve    the streaming VideoPredictor at full SAM2-tiny width (384 px,
           bf16, 8 objects, 7 memory slots, use_flash_attention=False):
           2 synthetic 480x854 videos, point prompts on frame 0, propagate;
           encode and propagate frames/s; every kernel must have launched
  cpu      the first 4 frames of one video on the card and on the CPU in
           float32 (plain versions); low-res logits must agree

Weights are ``synthetic_params``: the port's seeded random init moved off
its constants (every parameter + 0.05 N(0, 1), the memory encoder's CXBlock
layer scales, 1e-6 at init, drawn O(1), so the kernel check sees both
CXBlocks) and the object-score head's last bias at +10, so every object
reads present and the card-vs-CPU check compares mask logits rather than a
presence threshold. TF32 is off for both matmuls and cuDNN. The last lines
are the card's name and power limit, a JSON line of per-kernel numbers
(``launches`` null when the serve phase did not run), and
{"ok": true, "device": ...}.
The script needs the repository beside it and a CUDA device; without
either it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
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
CPU_REL_L2_TOL = 0.1          # card bf16 vs CPU float32, over 4 frames
PHASES = ("build", "kernels", "serve", "cpu")
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
    k_ms = p_ms = b_ms = 0.0
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
        ok = finite and err <= KERNEL_TOL * scale
        t_k = cuda_ms(lambda: hbk.fused_block(bp, x, spec, trunk_cfg.q_stride,
                                              trunk_cfg.mlp_ratio))
        t_p = cuda_ms(lambda: hbk.fused_block_plain(bp, x, spec,
                                                    trunk_cfg.q_stride))
        fl, nb = block_cost(spec, chunk, H, H, trunk_cfg.mlp_ratio, bp, x, got)
        b, by = bound_ms(fl, nb)
        k_ms, p_ms, b_ms = k_ms + t_k, p_ms + t_p, b_ms + b
        flops_all, bytes_all = flops_all + fl, bytes_all + nb
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale)
        print(f"fused_block[{i:2d}] {TINY_GEOMETRY.get(i, ''):28s} "
              f"x{tuple(x.shape)} max_abs_err={err:.4g} "
              f"tol={KERNEL_TOL * scale:.4g} kernel_ms={t_k:.4f} "
              f"plain_ms={t_p:.4f} bound_ms={b:.4f}({by}) "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"fused_block block {i} disagrees with its "
                             f"plain version: {err} > {KERNEL_TOL * scale}")
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
          f"max_abs_err={worst_abs:.4g} max_err/scale={worst_rel:.4g}",
          flush=True)

    # fused_memory_encoder at O objects, 384 px
    mcfg = cfg.memory_encoder_config
    S, h = cfg.image_size, cfg.feat_size
    pme = params["memory_encoder"]
    logits = 8.0 * torch.randn((objects, S, S, 1), generator=gen)
    masks = (torch.sigmoid(logits) * 20.0 - 10.0).to(dev, torch.bfloat16)
    pix = torch.randn((objects, h, h, 256), generator=gen).to(
        dev, torch.bfloat16)
    pix_proj = nn.conv2d(pme["pix_feat_proj"], pix)
    got = mek.fused_memory_encoder(pme, mcfg, pix_proj, masks)
    want = mek.fused_memory_encoder_plain(pme, mcfg, pix_proj, masks)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    ok = bool(torch.isfinite(got.float()).all()) and err <= KERNEL_TOL * scale
    t_k = cuda_ms(lambda: mek.fused_memory_encoder(pme, mcfg, pix_proj,
                                                   masks))
    t_p = cuda_ms(lambda: mek.fused_memory_encoder_plain(pme, mcfg, pix_proj,
                                                         masks))
    fl, nb = memory_encoder_cost(mcfg, masks, pix_proj, got, pme)
    b, by = bound_ms(fl, nb)
    print(f"fused_memory_encoder O={objects} masks{tuple(masks.shape)} "
          f"max_abs_err={err:.4g} tol={KERNEL_TOL * scale:.4g} "
          f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f} bound_ms={b:.4f}({by}) "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"fused_memory_encoder disagrees with its plain "
                         f"version: {err} > {KERNEL_TOL * scale}")
    rows.append(dict(name="fused_memory_encoder", route="cuda",
                     source="sam2_video_tpu_torch/csrc/memory_encoder.cu",
                     replaces=("sam2_video_tpu/ops/"
                               "memory_encoder_kernel.py:273"),
                     max_abs_err=err, ms=t_k, plain_ms=t_p,
                     bound_ms=b, bound_by=by, library_ms=None))
    return rows


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


def phase_serve(params, cfg, seed: int, frames: int, objects: int):
    from sam2_video_tpu_torch import VideoPredictor
    from sam2_video_tpu_torch.ops import hiera_block_kernel as hbk
    from sam2_video_tpu_torch.ops import memory_encoder_kernel as mek

    pred = VideoPredictor(params, cfg, max_objects=objects, device="cuda")
    videos = [synthetic_video(seed + v, frames, objects=objects)
              for v in range(2)]
    hbk.fused_block.launches = 0
    mek.fused_memory_encoder.launches = 0
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
    launches = {"fused_block": hbk.fused_block.launches,
                "fused_memory_encoder": mek.fused_memory_encoder.launches}
    print("kernels " + json.dumps(launches), flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise SystemExit(f"kernel {name} never launched on the "
                             "serving path")
    return launches


def phase_cpu(params, cfg, seed: int, objects: int):
    """4 frames on the card (bf16, kernels) and on the CPU (float32, plain
    versions, the same weights made again from ``seed``); relative L2 of
    the low-res logits."""
    import dataclasses

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
    print(f"card vs cpu (4 frames, {objects} objects): rel_l2={rel:.4g} "
          f"tol={CPU_REL_L2_TOL} max_abs_err={np.abs(a - b).max():.4g} "
          f"|cpu| max={np.abs(b).max():.4g} sign_agreement={agree:.4f} "
          f"{'OK' if rel <= CPU_REL_L2_TOL else 'FAIL'}", flush=True)
    if not rel <= CPU_REL_L2_TOL:
        raise SystemExit(f"card and CPU disagree: rel_l2 {rel}")


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

    cfg = sam2_mod.SAM2Config(backbone="tiny", image_size=384,
                              compute_dtype="bfloat16", num_maskmem=7,
                              use_flash_attention=False)
    params = synthetic_params(cfg, args.seed).to("cuda")

    rows = []
    if "kernels" in phases:
        with torch.no_grad():
            rows = phase_kernels(sam2_mod.prepare(params, cfg), cfg,
                                 args.seed, CHUNK, OBJECTS)
    launches = {}
    if "serve" in phases:
        launches = phase_serve(params, cfg, args.seed, FRAMES, OBJECTS)
    if "cpu" in phases:
        phase_cpu(params, cfg, args.seed, OBJECTS)

    for r in rows:      # null where this run did not drive the serving path
        r["launches"] = launches.get(r["name"])
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
