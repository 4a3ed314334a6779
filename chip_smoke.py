#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`preworld_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, one status line each; any failure exits non-zero, and there is no
fallback to the CPU or to a kernel's plain version:

  device     a CUDA card is present; its nvidia-smi name and power limit.
  build      nvcc builds the hand-written kernels (preworld_tpu_torch/csrc/)
             for sm_90a into preworld_tpu_torch/build/.
  kernel K*  each kernel against its plain PyTorch version on the card, at
             the flagship shapes (K3 also at 256 channels and on a harsh
             rig, 3 degrees of yaw and 2 m a frame, at 128 and 256; K7 at
             the shapes of the per-stage bench's cost volume, and at 256
             channels; K1 / K2 also, untimed, at Swin-T's block-route
             stages), within the stated tolerance; both timed. K1 / K2,
             K3, K4 and K7 bit-identical over two runs; K1's pad check: a
             case with ln_b at scale 1 that a prologue leaving pad tokens
             at ln_b instead of 0 would fail (the plain version fed that
             decoy must fall outside the tolerance). K3 prints each rig's
             sample footprint (samples in range, corners kept from one
             plane to the next, the corner box of a 64-pixel row tile and
             plane); K4 its kernels alone (profiler) beside the whole
             wrapper (sort included), the longest interval, and its
             interval starts against searchsorted.
  kernel K1/K2 stages  the K1 / K2 chains launch by launch at every Swin-B
             stage (ln_stats, qkv, attention, proj; ln_stats, fc1, fc2;
             device ms from torch.profiler), each GEMM beside its bound
             and one torch.matmul of the same bf16 product (cuBLAS, a
             yardstick the port never calls).
  reference  a small config (flagship widths, 2 Swin blocks per stage,
             128x352 input, 2 cameras, 20x20x8 grid) runs on the card in
             bf16 through the kernels and on the CPU in f32 through the plain
             versions (the path the CPU tests hold against the JAX package);
             the occupancy logits must agree.
  flagship   PreWorld.predict at the flagship configuration (Swin-B, 6 cams
             at 512x1408, 3 frames, D = 88, 200x200x16 grid; backbone, necks
             and encoder in bf16, heads in f32) answers 3 requests; every
             kernel must have run on that path.
  kernel K1b/K2b  the backward kernel chains against their plain backward
             (autograd through the plain forward) at every Swin-B stage
             and at Swin-T's block-route stages (C 384, 768), B = 6, within
             BWD_REL_L2 per gradient, and bit-identical over two runs; both
             timed.
  train-reference  the small config's finetune train step on the card (bf16,
             kernels) against the CPU (f32, plain): same weights, batch and
             drop-path / dropout masks; each loss, the gradient norm and the
             per-tensor gradient cosine within TRAIN_TOL.
  train-flagship  `build_model` from configs/preworld/preworld_7frame_finetune.py
             takes 3 train steps with remat off and 1 with it on: finite
             losses, a nonzero gradient on every parameter the key frame
             reaches, the EMA moved, 24 K1b and 24 K2b launches per step;
             step time, peak memory, the TMA tensor maps encoded per step
             (the flagship phase prints them per request) and a profiler
             breakdown of one more step.
  kernel K5/K6  K5 (packed windows) at Swin-T stages 0-1 and K6 (image
             layout) at every Swin-B stage, W-MSA and SW-MSA, B = 6, against
             their plain versions, bit-identical over two runs; kernel,
             plain and F.scaled_dot_product_attention times (the last a
             yardstick on the same q, k, v and bias + mask, never on the
             port's path), and per stage the unmasked and masked times on
             a line of their own. Then, untimed, the small and ragged cases
             of kernel K5b/K6b below.
  kernel K5b/K6b  their backward kernels at the same shapes: rel-L2 per
             gradient within BWD_REL_L2, bit-identical over two runs; timed
             like the forward (SDPA forward + backward as the yardstick).
             Then untimed cases at windows of 8x8 and 4x4 (N 64 and 16,
             the backward's smaller warp counts) and 199 packed windows
             (a ragged last group of windows), each W-MSA and SW-MSA,
             under the same gates.
  kernel K1b/K2b stages  the backward products' MN-major operands checked
             alone against torch.matmul (`check_gemm_mn_major`: weight
             gradients with and without the LN prologue, one split and
             many, a ragged M; input gradients with W as stored) within
             MN_MAJOR_REL_L2; then the K1b / K2b chains launch by launch at
             every Swin-B stage (device ms from torch.profiler): each of
             the eight products (dWproj, dO, dWqkv, dyln; dW2, dhpre, dW1,
             dn) beside its bound (`bwd_work`) and one torch.matmul of the
             same bf16 product, and the column sums beside theirs.
  swin-routes  Swin-B with `use_block_attn=False` (every stage per block on
             K6, K2 and their backward kernels) forward and backward on 6
             images at 512x1408, against the block route (K1, K2, K1b, K2b)
             with the same weights: outputs and gradients within
             ROUTES_REL_L2, launch counts.
  swint-reference  the reference config at Swin-T widths (K5 at stages
             0-1, the block kernels at stages 2-3, the grid-route cost
             volume), card (bf16) against CPU (f32): logit rel-L2 <= 0.05.
  swint-flagship  the finetune config's model at Swin-T widths (embed 96,
             depths 2/2/6/2, heads 3/6/12/24, window 12): 3 predict requests
             and 3 finetune steps, finite losses, the launch counts of
             SWINT_PER_REQUEST / SWINT_PER_STEP, ms per request and step,
             peak bytes, a profiler breakdown of one more request.
  pretrain-reference  the small config's pretrain train step (render
             losses on 512 rays and the LSS depth loss), card (bf16,
             kernels) against CPU (f32, plain), as train-reference.
  pretrain-flagship  `build_model` from
             configs/preworld/preworld_7frame_pretrain.py with 38400 rays:
             3 train steps with remat off and 1 with it on, the six losses
             finite, a nonzero gradient on every parameter the key frame
             and the render MLPs reach, 24 K1b and 24 K2b launches per step;
             step time, peak memory and a profiler breakdown of one more
             step.
  bench-parts  the `cost_volume` and `nerf` stages of
             `python3 -m preworld_tpu_torch.tools.bench_parts`, in-process:
             the plain grid route against K7 through
             `stereo_cost_volume_fused`, and the render losses of 38400 rays
             on a 200x200x16 field, forward and gradient.

Then one JSON line of per-kernel results (launches: K1-K4 from the flagship
predict run, K1b/K2b from the train-flagship run, K5/K5b from the
swint-flagship request and step, K6/K6b from the swin-routes run, K7 from
the bench-parts run; each
kernel's bound from the bytes and operations of its checked shapes), and
last the device line {"ok": true, "device": {...}}. TF32 is off for both
matmuls and cuDNN convolutions, so every f32 product is full f32.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
import traceback

import torch

KERNELS = {
    # launch-counter key: (label, source, TPU kernel it replaces)
    "fused_swin_attn_block": (
        "K1", "preworld_tpu_torch/csrc/swin_block.cu",
        "preworld_tpu/ops/swin_block_pallas.py:237"),
    "fused_swin_mlp": (
        "K2", "preworld_tpu_torch/csrc/swin_mlp.cu",
        "preworld_tpu/ops/swin_mlp_pallas.py:82"),
    "plane_sweep_cost_hom": (
        "K3", "preworld_tpu_torch/csrc/cost_volume.cu",
        "preworld_tpu/ops/cost_volume_pallas.py:590"),
    "bev_pool_fused": (
        "K4", "preworld_tpu_torch/csrc/bev_pool.cu",
        "preworld_tpu/ops/bev_pool_pallas.py:150"),
    "fused_swin_attn_block_bwd": (
        "K1b", "preworld_tpu_torch/csrc/swin_block_bwd.cu",
        "preworld_tpu/ops/swin_block_pallas.py:428"),
    "fused_swin_mlp_bwd": (
        "K2b", "preworld_tpu_torch/csrc/swin_mlp_bwd.cu",
        "preworld_tpu/ops/swin_mlp_pallas.py:237"),
    "fused_window_attention": (
        "K5", "preworld_tpu_torch/csrc/window_attn.cu",
        "preworld_tpu/ops/window_attn_pallas.py:86"),
    "band_window_attention": (
        "K6", "preworld_tpu_torch/csrc/window_attn.cu",
        "preworld_tpu/ops/window_attn_pallas.py:391"),
    "fused_window_attention_bwd": (
        "K5b", "preworld_tpu_torch/csrc/window_attn_bwd.cu",
        "preworld_tpu/ops/window_attn_pallas.py:234"),
    "band_window_attention_bwd": (
        "K6b", "preworld_tpu_torch/csrc/window_attn_bwd.cu",
        "preworld_tpu/ops/window_attn_pallas.py:538"),
    "plane_sweep_cost": (
        "K7", "preworld_tpu_torch/csrc/cost_volume.cu",
        "preworld_tpu/ops/cost_volume_pallas.py:320"),
}
BWD_KERNELS = ("fused_swin_attn_block_bwd", "fused_swin_mlp_bwd",
               "fused_window_attention_bwd", "band_window_attention_bwd")
# kernel vs plain version, both on the card: pass iff
# |kernel - plain| <= atol + rtol * |plain| everywhere. K1/K2 write bf16
# (1 ulp = 2^-8 relative) after bf16-rounded intermediates (LN output, qkv,
# probabilities, hidden) that can round the other way when the f32 sums
# differ in order; K3 takes the same sample positions and weights in the
# same f32 operations, only the channel sum's order differs (K7 as K3, from
# grid coordinates); K4 sums f32 in
# another order and rounds once to bf16.
# K5/K6 write bf16 averages of v after bf16-rounded probabilities, which
# can round the other way when the f32 score sums differ in order: a few
# ulps (2^-8 relative each) of an output whose typical magnitude here
# (N(0, 1) qkv) is 0.1-1. The largest errors read on the card, 0.0078 (K5)
# and 0.0156 (K6), each lay within 0.01 + 0.02 |plain|.
TOL = {
    "fused_swin_attn_block": (0.05, 0.02),
    "fused_swin_mlp": (0.05, 0.02),
    "plane_sweep_cost_hom": (1e-3, 1e-5),
    "plane_sweep_cost": (1e-3, 1e-5),
    "bev_pool_fused": (1e-3, 1e-2),
    "fused_window_attention": (0.01, 0.02),
    "band_window_attention": (0.01, 0.02),
}
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): device
# memory bytes/s, bf16 tensor-core and f32 (outside the tensor cores) FLOP/s
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# per predict request: 2 temporal frames x 24 Swin blocks, plus the 2
# stage-0 blocks of the stereo-reference frame; one cost volume and one
# voxel pooling per temporal frame
EXPECTED_PER_REQUEST = dict.fromkeys(KERNELS, 0)
EXPECTED_PER_REQUEST.update(fused_swin_attn_block=50, fused_swin_mlp=50,
                            plane_sweep_cost_hom=2, bev_pool_fused=2)
# Swin-B stages at 512x1408, 6 images: (C, heads, Hp, Wp, H, W), ws 12
SWIN_STAGES = [(128, 4, 132, 360, 128, 352), (256, 8, 72, 180, 64, 176),
               (512, 16, 36, 96, 32, 88), (1024, 32, 24, 48, 16, 44)]
REQUESTS = 3
# backward kernel chain vs the plain backward (autograd through the
# bf16-rounding plain forward), both on the card: every gradient within
# this rel-L2 of the plain one. The two round to bf16 at different points
# (the plain autograd rounds every gradient of a bf16 tensor, the kernels
# keep dP, dS and the LN input gradient in f32) and sum in other orders.
BWD_REL_L2 = 0.03
# per finetune train step: the forward launches of a predict request, and
# one backward per Swin-B block of the key frame (the other frames run
# without gradient); remat recomputes the key frame's 24 blocks and its
# view transformer (one more K4)
EXPECTED_PER_STEP = dict(EXPECTED_PER_REQUEST, fused_swin_attn_block_bwd=24,
                         fused_swin_mlp_bwd=24)
EXPECTED_PER_STEP_REMAT = dict(EXPECTED_PER_STEP, fused_swin_attn_block=74,
                               fused_swin_mlp=74, bev_pool_fused=3)
# train-reference, card (bf16) vs CPU (f32), on the reference config with
# the flagship's 6 cameras: relative error of each loss and of the
# pre-clip gradient norm; cosine between the card's and the CPU's whole
# gradient and the median cosine over gradient tensors (those whose CPU
# norm exceeds 1e-4 of the global norm; conv biases in front of a
# BatchNorm have exact gradient 0). The step's gradient at random weights
# is ill-conditioned (train-mode BatchNorm over one row per camera, ReLUs,
# the Lovasz sort): on the CPU alone, an image perturbation of 4e-3
# relative leaves a global cosine of 0.92 and rounding the weights to bf16
# one of 0.86. So the cosines are held against a calibration run, the CPU
# step from the bf16-rounded weights: the card may fall at most
# COS_MARGIN below it.
TRAIN_TOL = {"loss_rel": 0.01, "grad_norm_rel": 0.1}
COS_MARGIN = 0.15
TRAIN_STEPS = 3
# Swin-T widths (Liu et al. 2021) at PreWorld's window 12 and 512x1408:
# stages (C, heads, Hp, Wp) of 6 images; C 96 and 192 run per block on K5,
# 384 and 768 on the block kernels
SWINT = dict(embed_dims=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
             window_size=12)
SWINT_STAGES = [(96, 3, 132, 360), (192, 6, 72, 180)]
# its block-route stages, as SWIN_STAGES: (C, heads, Hp, Wp, H, W)
SWINT_BLOCK_STAGES = [(384, 12, 36, 96, 32, 88), (768, 24, 24, 48, 16, 44)]
# per swint-flagship request: 2 temporal frames x (4 K5 blocks + 8 block-
# route blocks), plus the stereo-reference frame's 2 stage-0 K5 blocks;
# the 96-channel stereo feature takes the grid-route cost volume (no K3)
SWINT_PER_REQUEST = dict.fromkeys(KERNELS, 0)
SWINT_PER_REQUEST.update(fused_window_attention=10, fused_swin_attn_block=16,
                         fused_swin_mlp=16, bev_pool_fused=2)
# per step: the key frame's 4 K5 and 8 block-route blocks backward
SWINT_PER_STEP = dict(SWINT_PER_REQUEST, fused_window_attention_bwd=4,
                      fused_swin_attn_block_bwd=8, fused_swin_mlp_bwd=8)
# swin-routes: Swin-B with the block kernel off, forward + backward
ROUTES_LAUNCHES = dict.fromkeys(KERNELS, 0)
ROUTES_LAUNCHES.update(band_window_attention=24, fused_swin_mlp=24,
                       band_window_attention_bwd=24, fused_swin_mlp_bwd=24)
# the band route rounds to bf16 where torch's ops do (LN output, qkv, the
# proj output before the residual); the block route where K1 / K2 do:
# outputs and the whole gradient within this rel-L2 of each other, and
# every parameter's gradient within ROUTES_TENSOR_REL_L2 (a tensor of a few
# hundred elements, such as a norm bias, reads the same rounding noise
# against a smaller norm)
ROUTES_REL_L2 = 0.03
ROUTES_TENSOR_REL_L2 = 0.1
# parameters the finetune loss never reaches (the render MLPs) or reaches
# with an exactly zero gradient (the occupancy head's soft weights: a
# softmax over one channel is 1)
ZERO_GRAD_PREFIXES = ("density_mlp.", "semantic_mlp.", "color_mlp.",
                      "occupancy_head.soft_w")
# ... and those the pretrain loss never reaches (the occupancy head)
PRETRAIN_ZERO_GRAD_PREFIXES = ("occupancy_head.",)
PRETRAIN_LOSSES = ("loss_render_depth", "loss_render_semantic",
                   "loss_render_color", "loss_sdf_entropy",
                   "loss_sdf_distortion", "loss_lss_depth")
# the per-stage bench's cost volume (tools/bench_parts.py), K7's shapes
BENCH_CV = dict(BN=6, H=128, W=352, C=128, D=88)
# K3's harsh rig: the ego turns this many degrees of yaw and moves this many
# metres along x per temporal frame (the flagship rig: 0 and -0.4)
HARSH_YAW_DEG, HARSH_STEP_M = 3.0, -2.0
# pretrain-reference: the density head's output bias, so that the render
# works at opacities of order 5e-3 (alpha = 1 - exp(-softplus(density +
# shift) / 2) with shift -13.8). At the initial opacity of 1e-6 that
# difference of two numbers near 1 keeps ~10 % in f32, and the card's bf16
# features would move each sample's opacity at random.
PRETRAIN_REF_DENSITY_BIAS = 9.0


def status(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of one call, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    atol, rtol = TOL[name]
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    return {"max_abs_err": float(err.max()),
            "max_rel_err": float((err / want.abs().clamp_min(1e-6)).max()),
            "n_bad": int(bad.sum()), "numel": want.numel()}


def randn(gen, shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def work(bytes_: float, flops: float, peak: float = BF16_FLOPS) -> dict:
    """The bytes a call must move (each input read once, each output
    written once) and the operations it does, at the peak rate of their
    type: what its bound (`bound_ms`) is computed from."""
    return {"bytes": float(bytes_), "flops": float(flops), "peak": peak}


def bound(rows) -> tuple:
    """(bound ms, "bytes" or "operations") of a kernel over its checked
    shapes: each shape's larger time of bytes over the memory rate and
    operations over the peak rate, summed."""
    mem = [r["bytes"] / HBM_BYTES_S * 1e3 for r in rows]
    ops = [r["flops"] / r["peak"] * 1e3 for r in rows]
    total = sum(max(m, o) for m, o in zip(mem, ops))
    return total, "bytes" if sum(mem) >= sum(ops) else "operations"


# ----------------------------------------------------------------- kernels

def swin_input(gen, B, Hp, Wp, C, H, W):
    """x (B, Hp, Wp, C) bf16 with N(0, 1) tokens and pad garbage, random per
    channel so that its LN1 output is large: K1 must zero it after LN1."""
    x = randn(gen, (B, Hp, Wp, C))
    garbage = 37.0 + randn(gen, (B, Hp, Wp, C), 10.0)
    x[:, H:] = garbage[:, H:]
    x[:, :, W:] = garbage[:, :, W:]
    return x.to(torch.bfloat16).contiguous()


def k1_pad_case(gen, k1):
    """K1 at Swin-B stage 3, SW-MSA, with ln_b drawn at scale 1: the pad
    check. A prologue that left pad tokens at ln_b (LN with rstd 0) rather
    than 0 would move the real tokens' outputs through the pad keys and
    values. The plain version fed that decoy (pad rows of x set to 0, whose
    LN output is ln_b, and no pad mask) must fall outside K1's tolerance
    on the real tokens (`pad_decoy_n_bad` > 0), so the case can tell."""
    from preworld_tpu_torch.models.swin import shifted_window_region_ids

    bf = torch.bfloat16
    ws, B = 12, 6
    C, heads, Hp, Wp, H, W = SWIN_STAGES[3]
    shift = ws // 2
    x = swin_input(gen, B, Hp, Wp, C, H, W)
    ln_w, ln_b = 1 + randn(gen, (C,), 0.1), randn(gen, (C,), 1.0)
    region = torch.from_numpy(shifted_window_region_ids(
        Hp, Wp, ws, shift).astype("int32")).cuda()
    args = (x, ln_w, ln_b, randn(gen, (3 * C, C), C ** -0.5, bf),
            randn(gen, (3 * C,), 0.1), randn(gen, (C, C), C ** -0.5, bf),
            randn(gen, (C,), 0.1), window_bias(gen, ws, heads), region, None,
            heads, ws, H, W, shift)
    got = k1.fused_swin_attn_block(*args)
    want = k1.fused_swin_attn_block_plain(*args)
    r = compare("fused_swin_attn_block", got, want)
    r["bit_identical"] = torch.equal(got, k1.fused_swin_attn_block(*args))
    decoy_x = torch.zeros_like(x)
    decoy_x[:, :H, :W] = x[:, :H, :W]
    decoy = k1.fused_swin_attn_block_plain(
        decoy_x, *args[1:12], Hp, Wp, shift)
    r["pad_decoy_n_bad"] = compare("fused_swin_attn_block",
                                   decoy[:, :H, :W], want[:, :H, :W])["n_bad"]
    r["shape"] = f"B{B} {Hp}x{Wp}x{C} h{heads} shift{shift} ln_b scale 1"
    r["extra"] = True
    return r


def check_swin(gen):
    """K1 and K2 at one W-MSA and one SW-MSA block (K1) and one block (K2)
    of every Swin-B stage, timed, each run twice for bit-identity; then the
    same at Swin-T's block-route stages and K1's pad check (`k1_pad_case`)
    (rows marked `extra`: checked, untimed, left out of the per-kernel
    sums)."""
    from preworld_tpu_torch.models.swin import shifted_window_region_ids
    from preworld_tpu_torch.ops import swin_block_pallas as k1
    from preworld_tpu_torch.ops import swin_mlp_pallas as k2

    bf = torch.bfloat16
    ws, B = 12, 6
    N = ws * ws
    rows = {"fused_swin_attn_block": [], "fused_swin_mlp": []}
    stages = [s + (False,) for s in SWIN_STAGES]
    stages += [s + (True,) for s in SWINT_BLOCK_STAGES]
    for C, heads, Hp, Wp, H, W, extra in stages:
        x = swin_input(gen, B, Hp, Wp, C, H, W)
        ln_w, ln_b = 1 + randn(gen, (C,), 0.1), randn(gen, (C,), 0.1)
        wqkv = randn(gen, (3 * C, C), C ** -0.5, bf)
        bqkv = randn(gen, (3 * C,), 0.1)
        wproj = randn(gen, (C, C), C ** -0.5, bf)
        bproj = randn(gen, (C,), 0.1)
        rel_bias = window_bias(gen, ws, heads)
        for shift in (0, ws // 2):
            region = None
            if shift:
                region = torch.from_numpy(shifted_window_region_ids(
                    Hp, Wp, ws, shift).astype("int32")).cuda()
            args = (x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, rel_bias,
                    region, None, heads, ws, H, W, shift)
            got = k1.fused_swin_attn_block(*args)
            r = compare("fused_swin_attn_block", got,
                        k1.fused_swin_attn_block_plain(*args))
            r["bit_identical"] = torch.equal(
                got, k1.fused_swin_attn_block(*args))
            if not extra:
                r["ms"] = cuda_ms(lambda: k1.fused_swin_attn_block(*args))
                r["plain_ms"] = cuda_ms(
                    lambda: k1.fused_swin_attn_block_plain(*args))
            r["shape"] = f"B{B} {Hp}x{Wp}x{C} h{heads} shift{shift}"
            r["extra"] = extra
            M = B * Hp * Wp
            r.update(work(4 * M * C + 8 * C * C + heads * N * N * 4,
                          8 * M * C * C + 4 * M * N * C))
            rows["fused_swin_attn_block"].append(r)
        w1 = randn(gen, (4 * C, C), C ** -0.5, bf)
        b1 = randn(gen, (4 * C,), 0.1)
        w2 = randn(gen, (C, 4 * C), (4 * C) ** -0.5, bf)
        b2 = randn(gen, (C,), 0.1)
        args = (x, ln_w, ln_b, w1, b1, w2, b2)
        got = k2.fused_swin_mlp(*args)
        r = compare("fused_swin_mlp", got, k2.fused_swin_mlp_plain(*args))
        r["bit_identical"] = torch.equal(got, k2.fused_swin_mlp(*args))
        if not extra:
            r["ms"] = cuda_ms(lambda: k2.fused_swin_mlp(*args))
            r["plain_ms"] = cuda_ms(lambda: k2.fused_swin_mlp_plain(*args))
        r["shape"] = f"M{B * Hp * Wp} C{C} hidden{4 * C}"
        r["extra"] = extra
        r.update(work(4 * B * Hp * Wp * C + 16 * C * C,
                      16 * B * Hp * Wp * C * C))
        rows["fused_swin_mlp"].append(r)
    rows["fused_swin_attn_block"].append(k1_pad_case(gen, k1))
    return rows


def chain_ms(fn, labels, reps=3, tries=3) -> dict:
    """Device ms of each launch of a kernel chain, median over `reps` whole
    chains profiled after a warm-up call. `labels` pairs each launch's
    label with a piece of its kernel's name, in chain order, the first
    unlike the rest. The profiler can drop records (seen: the first and
    last launches of three profiled calls), so it profiles `reps` + 2
    calls, reads only runs of records that match the whole chain, and
    tries again, `tries` times in all, if fewer than `reps` remain."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = len(labels)
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps + 2):
                fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and any(k in e.name for _, k in labels)),
                    key=lambda e: e.time_range.start)
        chains, i = [], 0
        while i + n <= len(ev):
            if all(k in e.name for (_, k), e in zip(labels, ev[i:i + n])):
                chains.append(ev[i:i + n])
                i += n
            else:
                i += 1
        if len(chains) >= reps:
            return {lab: statistics.median(c[k].time_range.elapsed_us()
                                           for c in chains[:reps]) / 1e3
                    for k, (lab, _) in enumerate(labels)}
    raise AssertionError(f"chain of {labels}: {len(chains)} whole chains in "
                         f"{[e.name[:60] for e in ev]}")


def gemm_work(k: str, M: int, C: int) -> dict:
    """Bytes (A, W, the output and the residual, each once) and operations
    of one of the K1 / K2 products at M rows and width C."""
    n, kd, resid = {"qkv": (3 * C, C, 0), "proj": (C, C, 1),
                    "fc1": (4 * C, C, 0), "fc2": (C, 4 * C, 1)}[k]
    return work(2 * (M * kd + n * kd + M * n + resid * M * n), 2 * M * n * kd)


def check_swin_stages(gen):
    """The K1 / K2 kernel chains stage by stage at every Swin-B stage (B =
    6): device ms of the LN statistics (LN1, LN2), the qkv GEMM (LN1
    prologue, bias epilogue), the window attention (W-MSA and SW-MSA), the
    proj GEMM (bias, row scale, residual), fc1 (LN2, bias, GELU) and fc2
    (bias, residual), each GEMM beside its bound (`gemm_work`) and one
    torch.matmul (cuBLAS) of the same bf16 product without the fused
    prologue or epilogue: a yardstick the port never calls."""
    from preworld_tpu_torch.models.swin import shifted_window_region_ids
    from preworld_tpu_torch.ops import swin_block_pallas as k1
    from preworld_tpu_torch.ops import swin_mlp_pallas as k2

    bf = torch.bfloat16
    ws, B = 12, 6
    out = []
    for C, heads, Hp, Wp, H, W in SWIN_STAGES:
        M = B * Hp * Wp
        x = randn(gen, (B, Hp, Wp, C), 1.0, bf)
        ln_w, ln_b = 1 + randn(gen, (C,), 0.1), randn(gen, (C,), 0.1)
        w = {"qkv": randn(gen, (3 * C, C), C ** -0.5, bf),
             "proj": randn(gen, (C, C), C ** -0.5, bf),
             "fc1": randn(gen, (4 * C, C), C ** -0.5, bf),
             "fc2": randn(gen, (C, 4 * C), (4 * C) ** -0.5, bf)}
        bias = {k: randn(gen, (v.shape[0],), 0.1) for k, v in w.items()}
        rel_bias = window_bias(gen, ws, heads)
        region = torch.from_numpy(shifted_window_region_ids(
            Hp, Wp, ws, ws // 2).astype("int32")).cuda()
        row = {"stage": f"C{C} h{heads} M{M}"}
        for shift, reg in ((0, None), (ws // 2, region)):
            args = (x, ln_w, ln_b, w["qkv"], bias["qkv"], w["proj"],
                    bias["proj"], rel_bias, reg, None, heads, ws, H, W, shift)
            t = chain_ms(lambda: k1.fused_swin_attn_block(*args),
                         (("ln1", "ln_stats_kernel"),
                          ("qkv", "gemm_sm90_kernel"),
                          ("attention", "window_attn_kernel"),
                          ("proj", "gemm_sm90_kernel")))
            row[f"attention_shift{shift}_ms"] = t.pop("attention")
            for k, v in t.items():  # the rest do the same work at both
                row.setdefault(f"{k}_ms", []).append(v)
        row.update({f"{k}_ms": v for k, v in chain_ms(
            lambda: k2.fused_swin_mlp(x, ln_w, ln_b, w["fc1"], bias["fc1"],
                                      w["fc2"], bias["fc2"]),
            (("ln2", "ln_stats_kernel"), ("fc1", "gemm_sm90_kernel"),
             ("fc2", "gemm_sm90_kernel"))).items()})
        for k in ("ln1", "qkv", "proj"):
            row[f"{k}_ms"] = statistics.mean(row[f"{k}_ms"])
        xm = x.reshape(M, C)
        hid = randn(gen, (M, 4 * C), 1.0, bf)
        for k, a in (("qkv", xm), ("proj", xm), ("fc1", xm), ("fc2", hid)):
            row[f"{k}_cublas_ms"] = cuda_ms(lambda: torch.matmul(a, w[k].t()))
            row[f"{k}_bound_ms"] = bound([gemm_work(k, M, C)])[0]
        out.append(row)
        del x, hid, xm
    return out


def grad_stats(got, want) -> dict:
    """max abs error and rel-L2 of one gradient against its plain version."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} vs {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite kernel gradient")
    err = got - want
    return {"max_abs_err": float(err.abs().max()),
            "rel_l2": float(err.norm() / want.norm().clamp_min(1e-30))}


def check_backward(name, names, bwd, plain, args, timed=True) -> dict:
    """One backward kernel chain against its plain version on the same
    inputs: per-gradient errors, bit-identity of two kernel runs, times
    (unless `timed` is false)."""
    got = bwd(*args)
    again = bwd(*args)
    want = plain(*args)
    grads = {n: grad_stats(g, w) for n, g, w in zip(names, got, want)}
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    worst = max(g["rel_l2"] for g in grads.values())
    r = {"grads": grads, "bit_identical": same, "rel_l2": worst,
         "max_abs_err": max(g["max_abs_err"] for g in grads.values()),
         "ok": same and worst <= BWD_REL_L2}
    if timed:
        r["ms"] = cuda_ms(lambda: bwd(*args))
        r["plain_ms"] = cuda_ms(lambda: plain(*args))
    return r


def check_swin_bwd(gen):
    """K1b and K2b at one W-MSA and one SW-MSA block (K1b) and one block
    (K2b) of every Swin-B stage, B = 6, cotangent N(0, 1), row scale with
    one zero and one 1/0.9; then the same at Swin-T's block-route stages
    (rows marked `extra`: checked, left out of the per-kernel sums)."""
    from preworld_tpu_torch.models.swin import shifted_window_region_ids
    from preworld_tpu_torch.ops import swin_block_pallas as k1
    from preworld_tpu_torch.ops import swin_mlp_pallas as k2

    bf = torch.bfloat16
    ws, B = 12, 6
    N = ws * ws
    rs = torch.ones(B, device="cuda")
    rs[0], rs[1] = 0.0, 1.0 / 0.9
    rows = {"fused_swin_attn_block_bwd": [], "fused_swin_mlp_bwd": []}
    stages = [s + (False,) for s in SWIN_STAGES]
    stages += [s + (True,) for s in SWINT_BLOCK_STAGES]
    for C, heads, Hp, Wp, H, W, extra in stages:
        x = randn(gen, (B, Hp, Wp, C))
        garbage = 37.0 + randn(gen, (B, Hp, Wp, C), 10.0)
        x[:, H:] = garbage[:, H:]
        x[:, :, W:] = garbage[:, :, W:]
        x = x.to(bf).contiguous()
        dy = randn(gen, (B, Hp, Wp, C), 1.0, bf)
        ln_w, ln_b = 1 + randn(gen, (C,), 0.1), randn(gen, (C,), 0.1)
        wqkv = randn(gen, (3 * C, C), C ** -0.5, bf)
        bqkv = randn(gen, (3 * C,), 0.1)
        wproj = randn(gen, (C, C), C ** -0.5, bf)
        bproj = randn(gen, (C,), 0.1)
        rel_bias = window_bias(gen, ws, heads)
        for shift in (0, ws // 2):
            region = None
            if shift:
                region = torch.from_numpy(shifted_window_region_ids(
                    Hp, Wp, ws, shift).astype("int32")).cuda()
            args = (x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, rel_bias,
                    region, rs, dy, heads, ws, H, W, shift)
            r = check_backward(
                "fused_swin_attn_block_bwd",
                ("x", "ln_w", "ln_b", "wqkv", "bqkv", "wproj", "bproj",
                 "rel_bias"),
                k1.fused_swin_attn_block_bwd,
                k1.fused_swin_attn_block_bwd_plain, args)
            r["shape"] = f"B{B} {Hp}x{Wp}x{C} h{heads} shift{shift}"
            # recompute qkv (6MC^2) and S, O (4MNC); dWproj, dO (4MC^2),
            # dV, dP, dQ, dK (8MNC), dWqkv, dLN (12MC^2)
            M = B * Hp * Wp
            r.update(work(6 * M * C + 8 * C * C + 16 * C * C
                          + 2 * heads * N * N * 4,
                          22 * M * C * C + 12 * M * N * C), extra=extra)
            rows["fused_swin_attn_block_bwd"].append(r)
        w1 = randn(gen, (4 * C, C), C ** -0.5, bf)
        b1 = randn(gen, (4 * C,), 0.1)
        w2 = randn(gen, (C, 4 * C), (4 * C) ** -0.5, bf)
        b2 = randn(gen, (C,), 0.1)
        rs_rows = rs.repeat_interleave(Hp * Wp)
        args = (x, ln_w, ln_b, w1, b1, w2, b2, rs_rows, dy)
        r = check_backward(
            "fused_swin_mlp_bwd", ("x", "ln_w", "ln_b", "w1", "b1", "w2", "b2"),
            k2.fused_swin_mlp_bwd, k2.fused_swin_mlp_bwd_plain, args)
        r["shape"] = f"M{B * Hp * Wp} C{C} hidden{4 * C}"
        # recompute fc1; dW2, dh, dW1, dx: five products of 8MC^2
        M = B * Hp * Wp
        r.update(work(6 * M * C + 16 * C * C + 32 * C * C, 40 * M * C * C),
                 extra=extra)
        rows["fused_swin_mlp_bwd"].append(r)
    return rows


# the backward products' MN-major operands checked alone, weight gradient
# A^T B and input gradient A W against torch.matmul in f32 (TF32 off) on
# the same bf16 inputs: the sums differ only in order (rel-L2 ~1e-5 at M
# 285,120), while a wrong layout of an operand gives rel-L2 ~1.4
MN_MAJOR_REL_L2 = 1e-3


def check_gemm_mn_major(gen) -> list:
    """The Hopper GEMM's backward products alone (`pw_gemm_dw`,
    `pw_gemm_dx`) against torch.matmul: weight gradients with both
    operands MN-major (M ragged short of a 64-row box, one split and many;
    with the LN prologue, every seventh row a pad row of rstd 0), input
    gradients with W as stored (an MN-major B)."""
    from preworld_tpu_torch.ops import _cuda

    lib = _cuda.lib()
    bf, f = torch.bfloat16, torch.float32
    dev = torch.device("cuda")
    stream = _cuda.stream_ptr(dev)
    rows = []
    for M, N, K, ln in ((35, 256, 1024, False), (300, 384, 128, True),
                        (20736, 512, 2048, False), (285120, 128, 128, False),
                        (77760, 1024, 256, True), (6912, 3072, 1024, True)):
        a, b = randn(gen, (M, N), 1.0, bf), randn(gen, (M, K), 1.0, bf)
        part = torch.empty((max(1, lib.pw_gemm_dw_part_elems(M, N, K, ln)),),
                           dtype=f, device=dev)
        got = torch.empty((N, K), dtype=f, device=dev)
        ptrs = (None, None, None)
        y = b
        if ln:
            xf = b.float()
            mu = xf.mean(-1)
            rstd = torch.rsqrt(((xf - mu[:, None]) ** 2).mean(-1) + 1e-5)
            rstd[::7] = 0.0
            stats = torch.stack([mu, rstd], -1).contiguous()
            lw, lb = 1 + randn(gen, (K,), 0.1), randn(gen, (K,), 0.1)
            y = ((xf - mu[:, None]) * rstd[:, None] * lw + lb).to(bf)
            y[rstd == 0] = 0
            ptrs = (stats.data_ptr(), lw.data_ptr(), lb.data_ptr())
        _cuda.check(lib.pw_gemm_dw(a.data_ptr(), b.data_ptr(), got.data_ptr(),
                                   part.data_ptr(), *ptrs, M, N, K, stream),
                    "pw_gemm_dw")
        want = torch.matmul(a.float().t(), y.float())
        rows.append({"product": f"dW M{M} N{N} K{K}" + (" LN" if ln else ""),
                     "splits": lib.pw_dw_splits(M, N, K, ln),
                     "rel_l2": float((got - want).norm() / want.norm())})
    for M, N, K in ((35, 256, 1024), (300, 128, 384), (20736, 512, 2048),
                    (6912, 1024, 4096)):
        a, w = randn(gen, (M, K), 1.0, bf), randn(gen, (K, N), 1.0, bf)
        got = torch.empty((M, N), dtype=f, device=dev)
        _cuda.check(lib.pw_gemm_dx(a.data_ptr(), w.data_ptr(), got.data_ptr(),
                                   M, N, K, stream), "pw_gemm_dx")
        want = torch.matmul(a.float(), w.float())
        rows.append({"product": f"dX M{M} N{N} K{K}",
                     "rel_l2": float((got - want).norm() / want.norm())})
    torch.cuda.synchronize()
    bad = [r for r in rows if not r["rel_l2"] <= MN_MAJOR_REL_L2]
    if bad:
        raise AssertionError(f"MN-major products off: {bad}")
    return rows


def bwd_work(k: str, M: int, C: int) -> dict:
    """Bytes (operands and LN statistics once, f32 outputs at 4 bytes,
    dhpre's f32 pre-activation read) and operations of one of the K1b /
    K2b backward products at M rows and width C (hidden 4C)."""
    H = 4 * C
    b, f = {
        "dwproj": (4 * M * C + 4 * C * C, 2 * M * C * C),
        "do": (4 * M * C + 2 * C * C, 2 * M * C * C),
        "dwqkv": (8 * M * C + 8 * M + 12 * C * C, 6 * M * C * C),
        "dyln": (10 * M * C + 6 * C * C, 6 * M * C * C),
        "dw2": (2 * M * C + 2 * M * H + 4 * C * H, 2 * M * C * H),
        "dhpre": (2 * M * C + 2 * C * H + 6 * M * H + 4 * H, 2 * M * C * H),
        "dw1": (2 * M * H + 2 * M * C + 8 * M + 4 * H * C, 2 * M * C * H),
        "dn": (2 * M * H + 2 * H * C + 4 * M * C, 2 * M * C * H),
    }[k]
    return work(b, f)


BWD_PRODUCTS = ("dwproj", "do", "dwqkv", "dyln", "dw2", "dhpre", "dw1", "dn")


def check_swin_bwd_stages(gen):
    """The K1b / K2b kernel chains launch by launch at every Swin-B stage (B
    = 6; K1b at W-MSA and SW-MSA, the products and sums averaged over the
    two): device ms of each of the eight backward products (a weight
    gradient with its split reduction), beside its bound (`bwd_work`) and
    one torch.matmul of the same bf16 product without prologue or
    epilogue, a yardstick the port never calls; the column sums (dbproj
    and db2 in the pass that writes bf16(rs dY), dbqkv, db1's reduction)
    beside their bound; and the chains' other launches."""
    from preworld_tpu_torch.models.swin import shifted_window_region_ids
    from preworld_tpu_torch.ops import _cuda
    from preworld_tpu_torch.ops import swin_block_pallas as k1
    from preworld_tpu_torch.ops import swin_mlp_pallas as k2

    lib = _cuda.lib()
    bf = torch.bfloat16
    ws, B = 12, 6
    rs = torch.ones(B, device="cuda")
    rs[0], rs[1] = 0.0, 1.0 / 0.9
    out = []
    for C, heads, Hp, Wp, H, W in SWIN_STAGES:
        M, Hd = B * Hp * Wp, 4 * C
        x = randn(gen, (B, Hp, Wp, C), 1.0, bf)
        dy = randn(gen, (B, Hp, Wp, C), 1.0, bf)
        ln_w, ln_b = 1 + randn(gen, (C,), 0.1), randn(gen, (C,), 0.1)
        w = {"qkv": randn(gen, (3 * C, C), C ** -0.5, bf),
             "proj": randn(gen, (C, C), C ** -0.5, bf),
             "fc1": randn(gen, (Hd, C), C ** -0.5, bf),
             "fc2": randn(gen, (C, Hd), Hd ** -0.5, bf)}
        bias = {k: randn(gen, (v.shape[0],), 0.1) for k, v in w.items()}
        rel_bias = window_bias(gen, ws, heads)
        region = torch.from_numpy(shifted_window_region_ids(
            Hp, Wp, ws, ws // 2).astype("int32")).cuda()

        def dw(lab, n, k, ln):
            red = [(f"{lab}_reduce", "reduce_splits_kernel")]
            return [(lab, "gemm_dw_sm90_kernel")] + (
                red if lib.pw_dw_splits(M, n, k, ln) > 1 else [])

        k1_labels = ([("ln1", "ln_stats_kernel"), ("qkv", "gemm_sm90_kernel"),
                      ("attention", "window_attn_kernel"),
                      ("dy_colsum", "colsum_rows_kernel"),
                      ("dbproj_reduce", "reduce_splits_kernel")]
                     + dw("dwproj", C, C, False)
                     + [("do", "gemm_sm90_kernel"),
                        ("attention_bwd", "window_attn_bwd_kernel"),
                        ("drel_reduce", "reduce_parts_kernel"),
                        ("dqkv_colsum", "colsum_rows_kernel"),
                        ("dbqkv_reduce", "reduce_splits_kernel")]
                     + dw("dwqkv", 3 * C, C, True)
                     + [("dyln", "gemm_sm90_kernel"),
                        ("ln_bwd", "ln_bwd_kernel"),
                        ("dln_reduce", "reduce_parts_kernel")])
        k2_labels = ([("ln2", "ln_stats_kernel"), ("fc1", "gemm_sm90_kernel"),
                      ("dy_colsum", "colsum_rows_kernel"),
                      ("db2_reduce", "reduce_splits_kernel")]
                     + dw("dw2", C, Hd, False)
                     + [("dhpre", "gemm_sm90_kernel"),
                        ("db1_reduce", "reduce_splits_kernel")]
                     + dw("dw1", Hd, C, True)
                     + [("dn", "gemm_sm90_kernel"), ("ln_bwd", "ln_bwd_kernel"),
                        ("dln_reduce", "reduce_parts_kernel")])
        k1_runs = []
        for shift, reg in ((0, None), (ws // 2, region)):
            args = (x, ln_w, ln_b, w["qkv"], bias["qkv"], w["proj"],
                    bias["proj"], rel_bias, reg, rs, dy, heads, ws, H, W, shift)
            k1_runs.append(chain_ms(
                lambda: k1.fused_swin_attn_block_bwd(*args), k1_labels))
        t1 = {k: statistics.mean(r[k] for r in k1_runs) for k in k1_runs[0]}
        rs_rows = rs.repeat_interleave(Hp * Wp)
        t2 = chain_ms(lambda: k2.fused_swin_mlp_bwd(
            x, ln_w, ln_b, w["fc1"], bias["fc1"], w["fc2"], bias["fc2"],
            rs_rows, dy), k2_labels)
        t = {f"k1b_{k}": v for k, v in t1.items()}
        t.update({f"k2b_{k}": v for k, v in t2.items()})
        row = {"stage": f"C{C} h{heads} M{M}", "M": M, "C": C,
               "k1b_sum_ms": sum(t1.values()), "k2b_sum_ms": sum(t2.values()),
               "k1b_attention_ms": [r["attention"] for r in k1_runs],
               "k1b_attention_bwd_ms": [r["attention_bwd"] for r in k1_runs],
               "launches": t}
        for k in BWD_PRODUCTS:
            pre = "k1b_" if k in ("dwproj", "do", "dwqkv", "dyln") else "k2b_"
            row[f"{k}_ms"] = t[pre + k] + t.get(f"{pre}{k}_reduce", 0.0)
            row[f"{k}_bound_ms"] = bound([bwd_work(k, M, C)])[0]
        row["colsum_ms"] = (t["k1b_dy_colsum"] + t["k1b_dbproj_reduce"]
                            + t["k1b_dqkv_colsum"] + t["k1b_dbqkv_reduce"]
                            + t["k2b_dy_colsum"] + t["k2b_db2_reduce"]
                            + t["k2b_db1_reduce"])
        # dY read twice and dqkv once (the sums), dyb written twice (the
        # same passes write bf16(rs dY))
        row["colsum_bound_ms"] = bound([work(2 * (2 * M * C) + 6 * M * C
                                             + 2 * (2 * M * C), 0)])[0]
        row["colsum_read_bound_ms"] = bound([work(4 * M * C + 6 * M * C, 0)])[0]
        xm, dym = x.reshape(M, C), dy.reshape(M, C)
        dqkv = randn(gen, (M, 3 * C), 1.0, bf)
        hid = randn(gen, (M, Hd), 1.0, bf)
        yard = {"dwproj": lambda: torch.matmul(dym.t(), xm),
                "do": lambda: torch.matmul(dym, w["proj"]),
                "dwqkv": lambda: torch.matmul(dqkv.t(), xm),
                "dyln": lambda: torch.matmul(dqkv, w["qkv"]),
                "dw2": lambda: torch.matmul(dym.t(), hid),
                "dhpre": lambda: torch.matmul(dym, w["fc2"]),
                "dw1": lambda: torch.matmul(hid.t(), xm),
                "dn": lambda: torch.matmul(hid, w["fc1"])}
        for k, fn in yard.items():
            row[f"{k}_matmul_ms"] = cuda_ms(fn)
        out.append(row)
        del x, dy, dqkv, hid, xm, dym
        torch.cuda.empty_cache()
    return out


def window_attn_cases(gen):
    """K5 / K6 inputs at their main-path shapes, B = 6: K5 on the packed
    windows of Swin-T stages 0-1, K6 on the image layout of every Swin-B
    stage; W-MSA and SW-MSA each. Yields (launch-counter key, qkv, bias,
    mask, heads, ws, shape label)."""
    from preworld_tpu_torch.models.swin import (
        shifted_window_mask,
        window_partition,
    )

    bf = torch.bfloat16
    ws, B = 12, 6
    cases = [("fused_window_attention", C, h, Hp, Wp)
             for C, h, Hp, Wp in SWINT_STAGES]
    cases += [("band_window_attention", C, h, Hp, Wp)
              for C, h, Hp, Wp, _, _ in SWIN_STAGES]
    for name, C, heads, Hp, Wp in cases:
        bias = window_bias(gen, ws, heads)
        qkv = randn(gen, (B, Hp, Wp, 3 * C), 1.0, bf)
        if name == "fused_window_attention":
            qkv = window_partition(qkv, ws).contiguous()
        for shift in (0, ws // 2):
            mask = (shifted_window_mask(Hp, Wp, ws, shift, "cuda")
                    if shift else None)
            yield (name, qkv, bias, mask, heads, ws,
                   f"qkv {tuple(qkv.shape)} h{heads} shift{shift}")


def window_bias(gen, ws, heads):
    """A relative-position bias (heads, N, N) gathered from a random table
    through the Swin index, as the model builds it."""
    from preworld_tpu_torch.models.swin import relative_position_index

    N = ws * ws
    rel_idx = torch.from_numpy(relative_position_index(ws).reshape(-1)).cuda()
    table = randn(gen, ((2 * ws - 1) ** 2, heads), 0.5)
    return table[rel_idx].reshape(N, N, heads).permute(2, 0, 1).contiguous()


def window_attn_small_cases(gen):
    """Untimed K5 / K6 and K5b / K6b cases beside the flagship shapes,
    W-MSA and SW-MSA each: windows of 8x8 and 4x4 (N 64 and 16: four warps
    and one per block) on a 32x48 / 16x24 image of 2 heads, and 199 packed
    windows of N 144 and 4 heads, whose last group of windows is ragged
    (the forward and backward cores share their plan of windows per
    block)."""
    from preworld_tpu_torch.models.swin import (
        shifted_window_mask,
        window_partition,
    )
    from preworld_tpu_torch.ops import _cuda

    bf = torch.bfloat16
    for name, C, heads, ws, Hp, Wp in (
            ("fused_window_attention", 64, 2, 8, 32, 48),
            ("band_window_attention", 64, 2, 8, 32, 48),
            ("fused_window_attention", 64, 2, 4, 16, 24),
            ("band_window_attention", 64, 2, 4, 16, 24),
            ("fused_window_attention", 128, 4, 12, 48, 48)):
        N = ws * ws
        bias = window_bias(gen, ws, heads)
        if ws == 12:
            # the core gives each of `groups` blocks per head
            # ceil(199 / groups) windows: the last group is short unless
            # groups divides 199
            groups = (_cuda.lib().pw_window_attn_bwd_part_elems(199, heads, N)
                      // (heads * N * N))
            if 199 % groups == 0:
                raise AssertionError(f"199 windows in {groups} equal groups")
            qkv = randn(gen, (199, N, 3 * C), 1.0, bf)
        else:
            qkv = randn(gen, (1, Hp, Wp, 3 * C), 1.0, bf)
            if name == "fused_window_attention":
                qkv = window_partition(qkv, ws).contiguous()
        for shift in (0, ws // 2):
            mask = (shifted_window_mask(Hp, Wp, ws, shift, "cuda")
                    if shift else None)
            yield (name, qkv, bias, mask, heads, ws,
                   f"qkv {tuple(qkv.shape)} h{heads} shift{shift}")


def _sdpa_inputs(qkv, bias, mask, heads, ws):
    """q, k, v (Bw, heads, N, 32) and the additive bias + mask (Bw, heads,
    N, N) in bf16, for the library yardstick."""
    from preworld_tpu_torch.models.swin import window_partition

    wins = window_partition(qkv, ws) if qkv.dim() == 4 else qkv
    Bw, N, C3 = wins.shape
    q, k, v = (t.contiguous() for t in
               wins.reshape(Bw, N, 3, heads, C3 // 3 // heads)
               .permute(2, 0, 3, 1, 4))
    m = bias.float()[None].expand(Bw, -1, -1, -1)
    if mask is not None:
        m = m + mask[torch.arange(Bw, device=qkv.device) % mask.shape[0]][:, None]
    return q, k, v, m.to(qkv.dtype).contiguous()


def _attn_work(qkv, heads, mask, ws, backward):
    """Bytes and bf16 tensor-core operations of one K5 / K6 call (forward:
    qkv in, o out, 4 M N C; backward: qkv and dO in, dqkv out, S, dV, dP,
    dQ, dK at 10 M N C), M tokens of C channels in windows of N."""
    N = ws * ws
    C = qkv.shape[-1] // 3
    M = qkv.numel() // (3 * C)
    small = heads * N * N * 4 + (0 if mask is None else mask.numel() * 4)
    if backward:
        return work(2 * (3 * M * C + M * C + 3 * M * C) + small
                    + heads * N * N * 4, 10 * M * N * C)
    return work(2 * (3 * M * C + M * C) + small, 4 * M * N * C)


def check_window_attn(gen):
    """K5 and K6 against their plain versions, two runs bit-identical,
    with the SDPA yardstick; then the untimed small and ragged cases."""
    import torch.nn.functional as F

    from preworld_tpu_torch.ops import window_attn_pallas as wa

    fns = {"fused_window_attention": (
               lambda q, b, m, h, ws: wa.fused_window_attention(q, b, m, h),
               lambda q, b, m, h, ws: wa.fused_window_attention_plain(
                   q, b, m, h)),
           "band_window_attention": (wa.band_window_attention,
                                     wa.band_window_attention_plain)}
    rows = {k: [] for k in fns}

    def checked(name, args):
        kern, plain = fns[name]
        got = kern(*args)
        r = compare(name, got, plain(*args))
        r["bit_identical"] = torch.equal(got, kern(*args))
        return r

    for name, qkv, bias, mask, heads, ws, shape in window_attn_small_cases(
            gen):
        r = checked(name, (qkv, bias, mask, heads, ws))
        r.update(shape=shape, extra=True)
        rows[name].append(r)
    for name, qkv, bias, mask, heads, ws, shape in window_attn_cases(gen):
        kern, plain = fns[name]
        args = (qkv, bias, mask, heads, ws)
        r = checked(name, args)
        r["stage"] = f"C{qkv.shape[-1] // 3} h{heads}"
        r["masked"] = mask is not None
        r["ms"] = cuda_ms(lambda: kern(*args))
        r["plain_ms"] = cuda_ms(lambda: plain(*args))
        q, k, v, am = _sdpa_inputs(*args)
        r["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am))
        r["shape"] = shape
        r.update(_attn_work(qkv, heads, mask, ws, False))
        rows[name].append(r)
        del q, k, v, am
    return rows


def check_window_attn_bwd(gen):
    """K5b and K6b against their plain backward, two runs bit-identical,
    with SDPA's forward + backward as the yardstick."""
    import torch.nn.functional as F

    from preworld_tpu_torch.ops import window_attn_pallas as wa

    fns = {"fused_window_attention_bwd": (
               lambda q, b, m, d, h, ws: wa.fused_window_attention_bwd(
                   q, b, m, d, h),
               lambda q, b, m, d, h, ws: wa.fused_window_attention_bwd_plain(
                   q, b, m, d, h)),
           "band_window_attention_bwd": (wa.band_window_attention_bwd,
                                         wa.band_window_attention_bwd_plain)}
    rows = {k: [] for k in fns}
    for name, qkv, bias, mask, heads, ws, shape in window_attn_cases(gen):
        name = name + "_bwd"
        kern, plain = fns[name]
        dout = randn(gen, qkv.shape[:-1] + (qkv.shape[-1] // 3,), 1.0,
                     qkv.dtype)
        args = (qkv, bias, mask, dout, heads, ws)
        r = check_backward(name, ("qkv", "bias"), kern, plain, args)
        q, k, v, am = _sdpa_inputs(qkv, bias, mask, heads, ws)
        for t in (q, k, v):
            t.requires_grad_(True)
        do = torch.randn_like(q)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
            torch.autograd.grad(out, (q, k, v), do)

        r["library_ms"] = cuda_ms(sdpa_fwd_bwd)
        r["shape"] = shape
        r.update(_attn_work(qkv, heads, mask, ws, True))
        rows[name].append(r)
        del q, k, v, am, do
    for name, qkv, bias, mask, heads, ws, shape in \
            window_attn_small_cases(gen):
        name = name + "_bwd"
        dout = randn(gen, qkv.shape[:-1] + (qkv.shape[-1] // 3,), 1.0,
                     qkv.dtype)
        r = check_backward(name, ("qkv", "bias"), *fns[name],
                           (qkv, bias, mask, dout, heads, ws), timed=False)
        r.update(shape=shape, extra=True)
        rows[name].append(r)
    return rows


def flagship_geometry(cfg, device, harsh=False):
    """Camera tensors of the flagship synthetic rig for temporal frame 0;
    `harsh`: frame t's ego pose turned by HARSH_YAW_DEG t degrees of yaw and
    moved HARSH_STEP_M t metres along x (the flagship rig: 0 and -0.4)."""
    from preworld_tpu_torch.data import synthetic_batch, to_device
    from preworld_tpu_torch.geometry import (
        curr2adjsensor_chain,
        sensor2keyego_chain,
    )

    b = synthetic_batch(cfg, 1, seed=0)
    b.pop("imgs")
    if harsh:
        for t in range(b["ego2globals"].shape[1]):
            a = math.radians(HARSH_YAW_DEG * t)
            b["ego2globals"][:, t, :, :2, :2] = [[math.cos(a), -math.sin(a)],
                                                [math.sin(a), math.cos(a)]]
            b["ego2globals"][:, t, :, 0, 3] = HARSH_STEP_M * t
    b = to_device(b, device)
    return b, sensor2keyego_chain(b["sensor2egos"], b["ego2globals"]), \
        curr2adjsensor_chain(b["sensor2egos"], b["ego2globals"],
                             cfg.temporal_frames)


def empty_share(cost, curr, bias: float) -> float:
    """Share of the (pixel, plane) costs whose warp sampled nothing: those
    equal sum_c |curr| + bias (up to the order of the channel sum)."""
    l1 = curr.float().abs().sum(-1)[:, None]
    return float(torch.isclose(cost, l1 + bias, rtol=0, atol=1e-2)
                 .float().mean())


def k3_homographies(cfg, harsh=False):
    """K3's (BN, D, 3, 3) homographies of the flagship (or harsh) rig at
    the cost volume's stride 4, on the card."""
    from preworld_tpu_torch.geometry import create_frustum
    from preworld_tpu_torch.models.depthnet import gen_stereo_homography

    b, _, curr2adj = flagship_geometry(cfg, "cuda", harsh)
    fr = torch.from_numpy(create_frustum(cfg.grid, cfg.input_size, 4)).cuda()
    return gen_stereo_homography(
        fr, curr2adj[:, 0], b["intrins"][:, 0], b["post_rots"][:, 0],
        b["post_trans"][:, 0], cfg.input_size).contiguous()


def k3_footprint(hom, H: int, W: int, tile: int = 64,
                 budget: int = 256) -> dict:
    """Where K3's samples fall, from the homographies as the kernel computes
    the positions: the share of (pixel, plane) samples in range; the share
    whose next plane keeps the same four corners (floor(gx), floor(gy) and
    the in-range state); and per (row tile of `tile` pixels, plane) the box
    of corner pixels its in-range samples read (rows, columns: median, p90,
    p99, max) and the share of boxes over `budget` pixels."""
    from preworld_tpu_torch.ops.cost_volume_pallas import sample_positions

    gx, gy, ok = sample_positions(hom, H, W)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    same = (x0[:, 1:] == x0[:, :-1]) & (y0[:, 1:] == y0[:, :-1]) \
        & ok[:, 1:] & ok[:, :-1] | ~ok[:, 1:] & ~ok[:, :-1]
    pad = -W % tile
    big = torch.tensor(float("inf"), device=hom.device)

    def tiles(t, fill):
        t = torch.where(ok, t, fill)
        t = torch.nn.functional.pad(t, (0, pad), value=float(fill))
        return t.reshape(*t.shape[:-1], -1, tile)

    any_in = tiles(ok.float(), 0.0).amax(-1) > 0
    dims = {}
    for name, v in (("rows", y0), ("columns", x0)):
        span = tiles(v, -big).amax(-1) - tiles(v, big).amin(-1) + 2
        dims[name] = span[any_in]
    box = dims["rows"] * dims["columns"]
    q = torch.tensor([0.5, 0.9, 0.99], device=hom.device)
    return {"in_range": float(ok.float().mean()),
            "corners_kept": float(same.float().mean()),
            **{f"box_{k}": [float(x) for x in torch.quantile(v, q)]
               + [float(v.max())] for k, v in dims.items()},
            "boxes_over_budget": float((box > budget).float().mean()),
            "tile": tile, "budget_pixels": budget}


def check_cost_volume(gen, cfg):
    """K3 at the flagship's 128 stereo channels on the flagship rig; marked
    `extra` (checked and timed, left out of the per-kernel sums): 256
    channels (a width the route also sends to K3) and the harsh rig (HARSH_*)
    at 128 and 256. Each against the plain version, and bit-identical over
    two runs; each rig's sample footprint (`k3_footprint`)."""
    from preworld_tpu_torch.ops import cost_volume_pallas as k3

    BN = cfg.num_cams
    Hc, Wc = cfg.input_size[0] // 4, cfg.input_size[1] // 4
    rows = []
    for rig in ("flagship", "harsh"):
        hom = k3_homographies(cfg, rig == "harsh")
        D = hom.shape[1]
        foot = k3_footprint(hom, Hc, Wc)
        for C in (128, 256):
            prev = randn(gen, (BN, Hc, Wc, C), 1.0, torch.bfloat16)
            curr = randn(gen, (BN, Hc, Wc, C), 1.0, torch.bfloat16)
            args = (prev, curr, hom, 5.0)
            got = k3.plane_sweep_cost_hom(*args)
            r = compare("plane_sweep_cost_hom", got,
                        k3.plane_sweep_cost_hom_plain(*args))
            r["bit_identical"] = torch.equal(
                got, k3.plane_sweep_cost_hom(*args))
            r["ms"] = cuda_ms(lambda: k3.plane_sweep_cost_hom(*args))
            r["plain_ms"] = cuda_ms(
                lambda: k3.plane_sweep_cost_hom_plain(*args))
            r["shape"] = f"{rig} rig BN{BN} D{D} {Hc}x{Wc}x{C}"
            # per channel of each (pixel, plane), 9 FP32 operations: curr
            # less the four weighted corners (4 FMA, 2 each), then |.| added
            # (1 add; the abs is an operand modifier)
            r.update(work(2 * BN * Hc * Wc * C * 2 + hom.numel() * 4
                          + BN * D * Hc * Wc * 4, 9 * BN * D * Hc * Wc * C,
                          F32_FLOPS), extra=(rig, C) != ("flagship", 128))
            r["empty_sample_share"] = empty_share(got, curr, 5.0)
            if C == 128:
                r["footprint"] = foot
            rows.append(r)
            del prev, curr, got
    return rows


def check_cost_volume_grid(gen):
    """K7 at the per-stage bench's shapes and warp (128 channels), and at
    256 channels (marked `extra`); bit-identical over two runs."""
    from preworld_tpu_torch.ops import cost_volume_pallas as k7
    from preworld_tpu_torch.tools.bench_parts import smooth_warp_grid

    BN, H, W, D = (BENCH_CV[k] for k in ("BN", "H", "W", "D"))
    grid = torch.from_numpy(smooth_warp_grid(BN, D, H, W)).cuda()
    rows = []
    for C in (BENCH_CV["C"], 256):
        prev = randn(gen, (BN, H, W, C), 1.0, torch.bfloat16)
        curr = randn(gen, (BN, H, W, C), 1.0, torch.bfloat16)
        args = (prev, curr, grid, 5.0)
        got = k7.plane_sweep_cost(*args)
        r = compare("plane_sweep_cost", got, k7.plane_sweep_cost_plain(*args))
        r["bit_identical"] = torch.equal(got, k7.plane_sweep_cost(*args))
        r["ms"] = cuda_ms(lambda: k7.plane_sweep_cost(*args))
        r["plain_ms"] = cuda_ms(lambda: k7.plane_sweep_cost_plain(*args))
        r["shape"] = f"BN{BN} D{D} {H}x{W}x{C}"
        # as K3, and the grid read once
        r.update(work(2 * BN * H * W * C * 2 + grid.numel() * 4
                      + BN * D * H * W * 4, 9 * BN * D * H * W * C,
                      F32_FLOPS), extra=C != BENCH_CV["C"])
        r["empty_sample_share"] = empty_share(got, curr, 5.0)
        rows.append(r)
        del prev, curr, got
    return rows


def k4_edge_cases(gen, C=32, nv=500, npix=64):
    """K4's kernels on ids the flagship's geometry never makes: negative ids
    (dropped, as searchsorted's bounds drop them) beside sentinels and one
    voxel holding 300 points (the slices' case), and no points at all. Each
    case holds `bev_pool_sorted` against the plain `bev_pool` over the points
    it keeps, and its starts against the plain twin and searchsorted."""
    from preworld_tpu_torch.ops import bev_pool_pallas as k4
    from preworld_tpu_torch.ops.bev_pool import bev_pool

    ok = {}
    for case, P in (("negative_ids", 4000), ("no_points", 0)):
        vox = torch.randint(-40, nv + 40, (P,), generator=gen, device="cuda")
        vox[:min(P, 300)] = 7
        pix = torch.randint(0, npix, (P,), generator=gen, device="cuda",
                            dtype=torch.int32)
        depth = torch.rand((P,), generator=gen, device="cuda").to(
            torch.bfloat16)
        feat = randn(gen, (npix, C), 1.0, torch.bfloat16)
        ids, order = k4.bev_pool_prepare(vox)
        out, starts = k4.bev_pool_sorted(ids, order, depth, pix, feat, nv)
        keep = vox >= 0
        r = compare("bev_pool_fused", out,
                    bev_pool(depth[keep], feat, vox[keep], pix[keep], nv))
        bounds = torch.arange(nv + 1, dtype=torch.int32, device="cuda")
        ok[case] = (r["n_bad"] == 0
                    and torch.equal(starts, k4.interval_starts_plain(ids, nv))
                    and torch.equal(starts, torch.searchsorted(
                        ids, bounds).to(torch.int32)))
    return ok


def check_bev_pool(gen, cfg):
    """K4 at the flagship's points (temporal frame 0, C 32): the wrapper
    `bev_pool_fused` against the plain `bev_pool` and bit-identical over
    two calls; the boundary pass's interval starts equal to its plain twin
    and to torch.searchsorted. Times: the kernels alone (`ms`: the boundary
    pass, the long intervals' slices and the interval walk, device ms from
    torch.profiler, each in `kernel_ms`; `sorted_ms`: CUDA events around
    `bev_pool_sorted`), the whole wrapper (sort included; `wrapper_ms`, and
    its device ms `wrapper_device_ms`) and the plain version. The kernels'
    bound counts what they move: the sorted ids, per in-grid point its order,
    depth and pixel, the feature rows once, the interval starts and the
    output."""
    from preworld_tpu_torch.geometry import (
        create_frustum,
        frustum_pixel_indices,
        frustum_to_lidar,
        voxel_indices,
    )
    from preworld_tpu_torch.ops import bev_pool_pallas as k4
    from preworld_tpu_torch.ops.bev_pool import bev_pool

    b, s2k, _ = flagship_geometry(cfg, "cuda")
    fr = torch.from_numpy(create_frustum(cfg.grid, cfg.input_size, 16)).cuda()
    vox = voxel_indices(frustum_to_lidar(
        fr, s2k[:, 0], b["intrins"][:, 0], b["post_rots"][:, 0],
        b["post_trans"][:, 0], b["bda"]), cfg.grid)
    _, N, D, Hf, Wf = vox.shape
    pix = torch.from_numpy(frustum_pixel_indices(1, N, D, Hf, Wf)).cuda()
    depth = torch.softmax(randn(gen, (1, N, D, Hf, Wf), 2.0), dim=2)
    depth = depth.to(torch.bfloat16)
    feat = randn(gen, (1, N, Hf, Wf, cfg.num_trans_channels), 1.0,
                 torch.bfloat16)
    nv = cfg.grid.num_voxels
    C = feat.shape[-1]
    args = (depth, feat, vox, pix, nv)
    got = k4.bev_pool_fused(*args)
    r = compare("bev_pool_fused", got, bev_pool(*args))
    ids, order = k4.bev_pool_prepare(vox)
    sorted_args = (ids, order, depth.reshape(-1), pix.reshape(-1).to(
        torch.int32), feat.reshape(-1, C), nv)
    out, starts = k4.bev_pool_sorted(*sorted_args)
    bounds = torch.arange(nv + 1, dtype=torch.int32, device="cuda")
    r["starts_exact"] = (
        torch.equal(starts, k4.interval_starts_plain(ids, nv))
        and torch.equal(starts, torch.searchsorted(ids, bounds).to(
            torch.int32)))
    r["bit_identical"] = (torch.equal(got, k4.bev_pool_fused(*args))
                          and torch.equal(got, out))
    lengths = starts[1:] - starts[:-1]
    r["points_in_grid"] = int(starts[-1])
    r["nonempty_voxels"] = int((lengths > 0).sum())
    r["longest_interval"] = int(lengths.max())
    r["mean_interval"] = r["points_in_grid"] / max(r["nonempty_voxels"], 1)
    r["edge_cases"] = k4_edge_cases(gen)
    reps = 5
    prof = profile_call(lambda: [k4.bev_pool_fused(*args)
                                 for _ in range(reps)])
    kern = [k for k in prof["top_kernels"] if "pw::bev_pool" in k["name"]]
    if len(kern) != 3 or any(k["count"] != reps for k in kern):
        raise AssertionError(f"kernel K4: profiled kernels {kern}")
    r["ms"] = sum(k["ms"] for k in kern) / reps
    r["wrapper_device_ms"] = prof["device_busy_ms"] / reps
    r["kernel_ms"] = {re.search(r"bev_pool_\w*kernel", k["name"]).group():
                      k["ms"] / reps for k in kern}
    r["sorted_ms"] = cuda_ms(lambda: k4.bev_pool_sorted(*sorted_args))
    r["wrapper_ms"] = cuda_ms(lambda: k4.bev_pool_fused(*args))
    r["plain_ms"] = cuda_ms(lambda: bev_pool(*args))
    r["shape"] = f"P{vox.numel()} C{C} V{nv}"
    P, Pin = vox.numel(), r["points_in_grid"]
    # one multiply-add per channel of each point inside the grid
    r.update(work(4 * P + 14 * Pin + 2 * feat.numel() + 4 * (nv + 1)
                  + 2 * nv * C, 2 * Pin * C, F32_FLOPS))
    # the wrapper's work: its inputs once (depth, feat, voxel and pixel
    # ids) and the output
    r["wrapper_bound_ms"] = bound([work(
        2 * (depth.numel() + feat.numel()) + 4 * vox.numel()
        + 4 * pix.numel() + 2 * nv * C, 2 * Pin * C, F32_FLOPS)])[0]
    return r


# ------------------------------------------------------------------- model

def init_weights(model, seed: int, fan_in: bool = False) -> None:
    """Seeded random weights: N(0, 0.02) for every parameter (or
    N(0, 1/sqrt(fan_in)) for weight matrices and kernels when `fan_in`),
    norm scales 1 + N(0, 0.02), BatchNorm running means N(0, 0.02) and
    POSITIVE running variances U(0.5, 1.5)."""
    import torch.nn as nn

    gen = torch.Generator().manual_seed(seed)

    def draw(t, std, mean=0.0):
        v = torch.randn(t.shape, generator=gen) * std + mean
        t.copy_(v)

    norms = (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, norms):
                draw(m.weight, 0.02, 1.0)
                draw(m.bias, 0.02)
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    draw(m.running_mean, 0.02)
                    m.running_var.copy_(
                        torch.rand(m.running_var.shape, generator=gen) + 0.5)
                continue
            for p in m.parameters(recurse=False):
                std = 0.02
                if fan_in and p.dim() >= 2:
                    std = p[0].numel() ** -0.5
                draw(p, std)


def run_heads(model, batch):
    with torch.no_grad():
        vf, _ = model.extract_voxel_feat(batch)
        return model.occupancy_logits(vf)


def reference_config(**over):
    """The small reference config: flagship widths, 2 Swin blocks per
    stage, 128x352 input, 2 cameras, 20x20x8 grid, finetune heads."""
    from preworld_tpu_torch.geometry import GridConfig
    from preworld_tpu_torch.models import PreWorldConfig

    grid = GridConfig(x=(-8.0, 8.0, 0.8), y=(-8.0, 8.0, 0.8),
                      z=(-1.0, 5.4, 0.8), depth=(1.0, 9.0, 0.5))
    kw = dict(grid=grid, input_size=(128, 352), num_cams=2,
              swin_depths=(2, 2, 2, 2), if_post_finetune=True)
    return PreWorldConfig(**dict(kw, **over))


def check_reference(routes=None, **over):
    """Small config (with `over`): card (bf16, kernels) against CPU (f32,
    plain); `routes`, when given, the Swin stage routes it must take."""
    from preworld_tpu_torch.data import synthetic_batch, to_device
    from preworld_tpu_torch.models import PreWorld

    cfg = reference_config(**over)
    ref = PreWorld(cfg).eval()
    if routes is not None and ref.img_backbone.stage_routes != routes:
        raise AssertionError(f"reference: routes "
                             f"{ref.img_backbone.stage_routes}, expected "
                             f"{routes}")
    init_weights(ref, seed=1, fan_in=True)
    card = PreWorld(dataclasses.replace(cfg, dtype=torch.bfloat16)).eval()
    card.load_state_dict(ref.state_dict())
    card.cuda()
    batch = synthetic_batch(cfg, 1, seed=7)
    want = run_heads(ref, to_device(batch, "cpu"))
    got = run_heads(card, to_device(batch, "cuda")).float().cpu()
    if not torch.isfinite(got).all():
        raise AssertionError("reference: non-finite logits on the card")
    err = (got - want).abs()
    rel_l2 = float(err.norm() / want.norm())
    # where the f32 top-2 margin exceeds twice the largest logit error,
    # the argmax cannot differ
    top2 = want.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * float(err.max())
    agree = got.argmax(-1) == want.argmax(-1)
    res = {"rel_l2": rel_l2, "max_abs_err": float(err.max()),
           "logit_std": float(want.std()),
           "sure_share": float(sure.float().mean()),
           "argmax_agree_share": float(agree.float().mean())}
    if rel_l2 > 0.05 or not bool(agree[sure].all()):
        raise AssertionError(f"reference: card vs CPU disagree: {res}")
    return res


def run_flagship():
    from preworld_tpu_torch.data import synthetic_batch, to_device
    from preworld_tpu_torch.models import PreWorld, PreWorldConfig
    from preworld_tpu_torch.ops import _cuda

    cfg = PreWorldConfig(if_post_finetune=True, dtype=torch.bfloat16)
    model = PreWorld(cfg).eval()
    init_weights(model, seed=0)
    model.cuda()
    n_params = sum(p.numel() for p in model.parameters())
    batches = [synthetic_batch(cfg, 1, seed=s) for s in range(REQUESTS)]
    sx, sy, sz = (int(v) for v in cfg.grid.size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    latencies, per_request, encodes = [], [], []
    _cuda.reset_launches()
    for b in batches:
        before = dict(_cuda.launches)
        enc = _cuda.tensor_map_encodes()
        t0 = time.perf_counter()
        batch = to_device(b, "cuda")
        out = model.predict(batch)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        encodes.append(_cuda.tensor_map_encodes() - enc)
        per_request.append({k: _cuda.launches[k] - before[k]
                            for k in _cuda.launches})
        occ = out["semantic_occ"]
        if occ.shape != (1, sx, sy, sz) or occ.dtype != torch.int32:
            raise AssertionError(f"flagship: semantic_occ {occ.dtype} "
                                 f"{tuple(occ.shape)}")
        lo, hi = int(occ.min()), int(occ.max())
        if lo < 0 or hi > cfg.num_classes - 1:
            raise AssertionError(f"flagship: classes in [{lo}, {hi}]")
    launches = dict(_cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    logits = run_heads(model, to_device(batches[-1], "cuda"))
    if not torch.isfinite(logits).all():
        raise AssertionError("flagship: non-finite occupancy logits")
    for got in per_request:
        if got != EXPECTED_PER_REQUEST:
            raise AssertionError(f"flagship: launches per request {got}, "
                                 f"expected {EXPECTED_PER_REQUEST}")
    return {"latency_ms": latencies, "peak_bytes": peak,
            "launches": launches, "per_request": per_request[0],
            "tensor_map_encodes": encodes, "params": n_params,
            "occ_classes": sorted(torch.unique(occ).tolist()),
            "profile": profile_call(
                lambda: model.predict(to_device(batches[0], "cuda")))}


def profile_call(fn, top: int = 60) -> dict:
    """Device time by kernel over one call of fn (torch.profiler), and the
    share of the call's wall time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted(
        ((e.self_device_time_total, e.count, e.key)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        reverse=True)
    busy_us = sum(k[0] for k in kernels)
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "top_kernels": [{"ms": us / 1e3, "count": n, "name": name[:90]}
                            for us, n, name in kernels[:top]]}


# ------------------------------------------------------------ train step

def one_train_step(model, batch, device, ema_updates=10560):
    """One finetune step of `model` on `device` (drop-path and dropout
    masks from a host generator seeded 11): metrics and the raw (pre-clip)
    gradients, as f32 CPU tensors."""
    from preworld_tpu_torch.data import to_device
    from preworld_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    opt = make_optimizer(model.parameters())
    state = create_train_state(model, opt, ema_updates)
    _, metrics = make_train_step()(state, to_device(batch, device),
                                   torch.Generator().manual_seed(11))
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    return {k: float(v) for k, v in metrics.items()}, grads


def check_train_reference(name="train-reference", density_bias=None, **over):
    """The reference config's train step (finetune unless `over` says
    otherwise), card (bf16, kernels) against CPU (f32, plain), from the same
    weights, batch and masks; `density_bias` sets the density head's output
    bias."""
    from preworld_tpu_torch.data import synthetic_batch
    from preworld_tpu_torch.models import PreWorld

    cfg = reference_config(**dict(dict(num_cams=6, if_render=False,
                                       use_lss_depth_loss=False), **over))
    ref = PreWorld(cfg)
    init_weights(ref, seed=1, fan_in=True)
    if density_bias is not None:
        with torch.no_grad():
            ref.density_mlp.Dense_1.bias.fill_(density_bias)
    state = {k: v.clone() for k, v in ref.state_dict().items()}
    card = PreWorld(dataclasses.replace(cfg, dtype=torch.bfloat16))
    card.load_state_dict(state)
    card.cuda()
    batch = synthetic_batch(cfg, 1, seed=7, with_labels=True)
    want, gw = one_train_step(ref, batch, "cpu")
    got, gg = one_train_step(card, batch, "cuda")
    for k, v in got.items():
        if not math.isfinite(v):
            raise AssertionError(f"{name}: {k} = {v} on the card")
    calib = PreWorld(cfg)
    calib.load_state_dict({k: v.to(torch.bfloat16).to(v.dtype)
                           if v.is_floating_point() else v
                           for k, v in state.items()})
    calib_metrics, gc = one_train_step(calib, batch, "cpu")
    total = math.sqrt(sum(float((g ** 2).sum()) for g in gw.values()))
    live = [k for k, g in gw.items() if float(g.norm()) > 1e-4 * total]

    def cosines(g):
        cos = {k: float(torch.nn.functional.cosine_similarity(
            g[k].reshape(-1).double(), gw[k].reshape(-1).double(), dim=0))
            for k in live}
        flat = torch.nn.functional.cosine_similarity(
            torch.cat([g[k].reshape(-1) for k in live]).double(),
            torch.cat([gw[k].reshape(-1) for k in live]).double(), dim=0)
        return float(flat), statistics.median(cos.values()), cos

    global_cos, median_cos, cos = cosines(gg)
    calib_global, calib_median, _ = cosines(gc)
    worst = sorted(cos, key=cos.get)
    res = {
        "losses": {k: [got[k], want[k]] for k in want},
        "loss_rel": max(abs(got[k] - want[k]) / abs(want[k])
                        for k in want if k != "grad_norm"),
        "grad_norm_rel": abs(got["grad_norm"] - want["grad_norm"])
        / want["grad_norm"],
        "calib_grad_norm_rel": abs(calib_metrics["grad_norm"]
                                   - want["grad_norm"]) / want["grad_norm"],
        "global_cos": global_cos, "median_cos": median_cos,
        "calib_global_cos": calib_global, "calib_median_cos": calib_median,
        "worst": {k: cos[k] for k in worst[:5]},
        "tensors": len(live),
    }
    ok = (res["loss_rel"] <= TRAIN_TOL["loss_rel"]
          and res["grad_norm_rel"] <= TRAIN_TOL["grad_norm_rel"]
          and global_cos >= calib_global - COS_MARGIN
          and median_cos >= calib_median - COS_MARGIN)
    if not ok:
        raise AssertionError(f"{name}: card vs CPU {res}")
    return res


def run_train_flagship(
        config="configs/preworld/preworld_7frame_finetune.py",
        zero_grad=ZERO_GRAD_PREFIXES, num_rays=512, losses=None,
        name="train-flagship"):
    """The flagship train step from its config file (the finetune stage
    unless told otherwise): TRAIN_STEPS steps with remat off, one with remat
    on, one more profiled. `zero_grad`: prefixes of the parameters the loss
    does not reach; `losses`: keys the metrics must hold."""
    from preworld_tpu_torch.data import synthetic_batch, to_device
    from preworld_tpu_torch.ops import _cuda
    from preworld_tpu_torch.train import (
        build_model,
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from preworld_tpu_torch.utils import Config

    conf = Config.fromfile(config)
    model = build_model(conf)
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, remat=False)
    init_weights(model, seed=0, fan_in=True)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, make_optimizer(model.parameters()),
                               conf["ema"]["init_updates"])
    step = make_train_step(conf["ema"]["decay"])
    gen = torch.Generator().manual_seed(0)
    batches = [synthetic_batch(cfg, 1, seed=s, with_labels=True,
                               num_rays=num_rays)
               for s in range(TRAIN_STEPS + 2)]

    def run(i):
        batch = to_device(batches[i], "cuda")
        _cuda.reset_launches()
        enc = _cuda.tensor_map_encodes()
        t0 = time.perf_counter()
        _, metrics = step(state, batch, gen)
        metrics = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        encodes.append(_cuda.tensor_map_encodes() - enc)
        for k, v in metrics.items():
            if not math.isfinite(v):
                raise AssertionError(f"{name} step {i}: {k} = {v}")
        missing = set(losses or ()) - set(metrics)
        if missing:
            raise AssertionError(f"{name} step {i}: no {sorted(missing)}")
        return metrics, ms, dict(_cuda.launches)

    encodes = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = [run(i) for i in range(TRAIN_STEPS)]
    peak = torch.cuda.max_memory_allocated()
    for i, (_, _, launches) in enumerate(steps):
        if launches != EXPECTED_PER_STEP:
            raise AssertionError(f"{name} step {i}: launches "
                                 f"{launches}, expected {EXPECTED_PER_STEP}")
    dead = [n for n, p in model.named_parameters()
            if not n.startswith(zero_grad)
            and (p.grad is None or not bool((p.grad != 0).any()))]
    if dead:
        raise AssertionError(f"{name}: no gradient on {len(dead)} "
                             f"parameters the loss reaches: {dead[:8]}")
    ema_move = max(float((state.ema_params[n] - init[n]).abs().max())
                   for n in init)
    if not ema_move > 0:
        raise AssertionError(f"{name}: the EMA did not move")

    model.cfg = dataclasses.replace(cfg, remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    remat_metrics, remat_ms, remat_launches = run(TRAIN_STEPS)
    remat_peak = torch.cuda.max_memory_allocated()
    if remat_launches != EXPECTED_PER_STEP_REMAT:
        raise AssertionError(f"{name} remat: launches "
                             f"{remat_launches}, expected "
                             f"{EXPECTED_PER_STEP_REMAT}")
    model.cfg = dataclasses.replace(cfg, remat=False)
    batch = to_device(batches[TRAIN_STEPS + 1], "cuda")
    profile = profile_call(lambda: step(state, batch, gen))
    return {
        "metrics": [m for m, _, _ in steps],
        "step_ms": [ms for _, ms, _ in steps],
        "step_ms_2_3": statistics.mean(ms for _, ms, _ in steps[1:]),
        "peak_bytes": peak,
        "launches": {k: sum(s[2][k] for s in steps) for k in steps[0][2]},
        "remat": {"step_ms": remat_ms, "peak_bytes": remat_peak,
                  "metrics": remat_metrics, "launches": remat_launches},
        "ema_max_move": ema_move,
        "tensor_map_encodes": encodes,
        "params": sum(p.numel() for p in model.parameters()),
        "profile": profile,
    }


def grad_rel_l2(got: dict, want: dict) -> tuple:
    """(whole-gradient rel-L2, {name: rel-L2}) of two gradient dicts."""
    per = {n: float((got[n] - w).norm() / w.norm().clamp_min(1e-30))
           for n, w in want.items()}
    num = math.sqrt(sum(float((got[n] - w).pow(2).sum())
                        for n, w in want.items()))
    den = math.sqrt(sum(float(w.pow(2).sum()) for w in want.values()))
    return num / den, per


def run_swin_routes():
    """Path (b): Swin-B with the block kernel off (every stage per block on
    K6, K2, K6b, K2b) against the block route, forward + backward on 6
    images at 512x1408 with the same weights and cotangents."""
    from preworld_tpu_torch.models import PreWorldConfig
    from preworld_tpu_torch.models.swin import SwinTransformer
    from preworld_tpu_torch.ops import _cuda

    size = PreWorldConfig().input_size
    block = SwinTransformer(size)
    init_weights(block, seed=3, fan_in=True)
    band = SwinTransformer(size, use_block_attn=False)
    band.load_state_dict(block.state_dict())
    if band.stage_routes != [("band", True)] * 4:
        raise AssertionError(f"swin-routes: routes {band.stage_routes}")
    block.cuda()
    band.cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = randn(gen, (6,) + tuple(size) + (3,), 1.0, torch.bfloat16)
    cts = []

    def run(model):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        outs = model(x)
        if not cts:
            cts.extend(randn(gen, o.shape) for o in outs)
        loss = sum((o.float() * c).sum() for o, c in zip(outs, cts))
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_cuda.launches)
        grads = {n: p.grad.float() for n, p in model.named_parameters()}
        return [o.detach().float() for o in outs], grads, launches, ms

    want, gw, _, _ = run(block)
    got, gg, launches, _ = run(band)
    if launches != ROUTES_LAUNCHES:
        raise AssertionError(f"swin-routes: launches {launches}, expected "
                             f"{ROUTES_LAUNCHES}")
    # timed in turns after the first run of each
    ms_band, ms_block = run(band)[3], run(block)[3]
    out_rel = [float((g - w).norm() / w.norm()) for g, w in zip(got, want)]
    for o in got:
        if not torch.isfinite(o).all():
            raise AssertionError("swin-routes: non-finite output")
    whole, per = grad_rel_l2(gg, gw)
    worst = sorted(per, key=per.get, reverse=True)[:5]
    res = {"output_rel_l2": out_rel, "grad_rel_l2": whole,
           "worst_tensors": {n: per[n] for n in worst},
           "tensors": len(per), "launches": launches,
           "fwd_bwd_ms": {"band": ms_band, "block": ms_block}}
    if (max(out_rel) > ROUTES_REL_L2 or whole > ROUTES_REL_L2
            or per[worst[0]] > ROUTES_TENSOR_REL_L2):
        raise AssertionError(f"swin-routes: band vs block route {res}")
    return res


def run_swint_flagship():
    """Path (a): the finetune config's model at Swin-T widths, remat off:
    3 predict requests, one more profiled, then 3 finetune steps."""
    from preworld_tpu_torch.data import synthetic_batch, to_device
    from preworld_tpu_torch.ops import _cuda
    from preworld_tpu_torch.train import (
        build_model,
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from preworld_tpu_torch.utils import Config

    conf = Config.fromfile("configs/preworld/preworld_7frame_finetune.py")
    conf["model"]["swin"] = dict(SWINT)
    model = build_model(conf)
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, remat=False)
    routes = model.img_backbone.stage_routes
    if (routes != [("window", False)] * 2 + [("block", True)] * 2
            or model.stereo_on_plane_sweep):
        raise AssertionError(f"swint-flagship: routes {routes}, K3 "
                             f"{model.stereo_on_plane_sweep}")
    init_weights(model, seed=0, fan_in=True)
    sx, sy, sz = (int(v) for v in cfg.grid.size)

    def timed(fn, expected, what):
        _cuda.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if _cuda.launches != expected:
            raise AssertionError(f"swint-flagship {what}: launches "
                                 f"{_cuda.launches}, expected {expected}")
        return out, ms, dict(_cuda.launches)

    model.eval()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    req_ms, req_launches = [], dict.fromkeys(KERNELS, 0)
    for seed in range(REQUESTS):
        batch = synthetic_batch(cfg, 1, seed=seed)
        out, ms, launches = timed(
            lambda: model.predict(to_device(batch, "cuda")),
            SWINT_PER_REQUEST, f"request {seed}")
        occ = out["semantic_occ"]
        if (occ.shape != (1, sx, sy, sz) or int(occ.min()) < 0
                or int(occ.max()) > cfg.num_classes - 1):
            raise AssertionError(f"swint-flagship: semantic_occ "
                                 f"{tuple(occ.shape)}")
        req_ms.append(ms)
        req_launches = {k: req_launches[k] + launches[k] for k in launches}
    req_peak = torch.cuda.max_memory_allocated()
    batch = synthetic_batch(cfg, 1, seed=0)
    req_profile = profile_call(lambda: model.predict(to_device(batch, "cuda")))

    state = create_train_state(model, make_optimizer(model.parameters()),
                               conf["ema"]["init_updates"])
    step = make_train_step(conf["ema"]["decay"])
    gen = torch.Generator().manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, metrics, step_launches = [], [], dict.fromkeys(KERNELS, 0)
    for i in range(TRAIN_STEPS):
        batch = synthetic_batch(cfg, 1, seed=100 + i, with_labels=True)
        (_, m), ms, launches = timed(
            lambda: step(state, to_device(batch, "cuda"), gen),
            SWINT_PER_STEP, f"step {i}")
        m = {k: float(v) for k, v in m.items()}
        for k, v in m.items():
            if not math.isfinite(v):
                raise AssertionError(f"swint-flagship step {i}: {k} = {v}")
        step_ms.append(ms)
        metrics.append(m)
        step_launches = {k: step_launches[k] + launches[k] for k in launches}
    return {"routes": routes, "request_ms": req_ms,
            "request_peak_bytes": req_peak, "request_launches": req_launches,
            "request_profile": req_profile,
            "step_ms": step_ms, "step_ms_2_3": statistics.mean(step_ms[1:]),
            "step_peak_bytes": torch.cuda.max_memory_allocated(),
            "step_launches": step_launches, "metrics": metrics,
            "params": sum(p.numel() for p in model.parameters())}


def run_bench_parts():
    """The `cost_volume` and `nerf` stages of the port's per-stage bench,
    in-process, with their kernel launches."""
    from preworld_tpu_torch.ops import _cuda
    from preworld_tpu_torch.tools import bench_parts

    dev = torch.device("cuda")
    _cuda.reset_launches()
    rows = bench_parts.bench_cost_volume(dev) + bench_parts.bench_nerf(dev)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    # the render's resetting mask scan alone (S - 1 = 416 steps over the
    # rays), on the nerf stage's 38400 rays
    from preworld_tpu_torch.models.nerf_head import NerfHeadConfig
    from preworld_tpu_torch.ops.render import cumdist_mask, sample_ray_points

    spec = NerfHeadConfig().spec
    gen = torch.Generator(device="cuda").manual_seed(0)
    pts, inner, _ = sample_ray_points(
        randn(gen, (38400, 3)), randn(gen, (38400, 3)),
        torch.eye(3, device="cuda"), spec)
    cumdist_ms = cuda_ms(lambda: cumdist_mask(pts, inner, spec))
    # 1 warm-up and 4 timed cost-volume calls, each one K7 launch
    expected = dict.fromkeys(KERNELS, 0)
    expected["plane_sweep_cost"] = 5
    if launches != expected:
        raise AssertionError(f"bench-parts: launches {launches}, expected "
                             f"{expected}")
    return {"stages": rows, "launches": launches,
            "cumdist_mask_ms": cumdist_ms,
            "samples_per_ray": spec.num_samples}


def sass_counts(lib_path: str) -> dict:
    """Per instance of the Hopper GEMMs (`gemm_sm90_kernel<prologue,
    epilogue, tile width, W as stored>`, `gemm_dw_sm90_kernel<prologue>`)
    in the built library, its wgmma (HGMMA), TMA load (UTMALDG) and TMA
    store (UTMASTG) instructions, from `cuobjdump -sass` (the toolkit's,
    beside nvcc); raises if an instance lacks wgmma or TMA loads."""
    import re
    from pathlib import Path

    from preworld_tpu_torch.ops import _cuda

    tool = str(Path(_cuda._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            m = re.search(r"gemm_sm90_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E",
                          ln)
            cur = m and f"gemm_sm90_kernel<{m[1]}, {m[2]}, {m[3]}, {m[4]}>"
            if not cur:
                m = re.search(r"gemm_dw_sm90_kernelILi(\d+)E", ln)
                cur = m and f"gemm_dw_sm90_kernel<{m[1]}>"
            if cur:
                counts[cur] = dict.fromkeys(("HGMMA", "UTMALDG", "UTMASTG"), 0)
        elif cur:
            for op in counts[cur]:
                counts[cur][op] += op in ln
    if not counts or any(not n["HGMMA"] or not n["UTMALDG"]
                         for n in counts.values()):
        raise AssertionError(f"build: the Hopper GEMM's SASS {counts}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from preworld_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    status("device", f"{kind}; torch {torch.__version__} cuda "
           f"{torch.version.cuda}; tf32 matmul/cudnn off")
    print(smi.stdout.strip().splitlines()[0], flush=True)

    t0 = time.perf_counter()
    _cuda.lib()
    info = _cuda.build_info
    ptxas = [ln.strip() for ln in info.get("log", "").splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln
             or "C7512" in ln]
    status("build", f"{info['path']} in {time.perf_counter() - t0:.1f} s "
           f"(nvcc {info['seconds']:.1f} s)")
    for ln in ptxas:
        print("  " + ln)
    for name, n in sass_counts(info["path"]).items():
        status("build", f"{name}: " + ", ".join(f"{op} {c}"
                                               for op, c in n.items()))

    from preworld_tpu_torch.data import tiny_nerf_config
    from preworld_tpu_torch.models import PreWorldConfig

    # The phases after the build are independent: each failure is printed
    # with its traceback and the script goes on to the next phase, so one
    # run reports every fault; it then exits 1 and prints no result line.
    failures = []

    def phase(name, fn):
        try:
            return fn()
        except Exception:  # reported below and fails the run
            traceback.print_exc()
            status(name, "FAILED")
            failures.append(name)
            return None

    flag_cfg = PreWorldConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    rows.update(phase("kernel K1/K2", lambda: check_swin(gen)) or {})
    stages = phase("kernel K1/K2 stages", lambda: check_swin_stages(gen))
    for st in stages or []:
        for k, what in (("qkv", "qkv GEMM (LN1 prologue, bias)"),
                        ("proj", "proj GEMM (bias, row scale, residual)"),
                        ("fc1", "fc1 GEMM (LN2 prologue, bias, GELU)"),
                        ("fc2", "fc2 GEMM (bias, residual)")):
            ms, lib = st[f"{k}_ms"], st[f"{k}_cublas_ms"]
            bnd = st[f"{k}_bound_ms"]
            status("kernel K1/K2 stages",
                   f"Swin-B {st['stage']} {what}: gemm_sm90 {ms:.3f} ms, "
                   f"bound {bnd:.3f} ms ({bnd / ms:.1%}), torch.matmul "
                   f"{lib:.3f} ms ({ms / lib:.2f}x)")
        status("kernel K1/K2 stages",
               f"Swin-B {st['stage']} window attention: W-MSA "
               f"{st['attention_shift0_ms']:.3f} ms, SW-MSA "
               f"{st['attention_shift6_ms']:.3f} ms; ln_stats LN1 "
               f"{st['ln1_ms']:.3f} ms, LN2 {st['ln2_ms']:.3f} ms")
    rows["plane_sweep_cost_hom"] = phase(
        "kernel K3", lambda: check_cost_volume(gen, flag_cfg))
    rows["plane_sweep_cost"] = phase(
        "kernel K7", lambda: check_cost_volume_grid(gen))
    rows["bev_pool_fused"] = [
        phase("kernel K4", lambda: check_bev_pool(gen, flag_cfg))]
    rows.update(phase("kernel K5/K6", lambda: check_window_attn(gen)) or {})
    for name, (label, _, _) in KERNELS.items():
        if name in BWD_KERNELS:
            continue
        atol, rtol = TOL[name]
        for r in rows.get(name) or []:
            if r is None:
                continue
            ok = (r["n_bad"] == 0 and r.get("bit_identical", True)
                  and r.get("pad_decoy_n_bad", 1) > 0
                  and r.get("starts_exact", True)
                  and all(r.get("edge_cases", {}).values()))
            if not ok:
                failures.append(f"kernel {label} {r['shape']}")
            lib = (f", F.scaled_dot_product_attention {r['library_ms']:.3f} ms"
                   if "library_ms" in r else "")
            if "empty_sample_share" in r:
                lib += f"; empty samples {r['empty_sample_share']:.4f}"
            same = (f"; bit-identical over two runs {r['bit_identical']}"
                    if "bit_identical" in r else "")
            if "pad_decoy_n_bad" in r:
                same += (f"; pad tokens left at ln_b would put "
                         f"{r['pad_decoy_n_bad']} real outputs outside")
            times = (f"; kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
                     f"ms{lib}" if "ms" in r else "; untimed")
            status(f"kernel {label}",
                   f"{'ok' if ok else 'MISMATCH'} {r['shape']}"
                   f"{' (extra shape)' if r.get('extra') else ''}: max abs err "
                   f"{r['max_abs_err']:.3g}, max rel err {r['max_rel_err']:.3g}"
                   f", {r['n_bad']} of {r['numel']} outside atol {atol} + "
                   f"rtol {rtol}{same}{times}")
            if "ms" in r and label in ("K3", "K4", "K7"):
                bnd, by = bound([r])
                status(f"kernel {label}", f"{r['shape']}: bound {bnd:.4f} ms "
                       f"({by}), {bnd / r['ms']:.1%} of the kernel's time")
            if "footprint" in r:
                f = r["footprint"]
                status(f"kernel {label}", f"{r['shape'].split(' BN')[0]} "
                       f"footprint: {f['in_range']:.4f} of samples in range, "
                       f"{f['corners_kept']:.4f} keep the corners of the "
                       f"plane before; per {f['tile']}-pixel row tile and "
                       f"plane, corner box rows {f['box_rows']} and columns "
                       f"{f['box_columns']} (median, p90, p99, max), "
                       f"{f['boxes_over_budget']:.4f} of boxes over "
                       f"{f['budget_pixels']} pixels")
            if "wrapper_ms" in r:
                status(f"kernel {label}",
                       f"kernels alone {r['ms']:.4f} ms device ("
                       + ", ".join(f"{n} {v:.4f}"
                                   for n, v in r["kernel_ms"].items())
                       + f"), {r['sorted_ms']:.4f} ms "
                       f"events around bev_pool_sorted; bev_pool_fused "
                       f"{r['wrapper_ms']:.4f} ms (device busy "
                       f"{r['wrapper_device_ms']:.4f}, sort included), "
                       f"bound {r['wrapper_bound_ms']:.4f} ms; "
                       f"{r['points_in_grid']} points in the grid over "
                       f"{r['nonempty_voxels']} voxels, mean "
                       f"{r['mean_interval']:.2f}, longest interval "
                       f"{r['longest_interval']}; starts equal to the plain "
                       f"twin and searchsorted {r['starts_exact']}; "
                       f"edge cases against the plain version "
                       f"{r['edge_cases']}")
        # K5 / K6: each stage's unmasked and masked time on its own line
        by_stage = {}
        for r in rows.get(name) or []:
            if r is not None and "stage" in r:
                by_stage.setdefault(r["stage"], {})[r["masked"]] = r
        for stage, rs in by_stage.items():
            status(f"kernel {label}", f"stage {stage}: " + "; ".join(
                f"{'masked' if m else 'unmasked'} kernel {r['ms']:.3f} ms, "
                f"SDPA {r['library_ms']:.3f} ms"
                for m, r in sorted(rs.items())))
    torch.cuda.empty_cache()

    runs = {}
    for name, fn in (("reference", check_reference),
                     ("flagship", run_flagship)):
        runs[name] = phase(name, fn)
        if runs[name] is not None:
            status(name, "ok " + json.dumps(runs[name]))
        torch.cuda.empty_cache()

    rows.update(phase("kernel K1b/K2b", lambda: check_swin_bwd(gen)) or {})
    torch.cuda.empty_cache()
    rows.update(phase("kernel K5b/K6b", lambda: check_window_attn_bwd(gen))
                or {})
    for name in BWD_KERNELS:
        label = KERNELS[name][0]
        for r in rows.get(name) or []:
            if not r["ok"]:
                failures.append(f"kernel {label} {r['shape']}")
            grads = ", ".join(f"{n} {g['rel_l2']:.2e}"
                              for n, g in r["grads"].items())
            lib = (f", F.scaled_dot_product_attention forward + backward "
                   f"{r['library_ms']:.3f} ms" if "library_ms" in r else "")
            times = (f"; kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
                     f"ms{lib}" if "ms" in r else "; untimed")
            shape = r["shape"] + (
                "" if not r.get("extra") else " (Swin-T width)" if "ms" in r
                else " (small or ragged case)")
            status(f"kernel {label}",
                   f"{'ok' if r['ok'] else 'MISMATCH'} {shape}: rel-L2 "
                   f"{grads} (limit {BWD_REL_L2}); max abs err "
                   f"{r['max_abs_err']:.3g}; bit-identical over two runs "
                   f"{r['bit_identical']}{times}")
    torch.cuda.empty_cache()
    mn = phase("kernel K1b/K2b stages", lambda: check_gemm_mn_major(gen))
    for r in mn or []:
        status("kernel K1b/K2b stages",
               f"MN-major {r['product']}"
               + (f" ({r['splits']} splits)" if "splits" in r else "")
               + f" against torch.matmul: rel-L2 {r['rel_l2']:.2e} "
               f"(limit {MN_MAJOR_REL_L2})")
    bwd_stages = phase("kernel K1b/K2b stages",
                       lambda: check_swin_bwd_stages(gen))
    for st in bwd_stages or []:
        for k in BWD_PRODUCTS:
            ms, lib = st[f"{k}_ms"], st[f"{k}_matmul_ms"]
            bnd = st[f"{k}_bound_ms"]
            status("kernel K1b/K2b stages",
                   f"Swin-B {st['stage']} {k}: {ms:.3f} ms, bound {bnd:.3f} "
                   f"ms ({bnd / ms:.1%}), torch.matmul {lib:.3f} ms "
                   f"({ms / lib:.2f}x)")
        cs, cb = st["colsum_ms"], st["colsum_bound_ms"]
        status("kernel K1b/K2b stages",
               f"Swin-B {st['stage']} column sums (dbproj + db2 with the "
               f"bf16(rs dY) they write, dbqkv, db1's reduction): {cs:.3f} "
               f"ms, bound {cb:.3f} ms ({cb / cs:.1%}; reads alone "
               f"{st['colsum_read_bound_ms']:.3f} ms)")
        status("kernel K1b/K2b stages",
               f"Swin-B {st['stage']} chains: K1b {st['k1b_sum_ms']:.3f} ms "
               f"(W-MSA / SW-MSA mean), K2b {st['k2b_sum_ms']:.3f} ms; "
               "launches " + json.dumps({k: round(v, 4) for k, v in
                                         st["launches"].items()}))
    torch.cuda.empty_cache()
    swint = dict(routes=[("window", False)] * 2 + [("block", True)] * 2,
                 swin_embed_dims=SWINT["embed_dims"],
                 swin_num_heads=SWINT["num_heads"])
    pretrain = dict(if_post_finetune=False, if_render=True,
                    use_lss_depth_loss=True, nerf=tiny_nerf_config())
    for name, fn in (("train-reference", check_train_reference),
                     ("train-flagship", run_train_flagship),
                     ("swin-routes", run_swin_routes),
                     ("swint-reference", lambda: check_reference(**swint)),
                     ("swint-flagship", run_swint_flagship),
                     ("pretrain-reference", lambda: check_train_reference(
                         "pretrain-reference", PRETRAIN_REF_DENSITY_BIAS,
                         **pretrain)),
                     ("pretrain-flagship", lambda: run_train_flagship(
                         "configs/preworld/preworld_7frame_pretrain.py",
                         PRETRAIN_ZERO_GRAD_PREFIXES, 38400, PRETRAIN_LOSSES,
                         "pretrain-flagship")),
                     ("bench-parts", run_bench_parts)):
        runs[name] = phase(name, fn)
        if runs[name] is not None:
            status(name, "ok " + json.dumps(runs[name]))
        torch.cuda.empty_cache()
    if failures:
        print(f"chip_smoke: FAILED phases: {failures}", file=sys.stderr)
        return 1

    # each kernel's launches come from the run of the path it serves
    launch_runs = {"fused_swin_attn_block_bwd": runs["train-flagship"],
                   "fused_swin_mlp_bwd": runs["train-flagship"],
                   "band_window_attention": runs["swin-routes"],
                   "band_window_attention_bwd": runs["swin-routes"],
                   "plane_sweep_cost": runs["bench-parts"]}
    launches = {name: launch_runs.get(name, runs["flagship"])["launches"][name]
                for name in KERNELS}
    launches["fused_window_attention"] = \
        runs["swint-flagship"]["request_launches"]["fused_window_attention"]
    launches["fused_window_attention_bwd"] = \
        runs["swint-flagship"]["step_launches"]["fused_window_attention_bwd"]
    kernels = []
    for name, (label, source, replaces) in KERNELS.items():
        rs = [r for r in rows[name] if not r.get("extra")]
        bound_ms, bound_by = bound(rs)
        lib = [r.get("library_ms") for r in rs]
        kernels.append({
            "name": f"{label} {name}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if None in lib else sum(lib),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
