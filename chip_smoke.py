#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`preworld_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, one status line each; any failure exits non-zero, and there is no
fallback to the CPU or to a kernel's plain version:

  device     a CUDA card is present; its nvidia-smi name and power limit.
  build      nvcc builds the hand-written kernels (preworld_tpu_torch/csrc/)
             for sm_90a into preworld_tpu_torch/build/.
  kernel K*  each kernel against its plain PyTorch version on the card, at
             the flagship shapes, within the stated tolerance; both timed.
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
             (autograd through the plain forward) at every Swin-B stage,
             B = 6, within BWD_REL_L2 per gradient, and bit-identical over
             two runs; both timed.
  train-reference  the small config's finetune train step on the card (bf16,
             kernels) against the CPU (f32, plain): same weights, batch and
             drop-path / dropout masks; each loss, the gradient norm and the
             per-tensor gradient cosine within TRAIN_TOL.
  train-flagship  `build_model` from configs/preworld/preworld_7frame_finetune.py
             takes 3 train steps with remat off and 1 with it on: finite
             losses, a nonzero gradient on every parameter the key frame
             reaches, the EMA moved, 24 K1b and 24 K2b launches per step;
             step time, peak memory and a profiler breakdown of one more step.

Then one JSON line of per-kernel results (launches: K1-K4 from the flagship
predict run, K1b/K2b from the train-flagship run), and last the device line
{"ok": true, "device": {...}}. TF32 is off for both matmuls and cuDNN
convolutions, so every f32 product is full f32.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
}
BWD_KERNELS = ("fused_swin_attn_block_bwd", "fused_swin_mlp_bwd")
# kernel vs plain version, both on the card: pass iff
# |kernel - plain| <= atol + rtol * |plain| everywhere. K1/K2 write bf16
# (1 ulp = 2^-8 relative) after bf16-rounded intermediates (LN output, qkv,
# probabilities, hidden) that can round the other way when the f32 sums
# differ in order; K3 takes the same sample positions and weights in the
# same f32 operations, only the channel sum's order differs; K4 sums f32 in
# another order and rounds once to bf16.
TOL = {
    "fused_swin_attn_block": (0.05, 0.02),
    "fused_swin_mlp": (0.05, 0.02),
    "plane_sweep_cost_hom": (1e-3, 1e-5),
    "bev_pool_fused": (1e-3, 1e-2),
}
# per predict request: 2 temporal frames x 24 Swin blocks, plus the 2
# stage-0 blocks of the stereo-reference frame; one cost volume and one
# voxel pooling per temporal frame
EXPECTED_PER_REQUEST = {"fused_swin_attn_block": 50, "fused_swin_mlp": 50,
                        "plane_sweep_cost_hom": 2, "bev_pool_fused": 2,
                        "fused_swin_attn_block_bwd": 0,
                        "fused_swin_mlp_bwd": 0}
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
# parameters the finetune loss never reaches (the render MLPs) or reaches
# with an exactly zero gradient (the occupancy head's soft weights: a
# softmax over one channel is 1)
ZERO_GRAD_PREFIXES = ("density_mlp.", "semantic_mlp.", "color_mlp.",
                      "occupancy_head.soft_w")


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


# ----------------------------------------------------------------- kernels

def check_swin(gen):
    """K1 and K2 at one W-MSA and one SW-MSA block of every Swin-B stage."""
    from preworld_tpu_torch.models.swin import (
        relative_position_index,
        shifted_window_region_ids,
    )
    from preworld_tpu_torch.ops import swin_block_pallas as k1
    from preworld_tpu_torch.ops import swin_mlp_pallas as k2

    bf = torch.bfloat16
    ws, B = 12, 6
    N = ws * ws
    rel_idx = torch.from_numpy(relative_position_index(ws).reshape(-1)).cuda()
    rows = {"fused_swin_attn_block": [], "fused_swin_mlp": []}
    for C, heads, Hp, Wp, H, W in SWIN_STAGES:
        x = randn(gen, (B, Hp, Wp, C))
        # pad garbage, random per channel so that its LN1 output is large:
        # the kernel must zero it after LN1
        garbage = 37.0 + randn(gen, (B, Hp, Wp, C), 10.0)
        x[:, H:] = garbage[:, H:]
        x[:, :, W:] = garbage[:, :, W:]
        x = x.to(bf).contiguous()
        ln_w, ln_b = 1 + randn(gen, (C,), 0.1), randn(gen, (C,), 0.1)
        wqkv = randn(gen, (3 * C, C), C ** -0.5, bf)
        bqkv = randn(gen, (3 * C,), 0.1)
        wproj = randn(gen, (C, C), C ** -0.5, bf)
        bproj = randn(gen, (C,), 0.1)
        table = randn(gen, ((2 * ws - 1) ** 2, heads), 0.5)
        rel_bias = table[rel_idx].reshape(N, N, heads).permute(2, 0, 1)
        rel_bias = rel_bias.contiguous()
        for shift in (0, ws // 2):
            region = None
            if shift:
                region = torch.from_numpy(shifted_window_region_ids(
                    Hp, Wp, ws, shift).astype("int32")).cuda()
            args = (x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, rel_bias,
                    region, None, heads, ws, H, W, shift)
            r = compare("fused_swin_attn_block", k1.fused_swin_attn_block(*args),
                        k1.fused_swin_attn_block_plain(*args))
            r["ms"] = cuda_ms(lambda: k1.fused_swin_attn_block(*args))
            r["plain_ms"] = cuda_ms(lambda: k1.fused_swin_attn_block_plain(*args))
            r["shape"] = f"B{B} {Hp}x{Wp}x{C} h{heads} shift{shift}"
            rows["fused_swin_attn_block"].append(r)
        w1 = randn(gen, (4 * C, C), C ** -0.5, bf)
        b1 = randn(gen, (4 * C,), 0.1)
        w2 = randn(gen, (C, 4 * C), (4 * C) ** -0.5, bf)
        b2 = randn(gen, (C,), 0.1)
        args = (x, ln_w, ln_b, w1, b1, w2, b2)
        r = compare("fused_swin_mlp", k2.fused_swin_mlp(*args),
                    k2.fused_swin_mlp_plain(*args))
        r["ms"] = cuda_ms(lambda: k2.fused_swin_mlp(*args))
        r["plain_ms"] = cuda_ms(lambda: k2.fused_swin_mlp_plain(*args))
        r["shape"] = f"M{B * Hp * Wp} C{C} hidden{4 * C}"
        rows["fused_swin_mlp"].append(r)
    return rows


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


def check_backward(name, names, bwd, plain, args) -> dict:
    """One backward kernel chain against its plain version on the same
    inputs: per-gradient errors, bit-identity of two kernel runs, times."""
    got = bwd(*args)
    again = bwd(*args)
    want = plain(*args)
    grads = {n: grad_stats(g, w) for n, g, w in zip(names, got, want)}
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    worst = max(g["rel_l2"] for g in grads.values())
    return {"grads": grads, "bit_identical": same, "rel_l2": worst,
            "max_abs_err": max(g["max_abs_err"] for g in grads.values()),
            "ok": same and worst <= BWD_REL_L2,
            "ms": cuda_ms(lambda: bwd(*args)),
            "plain_ms": cuda_ms(lambda: plain(*args))}


def check_swin_bwd(gen):
    """K1b and K2b at one W-MSA and one SW-MSA block (K1b) and one block
    (K2b) of every Swin-B stage, B = 6, cotangent N(0, 1), row scale with
    one zero and one 1/0.9."""
    from preworld_tpu_torch.models.swin import (
        relative_position_index,
        shifted_window_region_ids,
    )
    from preworld_tpu_torch.ops import swin_block_pallas as k1
    from preworld_tpu_torch.ops import swin_mlp_pallas as k2

    bf = torch.bfloat16
    ws, B = 12, 6
    N = ws * ws
    rel_idx = torch.from_numpy(relative_position_index(ws).reshape(-1)).cuda()
    rs = torch.ones(B, device="cuda")
    rs[0], rs[1] = 0.0, 1.0 / 0.9
    rows = {"fused_swin_attn_block_bwd": [], "fused_swin_mlp_bwd": []}
    for C, heads, Hp, Wp, H, W in SWIN_STAGES:
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
        table = randn(gen, ((2 * ws - 1) ** 2, heads), 0.5)
        rel_bias = table[rel_idx].reshape(N, N, heads).permute(2, 0, 1)
        rel_bias = rel_bias.contiguous()
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
        rows["fused_swin_mlp_bwd"].append(r)
    return rows


def flagship_geometry(cfg, device):
    """Camera tensors of the flagship synthetic rig for temporal frame 0."""
    from preworld_tpu_torch.data import synthetic_batch, to_device
    from preworld_tpu_torch.geometry import (
        curr2adjsensor_chain,
        sensor2keyego_chain,
    )

    b = synthetic_batch(cfg, 1, seed=0)
    b.pop("imgs")
    b = to_device(b, device)
    return b, sensor2keyego_chain(b["sensor2egos"], b["ego2globals"]), \
        curr2adjsensor_chain(b["sensor2egos"], b["ego2globals"],
                             cfg.temporal_frames)


def check_cost_volume(gen, cfg):
    from preworld_tpu_torch.geometry import create_frustum
    from preworld_tpu_torch.models.depthnet import gen_stereo_homography
    from preworld_tpu_torch.ops import cost_volume_pallas as k3

    b, _, curr2adj = flagship_geometry(cfg, "cuda")
    fr = torch.from_numpy(create_frustum(cfg.grid, cfg.input_size, 4)).cuda()
    hom = gen_stereo_homography(
        fr, curr2adj[:, 0], b["intrins"][:, 0], b["post_rots"][:, 0],
        b["post_trans"][:, 0], cfg.input_size).contiguous()
    BN = cfg.num_cams
    Hc, Wc = cfg.input_size[0] // 4, cfg.input_size[1] // 4
    prev = randn(gen, (BN, Hc, Wc, 128), 1.0, torch.bfloat16)
    curr = randn(gen, (BN, Hc, Wc, 128), 1.0, torch.bfloat16)
    args = (prev, curr, hom, 5.0)
    got = k3.plane_sweep_cost_hom(*args)
    r = compare("plane_sweep_cost_hom", got,
                k3.plane_sweep_cost_hom_plain(*args))
    r["ms"] = cuda_ms(lambda: k3.plane_sweep_cost_hom(*args))
    r["plain_ms"] = cuda_ms(lambda: k3.plane_sweep_cost_hom_plain(*args))
    r["shape"] = f"BN{BN} D{hom.shape[1]} {Hc}x{Wc}x128"
    r["empty_sample_share"] = float((got > 5.0 - 1e-6).float().mean())
    return r


def check_bev_pool(gen, cfg):
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
    args = (depth, feat, vox, pix, nv)
    r = compare("bev_pool_fused", k4.bev_pool_fused(*args), bev_pool(*args))
    r["ms"] = cuda_ms(lambda: k4.bev_pool_fused(*args))
    r["plain_ms"] = cuda_ms(lambda: bev_pool(*args))
    r["shape"] = f"P{vox.numel()} C{feat.shape[-1]} V{nv}"
    r["points_in_grid"] = int((vox < nv).sum())
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


def check_reference():
    """Small config: card (bf16, kernels) against CPU (f32, plain)."""
    from preworld_tpu_torch.data import synthetic_batch, to_device
    from preworld_tpu_torch.models import PreWorld

    cfg = reference_config()
    ref = PreWorld(cfg).eval()
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
    latencies, per_request = [], []
    _cuda.reset_launches()
    for b in batches:
        before = dict(_cuda.launches)
        t0 = time.perf_counter()
        batch = to_device(b, "cuda")
        out = model.predict(batch)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
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
            "params": n_params,
            "occ_classes": sorted(torch.unique(occ).tolist()),
            "profile": profile_call(
                lambda: model.predict(to_device(batches[0], "cuda")))}


def profile_call(fn, top: int = 15) -> dict:
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


def check_train_reference():
    """The reference config's train step, card (bf16, kernels) against CPU
    (f32, plain), from the same weights, batch and masks."""
    from preworld_tpu_torch.data import synthetic_batch
    from preworld_tpu_torch.models import PreWorld

    cfg = reference_config(num_cams=6, if_render=False,
                           use_lss_depth_loss=False)
    ref = PreWorld(cfg)
    init_weights(ref, seed=1, fan_in=True)
    state = {k: v.clone() for k, v in ref.state_dict().items()}
    card = PreWorld(dataclasses.replace(cfg, dtype=torch.bfloat16))
    card.load_state_dict(state)
    card.cuda()
    batch = synthetic_batch(cfg, 1, seed=7, with_labels=True)
    want, gw = one_train_step(ref, batch, "cpu")
    got, gg = one_train_step(card, batch, "cuda")
    for k, v in got.items():
        if not math.isfinite(v):
            raise AssertionError(f"train-reference: {k} = {v} on the card")
    calib = PreWorld(cfg)
    calib.load_state_dict({k: v.to(torch.bfloat16).to(v.dtype)
                           if v.is_floating_point() else v
                           for k, v in state.items()})
    _, gc = one_train_step(calib, batch, "cpu")
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
        raise AssertionError(f"train-reference: card vs CPU {res}")
    return res


def run_train_flagship():
    """The flagship finetune step from its config file: TRAIN_STEPS steps
    with remat off, one with remat on, one more profiled."""
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
    model = build_model(conf)
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, remat=False)
    init_weights(model, seed=0, fan_in=True)
    model.cuda()
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, make_optimizer(model.parameters()),
                               conf["ema"]["init_updates"])
    step = make_train_step(conf["ema"]["decay"])
    gen = torch.Generator().manual_seed(0)
    batches = [synthetic_batch(cfg, 1, seed=s, with_labels=True)
               for s in range(TRAIN_STEPS + 2)]

    def run(i):
        batch = to_device(batches[i], "cuda")
        _cuda.reset_launches()
        t0 = time.perf_counter()
        _, metrics = step(state, batch, gen)
        metrics = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for k, v in metrics.items():
            if not math.isfinite(v):
                raise AssertionError(f"train-flagship step {i}: {k} = {v}")
        return metrics, ms, dict(_cuda.launches)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = [run(i) for i in range(TRAIN_STEPS)]
    peak = torch.cuda.max_memory_allocated()
    for i, (_, _, launches) in enumerate(steps):
        if launches != EXPECTED_PER_STEP:
            raise AssertionError(f"train-flagship step {i}: launches "
                                 f"{launches}, expected {EXPECTED_PER_STEP}")
    dead = [n for n, p in model.named_parameters()
            if not n.startswith(ZERO_GRAD_PREFIXES)
            and (p.grad is None or not bool((p.grad != 0).any()))]
    if dead:
        raise AssertionError(f"train-flagship: no gradient on {len(dead)} "
                             f"parameters the key frame reaches: {dead[:8]}")
    ema_move = max(float((state.ema_params[n] - init[n]).abs().max())
                   for n in init)
    if not ema_move > 0:
        raise AssertionError("train-flagship: the EMA did not move")

    model.cfg = dataclasses.replace(cfg, remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    remat_metrics, remat_ms, remat_launches = run(TRAIN_STEPS)
    remat_peak = torch.cuda.max_memory_allocated()
    if remat_launches != EXPECTED_PER_STEP_REMAT:
        raise AssertionError(f"train-flagship remat: launches "
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
        "params": sum(p.numel() for p in model.parameters()),
        "profile": profile,
    }


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
             if "registers" in ln or "Compiling entry" in ln]
    status("build", f"{info['path']} in {time.perf_counter() - t0:.1f} s "
           f"(nvcc {info['seconds']:.1f} s)")
    for ln in ptxas:
        print("  " + ln)

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
    rows = phase("kernel K1/K2", lambda: check_swin(gen)) or {}
    rows["plane_sweep_cost_hom"] = [
        phase("kernel K3", lambda: check_cost_volume(gen, flag_cfg))]
    rows["bev_pool_fused"] = [
        phase("kernel K4", lambda: check_bev_pool(gen, flag_cfg))]
    for name, (label, _, _) in KERNELS.items():
        if name in BWD_KERNELS:
            continue
        atol, rtol = TOL[name]
        for r in rows.get(name) or [None]:
            if r is None:
                continue
            ok = r["n_bad"] == 0
            if not ok:
                failures.append(f"kernel {label} {r['shape']}")
            status(f"kernel {label}",
                   f"{'ok' if ok else 'MISMATCH'} {r['shape']}: max abs err "
                   f"{r['max_abs_err']:.3g}, max rel err {r['max_rel_err']:.3g}"
                   f", {r['n_bad']} of {r['numel']} outside atol {atol} + "
                   f"rtol {rtol}; kernel {r['ms']:.3f} ms, plain "
                   f"{r['plain_ms']:.3f} ms")

    ref = phase("reference", check_reference)
    if ref is not None:
        status("reference", "ok " + json.dumps(ref))
    flag = phase("flagship", run_flagship)
    if flag is not None:
        status("flagship", "ok " + json.dumps(flag))
    torch.cuda.empty_cache()

    rows.update(phase("kernel K1b/K2b", lambda: check_swin_bwd(gen)) or {})
    for name in BWD_KERNELS:
        label = KERNELS[name][0]
        for r in rows.get(name) or []:
            if not r["ok"]:
                failures.append(f"kernel {label} {r['shape']}")
            grads = ", ".join(f"{n} {g['rel_l2']:.2e}"
                              for n, g in r["grads"].items())
            status(f"kernel {label}",
                   f"{'ok' if r['ok'] else 'MISMATCH'} {r['shape']}: rel-L2 "
                   f"{grads} (limit {BWD_REL_L2}); max abs err "
                   f"{r['max_abs_err']:.3g}; bit-identical over two runs "
                   f"{r['bit_identical']}; kernel {r['ms']:.3f} ms, plain "
                   f"{r['plain_ms']:.3f} ms")
    torch.cuda.empty_cache()
    tref = phase("train-reference", check_train_reference)
    if tref is not None:
        status("train-reference", "ok " + json.dumps(tref))
    torch.cuda.empty_cache()
    tflag = phase("train-flagship", run_train_flagship)
    if tflag is not None:
        status("train-flagship", "ok " + json.dumps(tflag))
    if failures:
        print(f"chip_smoke: FAILED phases: {failures}", file=sys.stderr)
        return 1

    kernels = []
    for name, (label, source, replaces) in KERNELS.items():
        rs = rows[name]
        run = tflag if name in BWD_KERNELS else flag
        kernels.append({
            "name": f"{label} {name}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": run["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
