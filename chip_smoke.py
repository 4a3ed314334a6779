#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`preworld_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, one status line each and one with the phase's seconds; any
failure exits non-zero, and there is no fallback to the CPU or to a
kernel's plain version:

  device     a CUDA card is present; its nvidia-smi name and power limit.
  build      nvcc builds the hand-written kernels (preworld_tpu_torch/csrc/)
             for sm_90a into preworld_tpu_torch/build/.
  kernel K*  each kernel against its plain PyTorch version on the card, at
             the flagship shapes (K3 also at 256 channels, on a harsh
             rig, 3 degrees of yaw and 2 m a frame, at 128 and 256, and on
             a first streaming step's all-zero previous feature, where
             every cost must read sum |curr| + bias; K7 at
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
  streaming-reference  the reference config streams 3 frames (2, 1, 0 of
             the synthetic batch, the ego moving 0.4 m a frame, from a
             cache initialised on frame 2), card against CPU: the logits
             of each step under the reference gate.
  aavt-reference  the reference check through predict's
             `align_after_vt=True` (the adjacent frame pooled in its own
             ego, then warped to the key ego).
  bevstereo-reference  the BEVStereoOCC baseline on the reference config
             with 6 cameras, card against CPU: logits under the reference
             gate, its two losses (train mode, the same masks) within 1 %.
  streaming-flagship  the flagship model streams 4 frames from a cache:
             exactly 24 K1, 24 K2, 1 K3 and 1 K4 launches a step and no
             other kernel, ms a step, peak bytes, the cache's bytes and
             one profiled step; then `tools/verify_streaming.py`'s
             protocol (constant pose, streaming against the full forward,
             agreement >= 0.98) and one `predict(align_after_vt=True)`
             request at the request's launch counts.
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
  traj-reference  the reference config as PreWorld4DTraj (6 cameras),
             card (bf16, kernels) against CPU (f32, plain): the train step
             at num_future 2 under train-reference's gates (each loss,
             `loss_traj_1s` / `_2s` among them, within 1 %; the gradient
             norm; the cosines against their calibration), then the 7
             rollout predictions: each step's logits under the reference
             gate and the share of voxels where the card's `predict`
             gives the CPU's class.
  traj-flagship  `build_model` of preworld_7frame_finetune_traj.py:
             3 predicts with a 6-step rollout, timed with the batch
             resident and with its upload (50 / 50 / 2 / 2 launches each,
             peak bytes); then 2 train steps at each of num_future 2 and 6
             (the curriculum's ends) with remat off and on (step ms, peak
             bytes, EXPECTED_PER_STEP / _REMAT launches, a nonzero
             gradient on every traj head and every parameter the loss
             reaches); the OccHead's BatchNorm statistics after one
             num_future 2 step with remat on and one with it off from the
             same state, batch and masks (the same, so the recompute
             folds nothing twice); a profiled num_future 6 step.
  pretrain-traj-flagship  preworld_7frame_pretrain_traj.py's model: 2
             steps at num_future 2 with its 19,200 rays per horizon
             (remat as the config sets it), the render and traj losses of
             every horizon finite, ms, peak bytes, launches.
  bench-parts  the `cost_volume` and `nerf` stages of
             `python3 -m preworld_tpu_torch.tools.bench_parts`, in-process:
             the plain grid route against K7 through
             `stereo_cost_volume_fused`, and the render losses of 38400 rays
             on a 200x200x16 field, forward and gradient; then
             `bench_parts --batch 2`'s finetune train step (a batch of 2,
             38400 rays a sample): its row and peak bytes, the time finite
             and positive.
  bench-entry  `python3 -m preworld_tpu_torch.tools.bench` in a process of
             its own: exit 0, its JSON line (printed on a line of its own)
             with every key (`bench.py`'s but `train_bench_error`, and the
             port's `card` and launches), every time (and `tflops_fwd`,
             `mfu`, `gb_accessed_fwd`, `hbm_util`) finite and positive,
             `vs_baseline` equal to round(value / 8, 3) and
             `baseline_assumed_fps` 4.0, and the launches of a request
             (50 / 50 / 2 / 2) and of a streaming step (24 / 24 / 1 / 1).
  flops      `utils/flops.py::count_forward` on the card: the flagship
             predict's parameters read and built, aten and kernel FLOPs
             and each kernel's launches (50 / 50 / 2 / 2) and FLOPs, its
             bytes accessed and transcendentals (aten's, the kernels',
             each kernel's, the 10 largest ops by bytes), equal to the
             bench entry's `tflops_fwd` and `gb_accessed_fwd`; then the
             reference config on the card (bf16, kernels) and on the CPU
             (f32, plain twins): the same FLOP total and parameters read,
             exactly; in bf16 on both: the same forward bytes,
             transcendentals and FLOPs, and `count_step`'s FLOPs of its
             finetune and pretrain steps (a loss and its backward); then
             `count_step` of the flagship finetune step beside
             train-flagship's step time, as a share of 989e12.
  dev-tools  `python3 -m preworld_tpu_torch.tools.{bench_stages,
             bench_bytes, bench_swin, bench_nerf_bisect --quick}`, each a
             process of its own at the flagship sizes: exit 0, the card's
             line, every row under the JAX tools' keys (printed), its
             numbers finite; bench_bytes' full_predict equal to the flops
             phase's count; bench_stages' full_predict beside the bench
             entry's least request time (reported, not gated).

In a temporary directory the script deletes at its end:

  data-flagship  writes a nuScenes tree in the bevdetv2 info layout at
             nuScenes sizes (8 frames over 2 scenes, 6 cameras of 1600x900
             JPEG, 200x200x16 labels.npz, lidar sweeps, sparse depth and
             lidarseg GT of 4000 points an image) and builds one finetune
             and one pretrain train sample from it (38400 rays from the
             ported ray builders): ms each, shapes, finite values.
  train-loop-flagship  `build_model` of the finetune config on the card,
             its dataset on the tree (batch 2, 4 loader threads):
             `train_epochs` for 2 epochs of 2 iterations with a checkpoint
             and an `evaluate_miou` of 3 eval-mode samples at batch 2 after
             each epoch; then `maybe_resume` into a freshly built state,
             which must hold every tensor of the saved one bit for bit, and
             one more epoch. Gates: finite losses, the JAX loop's record
             keys in metrics.jsonl, the launches of each step (K1b / K2b
             24 each) and of each eval (50 / 50 / 2 / 2 a request), the
             eval's count 3. Prints s per iteration, the loader's wait,
             peak bytes, checkpoint bytes, save / restore s, eval s per
             sample and a profiled iteration's device busy share.
  eval-reference  `evaluate_miou` of a stepped state on the reference
             config on the card, 5 samples at batch 2: exactly the
             histogram of a second model that loads the EMA, predicting
             the same batches; the parameters, buffers, gradients and
             moments bit-identical afterwards, each module in its mode.
  pretrain-loop-flagship  the pretrain config's model for one iteration at
             batch 1 from the tree (38400 rays): the six losses finite,
             K1b / K2b 24 launches each.
  offline-chain  the tree's 8 key frames over 2 scenes as a raw nuScenes
             layout (JSON tables, 1600x900 JPEGs, lidar sweeps of 34,720
             points, uint8 lidarseg labels, occupancy labels), then the
             port's offline tools, each `python3 -m
             preworld_tpu_torch.tools.<name>` in a process of its own:
             create_data, gen_depth_gt, gen_seg_gt, precompute_rays (one
             file of each per image); the pretrain config's dataset on
             what they wrote, with and without `ray_cache_path` (38400
             rays, finite, lidar depth present), and one pretrain train
             step on the card from that sample (the six losses finite, the
             launches of a step). Prints s per tool, ms per sample and the
             step's ms.
  cli        the port's four CLIs, each a process of its own on the
             card: `train --synthetic --epochs 1 --max-iters 2` on the
             finetune-traj config (batch 2), `test_temporal --synthetic
             --num-samples 2` on its work dir, `test --synthetic
             --fuse-conv-bn --eval miou fscore` on the reference config as
             a config file, and `convert_torch_checkpoint` of an mmcv
             state dict made from a seeded finetune model, whose output
             overlaid on a fresh model gives back every converted tensor
             bit for bit. Each must exit 0 and print its result.

Training across processes (`preworld_tpu_torch/parallel/`), after cli.
Each phase's ranks are processes of their own (this script with
`--dist-worker`, or torchrun), on the kernels already built: 2 ranks
sharing cuda:0 over gloo, and again over NCCL with one card a rank where
there are 2 cards or more (a `[dist] layout` line says which ran). A
failing rank, a time limit or a gate fails the phase.

  dist       the one-process oracles of the three phases below on this
             process, then one launch of the ranks running their jobs.
  dist-reference  the reference config (train-reference's small config,
             6 cameras, bf16, seeded weights, the same masks): its
             finetune step in 2 processes x batch 1 against one process
             at batch 2, and its pretrain step (512 rays, the density
             bias of pretrain-reference) with n_data 1, n_seq 2 (256 rays
             a rank) against the dense one-process step. Gates, each
             calibrated by two one-process runs (the second from the
             bf16-rounded weights): each loss within TRAIN_TOL["loss_rel"],
             the gradient norm within TRAIN_TOL["grad_norm_rel"], whole and
             median per-tensor gradient cosines at most COS_MARGIN below
             the calibration's, the BatchNorm running statistics after the
             step no further (rel-L2) than the calibration's; the ranks'
             metrics and parameters bit-identical.
  dist-flagship  build_model of the finetune config, remat on: 2 ranks at
             its samples_per_gpu (2) for 3 steps against one process at
             batch 4, losses and gradient norm under dist-reference's loss
             gates, parameters bit-identical, every rank's launches those
             of a remat step (K1b / K2b 24 each); ms a step, the gradient
             all-reduce's ms and bytes, peak bytes a rank, the collectives
             a step (batchnorm: the synced BatchNorms' all_reduces).
  seq-flagship  the pretrain config with n_seq 2: each rank renders
             19,200 of the 38,400 rays; the six losses against the dense
             one-process step under the same gates; peak bytes a rank
             beside the dense run's.
  cli-dist   `python -m torch.distributed.run --nproc_per_node 2 -m
             preworld_tpu_torch.tools.train` on the finetune config
             (`--synthetic --epochs 1 --max-iters 2 --device cuda:0
             --dist-backend gloo`): exit 0, one JSON line, exactly one
             checkpoint; then `--auto-resume` for one more iteration.

A `[done]` line gives the whole run's seconds. Then one JSON line of
per-kernel results (launches: K1-K4 from the flagship
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
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
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
# per streaming step: the new frame's 24 Swin blocks, its cost volume
# against the cached stereo feature and its voxel pooling
STREAMING_PER_STEP = dict.fromkeys(KERNELS, 0)
STREAMING_PER_STEP.update(fused_swin_attn_block=24, fused_swin_mlp=24,
                          plane_sweep_cost_hom=1, bev_pool_fused=1)
# streaming-flagship: the synthetic sequence's frames 2, 1, 0 (the ego
# moving 0.4 m a frame), then frame 0 again (the ego standing)
STREAMING_FRAMES = (2, 1, 0, 0)
# the keys of the bench entry's JSON line, and those that are seconds or
# frames per second
BENCH_KEYS = ("metric", "value", "unit", "tflops_fwd", "mfu",
              "gb_accessed_fwd", "hbm_util", "streaming_fps",
              "pretrain_step_s", "finetune_step_s", "card",
              "launches_per_request", "launches_per_streaming_step",
              "vs_baseline", "baseline_assumed_fps", "baseline_peg_source")
BENCH_TIMES = ("value", "tflops_fwd", "mfu", "gb_accessed_fwd", "hbm_util",
               "streaming_fps", "pretrain_step_s", "finetune_step_s")
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

    b = synthetic_batch(cfg, 1, seed=0, with_labels=False)
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


def k3_row(prev, curr, hom, shape: str) -> dict:
    """K3 on (prev, curr, hom) against its plain version, bit-identity over
    two runs, both timed, its work and its share of empty samples."""
    from preworld_tpu_torch.ops import cost_volume_pallas as k3

    BN, Hc, Wc, C = curr.shape
    D = hom.shape[1]
    args = (prev, curr, hom, 5.0)
    got = k3.plane_sweep_cost_hom(*args)
    r = compare("plane_sweep_cost_hom", got,
                k3.plane_sweep_cost_hom_plain(*args))
    r["bit_identical"] = torch.equal(got, k3.plane_sweep_cost_hom(*args))
    r["ms"] = cuda_ms(lambda: k3.plane_sweep_cost_hom(*args))
    r["plain_ms"] = cuda_ms(lambda: k3.plane_sweep_cost_hom_plain(*args))
    r["shape"] = f"{shape} BN{BN} D{D} {Hc}x{Wc}x{C}"
    # per channel of each (pixel, plane), 9 FP32 operations: curr less the
    # four weighted corners (4 FMA, 2 each), then |.| added (1 add; the abs
    # is an operand modifier)
    r.update(work(2 * BN * Hc * Wc * C * 2 + hom.numel() * 4
                  + BN * D * Hc * Wc * 4, 9 * BN * D * Hc * Wc * C,
                  F32_FLOPS))
    r["empty_sample_share"] = empty_share(got, curr, 5.0)
    return r


def check_cost_volume(gen, cfg):
    """K3 at the flagship's 128 stereo channels on the flagship rig; marked
    `extra` (checked and timed, left out of the per-kernel sums): 256
    channels (a width the route also sends to K3) and the harsh rig (HARSH_*)
    at 128 and 256, and the first streaming step's all-zero previous
    feature (every sample then fails the channel C - 4 test, so every cost
    must read sum |curr| + bias). Each against the plain version, and
    bit-identical over two runs; each rig's sample footprint
    (`k3_footprint`)."""
    BN = cfg.num_cams
    Hc, Wc = cfg.input_size[0] // 4, cfg.input_size[1] // 4
    rows = []
    for rig in ("flagship", "harsh"):
        hom = k3_homographies(cfg, rig == "harsh")
        foot = k3_footprint(hom, Hc, Wc)
        for C in (128, 256):
            prev = randn(gen, (BN, Hc, Wc, C), 1.0, torch.bfloat16)
            curr = randn(gen, (BN, Hc, Wc, C), 1.0, torch.bfloat16)
            r = k3_row(prev, curr, hom, f"{rig} rig")
            r["extra"] = (rig, C) != ("flagship", 128)
            if C == 128:
                r["footprint"] = foot
            rows.append(r)
            del prev, curr
    curr = randn(gen, (BN, Hc, Wc, 128), 1.0, torch.bfloat16)
    r = k3_row(torch.zeros_like(curr), curr, k3_homographies(cfg),
               "first streaming step (zero previous feature), flagship rig")
    r.update(extra=True, all_empty=r["empty_sample_share"] == 1.0)
    rows.append(r)
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

def run_heads(model, batch, align_after_vt=False):
    with torch.no_grad():
        vf, _ = model.extract_voxel_feat(batch, align_after_vt=align_after_vt)
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


def reference_pair(cfg, model_cls=None):
    """(CPU f32 model, card bf16 model) of `cfg` in eval mode with the same
    seeded weights."""
    from preworld_tpu_torch.models import PreWorld
    from preworld_tpu_torch.utils import init_weights

    model_cls = model_cls or PreWorld
    ref = model_cls(cfg).eval()
    init_weights(ref, seed=1, fan_in=True)
    card = model_cls(dataclasses.replace(cfg, dtype=torch.bfloat16)).eval()
    card.load_state_dict(ref.state_dict())
    return ref, card.cuda()


def check_reference(routes=None, align_after_vt=False, **over):
    """Small config (with `over`): card (bf16, kernels) against CPU (f32,
    plain); `routes`, when given, the Swin stage routes it must take;
    `align_after_vt`, the predict option."""
    from preworld_tpu_torch.data import synthetic_batch, to_device

    ref, card = reference_pair(reference_config(**over))
    if routes is not None and ref.img_backbone.stage_routes != routes:
        raise AssertionError(f"reference: routes "
                             f"{ref.img_backbone.stage_routes}, expected "
                             f"{routes}")
    batch = synthetic_batch(ref.cfg, 1, seed=7, with_labels=False)
    want = run_heads(ref, to_device(batch, "cpu"), align_after_vt)
    got = run_heads(card, to_device(batch, "cuda"), align_after_vt)
    return card_vs_cpu("reference", got.float().cpu(), want)


def card_vs_cpu(name: str, got, want) -> dict:
    """Card logits against the CPU's: rel-L2 <= 0.05, and the same argmax
    wherever the CPU's top-2 margin exceeds twice the largest error."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite logits on the card")
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
        raise AssertionError(f"{name}: card vs CPU disagree: {res}")
    return res


def run_flagship():
    from preworld_tpu_torch.data import synthetic_batch, to_device
    from preworld_tpu_torch.models import PreWorld, PreWorldConfig
    from preworld_tpu_torch.ops import _cuda
    from preworld_tpu_torch.utils import init_weights

    cfg = PreWorldConfig(if_post_finetune=True, dtype=torch.bfloat16)
    model = PreWorld(cfg).eval()
    init_weights(model, seed=0)
    model.cuda()
    n_params = sum(p.numel() for p in model.parameters())
    batches = [synthetic_batch(cfg, 1, seed=s, with_labels=False)
               for s in range(REQUESTS)]
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


def check_streaming_reference():
    """3 streaming steps of the reference config (frames 2, 1, 0 of the
    synthetic batch, whose ego moves 0.4 m a frame, from a cache
    initialised on frame 2), card (bf16, kernels) against CPU (f32, plain):
    the occupancy logits of each step under `card_vs_cpu`."""
    from preworld_tpu_torch.data import frame_batch, synthetic_batch, to_device

    ref, card = reference_pair(reference_config())
    batch = synthetic_batch(ref.cfg, 1, seed=7, with_labels=False)
    caches = {m: m.init_sequential_cache(to_device(frame_batch(batch, 2), d))
              for m, d in ((ref, "cpu"), (card, "cuda"))}
    res = []
    for t in (2, 1, 0):
        logits = {}
        for m, d in ((ref, "cpu"), (card, "cuda")):
            vf, caches[m] = m.sequential_voxel_feat(
                to_device(frame_batch(batch, t), d), caches[m])
            with torch.no_grad():
                logits[m] = m.occupancy_logits(vf).float().cpu()
        res.append(card_vs_cpu(f"streaming-reference frame {t}",
                               logits[card], logits[ref]))
    return {"steps": res}


def check_bevstereo_reference():
    """BEVStereoOCC on the reference config with the flagship's 6 cameras,
    card (bf16, kernels) against CPU (f32, plain): its logits in eval mode
    under `card_vs_cpu`, then its two losses in train mode from the same
    batch and drop-path / dropout masks, each within TRAIN_TOL's loss_rel."""
    from preworld_tpu_torch.data import synthetic_batch, to_device
    from preworld_tpu_torch.models import BEVStereoOCC

    ref, card = reference_pair(reference_config(num_cams=6), BEVStereoOCC)
    batch = synthetic_batch(ref.cfg, 1, seed=7, with_labels=True)
    logits, losses = {}, {}
    for m, d in ((ref, "cpu"), (card, "cuda")):
        b = to_device(batch, d)
        with torch.no_grad():
            logits[m] = m.occ_logits(b)[0].float().cpu()
        m.train()
        with torch.no_grad():
            losses[m] = {k: float(v) for k, v in m.loss(
                b, torch.Generator().manual_seed(11)).items()}
    res = card_vs_cpu("bevstereo-reference", logits[card], logits[ref])
    res["losses"] = losses[card]
    res["losses_cpu"] = losses[ref]
    for k, want in losses[ref].items():
        got = losses[card][k]
        if not abs(got - want) <= TRAIN_TOL["loss_rel"] * abs(want):
            raise AssertionError(f"bevstereo-reference: {k} {got} on the "
                                 f"card, {want} on the CPU")
    return res


def run_streaming_flagship():
    """The flagship model (bf16, random weights) streams STREAMING_FRAMES
    from a cache initialised on frame 2: per step exactly the launches of
    STREAMING_PER_STEP, classes in [0, 17], ms, peak bytes and the cache's
    bytes, and one more step profiled. Then the `verify_streaming` protocol
    (constant pose, frames 2, 1, 0 against the full forward) at its
    agreement, and one `predict(align_after_vt=True)` request with the
    request's launch counts."""
    from preworld_tpu_torch.data import frame_batch, synthetic_batch, to_device
    from preworld_tpu_torch.models import PreWorld, PreWorldConfig
    from preworld_tpu_torch.ops import _cuda
    from preworld_tpu_torch.tools import verify_streaming
    from preworld_tpu_torch.utils import init_weights

    cfg = PreWorldConfig(if_post_finetune=True, if_render=False,
                         use_lss_depth_loss=False, dtype=torch.bfloat16)
    model = PreWorld(cfg).eval()
    init_weights(model, seed=0)
    model.cuda()
    batch = to_device(synthetic_batch(cfg, 1, seed=0, with_labels=False),
                      "cuda")
    frames = {t: frame_batch(batch, t) for t in set(STREAMING_FRAMES)}
    sx, sy, sz = (int(v) for v in cfg.grid.size)

    def check_occ(occ, what):
        if occ.shape != (1, sx, sy, sz) or occ.dtype != torch.int32:
            raise AssertionError(f"{what}: semantic_occ {occ.dtype} "
                                 f"{tuple(occ.shape)}")
        lo, hi = int(occ.min()), int(occ.max())
        if lo < 0 or hi > cfg.num_classes - 1:
            raise AssertionError(f"{what}: classes in [{lo}, {hi}]")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cache = model.init_sequential_cache(frames[2])
    ms, per_step = [], []
    for t in STREAMING_FRAMES:
        _cuda.reset_launches()
        t0 = time.perf_counter()
        out, cache = model.predict_sequential(frames[t], cache)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(dict(_cuda.launches))
        check_occ(out["semantic_occ"], "streaming-flagship")
    peak = torch.cuda.max_memory_allocated()
    for got in per_step:
        if got != STREAMING_PER_STEP:
            raise AssertionError(f"streaming-flagship: launches per step "
                                 f"{got}, expected {STREAMING_PER_STEP}")
    if not torch.isfinite(cache["bev_feat"]).all():
        raise AssertionError("streaming-flagship: non-finite cached feature")
    cache_bytes = {k: v.numel() * v.element_size() for k, v in cache.items()}
    profile = profile_call(
        lambda: model.predict_sequential(frames[0], cache), top=25)

    const = to_device(verify_streaming.constant_pose(
        synthetic_batch(cfg, 1, seed=0, with_labels=False)), "cuda")
    agreement = verify_streaming.streaming_agreement(model, const)
    if agreement < verify_streaming.AGREEMENT:
        raise AssertionError(f"streaming-flagship: agreement {agreement} "
                             f"against the full forward, below "
                             f"{verify_streaming.AGREEMENT}")
    del const
    _cuda.reset_launches()
    t0 = time.perf_counter()
    aavt = model.predict(batch, align_after_vt=True)
    torch.cuda.synchronize()
    aavt_ms = (time.perf_counter() - t0) * 1e3
    aavt_launches = dict(_cuda.launches)
    check_occ(aavt["semantic_occ"], "streaming-flagship align_after_vt")
    if aavt_launches != EXPECTED_PER_REQUEST:
        raise AssertionError(f"streaming-flagship: align_after_vt launches "
                             f"{aavt_launches}, expected "
                             f"{EXPECTED_PER_REQUEST}")
    return {"step_ms": ms, "peak_bytes": peak,
            "launches_per_step": {k: v for k, v in per_step[0].items() if v},
            "cache_bytes": cache_bytes,
            "cache_bytes_total": sum(cache_bytes.values()),
            "agreement_vs_full": agreement,
            "aavt_request_ms": aavt_ms,
            "aavt_occ_classes": sorted(
                torch.unique(aavt["semantic_occ"]).tolist()),
            "profile": profile}


def run_bench_entry():
    """`python3 -m preworld_tpu_torch.tools.bench` in a process of its own:
    exit 0, a last line with BENCH_KEYS, every time finite and positive, and
    the launch counts of a request and of a streaming step. Returns that
    line's object."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    run = subprocess.run([sys.executable, "-m", "preworld_tpu_torch.tools.bench"],
                         cwd=root, capture_output=True, text=True,
                         timeout=900)
    if run.returncode != 0:
        raise AssertionError(f"bench-entry: exit {run.returncode}: "
                             f"{run.stderr[-2000:]}")
    line = run.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    out = json.loads(line)
    missing = [k for k in BENCH_KEYS if k not in out]
    bad = [k for k in BENCH_TIMES if k in out
           and not (math.isfinite(out[k]) and out[k] > 0)]
    if missing or bad or out["metric"] != "6cam_occ_inference_fps":
        raise AssertionError(f"bench-entry: keys missing {missing}, times "
                             f"not finite and positive {bad}: {out}")
    # `bench.py`'s peg: value over twice 4.0 frames a second
    if (out["vs_baseline"] != round(out["value"] / 8, 3)
            or out["baseline_assumed_fps"] != 4.0):
        raise AssertionError(f"bench-entry: vs_baseline {out['vs_baseline']}"
                             f", baseline_assumed_fps "
                             f"{out['baseline_assumed_fps']}: {out}")
    for key, want in (("launches_per_request", EXPECTED_PER_REQUEST),
                      ("launches_per_streaming_step", STREAMING_PER_STEP)):
        if out[key] != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"bench-entry: {key} {out[key]}")
    return out


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

def one_train_step(model, batch, device, ema_updates=10560, **loss_kwargs):
    """One finetune step of `model` on `device` (drop-path and dropout
    masks from a host generator seeded 11; `loss_kwargs` to the loss):
    metrics and the raw (pre-clip) gradients, as f32 CPU tensors."""
    from preworld_tpu_torch.data import to_device
    from preworld_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    opt = make_optimizer(model.parameters())
    state = create_train_state(model, opt, ema_updates)
    _, metrics = make_train_step(**loss_kwargs)(
        state, to_device(batch, device), torch.Generator().manual_seed(11))
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    return {k: float(v) for k, v in metrics.items()}, grads


def check_train_reference(name="train-reference", density_bias=None,
                          model_cls=None, loss_kwargs=None, **over):
    """The reference config's train step (finetune unless `over` says
    otherwise), card (bf16, kernels) against CPU (f32, plain), from the same
    weights, batch and masks; `density_bias` sets the density head's output
    bias. `model_cls`: the model, PreWorld by default; PreWorld4DTraj
    takes a batch with the forecasting keys. `loss_kwargs` go to the
    loss."""
    from preworld_tpu_torch.data import synthetic_batch
    from preworld_tpu_torch.models import PreWorld, PreWorld4DTraj
    from preworld_tpu_torch.utils import init_weights

    model_cls = model_cls or PreWorld
    loss_kwargs = loss_kwargs or {}
    cfg = reference_config(**dict(dict(num_cams=6, if_render=False,
                                       use_lss_depth_loss=False), **over))
    ref = model_cls(cfg)
    init_weights(ref, seed=1, fan_in=True)
    if density_bias is not None:
        with torch.no_grad():
            ref.density_mlp.Dense_1.bias.fill_(density_bias)
    state = {k: v.clone() for k, v in ref.state_dict().items()}
    card = model_cls(dataclasses.replace(cfg, dtype=torch.bfloat16))
    card.load_state_dict(state)
    card.cuda()
    batch = synthetic_batch(cfg, 1, seed=7, with_labels=True,
                            with_traj=model_cls is PreWorld4DTraj)
    want, gw = one_train_step(ref, batch, "cpu", **loss_kwargs)
    got, gg = one_train_step(card, batch, "cuda", **loss_kwargs)
    for k, v in got.items():
        if not math.isfinite(v):
            raise AssertionError(f"{name}: {k} = {v} on the card")
    calib = model_cls(cfg)
    calib.load_state_dict({k: v.to(torch.bfloat16).to(v.dtype)
                           if v.is_floating_point() else v
                           for k, v in state.items()})
    calib_metrics, gc = one_train_step(calib, batch, "cpu", **loss_kwargs)
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
    from preworld_tpu_torch.utils import Config, init_weights

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
    from preworld_tpu_torch.utils import init_weights

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
    from preworld_tpu_torch.utils import Config, init_weights

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
        batch = synthetic_batch(cfg, 1, seed=seed, with_labels=False)
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
    batch = synthetic_batch(cfg, 1, seed=0, with_labels=False)
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
    in-process, with their kernel launches, then its finetune train step at
    batch 2 (`bench_parts --batch 2`) with the step's peak memory."""
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
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (b2,) = bench_parts.bench_train_step(
        "configs/preworld/preworld_7frame_finetune.py", "finetune_train_step",
        dev, batch=2)
    b2["peak_bytes"] = torch.cuda.max_memory_allocated()
    # the stage's wall seconds, model build and warm-up included
    b2["wall_s"] = time.perf_counter() - t0
    print(json.dumps(b2), flush=True)
    if b2["stage"] != "finetune_train_step_b2" or not (
            math.isfinite(b2["s"]) and b2["s"] > 0):
        raise AssertionError(f"bench-parts: batch-2 finetune step {b2}")
    return {"stages": rows + [b2], "launches": launches,
            "cumdist_mask_ms": cumdist_ms,
            "samples_per_ray": spec.num_samples}


# ------------------------------------------- the forecasting model and CLIs

FINETUNE_TRAJ_CONFIG = "configs/preworld/preworld_7frame_finetune_traj.py"
PRETRAIN_TRAJ_CONFIG = "configs/preworld/preworld_7frame_pretrain_traj.py"
# the rollout curriculum's ends: `rollout_curriculum` gives 2 future steps
# in the first epochs and 6 in the last
TRAJ_FUTURES = (2, 6)
# the forecasting heads, each of which must get a nonzero gradient
TRAJ_HEADS = ("plan_head.", "fusion_head.", "downscale.", "ego_fusion_head.",
              "traj_head.")
# traj-flagship: train steps per (num_future, remat) setting
TRAJ_STEPS = 2
# cli: each command's time limit, and the reference config as a config file
# (the finetune config with `reference_config`'s sizes)
CLI_TIMEOUT_S = 600
REFERENCE_CONFIG_FILE = """
_base_ = ["{base}"]
data_config = dict(input_size=(128, 352), Ncams=2)
grid_config = dict(x=[-8.0, 8.0, 0.8], y=[-8.0, 8.0, 0.8],
                   z=[-1.0, 5.4, 0.8], depth=[1.0, 9.0, 0.5])
model = dict(swin=dict(depths=(2, 2, 2, 2)))
"""
# the port's Swin parameter names -> mmcv keys (the inverse of
# `utils/torch_port.py::swin_key_map`), the first match applies
SWIN_TO_MMCV = (
    (r"^patch_embed\.", "patch_embed.projection."),
    (r"^patch_norm\.", "patch_embed.norm."),
    (r"^out_norm(\d)\.", r"norm\1."),
    (r"^downsample(\d)\.", r"stages.\1.downsample."),
    (r"^stage(\d+)_block(\d+)\.attn\.", r"stages.\1.blocks.\2.attn.w_msa."),
    (r"^stage(\d+)_block(\d+)\.mlp_fc1\.",
     r"stages.\1.blocks.\2.ffn.layers.0.0."),
    (r"^stage(\d+)_block(\d+)\.mlp_fc2\.", r"stages.\1.blocks.\2.ffn.layers.1."),
    (r"^stage(\d+)_block(\d+)\.", r"stages.\1.blocks.\2."),
)


def rollout_logits(model, batch, num_future: int = 6) -> list:
    """The occupancy logits of the current frame and of each rollout
    step."""
    with torch.no_grad():
        feats, _ = model.extract_voxel_feat(batch)
        out = [model.occupancy_logits(feats)]
        for _ in range(num_future):
            feats, _ = model.rollout_step(feats, batch["ego_states"])
            out.append(model.occupancy_logits(feats))
    return out


def check_traj_reference() -> dict:
    """The reference config as PreWorld4DTraj (6 cameras), card (bf16,
    kernels) against CPU (f32, plain): the train step at num_future 2 under
    `check_train_reference`'s gates, then the 7 rollout predictions: each
    step's logits under `card_vs_cpu`, and the share of voxels where the
    card's `predict` gives the CPU's class."""
    from preworld_tpu_torch.data import synthetic_batch, to_device
    from preworld_tpu_torch.models import PreWorld4DTraj
    from preworld_tpu_torch.train.evaluate import INFER_KEYS

    res = check_train_reference("traj-reference", model_cls=PreWorld4DTraj,
                                loss_kwargs={"num_future": 2})
    ref, card = reference_pair(reference_config(num_cams=6), PreWorld4DTraj)
    b = synthetic_batch(ref.cfg, 1, seed=7, with_traj=True)
    b = {k: b[k] for k in INFER_KEYS}
    want = rollout_logits(ref, to_device(b, "cpu"))
    got = rollout_logits(card, to_device(b, "cuda"))
    pred = card.predict(to_device(b, "cuda"))
    if sorted(pred) != sorted(f"semantic_occ_{k}s" for k in range(7)):
        raise AssertionError(f"traj-reference: predict keys {sorted(pred)}")
    steps = []
    for k, (g, w) in enumerate(zip(got, want)):
        r = card_vs_cpu(f"traj-reference step {k}", g.float().cpu(), w)
        r["predict_agree_share"] = float(
            (pred[f"semantic_occ_{k}s"].cpu() == w.argmax(-1)).float().mean())
        steps.append(r)
    res["loss_traj"] = {k: v for k, v in res["losses"].items()
                        if k.startswith("loss_traj")}
    res["rollout"] = steps
    return res


def traj_batches(cfg, n: int, **kw) -> list:
    """n synthetic traj batches (seeds 0 .. n - 1), numpy."""
    from preworld_tpu_torch.data import synthetic_batch

    return [synthetic_batch(cfg, 1, seed=s, with_traj=True, **kw)
            for s in range(n)]


def run_traj_flagship() -> dict:
    """The finetune-traj config's model (Swin-B, 6 cameras at 512x1408, 3
    frames, 200x200x16 grid, out_dim 32): REQUESTS predicts with a 6-step
    rollout, timed with the batch resident and with its upload; then train
    steps at num_future 2 and 6 (the curriculum's ends) with remat off and
    on; the gradient of every traj head; and the OccHead's BatchNorm
    statistics after one num_future 2 step with remat on and one with it
    off from the same state, batch and masks."""
    from preworld_tpu_torch.data import to_device
    from preworld_tpu_torch.ops import _cuda
    from preworld_tpu_torch.train import (
        build_model,
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from preworld_tpu_torch.train.evaluate import INFER_KEYS
    from preworld_tpu_torch.utils import Config, init_weights

    conf = Config.fromfile(FINETUNE_TRAJ_CONFIG)
    model = build_model(conf)
    cfg = model.cfg
    init_weights(model, seed=0, fan_in=True)
    sx, sy, sz = (int(v) for v in cfg.grid.size)
    batches = traj_batches(cfg, REQUESTS + 1)
    infer = [{k: b[k] for k in INFER_KEYS} for b in batches[:REQUESTS]]

    def request(batch, upload):
        _cuda.reset_launches()
        t0 = time.perf_counter()
        out = model.predict(to_device(batch, "cuda") if upload else batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_cuda.launches)
        if sorted(out) != sorted(f"semantic_occ_{k}s" for k in range(7)):
            raise AssertionError(f"traj-flagship: predict keys {sorted(out)}")
        for k, occ in out.items():
            if occ.shape != (1, sx, sy, sz) or occ.dtype != torch.int32 \
                    or int(occ.min()) < 0 \
                    or int(occ.max()) > cfg.num_classes - 1:
                raise AssertionError(f"traj-flagship: {k} {occ.dtype} "
                                     f"{tuple(occ.shape)}")
        if launches != EXPECTED_PER_REQUEST:
            raise AssertionError(f"traj-flagship: launches per request "
                                 f"{launches}, expected "
                                 f"{EXPECTED_PER_REQUEST}")
        return ms

    model.eval()
    resident = [to_device(b, "cuda") for b in infer]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_ms = [request(b, False) for b in resident]
    upload_ms = [request(b, True) for b in infer]
    predict_peak = torch.cuda.max_memory_allocated()
    del resident
    torch.cuda.empty_cache()

    model.train()
    init_updates, decay = conf["ema"]["init_updates"], conf["ema"]["decay"]
    state = create_train_state(model, make_optimizer(model.parameters()),
                               init_updates)
    gen = torch.Generator().manual_seed(0)

    def run(num_future, remat, i, st=None, generator=None):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        step = make_train_step(decay, num_future=num_future)
        batch = to_device(batches[i], "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        _, metrics = step(state if st is None else st, batch,
                          gen if generator is None else generator)
        metrics = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_cuda.launches)
        what = f"traj-flagship num_future {num_future} remat {remat}"
        bad = [k for k, v in metrics.items() if not math.isfinite(v)]
        if bad or f"loss_traj_{num_future}s" not in metrics \
                or f"loss_traj_{num_future + 1}s" in metrics:
            raise AssertionError(f"{what}: metrics {metrics}")
        want = EXPECTED_PER_STEP_REMAT if remat else EXPECTED_PER_STEP
        if launches != want:
            raise AssertionError(f"{what}: launches {launches}, expected "
                                 f"{want}")
        return {"ms": ms, "peak_bytes": torch.cuda.max_memory_allocated(),
                "metrics": metrics}

    steps, head_grads = {}, {}
    for num_future in TRAJ_FUTURES:
        for remat in (False, True):
            rs = [run(num_future, remat, i) for i in range(TRAJ_STEPS)]
            steps[f"num_future {num_future} remat {remat}"] = {
                "step_ms": [r["ms"] for r in rs],
                "peak_bytes": max(r["peak_bytes"] for r in rs),
                "loss_traj": {k: v for k, v in rs[-1]["metrics"].items()
                              if k.startswith("loss_traj")}}
            dead = [n for n, p in model.named_parameters()
                    if not n.startswith(ZERO_GRAD_PREFIXES)
                    and (p.grad is None or not bool((p.grad != 0).any()))]
            if dead:
                raise AssertionError(f"traj-flagship: no gradient on "
                                     f"{len(dead)} parameters the loss "
                                     f"reaches: {dead[:8]}")
            head_grads[num_future] = {
                h: math.sqrt(sum(float(p.grad.float().pow(2).sum())
                                 for n, p in model.named_parameters()
                                 if n.startswith(h)))
                for h in TRAJ_HEADS}

    # the OccHead's running statistics: remat on and off from one state
    snap = {k: v.clone() for k, v in model.state_dict().items()}
    bn_keys = [k for k in snap if k.startswith("occupancy_head.")
               and k.endswith(("running_mean", "running_var"))]

    def bn_after(remat):
        model.load_state_dict(snap)
        st = create_train_state(model, make_optimizer(model.parameters()),
                                init_updates)
        run(2, remat, REQUESTS, st, torch.Generator().manual_seed(5))
        return {k: model.state_dict()[k].clone() for k in bn_keys}

    plain, rematted = bn_after(False), bn_after(True)
    moved = max(float((plain[k] - snap[k]).abs().max()) for k in bn_keys)
    diff = max(float((plain[k] - rematted[k]).abs().max()) for k in bn_keys)
    if not moved > 0 or diff > 1e-4 * moved:
        raise AssertionError(f"traj-flagship: OccHead BN statistics moved "
                             f"{moved}, remat against plain {diff}")
    model.cfg = dataclasses.replace(cfg, remat=False)
    batch = to_device(batches[0], "cuda")
    step6 = make_train_step(decay, num_future=TRAJ_FUTURES[-1])
    profile = profile_call(lambda: step6(state, batch, gen), top=16)
    return {
        "request_ms_resident": resident_ms, "request_ms_upload": upload_ms,
        "predict_peak_bytes": predict_peak,
        "launches_per_request": {k: v for k, v in
                                 EXPECTED_PER_REQUEST.items() if v},
        "steps": steps, "head_grad_norms": head_grads,
        "occ_head_bn": {"tensors": len(bn_keys), "moved": moved,
                        "remat_vs_plain_max_abs": diff},
        "profile_num_future_6": profile,
    }


def run_pretrain_traj_flagship() -> dict:
    """The pretrain-traj config's model: TRAJ_STEPS train steps at
    num_future 2 with its max_ray_nums rays per horizon (remat as the
    config sets it), losses finite, the step's launches."""
    from preworld_tpu_torch.data import to_device
    from preworld_tpu_torch.ops import _cuda
    from preworld_tpu_torch.train import make_train_step
    from preworld_tpu_torch.utils import Config

    conf = Config.fromfile(PRETRAIN_TRAJ_CONFIG)
    state = config_state(conf)
    cfg = state.model.cfg
    rays = int(conf["data"]["train"]["max_ray_nums"])
    batches = traj_batches(cfg, TRAJ_STEPS, num_rays=rays, num_future=2)
    step = make_train_step(conf["ema"]["decay"], num_future=2)
    want = EXPECTED_PER_STEP_REMAT if cfg.remat else EXPECTED_PER_STEP
    gen = torch.Generator().manual_seed(0)
    ms = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for b in batches:
        batch = to_device(b, "cuda")
        _cuda.reset_launches()
        t0 = time.perf_counter()
        _, metrics = step(state, batch, gen)
        metrics = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_cuda.launches)
        keys = {"loss_render_depth_0s", "loss_render_depth_2s",
                "loss_traj_1s", "loss_traj_2s", "loss_lss_depth"}
        if not keys <= set(metrics) or not all(
                math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"pretrain-traj-flagship: {metrics}")
        if launches != want:
            raise AssertionError(f"pretrain-traj-flagship: launches "
                                 f"{launches}, expected {want}")
    return {"rays_per_horizon": rays, "remat": cfg.remat, "step_ms": ms,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "losses": metrics}


def mmcv_state_dict(model) -> dict:
    """The port model's Swin, neck, depth net and BEV encoder tensors under
    the reference checkpoint's mmcv keys (`full_model_key_map` and the
    inverse of `swin_key_map`), CPU tensors."""
    from preworld_tpu_torch.utils.flax_bridge import torch_name
    from preworld_tpu_torch.utils.torch_port import (
        full_model_key_map,
        swin_key_map,
    )

    state = model.state_dict()
    sd = {}
    for name, p in model.img_backbone.named_parameters():
        key = next(re.sub(pat, rep, name) for pat, rep in SWIN_TO_MMCV
                   if re.match(pat, name))
        path, _ = swin_key_map(key)
        if torch_name(("img_backbone",) + path) != "img_backbone." + name:
            raise AssertionError(f"cli: {name} -> {key} -> {path}")
        sd["img_backbone." + key] = p.detach().cpu().clone()
    for tprefix, (fpath, kind) in full_model_key_map().items():
        base = ".".join(fpath)
        leaves = (("weight", "bias", "running_mean", "running_var")
                  if kind == "bn" else ("weight", "bias"))
        for leaf in leaves:
            if f"{base}.{leaf}" not in state:
                continue
            t = state[f"{base}.{leaf}"].cpu().clone()
            if kind == "dense1x1" and leaf == "weight":
                t = t[:, :, None, None]
            sd[f"{tprefix}.{leaf}"] = t
    return sd


def run_cli(tmp: str) -> dict:
    """The four CLIs, each a process of its own on the card:
    `train --synthetic --epochs 1 --max-iters 2` on the finetune-traj
    config, `test_temporal --synthetic --num-samples 2` on its work dir,
    `test --synthetic --fuse-conv-bn --eval miou fscore` on the reference
    config, and `convert_torch_checkpoint` of an mmcv state dict made from
    a seeded model, whose output overlaid on a fresh model must give back
    every converted tensor bit for bit. Each must exit 0 and print its
    result."""
    from preworld_tpu_torch.train import build_model
    from preworld_tpu_torch.utils import Config, init_weights
    from preworld_tpu_torch.utils.torch_port import overlay_flax_params

    root = os.path.dirname(os.path.abspath(__file__))
    seconds = {}

    def cli(name, *args):
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", f"preworld_tpu_torch.tools.{name}", *args],
            cwd=root, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
        seconds[name] = time.perf_counter() - t0
        if p.returncode != 0:
            raise AssertionError(f"cli {name}: exit {p.returncode}\n"
                                 f"{p.stderr[-4000:]}")
        last = p.stdout.strip().splitlines()[-1]
        status("cli", f"{name}: {last}")
        return last

    work = os.path.join(tmp, "traj_work")
    train = json.loads(cli("train", FINETUNE_TRAJ_CONFIG, "--synthetic",
                           "--epochs", "1", "--max-iters", "2",
                           "--work-dir", work))
    if train["step"] != 2 or "loss_traj_2s" not in train["metrics"] \
            or not all(math.isfinite(v) for v in train["metrics"].values()):
        raise AssertionError(f"cli train: {train}")
    temporal = json.loads(cli("test_temporal", FINETUNE_TRAJ_CONFIG, work,
                              "--synthetic", "--num-samples", "2"))
    if temporal["count"] != 2 or "mIoU_3s" not in temporal:
        raise AssertionError(f"cli test_temporal: {temporal}")
    ref_cfg = os.path.join(tmp, "reference.py")
    with open(ref_cfg, "w") as fh:
        fh.write(REFERENCE_CONFIG_FILE.format(
            base=os.path.join(root, FINETUNE_CONFIG)))
    test = json.loads(cli("test", ref_cfg, "--synthetic", "--fuse-conv-bn",
                          "--eval", "miou", "fscore"))
    if test["count"] != 4 or "fscore" not in test:
        raise AssertionError(f"cli test: {test}")

    conf = Config.fromfile(FINETUNE_CONFIG)
    source = build_model(conf, device="cpu")
    init_weights(source, seed=3, fan_in=True)
    sd = mmcv_state_dict(source)
    pth, pkl = os.path.join(tmp, "bevdet.pth"), os.path.join(tmp, "ported.pkl")
    torch.save({"state_dict": sd}, pth)
    converted = cli("convert_torch_checkpoint", pth, pkl)
    with open(pkl, "rb") as fh:
        ported = pickle.load(fh)
    fresh = build_model(conf, device="cpu")
    init_weights(fresh, seed=4, fan_in=True)
    loaded, unexpected = overlay_flax_params(fresh, ported["params"],
                                             ported["batch_stats"])
    want, got = source.state_dict(), fresh.state_dict()
    differ = [k for k in loaded if not torch.equal(got[k], want[k])]
    swin = [n for n, _ in source.img_backbone.named_parameters()]
    if unexpected or differ or not {f"img_backbone.{n}" for n in swin} \
            <= set(loaded):
        raise AssertionError(f"cli convert: unexpected {unexpected[:5]}, "
                             f"differ {differ[:5]}")
    return {"seconds": seconds, "train": train, "test_temporal": temporal,
            "test": test, "convert": {"printed": converted,
                                      "mmcv_tensors": len(sd),
                                      "loaded": len(loaded)}}


# ------------------------------------- data layer, train loop, evaluation

FINETUNE_CONFIG = "configs/preworld/preworld_7frame_finetune.py"
PRETRAIN_CONFIG = "configs/preworld/preworld_7frame_pretrain.py"
# data-flagship: a nuScenes tree this script writes (bevdetv2 infos and the
# reference's file formats) at nuScenes sizes: 8 key frames over 2 scenes,
# 6 cameras of 1600x900 JPEG, 200x200x16 occupancy labels, lidar sweeps of
# 34720 points, and sparse depth / lidarseg GT of 4000 points an image, so
# that a pretrain sample's 7 frames x 6 cameras hold more than its 38400
# rays
TREE_FRAMES, TREE_SCENES = 8, 2
TREE_SRC = (900, 1600)
TREE_GT_POINTS = 4000
TREE_LIDAR_POINTS = 34720
TREE_CAM_YAWS = (55.0, 0.0, -55.0, -110.0, 180.0, 110.0)  # DEFAULT_CAMS
TREE_INTRIN = [[1266.4, 0.0, 816.3], [0.0, 1266.4, 491.5], [0.0, 0.0, 1.0]]
TREE_PKL = "bevdetv2-nuscenes_infos_train.pkl"
# train-loop-flagship: epochs x iterations with a checkpoint each epoch,
# then one more epoch resumed from it; the eval after each epoch over
# EVAL_SAMPLES eval-mode samples at batch EVAL_BATCH (the last one padded)
LOOP_EPOCHS, LOOP_ITERS = 2, 2
EVAL_SAMPLES, EVAL_BATCH = 3, 2
# eval-reference: samples (at batch 2)
EVAL_REF_SAMPLES = 5
# the keys of each train record in metrics.jsonl, as the JAX loop writes
# them (each loss of the step besides)
RECORD_KEYS = {"epoch", "iter", "time_per_iter", "loss_total", "grad_norm"}


def rotmat_to_quat(r) -> list:
    """(w, x, y, z) of a 3x3 rotation (Shepperd's branches)."""
    t = r[0, 0] + r[1, 1] + r[2, 2]
    if t > 0:
        s = 2.0 * math.sqrt(t + 1.0)
        return [s / 4, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                (r[1, 0] - r[0, 1]) / s]
    i = max(range(3), key=lambda k: r[k, k])
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * math.sqrt(1.0 + r[i, i] - r[j, j] - r[k, k])
    q = [0.0] * 4
    q[0] = (r[k, j] - r[j, k]) / s
    q[1 + i] = s / 4
    q[1 + j] = (r[j, i] + r[i, j]) / s
    q[1 + k] = (r[k, i] + r[i, k]) / s
    return q


def tree_ego_pose(t: int):
    """Key frame t of the tree: (scene, frame within it, ego rotation
    quaternion, ego translation); the ego turns 2 degrees and moves 0.5 m a
    frame."""
    import numpy as np

    scene, f = divmod(t, TREE_FRAMES // TREE_SCENES)
    yaw = math.radians(2.0 * f + 30.0 * scene)
    ego_rot = rotmat_to_quat(np.array(
        [[math.cos(yaw), -math.sin(yaw), 0.0],
         [math.sin(yaw), math.cos(yaw), 0.0], [0.0, 0.0, 1.0]]))
    ego_tr = [600.0 + 200.0 * scene + 0.5 * f * math.cos(yaw),
              1600.0 + 0.5 * f * math.sin(yaw), 0.0]
    return scene, f, ego_rot, ego_tr


def tree_camera(yaw_deg: float):
    """(sensor2ego rotation quaternion, translation) of the tree's camera
    looking along `yaw_deg` (x right, y down, z forward)."""
    import numpy as np

    a = math.radians(yaw_deg)
    fwd = [math.cos(a), math.sin(a), 0.0]
    right = [math.sin(a), -math.cos(a), 0.0]
    rot = np.stack([right, [0.0, 0.0, -1.0], fwd], axis=1)
    return rotmat_to_quat(rot), [fwd[0], 0.5 * fwd[1], 1.6]


def tree_labels(rng, shape) -> dict:
    """One frame's random occupancy labels of `shape` (70 % free)."""
    import numpy as np

    return dict(
        semantics=np.where(rng.uniform(size=shape) < 0.7, 17,
                           rng.integers(0, 17, shape)).astype(np.uint8),
        mask_lidar=(rng.uniform(size=shape) < 0.4).astype(np.uint8),
        mask_camera=(rng.uniform(size=shape) < 0.6).astype(np.uint8))


def tree_image(rng):
    """A 1600x900 RGB image: a random 80x45 one resized bilinearly."""
    import numpy as np
    from PIL import Image

    H, W = TREE_SRC
    small = rng.integers(0, 256, (H // 20, W // 20, 3), np.uint8)
    return Image.fromarray(small).resize((W, H), Image.BILINEAR)


def write_nuscenes_tree(root: str, grid_shape, seed: int = 0) -> str:
    """Write the data-flagship tree under `root` (paths in the infos
    relative to it, as `data_root` reads them), its occupancy labels of
    `grid_shape`; returns the info pkl."""
    import pickle

    import numpy as np

    from preworld_tpu_torch.data import DEFAULT_CAMS

    rng = np.random.default_rng(seed)
    H, W = TREE_SRC
    intrin = np.array(TREE_INTRIN)
    infos = []
    for t in range(TREE_FRAMES):
        scene, f, ego_rot, ego_tr = tree_ego_pose(t)
        token = f"tok{t:03d}"
        occ = os.path.join("gts", f"scene-{scene:04d}", token)
        os.makedirs(os.path.join(root, occ))
        np.savez_compressed(os.path.join(root, occ, "labels.npz"),
                            **tree_labels(rng, tuple(grid_shape)))
        pts = np.empty((TREE_LIDAR_POINTS, 5), np.float32)
        pts[:, :2] = rng.uniform(-50.0, 50.0, (TREE_LIDAR_POINTS, 2))
        pts[:, 2] = rng.uniform(-2.0, 4.0, TREE_LIDAR_POINTS)
        pts[:, 3] = rng.uniform(0, 255, TREE_LIDAR_POINTS)
        pts[:, 4] = rng.integers(0, 32, TREE_LIDAR_POINTS)
        lidar = os.path.join("sweeps", f"{token}__LIDAR_TOP.pcd.bin")
        os.makedirs(os.path.join(root, "sweeps"), exist_ok=True)
        pts.tofile(os.path.join(root, lidar))
        info = {"token": token, "scene_token": f"scene-{scene:04d}",
                "scene_name": f"scene-{scene:04d}", "frame_idx": f,
                "timestamp": 1_533_000_000_000_000 + 500_000 * t,
                "lidar_path": lidar, "lidar2ego_rotation": [1.0, 0, 0, 0],
                "lidar2ego_translation": [0.94, 0.0, 1.84],
                "ego2global_rotation": ego_rot,
                "ego2global_translation": ego_tr, "occ_path": occ,
                "cams": {}}
        for cam, a in zip(DEFAULT_CAMS, TREE_CAM_YAWS):
            cam_rot, cam_tr = tree_camera(a)
            name = os.path.join("samples", cam, f"{token}__{cam}.jpg")
            os.makedirs(os.path.join(root, "samples", cam), exist_ok=True)
            tree_image(rng).save(os.path.join(root, name), quality=90)
            info["cams"][cam] = {
                "data_path": name, "cam_intrinsic": intrin,
                "sensor2ego_rotation": cam_rot,
                "sensor2ego_translation": cam_tr,
                "ego2global_rotation": ego_rot,
                "ego2global_translation": ego_tr}
            uv = np.stack([rng.integers(0, W, TREE_GT_POINTS),
                           rng.integers(0, H, TREE_GT_POINTS)],
                          1).astype(np.float32)
            base = os.path.basename(name) + ".bin"
            for sub, val in (
                    ("depth_gt", rng.uniform(1.5, 50.0, TREE_GT_POINTS)),
                    ("seg_gt", rng.integers(0, 17, TREE_GT_POINTS))):
                os.makedirs(os.path.join(root, sub), exist_ok=True)
                np.concatenate([uv, val[:, None]], 1).astype(
                    np.float32).tofile(os.path.join(root, sub, base))
        infos.append(info)
    ann = os.path.join(root, TREE_PKL)
    with open(ann, "wb") as fh:
        pickle.dump({"infos": infos, "metadata": {"version": "v1.0-fake"}},
                    fh)
    return ann


def tree_dataset(conf, root: str, is_train: bool, **kw):
    """The config's train dataset on the tree (its pkl, data root and GT
    paths in place of the config's; `kw` to the dataset)."""

    from preworld_tpu_torch.data import NuScenesOccDataset

    tr = conf["data"]["train"]
    return NuScenesOccDataset(
        ann_file=os.path.join(root, TREE_PKL),
        data_config=conf["data_config"], grid_config=conf["grid_config"],
        bda_aug_conf=conf.get("bda_aug_conf"), is_train=is_train,
        use_rays=bool(tr.get("use_rays", False)),
        aux_frames=tr.get("aux_frames", (-3, -2, -1, 1, 2, 3)),
        max_ray_nums=int(tr.get("max_ray_nums", 38400)),
        depth_gt_path=os.path.join(root, "depth_gt"),
        semantic_gt_path=os.path.join(root, "seg_gt"), data_root=root, **kw)


def run_data_flagship(root: str) -> dict:
    """Write the tree, then build one finetune and one pretrain train
    sample (rays from the ported builders) and check their shapes."""

    import numpy as np

    from preworld_tpu_torch.geometry.rays import RAY_DIM
    from preworld_tpu_torch.train.builder import build_grid_config
    from preworld_tpu_torch.utils import Config

    conf = Config.fromfile(FINETUNE_CONFIG)
    grid = tuple(int(v) for v in build_grid_config(conf["grid_config"]).size)
    t0 = time.perf_counter()
    write_nuscenes_tree(root, grid)
    out = {"tree_write_s": time.perf_counter() - t0,
           "tree_bytes": sum(os.path.getsize(os.path.join(d, f))
                             for d, _, fs in os.walk(root) for f in fs)}
    H, W = conf["data_config"]["input_size"]
    n = int(conf["data_config"]["Ncams"])
    want = {"imgs": (3, n, H, W, 3), "sensor2egos": (3, n, 4, 4),
            "voxel_semantics": grid, "mask_camera": grid,
            "gt_depth": (n, H, W), "bda": (3, 3)}
    for name, config in (("finetune", FINETUNE_CONFIG),
                         ("pretrain", PRETRAIN_CONFIG)):
        ds = tree_dataset(Config.fromfile(config), root, is_train=True)
        t0 = time.perf_counter()
        s = ds[TREE_FRAMES // TREE_SCENES - 1]
        out[f"{name}_sample_ms"] = (time.perf_counter() - t0) * 1e3
        shapes = {k: tuple(v.shape) for k, v in s.items()}
        out[f"{name}_shapes"] = shapes
        need = dict(want, rays=(ds.max_ray_nums, RAY_DIM)) if ds.use_rays \
            else want
        bad = {k: shapes.get(k) for k, v in need.items()
               if shapes.get(k) != v}
        if bad or not all(np.isfinite(v).all() for v in s.values()
                          if v.dtype.kind == "f"):
            raise AssertionError(f"data-flagship {name}: shapes {bad} or "
                                 f"non-finite values: {shapes}")
        out[f"{name}_lidar_depth_share"] = float((s["gt_depth"] > 0).mean())
    return out


class TimedLoader:
    """A loader that records how long each `next` blocks its caller, per
    epoch."""

    def __init__(self, loader):
        self.loader = loader
        self.waits = []

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)
        self.waits.append([])

    def __iter__(self):
        it = iter(self.loader)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.waits[-1].append(time.perf_counter() - t0)
                yield batch
        finally:
            it.close()


def counted(step, log: list):
    """`step` with the launch counts of each call appended to `log` (the
    counts set to 0 just before the call)."""
    from preworld_tpu_torch.ops import _cuda

    def run(state, batch, generator):
        _cuda.reset_launches()
        out = step(state, batch, generator)
        log.append(dict(_cuda.launches))
        return out

    return run


def config_state(conf, seed: int = 0):
    """`build_model(conf)` on the card with seeded weights, and its train
    state with the config's optimizer and EMA, as the JAX train CLI sets
    them."""
    from preworld_tpu_torch.train import (
        build_model,
        create_train_state,
        make_optimizer,
    )
    from preworld_tpu_torch.utils import init_weights

    model = build_model(conf)
    init_weights(model, seed=seed, fan_in=True)
    opt, lr = conf.get("optimizer", {}), conf.get("lr_config", {})
    clip = conf.get("optimizer_config", {}).get("grad_clip", {})
    return create_train_state(model, make_optimizer(
        model.parameters(), base_lr=float(opt.get("lr", 1e-4)),
        weight_decay=float(opt.get("weight_decay", 1e-2)),
        clip_norm=float(clip.get("max_norm", 5)),
        warmup_iters=int(lr.get("warmup_iters", 200))),
        int(conf["ema"]["init_updates"]))


def state_mismatches(a, b) -> list:
    """Names of what two train states do not hold bit-equal: model state,
    AdamW moments, EMA, the optimizer's count, ema_updates, step."""
    sb = b.model.state_dict()
    bad = [k for k, v in a.model.state_dict().items()
           if not torch.equal(v, sb[k])]
    pb = dict(b.model.named_parameters())
    for n, p in a.model.named_parameters():
        ma, mb = a.optimizer.state[p], b.optimizer.state[pb[n]]
        bad += [f"{k}.{n}" for k in ("mu", "nu")
                if k not in mb or not torch.equal(ma[k], mb[k])]
        if not torch.equal(a.ema_params[n], b.ema_params[n]):
            bad.append(f"ema.{n}")
    bad += [k for k in ("step", "ema_updates")
            if getattr(a, k) != getattr(b, k)]
    if a.optimizer.count != b.optimizer.count:
        bad.append("count")
    return bad


def read_records(work: str, what: str) -> tuple:
    """(train records, eval records) of work/metrics.jsonl; each train
    record must hold the JAX loop's keys and finite numbers."""
    with open(os.path.join(work, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    train = [r for r in recs if "eval" not in r]
    evals = [r for r in recs if "eval" in r]
    for r in train:
        if not RECORD_KEYS <= set(r) or not all(
                math.isfinite(v) for v in r.values()):
            raise AssertionError(f"{what}: train record {r}")
    return train, evals


def run_train_loop_flagship(root: str, tmp: str) -> dict:
    """The finetune config's model trained by `train_epochs` from the tree:
    LOOP_EPOCHS epochs of LOOP_ITERS iterations at the config's batch, a
    checkpoint and an `evaluate_miou` each epoch; then `maybe_resume` into
    a freshly built state (bit-equal to the saved one) and one more
    epoch."""

    from preworld_tpu_torch.data import DataLoader
    from preworld_tpu_torch.ops import _cuda
    from preworld_tpu_torch.train import (
        evaluate_miou,
        make_train_step,
        maybe_resume,
        save_checkpoint,
        train_epochs,
    )
    from preworld_tpu_torch.train.loop import batch_to
    from preworld_tpu_torch.utils import Config

    conf = Config.fromfile(FINETUNE_CONFIG)
    data = conf["data"]
    state = config_state(conf)
    expected = EXPECTED_PER_STEP_REMAT if state.model.cfg.remat \
        else EXPECTED_PER_STEP
    loader = TimedLoader(DataLoader(
        tree_dataset(conf, root, is_train=True),
        batch_size=int(data["samples_per_gpu"]),
        num_workers=int(data["workers_per_gpu"]) * 2, seed=0))
    eval_ds = tree_dataset(conf, root, is_train=False)
    eval_samples = [eval_ds[i] for i in range(EVAL_SAMPLES)]
    evals, steps = [], []

    def eval_fn(state):
        _cuda.reset_launches()
        t0 = time.perf_counter()
        res = evaluate_miou(state.model, state, iter(eval_samples),
                            batch_size=EVAL_BATCH)
        evals.append({"s_per_sample": (time.perf_counter() - t0)
                      / EVAL_SAMPLES, "launches": dict(_cuda.launches)})
        return res

    step = counted(make_train_step(conf["ema"]["decay"]), steps)
    work = os.path.join(tmp, "finetune_run")
    gen = torch.Generator().manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_epochs(state, step, loader, LOOP_EPOCHS, work,
                         log_interval=1, generator=gen, eval_fn=eval_fn,
                         max_iters_per_epoch=LOOP_ITERS)
    loop_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ckpt = os.path.join(work, "checkpoints")
    files = sorted(os.listdir(ckpt), key=lambda f: int(f.split(".")[0]))
    want_files = [f"{LOOP_ITERS * (e + 1)}.pt" for e in range(LOOP_EPOCHS)]
    if files != want_files:
        raise AssertionError(f"train-loop-flagship: checkpoints {files}")
    ckpt_bytes = os.path.getsize(os.path.join(ckpt, want_files[-1]))
    t0 = time.perf_counter()
    save_checkpoint(ckpt, state, state.step, max_to_keep=2)
    save_s = time.perf_counter() - t0

    fresh = config_state(conf, seed=1)
    t0 = time.perf_counter()
    fresh, resumed = maybe_resume(fresh, work)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    bad = state_mismatches(state, fresh)
    if not resumed or bad:
        raise AssertionError(f"train-loop-flagship: resumed {resumed}, "
                             f"not bit-equal: {bad[:8]} ({len(bad)})")
    del state
    torch.cuda.empty_cache()
    for f in want_files[:-1]:  # at most 2 checkpoints on disk
        os.remove(os.path.join(ckpt, f))
    fresh = train_epochs(fresh, step, loader, LOOP_EPOCHS + 1, work,
                         log_interval=1, generator=gen, eval_fn=eval_fn,
                         start_epoch=LOOP_EPOCHS,
                         max_iters_per_epoch=LOOP_ITERS)
    train, eval_recs = read_records(work, "train-loop-flagship")
    batch = next(iter(loader.loader))
    profile = profile_call(lambda: step(fresh, batch_to(batch, "cuda"), gen),
                           top=8)
    per_eval = {k: v * math.ceil(EVAL_SAMPLES / EVAL_BATCH)
                for k, v in EXPECTED_PER_REQUEST.items()}
    faults = [f"step {i} launches {s}" for i, s in enumerate(steps)
              if s != expected]
    faults += [f"eval launches {e['launches']}" for e in evals
               if e["launches"] != per_eval]
    faults += [f"eval {r}" for r in eval_recs
               if r["eval"]["count"] != EVAL_SAMPLES]
    if len(train) != LOOP_ITERS * (LOOP_EPOCHS + 1):
        faults.append(f"{len(train)} train records")
    if len(eval_recs) != LOOP_EPOCHS + 1:
        faults.append(f"{len(eval_recs)} eval records")
    if fresh.step != LOOP_ITERS * (LOOP_EPOCHS + 1) + 1:
        faults.append(f"step {fresh.step}")
    if faults:
        raise AssertionError(f"train-loop-flagship: {faults}")
    return {
        "batch": int(data["samples_per_gpu"]),
        "loader_threads": loader.loader.num_workers,
        "remat": fresh.model.cfg.remat,
        "s_per_iter": [r["time_per_iter"] for r in train],
        "loader_wait_s_first": [w[0] for w in loader.waits if w],
        "loader_wait_s_later": [x for w in loader.waits
                                for x in w[1:LOOP_ITERS]],
        "loop_s_first_epochs": loop_s,
        "peak_bytes": peak,
        "checkpoint_bytes": ckpt_bytes,
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in fresh.model.parameters()),
        "save_s": save_s, "restore_s": restore_s,
        "eval_s_per_sample": [e["s_per_sample"] for e in evals],
        "eval_miou": [r["eval"]["mIoU"] for r in eval_recs],
        "losses": {k: [r[k] for r in train] for k in train[0]
                   if k.startswith("loss") or k == "grad_norm"},
        "launches_per_step": {k: v for k, v in steps[0].items() if v},
        "launches_per_eval": {k: v for k, v in evals[0]["launches"].items()
                              if v},
        "profile_step": {k: profile[k] for k in
                         ("wall_ms", "device_busy_ms", "device_busy_share")},
        "profile_top": profile["top_kernels"],
    }


def check_eval_reference() -> dict:
    """`evaluate_miou` of a stepped state on the reference config (card,
    bf16, kernels) over EVAL_REF_SAMPLES samples at batch 2: exactly the
    histogram and mIoU of MetricMIoU fed sample by sample from `predict`
    of a second model that loads the EMA, on the same batches; the
    training parameters, buffers, gradients and moments bit-identical
    afterwards and every module back in its mode."""
    import numpy as np

    from preworld_tpu_torch.data import synthetic_batch, to_device
    from preworld_tpu_torch.metrics import MetricMIoU
    from preworld_tpu_torch.models import PreWorld
    from preworld_tpu_torch.train import (
        create_train_state,
        evaluate_miou,
        make_optimizer,
        make_train_step,
    )
    from preworld_tpu_torch.train.evaluate import INFER_KEYS
    from preworld_tpu_torch.utils import init_weights

    cfg = dataclasses.replace(reference_config(), dtype=torch.bfloat16)
    model = PreWorld(cfg)
    init_weights(model, seed=1, fan_in=True)
    model.cuda()
    state = create_train_state(model, make_optimizer(model.parameters()),
                               10560)
    make_train_step()(state, to_device(synthetic_batch(cfg, 1, seed=7),
                                       "cuda"),
                      torch.Generator().manual_seed(11))
    # an EMA far from the parameters (another seeded init), so that the
    # check can tell which weights were scored
    other = PreWorld(cfg)
    init_weights(other, seed=2, fan_in=True)
    with torch.no_grad():
        for n, p in other.named_parameters():
            state.ema_params[n].copy_(p)
    b = synthetic_batch(cfg, EVAL_REF_SAMPLES, seed=3)
    samples = [{k: v[i] for k, v in b.items()}
               for i in range(EVAL_REF_SAMPLES)]
    model.train()
    model.occupancy_head.eval()  # a mixed mode must come back as it was
    modes = [m.training for m in model.modules()]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    moments = {n: {k: v.clone() for k, v in state.optimizer.state[p].items()}
               for n, p in model.named_parameters()}
    dumps = []
    t0 = time.perf_counter()
    got = evaluate_miou(model, state, iter(samples), batch_size=2,
                        dump_fn=lambda i, occ: dumps.append((i, occ)))
    eval_s = time.perf_counter() - t0
    faults = [] if [m.training for m in model.modules()] == modes \
        else ["modes"]
    faults += [k for k, v in model.state_dict().items()
               if not torch.equal(v, before[k])]
    faults += [f"grad.{n}" for n, p in model.named_parameters()
               if n in grads and not torch.equal(p.grad, grads[n])]
    faults += [f"{k}.{n}" for n, p in model.named_parameters()
               for k, v in moments[n].items()
               if not torch.equal(state.optimizer.state[p][k], v)]

    oracle = PreWorld(cfg)
    oracle.load_state_dict({**before, **state.ema_params})
    oracle.cuda().eval()
    model.eval()
    metric, scored = MetricMIoU(), MetricMIoU()
    for i, occ in dumps:  # the histogram of what the eval predicted
        s = samples[i]
        scored.add_batch(occ, s["voxel_semantics"], None, s["mask_camera"])
    differ = 0.0
    for lo in range(0, EVAL_REF_SAMPLES, 2):
        idx = [min(i, EVAL_REF_SAMPLES - 1) for i in (lo, lo + 1)]
        batch = to_device({k: np.stack([samples[i][k] for i in idx])
                           for k in INFER_KEYS if k in samples[0]}, "cuda")
        occ = oracle.predict(batch)["semantic_occ"]
        raw = model.predict(batch)["semantic_occ"]
        differ = max(differ, float((occ != raw).float().mean()))
        occ = occ.cpu().numpy()
        for j in range(min(2, EVAL_REF_SAMPLES - lo)):
            s = samples[lo + j]
            metric.add_batch(occ[j], s["voxel_semantics"], None,
                             s["mask_camera"])
    want = metric.count_miou()
    if got != want or not np.array_equal(scored.hist, metric.hist):
        faults.append(f"mIoU {got['mIoU']} != oracle {want['mIoU']}, or "
                      f"the histograms differ")
    if not differ > 0:
        faults.append("the EMA and the parameters predict alike")
    if faults:
        raise AssertionError(f"eval-reference: {faults[:8]}")
    return {"mIoU": got["mIoU"], "oracle_mIoU": want["mIoU"],
            "count": got["count"], "eval_s": eval_s,
            "hist_sum": float(metric.hist.sum()),
            "raw_params_differ_share": differ}


def run_pretrain_loop_flagship(root: str, tmp: str) -> dict:
    """The pretrain config's model for one epoch of one iteration from the
    tree at batch 1, its 38400 rays built by the ported ray builders."""

    from preworld_tpu_torch.data import DataLoader
    from preworld_tpu_torch.train import make_train_step, train_epochs
    from preworld_tpu_torch.utils import Config

    conf = Config.fromfile(PRETRAIN_CONFIG)
    state = config_state(conf)
    expected = EXPECTED_PER_STEP_REMAT if state.model.cfg.remat \
        else EXPECTED_PER_STEP
    ds = tree_dataset(conf, root, is_train=True)
    loader = TimedLoader(DataLoader(
        ds, batch_size=1, num_workers=int(conf["data"]["workers_per_gpu"])
        * 2, seed=0))
    steps = []
    work = os.path.join(tmp, "pretrain_run")
    t0 = time.perf_counter()
    train_epochs(state, counted(make_train_step(conf["ema"]["decay"]), steps),
                 loader, 1, work, log_interval=1, checkpoint_interval=2,
                 generator=torch.Generator().manual_seed(0),
                 max_iters_per_epoch=1)
    loop_s = time.perf_counter() - t0
    train, _ = read_records(work, "pretrain-loop-flagship")
    missing = [k for k in PRETRAIN_LOSSES if k not in train[0]]
    if missing or len(steps) != 1 or steps[0] != expected \
            or ds.max_ray_nums != 38400:
        raise AssertionError(f"pretrain-loop-flagship: losses missing "
                             f"{missing}, launches {steps}, rays "
                             f"{ds.max_ray_nums}")
    return {"rays": ds.max_ray_nums, "loop_s": loop_s,
            "s_per_iter": train[0]["time_per_iter"],
            "loader_wait_s": loader.waits[0][0],
            "losses": {k: train[0][k] for k in PRETRAIN_LOSSES},
            "launches_per_step": {k: v for k, v in steps[0].items() if v}}


# offline-chain: the raw nuScenes layout's version directory, and the port's
# offline tools in the order a user runs them, each a process of its own
RAW_VERSION = "v1.0-trainval"
OFFLINE_TOOLS = ("create_data", "gen_depth_gt", "gen_seg_gt",
                 "precompute_rays")
OFFLINE_TIMEOUT_S = 300


def write_raw_nuscenes(root: str, grid_shape, seed: int = 1) -> None:
    """The tree's 8 key frames over 2 scenes (its rig, poses and sizes) as
    a raw nuScenes layout under `root`: the JSON tables of RAW_VERSION,
    1600x900 JPEGs, lidar sweeps of TREE_LIDAR_POINTS points, uint8
    lidarseg labels (32 classes) and occupancy labels of `grid_shape`."""
    import numpy as np

    from preworld_tpu_torch.data import DEFAULT_CAMS

    rng = np.random.default_rng(seed)
    tables = {k: [] for k in ("scene", "sample", "sample_data",
                              "calibrated_sensor", "ego_pose", "sensor",
                              "sample_annotation")}
    for s in range(TREE_SCENES):
        tables["scene"].append({"token": f"sc{s}", "name": f"scene-{s:04d}"})
    tables["sensor"].append({"token": "sens_lidar", "channel": "LIDAR_TOP"})
    tables["calibrated_sensor"].append({
        "token": "cs_lidar", "sensor_token": "sens_lidar",
        "rotation": [1.0, 0.0, 0.0, 0.0], "translation": [0.94, 0.0, 1.84],
        "camera_intrinsic": []})
    for cam, a in zip(DEFAULT_CAMS, TREE_CAM_YAWS):
        rot, tr = tree_camera(a)
        tables["sensor"].append({"token": f"sens_{cam}", "channel": cam})
        tables["calibrated_sensor"].append({
            "token": f"cs_{cam}", "sensor_token": f"sens_{cam}",
            "rotation": rot, "translation": tr,
            "camera_intrinsic": TREE_INTRIN})
        os.makedirs(os.path.join(root, "samples", cam))
    for sub in ("samples/LIDAR_TOP", f"lidarseg/{RAW_VERSION}", RAW_VERSION):
        os.makedirs(os.path.join(root, sub))
    for t in range(TREE_FRAMES):
        scene, _, ego_rot, ego_tr = tree_ego_pose(t)
        token = f"tok{t:03d}"
        tables["sample"].append({"token": token, "scene_token": f"sc{scene}",
                                 "timestamp": 1_533_000_000_000_000
                                 + 500_000 * t})
        tables["ego_pose"].append({"token": f"pose{t}", "rotation": ego_rot,
                                   "translation": ego_tr})
        lidar = f"samples/LIDAR_TOP/{token}__LIDAR_TOP.pcd.bin"
        tables["sample_data"].append({
            "token": f"sd_lidar{t}", "sample_token": token,
            "calibrated_sensor_token": "cs_lidar",
            "ego_pose_token": f"pose{t}", "filename": lidar,
            "is_key_frame": True})
        pts = np.empty((TREE_LIDAR_POINTS, 5), np.float32)
        pts[:, :2] = rng.uniform(-50.0, 50.0, (TREE_LIDAR_POINTS, 2))
        pts[:, 2] = rng.uniform(-2.0, 4.0, TREE_LIDAR_POINTS)
        pts[:, 3] = rng.uniform(0, 255, TREE_LIDAR_POINTS)
        pts[:, 4] = rng.integers(0, 32, TREE_LIDAR_POINTS)
        pts.tofile(os.path.join(root, lidar))
        rng.integers(0, 32, TREE_LIDAR_POINTS, dtype=np.uint8).tofile(
            os.path.join(root, "lidarseg", RAW_VERSION,
                         f"sd_lidar{t}_lidarseg.bin"))
        for cam in DEFAULT_CAMS:
            name = f"samples/{cam}/{token}__{cam}.jpg"
            tree_image(rng).save(os.path.join(root, name), quality=90)
            tables["sample_data"].append({
                "token": f"sd_{cam}{t}", "sample_token": token,
                "calibrated_sensor_token": f"cs_{cam}",
                "ego_pose_token": f"pose{t}", "filename": name,
                "is_key_frame": True})
        occ = os.path.join(root, "gts", f"scene-{scene:04d}", token)
        os.makedirs(occ)
        np.savez_compressed(os.path.join(occ, "labels.npz"),
                            **tree_labels(rng, tuple(grid_shape)))
    for name, rows in tables.items():
        with open(os.path.join(root, RAW_VERSION, f"{name}.json"), "w") as fh:
            json.dump(rows, fh)


def run_offline_tool(name: str, argv: list) -> float:
    """`python3 -m preworld_tpu_torch.tools.<name> argv` in a process of its
    own; exit 0 or fail. Returns its seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", f"preworld_tpu_torch.tools.{name}", *argv],
        cwd=root, capture_output=True, text=True, timeout=OFFLINE_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"offline-chain: {name} exit {run.returncode}: "
                             f"{run.stderr[-2000:]}")
    status("offline-chain", f"{name} {secs:.1f} s: "
           f"{run.stdout.strip().splitlines()[-1]}")
    return secs


def run_offline_chain(root: str) -> dict:
    """The raw layout, the port's four offline tools on it, the pretrain
    config's dataset on what they wrote, with and without the ray cache,
    and one pretrain train step on the card from the sample."""
    import numpy as np

    from preworld_tpu_torch.data import collate
    from preworld_tpu_torch.geometry.rays import RAY_DIM
    from preworld_tpu_torch.ops import _cuda
    from preworld_tpu_torch.train import make_train_step
    from preworld_tpu_torch.train.builder import build_grid_config
    from preworld_tpu_torch.train.loop import batch_to
    from preworld_tpu_torch.utils import Config

    conf = Config.fromfile(PRETRAIN_CONFIG)
    grid = tuple(int(v) for v in build_grid_config(conf["grid_config"]).size)
    t0 = time.perf_counter()
    write_raw_nuscenes(root, grid)
    out = {"raw_write_s": time.perf_counter() - t0}
    ann = os.path.join(root, TREE_PKL)
    scenes = ",".join(f"scene-{s:04d}" for s in range(TREE_SCENES))
    argv = {
        "create_data": ["--root-path", root, "--version", RAW_VERSION,
                        "--occ-gt-root", "gts", "--out-prefix", "bevdetv2",
                        "--train-scenes", scenes, "--val-scenes", scenes],
        "gen_depth_gt": ["--ann-file", ann, "--data-root", root, "--out-dir",
                         os.path.join(root, "depth_gt"), "--workers", "4"],
        "gen_seg_gt": ["--ann-file", ann, "--data-root", root, "--seg-root",
                       os.path.join(root, "lidarseg", RAW_VERSION),
                       "--out-dir", os.path.join(root, "seg_gt"),
                       "--workers", "4"],
        "precompute_rays": [ann, "--depth-gt-path",
                            os.path.join(root, "depth_gt"),
                            "--semantic-gt-path", os.path.join(root, "seg_gt"),
                            "--out-dir", os.path.join(root, "rays_cache"),
                            "--data-root", root, "--workers", "8"]}
    out["tool_s"] = {name: run_offline_tool(name, argv[name])
                     for name in OFFLINE_TOOLS}
    images = TREE_FRAMES * len(TREE_CAM_YAWS)
    counts = {d: len(os.listdir(os.path.join(root, d)))
              for d in ("depth_gt", "seg_gt", "rays_cache")}
    if set(counts.values()) != {images}:
        raise AssertionError(f"offline-chain: files {counts}, expected "
                             f"{images} of each")
    out["depth_points"] = sum(
        os.path.getsize(os.path.join(root, "depth_gt", f))
        for f in os.listdir(os.path.join(root, "depth_gt"))) // 12
    index = TREE_FRAMES // TREE_SCENES - 1
    samples = {}
    for name, kw in (("sample", {}),
                     ("cached_sample",
                      {"ray_cache_path": os.path.join(root, "rays_cache")})):
        ds = tree_dataset(conf, root, is_train=True, **kw)
        t0 = time.perf_counter()
        s = ds[index]
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        samples[name] = s
        bad = {k: v.shape for k, v in s.items()
               if v.dtype.kind == "f" and not np.isfinite(v).all()}
        if bad or s["rays"].shape != (ds.max_ray_nums, RAY_DIM) \
                or not (s["gt_depth"] > 0).any() or ds.max_ray_nums != 38400:
            raise AssertionError(f"offline-chain {name}: non-finite {bad}, "
                                 f"rays {s['rays'].shape}, lidar depth "
                                 f"{float((s['gt_depth'] > 0).mean())}")
    out["lidar_depth_share"] = float((samples["sample"]["gt_depth"] > 0)
                                     .mean())
    state = config_state(conf)
    expected = EXPECTED_PER_STEP_REMAT if state.model.cfg.remat \
        else EXPECTED_PER_STEP
    batch = batch_to(collate([samples["sample"]]), "cuda")
    step = make_train_step(conf["ema"]["decay"])
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    _, metrics = step(state, batch, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    launches = dict(_cuda.launches)
    losses = {k: float(metrics[k]) for k in PRETRAIN_LOSSES}
    if launches != expected or not all(map(math.isfinite, losses.values())):
        raise AssertionError(f"offline-chain: step launches {launches}, "
                             f"losses {losses}")
    out.update(losses=losses,
               launches_per_step={k: v for k, v in launches.items() if v})
    return out


def by_op_difference(a: dict, b: dict) -> dict:
    """{op: (a's, b's)} of the ops whose byte counts differ."""
    return {op: (a.get(op, 0), b.get(op, 0)) for op in sorted(set(a) | set(b))
            if a.get(op, 0) != b.get(op, 0)}


def reference_bf16_pair(**over):
    """(CPU bf16 model, card bf16 model) of the reference config (with
    `over`) from the same seeded weights."""
    from preworld_tpu_torch.models import PreWorld
    from preworld_tpu_torch.utils import init_weights

    cfg = dataclasses.replace(reference_config(**over), dtype=torch.bfloat16)
    cpu = PreWorld(cfg)
    init_weights(cpu, seed=1, fan_in=True)
    card = PreWorld(cfg)
    card.load_state_dict(cpu.state_dict())
    return cpu, card.cuda()


def check_reference_counts() -> dict:
    """The reference config on the card (bf16, kernels) against the CPU in
    f32 (plain twins): the same FLOP total and parameters read; in bf16
    on both: the forward's bytes, transcendentals, FLOPs and parameters
    read, and `count_step`'s FLOPs of the finetune and the pretrain step,
    integer for integer."""
    from preworld_tpu_torch.data import (
        synthetic_batch,
        tiny_nerf_config,
        to_device,
    )
    from preworld_tpu_torch.models import PreWorld
    from preworld_tpu_torch.utils.flops import (
        count_forward,
        count_step,
        loss_backward,
    )

    cpu, card = reference_bf16_pair()
    ref = PreWorld(reference_config())
    ref.load_state_dict(cpu.state_dict())
    b = synthetic_batch(cpu.cfg, 1, seed=7, with_labels=False)
    f32 = count_forward(ref.eval(), to_device(b, "cpu"))
    fc = count_forward(cpu.eval(), to_device(b, "cpu"))
    fg = count_forward(card.eval(), to_device(b, "cuda"))
    same = (fg["flops"] == f32["flops"] and fg["params"] == f32["params"]
            and f32["kernel_flops"] == 0 and fg["kernel_flops"] > 0)
    status("flops", f"reference config: card {fg['flops']} (aten "
           f"{fg['aten_flops']} + kernels {fg['kernel_flops']}), CPU "
           f"{f32['flops']} (aten); params read {fg['params']} / "
           f"{f32['params']}; equal {same}")
    if not same:
        raise AssertionError("flops: the card's reference count is not the "
                             "CPU's")
    out = {"card": fg["flops"], "cpu": f32["flops"],
           "card_kernel_flops": fg["kernel_flops"], "params": fg["params"],
           "kernels": fg["kernels"]}
    keys = ("flops", "bytes", "aten_bytes", "kernel_bytes", "transcendentals",
            "params")
    out["forward"] = {k: [fg[k], fc[k]] for k in keys}
    out["forward"]["bytes_by_kernel"] = [fg["bytes_by_kernel"],
                                         fc["bytes_by_kernel"]]
    # by op, cuDNN's eval BatchNorm is `cudnn_batch_norm` on the card and
    # `native_batch_norm` on the CPU: the totals must agree
    out["forward"]["ops_named_apart"] = by_op_difference(fg["bytes_by_op"],
                                                         fc["bytes_by_op"])
    if any(fg[k] != fc[k] for k in keys) or \
            fg["bytes_by_kernel"] != fc["bytes_by_kernel"]:
        raise AssertionError(f"flops: reference bf16 forward, card against "
                             f"CPU: {out['forward']}")
    for stage, over in (("finetune", {}),
                        ("pretrain", dict(if_post_finetune=False,
                                          if_render=True,
                                          use_lss_depth_loss=True,
                                          nerf=tiny_nerf_config()))):
        cpu, card = reference_bf16_pair(**over)
        b = synthetic_batch(cpu.cfg, 1, seed=7, with_labels=True)
        sc = count_step(loss_backward(cpu, to_device(b, "cpu"),
                                      torch.Generator().manual_seed(11)), cpu)
        sg = count_step(loss_backward(card, to_device(b, "cuda"),
                                      torch.Generator().manual_seed(11)),
                        card)
        out[f"{stage}_step"] = {
            "card": sg["flops"], "cpu": sc["flops"],
            "card_kernel_flops": sg["kernel_flops"],
            "card_kernels": {k: v["launches"]
                             for k, v in sg["kernels"].items()}}
        if sg["flops"] != sc["flops"] or not sg["kernel_flops"] > 0 or \
                sc["kernel_flops"] != 0:
            raise AssertionError(
                f"flops: reference {stage} step, card against CPU: "
                f"{out[f'{stage}_step']}; by op (card, CPU) where they "
                f"differ: {by_op_difference(sg['aten_by_op'], sc['aten_by_op'])}")
    return out


def count_flagship_finetune_step() -> dict:
    """`count_step` of the flagship finetune step as `train-flagship` runs
    it (the config file's model, remat off, 512 rays, seed 0)."""
    from preworld_tpu_torch.data import synthetic_batch, to_device
    from preworld_tpu_torch.train import build_model
    from preworld_tpu_torch.utils import Config, init_weights
    from preworld_tpu_torch.utils.flops import count_step, loss_backward

    model = build_model(Config.fromfile(FINETUNE_CONFIG))
    model.cfg = dataclasses.replace(model.cfg, remat=False)
    init_weights(model, seed=0, fan_in=True)
    batch = to_device(synthetic_batch(model.cfg, 1, seed=0, with_labels=True,
                                      num_rays=512), "cuda")
    res = count_step(loss_backward(model, batch,
                                   torch.Generator().manual_seed(0)), model)
    launches = {k: v["launches"] for k, v in res["kernels"].items()}
    if launches != {k: v for k, v in EXPECTED_PER_STEP.items() if v}:
        raise AssertionError(f"flops: flagship finetune step launches "
                             f"{launches}")
    return res


def run_flops(bench_entry, train_flagship) -> dict:
    """`utils.flops.count_forward` on the card: the flagship predict
    (params, aten and kernel FLOPs, each kernel's launches and FLOPs, the
    bytes accessed and transcendentals: aten's, the kernels', each kernel's
    and the 10 largest ops; the bench entry's `tflops_fwd` and
    `gb_accessed_fwd` the same counts, where that phase ran), the
    reference config on the card (bf16, kernels) and the CPU (f32, plain
    twins), whose totals and parameters read must be equal, and in bf16
    on both (`check_reference_counts`); then `count_step` of the flagship
    finetune step beside `train-flagship`'s step time."""
    from preworld_tpu_torch.data import synthetic_batch, to_device
    from preworld_tpu_torch.models import PreWorld, PreWorldConfig
    from preworld_tpu_torch.utils import init_weights
    from preworld_tpu_torch.utils.flops import count_forward

    cfg = PreWorldConfig(if_post_finetune=True, dtype=torch.bfloat16)
    model = PreWorld(cfg).eval()
    init_weights(model, seed=0)
    model.cuda()
    batch = to_device(synthetic_batch(cfg, 1, seed=0, with_labels=False),
                      "cuda")
    t0 = time.perf_counter()
    flag = count_forward(model, batch)
    count_s = time.perf_counter() - t0
    del model, batch
    torch.cuda.empty_cache()
    launches = {k: v["launches"] for k, v in flag["kernels"].items()}
    if launches != {k: v for k, v in EXPECTED_PER_REQUEST.items() if v}:
        raise AssertionError(f"flops: flagship launches {launches}")
    if bench_entry is not None and (
            round(bench_entry["tflops_fwd"] * 1e12) != flag["flops"]
            or round(bench_entry["gb_accessed_fwd"] * 1e9) != flag["bytes"]):
        raise AssertionError(f"flops: bench entry tflops_fwd "
                             f"{bench_entry['tflops_fwd']}, gb_accessed_fwd "
                             f"{bench_entry['gb_accessed_fwd']}; count "
                             f"{flag['flops']} FLOPs, {flag['bytes']} bytes")
    status("flops", f"flagship predict: params {flag['params']} "
           f"({flag['params_built']} built), {flag['flops'] / 1e9:.3f} "
           f"GFLOPs = aten {flag['aten_flops'] / 1e9:.3f} + kernels "
           f"{flag['kernel_flops'] / 1e9:.3f}; " + ", ".join(
               f"{KERNELS[k][0]} {v['launches']} launches "
               f"{v['flops'] / 1e9:.3f} GFLOPs"
               for k, v in flag["kernels"].items()))
    status("flops", f"flagship predict: {flag['bytes']} bytes accessed = "
           f"aten {flag['aten_bytes']} + kernels {flag['kernel_bytes']} ("
           + ", ".join(f"{KERNELS[k][0]} {v['bytes']} in {v['launches']} "
                       f"calls" for k, v in flag["kernels"].items())
           + f"); {flag['transcendentals']} transcendentals ("
           + ", ".join(f"{KERNELS[k][0]} {v['transcendentals']}"
                       for k, v in flag["kernels"].items())
           + f"); counted in {count_s:.1f} s")
    status("flops", "flagship predict, the 10 largest ops by bytes: "
           + ", ".join(f"{op} {n}" for op, n in
                       list(flag["bytes_by_op"].items())[:10]))
    if bench_entry is not None:
        status("flops", f"bench entry: gb_accessed_fwd "
               f"{bench_entry['gb_accessed_fwd']}, hbm_util "
               f"{bench_entry['hbm_util']} (equal to the count)")
    counts = check_reference_counts()
    fw = counts["forward"]
    status("flops", f"reference config in bf16, card / CPU: bytes "
           f"{fw['bytes']}, transcendentals {fw['transcendentals']}, FLOPs "
           f"{fw['flops']}; finetune step FLOPs "
           f"{[counts['finetune_step'][d] for d in ('card', 'cpu')]}, "
           f"pretrain step FLOPs "
           f"{[counts['pretrain_step'][d] for d in ('card', 'cpu')]}; equal")
    torch.cuda.empty_cache()
    step = count_flagship_finetune_step()
    torch.cuda.empty_cache()
    res = {"flagship": {k: v for k, v in flag.items()
                        if k not in ("aten_by_op", "bytes_by_op", "unread")},
           "flagship_top_ops": dict(list(flag["bytes_by_op"].items())[:10]),
           "count_s": count_s, "reference": counts,
           "finetune_step": {k: step[k] for k in ("flops", "aten_flops",
                                                   "kernel_flops",
                                                   "params_with_grad")}}
    res["finetune_step"]["kernels"] = {
        KERNELS[k][0]: v["flops"] for k, v in step["kernels"].items()}
    if train_flagship is not None:
        s = train_flagship["step_ms_2_3"] / 1e3
        res["finetune_step"]["step_s"] = s
        res["finetune_step"]["share_of_989e12"] = step["flops"] / s / BF16_FLOPS
    status("flops", f"flagship finetune step: {step['flops']} FLOPs (aten "
           f"{step['aten_flops']} + kernels {step['kernel_flops']})"
           + (f"; at train-flagship's {res['finetune_step']['step_s']:.4f} s "
              f"a step, {res['finetune_step']['share_of_989e12']:.4f} of "
              f"989e12" if train_flagship is not None else ""))
    return res


# the dev tools: the rows each prints, by its row key
DEV_PROBES = ("encode_3frames", "plus_vt_zerocost", "plus_viewtransform",
              "plus_bev_encoder", "full_predict")
DEV_TOOLS = {
    "bench_stages": ("probe", DEV_PROBES, ("ms", "delta_ms")),
    "bench_bytes": ("probe", DEV_PROBES,
                    ("gb", "delta_gb", "tflops", "delta_tflops")),
    "bench_swin": ("probe", ("swin_full_6cam", "swin_stage0_6cam")
                   + tuple(f"swin_block_stage{i}" for i in range(4)),
                   ("ms",)),
    "bench_nerf_bisect": ("stage", ("scatter_only_full", "scatter_5pct",
                                    "grad_base")
                          + tuple(f"grad_no_{t}" for t in (
                              "depth", "semantic", "color", "entropy",
                              "distortion")) + ("grad_trained",), ("ms",)),
}


def run_dev_tools(bench_entry, flops) -> dict:
    """The four dev tools at their flagship defaults on the card, in this
    process through their `main` (`bench_nerf_bisect --quick`): the card's
    line first, then every row, its numbers finite (times positive);
    `bench_bytes`' full_predict equal to the `flops` phase's count of the
    same request, where that phase ran. `bench_stages`' full_predict
    against the bench entry's least request time is reported, not gated."""
    import contextlib
    import importlib
    import io

    out = {}
    for tool, (key, names, numbers) in DEV_TOOLS.items():
        module = importlib.import_module(f"preworld_tpu_torch.tools.{tool}")
        argv = ["--quick"] if tool == "bench_nerf_bisect" else []
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            module.main(argv)
        seconds = time.perf_counter() - t0
        torch.cuda.empty_cache()
        lines = printed.getvalue().strip().splitlines()
        for ln in lines:
            print(f"  {tool}: {ln}", flush=True)
        rows = [json.loads(ln) for ln in lines[1:]]
        got = tuple(r[key] for r in rows)
        bad = [r for r in rows if not all(
            math.isfinite(r[k]) for k in numbers) or not all(
            r[k] > 0 for k in numbers if k in ("ms", "gb", "tflops"))]
        if got != names or bad or not lines[0].startswith("NVIDIA"):
            raise AssertionError(f"dev-tools: {tool} rows {got}, expected "
                                 f"{names}; not finite or not positive "
                                 f"{bad}; first line {lines[0]!r}")
        out[tool] = {"seconds": seconds,
                     "rows": {r[key]: {k: v for k, v in r.items()
                                       if k != key} for r in rows}}
        status("dev-tools", f"{tool}: {len(rows)} rows in {seconds:.1f} s")
    last = out["bench_bytes"]["rows"]["full_predict"]
    if flops is not None:
        want = flops["flagship"]
        same = (round(last["tflops"] * 1e12) == want["flops"]
                and round(last["gb"] * 1e9) == want["bytes"])
        status("dev-tools", f"bench_bytes full_predict {last['tflops']} "
               f"TFLOPs, {last['gb']} GB; the flops phase's count "
               f"{want['flops']} FLOPs, {want['bytes']} bytes; equal {same}")
        if not same:
            raise AssertionError("dev-tools: bench_bytes' full_predict is "
                                 "not the flops phase's count")
    ms = out["bench_stages"]["rows"]["full_predict"]["ms"]
    if bench_entry is not None:
        least = 1e3 / bench_entry["value"]
        out["full_predict_vs_bench"] = ms / least
        status("dev-tools", f"bench_stages full_predict {ms:.3f} ms; the "
               f"bench entry's least request {least:.3f} ms (ratio "
               f"{ms / least:.3f}; within 10 % {abs(ms / least - 1) <= 0.1};"
               f" reported, not gated)")
    return out


# ------------------------------------------ training across processes

# the multi-process phases: 2 ranks; over gloo on one card (cuda:0 shared),
# and where there are 2 cards or more, over NCCL with one card a rank
DIST_WORLD = 2
DIST_TIMEOUT_S = 900
# dist-reference: (n_data, n_seq, global batch, config overrides, density
# head bias) of the reference config's finetune and pretrain steps; the
# pretrain mesh splits each scene's 512 rays over 'seq'
DIST_REFERENCE = {
    "finetune": (2, 1, 2, dict(if_render=False, use_lss_depth_loss=False),
                 None),
    "pretrain": (1, 2, 1, dict(if_post_finetune=False, if_render=True,
                               use_lss_depth_loss=True),
                 PRETRAIN_REF_DENSITY_BIAS),
}
# dist-flagship: steps, the global batch (2 ranks at the finetune
# config's samples_per_gpu, 2) and its rays
DIST_FLAGSHIP_STEPS, DIST_FLAGSHIP_BATCH = 3, 4
# seq-flagship: steps of the pretrain config at 38400 rays
SEQ_FLAGSHIP_STEPS, SEQ_FLAGSHIP_RAYS = 2, 38400


def dist_layouts() -> list:
    """(backend, one card a rank) of each multi-process run: gloo with the
    ranks sharing cuda:0, then NCCL with cuda:rank where there are 2 cards
    or more (NCCL refuses two ranks on one card)."""
    layouts = [("gloo", False)]
    if torch.cuda.device_count() >= DIST_WORLD:
        layouts.append(("nccl", True))
    return layouts


def layout_name(backend: str, per_card: bool) -> str:
    return (f"{backend}, {DIST_WORLD} processes, "
            + ("one card each" if per_card else "sharing cuda:0"))


def dist_env(rank: int, port: int) -> dict:
    return dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                WORLD_SIZE=str(DIST_WORLD), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), GLOO_SOCKET_IFNAME="lo")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_all(procs, what: str, timeout: float) -> list:
    """Wait for every process; the first that fails (or the time limit)
    stops the others and fails `what`. Returns their (stdout, stderr)."""
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.perf_counter() - t0 > timeout:
                break
            time.sleep(0.5)
        outs = [p.communicate(timeout=30) if p.poll() is not None
                else ("", "") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{what}: rank {r} exited {p.returncode}"
                                 f"\n{out[-2000:]}\n{err[-6000:]}")
    return outs


def launch_dist_jobs(jobs, tmp: str, backend: str, per_card: bool) -> list:
    """Run `jobs` ((key, function name, kwargs)) in DIST_WORLD processes of
    this script (`--dist-worker`), ranks joined over `backend`; each rank's
    {key: result}."""
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "jobs.pkl"), "wb") as fh:
        pickle.dump({"jobs": jobs, "backend": backend,
                     "per_card": per_card}, fh)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker", tmp],
        env=dist_env(r, port), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(DIST_WORLD)]
    wait_all(procs, f"dist workers ({backend})", DIST_TIMEOUT_S)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(DIST_WORLD)]


def dist_worker(tmp: str) -> int:
    """A rank of `launch_dist_jobs`: joins the group, runs the jobs in
    order, saves their results."""
    import torch.distributed as dist

    rank = int(os.environ["RANK"])
    with open(os.path.join(tmp, "jobs.pkl"), "rb") as fh:
        spec = pickle.load(fh)
    device = torch.device(f"cuda:{rank if spec['per_card'] else 0}")
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        spec["backend"], rank=rank, world_size=DIST_WORLD,
        init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}")
    out = {key: globals()[name](device, **kw)
           for key, name, kw in spec["jobs"]}
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def params_digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for _, p in sorted(model.named_parameters()):
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def bn_stats(model) -> dict:
    return {n: b.detach().float().cpu().clone()
            for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def stats_rel_l2(got: dict, want: dict) -> float:
    num = math.sqrt(sum(float((got[k] - w).pow(2).sum())
                        for k, w in want.items()))
    return num / math.sqrt(sum(float(w.pow(2).sum()) for w in want.values()))


def grad_cosines(g: dict, gw: dict, live: list) -> tuple:
    """(whole-gradient cosine, median per-tensor cosine, {name: cosine}) of
    `g` against `gw` over the `live` tensors."""
    cos = {k: float(torch.nn.functional.cosine_similarity(
        g[k].reshape(-1).double(), gw[k].reshape(-1).double(), dim=0))
        for k in live}
    flat = torch.nn.functional.cosine_similarity(
        torch.cat([g[k].reshape(-1) for k in live]).double(),
        torch.cat([gw[k].reshape(-1) for k in live]).double(), dim=0)
    return float(flat), statistics.median(cos.values()), cos


def dist_reference_model(kind: str, device):
    """The reference config's model for `kind` ("finetune" / "pretrain"),
    bf16, 6 cameras, the weights of train-reference (seed 1), on
    `device`; and the global batch."""
    from preworld_tpu_torch.data import synthetic_batch, tiny_nerf_config
    from preworld_tpu_torch.models import PreWorld
    from preworld_tpu_torch.utils import init_weights

    _, _, batch, over, bias = DIST_REFERENCE[kind]
    if kind == "pretrain":
        over = dict(over, nerf=tiny_nerf_config())
    cfg = reference_config(num_cams=6, dtype=torch.bfloat16, **over)
    model = PreWorld(cfg)
    init_weights(model, seed=1, fan_in=True)
    if bias is not None:
        with torch.no_grad():
            model.density_mlp.Dense_1.bias.fill_(bias)
    return model.to(device), synthetic_batch(cfg, batch, seed=7,
                                             with_labels=True)


def dist_reference_rank(device, kind: str) -> dict:
    """A rank's train step of dist-reference: its rows (and, pretrain, its
    half of the rays) of the global batch, on the (n_data, n_seq) mesh."""
    from preworld_tpu_torch import parallel
    from preworld_tpu_torch.data import to_device
    from preworld_tpu_torch.ops import _cuda
    from preworld_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    n_data, n_seq = DIST_REFERENCE[kind][:2]
    mesh = parallel.make_mesh(n_data, n_seq)
    model, batch = dist_reference_model(kind, device)
    local = to_device(parallel.shard_batch(mesh, batch), device)
    state = create_train_state(model, make_optimizer(model.parameters()),
                               10560)
    _cuda.reset_launches()
    parallel.counts.clear()
    _, metrics = make_train_step(mesh=mesh)(
        state, local, torch.Generator().manual_seed(11))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.float().cpu()
                      for n, p in model.named_parameters()
                      if p.grad is not None},
            "stats": bn_stats(model), "digest": params_digest(model),
            "launches": dict(_cuda.launches),
            "collectives": dict(parallel.counts),
            "rays": parallel.seq_rays(mesh, local["rays"])[0].shape[1]}


def dist_reference_oracle(kind: str) -> dict:
    """The one-process step of dist-reference at the global batch, and its
    calibration: the same step from the bf16-rounded weights."""
    out = {}
    for name in ("one", "calib"):
        model, batch = dist_reference_model(kind, "cuda")
        if name == "calib":
            with torch.no_grad():
                for p in model.parameters():
                    p.copy_(p.to(torch.bfloat16).float())
        metrics, grads = one_train_step(model, batch, "cuda")
        out[name] = {"metrics": metrics, "grads": grads,
                     "stats": bn_stats(model)}
        del model
        torch.cuda.empty_cache()
    return out


def check_dist_reference(oracle: dict, ranks: list, kind: str) -> dict:
    """The ranks' step against the one-process step, under train-
    reference's gates calibrated by two one-process runs: each loss within
    TRAIN_TOL["loss_rel"], the gradient norm within
    TRAIN_TOL["grad_norm_rel"], the whole-gradient and median per-tensor
    cosines at most COS_MARGIN below the calibration's, the BatchNorm
    running statistics no further (rel-L2) from the one-process ones than
    the calibration's; every rank's metrics and parameters alike."""
    want, calib, got = oracle["one"], oracle["calib"], ranks[0]
    wm, gm = want["metrics"], got["metrics"]
    gw = want["grads"]
    total = math.sqrt(sum(float((g ** 2).sum()) for g in gw.values()))
    live = [k for k, g in gw.items() if float(g.norm()) > 1e-4 * total]
    global_cos, median_cos, cos = grad_cosines(got["grads"], gw, live)
    calib_global, calib_median, _ = grad_cosines(calib["grads"], gw, live)
    res = {
        "loss_rel": max(abs(gm[k] - wm[k]) / abs(wm[k])
                        for k in wm if k != "grad_norm"),
        "calib_loss_rel": max(abs(calib["metrics"][k] - wm[k]) / abs(wm[k])
                              for k in wm if k != "grad_norm"),
        "grad_norm_rel": abs(gm["grad_norm"] - wm["grad_norm"])
        / wm["grad_norm"],
        "calib_grad_norm_rel": abs(calib["metrics"]["grad_norm"]
                                   - wm["grad_norm"]) / wm["grad_norm"],
        "global_cos": global_cos, "median_cos": median_cos,
        "calib_global_cos": calib_global, "calib_median_cos": calib_median,
        "bn_rel_l2": stats_rel_l2(got["stats"], want["stats"]),
        "calib_bn_rel_l2": stats_rel_l2(calib["stats"], want["stats"]),
        "worst": {k: cos[k] for k in sorted(cos, key=cos.get)[:3]},
        "rays_per_rank": got["rays"], "collectives": got["collectives"],
        "launches": {k: v for k, v in got["launches"].items() if v},
    }
    same = all(r["digest"] == got["digest"] and r["metrics"] == gm
               for r in ranks)
    ok = (res["loss_rel"] <= TRAIN_TOL["loss_rel"]
          and res["grad_norm_rel"] <= TRAIN_TOL["grad_norm_rel"]
          and global_cos >= calib_global - COS_MARGIN
          and median_cos >= calib_median - COS_MARGIN
          and res["bn_rel_l2"] <= res["calib_bn_rel_l2"] and same
          and set(gm) == set(wm))
    if not ok:
        raise AssertionError(f"dist-reference {kind}: {res}; ranks alike "
                             f"{same}")
    return res


def flagship_dist_state(device, config: str, remat: bool):
    """`build_model` of `config` on `device` with train-flagship's weights
    (seed 0), remat as given, and its train state."""
    from preworld_tpu_torch.train import (
        build_model,
        create_train_state,
        make_optimizer,
    )
    from preworld_tpu_torch.utils import Config, init_weights

    conf = Config.fromfile(config)
    model = build_model(conf, device=device)
    model.cfg = dataclasses.replace(model.cfg, remat=remat)
    init_weights(model, seed=0, fan_in=True)
    return conf, create_train_state(model, make_optimizer(
        model.parameters()), conf["ema"]["init_updates"])


def flagship_dist_steps(device, config: str, batch: int, num_rays: int,
                        steps: int, remat: bool, mesh=None) -> dict:
    """`steps` train steps of `config`'s model on one synthetic batch of
    `batch` scenes (seed 0; this rank's rows under `mesh`; one batch, as
    making a flagship sample on the host takes ~1 s): metrics, ms, peak
    bytes, launches and collectives a step, the gradient all-reduce's ms
    and bytes, the parameters' digest."""
    from preworld_tpu_torch import parallel
    from preworld_tpu_torch.data import synthetic_batch, to_device
    from preworld_tpu_torch.ops import _cuda
    from preworld_tpu_torch.train import make_train_step, train_state

    conf, state = flagship_dist_state(device, config, remat)
    b = to_device(parallel.shard_batch(mesh, synthetic_batch(
        state.model.cfg, batch, seed=0, with_labels=True, num_rays=num_rays)),
        device)
    reduces = []
    allreduce = train_state.allreduce_grads

    def timed_allreduce(params, group):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        nbytes = allreduce(params, group)
        torch.cuda.synchronize(device)
        reduces.append(((time.perf_counter() - t0) * 1e3, nbytes))
        return nbytes

    step = make_train_step(conf["ema"]["decay"], mesh=mesh)
    gen = torch.Generator().manual_seed(0)
    out = {"metrics": [], "ms": [], "peak_bytes": [], "launches": [],
           "collectives": []}
    train_state.allreduce_grads = timed_allreduce
    try:
        for _ in range(steps):
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            _cuda.reset_launches()
            parallel.counts.clear()
            t0 = time.perf_counter()
            _, metrics = step(state, b, gen)
            metrics = {k: float(v) for k, v in metrics.items()}
            torch.cuda.synchronize(device)
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["metrics"].append(metrics)
            out["peak_bytes"].append(torch.cuda.max_memory_allocated(device))
            out["launches"].append({k: v for k, v in _cuda.launches.items()
                                    if v})
            out["collectives"].append(dict(parallel.counts))
            for k, v in metrics.items():
                if not math.isfinite(v):
                    raise AssertionError(f"{config}: {k} = {v}")
    finally:
        train_state.allreduce_grads = allreduce
    out["allreduce_ms"] = [ms for ms, _ in reduces]
    out["allreduce_bytes"] = [n for _, n in reduces]
    out["digest"] = params_digest(state.model)
    out["rays_per_rank"] = int(parallel.seq_rays(
        mesh, torch.empty(1, num_rays))[0].shape[1])
    return out


def dist_flagship_rank(device) -> dict:
    from preworld_tpu_torch import parallel

    return flagship_dist_steps(
        device, FINETUNE_CONFIG, DIST_FLAGSHIP_BATCH, 512,
        DIST_FLAGSHIP_STEPS, True, parallel.make_mesh(DIST_WORLD, 1))


def seq_flagship_rank(device) -> dict:
    from preworld_tpu_torch import parallel

    return flagship_dist_steps(
        device, PRETRAIN_CONFIG, 1, SEQ_FLAGSHIP_RAYS, SEQ_FLAGSHIP_STEPS,
        True, parallel.make_mesh(1, DIST_WORLD))


def check_dist_losses(name: str, ranks: list, want: list) -> dict:
    """Every step's losses of rank 0 within TRAIN_TOL["loss_rel"] of the
    one-process run's and its gradient norm within
    TRAIN_TOL["grad_norm_rel"] (dist-reference's gates); every rank's
    metrics and final parameters alike."""
    got = ranks[0]["metrics"]
    loss_rel = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got, want)
                   for k in w if k != "grad_norm")
    norm_rel = max(abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                   for g, w in zip(got, want))
    same = all(r["digest"] == ranks[0]["digest"] and r["metrics"] == got
               for r in ranks)
    if loss_rel > TRAIN_TOL["loss_rel"] or not same or \
            norm_rel > TRAIN_TOL["grad_norm_rel"] or \
            [set(g) for g in got] != [set(w) for w in want]:
        raise AssertionError(f"{name}: loss rel {loss_rel}, grad norm rel "
                             f"{norm_rel}, ranks alike {same}")
    return {"loss_rel": loss_rel, "grad_norm_rel": norm_rel}


def dist_summary(ranks: list) -> dict:
    """Rank 0's ms a step (the second on), peak bytes, all-reduce ms and
    bytes, collectives and launches a step; the peak of each rank."""
    r = ranks[0]
    return {"step_ms": r["ms"], "step_ms_2_on": statistics.mean(r["ms"][1:]),
            "peak_bytes_per_rank": [max(x["peak_bytes"]) for x in ranks],
            "allreduce_ms": r["allreduce_ms"],
            "allreduce_bytes": r["allreduce_bytes"][0],
            "collectives_per_step": r["collectives"][-1],
            "launches_per_step": r["launches"][-1],
            "rays_per_rank": r["rays_per_rank"]}


def run_dist(tmp: str) -> dict:
    """dist-reference, dist-flagship and seq-flagship: the one-process
    oracles on this process, then every layout's ranks (one launch each,
    the phases' jobs in order). Returns {phase: {layout: result}} with the
    failures of a phase raised when it is checked."""
    oracle = {kind: dist_reference_oracle(kind) for kind in DIST_REFERENCE}
    flagship = flagship_dist_steps("cuda", FINETUNE_CONFIG,
                                   DIST_FLAGSHIP_BATCH, 512,
                                   DIST_FLAGSHIP_STEPS, True)
    torch.cuda.empty_cache()
    dense = flagship_dist_steps("cuda", PRETRAIN_CONFIG, 1,
                                SEQ_FLAGSHIP_RAYS, SEQ_FLAGSHIP_STEPS, True)
    torch.cuda.empty_cache()
    jobs = [(kind, "dist_reference_rank", {"kind": kind})
            for kind in DIST_REFERENCE]
    jobs += [("flagship", "dist_flagship_rank", {}),
             ("seq", "seq_flagship_rank", {})]
    runs = {}
    for backend, per_card in dist_layouts():
        name = layout_name(backend, per_card)
        status("dist", f"layout: {name}")
        t0 = time.perf_counter()
        runs[name] = launch_dist_jobs(jobs, os.path.join(tmp, backend),
                                      backend, per_card)
        status("dist", f"{name}: ranks done in "
               f"{time.perf_counter() - t0:.1f} s")
    if len(runs) == 1:
        status("dist", f"nccl: not run ({torch.cuda.device_count()} card)")
    return {"oracle": oracle, "flagship": flagship, "dense": dense,
            "runs": runs}


def check_dist_reference_phase(d: dict) -> dict:
    return {name: {kind: check_dist_reference(
        d["oracle"][kind], [r[kind] for r in ranks], kind)
        for kind in DIST_REFERENCE} for name, ranks in d["runs"].items()}


def check_dist_flagship_phase(d: dict) -> dict:
    """Launches of a remat finetune step in every rank (K1b / K2b 24 each),
    the losses of the one-process run at batch 4, the summary."""
    out = {"one_process_step_ms": d["flagship"]["ms"],
           "one_process_peak_bytes": max(d["flagship"]["peak_bytes"])}
    for name, ranks in d["runs"].items():
        rs = [r["flagship"] for r in ranks]
        bad = [(i, s) for r in rs for i, s in enumerate(r["launches"])
               if s != {k: v for k, v in EXPECTED_PER_STEP_REMAT.items()
                        if v}]
        if bad:
            raise AssertionError(f"dist-flagship {name}: launches {bad[0]}")
        out[name] = dict(check_dist_losses(
            f"dist-flagship {name}", rs, d["flagship"]["metrics"]),
            **dist_summary(rs))
    return out


def check_seq_flagship_phase(d: dict) -> dict:
    """Each rank renders half the rays; the six losses of the dense
    one-process step; peak bytes beside the dense run's."""
    out = {"dense_step_ms": d["dense"]["ms"],
           "dense_peak_bytes": max(d["dense"]["peak_bytes"])}
    for name, ranks in d["runs"].items():
        rs = [r["seq"] for r in ranks]
        if rs[0]["rays_per_rank"] != SEQ_FLAGSHIP_RAYS // DIST_WORLD or \
                set(PRETRAIN_LOSSES) - set(rs[0]["metrics"][0]):
            raise AssertionError(f"seq-flagship {name}: rays "
                                 f"{rs[0]['rays_per_rank']}, metrics "
                                 f"{sorted(rs[0]['metrics'][0])}")
        out[name] = dict(check_dist_losses(
            f"seq-flagship {name}", rs, d["dense"]["metrics"]),
            **dist_summary(rs))
    return out


def run_cli_dist(tmp: str) -> dict:
    """The train CLI under torchrun: 2 processes of the finetune config
    (`--synthetic --epochs 1 --max-iters 2`), on cuda:0 over gloo (and, with
    2 cards or more, one card each over NCCL): exit 0, one JSON line,
    exactly one checkpoint; then `--auto-resume` for one more iteration."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for backend, per_card in dist_layouts():
        name = layout_name(backend, per_card)
        work = os.path.join(tmp, f"cli_dist_{backend}")
        device = [] if per_card else ["--device", "cuda:0"]
        runs = []
        for extra in (["--max-iters", "2"],
                      ["--max-iters", "1", "--auto-resume"]):
            cmd = [sys.executable, "-m", "torch.distributed.run",
                   "--nproc_per_node", str(DIST_WORLD), "--master_port",
                   str(free_port()), "-m", "preworld_tpu_torch.tools.train",
                   FINETUNE_CONFIG, "--synthetic", "--epochs", "1",
                   "--work-dir", work, "--dist-backend", backend,
                   *device, *extra]
            t0 = time.perf_counter()
            p = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 env=dict(os.environ,
                                          GLOO_SOCKET_IFNAME="lo"))
            (stdout, _), = wait_all([p], f"cli-dist {name}", CLI_TIMEOUT_S)
            lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
            if len(lines) != 1:
                raise AssertionError(f"cli-dist {name}: JSON lines {lines}")
            res = json.loads(lines[0])
            res["seconds"] = time.perf_counter() - t0
            status("cli-dist", f"{name}: {lines[0]}")
            runs.append(res)
            if len(runs) == 1:
                first = sorted(os.listdir(os.path.join(work, "checkpoints")))
                if first != ["2.pt"]:
                    raise AssertionError(f"cli-dist {name}: checkpoints "
                                         f"{first} after 2 iterations")
        ckpts = sorted(os.listdir(os.path.join(work, "checkpoints")))
        if [r["step"] for r in runs] != [2, 3] or \
                ckpts != ["2.pt", "3.pt"] or not all(
                    math.isfinite(v) for r in runs
                    for v in r["metrics"].values()):
            raise AssertionError(f"cli-dist {name}: steps "
                                 f"{[r['step'] for r in runs]}, "
                                 f"checkpoints {ckpts}")
        out[name] = {"seconds": [r["seconds"] for r in runs],
                     "metrics": runs[-1]["metrics"], "checkpoints": ckpts}
    return out


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
    if sys.argv[1:2] == ["--dist-worker"]:
        return dist_worker(sys.argv[2])
    t_start = time.perf_counter()
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
        t0 = time.perf_counter()
        try:
            return fn()
        except Exception:  # reported below and fails the run
            traceback.print_exc()
            status(name, "FAILED")
            failures.append(name)
            return None
        finally:
            status(name, f"{time.perf_counter() - t0:.1f} s")

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
                  and r.get("all_empty", True)
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
                     ("flagship", run_flagship),
                     ("streaming-reference", check_streaming_reference),
                     ("aavt-reference",
                      lambda: check_reference(align_after_vt=True)),
                     ("bevstereo-reference", check_bevstereo_reference),
                     ("streaming-flagship", run_streaming_flagship)):
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
                     ("traj-reference", check_traj_reference),
                     ("traj-flagship", run_traj_flagship),
                     ("pretrain-traj-flagship", run_pretrain_traj_flagship),
                     ("bench-parts", run_bench_parts),
                     ("bench-entry", run_bench_entry),
                     ("flops", lambda: run_flops(runs.get("bench-entry"),
                                                 runs.get("train-flagship"))),
                     ("dev-tools", lambda: run_dev_tools(
                         runs.get("bench-entry"), runs.get("flops")))):
        runs[name] = phase(name, fn)
        if runs[name] is not None:
            status(name, "ok " + json.dumps(runs[name]))
        torch.cuda.empty_cache()
    # the data layer, the train loop with its checkpoints, and the eval,
    # on a nuScenes tree written into a temporary directory
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tree = os.path.join(tmp, "nuscenes")
        for name, fn in (
                ("data-flagship", lambda: run_data_flagship(tree)),
                ("train-loop-flagship",
                 lambda: run_train_loop_flagship(tree, tmp)),
                ("eval-reference", check_eval_reference),
                ("pretrain-loop-flagship",
                 lambda: run_pretrain_loop_flagship(tree, tmp)),
                ("offline-chain", lambda: run_offline_chain(
                    os.path.join(tmp, "raw_nuscenes"))),
                ("cli", lambda: run_cli(tmp))):
            runs[name] = phase(name, fn)
            if runs[name] is not None:
                status(name, "ok " + json.dumps(runs[name]))
            torch.cuda.empty_cache()
        # training across processes: the oracles here, then the ranks
        dist = phase("dist", lambda: run_dist(os.path.join(tmp, "dist")))
        torch.cuda.empty_cache()
        for name, fn in (("dist-reference", check_dist_reference_phase),
                         ("dist-flagship", check_dist_flagship_phase),
                         ("seq-flagship", check_seq_flagship_phase),
                         ("cli-dist", None)):
            if fn is None:
                runs[name] = phase(name, lambda: run_cli_dist(tmp))
            elif dist is None:
                status(name, "FAILED (the dist launch failed)")
                failures.append(name)
                continue
            else:
                runs[name] = phase(name, lambda fn=fn: fn(dist))
            if runs[name] is not None:
                status(name, "ok " + json.dumps(runs[name]))
            torch.cuda.empty_cache()
    status("done", f"all phases in {time.perf_counter() - t_start:.1f} s")
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
