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

Then one JSON line of per-kernel results, and last the device line
{"ok": true, "device": {...}}. TF32 is off for both matmuls and cuDNN
convolutions, so every f32 product is full f32.
"""

from __future__ import annotations

import dataclasses
import json
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
}
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
                        "plane_sweep_cost_hom": 2, "bev_pool_fused": 2}
# Swin-B stages at 512x1408, 6 images: (C, heads, Hp, Wp, H, W), ws 12
SWIN_STAGES = [(128, 4, 132, 360, 128, 352), (256, 8, 72, 180, 64, 176),
               (512, 16, 36, 96, 32, 88), (1024, 32, 24, 48, 16, 44)]
REQUESTS = 3


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


def check_reference():
    """Small config: card (bf16, kernels) against CPU (f32, plain)."""
    from preworld_tpu_torch.data import synthetic_batch, to_device
    from preworld_tpu_torch.geometry import GridConfig
    from preworld_tpu_torch.models import PreWorld, PreWorldConfig

    grid = GridConfig(x=(-8.0, 8.0, 0.8), y=(-8.0, 8.0, 0.8),
                      z=(-1.0, 5.4, 0.8), depth=(1.0, 9.0, 0.5))
    cfg = PreWorldConfig(grid=grid, input_size=(128, 352), num_cams=2,
                         swin_depths=(2, 2, 2, 2), if_post_finetune=True)
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
            "profile": profile_request(model, to_device(batches[0], "cuda"))}


def profile_request(model, batch, top: int = 15) -> dict:
    """Device time by kernel over one more predict request (torch.profiler),
    and the share of the request's wall time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.predict(batch)
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
    if failures:
        print(f"chip_smoke: FAILED phases: {failures}", file=sys.stderr)
        return 1

    kernels = []
    for name, (label, source, replaces) in KERNELS.items():
        rs = rows[name]
        kernels.append({
            "name": f"{label} {name}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": flag["launches"][name],
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
