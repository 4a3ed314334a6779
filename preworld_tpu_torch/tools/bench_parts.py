"""Per-stage microbenchmarks of the port, at the flagship shapes.

    python3 -m preworld_tpu_torch.tools.bench_parts \
        [cost_volume|nerf|pretrain_step|finetune_step|all] [--device cuda|cpu]

The port's counterpart of `tools/bench_parts.py`: the same stages, shapes
and inputs, on the card unless `--device cpu` is given (no card is an
error, never a fallback). The first line is the card's `nvidia-smi` name
and power limit; then one JSON line per stage, under the JAX tool's keys
(`stage`, and `ms` or `s`).

  cost_volume    BN 6, H 128, W 352, C 128, D 88, bf16 features and the JAX
                 tool's smooth warp as an f32 grid: `cost_volume_plain` (the
                 plain grid route, `models.depthnet.stereo_cost_volume`) and
                 `cost_volume_fused` (kernel K7,
                 `models.depthnet.stereo_cost_volume_fused`). The JAX tool's
                 third variant, its corner-table gather, is a TPU layout of
                 the plain route and is not ported.
  nerf           the render losses of 38400 rays on a 200x200x16 field,
                 forward (`nerf_render_fwd`) and the gradient in the three
                 fields (`nerf_render_bwd`).
  pretrain_step, finetune_step
                 one train step of `build_model` of the config file at batch
                 1 (38400 rays), with the modules' own initial weights.

Each stage runs once, then times 4 runs (3 train steps) whose float inputs
are offset by 1e-6 (i + 1), as the JAX tool varies them; each run ends in a
device synchronise, and the least time is printed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
STAGES = ("cost_volume", "nerf", "pretrain_step", "finetune_step")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, args, device, n: int = 4) -> float:
    """Least seconds of n runs of fn(*args) after one warm-up run, each
    with its float inputs offset by 1e-6 (i + 1)."""
    fn(*args)
    _sync(device)
    times = []
    for i in range(n):
        a2 = [a + 1e-6 * (i + 1) if a.is_floating_point() else a for a in args]
        t0 = time.perf_counter()
        fn(*a2)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return min(times)


def smooth_warp_grid(BN: int, D: int, H: int, W: int) -> np.ndarray:
    """The JAX tool's cost-volume warp, a mild shift and scale per depth,
    as a (BN, D*H, W, 2) f32 grid (part of it falls outside the image)."""
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    gx = np.zeros((BN, D, H, W), np.float32)
    gy = np.zeros((BN, D, H, W), np.float32)
    for d in range(D):
        shift = 30.0 / (1.0 + 0.5 * d)
        gx[:, d] = (xs + shift) / (W - 1) * 2 - 1
        gy[:, d] = (ys + 0.1 * shift) / (H - 1) * 2 - 1
    return np.stack([gx, gy], -1).reshape(BN, D * H, W, 2)


def bench_cost_volume(device, BN=6, H=128, W=352, C=128, D=88, seed=0):
    from ..models.depthnet import stereo_cost_volume, stereo_cost_volume_fused

    rng = np.random.default_rng(seed)
    prev = torch.from_numpy(rng.normal(size=(BN, H, W, C)).astype(np.float32))
    curr = torch.from_numpy(rng.normal(size=(BN, H, W, C)).astype(np.float32))
    args = [prev.to(device, torch.bfloat16), curr.to(device, torch.bfloat16),
            torch.from_numpy(smooth_warp_grid(BN, D, H, W)).to(device)]
    rows = []
    for name, fn in (("plain", stereo_cost_volume),
                     ("fused", stereo_cost_volume_fused)):
        s = timeit(lambda p, c, g, fn=fn: fn(p, c, g, 5.0), args, device)
        rows.append({"stage": f"cost_volume_{name}", "ms": s * 1e3})
    return rows


def bench_nerf(device, R=38400, X=200, Y=200, Z=16, seed=0):
    from ..models.nerf_head import NerfHeadConfig, nerf_head_losses

    cfg = NerfHeadConfig()
    rng = np.random.default_rng(seed)
    B = 1
    density = rng.normal(size=(B, X, Y, Z)).astype(np.float32)
    semantic = rng.normal(size=(B, X, Y, Z, 17)).astype(np.float32)
    color = rng.normal(size=(B, X, Y, Z, 3)).astype(np.float32)
    rays = np.zeros((B, R, 16), np.float32)
    rays[..., 2] = rng.uniform(1, 40, (B, R))  # depth
    rays[..., 3] = rng.integers(0, 17, (B, R))
    rays[..., 4:7] = rng.uniform(-2, 2, (B, R, 3))
    rays[..., 7:10] = rng.normal(size=(B, R, 3))
    rays[..., 13:16] = rng.uniform(0, 1, (B, R, 3))
    rays = torch.from_numpy(rays).to(device)
    bda = torch.eye(3, device=device).expand(B, 3, 3)

    def fwd(de, se, co):
        return sum(nerf_head_losses(de, se, co, rays, bda, cfg).values())

    def grad(de, se, co):
        ins = [t.detach().requires_grad_(True) for t in (de, se, co)]
        return torch.autograd.grad(fwd(*ins), ins)

    args = [torch.from_numpy(a).to(device) for a in (density, semantic, color)]
    with torch.no_grad():
        fwd_s = timeit(fwd, args, device)
    bwd_s = timeit(grad, args, device)
    return [{"stage": "nerf_render_fwd", "ms": fwd_s * 1e3},
            {"stage": "nerf_render_bwd", "ms": bwd_s * 1e3}]


def bench_train_step(config: str, name: str, device):
    batch, num_rays = 1, 38400
    from ..data import synthetic_batch, to_device
    from ..train import (
        build_model,
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from ..utils import Config

    model = build_model(Config.fromfile(str(REPO / config)), device=device)
    b = to_device(synthetic_batch(model.cfg, batch, seed=0, with_labels=True,
                                  num_rays=num_rays), device)
    state = create_train_state(model, make_optimizer(model.parameters()))
    step = make_train_step()
    gen = torch.Generator().manual_seed(1)

    def run(imgs):
        _, metrics = step(state, dict(b, imgs=imgs), gen)
        return float(metrics["loss_total"])

    return [{"stage": f"{name}_b{batch}",
             "s": timeit(run, [b["imgs"]], device, n=3)}]


def card_line(device) -> str:
    """The card's nvidia-smi name and power limit (`cpu` on the CPU)."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("which", nargs="?", default="all",
                   choices=STAGES + ("all",))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("bench_parts: no CUDA device (pass --device cpu for the CPU)",
              file=sys.stderr)
        return 2
    device = torch.device(a.device)
    print(card_line(device), flush=True)
    stages = {
        "cost_volume": lambda: bench_cost_volume(device),
        "nerf": lambda: bench_nerf(device),
        "pretrain_step": lambda: bench_train_step(
            "configs/preworld/preworld_7frame_pretrain.py",
            "pretrain_train_step", device),
        "finetune_step": lambda: bench_train_step(
            "configs/preworld/preworld_7frame_finetune.py",
            "finetune_train_step", device),
    }
    for name in STAGES:
        if a.which in (name, "all"):
            for row in stages[name]():
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
