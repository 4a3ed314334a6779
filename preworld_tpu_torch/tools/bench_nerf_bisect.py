"""Per-term bisection of the render backward (dev tool).

    python -m preworld_tpu_torch.tools.bench_nerf_bisect [--quick]
        [--device cuda|cpu]

The port's counterpart of `tools/bench_nerf_bisect.py`, on the card unless
`--device cpu` (no card is an error, never a fallback), at the pretrain
stage's render: 38400 rays on a 200x200x16 field, the default
`NerfHeadConfig` (417 samples a ray). Stages:

  scatter_only_full   the backward of the render's 3-D `F.grid_sample`
                      alone (`aten.grid_sampler_3d_backward`, what
                      `models/nerf_head.py` calls), through its field
                      layout: a (1, 21, 200, 200, 16) f32 field, points
                      uniform in [-0.9, 0.9] (normalised) at 38400 x 417,
                      a N(0, 1) cotangent on every sample and channel: the
                      floor of the field gradient;
  scatter_5pct        the same with 95 % of the cotangents zero (the JAX
                      tool's `scatter_cap64_5pct`; the port has no
                      `live_cap`: the scatter runs over every sample);
  grad_base           the gradient of the sum of `nerf_head_losses` in the
                      density, semantic and colour fields, random density
                      (the transparent regime: every sample live);
  grad_no_<term>      the same with one term left out, and `marginal_ms`,
                      base less it. Torch has no dead-code elimination: a
                      zero weight would still run its term's backward, so
                      the port sums the loss dict without the term's key
                      and autograd skips that branch. The render's own
                      backward (`_RenderRays`) still runs whole, with a
                      zero cotangent for an output no term reads;
  grad_trained        grad_base at density + 14 (opaque surfaces, early
                      exit). The JAX tool's cap{0,64,128} variants are the
                      TPU-only `bwd_live_cap`, which the port does not
                      carry: one variant.

Each stage runs once, then 3 times (2 with `--quick`) with its float
inputs (the fields; the points and cotangent) offset by 1e-6 (i + 1)
outside the timed window (the sparse
cotangent is masked again inside, so no dead sample comes back to life),
each run between two device synchronises; the least time is printed. The
first line is the card's `nvidia-smi` name and power limit, then one JSON
line a stage: `stage`, `ms` (and `marginal_ms`), the JAX tool's keys.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .cli import add_device_arg, resolve_device

# each term of the JAX tool's bisection and the loss key the port drops
TERMS = {"depth": "loss_render_depth", "semantic": "loss_render_semantic",
         "color": "loss_render_color", "entropy": "loss_sdf_entropy",
         "distortion": "loss_sdf_distortion"}


def make_inputs(density_shift: float = 0.0, seed: int = 0, scene=None,
                R: int = 38400, X: int = 200, Y: int = 200, Z: int = 16,
                device="cpu"):
    """(density, semantic, color, rays, bda) of one scene, drawn as the JAX
    tool's `make_inputs` draws them. scene=None: N(0, 1) density +
    density_shift; scene='wall': mostly empty space (-30) with opaque walls
    and a ground plane (14), the trained regime where live cotangents are
    sparse, contiguous spans."""
    rng = np.random.default_rng(seed)
    B = 1
    if scene == "wall":
        d = np.full((B, X, Y, Z), -30.0, np.float32)
        d[:, :, :, :2] = 14.0  # ground plane
        d[:, 118 * X // 200:123 * X // 200, :, :] = 14.0  # wall slab
        d[:, :, 60 * Y // 200:64 * Y // 200, :] = 14.0  # cross wall
        density = d + rng.normal(size=d.shape).astype(np.float32)
    else:
        density = (rng.normal(size=(B, X, Y, Z)).astype(np.float32)
                   + density_shift)
    semantic = rng.normal(size=(B, X, Y, Z, 17)).astype(np.float32)
    color = rng.normal(size=(B, X, Y, Z, 3)).astype(np.float32)
    rays = np.zeros((B, R, 16), np.float32)
    rays[..., 2] = rng.uniform(1, 40, (B, R))
    rays[..., 3] = rng.integers(0, 17, (B, R))
    rays[..., 4:7] = rng.uniform(-2, 2, (B, R, 3))
    rays[..., 7:10] = rng.normal(size=(B, R, 3))
    rays[..., 13:16] = rng.uniform(0, 1, (B, R, 3))
    bda = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 .to(device) for a in (density, semantic, color, rays, bda))


def loss_grads(cfg, density, semantic, color, rays, bda, drop=None):
    """Gradients of the sum of `nerf_head_losses` in (density, semantic,
    color), the loss keyed `drop` left out of the sum."""
    from ..models.nerf_head import nerf_head_losses

    leaves = [t.detach().requires_grad_(True)
              for t in (density, semantic, color)]
    losses = nerf_head_losses(*leaves, rays, bda, cfg)
    total = sum(v for k, v in sorted(losses.items()) if k != drop)
    return torch.autograd.grad(total, leaves)


def scatter_grad(field, pts, g):
    """The field gradient of the render's `F.grid_sample` 3-D alone: field
    (1, C, X, Y, Z), pts (R, S, 3) normalised (x, y, z), g (C, R, S) the
    samples' cotangent."""
    R, S = pts.shape[:2]
    grid = pts.flip(-1).reshape(1, R, S, 1, 3)
    d_field, _ = torch.ops.aten.grid_sampler_3d_backward(
        g[None, ..., None], field, grid, 0, 0, True, [True, False])
    return d_field


def scatter_inputs(R: int = 38400, S: int = 417, C: int = 21,
                   X: int = 200, Y: int = 200, Z: int = 16, seed: int = 1,
                   device="cpu"):
    """(field, pts, g, live) of the scatter stages: pts uniform in [-0.9,
    0.9], g N(0, 1), live the (1, R, S) mask of the 5 % live samples."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.9, 0.9, (R, S, 3)).astype(np.float32)
    g = rng.normal(size=(C, R, S)).astype(np.float32)
    live = rng.uniform(size=(1, R, S)) < 0.05
    field = torch.zeros((1, C, X, Y, Z), dtype=torch.float32, device=device)
    return (field, torch.from_numpy(pts).to(device),
            torch.from_numpy(g).to(device), torch.from_numpy(live).to(device))


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true",
                   help="2 timed runs a stage instead of 3")
    add_device_arg(p)
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    n = 2 if a.quick else 3
    from ..models.nerf_head import NerfHeadConfig
    from .bench_parts import card_line
    from .bench_stages import timeit

    print(card_line(device), flush=True)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    field, pts, g, live = scatter_inputs(device=device)
    emit({"stage": "scatter_only_full",
          "ms": timeit(lambda p_, g_: scatter_grad(field, p_, g_),
                       [pts, g], device, n) * 1e3})
    emit({"stage": "scatter_5pct",
          "ms": timeit(lambda p_, g_, lv: scatter_grad(field, p_, g_ * lv),
                       [pts, g, live], device, n) * 1e3})
    del field, pts, g, live

    cfg = NerfHeadConfig()

    def grad_ms(inputs, drop=None):
        *fields, rays, bda = inputs
        return timeit(lambda *f: loss_grads(cfg, *f, rays, bda, drop=drop),
                      fields, device, n) * 1e3

    inputs = make_inputs(device=device)
    base = grad_ms(inputs)
    emit({"stage": "grad_base", "ms": base})
    for term, key in TERMS.items():
        ms = grad_ms(inputs, key)
        emit({"stage": f"grad_no_{term}", "ms": ms, "marginal_ms": base - ms})
    emit({"stage": "grad_trained",
          "ms": grad_ms(make_inputs(density_shift=14.0, device=device))})
    return rows


if __name__ == "__main__":
    main()
