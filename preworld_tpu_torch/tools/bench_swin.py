"""Swin backbone microbenchmarks at the flagship's scale (dev tool).

    python -m preworld_tpu_torch.tools.bench_swin [--device cuda|cpu]

The port's counterpart of `tools/bench_swin.py`, the same probes on the
card unless `--device cpu` (no card is an error, never a fallback):

  swin_full_6cam      the Swin-B forward (`models/swin.py::SwinTransformer`,
                      embed 128, depths 2/2/18/2, window 12) of 6 images at
                      512x1408 in bf16;
  swin_stage0_6cam    its stage 0 alone (the stereo path, `stage0_only`);
  swin_block_stage{i} one W-MSA `SwinBlock` of stage i on the block route
                      (K1 + K2) at the stage's width and feature size, on
                      the stage's padded (6, Hp, Wp, C) layout.

Weights from `utils.init_weights(seed=0)`, inputs N(0, 1) from a numpy
generator seeded 0. Each probe runs once, then 4 times with its input
offset by 1e-6 (i + 1) outside the timed window, each run between two
device synchronises; the least time is printed. The first line is the
card's `nvidia-smi` name and power limit, then one JSON line a probe:
`probe`, `ms` (the JAX tool's keys).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from .cli import add_device_arg, resolve_device

# (C, (H, W), heads) of each Swin-B stage at 512x1408
STAGES = ((128, (128, 352), 4), (256, (64, 176), 8), (512, (32, 88), 16),
          (1024, (16, 44), 32))


def make_swin(device, input_size=(512, 1408), seed: int = 0, **kw):
    """The Swin-B backbone (or `kw`'s widths) in eval mode on `device`."""
    from ..models.swin import SwinTransformer
    from ..utils import init_weights

    model = SwinTransformer(input_size, **kw).eval()
    init_weights(model, seed=seed)
    return model.to(device)


def make_block(C: int, hw, heads: int, device, ws: int = 12, seed: int = 0):
    """(block, x): a W-MSA `SwinBlock` of width C on the block route, and an
    f32 (6, Hp, Wp, C) input, its real (H, W) region N(0, 1) and its pad
    zero, as a stage passes it (`block_fn` casts it to bf16)."""
    from ..models.swin import SwinBlock
    from ..utils import init_weights

    blk = SwinBlock(C, heads, ws, 0, route="block").eval()
    init_weights(blk, seed=seed)
    H, W = hw
    x = np.random.default_rng(seed).normal(size=(6, H, W, C))
    x = torch.from_numpy(x.astype(np.float32)).to(device)
    x = F.pad(x, (0, 0, 0, (-W) % ws, 0, (-H) % ws)).contiguous()
    return blk.to(device), x


def block_fn(blk, hw):
    """x -> the block's output on bf16(x), without gradient."""
    def run(x):
        with torch.no_grad():
            return blk(x.to(torch.bfloat16), hw, None)
    return run


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(p)
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    from .bench_parts import card_line
    from .bench_stages import timeit

    print(card_line(device), flush=True)
    rows = []

    def emit(name, seconds):
        rows.append({"probe": name, "ms": seconds * 1e3})
        print(json.dumps(rows[-1]), flush=True)

    model = make_swin(device)
    imgs = np.random.default_rng(0).normal(size=(6, 512, 1408, 3))
    imgs = torch.from_numpy(imgs.astype(np.float32)).to(device)
    for name, stage0 in (("swin_full_6cam", False), ("swin_stage0_6cam", True)):
        def run(x, stage0=stage0):
            with torch.no_grad():
                return model(x.to(torch.bfloat16), stage0)
        emit(name, timeit(run, [imgs], device, 4))
    del model, imgs
    for i, (C, hw, heads) in enumerate(STAGES):
        blk, x = make_block(C, hw, heads, device, seed=i)
        emit(f"swin_block_stage{i}",
             timeit(block_fn(blk, hw), [x], device, 4))
    return rows


if __name__ == "__main__":
    main()
