"""Cumulative-truncation breakdown of the flagship predict (dev tool).

    python -m preworld_tpu_torch.tools.bench_stages [--device cuda|cpu]

The port's counterpart of `tools/bench_stages.py`: the same five probes,
each a prefix of the forward (the JAX probe reduces it to one f32 scalar,
which `make_probes` gives apart), so that successive differences
attribute the request's time to its stages:

  encode_3frames      the image encoder of the 3 frames (the stereo-only
                      reference frame's stage 0, then each temporal
                      frame's backbone and neck);
  plus_vt_zerocost    + the view transformer and the pre-process net of
                      each temporal frame, without the stereo cost volume;
  plus_viewtransform  + the cost volume (K3) against the frame before;
  plus_bev_encoder    + the BEV encoder (`bev_backbone`, `bev_neck`) and
                      `final_conv`;
  full_predict        `PreWorld.predict` (+ the occupancy head and argmax;
                      its scalar the sum of the predicted labels).

The model is the flagship `PreWorldConfig(if_post_finetune=True,
if_render=False, use_lss_depth_loss=False)` in bf16 with weights from
`utils.init_weights(seed=0)` (N(0, 0.02), the JAX tool's draw), on the card
unless `--device cpu` (no card is an error, never a fallback). Each probe
runs once, then 3 times with `imgs` offset by 1e-6 (i + 1) outside the
timed window, each run between two device synchronises; the least time is
printed. The first line is the card's `nvidia-smi` name and power limit,
then one JSON line a probe: `probe`, `ms`, `delta_ms` (the JAX tool's keys).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .cli import add_device_arg, resolve_device


def _frame_loop(m, batch, with_vt: bool, with_bev: bool,
                with_cost: bool = True):
    """The JAX probes' `frame_loop` on the port's modules (as
    `PreWorld.extract_voxel_feat` runs them), up to the sums: returns each
    temporal frame's (neck feature, stereo feature) without the view
    transformer, else the frames' voxel features without the BEV encoder,
    else `final_conv`'s output."""
    from ..geometry.transforms import curr2adjsensor_chain, sensor2keyego_chain

    c = m.cfg
    imgs = batch["imgs"].to(c.dtype)
    B, T, N = imgs.shape[:3]
    s2keyego = sensor2keyego_chain(batch["sensor2egos"], batch["ego2globals"])
    curr2adj = curr2adjsensor_chain(batch["sensor2egos"],
                                    batch["ego2globals"], c.temporal_frames)
    prev = None
    outs = []
    for fid in range(c.num_frames - 1, -1, -1):
        frame_imgs = imgs[:, fid]
        if fid >= c.temporal_frames:
            x = frame_imgs.reshape(B * N, *frame_imgs.shape[2:])
            prev = m._backbone(x, True, None)[0]
            continue
        if not with_vt:
            feat, prev = m._encode_image(frame_imgs)
            outs.append((feat, prev))
            continue
        voxel, _, prev = m._frame(batch, fid, frame_imgs, s2keyego, curr2adj,
                                  prev if with_cost else None, None)
        outs.append(voxel)
    if with_bev:
        return m._bev_encode(outs)
    return outs


# (name, fn(model, batch) -> output, output -> the JAX probe's f32 scalar)
PROBES = (
    ("encode_3frames", lambda m, b: _frame_loop(m, b, False, False),
     lambda out: sum(f.float().sum() + s.float()[0, 0, 0, 0]
                     for f, s in out)),
    ("plus_vt_zerocost", lambda m, b: _frame_loop(m, b, True, False, False),
     lambda out: torch.cat(out, dim=-1).float().sum()),
    ("plus_viewtransform", lambda m, b: _frame_loop(m, b, True, False),
     lambda out: torch.cat(out, dim=-1).float().sum()),
    ("plus_bev_encoder", lambda m, b: _frame_loop(m, b, True, True),
     lambda out: out.sum()),
    ("full_predict", lambda m, b: m.predict(b),
     lambda out: out["semantic_occ"].sum().float()),
)


def make_probes(cfg=None, device=None, seed: int = 0):
    """(model, batch, [(name, fn, reduce)]) of the five probes: fn(model,
    batch) runs a prefix of the forward without gradient, reduce(its
    output) gives the JAX probe's f32 scalar (the sum the JAX probe jits
    with it, here outside the timed or counted call). cfg: a
    `PreWorldConfig`, by default the flagship's in bf16; the model in eval
    mode with `init_weights(seed)` on `device` (the CPU by default) and a
    synthetic inference batch (seed 0) there."""
    from ..data import synthetic_batch, to_device
    from ..models import PreWorld, PreWorldConfig
    from ..utils import init_weights

    cfg = cfg or PreWorldConfig(if_post_finetune=True, if_render=False,
                                use_lss_depth_loss=False,
                                dtype=torch.bfloat16)
    device = torch.device(device or "cpu")
    model = PreWorld(cfg).eval()
    init_weights(model, seed=seed)
    model.to(device)
    batch = to_device(synthetic_batch(cfg, 1, seed=0, with_labels=False),
                      device)

    def no_grad(fn):
        def run(m, b):
            with torch.no_grad():
                return fn(m, b)
        return run

    return model, batch, [(name, no_grad(fn), reduce)
                          for name, fn, reduce in PROBES]


def timeit(fn, args, device, n: int) -> float:
    """Least seconds of n runs of fn(*args) after one warm-up, each with its
    float tensor arguments offset by 1e-6 (i + 1) before the timed window,
    which a device synchronise opens and closes (the dev tools' timer)."""
    from .bench_parts import sync

    fn(*args)
    times = []
    for i in range(n):
        a2 = [a + 1e-6 * (i + 1) if a.is_floating_point() else a
              for a in args]
        sync(device)
        t0 = time.perf_counter()
        fn(*a2)
        sync(device)
        times.append(time.perf_counter() - t0)
    return min(times)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(p)
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    from .bench_parts import card_line

    print(card_line(device), flush=True)
    model, batch, probes = make_probes(device=device)
    rows, prev = [], 0.0
    for name, fn, _ in probes:
        t = timeit(lambda imgs, fn=fn: fn(model, dict(batch, imgs=imgs)),
                   [batch["imgs"]], device, 3)
        rows.append({"probe": name, "ms": t * 1e3,
                     "delta_ms": (t - prev) * 1e3})
        print(json.dumps(rows[-1]), flush=True)
        prev = t
    return rows


if __name__ == "__main__":
    main()
