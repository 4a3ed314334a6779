"""Streaming inference against the full forward, at the flagship size.

    python3 -m preworld_tpu_torch.tools.verify_streaming

The port's counterpart of `tools/verify_streaming_flagship.py`, on the
card: Swin-B, 6 cameras at 512x1408, 200x200x16 grid, bf16, random
weights from a seed. Every frame's poses are set to frame 0's, so the
ego-motion warp is the identity and the streaming path is the full
3-frame forward in another order: a cache initialised on frame 2 streams
frames 2, 1, 0, and the last step's occupancy is compared voxel by voxel
with `predict` on the whole 3-frame batch. The share that agrees must be
at least AGREEMENT (bf16 rounding may flip isolated argmax ties).

Prints one JSON line {"check", "agreement", "ok", "card"} and exits 1 below
AGREEMENT; with no card it prints no line and exits 2.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

AGREEMENT = 0.98


def constant_pose(batch):
    """The numpy batch with every frame's camera tensors set to frame 0's."""
    out = dict(batch)
    for k in ("sensor2egos", "ego2globals", "intrins", "post_rots",
              "post_trans"):
        out[k] = np.repeat(batch[k][:, :1], batch[k].shape[1], axis=1)
    return out


def streaming_agreement(model, batch) -> float:
    """Share of voxels where the third streaming step (frames 2, 1, 0 from a
    cache initialised on frame 2) and `predict` on the 3-frame `batch` (a
    dict of tensors on the model's device) give the same class."""
    from ..data import frame_batch

    cache = model.init_sequential_cache(frame_batch(batch, 2))
    for t in (2, 1, 0):
        out, cache = model.predict_sequential(frame_batch(batch, t), cache)
    full = model.predict(batch)
    return float((out["semantic_occ"] == full["semantic_occ"])
                 .float().mean())


def main(argv=None) -> int:
    import argparse

    from ..data import synthetic_batch, to_device
    from ..models import PreWorld, PreWorldConfig
    from ..utils import init_weights
    from .bench_parts import card_line

    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("verify_streaming: no CUDA device; this check runs only on the "
              "card", file=sys.stderr)
        return 2
    cfg = PreWorldConfig(if_post_finetune=True, if_render=False,
                         use_lss_depth_loss=False, dtype=torch.bfloat16)
    model = PreWorld(cfg).eval()
    init_weights(model, seed=0)
    model.cuda()
    batch = to_device(constant_pose(
        synthetic_batch(cfg, 1, seed=0, with_labels=False)), "cuda")
    agree = streaming_agreement(model, batch)
    ok = agree >= AGREEMENT
    print(json.dumps({"check": "streaming_flagship_agreement",
                      "agreement": agree, "ok": ok,
                      "card": card_line(torch.device("cuda"))}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
