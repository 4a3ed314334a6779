"""Headline benchmark of the port: 6-camera occupancy inference on one card.

    python3 -m preworld_tpu_torch.tools.bench [--streaming]

The port's counterpart of `bench.py`, on the card (no card is an error,
never a fallback). The model is the flagship `PreWorldConfig(
if_post_finetune=True, if_render=False, use_lss_depth_loss=False)` in bf16
(Swin-B, 6 cameras at 512x1408, 3 frames, 200x200x16 grid) with random
weights from a seed (`utils.init_weights`: N(0, 0.02)). The synthetic batch
is on the card before any timing: no upload is timed.

Default: one warm-up request, then REQUESTS timed `PreWorld.predict`
requests, each with `imgs` offset by 1e-6 (i + 1) outside the timed window
and ended by `torch.cuda.synchronize()`; `value` is 1 / the least time.
Then the streaming path the same way (`init_sequential_cache` on frame 0,
one warm-up step, STREAMING_STEPS timed `predict_sequential` steps) gives
`streaming_fps`, and one train step each of the pretrain and finetune
configs (`bench_parts.bench_train_step`: warm-up, then the least of 3)
gives `pretrain_step_s` and `finetune_step_s`.

`--streaming`: only the streaming path, with REQUESTS timed steps, under
the metric `6cam_occ_streaming_fps`.

Prints one JSON line: `bench.py`'s keys `metric`, `value`, `unit`,
`tflops_fwd`, `mfu`, `gb_accessed_fwd` and `hbm_util` (and by default
`streaming_fps`, `pretrain_step_s`, `finetune_step_s`), the card's
nvidia-smi name and power limit (`card`), and the kernel launches of the
last timed request and streaming step. The FLOPs and bytes are those of
one request of the metric (a predict request, or a streaming step under
`--streaming`), counted once, outside the timed window, by
`utils/flops.py`. `tflops_fwd`: the dense products and convolutions as
`torch.utils.flop_counter` defines them, plus the hand-written kernels'
products by the same definition (K3, K4 and K7 count 0). `gb_accessed_fwd`:
the bytes each aten op reads and writes, each kernel call counting its
operands and result, as XLA counts a custom call. Neither is XLA's count,
which `bench.py` reports on the TPU: the eager ops are not fused. `mfu` is
the FLOPs times `value` over 989e12, the H100's bf16 dense peak;
`hbm_util` the bytes times `value` over 3.35e12 bytes/s, its HBM3 rate
(NVIDIA H100 SXM data sheet). Nothing is caught: a failing part fails the
run with a non-zero exit and no JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

REQUESTS = 5
STREAMING_STEPS = 4
# the H100's bf16 dense tensor-core peak and HBM3 rate (NVIDIA H100 SXM
# data sheet)
PEAK_FLOPS = 989e12
HBM_BYTES_S = 3.35e12


def timed_min(fn, inputs) -> float:
    """Least seconds of fn(x) over `inputs`, each call ended by a device
    synchronise."""
    times = []
    for x in inputs:
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times)


def varied(imgs, n: int):
    """n copies of `imgs` offset by 1e-6 (i + 1), made before any timing."""
    out = [imgs + 1e-6 * (i + 1) for i in range(n)]
    torch.cuda.synchronize()
    return out


def launch_counts(fn):
    """fn wrapped: the kernel launch counts of its last call land in the
    returned dict."""
    from ..ops import _cuda

    last = {}

    def run(x):
        _cuda.reset_launches()
        fn(x)
        last.clear()
        last.update({k: v for k, v in _cuda.launches.items() if v})

    return run, last


def bench_predict(model, batch):
    """(least seconds of a request, launches of the last one)."""
    run, launches = launch_counts(
        lambda imgs: model.predict(dict(batch, imgs=imgs)))
    run(batch["imgs"])
    torch.cuda.synchronize()
    return timed_min(run, varied(batch["imgs"], REQUESTS)), launches


def count_keys(count: dict, per_s: float) -> dict:
    """`bench.py`'s `tflops_fwd`, `mfu`, `gb_accessed_fwd` and `hbm_util`
    for a request of `count` (`utils.flops.count_flops`) at `per_s`
    requests a second."""
    return {"tflops_fwd": count["flops"] / 1e12,
            "mfu": count["flops"] * per_s / PEAK_FLOPS,
            "gb_accessed_fwd": count["bytes"] / 1e9,
            "hbm_util": count["bytes"] * per_s / HBM_BYTES_S}


def bench_streaming(model, batch, n: int):
    """(least seconds of a streaming step over n, launches of the last,
    the step's `count_flops`)."""
    from ..data import frame_batch
    from ..utils.flops import count_flops

    frame = frame_batch(batch, 0)
    state = {"cache": model.init_sequential_cache(frame)}
    count = count_flops(lambda: model.predict_sequential(frame, state["cache"]),
                        model)

    def step(imgs):
        _, state["cache"] = model.predict_sequential(dict(frame, imgs=imgs),
                                                     state["cache"])

    run, launches = launch_counts(step)
    run(frame["imgs"])
    torch.cuda.synchronize()
    return timed_min(run, varied(frame["imgs"], n)), launches, count


def main(argv=None) -> int:
    from ..data import synthetic_batch, to_device
    from ..models import PreWorld, PreWorldConfig
    from ..utils import init_weights
    from ..utils.flops import count_forward
    from .bench_parts import bench_train_step, card_line

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--streaming", action="store_true",
                   help="time only the streaming path (one new frame a "
                        "step, the previous voxel feature ego-aligned)")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device; this benchmark runs only on the card",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    cfg = PreWorldConfig(if_post_finetune=True, if_render=False,
                         use_lss_depth_loss=False, dtype=torch.bfloat16)
    model = PreWorld(cfg).eval()
    init_weights(model, seed=0)
    model.to(device)
    batch = to_device(synthetic_batch(cfg, 1, seed=0, with_labels=False),
                      device)
    out = {"card": card_line(device)}
    if a.streaming:
        s, launches, count = bench_streaming(model, batch, REQUESTS)
        out.update(metric="6cam_occ_streaming_fps", value=1.0 / s,
                   unit="frames/s/chip", launches_per_streaming_step=launches,
                   **count_keys(count, 1.0 / s))
        print(json.dumps(out), flush=True)
        return 0
    count = count_forward(model, batch)
    s, launches = bench_predict(model, batch)
    out.update(metric="6cam_occ_inference_fps", value=1.0 / s,
               unit="frames/s/chip", launches_per_request=launches,
               **count_keys(count, 1.0 / s))
    s, launches, _ = bench_streaming(model, batch, STREAMING_STEPS)
    out.update(streaming_fps=1.0 / s, launches_per_streaming_step=launches)
    del model, batch
    torch.cuda.empty_cache()
    for key, config in (
            ("pretrain_step_s", "configs/preworld/preworld_7frame_pretrain.py"),
            ("finetune_step_s", "configs/preworld/preworld_7frame_finetune.py")):
        out[key] = bench_train_step(config, key, device)[0]["s"]
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
