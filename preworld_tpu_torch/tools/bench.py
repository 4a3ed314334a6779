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
the metric `6cam_occ_streaming_fps`. `PREWORLD_BENCH_TRAIN=0` skips the two
train steps and leaves their keys null, as in `bench.py`; any other value,
or none, runs them.

Prints one JSON line. Its keys are `bench.py`'s, without
`train_bench_error` (that key holds the error of `bench.py`'s guarded train
steps; here nothing is caught), and then the port's own three:

  metric                       `6cam_occ_inference_fps`
  value                        requests a second (1 / the least time)
  unit                         `frames/s/chip`
  vs_baseline                  round(value / 8.0, 3): 2 x the peg, so 1.0
                               is the 2x-A100 target
  streaming_fps                streaming steps a second
  baseline_assumed_fps         4.0, the peg
  baseline_peg_source          where the peg comes from, `bench.py`'s text
  pretrain_step_s              seconds of a pretrain step (null when
                               skipped)
  finetune_step_s              seconds of a finetune step (null when
                               skipped)
  mfu                          tflops_fwd x value over the card's peak
  hbm_util                     gb_accessed_fwd x value over its HBM rate
  tflops_fwd                   TFLOPs of one request
  gb_accessed_fwd              GB one request reads and writes
  card                         the card's nvidia-smi name and power limit
  launches_per_request         kernel launches of the last timed request
  launches_per_streaming_step  kernel launches of the last timed step

Under `--streaming` the line keeps `metric`, `value`, `unit`,
`vs_baseline`, `baseline_assumed_fps`, `tflops_fwd`, `mfu`,
`gb_accessed_fwd`, `hbm_util`, `card` and `launches_per_streaming_step`,
each of a streaming step.

The peg (`bench.py`'s docstring): the reference publishes no throughput.
BASELINE.json's target is 2x an A100 on 6-camera occupancy inference. The
closest published figure is the BEVDet paper's (Huang et al.,
arXiv:2112.11790, inference-speed table): BEVDet-Base, the same Swin-B at
the same 6 cameras at 512x1408, at ~1.9 frames/s on an RTX 3090. PreWorld
adds stereo cost volumes and two temporal frames, and an A100 is ~1.3-1.5x
a 3090 here, so an A100 estimate is <= 2.5 frames/s; the peg is a
deliberately generous 4.0, so `vs_baseline` can only understate. It is a
GPU estimate from a published paper, not a time taken on a TPU.
`vs_baseline` is relative to that peg; `mfu` and `hbm_util` are measured
here and do not depend on it.

The FLOPs and bytes are those of one request of the metric (a predict
request, or a streaming step under `--streaming`), counted once, outside
the timed window, by `utils/flops.py`. `tflops_fwd`: the dense products
and convolutions as `torch.utils.flop_counter` defines them, plus the
hand-written kernels' products by the same definition (K3, K4 and K7 count
0). `gb_accessed_fwd`: the bytes each aten op reads and writes, each kernel
call counting its operands and result, as XLA counts a custom call.
Neither is XLA's count, which `bench.py` reports on the TPU: the eager ops
are not fused. `mfu` is the FLOPs times `value` over 989e12, the H100's
bf16 dense peak; `hbm_util` the bytes times `value` over 3.35e12 bytes/s,
its HBM3 rate (NVIDIA H100 SXM data sheet). Nothing is caught: a failing
part fails the run with a non-zero exit and no JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

REQUESTS = 5
STREAMING_STEPS = 4
# the H100's bf16 dense tensor-core peak and HBM3 rate (NVIDIA H100 SXM
# data sheet)
PEAK_FLOPS = 989e12
HBM_BYTES_S = 3.35e12
# `bench.py`'s peg: a generous A100 estimate, frames a second (docstring);
# `vs_baseline` divides by twice it
BASELINE_ASSUMED_FPS = 4.0
BASELINE_PEG_SOURCE = ("arXiv:2112.11790 BEVDet-Base (Swin-B 512x1408) "
                       "~1.9fps@3090; 4.0 is a generous A100 upper bound")
TRAIN_CONFIGS = {
    "pretrain_step_s": "configs/preworld/preworld_7frame_pretrain.py",
    "finetune_step_s": "configs/preworld/preworld_7frame_finetune.py",
}


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


def train_step_seconds(device) -> dict:
    """{key: seconds} of one train step of each TRAIN_CONFIGS config
    (`bench_parts.bench_train_step`), or None each when
    PREWORLD_BENCH_TRAIN=0."""
    from . import bench_parts

    if os.environ.get("PREWORLD_BENCH_TRAIN", "1") == "0":
        return dict.fromkeys(TRAIN_CONFIGS)
    out = {}
    for key, config in TRAIN_CONFIGS.items():
        out[key] = bench_parts.bench_train_step(config, key, device)[0]["s"]
        torch.cuda.empty_cache()
    return out


def headline_line(value: float, count: dict, card: str, launches: dict,
                  streaming=None, train=None) -> dict:
    """The bench line (the docstring's keys) of `value` requests a second,
    each of `count` (`utils.flops.count_flops`) and `launches`.

    `streaming` None is the `--streaming` line: `value`, `count` and
    `launches` are then a streaming step's. Otherwise it is the default
    line and `streaming` is (steps a second, launches of a step) of its
    streaming path, and `train` is `train_step_seconds`' dict.
    """
    out = {"card": card,
           "metric": ("6cam_occ_streaming_fps" if streaming is None
                      else "6cam_occ_inference_fps"),
           "value": value, "unit": "frames/s/chip",
           "vs_baseline": round(value / (2 * BASELINE_ASSUMED_FPS), 3)}
    if streaming is None:
        out.update(baseline_assumed_fps=BASELINE_ASSUMED_FPS,
                   **count_keys(count, value),
                   launches_per_streaming_step=launches)
        return out
    streaming_fps, streaming_launches = streaming
    out.update(streaming_fps=streaming_fps,
               baseline_assumed_fps=BASELINE_ASSUMED_FPS,
               baseline_peg_source=BASELINE_PEG_SOURCE, **train,
               **count_keys(count, value), launches_per_request=launches,
               launches_per_streaming_step=streaming_launches)
    return out


def main(argv=None) -> int:
    from ..data import synthetic_batch, to_device
    from ..models import PreWorld, PreWorldConfig
    from ..utils import init_weights
    from ..utils.flops import count_forward
    from .bench_parts import card_line

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
    card = card_line(device)
    if a.streaming:
        s, launches, count = bench_streaming(model, batch, REQUESTS)
        print(json.dumps(headline_line(1.0 / s, count, card, launches)),
              flush=True)
        return 0
    count = count_forward(model, batch)
    s, launches = bench_predict(model, batch)
    s_streaming, streaming_launches, _ = bench_streaming(model, batch,
                                                         STREAMING_STEPS)
    del model, batch
    torch.cuda.empty_cache()
    out = headline_line(1.0 / s, count, card, launches,
                        (1.0 / s_streaming, streaming_launches),
                        train_step_seconds(device))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
