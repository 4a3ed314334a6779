"""One run of one cell: set-up, the measured window, the traced span
(`--trace 1`), the output check, and the result line.

Set-up (`setup_s`, from process start until the window opens): the
program's model from its configuration file, the benchmark's weights from
the seed, the host inputs, the kernels built or loaded from the build
directory in the checkout, and the warm inputs (`warm` of the mix: two
frames, or the train step's first three steps, which the check follows).
The window then serves inputs one after another, each from host inputs to
a host result, until `--seconds` have passed; the rate is over all the
inputs and all the time of the window, the tail over every input.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .check import reference_meta, verdict
from .inputs import make_state_dict, make_traffic
from .manifest import Manifest
from .program import build_program
from .trace import profile_span

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "preworld_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (compared whole: `preworld_tpu_torch` is not
    `preworld_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def window_line(times: List[float]) -> str:
    """The spread of the inputs' times inside the window, and its drift
    (the mean of each half)."""
    t = np.array(times) * 1e3
    h = len(t) // 2
    return (f"{len(t)} inputs, mean {t.mean():.3f} ms, sd {t.std():.3f} ms,"
            f" halves {t[:h].mean() if h else float('nan'):.3f} / "
            f"{t[h:].mean():.3f} ms")


def end_to_end(name: str, rec: Dict) -> float:
    if name == "occ_frames_per_s":
        return rec["n"] / rec["window_s"]
    if name == "train_samples_per_s":
        return rec["n"] * rec["batch"] / rec["window_s"]
    if name == "frame_ms_p95":
        return float(np.percentile(np.array(rec["times"]) * 1e3, 95))
    if name == "peak_mem_gb":
        return rec["peak_bytes"] / 1e9
    if name == "setup_s":
        return rec["setup_s"]
    raise KeyError(f"no end-to-end metric {name!r}")


def build(man: Manifest, cell: Dict, device):
    """(config, mix, entry module, the program's model)."""
    config = man.config(cell)
    mix = man.traffic(cell)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    return config, mix, man.entry(mix), build_program(config, device)


def prepare(config: Dict, mix: Dict, kind, model, seed: int, device):
    """The program ready to serve the seed's traffic: the seed's weights,
    the host inputs, the entry and its warm inputs. Returns (traffic,
    entry, the inputs whose outputs the check compares)."""
    model.load_state_dict(make_state_dict(reference_meta(config), seed,
                                          device))
    traffic = make_traffic(config, mix, seed, device)
    entry = kind.Entry(model, traffic, device, seed, config)
    warm = mix["warm"]
    for k in range(warm):
        entry.run(k)
    entry.sync()
    return traffic, entry, [warm + j for j in kind.sample(mix, seed)]


def serve(entry, start: int, ks: List[int], limit: int,
          seconds: Optional[float] = None) -> Dict:
    """Serve inputs start, start + 1, ... one after another, keeping the
    outputs of ks, until `seconds` have passed or, without `seconds`, up
    to the last of ks; never past input `limit`."""
    times = []
    k = start
    t0 = time.perf_counter()
    while seconds is not None or k <= max(ks, default=start - 1):
        if k >= limit:
            raise RuntimeError(f"the mix holds {limit} inputs")
        if k in ks:
            entry.capture(k)
        times.append(entry.run(k))
        k += 1
        if seconds is not None and time.perf_counter() - t0 >= seconds:
            break
    return {"times": times, "n": len(times),
            "window_s": time.perf_counter() - t0, "next": k}


def free_program(entry) -> None:
    entry.close()
    entry.model = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(args, t_process: float, device=None, man=None) -> int:
    """One run; `device` and `man` are for the CPU tests, which drive a
    run without the card (its look for a card is in `run.py`)."""
    device = device or torch.device("cuda", 0)
    man = man or Manifest()
    cell = man.cell(args.workload)
    limits = man.limits(cell)
    config, mix, kind, model = build(man, cell, device)
    traffic, entry, ks = prepare(config, mix, kind, model, args.seed, device)
    del model
    setup_s = time.perf_counter() - t_process
    rec = serve(entry, mix["warm"], ks, mix["max_frames"], args.seconds)
    rec.update(setup_s=setup_s, batch=traffic.batch)
    span = None
    if args.trace:
        span = profile_span(entry.run, range(rec["next"], rec["next"]
                                             + mix["trace_frames"]),
                            entry.model, kind.MODULE_RANGES, device)
    rec["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}", file=sys.stderr)
        return 3
    outputs = entry.outputs()  # on the host; then the program is freed
    free_program(entry)
    del entry
    metrics = {}
    if args.trace:
        work = kind.work(config, traffic, args.seed, device,
                         ks[0] if ks else 0)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        summary = dict(span, work=work, rate=rec["n"] / rec["window_s"])
        for m in man.per_layer(cell):
            value = man.reader(m["name"]).read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in man.end_to_end(cell):
            metrics[m["name"]] = {"value": end_to_end(m["name"], rec),
                                  "unit": m["unit"]}
    numbers = kind.check(config, traffic, outputs, args.seed, device)
    correct = verdict(numbers, limits)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": rec["peak_bytes"]}
    line = {"correct": correct, "attempted": rec["n"], "failed": 0,
            "metrics": metrics, "device": device_info}
    if span is not None:
        device_info.update(busy_s=span["busy_s"], window_s=span["window_s"])
        line["breakdown"] = {"device_ops": span["device_ops"],
                             "idle_gaps": span["idle_gaps"]}
    checks = {n: {"value": v, "limit": limits.get(n)}
              for n, v in numbers.items()}
    line["checks"] = checks
    print(f"card: {card_line()}", file=sys.stderr)
    print(f"window: {window_line(rec['times'])}", file=sys.stderr)
    if span is not None:
        print(f"trace: {span['n_kernels']} kernels, {span['n_unmatched']} "
              f"without a launch record; ms by range "
              f"{json.dumps(span['range_ms'])}", file=sys.stderr)
    for n, c in checks.items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
