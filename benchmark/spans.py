"""The program's own spans and counters in a cell's traced span, on the card.

    python3 benchmark/spans.py --workload <cell> --seed <n> [--pairs 2]

Set-up as a run makes it (`harness/main.py` `build`, `prepare`), then
the mix's `trace_frames` inputs served untraced, then `--pairs` pairs of
traced spans of `trace_frames` inputs each, as `harness/trace.py`
profiles them (frame ranges, module ranges where the entry opens them),
with the program's tracing (`preworld_tpu_torch.utils.trace`) off and on
in turns: off, on, on, off, ... For each span, one JSON line: the ms a
frame or step of the whole span (`span_ms_per_input`, which with tracing
off and on gives what the spans cost), the device's idle share, the
cell's per-layer readings from `harness/trace.py`'s summary, and with
tracing on `summarise_spans`' `span_ms`, `phase_ms`, `idle_ms`, the
program's `counters`, the per-layer numbers of `spans.readings`, the
program's ranges a frame or step (`spans_per_input`), the sum
of the idle parts beside the kernel union's idle, and the phases' share
of the kernels' device time (`phase_share`); the
idle, span and phase tables go to standard error. The benchmark's runs
never run this.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def profiled_events(entry, ks, model, hooks: bool, device):
    """The chrome trace events of run(k) for each k, each inside a frame
    range, profiled as `harness/trace.py` profiles a traced span."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness.trace import FRAME, ModuleRanges

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    ranges = ModuleRanges(model) if hooks else None
    if cuda:
        torch.cuda.synchronize(device)
    try:
        with profile(activities=acts) as prof:
            for k in ks:
                with torch.profiler.record_function(FRAME):
                    entry.run(k)
            if cuda:
                torch.cuda.synchronize(device)
    finally:
        if ranges is not None:
            ranges.remove()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        os.remove(path)


def spans_of(workload: str, seed: int, pairs: int, device, man=None):
    """Yield one record per traced span (see the module docstring)."""
    from preworld_tpu_torch.utils import trace as program_trace

    from benchmark.harness.main import build, prepare
    from benchmark.harness.manifest import Manifest
    from benchmark.harness.spans import (
        PHASES,
        PW,
        readings,
        summarise_spans,
        table,
    )
    from benchmark.harness.trace import summarise

    man = man or Manifest()
    cell = man.cell(workload)
    config, mix, kind, model = build(man, cell, device)
    _, entry, _ = prepare(config, mix, kind, model, seed, device)
    n = mix["trace_frames"]
    k = mix["warm"] + n
    for j in range(mix["warm"], k):
        entry.run(j)
    layer = man.per_layer(cell)
    for i in range(2 * pairs):
        on = i % 4 in (1, 2)
        program_trace.reset()
        program_trace.enable(on)
        try:
            events = profiled_events(entry, range(k, k + n), entry.model,
                                     kind.MODULE_RANGES, device)
        finally:
            program_trace.enable(False)
        k += n
        s = summarise(events, n)
        rec = {"workload": workload, "seed": seed, "tracing": on,
               "span_ms_per_input": s["window_s"] * 1e3 / n,
               "device_idle_share": 100.0 * (1.0 - s["kernel_busy_s"]
                                             / s["window_s"]),
               "per_layer": {m["name"]: man.reader(m["name"]).read(s)
                             for m in layer}}
        if on:
            s.update(summarise_spans(events))
            counters = dict(program_trace.counters)
            kernel_ms = sum(s["span_ms"].values())
            rec.update({key: s[key] for key in ("span_ms", "phase_ms",
                                                "idle_ms")},
                       counters=counters, readings=readings(s, counters),
                       spans_per_input=sum(e.get("cat") == "user_annotation"
                                           and e["name"].startswith(PW)
                                           for e in events) / n,
                       # the idle parts against the kernel union's idle
                       idle_parts_ms=sum(s["idle_ms"].values()),
                       idle_union_ms=(s["window_s"] - s["kernel_busy_s"])
                       * 1e3,
                       phase_share=sum(s["phase_ms"].get(p, 0.0) for p in
                                       PHASES) / kernel_ms
                       if s["phase_ms"] and kernel_ms else None)
            for line in table(s):
                print(f"{workload} {line}", file=sys.stderr)
        yield rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=2,
                   help="pairs of traced spans, tracing off and on")
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("spans: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    for rec in spans_of(args.workload, args.seed, args.pairs,
                        torch.device("cuda", 0)):
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
