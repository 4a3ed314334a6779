"""The traced span: module ranges, the profiler, and its summary.

`ModuleRanges` registers forward pre- and post-hooks from the benchmark
on the program's top-level submodules; each opens and closes a
`torch.profiler.record_function` range named `mod:<submodule>`. Each
frame or step of the span runs inside a range `bench.frame`. The span is
profiled with `torch.profiler` (CPU and CUDA activities), exported as a
chrome trace into the run's temporary directory, read back and deleted.

`summarise` attributes every kernel's device time to the innermost
module range in which the host issued its launch (matched by the
launch's correlation id), or to `outside` when the launch was inside a
frame but outside every module range. It also gives the union of kernel
intervals, of all device activity, the host-to-device copies, the top
device operations by name and the longest gaps with no kernel, each
named by the innermost host operation that was running across it.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, Iterable, List

import torch

FRAME = "bench.frame"
MOD = "mod:"


class ModuleRanges:
    def __init__(self, model: torch.nn.Module):
        self.handles = []
        self.open: Dict[str, list] = defaultdict(list)
        for name, mod in model.named_children():
            self.handles.append(mod.register_forward_pre_hook(
                self._enter(name)))
            self.handles.append(mod.register_forward_hook(self._exit(name)))

    def _enter(self, name):
        def hook(module, args):
            rf = torch.profiler.record_function(MOD + name)
            rf.__enter__()
            self.open[name].append(rf)
        return hook

    def _exit(self, name):
        def hook(module, args, out):
            self.open[name].pop().__exit__(None, None, None)
        return hook

    def remove(self):
        for h in self.handles:
            h.remove()


def profile_span(run: Callable[[int], float], ks: Iterable[int],
                 model: torch.nn.Module, hooks: bool, device) -> Dict:
    """Profile run(k) for each k, each inside a frame range; returns the
    summary of the trace (`summarise`)."""
    from torch.profiler import ProfilerActivity, profile

    ks = list(ks)
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    ranges = ModuleRanges(model) if hooks else None
    if cuda:
        torch.cuda.synchronize(device)
    try:
        with profile(activities=acts) as prof:
            for k in ks:
                with torch.profiler.record_function(FRAME):
                    run(k)
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
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    return summarise(events, len(ks))


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def _clip(intervals, lo, hi) -> float:
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in intervals)


def summarise(events: List[Dict], frames: int) -> Dict:
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    kernels = [e for e in xs if e.get("cat") == "kernel"]
    copies = [e for e in xs if e.get("cat") in ("gpu_memcpy", "gpu_memset")]
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    ann = [e for e in xs if e.get("cat") == "user_annotation"]
    frames_ev = sorted((e for e in ann if e["name"] == FRAME),
                       key=lambda e: e["ts"])
    if not frames_ev:
        raise RuntimeError("the trace holds no frame range")
    lo = frames_ev[0]["ts"]
    hi = max(e["ts"] + e["dur"] for e in frames_ev)
    mods = sorted((e for e in ann if e["name"].startswith(MOD)),
                  key=lambda e: e["ts"])
    starts = [e["ts"] for e in mods]

    def owner(ts, tid):
        """Innermost module range open at host time ts on thread tid."""
        best = None
        for e in mods[:bisect.bisect_right(starts, ts)]:
            if e["tid"] == tid and e["ts"] <= ts <= e["ts"] + e["dur"]:
                if best is None or e["dur"] < best["dur"]:
                    best = e
        return None if best is None else best["name"][len(MOD):]

    def in_frame(ts):
        return any(f["ts"] <= ts <= f["ts"] + f["dur"] for f in frames_ev)

    by_range: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    # a kernel whose launch record is missing runs in launch order on its
    # stream, so it takes the range of the kernel before it there
    last: Dict[object, str] = {}
    unmatched = 0
    for k in sorted(kernels, key=lambda e: e["ts"]):
        by_name[k["name"]] += k["dur"]
        stream = k.get("args", {}).get("stream", k.get("tid"))
        la = launches.get(k.get("args", {}).get("correlation"))
        if la is None:
            unmatched += 1
            name = last.get(stream, "unattributed")
        else:
            name = owner(la["ts"], la["tid"])
            if name is None:
                name = "outside" if in_frame(la["ts"]) else "unattributed"
        last[stream] = name
        by_range[name] += k["dur"]
    h2d = 0.0
    for c in copies:
        by_name[c["name"]] += c["dur"]
        if "HtoD" in c["name"]:
            h2d += c["dur"]
    kunion = _union([(k["ts"], k["ts"] + k["dur"]) for k in kernels])
    aunion = _union([(e["ts"], e["ts"] + e["dur"])
                     for e in kernels + copies])
    span = hi - lo
    return {
        "frames": frames,
        "window_s": span / 1e6,
        "busy_s": _clip(aunion, lo, hi) / 1e6,
        "kernel_busy_s": _clip(kunion, lo, hi) / 1e6,
        "range_ms": {k: v / 1e3 for k, v in by_range.items()},
        "h2d_ms": h2d / 1e3,
        "n_kernels": len(kernels),
        "n_unmatched": unmatched,
        "device_ops": [[n, v / 1e6] for n, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": _gaps(kunion, lo, hi, xs),
    }


def _gaps(kunion, lo, hi, xs) -> List[list]:
    """The 10 longest stretches of the span with no kernel, each named by
    the innermost host operation that covers its middle."""
    edges = [lo] + [x for ab in kunion for x in ab] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    host = [e for e in xs if e.get("cat") in ("cpu_op", "cuda_runtime",
                                              "cuda_driver",
                                              "user_annotation")]
    out = []
    for dur, start in gaps:
        mid = start + dur / 2
        cover = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        name = min(cover, key=lambda e: e["dur"])["name"] if cover \
            else "python"
        out.append([name, dur / 1e6])
    return out
