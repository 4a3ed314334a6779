"""The program's own spans in a traced span's chrome trace.

With `preworld_tpu_torch.utils.trace` on, the program opens profiler
ranges named `pw.<span>` (`upload`, `masks`, `predict`, `train_step` and
its phases `forward` / `backward` / `update`, `image_backbone`,
`view_transformer`, `cost_volume`, `geometry`, `bev_encoder`, `render`,
`render.backward`). `summarise_spans` reads them from the same events that
`trace.summarise` reads, on the same clock:

  span_ms   device ms of kernels by the innermost `pw.` span open at the
            launch on the launching thread (`outside`: none open);
  phase_ms  device ms of kernels by the phase (`forward`, `backward`,
            `update`) open at the launch's host time on the thread that
            opened `train_step`, whichever thread launched them (the
            autograd engine's, remat's recompute); empty without a step,
            each phase present with one;
  idle_ms   the traced span's time with no kernel running (the kernel
            union that `device_idle_share.*` reads), split by the
            innermost `pw.` span open over each part of it on the thread
            that ran the frames (`outside`: none open).

A kernel without a launch record takes the span of the kernel before it
on its stream, as in `trace.summarise`. `readings` turns a summary into
the per-layer numbers a frame or step, and `table` into the lines that
`benchmark/spans.py` prints. The harness's runs do not read these spans
yet (`harness/trace.py` neither turns the program's tracing on nor
summarises `pw.` ranges).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .trace import FRAME, _union

PW = "pw."
OUTSIDE = "outside"
PHASES = ("forward", "backward", "update")


def _timeline(spans: List[Dict]) -> Tuple[List[float], List[Optional[str]]]:
    """The innermost of `spans` (ranges of one thread) over time: names[i]
    holds over [edges[i], edges[i + 1]), None where none is open; of two
    ranges open at once the later started, then the shorter, is inner."""
    edges = sorted({t for e in spans for t in (e["ts"], e["ts"] + e["dur"])})
    names: List[Optional[str]] = []
    for a, b in zip(edges, edges[1:]):
        mid = (a + b) / 2
        cover = [e for e in spans if e["ts"] <= mid <= e["ts"] + e["dur"]]
        names.append(max(cover, key=lambda e: (e["ts"], -e["dur"]))["name"]
                     [len(PW):] if cover else None)
    return edges, names


def _at(line, t: float) -> Optional[str]:
    edges, names = line
    i = bisect.bisect_right(edges, t) - 1
    return names[i] if 0 <= i < len(names) else None


def _split(intervals, line) -> Dict[str, float]:
    """The length of `intervals` by the name the timeline gives each
    part."""
    edges, names = line
    out: Dict[str, float] = defaultdict(float)
    for a, b in intervals:
        t, i = a, bisect.bisect_right(edges, a) - 1
        while t < b:
            if i < 0:
                end, name = min(b, edges[0]), None
            elif i >= len(names):
                end, name = b, None
            else:
                end, name = min(b, edges[i + 1]), names[i]
            out[name or OUTSIDE] += end - t
            t, i = end, i + 1
    return out


def _idle(kunion, lo: float, hi: float) -> List[Tuple[float, float]]:
    """[lo, hi] less the kernel union."""
    out, t = [], lo
    for a, b in kunion:
        if b <= t:
            continue
        if a >= hi:
            break
        if a > t:
            out.append((t, a))
        t = b
    if t < hi:
        out.append((t, hi))
    return out


def summarise_spans(events: List[Dict]) -> Dict:
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    kernels = sorted((e for e in xs if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    ann = [e for e in xs if e.get("cat") == "user_annotation"]
    frames = [e for e in ann if e["name"] == FRAME]
    if not frames:
        raise RuntimeError("the trace holds no frame range")
    lo = min(e["ts"] for e in frames)
    hi = max(e["ts"] + e["dur"] for e in frames)
    pw = [e for e in ann if e["name"].startswith(PW)]
    by_tid: Dict[object, List[Dict]] = defaultdict(list)
    for e in pw:
        by_tid[e["tid"]].append(e)
    lines = {tid: _timeline(v) for tid, v in by_tid.items()}
    steps = {e["tid"] for e in pw if e["name"] == PW + "train_step"}
    phase_line = _timeline([e for e in pw if e["tid"] in steps
                            and e["name"][len(PW):] in PHASES])

    span_ms: Dict[str, float] = defaultdict(float)
    phase_ms: Dict[str, float] = defaultdict(
        float, {p: 0.0 for p in PHASES} if steps else {})
    last: Dict[object, Tuple[str, str]] = {}
    for k in kernels:
        stream = k.get("args", {}).get("stream", k.get("tid"))
        la = launches.get(k.get("args", {}).get("correlation"))
        if la is None:
            name, phase = last.get(stream, (OUTSIDE, OUTSIDE))
        else:
            line = lines.get(la["tid"])
            name = (_at(line, la["ts"]) if line else None) or OUTSIDE
            phase = _at(phase_line, la["ts"]) or OUTSIDE
        last[stream] = (name, phase)
        span_ms[name] += k["dur"] / 1e3
        if steps:
            phase_ms[phase] += k["dur"] / 1e3
    kunion = _union([(k["ts"], k["ts"] + k["dur"]) for k in kernels])
    main = lines.get(frames[0]["tid"], ([], []))
    idle = _split(_idle(kunion, lo, hi), main)
    return {"span_ms": dict(span_ms), "phase_ms": dict(phase_ms),
            "idle_ms": {k: v / 1e3 for k, v in idle.items()}}


def readings(s: Dict, counters: Dict[str, int]) -> Dict[str, float]:
    """The per-layer numbers a frame or step of summary `s` (`frames`,
    `span_ms`, `phase_ms`, `idle_ms`) and the program's counters over the
    same span: `.train` where the span held train steps, else `.infer`;
    a number whose span or counter is absent is left out."""
    f = s["frames"]
    idle, spans, phases = s["idle_ms"], s["span_ms"], s["phase_ms"]
    suffix = ".train" if phases else ".infer"
    out = {}
    if "upload" in idle:
        out["upload_idle_ms"] = idle["upload"] / f
    if "upload_bytes" in counters:
        out["upload_mb"] = counters["upload_bytes"] / f / 1e6
    if phases:
        if "masks" in idle:
            out["mask_draw_idle_ms"] = idle["masks"] / f
        for p in PHASES:
            if p in phases:
                out[p + "_ms"] = phases[p] / f
        if "render" in spans or "render.backward" in spans:
            out["render_ms"] = (spans.get("render", 0.0)
                                + spans.get("render.backward", 0.0)) / f
    else:
        launch = [v for k, v in idle.items() if k not in ("upload",
                                                           OUTSIDE)]
        if launch:
            out["launch_idle_ms"] = sum(launch) / f
        if "cost_volume" in spans:
            out["cost_volume_ms"] = spans["cost_volume"] / f
    return {k + suffix: v for k, v in out.items()}


def table(s: Dict) -> List[str]:
    """Lines of the idle, span and phase tables, ms a frame or step,
    largest first."""
    f = s["frames"]
    out = []
    for key in ("idle_ms", "span_ms", "phase_ms"):
        rows = sorted(s[key].items(), key=lambda kv: -kv[1])
        if rows:
            out.append(f"{key} a frame: " + ", ".join(
                f"{k} {v / f:.3f}" for k, v in rows))
    return out
