"""The program's spans in a traced span (`harness/spans.py`) on a
synthetic chrome trace, and the span tool (`benchmark/spans.py`) on the
CPU at tiny sizes."""

from __future__ import annotations

import pytest

from benchmark.harness.spans import readings, summarise_spans
from benchmark.harness.trace import FRAME, summarise

MAIN, AUTOGRAD = 1, 2


def _range(name, ts, end, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": end - ts, "tid": tid}


def _launch(corr, ts, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 0.5, "tid": tid, "args": {"correlation": corr}}


def _kernel(corr, ts, end, name="k"):
    args = {"stream": 7}
    if corr is not None:
        args["correlation"] = corr
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
            "dur": end - ts, "tid": 99, "args": args}


def _step_trace():
    """One train step over [0, 100] us: forward [0, 40] with the masks
    [10, 30], backward [40, 80] with the render's backward on the autograd
    thread [50, 60], update [80, 100]. Kernels: one launched in the
    forward, one from the autograd thread outside any span of its own, one
    in the render's backward, one in the update, and one without a launch
    record after it on the same stream."""
    return [
        _range(FRAME, 0, 100), _range("pw.train_step", 0, 100),
        _range("pw.forward", 0, 40), _range("pw.masks", 10, 30),
        _range("pw.backward", 40, 80), _range("pw.update", 80, 100),
        _range("pw.render.backward", 50, 60, AUTOGRAD),
        _launch(1, 5), _launch(2, 45, AUTOGRAD), _launch(3, 55, AUTOGRAD),
        _launch(4, 85),
        _kernel(1, 6, 9), _kernel(2, 46, 50), _kernel(3, 55, 58),
        _kernel(4, 86, 90), _kernel(None, 90, 92),
    ]


def test_backward_thread_launches_go_to_the_backward():
    s = summarise_spans(_step_trace())
    assert s["phase_ms"] == pytest.approx({"forward": 0.003,
                                           "backward": 0.007,
                                           "update": 0.006})
    assert s["span_ms"] == pytest.approx({"forward": 0.003, "outside": 0.004,
                                          "render.backward": 0.003,
                                          "update": 0.006})


def test_idle_parts_sum_to_the_kernel_union_idle():
    events = _step_trace()
    s = summarise_spans(events)
    assert s["idle_ms"] == pytest.approx({"forward": 0.017, "masks": 0.020,
                                          "backward": 0.033,
                                          "update": 0.014})
    whole = summarise(events, 1)
    assert sum(s["idle_ms"].values()) == pytest.approx(
        (whole["window_s"] - whole["kernel_busy_s"]) * 1e3)


def test_idle_outside_every_span():
    """Idle time with no span open on the frames' thread, before the
    first and after the last, is `outside`."""
    events = [_range(FRAME, 0, 100), _range("pw.predict", 20, 60),
              _range("pw.upload", 70, 80), _launch(1, 30),
              _kernel(1, 40, 50)]
    s = summarise_spans(events)
    assert s["idle_ms"] == pytest.approx({"outside": 0.050, "predict": 0.030,
                                          "upload": 0.010})
    assert s["phase_ms"] == {}
    assert readings(dict(s, frames=2), {"upload_bytes": 4_000_000}) == \
        pytest.approx({"upload_idle_ms.infer": 0.005,
                       "upload_mb.infer": 2.0,
                       "launch_idle_ms.infer": 0.015})


def test_step_readings():
    s = dict(summarise_spans(_step_trace()), frames=1)
    assert readings(s, {}) == pytest.approx({
        "mask_draw_idle_ms.train": 0.020, "forward_ms.train": 0.003,
        "backward_ms.train": 0.007, "update_ms.train": 0.006,
        "render_ms.train": 0.003})


def test_existing_keys_unchanged_by_program_spans():
    """`trace.summarise` gives the same keys with the program's ranges in
    the trace as without them; a gap may take a `pw.` range's name."""
    base = [e for e in _step_trace() if not e["name"].startswith("pw.")]
    base.append(_range("mod:img_backbone", 0, 35))
    a = summarise(base, 1)
    b = summarise(base + [e for e in _step_trace()
                          if e["name"].startswith("pw.")], 1)
    gaps_a, gaps_b = a.pop("idle_gaps"), b.pop("idle_gaps")
    assert a == b
    assert [g[1] for g in gaps_a] == [g[1] for g in gaps_b]


@pytest.mark.parametrize("cell", ["finetune-predict", "pretrain-train"])
def test_span_tool_on_the_cpu(tiny_root, cell):
    import torch

    from benchmark.harness.manifest import Manifest
    from benchmark.spans import spans_of
    from preworld_tpu_torch.utils import trace

    recs = list(spans_of(cell, 11, 1, torch.device("cpu"),
                         Manifest(tiny_root)))
    assert [r["tracing"] for r in recs] == [False, True]
    assert trace.span("upload") is trace.OFF
    on = recs[1]
    assert on["idle_parts_ms"] == pytest.approx(on["idle_union_ms"])
    suffix = ".train" if cell.endswith("train") else ".infer"
    assert "upload_mb" + suffix in on["readings"]
    if suffix == ".train":
        assert {"forward", "backward", "update"} <= set(on["phase_ms"])
        assert "masks" in on["idle_ms"]
    else:
        assert "predict" in on["idle_ms"] and on["phase_ms"] == {}
