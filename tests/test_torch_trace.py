"""The port's own spans and counters (`preworld_tpu_torch/utils/trace.py`),
on the CPU at the tiny configs:

  * off, `span` is the shared no-op and a profiled predict holds no `pw.`
    range;
  * on, predict, a streaming step, a finetune and a render train step open
    their spans nested as the program lays them out, `render.backward`
    inside `backward`;
  * the forecasting model's request opens `predict` > `rollout` > a
    `rollout_step` a future step and counts them in `rollout_steps`; its
    remat train step counts each step once, not again in the recompute;
  * `upload_bytes` counts the bytes of the batch handed to the device;
  * the train loop's `--profile-dir` turns the spans on for the profiled
    iterations only, and its records carry `data_wait`.
"""

import json
import os

import numpy as np
import pytest
import torch

from preworld_tpu_torch.data import (
    DataLoader,
    frame_batch,
    synthetic_batch,
    tiny_config,
    to_device,
)
import dataclasses

from preworld_tpu_torch.models import PreWorld, PreWorld4DTraj
from preworld_tpu_torch.train import (
    create_train_state,
    make_optimizer,
    make_train_step,
    train_epochs,
)
from preworld_tpu_torch.utils import init_weights, trace

FINETUNE = dict(if_post_finetune=True, if_render=False,
                use_lss_depth_loss=False)
PRETRAIN = dict(if_pretrain=True, if_render=True, use_lss_depth_loss=True)
FRAME = ("image_backbone", "view_transformer", "cost_volume", "geometry",
         "bev_encoder")


@pytest.fixture(autouse=True)
def tracing_off_after():
    yield
    trace.enable(False)
    trace.reset()


def _model(**kw):
    torch.manual_seed(0)
    model = PreWorld(tiny_config(**kw))
    init_weights(model, seed=0, fan_in=True)
    return model


def _profiled(fn):
    """fn() under the CPU profiler -> the `pw.` ranges as (name, start,
    end, thread), in start order."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = [(e.name[len(trace.PREFIX):], e.time_range.start,
            e.time_range.end, e.thread) for e in prof.events()
           if e.name.startswith(trace.PREFIX)]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _children(spans):
    """{span name: the names of the spans directly inside one of its
    ranges on its thread}; top-level spans under None."""
    out = {}
    for i, (name, a, b, tid) in enumerate(spans):
        parents = [s for s in spans[:i] if s[3] == tid and s[1] <= a
                   and b <= s[2]]
        # the innermost enclosing range started last
        parent = parents[-1][0] if parents else None
        out.setdefault(parent, set()).add(name)
    return out


def test_off_span_is_the_shared_noop_and_predict_has_no_range():
    trace.enable(False)
    assert trace.span("predict") is trace.OFF
    assert trace.span("upload") is trace.span("geometry")
    trace.count("upload_bytes", 5)
    assert trace.counters == {}
    model = _model(**FINETUNE).eval()
    batch = to_device(synthetic_batch(model.cfg, 1, seed=1,
                                      with_labels=False), "cpu")
    assert _profiled(lambda: model.predict(batch)) == []


def _predict(model, batch, gen):
    model.eval()
    return lambda: model.predict(batch)


def _stream(model, batch, gen):
    model.eval()
    cache = model.init_sequential_cache(frame_batch(batch, 2))
    return lambda: model.predict_sequential(frame_batch(batch, 1), cache)


def _step(model, batch, gen):
    state = create_train_state(model, make_optimizer(model.parameters()))
    step = make_train_step()
    return lambda: step(state, batch, gen)


STEP = {"train_step": {"forward", "backward", "update"}}
CASES = {
    # case: (config, labels, entry, the children each span must have)
    "predict": (FINETUNE, False, _predict, {None: {"predict"},
                                            "predict": set(FRAME)}),
    "predict_sequential": (FINETUNE, False, _stream, {
        None: {"predict_sequential"}, "predict_sequential": set(FRAME)}),
    "finetune_step": (FINETUNE, True, _step, {
        None: {"train_step"}, **STEP, "forward": set(FRAME),
        "view_transformer": {"masks"}}),
    "render_step": (PRETRAIN, True, _step, {
        None: {"train_step"}, **STEP, "forward": {*FRAME, "render"},
        "view_transformer": {"masks"}, "backward": {"render.backward"}}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spans_nest(case):
    cfg, labels, entry, want = CASES[case]
    model = _model(**cfg)
    batch = to_device(synthetic_batch(model.cfg, 1, seed=2,
                                      with_labels=labels, num_rays=64),
                      "cpu")
    run = entry(model, batch, torch.Generator().manual_seed(0))
    trace.enable(True)
    spans = _profiled(run)
    trace.enable(False)
    got = _children(spans)
    for parent, names in want.items():
        assert got.get(parent) == names, (parent, got)
    if case == "render_step":
        # on the card the render's backward runs on the autograd thread:
        # held to the backward's interval, not its thread
        back = [s for s in spans if s[0] == "backward"]
        for _, a, b, _ in (s for s in spans if s[0] == "render.backward"):
            assert any(p[1] <= a and b <= p[2] for p in back)
    # the training masks are drawn only in training
    assert ("masks" in {s[0] for s in spans}) == labels


def _traj(remat=False):
    torch.manual_seed(0)
    model = PreWorld4DTraj(dataclasses.replace(tiny_config(**FINETUNE),
                                               remat=remat))
    init_weights(model, seed=0, fan_in=True)
    return model


def _traj_batch(model, num_future):
    return to_device(synthetic_batch(model.cfg, 2, seed=4, with_traj=True,
                                     num_future=num_future), "cpu")


def test_traj_predict_spans_and_rollout_steps():
    """A 6-step request: `predict` holds the frame's spans and `rollout`,
    `rollout` the six `rollout_step`s (and the heads' `bev_encoder`), and
    `rollout_steps` counts 6; off, no range and no count."""
    model = _traj().eval()
    batch = _traj_batch(model, 6)
    trace.enable(True)
    trace.reset()
    spans = _profiled(lambda: model.predict(batch, num_future=6))
    trace.enable(False)
    got = _children(spans)
    assert got[None] == {"predict"}
    assert got["predict"] == {*FRAME, "rollout"}
    assert got["rollout"] == {"rollout_step", "bev_encoder"}
    assert [s[0] for s in spans].count("rollout_step") == 6
    assert trace.counters == {"rollout_steps": 6}
    trace.reset()
    assert _profiled(lambda: model.predict(batch, num_future=6)) == []
    assert trace.counters == {}


def test_traj_remat_step_counts_each_rollout_step_once():
    """A remat train step at num_future 2: `rollout` in the forward holds
    two `rollout_step`s and their `future_losses`, the recompute in the
    backward opens them again, and `rollout_steps` counts 2, not 4."""
    model = _traj(remat=True)
    batch = _traj_batch(model, 2)
    step = make_train_step(num_future=2)
    state = create_train_state(model, make_optimizer(model.parameters()))
    trace.enable(True)
    trace.reset()
    spans = _profiled(lambda: step(state, batch,
                                   torch.Generator().manual_seed(0)))
    trace.enable(False)
    got = _children(spans)
    assert "rollout" in got["forward"]
    assert got["rollout"] == {"rollout_step", "future_losses"}
    names = [s[0] for s in spans]
    assert names.count("rollout_step") == 4  # twice in the recompute
    assert names.count("future_losses") == 4
    assert trace.counters["rollout_steps"] == 2


def test_upload_counts_the_batch_bytes():
    cfg = tiny_config(**FINETUNE)
    host = synthetic_batch(cfg, 2, seed=3, with_labels=True, num_rays=64)
    trace.enable(True)
    trace.reset()
    to_device(host, "cpu")
    assert trace.counters == {"upload_bytes": sum(v.nbytes
                                                  for v in host.values())}
    trace.enable(False)
    to_device(host, "cpu")
    assert trace.counters["upload_bytes"] == sum(v.nbytes
                                                 for v in host.values())


class _Dataset:
    def __len__(self):
        return 14

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.float32)}


def test_profile_dir_traces_spans_of_the_profiled_iterations(tmp_path):
    """Iterations 8-11 of 14 are profiled: four `pw.upload` ranges (the
    loop's `batch_to`), tracing off again after; every record has a
    `data_wait` of zero or more."""
    loader = DataLoader(_Dataset(), batch_size=1, num_workers=1, seed=0)
    state = type("S", (), {"model": torch.nn.Linear(1, 1), "step": 0})()
    train_epochs(state, lambda s, b, g: (s, {"x": b["x"].sum()}), loader, 1,
                 str(tmp_path), checkpoint_interval=2, log_interval=7,
                 profile_dir=str(tmp_path / "prof"))
    assert trace.span("upload") is trace.OFF
    with open(tmp_path / "prof" / "trace.json") as fh:
        names = [e.get("name") for e in json.load(fh)["traceEvents"]]
    assert names.count("pw.upload") == 4
    with open(os.path.join(tmp_path, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    assert [r["iter"] for r in recs] == [7, 14]
    assert all(r["data_wait"] >= 0.0 for r in recs)
