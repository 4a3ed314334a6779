"""The benchmark's manifest, its data-driven lookup, the result line, and
the output check's verdict under planted faults, on the CPU at tiny
sizes (`harness_fixture`)."""

from __future__ import annotations

import json
import re

import pytest

import harness_fixture as hf
from benchmark.harness.manifest import Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device",
             "checks"}


@pytest.fixture(scope="module")
def man():
    return Manifest()


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_form(man):
    d = man.data
    raw = (man.root / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert d["command"] == ["python3", "benchmark/run.py"]
    assert d["paths"] == ["benchmark"] and all(PATH.match(p)
                                                for p in d["paths"])
    assert 1 <= d["run_seconds"] <= 51 and isinstance(d["run_seconds"], int)
    # a full check with 24 cells fits in its 43200 seconds
    assert 2 + 14 * 24 * (d["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["why"])
        assert line_ok(c["source"]) and c["file"].startswith("benchmark/")
        assert json.loads((man.root / c["file"]).read_text())["sizes"]
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    pairs = set()
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and line_ok(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(d["workloads"])
    assert sum(w["chips"] == 4 for w in d["workloads"]) <= 1
    metrics = d["end_to_end"] + d["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in d["end_to_end"]}
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert line_ok(m["layer"]) and m["moves"] in e2e


@pytest.mark.parametrize("cell", list(hf.CELLS))
def test_cell_resolves(man, cell):
    """Each cell finds its configuration, mix, entry, reference class,
    limits and readers by name; it reports setup_s, another end-to-end
    metric and a per-layer one, and every per-layer metric's reader
    declares the manifest's layer, unit and `moves`."""
    from benchmark.harness.check import reference_class

    w = man.cell(cell)
    config, mix = man.config(w), man.traffic(w)
    assert config["sizes"] and reference_class(config).from_sizes
    entry = man.entry(mix)
    for name in ("Entry", "MODULE_RANGES", "sample", "check", "work",
                 "controls"):
        assert hasattr(entry, name), (mix["entry"], name)
    assert man.limits(w)
    e2e = {m["name"] for m in man.end_to_end(w)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per = man.per_layer(w)
    assert per
    for m in per:
        r = man.reader(m["name"])
        assert (r.LAYER, r.UNIT, r.MOVES) == (m["layer"], m["unit"],
                                              m["moves"])
        assert m["moves"] in e2e


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", list(hf.CELLS))
def test_result_line(tmp_path, cell, trace):
    """The last line's keys, `checks` last, and the metrics the cell
    reports; a sound run of the program is correct under the cell's
    limits."""
    limits = {c: json.loads((hf.BENCH / "limits" / f"{c}.json").read_text())
              for c in hf.CELLS}
    root = hf.make_root(tmp_path, limits)
    rc, line, err = hf.run_cell(root, cell, trace=trace)
    assert rc == 0, err
    keys = LINE_KEYS | ({"breakdown"} if trace else set())
    assert set(line) == keys and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["checks"]) >= set(limits[cell])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    man = Manifest(root)
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
        # no device ran on the CPU: only the whole-step share has a count
        assert set(line["metrics"]) <= {m["name"]
                                        for m in man.per_layer(
                                            man.cell(cell))}
    else:
        assert set(line["metrics"]) == {m["name"] for m in man.end_to_end(
            man.cell(cell))}
    assert err.strip().splitlines()[-1].startswith("check ")


def _alter_answer(monkeypatch):
    from preworld_tpu_torch.models.preworld import PreWorld

    orig = PreWorld._occupancy

    def altered(self, voxel_feats):
        occ, geo = orig(self, voxel_feats)
        occ = occ.clone()
        occ[..., :2] = (occ[..., :2] + 5) % self.cfg.num_classes
        return occ, geo

    monkeypatch.setattr(PreWorld, "_occupancy", altered)


def _state_unchanged(monkeypatch):
    from preworld_tpu_torch.train.train_state import ClippedAdamW

    def no_update(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        self.count += 1
        import torch
        return torch.linalg.vector_norm(torch.stack(
            [torch.zeros(()) if p.grad is None else p.grad.norm()
             for p in params]))

    monkeypatch.setattr(ClippedAdamW, "step", no_update)


def _half_batch(monkeypatch):
    from preworld_tpu_torch.models.preworld import PreWorld

    orig = PreWorld.loss

    def half(self, batch, generator):
        rows = batch["imgs"].shape[0] // 2
        return orig(self, {k: v[:rows] for k, v in batch.items()}, generator)

    monkeypatch.setattr(PreWorld, "loss", half)


def _ema_unchanged(monkeypatch):
    from preworld_tpu_torch.train import train_state

    monkeypatch.setattr(train_state, "ema_decay_schedule",
                        lambda updates, decay=0.999: 1.0)


def _ema_from_zero(monkeypatch):
    """The EMA's ramp restarted: its updates counted from 0, not from the
    configuration's `ema_init_updates`."""
    from preworld_tpu_torch.train import train_state

    orig = train_state.ema_decay_schedule
    monkeypatch.setattr(train_state, "ema_decay_schedule",
                        lambda updates, decay=0.999: orig(updates - 10560,
                                                          decay))


FAULTS = [("finetune-predict", _alter_answer),
          ("finetune-stream", _alter_answer),
          ("finetune-train", _state_unchanged),
          ("finetune-train", _half_batch),
          ("finetune-train", _ema_unchanged),
          ("finetune-train", _ema_from_zero),
          ("pretrain-train", _state_unchanged),
          ("pretrain-train", _half_batch),
          ("pretrain-train", _ema_unchanged),
          ("pretrain-train", _ema_from_zero)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    """A run whose timed path is broken underneath reads correct false
    under the cell's limits."""
    limits = {c: json.loads((hf.BENCH / "limits" / f"{c}.json").read_text())
              for c in hf.CELLS}
    root = hf.make_root(tmp_path, limits)
    fault(monkeypatch)
    rc, line, err = hf.run_cell(root, cell)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


def test_no_limits_is_no_pass(tiny_root):
    rc, line, err = hf.run_cell(tiny_root, "finetune-predict")
    assert rc == 0, err
    assert line["correct"] is False
