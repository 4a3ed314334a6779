"""The reference against the program's plain CPU path at tiny sizes (the
test may import both; the reference imports nothing of the program), the
control's lower precision failing the cells' limits, and the imports of
a fresh process."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

import harness_fixture as hf
import tiny
from benchmark.entries import predict, stream, train
from benchmark.harness.check import (
    compare_logits,
    compare_train,
    initial_params,
    ref_train,
    reference,
    reference_meta,
)
from benchmark.harness.inputs import make_state_dict, make_traffic
from benchmark.harness.manifest import Manifest
from benchmark.harness.program import build_program

CPU = torch.device("cpu")


def program(tmp_path, stage, backbone, seed):
    s = tiny.sizes(stage, backbone)
    cfg = tiny.config(stage, backbone, str(tiny.write_program_config(
        tmp_path / "program.py", s)))
    model = build_program(cfg, CPU)
    model.load_state_dict(make_state_dict(reference_meta(cfg), seed, CPU))
    return cfg, model


def mix(name):
    m = json.loads((hf.BENCH / "traffic" / f"{name}.json").read_text())
    m.update(image_pool=4, max_frames=50)
    return m


@pytest.mark.parametrize("backbone", ["tiny", "swin"])
def test_reference_matches_program_inference(tmp_path, backbone):
    """Predict (3 frames) and five streaming steps: the program's logits
    and answers against the reference's at float32."""
    from preworld_tpu_torch.data import to_device

    cfg, model = program(tmp_path, "finetune", backbone, 21)
    model.eval()
    ref = reference(cfg, 21, CPU).eval()
    caps = []
    model.occupancy_head.register_forward_hook(
        lambda m, i, o: caps.append(o.detach().clone()))
    tr = make_traffic(cfg, mix("predict-closed"), 21, CPU)
    with torch.no_grad():
        occ = model.predict(to_device(tr.request(3), CPU))["semantic_occ"]
        got = compare_logits(caps[-1], occ,
                             predict.ref_logits(ref, tr, 3, CPU))
    assert got["logit_rel_l2"] < 1e-5 and got["served_vs_logits"] == 0.0, got
    tr = make_traffic(cfg, mix("stream-closed"), 22, CPU)
    cache = model.init_sequential_cache(to_device(tr.frame(0), CPU))
    with torch.no_grad():
        for k in range(5):
            out, cache = model.predict_sequential(to_device(tr.frame(k), CPU),
                                                  cache)
            if k >= 2:
                got = compare_logits(caps[-1], out["semantic_occ"],
                                     stream.ref_logits(ref, tr, k, CPU))
                assert got["logit_rel_l2"] < 1e-5, (k, got)


@pytest.mark.parametrize("stage", ["finetune", "pretrain"])
def test_reference_matches_program_train(tmp_path, stage):
    """The program's first three train steps (batch 2, masks from one
    generator) against the reference's: losses, step-1 gradients, the
    first moments, and the change of the parameters and of their EMA."""
    cfg, model = program(tmp_path, stage, "tiny", 5)
    tr = make_traffic(cfg, mix("train-step"), 5, CPU)
    assert tr.batch == cfg["train"]["batch"] and tr.labels
    e = train.Entry(model, tr, CPU, 5, cfg)
    for k in range(train.STEPS):
        e.run(k)
    got = compare_train(e.outputs(), ref_train(cfg, tr, 5, CPU),
                        initial_params(cfg, 5, CPU))
    assert got["loss_gap"] < 1e-5, got
    for n in ("grad", "moment", "update", "ema"):
        assert got[f"{n}_gap_median"] < 0.05, (n, got)


@pytest.mark.parametrize("cell", list(hf.CELLS))
def test_control_is_not_correct(tmp_path, cell):
    """The reference in float8 in the program's place reads at least three
    times the program on one of the numbers the cell compares, and comes
    out not correct under limits set between the two readings as the
    cell's were (at tiny sizes, the inference cells on a small Swin; the
    card's readings at the cells' own sizes are in PERF.md)."""
    from benchmark import control
    from benchmark.harness.check import verdict

    root = hf.make_root(tmp_path, backbone="tiny" if "train" in cell
                        else "swin")
    man = Manifest(root)
    names = json.loads((hf.BENCH / "limits" / f"{cell}.json").read_text())
    (_, prog), = control.program_readings(cell, [31], CPU, man)
    ctl = control.readings(cell, 31, CPU, man)["control"]
    apart = [k for k in names if ctl[k] >= 3 * max(prog[k], 1e-9)]
    assert apart, (prog, ctl)
    limits = {k: (max(prog[k], 1e-9) * ctl[k]) ** 0.5 if k in apart
              else names[k] for k in names}
    assert verdict(prog, limits) and not verdict(ctl, limits), (prog, ctl)


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=str(hf.ROOT), timeout=600, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_no_jax_in_a_run(tmp_path):
    """A fresh process that imports benchmark/run.py and the reference, and
    drives a tiny run, loads nothing whose top-level name is jax, jaxlib,
    flax, optax or preworld_tpu; the reference alone loads nothing of the
    program."""
    forbidden = {"jax", "jaxlib", "flax", "optax", "preworld_tpu"}
    tops = ("json.dumps(sorted({m.split('.')[0] for m in sys.modules}))")
    ref_only = _modules_after(
        "import sys, json; sys.path.insert(0, '.');"
        "import benchmark.reference.model, benchmark.reference.optim,"
        "benchmark.counts.work; print(" + tops + ")")
    assert not ref_only & (forbidden | {"preworld_tpu_torch"})
    root = hf.make_root(tmp_path)
    run = _modules_after(
        "import sys, json; sys.path.insert(0, '.');"
        "sys.path.insert(0, 'benchmark/tests');"
        "import runpy; runpy.run_path('benchmark/run.py', run_name='x');"
        "import harness_fixture as hf; from pathlib import Path;"
        f"rc, line, err = hf.run_cell(Path({str(root)!r}), "
        "'finetune-predict'); assert rc == 0, err;"
        "print(" + tops + ")")
    assert "preworld_tpu_torch" in run and not run & forbidden


def test_run_needs_a_card(monkeypatch):
    """run.py fails with no CUDA device and prints no result."""
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "finetune-predict", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, cwd=str(hf.ROOT),
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"},
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.card
def test_cell_on_the_card(card):
    """A short run of the flagship cell on the card is correct."""
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "finetune-predict", "--seed", "2147483659",
                        "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, cwd=str(hf.ROOT),
                       timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"] is True
