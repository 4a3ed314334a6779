"""A checkout in miniature for the CPU tests: BENCHMARK.json with the four
cells' names over tiny configurations, the real traffic mixes shrunk to a
few inputs, the real readers, and limits that the test chooses."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import time
import types
from pathlib import Path
from typing import Dict, Optional

import torch

import tiny

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

CELLS = {"finetune-predict": ("finetune", "predict-closed"),
         "pretrain-train": ("pretrain", "train-step"),
         "finetune-train": ("finetune", "train-step"),
         "finetune-stream": ("finetune", "stream-closed")}


def make_root(tmp: Path, limits: Optional[Dict[str, Dict]] = None,
              backbone: str = "tiny") -> Path:
    """A root with BENCHMARK.json and bench/ whose cells are the real
    cells' names and mixes at tiny sizes."""
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp / "bench"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "layer_metrics", bench / "layer_metrics",
                    dirs_exist_ok=True)
    configs = []
    for stage in ("finetune", "pretrain"):
        s = tiny.sizes(stage, backbone)
        pc = tiny.write_program_config(tmp / f"{stage}_program.py", s)
        c = tiny.config(stage, backbone, str(pc))
        (bench / "configs" / f"tiny-{stage}.json").write_text(json.dumps(c))
        configs.append({"name": f"tiny-{stage}", "source": "test",
                        "file": f"bench/configs/tiny-{stage}.json",
                        "reduced": []})
    for mix in ("predict-closed", "stream-closed", "train-step"):
        m = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
        m.update(image_pool=4, max_frames=200, trace_frames=2)
        if "check_window" in m:
            m.update(check_frames=1, check_window=[0, 1])
        (bench / "traffic" / f"{mix}.json").write_text(json.dumps(m))
    cells = []
    for name, (stage, mix) in CELLS.items():
        cells.append({"name": name, "config": f"tiny-{stage}",
                      "traffic": mix, "chips": 1, "why": "test"})
        lim = (limits or {}).get(name, {})
        (bench / "limits" / f"{name}.json").write_text(json.dumps(lim))
    data = dict(real, paths=["bench"], configs=configs, workloads=cells)
    (tmp / "BENCHMARK.json").write_text(json.dumps(data))
    return tmp


def run_cell(root: Path, cell: str, seed: int = 7, trace: int = 0,
             seconds: float = 0.0):
    """Drive one run on the CPU; returns (exit code, result line or None,
    standard error)."""
    from benchmark.harness.main import run
    from benchmark.harness.manifest import Manifest

    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=seconds,
                                 trace=trace)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run(args, time.perf_counter(), device=torch.device("cpu"),
                 man=Manifest(root))
    lines = out.getvalue().strip().splitlines()
    line = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, line, err.getvalue()
