"""The forecasting cells `traj-rollout` and `traj-train-nf6` on the CPU at
tiny sizes (`tiny.py`'s finetune sizes: out_dim 16, a 20x20x8 grid): the
reference `traj.PreWorldTrajRef` against the program's `PreWorld4DTraj`,
the planted faults and the control over the cells' limits, the result
line of both cells, their readers, and the reference's imports."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

import harness_fixture as hf
import tiny
from benchmark.entries import traj_rollout, traj_train
from benchmark.harness.check import compare_logits, reference, reference_meta
from benchmark.harness.forecast import forecast_traffic
from benchmark.harness.inputs import make_state_dict, make_traffic
from benchmark.harness.manifest import Manifest
from benchmark.harness.program import build_program

CPU = torch.device("cpu")
CELLS = {"traj-rollout": "traj-rollout-closed",
         "traj-train-nf6": "traj-train-step"}
CONFIG = "tiny-finetune-traj"


def traj_config(tmp_path, num_future: int) -> dict:
    """The tiny finetune sizes as a forecasting configuration, remat on as
    in the cells' configuration."""
    s = dict(tiny.sizes("finetune"), remat=True, num_future=num_future)
    pc = tiny.write_program_config(tmp_path / "traj_program.py", s)
    pc.write_text(pc.read_text().replace("'type': 'PreWorld'",
                                         "'type': 'PreWorld4DTraj'"))
    return dict(tiny.config("finetune", program_config=str(pc)),
                name=CONFIG, reference="traj.PreWorldTrajRef", sizes=s)


def make_root(tmp_path, limits=None, num_future: int = 2):
    """`harness_fixture.make_root` with the two forecasting cells over the
    tiny forecasting configuration and their mixes shrunk as the others."""
    root = hf.make_root(tmp_path, limits)
    bench = root / "bench"
    cfg = traj_config(tmp_path, num_future)
    (bench / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": CONFIG, "source": "test",
                            "file": f"bench/configs/{CONFIG}.json",
                            "reduced": []})
    for cell, mix in CELLS.items():
        m = json.loads((hf.BENCH / "traffic" / f"{mix}.json").read_text())
        m.update(image_pool=4, max_frames=200, trace_frames=2)
        if "check_window" in m:
            m.update(check_frames=1, check_window=[0, 1])
        (bench / "traffic" / f"{mix}.json").write_text(json.dumps(m))
        data["workloads"].append({"name": cell, "config": CONFIG,
                                  "traffic": mix, "chips": 1, "why": "test"})
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(
            (limits or {}).get(cell, {})))
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    return root


def real_limits():
    return {c: json.loads((hf.BENCH / "limits" / f"{c}.json").read_text())
            for c in CELLS}


def program(cfg, seed):
    model = build_program(cfg, CPU)
    model.load_state_dict(make_state_dict(reference_meta(cfg), seed, CPU))
    return model


def mix(name):
    m = json.loads((hf.BENCH / "traffic" / f"{name}.json").read_text())
    m.update(image_pool=4, max_frames=50)
    return m


def test_reference_matches_program_predict(tmp_path):
    """A 6-step request: the program's 7 occupancy head outputs against
    the reference's `rollout` (atol 1e-4), each served grid their argmax."""
    from preworld_tpu_torch.data import to_device

    cfg = traj_config(tmp_path, 6)
    model = program(cfg, 21).eval()
    ref = reference(cfg, 21, CPU).eval()
    caps = []
    model.occupancy_head.register_forward_hook(
        lambda m, i, o: caps.append(o.detach().clone()))
    tr = forecast_traffic(make_traffic(cfg, mix("traj-rollout-closed"), 21,
                                       CPU), cfg, 21)
    with torch.no_grad():
        out = model.predict(to_device(tr.request(3), CPU), num_future=6)
        _, want = traj_rollout.ref_rollout(ref, tr, 3, CPU, 6)
    assert sorted(out) == [f"semantic_occ_{s}s" for s in range(7)]
    assert len(caps) == len(want) == 7
    for s, (got, r) in enumerate(zip(caps, want)):
        torch.testing.assert_close(got, r, atol=1e-4, rtol=0)
        c = compare_logits(got, out[f"semantic_occ_{s}s"], r)
        assert c["served_vs_logits"] == 0.0, (s, c)
    # the steps differ from one another: a rollout that stood still would
    # pass a shifted comparison
    assert compare_logits(want[1], want[2].argmax(-1), want[2])[
        "logit_rel_l2"] > 0.05


def test_reference_matches_program_train(tmp_path):
    """The program's first three train steps at num_future 2 (batch 2,
    remat, masks from one generator) against the reference's, by the
    cell's own check and limits."""
    from benchmark.harness.check import verdict

    cfg = traj_config(tmp_path, 2)
    model = program(cfg, 5)
    tr = make_traffic(cfg, mix("traj-train-step"), 5, CPU)
    e = traj_train.Entry(model, tr, CPU, 5, cfg)
    assert {"ego_states", "temporal_semantics", "temporal_trajs"} <= set(
        e.traffic.request(0))
    for k in range(traj_train.STEPS):
        e.run(k)
    assert "loss_traj_2s" in e.outputs()["parts"][0]
    out = e.outputs()
    assert len(out["steps"]) == 3 and len(out["waypoints"]) == 2
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = traj_train.check(cfg, tr, out, 5, CPU)
        # the check's references leave the flags as the program had them
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    assert got["loss_gap"] < 1e-5 and got["loss_traj_2s_gap"] < 1e-5, got
    assert got["rollout_rel_l2"] < 1e-5 and got["waypoint_rel_l2"] < 1e-5, got
    for n in ("grad", "moment", "update", "ema"):
        assert got[f"{n}_gap_median"] < 0.05, (n, got)
    limits = dict(real_limits()["traj-train-nf6"])
    limits["loss_traj_2s_gap"] = limits.pop("loss_traj_6s_gap")
    assert verdict(got, limits), got


def test_rollout_capture_copies_to_the_host(tmp_path):
    """Two captured requests: each step's logits and the key frame's
    feature reach the host, as a hook of the test's own sees them, and the
    second request's copies leave the first's untouched (the entry's
    buffers are reused, its kept outputs are not)."""
    cfg = traj_config(tmp_path, 6)
    model = program(cfg, 23)
    tr = make_traffic(cfg, mix("traj-rollout-closed"), 23, CPU)
    e = traj_rollout.Entry(model, tr, CPU, 23, cfg)
    seen = []
    model.occupancy_head.register_forward_hook(
        lambda m, i, o: seen.append((i[0].detach().clone(),
                                     o.detach().clone())))
    for k in (3, 4):
        e.capture(k)
        e.run(k)
    out = e.outputs()
    assert sorted(out["logits"]) == sorted(out["key_feats"]) == [3, 4]
    for j, k in enumerate((3, 4)):
        mine = seen[7 * j:7 * (j + 1)]
        assert torch.equal(out["key_feats"][k], mine[0][0])
        assert torch.equal(out["logits"][k], torch.stack([o for _, o in
                                                          mine]))
        assert out["logits"][k].device.type == "cpu"
    assert not torch.equal(out["logits"][3], out["logits"][4])
    e.close()


def test_rollout_check_keeps_the_tf32_flags(tmp_path):
    """The rollout check and its references leave the process's TF32
    flags as they found them, so that a program served after them in one
    process (`control.py --program`) runs as a timed run does."""
    cfg = traj_config(tmp_path, 6)
    tr = make_traffic(cfg, mix("traj-rollout-closed"), 24, CPU)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    for want in ((True, True), (False, True)):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = want
        try:
            got = traj_rollout.check(cfg, tr, {"logits": {}, "served": {},
                                               "key_feats": {}}, 24, CPU)
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == want
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
        assert got["logit_rel_l2"] == float("inf")  # nothing compared


def test_traffic_is_the_seeds():
    """The forecasting inputs are the seed's and k's alone: two wraps of
    two tracks of one seed agree, another seed differs; the waypoints are
    the drive's next poses in the key frame's ego frame."""
    import numpy as np

    cfg = tiny.config("finetune")
    cfg["sizes"]["num_future"] = 6
    m = mix("traj-train-step")
    a = forecast_traffic(make_traffic(cfg, m, 9, CPU), cfg, 9)
    b = forecast_traffic(make_traffic(cfg, m, 9, CPU), cfg, 9)
    c = forecast_traffic(make_traffic(cfg, m, 10, CPU), cfg, 10)
    ra, rb, rc = a.request(4), b.request(4), c.request(4)
    for k in ("ego_states", "temporal_semantics", "temporal_trajs"):
        assert np.array_equal(ra[k], rb[k]) and not np.array_equal(ra[k],
                                                                   rc[k])
    assert ra["temporal_semantics"].shape == (2, 6, 20, 20, 8)
    assert ra["ego_states"].shape == (2, 21)
    step = np.linalg.norm(np.diff(np.concatenate(
        [np.zeros((2, 1, 2)), ra["temporal_trajs"]], axis=1), axis=1),
        axis=-1)
    lo, hi = m["ego_step_m"]
    assert ((step > lo - 1e-4) & (step < hi + 1e-4)).all(), step
    assert (ra["temporal_trajs"][..., 0] > 0).all()  # ahead of the ego


def _stale_ego(monkeypatch):
    """The program forecasts every request from the first request's ego
    state (a stale cache)."""
    from preworld_tpu_torch.models.preworld_traj import PreWorld4DTraj

    orig, first = PreWorld4DTraj.predict, []

    def stale(self, batch, num_future=6):
        first.append(batch["ego_states"])
        return orig(self, dict(batch, ego_states=first[0]), num_future)

    monkeypatch.setattr(PreWorld4DTraj, "predict", stale)


def _steps_shifted(monkeypatch):
    """The program answers each step with the head run before the step."""
    from preworld_tpu_torch.models.preworld_traj import PreWorld4DTraj

    def shifted(self, batch, num_future=6):
        with torch.no_grad():
            vf, _ = self.extract_voxel_feat(batch)
            out = {"semantic_occ_0s": self._occupancy(vf)[0]}
            for step in range(1, num_future + 1):
                out[f"semantic_occ_{step}s"] = self._occupancy(vf)[0]
                vf, _ = self.rollout_step(vf, batch["ego_states"])
        return out

    monkeypatch.setattr(PreWorld4DTraj, "predict", shifted)


def _half_batch(monkeypatch):
    from preworld_tpu_torch.models.preworld_traj import PreWorld4DTraj

    orig = PreWorld4DTraj.loss

    def half(self, batch, generator, num_future=2):
        rows = batch["imgs"].shape[0] // 2
        return orig(self, {k: v[:rows] for k, v in batch.items()}, generator,
                    num_future)

    monkeypatch.setattr(PreWorld4DTraj, "loss", half)


def _ema_from_zero(monkeypatch):
    from preworld_tpu_torch.train import train_state

    orig = train_state.ema_decay_schedule
    monkeypatch.setattr(train_state, "ema_decay_schedule",
                        lambda updates, decay=0.999: orig(updates - 10560,
                                                          decay))


def _one_step_short(monkeypatch):
    """The program rolls out num_future - 1 steps."""
    from preworld_tpu_torch.models.preworld_traj import PreWorld4DTraj

    orig = PreWorld4DTraj.loss

    def short(self, batch, generator, num_future=2):
        return orig(self, batch, generator, num_future - 1)

    monkeypatch.setattr(PreWorld4DTraj, "loss", short)


FAULTS = [("traj-rollout", _stale_ego), ("traj-rollout", _steps_shifted),
          ("traj-train-nf6", _half_batch),
          ("traj-train-nf6", _ema_from_zero),
          ("traj-train-nf6", _one_step_short)]


def _future(cell: str) -> int:
    """The tiny cells' num_future: the request's 6 steps, the train step's
    2 (as the program's own train tests)."""
    return 6 if cell == "traj-rollout" else 2


def _cell_limits(num_future):
    lim = real_limits()
    t = lim["traj-train-nf6"]
    t[f"loss_traj_{num_future}s_gap"] = t.pop("loss_traj_6s_gap")
    return lim


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    """A run whose timed path is broken underneath reads correct false
    under the cell's limits (the train cell at num_future 2, its
    `loss_traj_6s_gap` limit on the last step's term, `_cell_limits`)."""
    root = make_root(tmp_path, _cell_limits(2), num_future=_future(cell))
    fault(monkeypatch)
    rc, line, err = hf.run_cell(root, cell)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_control_and_faults_read_apart(tmp_path, cell):
    """In the program's place, the reference in float8 reads at least
    three times the program on one of the cell's numbers and comes out not
    correct under limits set between the two readings; so does the
    reference with the forecasting heads in bfloat16 on the heads'
    numbers; each planted fault of `controls` reads over a limit the
    program meets among the numbers it has."""
    from benchmark import control
    from benchmark.harness.check import verdict

    root = make_root(tmp_path, num_future=_future(cell))
    man = Manifest(root)
    names = _cell_limits(2)[cell]
    (_, prog), = control.program_readings(cell, [31], CPU, man)
    got = control.readings(cell, 31, CPU, man)
    ctl = got["control"]
    # the float8 control's numbers: the train cell's heads are float32 in
    # it, and `heads_gaps` reads them in the bfloat16 control below
    apart = [k for k in names if k in ctl
             and ctl[k] >= 3 * max(prog[k], 1e-9)]
    assert apart, (prog, ctl)
    limits = {k: (max(prog[k], 1e-9) * ctl[k]) ** 0.5 if k in apart
              else names[k] for k in names if k in ctl}
    assert verdict(prog, limits) and not verdict(ctl, limits), (prog, ctl)
    heads = {k: names[k] for k in ("rollout_rel_l2", "waypoint_rel_l2")
             if k in names}
    low = got["rollout_bf16"]
    assert heads and all(low[k] >= 3 * max(prog[k], 1e-9) for k in heads), (
        prog, low)
    assert not verdict(low, {k: (max(prog[k], 1e-9) * low[k]) ** 0.5
                             for k in heads}), (prog, low)
    faults = {"traj-rollout": ("ego_other", "steps_shifted"),
              "traj-train-nf6": ("half_batch", "ema_from_zero",
                                 "num_future_short")}[cell]
    for f in faults:
        assert not verdict(got[f], {k: v for k, v in names.items()
                                    if k in got[f]}), (f, got[f])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", list(CELLS))
def test_result_line(tmp_path, cell, trace):
    """Both cells run through `harness.main.run` and print a correct
    result line with the metrics the manifest gives them."""
    root = make_root(tmp_path, _cell_limits(2), num_future=_future(cell))
    rc, line, err = hf.run_cell(root, cell, trace=trace)
    assert rc == 0, err
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    man = Manifest(root)
    w = man.cell(cell)
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device ran on the CPU: only the whole-step share has a count
        assert set(line["metrics"]) == {"mfu.infer" if "rollout" in cell
                                        else "mfu.train"}
    else:
        assert set(line["metrics"]) == {m["name"]
                                        for m in man.end_to_end(w)}
    if cell == "traj-rollout":
        assert line["checks"]["steps_compared"]["value"] == 7.0


def test_readers():
    """The new readers on a summary of a traced span: the rollout's module
    ranges and the occupancy head's a request, the `scan` operations a
    step, and nothing where the span holds none."""
    man = Manifest()
    s = {"frames": 2, "range_ms": {"plan_head": 0.5, "fusion_head": 9.0,
                                   "downscale": 3.0, "ego_fusion_head": 0.25,
                                   "traj_head": 0.25, "occupancy_head": 14.0,
                                   "outside": 5.0},
         "device_ops": [["void at::native::tensor_kernel_scan_innermost_dim"
                         "<float, std::plus<float> >", 0.3],
                        ["gemm", 0.2], ["DeviceScanKernel", 0.1]]}
    assert man.reader("rollout_ms.infer").read(s) == 6.5
    assert man.reader("rollout_heads_ms.infer").read(s) == 7.0
    assert man.reader("lovasz_scan_ms.train").read(s) == pytest.approx(
        200.0)
    empty = {"frames": 2, "range_ms": {"img_backbone": 1.0},
             "device_ops": [["gemm", 0.2]]}
    for name in ("rollout_ms.infer", "rollout_heads_ms.infer",
                 "lovasz_scan_ms.train"):
        assert man.reader(name).read(empty) is None


def test_cells_in_the_manifest():
    """The real manifest: the configuration, its two one-chip cells, their
    metrics and readers, and the reference's forecasting parameters."""
    man = Manifest()
    for cell, moves in (("traj-rollout", {"occ_frames_per_s",
                                           "frame_ms_p95"}),
                        ("traj-train-nf6", {"train_samples_per_s"})):
        w = man.cell(cell)
        assert w["chips"] == 1 and w["config"] == "preworld-7frame-finetune-traj"
        e2e = {m["name"] for m in man.end_to_end(w)}
        assert e2e == moves | {"peak_mem_gb", "setup_s"}
        for m in man.per_layer(w):
            r = man.reader(m["name"])
            assert (r.LAYER, r.UNIT, r.MOVES) == (m["layer"], m["unit"],
                                                  m["moves"])
        entry = man.entry(man.traffic(w))
        for name in ("Entry", "MODULE_RANGES", "sample", "check", "work",
                     "controls"):
            assert hasattr(entry, name)
        assert man.limits(w)
    cfg = man.config(man.cell("traj-rollout"))
    assert cfg["sizes"]["num_future"] == 6
    assert cfg["reference"] == "traj.PreWorldTrajRef"
    assert set(reference_meta(cfg).state_dict()) >= {
        "plan_head.fc1.weight", "fusion_head.Dense_0.weight",
        "downscale.down3.bias", "ego_fusion_head.fc3.weight",
        "traj_head.Dense_1.weight"}


def test_reference_imports_nothing_of_the_program(tmp_path):
    """A fresh process that imports the forecasting reference and the
    forecasting inputs loads nothing of the program, JAX or the JAX
    package."""
    forbidden = {"jax", "jaxlib", "flax", "optax", "preworld_tpu",
                 "preworld_tpu_torch"}
    code = ("import sys, json; sys.path.insert(0, '.');"
            "import benchmark.reference.traj, benchmark.harness.forecast;"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(hf.ROOT), timeout=600,
                         check=True).stdout
    assert not set(json.loads(out.strip().splitlines()[-1])) & forbidden
