"""The train CLI (`preworld_tpu_torch.tools.train`) in two gloo processes
on the CPU (`--device cpu`), against its one-process run at the global
batch, on tiny configs written per test over the repo's config files (the
tiny backbone, a 20x20x8 grid, 2 cameras at 64x128, f32, 64 rays).

  * under `python -m torch.distributed.run --nproc_per_node 2`, the
    finetune config at `samples_per_gpu` 1 (global batch 2): exit 0,
    exactly one JSON line, exactly one checkpoint and one metrics record
    per iteration, all from rank 0; the last iteration's losses and the
    checkpoint's parameters, EMA and BatchNorm statistics those of the
    one-process run at `samples_per_gpu` 2, with the same dropout masks
    (the parameters' and the EMA's movement from the initial weights at
    rel-L2 0.05, the step test's gate on the clipped gradients: AdamW's
    first updates follow their signs);
  * `--auto-resume` in both ranks (started with torchrun's environment,
    each returning its own result): both restore step 2 and save step 3;
  * `parallel.n_seq=2` on the pretrain config (the two ranks hold the same
    scene and render half its rays each) with `--validate`: the losses of
    the one-process run, and an eval of 3 samples that counts 3.

Tolerances, as `tests/test_torch_train_step.py` holds a step: losses rtol
1e-4, the pre-clip gradient norm rtol 0.01, BatchNorm statistics rtol
1e-3 / atol 1e-5.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist
from preworld_tpu_torch.tools import train as cli_train

TINY = """
_base_ = ["{base}"]
data_config = dict(input_size=(64, 128), Ncams=2)
grid_config = dict(x=[-8.0, 8.0, 0.8], y=[-8.0, 8.0, 0.8],
                   z=[-1.0, 5.4, 0.8], depth=[1.0, 9.0, 0.5])
model = dict(backbone="tiny", neck_out_channels=64, num_trans_channels=16,
             out_dim=16, dtype="float32", remat=False)
data = dict(samples_per_gpu={spg}, workers_per_gpu=1,
            train=dict(max_ray_nums=64))
log_interval = 1
"""
FINETUNE = "configs/preworld/preworld_7frame_finetune.py"
PRETRAIN = "configs/preworld/preworld_7frame_pretrain.py"
ARGS = ["--synthetic", "--epochs", "1", "--device", "cpu"]
WORKER = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from preworld_tpu_torch.tools import train
r = train.main({argv!r})
print("RANK_RESULT " + json.dumps({{"step": r["step"],
                                    "metrics": r["metrics"]}}))
"""


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_config(tmp, name, base, spg):
    path = tmp / f"{name}.py"
    path.write_text(TINY.format(base=os.path.join(torch_dist.REPO, base),
                                spg=spg))
    return str(path)


def rank_results(argv):
    """`train.main(argv)` in two processes with torchrun's environment:
    each rank's step and metrics."""
    code = WORKER.format(repo=torch_dist.REPO, argv=list(argv))
    outs = torch_dist.Ranks([[sys.executable, "-c", code]] * 2).wait()
    return [json.loads(out.split("RANK_RESULT ", 1)[1]) for out, _ in outs]


def initial_params(config):
    """The CLI's model at its seed (`--seed 0`), before any step."""
    from preworld_tpu_torch.train import build_model
    from preworld_tpu_torch.utils import Config

    torch.manual_seed(0)
    model = build_model(Config.fromfile(config), device="cpu")
    return {n: p.detach() for n, p in model.named_parameters()}


def update_rel_l2(got, want, init):
    """rel-L2 of one run's parameter movement from `init` against the
    other's: AdamW's first updates are near lr * sign(g), so this is the
    step test's clipped-gradient gate (0.05) on the updates (an element
    whose gradient is near 0 may move either way)."""
    d = [(got[n] - p).reshape(-1) for n, p in init.items()]
    w = [(want[n] - p).reshape(-1) for n, p in init.items()]
    d, w = torch.cat(d).double(), torch.cat(w).double()
    assert float(w.norm()) > 0
    return float((d - w).norm() / w.norm())


def check_metrics(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        tol = dict(rtol=0.01) if k == "grad_norm" else dict(rtol=1e-4)
        np.testing.assert_allclose(got[k], v, err_msg=k, **tol)


@pytest.fixture(scope="module")
def torchrun(tmp_path_factory):
    """The finetune config under torchrun (2 x batch 1) and in one process
    (batch 2), 2 iterations each."""
    tmp = tmp_path_factory.mktemp("torchrun")
    work = str(tmp / "work")
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", "2", "--master_port",
           str(torch_dist.free_port()), "-m", "preworld_tpu_torch.tools.train",
           write_config(tmp, "ft", FINETUNE, 1), "--work-dir", work,
           "--max-iters", "2", *ARGS]
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="2")
    proc = subprocess.run(cmd, env=env, cwd=torch_dist.REPO,
                          capture_output=True, text=True, timeout=240)
    one = cli_train.main([write_config(tmp, "ft2", FINETUNE, 2),
                          "--work-dir", str(tmp / "one"), "--max-iters", "2",
                          *ARGS])
    return dict(proc=proc, work=work, one=one, tmp=tmp,
                config=write_config(tmp, "ft_resume", FINETUNE, 1))


def test_torchrun_trains_like_one_process(torchrun):
    proc = torchrun["proc"]
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, proc.stdout
    got, one = json.loads(lines[0]), torchrun["one"]
    assert got["step"] == one["step"] == 2
    check_metrics(got["metrics"], one["metrics"])
    ckpts = os.path.join(torchrun["work"], "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["2.pt"]
    with open(os.path.join(torchrun["work"], "metrics.jsonl")) as fh:
        assert [json.loads(ln)["iter"] for ln in fh] == [1, 2]
    a = torch.load(os.path.join(ckpts, "2.pt"), weights_only=True)
    b = torch.load(one["checkpoint"], weights_only=True)
    init = initial_params(torchrun["config"])
    for k, v in b["model"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(a["model"][k].numpy(), v.numpy(),
                                       rtol=1e-3, atol=1e-5, err_msg=k)
    for what in ("model", "ema_params"):
        assert update_rel_l2(a[what], b[what], init) < 0.05, what
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == 2


def test_both_ranks_resume(torchrun):
    work = str(torchrun["tmp"] / "resume")
    shutil.copytree(torchrun["work"], work)
    res = rank_results([torchrun["config"], "--work-dir", work,
                        "--auto-resume", "--max-iters", "1", *ARGS])
    assert [r["step"] for r in res] == [3, 3]
    assert res[0]["metrics"] == res[1]["metrics"]
    assert sorted(os.listdir(os.path.join(work, "checkpoints"))) == [
        "2.pt", "3.pt"]


def test_seq_split_trains_like_one_process_and_evaluates_once(tmp_path):
    args = ["--max-iters", "1", "--validate", "--val-samples", "3", *ARGS]
    work = str(tmp_path / "seq")
    res = rank_results([write_config(tmp_path, "pt", PRETRAIN, 1),
                        "--work-dir", work, "--cfg-options",
                        "parallel.n_seq=2", *args])
    one = cli_train.main([write_config(tmp_path, "pt1", PRETRAIN, 1),
                          "--work-dir", str(tmp_path / "one"), *args])
    assert res[0]["metrics"] == res[1]["metrics"]
    assert "loss_render_depth" in one["metrics"]
    check_metrics(res[0]["metrics"], one["metrics"])
    with open(os.path.join(work, "metrics.jsonl")) as fh:
        evals = [json.loads(ln)["eval"] for ln in fh if '"eval"' in ln]
    assert len(evals) == 1 and evals[0]["count"] == 3


@pytest.mark.parametrize("device,want", [
    ("cuda", "no CUDA device cuda:1"), ("cuda:3", "no CUDA device cuda:3"),
    ("cpu", None)])
def test_a_rank_with_no_card_is_an_error(monkeypatch, device, want):
    """Under torchrun a bare `--device cuda` is cuda:$LOCAL_RANK; a rank
    whose card is not there raises (one card here, LOCAL_RANK 1), never a
    quiet remap to another card or the CPU."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if want is None:
        assert cli_train.process_device(device) == torch.device("cpu")
    else:
        with pytest.raises(RuntimeError, match=want):
            cli_train.process_device(device)
