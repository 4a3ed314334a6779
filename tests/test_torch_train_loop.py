"""The port's train loop and checkpoints (`preworld_tpu_torch/train/loop.py`,
`train/checkpoints.py`).

  * Resume, bit for bit: on a tiny finetune config fed eval-mode samples
    of the miniature nuScenes tree (`test_torch_data.py`'s fixture), two
    uninterrupted epochs of one iteration equal one epoch, a checkpoint, a
    fresh state restored by `maybe_resume` and one more epoch, with the
    same `torch.Generator` passed on: every parameter, buffer, AdamW
    moment, EMA tensor, the optimizer's `count`, `ema_updates` and `step`.
    A checkpoint whose optimizer restarts its count (what a file without
    `count` would give) must fail that comparison.
  * `maybe_resume`'s explicit-path semantics (`tests/test_train_infra.py`
    `TestResumeFrom`), `max_to_keep`, and a save cut midway leaving the
    previous checkpoint readable.
  * The port's `train_epochs` and the JAX one, each driven by a trivial
    step function over the same loader, write the same `metrics.jsonl`
    records (`time_per_iter` and the port's `data_wait` aside) and see
    the same batches.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preworld_tpu.train.loop import train_epochs as jax_train_epochs
from preworld_tpu_torch.data import DataLoader, NuScenesOccDataset
from preworld_tpu_torch.data import tiny_config
from preworld_tpu_torch.geometry import GridConfig
from preworld_tpu_torch.models import PreWorld
from preworld_tpu_torch.train import (
    create_train_state,
    latest_step,
    make_optimizer,
    make_train_step,
    maybe_resume,
    restore_checkpoint,
    save_checkpoint,
    train_epochs,
)
from preworld_tpu_torch.train import checkpoints
from preworld_tpu_torch.utils import init_weights
from test_torch_data import DATA_CONFIG, GRID_CONFIG, fake_nuscenes  # noqa: F401

EPOCH_KW = dict(max_iters_per_epoch=1, log_interval=1)


def _tiny_state():
    cfg = tiny_config(
        input_size=DATA_CONFIG["input_size"], num_cams=2,
        grid=GridConfig(**{k: tuple(v) for k, v in GRID_CONFIG.items()}),
        if_post_finetune=True, if_render=False, use_lss_depth_loss=False)
    model = PreWorld(cfg)
    init_weights(model, seed=0, fan_in=True)
    # a short warmup and a large lr, so the step count moves the update
    opt = make_optimizer(model.parameters(), base_lr=1e-2, warmup_iters=4)
    return create_train_state(model, opt, init_ema_updates=10560)


def _loader(fake_nuscenes):  # noqa: F811
    root, ann = fake_nuscenes
    ds = NuScenesOccDataset(ann_file=ann, data_config=DATA_CONFIG,
                            grid_config=GRID_CONFIG, is_train=False)
    return DataLoader(ds, batch_size=2, num_workers=2, seed=0)


def _flat(state):
    """Every tensor and number a resumed run must carry, by name."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for n, p in state.model.named_parameters():
        for k in ("mu", "nu"):
            out[f"{k}.{n}"] = state.optimizer.state[p][k]
        out[f"ema.{n}"] = state.ema_params[n]
    out.update(count=state.optimizer.count, step=state.step,
               ema_updates=state.ema_updates)
    return out


def mismatches(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    bad = []
    for k, v in fa.items():
        w = fb[k]
        same = (v.dtype == w.dtype and v.shape == w.shape
                and bool(torch.equal(v, w))) if torch.is_tensor(v) \
            else v == w
        if not same:
            bad.append(k)
    return bad


def _records(work_dir):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        r.pop("time_per_iter", None)
        r.pop("data_wait", None)  # host timings
    return recs


@pytest.fixture(scope="module")
def uninterrupted(fake_nuscenes, tmp_path_factory):  # noqa: F811
    work = str(tmp_path_factory.mktemp("straight"))
    state = train_epochs(_tiny_state(), make_train_step(),
                         _loader(fake_nuscenes), 2, work,
                         generator=torch.Generator().manual_seed(5),
                         **EPOCH_KW)
    return state, work


def _resumed(fake_nuscenes, work):  # noqa: F811
    gen = torch.Generator().manual_seed(5)
    loader = _loader(fake_nuscenes)
    train_epochs(_tiny_state(), make_train_step(), loader, 1, work,
                 generator=gen, **EPOCH_KW)
    state, resumed = maybe_resume(_tiny_state(), work)
    assert resumed and state.step == 1 and state.optimizer.count == 1
    return train_epochs(state, make_train_step(), loader, 2, work,
                        generator=gen, start_epoch=1, **EPOCH_KW)


def test_resume_is_bit_exact(fake_nuscenes, uninterrupted,  # noqa: F811
                             tmp_path):
    straight, straight_dir = uninterrupted
    state = _resumed(fake_nuscenes, str(tmp_path))
    assert state.step == 2 and state.optimizer.count == 2
    assert mismatches(state, straight) == []
    assert _records(str(tmp_path)) == _records(straight_dir)
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["1.pt", "2.pt"]


def test_resume_without_count_fails(fake_nuscenes, uninterrupted,  # noqa: F811
                                    tmp_path, monkeypatch):
    """A checkpoint that does not carry the optimizer's count restarts the
    warmup lr and the bias correction: the parameters and the EMA diverge
    (the moments of the step after the resume do not: they read the same
    gradients)."""
    real = checkpoints.state_dict

    def no_count(state):
        d = real(state)
        d["optimizer"]["count"] = 0
        return d

    monkeypatch.setattr(checkpoints, "state_dict", no_count)
    gen = torch.Generator().manual_seed(5)
    loader = _loader(fake_nuscenes)
    train_epochs(_tiny_state(), make_train_step(), loader, 1, str(tmp_path),
                 generator=gen, **EPOCH_KW)
    state, _ = maybe_resume(_tiny_state(), str(tmp_path))
    state = train_epochs(state, make_train_step(), loader, 2, str(tmp_path),
                         generator=gen, start_epoch=1, **EPOCH_KW)
    bad = mismatches(state, uninterrupted[0])
    assert "count" in bad
    assert any(k.startswith("model.") for k in bad)
    assert any(k.startswith("ema.") for k in bad)


def _small_state(step=0):
    model = torch.nn.Sequential(torch.nn.Linear(3, 4),
                                torch.nn.BatchNorm1d(4))
    state = create_train_state(model, make_optimizer(model.parameters()))
    state.step = step
    return state


class TestResumeFrom:
    def test_explicit_path_work_dir_and_ckpt_dir(self, tmp_path):
        src = tmp_path / "pretrain_run"
        save_checkpoint(str(src / "checkpoints"), _small_state(7), 7)
        # fresh work_dir with no checkpoints: auto-resume finds nothing...
        _, resumed = maybe_resume(_small_state(), str(tmp_path / "finetune"))
        assert not resumed
        # ...but an explicit path restores from the other run, given
        # either the work_dir or the checkpoints dir itself
        for path in (str(src), str(src / "checkpoints")):
            restored, resumed = maybe_resume(
                _small_state(), str(tmp_path / "finetune"), resume_from=path)
            assert resumed and restored.step == 7

    def test_explicit_path_missing_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            maybe_resume(_small_state(), str(tmp_path),
                         resume_from=str(tmp_path / "x"))


def test_max_to_keep_and_latest(tmp_path):
    ckpt = str(tmp_path / "ck")
    assert latest_step(ckpt) is None
    assert restore_checkpoint(ckpt, _small_state()) is None
    for s in range(1, 6):
        save_checkpoint(ckpt, _small_state(s), s, max_to_keep=3)
    assert sorted(os.listdir(ckpt)) == ["3.pt", "4.pt", "5.pt"]
    assert latest_step(ckpt) == 5
    assert restore_checkpoint(ckpt, _small_state(), step=4).step == 4
    # plain tensors and numbers only: the weights-only loader reads it
    d = torch.load(os.path.join(ckpt, "5.pt"), weights_only=True)
    assert sorted(d) == ["ema_params", "ema_updates", "model", "optimizer",
                         "step"]
    assert "1.num_batches_tracked" in d["model"]


def test_cut_save_keeps_previous_checkpoint(tmp_path, monkeypatch):
    ckpt = str(tmp_path)
    save_checkpoint(ckpt, _small_state(1), 1)
    real = torch.save

    def cut(obj, path):
        real(obj, path)
        with open(path, "r+b") as f:
            f.truncate(100)
        raise RuntimeError("cut")

    monkeypatch.setattr(torch, "save", cut)
    with pytest.raises(RuntimeError, match="cut"):
        save_checkpoint(ckpt, _small_state(2), 2)
    monkeypatch.undo()
    assert os.listdir(ckpt) == ["1.pt"]
    assert restore_checkpoint(ckpt, _small_state()).step == 1


class _Dataset:
    def __len__(self):
        return 11

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.float32)}


def test_loop_records_match_jax(tmp_path):
    """Both loops over one loader (batch 2, 5 batches an epoch, 3 taken),
    logging every 2 iterations, a hook and an eval each epoch."""
    loader = DataLoader(_Dataset(), batch_size=2, num_workers=1, seed=4)
    kw = dict(max_epochs=3, log_interval=2, checkpoint_interval=100,
              start_epoch=1, max_iters_per_epoch=3)
    seen, hooks = {"port": [], "jax": []}, {"port": [], "jax": []}

    def port_step(state, batch, generator):
        seen["port"].append(batch["x"].numpy().copy())
        return state, {"loss": batch["x"].sum() / 3, "first": batch["x"][0, 0]}

    def jax_step(state, batch, rng):
        return state, {"loss": jnp.sum(batch["x"]) / 3,
                       "first": batch["x"][0, 0]}

    class Recording:
        def __init__(self, name):
            self.name = name

        def set_epoch(self, epoch):
            loader.set_epoch(epoch)

        def __iter__(self):
            for b in loader:
                if self.name == "jax":
                    seen["jax"].append(b["x"].copy())
                yield b

    state = types.SimpleNamespace(model=torch.nn.Linear(1, 1), step=0)
    train_epochs(state, port_step, Recording("port"),
                 work_dir=str(tmp_path / "port"),
                 set_epoch_hooks=[hooks["port"].append],
                 eval_fn=lambda s: {"mIoU": 1.5}, **kw)
    jax_train_epochs({"n": jnp.zeros(())}, jax_step, Recording("jax"),
                     work_dir=str(tmp_path / "jax"),
                     set_epoch_hooks=[hooks["jax"].append],
                     rng=jax.random.PRNGKey(0),
                     eval_fn=lambda s: {"mIoU": 1.5}, **kw)
    assert hooks["port"] == hooks["jax"] == [1, 2]
    # the JAX loop draws one more batch before it breaks
    assert len(seen["port"]) == 6
    for g, w in zip(seen["port"], [b for i, b in enumerate(seen["jax"])
                                   if i % 4 != 3]):
        np.testing.assert_array_equal(g, w)
    got, want = _records(str(tmp_path / "port")), \
        _records(str(tmp_path / "jax"))
    assert got == want
    assert [r.get("iter") for r in got] == [2, None, 2, None]


def test_profile_dir_writes_a_trace(tmp_path):
    loader = DataLoader(_Dataset(), batch_size=1, num_workers=1, seed=0)
    state = types.SimpleNamespace(model=torch.nn.Linear(1, 1), step=0)
    train_epochs(state, lambda s, b, g: (s, {"x": b["x"].sum()}), loader, 1,
                 str(tmp_path), checkpoint_interval=2,
                 profile_dir=str(tmp_path / "prof"))
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
