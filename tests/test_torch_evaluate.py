"""The port's evaluation (`preworld_tpu_torch/train/evaluate.py`) against the
JAX package's `train/evaluate.py`.

  * `rank_padded_indices` and `_batched` over a grid of sample counts and
    process counts;
  * `evaluate_miou` (with an F-score metric and a dump callback) and
    `evaluate_miou_temporal`, each with a stub predict function, against
    the JAX functions on a one-device CPU mesh: equal results;
  * the EMA: with a stepped state the port's eval scores the EMA weights
    (exactly the histogram of a second model loaded with them) and leaves
    the parameters, their gradients, the BatchNorm buffers, the optimizer
    and each module's mode as they were;
  * two processes joined by gloo: rank 0's mIoU over 5 samples (an odd
    count, so the ranks pad) equals the serial oracle, as
    `tests/test_multihost_eval.py` checks the JAX package.
"""

import json
import os
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preworld_tpu.metrics import MetricFScore as JaxMetricFScore
from preworld_tpu.parallel import make_mesh
from preworld_tpu.train import evaluate as jax_evaluate
from preworld_tpu_torch.data import synthetic_batch, tiny_config, to_device
from preworld_tpu_torch.metrics import MetricFScore, MetricMIoU
from preworld_tpu_torch.models import PreWorld
from preworld_tpu_torch.train import (
    create_train_state,
    make_optimizer,
    make_train_step,
)
from preworld_tpu_torch.train import evaluate
from preworld_tpu_torch.utils import init_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLASSES = 4
SHAPE = (6, 5, 3)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_rank_padded_indices_and_batched_match_jax(world):
    for n in range(0, 8):
        for rank in range(world):
            got = list(evaluate.rank_padded_indices(n, rank, world))
            assert got == list(jax_evaluate.rank_padded_indices(
                n, rank, world))
            samples = [{"i": np.asarray([i]), "_valid": v} for i, v in got]
            for bs in (1, 2, 3):
                a = list(evaluate._batched(samples, bs))
                b = list(jax_evaluate._batched(samples, bs))
                assert [nv for _, nv in a] == [nv for _, nv in b]
                for (ba, _), (bb, _) in zip(a, b):
                    np.testing.assert_array_equal(ba["i"], bb["i"])
    assert list(evaluate.rank_padded_indices(3)) == [(0, True), (1, True),
                                                      (2, True)]


def _samples(n, temporal=False):
    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        s = {"imgs": rng.uniform(0.0, 1.0, SHAPE).astype(np.float32),
             "bda": np.eye(3, dtype=np.float32),
             "voxel_semantics": rng.integers(0, N_CLASSES, SHAPE),
             "mask_camera": rng.uniform(size=SHAPE) > 0.3,
             "mask_lidar": rng.uniform(size=SHAPE) > 0.5}
        if temporal:  # no ground truth at horizon 2
            for h in (0, 1, 3):
                s[f"gt_h{h}"] = rng.integers(0, N_CLASSES, SHAPE)
        out.append(s)
    return out


def _occ_np(imgs, k=7.0):
    return (np.abs(imgs) * k).astype(np.int32) % N_CLASSES


def _port_predict(params, batch):
    x = batch["imgs"]
    out = {"semantic_occ": (x.abs() * 7.0).to(torch.int32) % N_CLASSES}
    for s in (0, 1, 3, 5):
        out[f"semantic_occ_{s}s"] = (x.abs() * (3.0 + s)).to(
            torch.int32) % N_CLASSES
    return out


@jax.jit
def _jax_predict(params, batch_stats, b):
    x = b["imgs"]
    out = {"semantic_occ": (jnp.abs(x) * 7.0).astype(jnp.int32) % N_CLASSES}
    for s in (0, 1, 3, 5):
        out[f"semantic_occ_{s}s"] = (jnp.abs(x) * (3.0 + s)).astype(
            jnp.int32) % N_CLASSES
    return out


STUB_PORT = types.SimpleNamespace(step=1, ema_params={})
STUB_JAX = types.SimpleNamespace(step=1, params={}, ema_params={},
                                 batch_stats={})


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(n_data=1, n_seq=1, devices=jax.devices()[:1])


@pytest.mark.parametrize("batch_size", [1, 2, 3])
@pytest.mark.parametrize("use_image_mask", [True, False])
def test_evaluate_miou_matches_jax(mesh, batch_size, use_image_mask):
    dumps = {"port": [], "jax": []}
    kw = dict(num_classes=N_CLASSES, use_image_mask=use_image_mask,
              batch_size=batch_size)
    fs = dict(voxel_size=(1.0, 1.0, 1.0), pc_range=(0, 0, 0, 6, 5, 3),
              void=(0, 255))
    got = evaluate.evaluate_miou(
        None, STUB_PORT, _samples(5), predict_fn=_port_predict,
        dump_fn=lambda i, o: dumps["port"].append((i, o)),
        fscore_metric=MetricFScore(**fs), device="cpu", **kw)
    want = jax_evaluate.evaluate_miou(
        None, STUB_JAX, _samples(5), mesh, predict_fn=_jax_predict,
        dump_fn=lambda i, o: dumps["jax"].append((i, np.asarray(o))),
        fscore_metric=JaxMetricFScore(**fs), **kw)
    assert got == want
    assert got["count"] == 5 and "fscore" in got
    assert [i for i, _ in dumps["port"]] == list(range(5))
    for (i, a), (j, b) in zip(dumps["port"], dumps["jax"]):
        assert i == j and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("batch_size", [1, 2])
def test_evaluate_miou_temporal_matches_jax(mesh, batch_size):
    kw = dict(num_classes=N_CLASSES, batch_size=batch_size)
    got = evaluate.evaluate_miou_temporal(
        None, STUB_PORT, _samples(5, True), predict_fn=_port_predict,
        device="cpu", **kw)
    want = jax_evaluate.evaluate_miou_temporal(
        None, STUB_JAX, _samples(5, True), mesh, predict_fn=_jax_predict,
        **kw)
    # horizon 2 has no ground truth: NaN on both sides
    assert json.dumps(got) == json.dumps(want) and got["count"] == 5


def _model_samples(cfg, n):
    b = synthetic_batch(cfg, n, num_rays=8, seed=4)
    return [{k: v[i] for k, v in b.items()} for i in range(n)]


def test_evaluate_scores_the_ema_and_leaves_the_model_alone():
    cfg = tiny_config(if_post_finetune=True, if_render=False,
                      use_lss_depth_loss=False)
    model = PreWorld(cfg)
    init_weights(model, seed=1, fan_in=True)
    state = create_train_state(model, make_optimizer(model.parameters()))
    batch = to_device(synthetic_batch(cfg, 1, num_rays=8, seed=1), "cpu")
    make_train_step()(state, batch, torch.Generator().manual_seed(0))
    # an EMA far from the parameters, so that its predictions differ: the
    # weights of another seeded init
    other = PreWorld(cfg)
    init_weights(other, seed=2, fan_in=True)
    with torch.no_grad():
        for n, p in other.named_parameters():
            state.ema_params[n].copy_(p)
    model.train()
    model.occupancy_head.eval()  # a mixed mode must come back as it was
    modes = [m.training for m in model.modules()]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    opt_before = {n: {k: v.clone() for k, v in
                      state.optimizer.state[p].items()}
                  for n, p in model.named_parameters()}
    assert grads

    samples = _model_samples(cfg, 3)
    got = evaluate.evaluate_miou(model, state, samples, batch_size=2)

    # the oracle: a second model that loads the EMA, predicting the same
    # batches (the last one padded), fed to the metric sample by sample
    ema_model = PreWorld(cfg).eval()
    ema_model.load_state_dict({**model.state_dict(), **state.ema_params})
    raw = MetricMIoU()
    oracle = MetricMIoU()
    for idx, n_valid in (([0, 1], 2), ([2, 2], 1)):
        b = to_device({k: np.stack([samples[i][k] for i in idx])
                       for k in evaluate.INFER_KEYS if k in samples[0]},
                      "cpu")
        occ = ema_model.predict(b)["semantic_occ"].numpy()
        occ_raw = model.eval().predict(b)["semantic_occ"].numpy()
        for j, i in enumerate(idx[:n_valid]):
            s = samples[i]
            oracle.add_batch(occ[j], s["voxel_semantics"], None,
                             s["mask_camera"])
            raw.add_batch(occ_raw[j], s["voxel_semantics"], None,
                          s["mask_camera"])
    assert got["count"] == oracle.cnt == 3
    assert got == oracle.count_miou()
    assert raw.hist.tolist() != oracle.hist.tolist()

    for m, training in zip(model.modules(), modes):
        m.training = training  # the oracle's predict above set eval
    model.train()
    model.occupancy_head.eval()
    evaluate.evaluate_miou(model, state, samples, batch_size=2)
    assert [m.training for m in model.modules()] == modes
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for n, p in model.named_parameters():
        if n in grads:
            assert torch.equal(p.grad, grads[n]), n
        for k, v in opt_before[n].items():
            assert torch.equal(state.optimizer.state[p][k], v), (n, k)


WORKER = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {repo!r})
from preworld_tpu_torch.train import evaluate
from types import SimpleNamespace
rank, world, port = {rank}, 2, {port}
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                        rank=rank, world_size=world)
def sample(i):
    rng = np.random.default_rng(100 + i)
    s = {{"imgs": rng.uniform(0.0, 1.0, {shape}).astype(np.float32),
          "voxel_semantics": rng.integers(0, {n}, {shape})}}
    s.update({{f"gt_h{{h}}": rng.integers(0, {n}, {shape})
               for h in range(4)}})
    return s
def predict(params, b):
    x = b["imgs"]
    out = {{"semantic_occ": (x.abs() * 7.0).to(torch.int32) % {n}}}
    for s in (0, 1, 3, 5):
        out[f"semantic_occ_{{s}}s"] = (x.abs() * (3.0 + s)).to(
            torch.int32) % {n}
    return out
state = SimpleNamespace(step=1, ema_params={{}})
samples = lambda: ({{**sample(i), "_valid": v}}
                   for i, v in evaluate.rank_padded_indices(5))
res = evaluate.evaluate_miou(None, state, samples(), num_classes={n},
                             use_image_mask=False, predict_fn=predict,
                             device="cpu")
tmp = evaluate.evaluate_miou_temporal(None, state, samples(),
                                      num_classes={n}, predict_fn=predict,
                                      device="cpu")
dist.destroy_process_group()
print("EVAL_RESULT " + json.dumps({{"miou": res["mIoU"],
                                   "temporal": tmp}}))
"""


def test_two_process_gloo_eval_matches_serial_oracle():
    """Rank 0's mIoU and the temporal result over 5 samples equal a serial
    single-process oracle over the same samples."""
    m = MetricMIoU(num_classes=N_CLASSES, use_image_mask=False)
    serial = []
    for i in range(5):
        rng = np.random.default_rng(100 + i)
        imgs = rng.uniform(0.0, 1.0, SHAPE).astype(np.float32)
        m.add_batch(_occ_np(imgs), rng.integers(0, N_CLASSES, SHAPE),
                    None, None)
        serial.append({"imgs": imgs, **{
            f"gt_h{h}": rng.integers(0, N_CLASSES, SHAPE) for h in range(4)}})
    want_t = evaluate.evaluate_miou_temporal(
        None, STUB_PORT, serial, num_classes=N_CLASSES,
        predict_fn=_port_predict, device="cpu")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER.format(repo=REPO, rank=r, port=port,
                                             shape=SHAPE, n=N_CLASSES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    line = next(ln for ln in outs[0].splitlines() if "EVAL_RESULT " in ln)
    got = json.JSONDecoder().raw_decode(line.split("EVAL_RESULT ", 1)[1])[0]
    assert got["miou"] == m.count_miou()["mIoU"]
    assert got["temporal"] == want_t and want_t["count"] == 5
