"""Pretrain-stage parity of the PyTorch port against the JAX package (CPU,
f32), and its convergence.

  * `downsampled_gt_depth` exactly and `depth_bce_loss` at 1e-6;
  * the tiny pretrain config (`if_render`, `use_lss_depth_loss`, the tiny
    backbone, 64 rays) from the same seeded flax variables and numpy batch
    on both sides, the depth net's dropout off on both (the JAX side
    through a pytest monkeypatch of flax's `Dropout`): `PreWorld.loss`'s
    six losses against the JAX step's, then one `make_train_step` against
    the JAX `make_train_step`, at the finetune step's tolerances and for
    its reasons (tests/test_torch_train_step.py): losses at rtol 1e-4, the
    pre-clip norm at rtol 0.01, clipped gradients at rel-L2 0.05 globally
    and 0.15 per tensor, BatchNorm statistics at rtol 1e-3 / atol 1e-5,
    the update and the EMA where the gradient's sign is settled at atol
    1e-6 / 3e-7. The density head's output bias is set to 9, so that the
    render works at opacities of order 5e-3 (see `step`). The port's
    occupancy head, which the pretrain loss never reaches (flax creates no
    parameters for it), keeps its own weights and gets no gradient;
  * `build_model` of the pretrain config file carries the JAX `cfg.nerf`;
  * the counterpart of `TestConvergence.test_pretrain_stage_overfits`:
    bf16 with remat, 80 steps on one batch halve the total loss.
"""

import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preworld_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from preworld_tpu.data.synthetic import tiny_config as jax_tiny_config
from preworld_tpu.geometry.frustum import GridConfig as JaxGridConfig
from preworld_tpu.models import PreWorld as JaxPreWorld
from preworld_tpu.models.view_transformer import (
    depth_bce_loss as jax_depth_bce_loss,
)
from preworld_tpu.models.view_transformer import (
    downsampled_gt_depth as jax_downsampled_gt_depth,
)
from preworld_tpu.train.train_state import TrainState as JaxTrainState
from preworld_tpu.train.train_state import make_optimizer as jax_make_optimizer
from preworld_tpu.train.train_state import make_train_step as jax_make_train_step
from preworld_tpu_torch.data import synthetic_batch, tiny_config, to_device
from preworld_tpu_torch.geometry import GridConfig
from preworld_tpu_torch.models import PreWorld
from preworld_tpu_torch.models.view_transformer import (
    depth_bce_loss,
    downsampled_gt_depth,
)
from preworld_tpu_torch.train import (
    create_train_state,
    make_optimizer,
    make_train_step,
)
from preworld_tpu_torch.utils import flax_to_torch_state, torch_state

BASE_LR = 0.1
INIT_EMA_UPDATES = 10560
PRETRAIN = dict(if_pretrain=True, if_render=True, use_lss_depth_loss=True)
LOSSES = ["loss_lss_depth", "loss_render_color", "loss_render_depth",
          "loss_render_semantic", "loss_sdf_distortion", "loss_sdf_entropy"]
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
GRID = dict(x=(-8.0, 8.0, 0.8), y=(-8.0, 8.0, 0.8), z=(-1.0, 5.4, 0.8),
            depth=(1.0, 9.0, 0.5))


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ depth loss

def test_depth_bce_loss_matches_jax():
    rng = np.random.default_rng(2)
    B, N, H, W, ds = 2, 3, 32, 64, 8
    D = GridConfig(**GRID).num_depth_bins
    gt = np.where(rng.uniform(size=(B, N, H, W)) > 0.8,
                  rng.uniform(0.5, 12.0, (B, N, H, W)), 0.0).astype(np.float32)
    logits = rng.normal(size=(B, N, D, H // ds, W // ds)).astype(np.float32)
    pred = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=2))
    jgrid = JaxGridConfig(**GRID)
    want = np.asarray(jax_downsampled_gt_depth(jnp.asarray(gt), ds, jgrid))
    got = downsampled_gt_depth(_t(gt), ds, GridConfig(**GRID))
    np.testing.assert_array_equal(got.numpy(), want)
    # bins both in and out of range occur
    assert 0 < want.max(axis=1).mean() < 1
    np.testing.assert_allclose(
        float(depth_bce_loss(_t(pred), _t(gt), ds, GridConfig(**GRID))),
        float(jax_depth_bce_loss(jnp.asarray(pred), jnp.asarray(gt), ds,
                                 jgrid)), rtol=1e-6)


def test_depth_bce_loss_finite_on_confident_bf16_bin():
    """A bf16 softmax that puts all its mass on the labelled bin: the loss
    stays finite (in bf16 the clamp 1 - 1e-7 is 1, and 0 * log(0) is NaN)."""
    B, N, H, W, ds = 1, 1, 16, 16, 8
    grid = GridConfig(**GRID)
    D = grid.num_depth_bins
    gt = np.zeros((B, N, H, W), np.float32)
    gt[..., :ds, :ds] = 4.0
    labels = downsampled_gt_depth(_t(gt), ds, grid)
    assert labels[0].sum() == 1.0
    pred = torch.zeros(B * N * (H // ds) * (W // ds), D)
    pred[:, 0] = 1.0
    pred[0] = labels[0]
    pred = pred.reshape(B, N, H // ds, W // ds, D).permute(0, 1, 4, 2, 3)
    loss = depth_bce_loss(pred.bfloat16(), _t(gt), ds, grid)
    assert torch.isfinite(loss)
    assert loss.dtype == torch.float32


# --------------------------------------------------------------- one step

def _random_variables(shapes, rng):
    """Seeded values for a flax variables tree: kernels N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1), other params and BN means N(0, 0.1), BN
    variances U(0.5, 1.5)."""

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            v = rng.normal(0.0, int(np.prod(shape[:-1])) ** -0.5, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = rng.normal(1.0, 0.1, shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


class _NoDropout(flax.linen.Module):
    """flax `Dropout` at rate 0 (the port's dropout is off too)."""

    rate: float
    deterministic: bool = None

    def __call__(self, x):
        return x


def _port_model(params, stats):
    """The tiny pretrain model with the flax weights; its occupancy head
    (no flax leaves) keeps the module's own initial weights."""
    model = PreWorld(tiny_config(**PRETRAIN))
    model.view_transformer.depth_net.aspp.dropout_rate = 0.0
    flat = flax_to_torch_state(params, stats)
    missing, unexpected = model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in flat.items()}, strict=False)
    assert unexpected == []
    assert all(k.startswith("occupancy_head.")
               or k.endswith("num_batches_tracked") for k in missing), missing
    return model


@pytest.fixture(scope="module")
def step():
    jcfg = jax_tiny_config(**PRETRAIN)
    batch_np = jax_synthetic_batch(jcfg, 1, 64, seed=3)
    batch_np["imgs"][:, :, 1] = 2.0 * batch_np["imgs"][:, :, 1] + 1.0
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        jmodel = JaxPreWorld(jcfg)
        shapes = jax.eval_shape(lambda b: jmodel.init(
            {"params": jax.random.PRNGKey(0)}, b, train=True), jbatch)
        jvars = _random_variables(shapes, np.random.default_rng(5))
        # density ~ 9 + O(1): alpha of order 5e-3 instead of the initial
        # 1e-6, where 1 - exp(-softplus(d + shift) / 2) loses ~10 % to f32
        # cancellation and one ulp of density moves the render losses by
        # 2e-4 relative; far from alpha ~ 1 too, where a ray's transmittance
        # after the early exit compounds the features' rounding
        dense = jvars["params"]["density_mlp"]["Dense_1"]
        dense["bias"] = np.full_like(dense["bias"], 9.0)
        tx = jax_make_optimizer(base_lr=BASE_LR)
        params = jvars["params"]
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jvars["batch_stats"], opt_state=tx.init(params),
            ema_params=params, ema_updates=jnp.asarray(INIT_EMA_UPDATES))
        args = (state, jbatch, jax.random.PRNGKey(0))
        new, jmetrics = jax.jit(jax_make_train_step(jmodel, tx)).lower(
            *args).compile(compiler_options=FAST_COMPILE)(*args)
    jmu = new.opt_state[1][0].mu

    batch = to_device(batch_np, "cpu")
    # the loss dict alone, train mode, from the same weights
    loss_model = _port_model(params, jvars["batch_stats"]).train()
    losses = loss_model.loss(batch, torch.Generator().manual_seed(0))

    model = _port_model(params, jvars["batch_stats"])
    before = torch_state(model)
    opt = make_optimizer(model.parameters(), base_lr=BASE_LR)
    st = create_train_state(model, opt, INIT_EMA_UPDATES)
    st, metrics = make_train_step()(st, batch, torch.Generator().manual_seed(0))
    return dict(
        losses={k: float(v.detach()) for k, v in losses.items()},
        jmetrics={k: float(v) for k, v in jmetrics.items()},
        metrics={k: float(v) for k, v in metrics.items()},
        jstate=flax_to_torch_state(new.params, new.batch_stats),
        jema=flax_to_torch_state(new.ema_params),
        jg=flax_to_torch_state(jax.tree_util.tree_map(lambda m: m / 0.1,
                                                      jmu)),
        state=torch_state(model),
        ema=torch_state(model, st.ema_params),
        g={n: opt.state[p]["mu"].numpy() / 0.1
           for n, p in model.named_parameters()},
        grads={n: p.grad for n, p in model.named_parameters()},
        before=before)


def _live(r):
    """Gradient tensors whose exact value is not 0."""
    total = np.sqrt(sum((w ** 2).sum() for w in r["jg"].values()))
    return [k for k, w in r["jg"].items() if np.linalg.norm(w) > 1e-4 * total]


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_loss_dict_matches_jax(step):
    assert sorted(step["losses"]) == LOSSES
    for k in LOSSES:
        assert np.isfinite(step["losses"][k]), k
        np.testing.assert_allclose(step["losses"][k], step["jmetrics"][k],
                                   rtol=1e-4, err_msg=k)


def test_step_losses_and_grad_norm(step):
    assert set(step["metrics"]) == set(step["jmetrics"])
    for k, v in step["jmetrics"].items():
        tol = dict(rtol=0.01) if k == "grad_norm" else dict(rtol=1e-4)
        np.testing.assert_allclose(step["metrics"][k], v, err_msg=k, **tol)


def test_step_clipped_grads(step):
    r = step
    live = _live(r)
    # the render MLPs and the depth net are reached
    for prefix in ("density_mlp.", "semantic_mlp.", "color_mlp.",
                   "view_transformer.depth_net.depth_pred."):
        assert any(k.startswith(prefix) for k in live), prefix
    got = np.concatenate([r["g"][k].ravel() for k in live])
    want = np.concatenate([r["jg"][k].ravel() for k in live])
    assert _rel(got, want) < 0.05
    for k in live:
        assert _rel(r["g"][k], r["jg"][k]) < 0.15, k
    # the occupancy head gets no gradient in the pretrain stage
    assert all(g is None for n, g in r["grads"].items()
               if n.startswith("occupancy_head."))


def test_step_batch_stats_update_and_ema(step):
    r = step
    keys = [k for k in r["jstate"] if k.endswith(("running_mean",
                                                  "running_var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(r["state"][k], r["jstate"][k], rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    for k in _live(r):
        g = r["jg"][k]
        sure = np.abs(g) > 0.5 * np.abs(g).max()
        got = r["state"][k] - r["before"][k]
        want = r["jstate"][k] - r["before"][k]
        np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(r["ema"][k][sure], r["jema"][k][sure],
                                   rtol=0, atol=3e-7, err_msg=k)


# ----------------------------------------------------------------- config

def test_pretrain_config_builds_the_render_head():
    from preworld_tpu.train.builder import build_model as jax_build_model
    from preworld_tpu.utils.config import Config as JaxConfig
    from preworld_tpu_torch.train import build_model
    from preworld_tpu_torch.utils import Config

    path = "configs/preworld/preworld_7frame_pretrain.py"
    cfg = build_model(Config.fromfile(path), device="meta").cfg
    want = jax_build_model(JaxConfig.fromfile(path)).cfg
    assert cfg.if_render and cfg.use_lss_depth_loss and not cfg.if_post_finetune
    got = dataclasses.asdict(cfg.nerf)
    jnerf = dataclasses.asdict(want.nerf)
    assert {k: jnerf[k] for k in got} == got
    assert set(jnerf) - set(got) == {"table_dtype", "bwd_live_cap"}
    assert cfg.nerf.spec.num_samples == 417


# ------------------------------------------------------------ convergence

def test_pretrain_stage_overfits():
    """80 steps on one batch of 128 rays (bf16, remat, lr 5e-3 with one
    warmup step): every total finite, the last below half the first."""
    torch.manual_seed(0)
    cfg = tiny_config(**PRETRAIN, dtype=torch.bfloat16, remat=True)
    model = PreWorld(cfg)
    batch = to_device(synthetic_batch(cfg, 1, seed=0, with_labels=True,
                                      num_rays=128), "cpu")
    state = create_train_state(model, make_optimizer(
        model.parameters(), base_lr=5e-3, warmup_iters=1))
    step = make_train_step()
    gen = torch.Generator().manual_seed(0)
    losses = []
    for i in range(80):
        _, metrics = step(state, batch, gen)
        loss = float(metrics["loss_total"])
        assert np.isfinite(loss), (i, loss)
        losses.append(loss)
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
