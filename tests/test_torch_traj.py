"""The forecasting model `PreWorld4DTraj` of the PyTorch port against the
JAX package (CPU, f32), with the weights carried through the bridge from
one seeded flax init.

The config is `tiny_config` (tiny backbone, 20x20x8 grid, out_dim 16) at the
finetune stage, the JAX traj tests' config. The depth net's dropout is off
on both sides (the JAX side through a monkeypatch of flax's `Dropout`, as in
`tests/test_torch_train_step.py`), and camera 1's images are scaled by 2
and offset by 1 so that the cameras' statistics differ (see that file).

Tolerances. `DownScale3D`, the rollout step and the eval-mode loss dict
are f32 computations of the same function in another order: atol 1e-5 on
features, rtol 1e-4 on each loss (the train-step file's forward
tolerance). Predictions are integer classes: equal to the JAX ones wherever
the JAX logits' top-2 margin exceeds 1e-3 (more than 99 % of voxels at every
rollout step), the logits themselves within atol 1e-4. The train step
(num_future 2, base lr 0.1 so the first AdamW step stands above rounding)
is held as the finetune step is: the losses at rtol 1e-4, the new BatchNorm
statistics at rtol 1e-3 / atol 1e-5, the parameter update at atol 1e-6
where |g| exceeds half its tensor's largest, and the EMA at atol 3e-6.
"""

import dataclasses
import json
import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preworld_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from preworld_tpu.data.synthetic import tiny_config as jax_tiny_config
from preworld_tpu.models.occ_head import DownScale3D as JaxDownScale3D
from preworld_tpu.models.preworld_traj import PreWorld4DTraj as JaxTraj
from preworld_tpu.models.preworld_traj import l2_traj_loss as jax_l2
from preworld_tpu.models.preworld_traj import (
    rollout_curriculum as jax_curriculum,
)
from preworld_tpu.parallel import make_mesh
from preworld_tpu.train import evaluate as jax_evaluate
from preworld_tpu.train.train_state import TrainState as JaxTrainState
from preworld_tpu.train.train_state import make_optimizer as jax_make_optimizer
from preworld_tpu.train.train_state import make_train_step as jax_make_train_step
from preworld_tpu_torch.data import synthetic_batch, tiny_config, to_device
from preworld_tpu_torch.models import (
    PreWorld4DTraj,
    l2_traj_loss,
    rollout_curriculum,
)
from preworld_tpu_torch.models.occ_head import DownScale3D
from preworld_tpu_torch.train import (
    create_train_state,
    evaluate_miou_temporal,
    make_optimizer,
    make_train_step,
)
from preworld_tpu_torch.train.evaluate import INFER_KEYS
from preworld_tpu_torch.utils import (
    flax_to_torch_state,
    load_flax_params,
    torch_state,
)

FINETUNE = dict(if_pretrain=False, if_render=False, if_post_finetune=True,
                use_lss_depth_loss=False)
LOSS_RTOL = 1e-4
FEAT_ATOL = 1e-5
LOGIT_ATOL = 1e-4
MARGIN = 1e-3
BASE_LR = 0.1
INIT_EMA_UPDATES = 10560
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
HEADS = ("plan_head.", "fusion_head.", "downscale.", "ego_fusion_head.",
         "traj_head.")


class _NoDropout(flax.linen.Module):
    """flax `Dropout` at rate 0 (the port's dropout is off too)."""

    rate: float
    deterministic: bool = None

    def __call__(self, x):
        return x


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


def _with_render_mlps(params, model):
    """The finetune tree has no render MLPs (flax creates them only when
    called); add the port's own in flax layout (they get zero gradients)."""
    params = dict(params)
    for name, p in model.named_parameters():
        if name.startswith(("density_mlp.", "semantic_mlp.", "color_mlp.")):
            head, layer, leaf = name.split(".")
            v = p.detach().numpy()
            params.setdefault(head, {}).setdefault(layer, {})[
                "kernel" if leaf == "weight" else "bias"] = (
                    v.T if leaf == "weight" else v)
    return params


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """The JAX model and its seeded variables, the port's model loaded from
    them (eval mode, dropout off), and the numpy traj batch."""
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "Dropout", _NoDropout)
    jcfg = jax_tiny_config(**FINETUNE)
    batch_np = jax_synthetic_batch(jcfg, 1, 64, seed=3, with_traj=True)
    batch_np["imgs"][:, :, 1] = 2.0 * batch_np["imgs"][:, :, 1] + 1.0
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jmodel = JaxTraj(jcfg)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, b, train=False, num_future=1),
        jbatch)
    jvars = _random_variables(shapes, np.random.default_rng(5))
    model = PreWorld4DTraj(tiny_config(**FINETUNE)).eval()
    params = _with_render_mlps(_np_tree(jvars["params"]), model)
    load_flax_params(model, params, _np_tree(jvars["batch_stats"]))
    model.view_transformer.depth_net.aspp.dropout_rate = 0.0
    yield types.SimpleNamespace(
        jmodel=jmodel, jvars=jvars, jbatch=jbatch, batch_np=batch_np,
        model=model, params=params, batch=to_device(batch_np, "cpu"))
    mp.undo()


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the tiny shapes gain nothing from more, and
    parallel test workers on one host share its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- pieces

def test_downscale3d_pads_odd_axes_as_flax():
    """At the tiny grid the third convolution meets X = Y = 5 and the
    second Z = 2 -> 1: flax's SAME pads one zero plane after each odd axis
    (3 outputs of 5, not 2). atol 1e-5."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 20, 20, 8, 16)).astype(np.float32)
    jm = JaxDownScale3D(16)
    v = _random_variables(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    m = DownScale3D(16)
    load_flax_params(m, _np_tree(v["params"]))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_ATOL)


def test_rollout_step_matches_jax(setup):
    """One rollout step from the same (B, X, Y, Z, C) feature and ego
    state: the fused feature and the predicted waypoint, atol 1e-5."""
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(1, 20, 20, 8, 16)).astype(np.float32)
    ego = setup.batch_np["ego_states"]
    jf, jt = setup.jmodel.apply(setup.jvars, jnp.asarray(feats),
                                jnp.asarray(ego),
                                method=JaxTraj.rollout_step)
    with torch.no_grad():
        f, t = setup.model.rollout_step(torch.from_numpy(feats),
                                        torch.from_numpy(ego))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0,
                               atol=FEAT_ATOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0,
                               atol=FEAT_ATOL)


@pytest.mark.parametrize("num_future", [1, 2])
def test_loss_dict_matches_jax(setup, num_future):
    """Every loss of the eval-mode rollout (BatchNorm on its running
    statistics, no dropout): `_0s` on the key frame, `_{k}s` per step,
    `loss_traj_{k}s` among them; rtol 1e-4."""
    want = setup.jmodel.apply(setup.jvars, setup.jbatch, train=False,
                              num_future=num_future)
    with torch.no_grad():
        got = setup.model.loss(setup.batch, torch.Generator(),
                               num_future=num_future)
    assert set(got) == set(want)
    assert f"loss_traj_{num_future}s" in got and "loss_voxel_ce_0s" in got
    assert not any(k.endswith(f"_{num_future + 1}s") for k in got)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=LOSS_RTOL,
                                   err_msg=k)


def _jax_rollout_logits(m, batch, num_future):
    feats, _ = m.extract_voxel_feat(batch, train=False)
    out = [m.occupancy_logits(feats, train=False)]
    for _ in range(num_future):
        feats, _ = m.rollout_step(feats, batch["ego_states"])
        out.append(m.occupancy_logits(feats, train=False))
    return out


def test_predict_matches_jax(setup):
    """The 7 keys of `predict` (the current frame and 6 rollout steps):
    the per-step logits within atol 1e-4, and the classes equal to the JAX
    ones wherever the JAX top-2 margin exceeds 1e-3 (over 99 % of voxels
    at every step)."""
    infer = {k: setup.jbatch[k] for k in INFER_KEYS}
    want = setup.jmodel.apply(setup.jvars, infer, train=False)
    jlogits = setup.jmodel.apply(
        setup.jvars, infer, 6,
        method=lambda m, b, n: _jax_rollout_logits(m, b, n))
    pbatch = {k: setup.batch[k] for k in INFER_KEYS}
    got = setup.model.predict(pbatch)
    with torch.no_grad():
        feats, _ = setup.model.extract_voxel_feat(pbatch)
        logits = [setup.model.occupancy_logits(feats)]
        for _ in range(6):
            feats, _ = setup.model.rollout_step(feats, pbatch["ego_states"])
            logits.append(setup.model.occupancy_logits(feats))
    assert set(got) == set(want) == {f"semantic_occ_{k}s" for k in range(7)}
    for k in range(7):
        g, w = got[f"semantic_occ_{k}s"].numpy(), np.asarray(
            want[f"semantic_occ_{k}s"])
        assert g.dtype == w.dtype == np.int32 and g.shape == (1, 20, 20, 8)
        jl = np.asarray(jlogits[k])
        np.testing.assert_allclose(logits[k].numpy(), jl, rtol=0,
                                   atol=LOGIT_ATOL, err_msg=str(k))
        top2 = np.sort(jl, axis=-1)[..., -2:]
        sure = top2[..., 1] - top2[..., 0] > MARGIN
        assert sure.mean() > 0.99, k
        np.testing.assert_array_equal(g[sure], w[sure], err_msg=str(k))
        np.testing.assert_array_equal(g, logits[k].argmax(-1).numpy())


def test_forward_dispatches_as_jax_call(setup):
    """`forward` picks the losses, the rollout prediction or the
    single-frame prediction by the batch's keys, as the JAX `__call__`."""
    gen = torch.Generator()
    with torch.no_grad():
        assert "loss_traj_1s" in setup.model(setup.batch, gen, num_future=1)
        infer = {k: setup.batch[k] for k in INFER_KEYS}
        assert len(setup.model(infer)) == 7
        infer.pop("ego_states")
        assert set(setup.model(infer)) == {"semantic_occ", "geo_occ"}


def test_evaluate_miou_temporal_matches_jax(setup):
    """The 4-D protocol on the same weights and samples (3 samples at
    batch 2, the last batch padded): the port's scores equal the JAX
    package's."""
    cfg = tiny_config(**FINETUNE)
    samples = []
    for i in range(3):
        s = synthetic_batch(cfg, 1, 64, seed=100 + i, with_traj=True)
        out = {k: v[0] for k, v in s.items()}
        for h, f in zip((0, 1, 2, 3), (0, 2, 4, 6)):
            out[f"gt_h{h}"] = (s["temporal_semantics"][0, f - 1] if f > 0
                               else s["voxel_semantics"][0])
        samples.append(out)
    state = create_train_state(setup.model,
                               make_optimizer(setup.model.parameters()))
    got = evaluate_miou_temporal(setup.model, state, iter(samples),
                                 batch_size=2, device="cpu")
    jstate = types.SimpleNamespace(
        step=0, params=setup.jvars["params"],
        ema_params=setup.jvars["params"],
        batch_stats=setup.jvars["batch_stats"])
    mesh = make_mesh(n_data=1, n_seq=1, devices=jax.devices()[:1])
    want = jax_evaluate.evaluate_miou_temporal(
        setup.jmodel, jstate, iter(samples), mesh, batch_size=2)
    assert json.dumps(got) == json.dumps(want) and got["count"] == 3


@pytest.mark.parametrize("epoch", range(16))
@pytest.mark.parametrize("if_render", [True, False])
def test_rollout_curriculum_matches_jax(epoch, if_render):
    assert rollout_curriculum(epoch, if_render) == jax_curriculum(
        epoch, if_render)


def test_l2_traj_loss():
    """Batch mean per coordinate, then the sum: (1 + 9) / 2 + (4 + 16) / 2
    = 15, and the JAX value on random waypoints (rtol 1e-6)."""
    a = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    assert float(l2_traj_loss(a, torch.zeros(2, 2))) == 15.0
    rng = np.random.default_rng(2)
    p, g = (rng.normal(size=(3, 2)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        float(l2_traj_loss(torch.from_numpy(p), torch.from_numpy(g))),
        float(jax_l2(jnp.asarray(p), jnp.asarray(g))), rtol=1e-6)


@pytest.mark.parametrize("batch_size,seed,num_future",
                         [(1, 0, 6), (2, 3, 2)])
def test_synthetic_traj_batch_matches_jax(batch_size, seed, num_future):
    """`with_traj=True`: every key, the four forecasting keys among them,
    byte for byte with the JAX package's arrays."""
    want = jax_synthetic_batch(jax_tiny_config(**FINETUNE), batch_size, 32,
                               seed, with_traj=True, num_future=num_future)
    got = synthetic_batch(tiny_config(**FINETUNE), batch_size, 32, seed,
                          with_traj=True, num_future=num_future)
    assert sorted(got) == sorted(want)
    assert got["temporal_semantics"].shape[1] == num_future
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


# --------------------------------------------------------------- one step

@pytest.fixture(scope="module")
def step(setup):
    """One curriculum train step at num_future 2 on both sides from the
    same variables and batch."""
    tx = jax_make_optimizer(base_lr=BASE_LR)
    params = setup.jvars["params"]
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=setup.jvars["batch_stats"], opt_state=tx.init(params),
        ema_params=params, ema_updates=jnp.asarray(INIT_EMA_UPDATES))
    args = (jstate, setup.jbatch, jax.random.PRNGKey(0))
    fn = jax_make_train_step(setup.jmodel, tx, num_future=2)
    new, jmetrics = jax.jit(fn).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)

    model = PreWorld4DTraj(tiny_config(**FINETUNE))
    model.load_state_dict(setup.model.state_dict())
    model.view_transformer.depth_net.aspp.dropout_rate = 0.0
    before = torch_state(model)
    st = create_train_state(model, make_optimizer(model.parameters(),
                                                  base_lr=BASE_LR),
                            INIT_EMA_UPDATES)
    st, metrics = make_train_step(num_future=2)(
        st, setup.batch, torch.Generator().manual_seed(0))
    return dict(
        jmetrics={k: float(v) for k, v in jmetrics.items()},
        metrics={k: float(v) for k, v in metrics.items()},
        jstate=flax_to_torch_state(new.params, new.batch_stats),
        jema=flax_to_torch_state(new.ema_params),
        jg=flax_to_torch_state(jax.tree_util.tree_map(
            lambda m: m / 0.1, new.opt_state[1][0].mu)),
        state=torch_state(model), ema=torch_state(model, st.ema_params),
        grads={n: p.grad for n, p in model.named_parameters()},
        before=before, batch=setup.batch)


def test_train_step_losses(step):
    assert set(step["metrics"]) == set(step["jmetrics"])
    assert "loss_traj_2s" in step["metrics"]
    for k, v in step["jmetrics"].items():
        assert np.isfinite(step["metrics"][k]), k
        tol = dict(rtol=0.01) if k == "grad_norm" else dict(rtol=LOSS_RTOL)
        np.testing.assert_allclose(step["metrics"][k], v, err_msg=k, **tol)


def test_train_step_batch_stats(step):
    """The OccHead's BatchNorms fold 3 batch statistics (the key frame and
    2 rollout steps), in order, as flax does; every other BN one."""
    keys = [k for k in step["jstate"] if k.endswith(("running_mean",
                                                     "running_var"))]
    assert any(k.startswith("occupancy_head.") for k in keys)
    for k in keys:
        assert not np.array_equal(step["state"][k], step["before"][k]), k
        np.testing.assert_allclose(step["state"][k], step["jstate"][k],
                                   rtol=1e-3, atol=1e-5, err_msg=k)


def test_train_step_params_and_ema(step):
    """The parameter update where the gradient's sign is settled, and the
    EMA everywhere; every traj head gets a nonzero gradient."""
    total = np.sqrt(sum((w ** 2).sum() for w in step["jg"].values()))
    live = [k for k, w in step["jg"].items()
            if np.linalg.norm(w) > 1e-4 * total]
    assert any(k.startswith(HEADS) for k in live)
    for k in live:
        g = step["jg"][k]
        sure = np.abs(g) > 0.5 * np.abs(g).max()
        got = step["state"][k] - step["before"][k]
        want = step["jstate"][k] - step["before"][k]
        np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-6,
                                   err_msg=k)
    for k, w in step["jema"].items():
        np.testing.assert_allclose(step["ema"][k], w, rtol=0, atol=3e-6,
                                   err_msg=k)
    for head in HEADS:
        gs = [g for n, g in step["grads"].items() if n.startswith(head)]
        assert gs and any(float(g.abs().max()) > 0 for g in gs), head


def test_remat_step_matches_plain_step(setup, step):
    """cfg.remat puts each rollout step under `torch.utils.checkpoint`:
    the same losses, parameters and BatchNorm statistics (the OccHead's
    recompute folds no statistics a second time)."""
    model = PreWorld4DTraj(dataclasses.replace(tiny_config(**FINETUNE),
                                               remat=True))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in step["before"].items()}, strict=False)
    model.view_transformer.depth_net.aspp.dropout_rate = 0.0
    st = create_train_state(model, make_optimizer(model.parameters(),
                                                  base_lr=BASE_LR),
                            INIT_EMA_UPDATES)
    st, metrics = make_train_step(num_future=2)(
        st, step["batch"], torch.Generator().manual_seed(0))
    for k, v in step["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-6,
                                   err_msg=k)
    state = torch_state(model)
    for k, v in step["state"].items():
        np.testing.assert_allclose(state[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
