"""Training across processes (`preworld_tpu_torch/parallel/`) against the
JAX mesh, on the CPU, in two gloo processes started once for the module
(`tests/torch_dist.py`: torchrun's environment, port code only).

  * the mesh's rank layout against the JAX `make_mesh`, and `shard_batch`
    with the render's ray slice (`seq_rays`) against the JAX
    `batch_shardings` on the 8 virtual devices;
  * the differentiable all_reduce and row gather (values, gradients), and
    `allreduce_grads` (a gradient missing on one rank is zeros there, one
    missing on every rank stays None);
  * the synced BatchNorm against one process's BatchNorm on the
    concatenated batch (outputs, input and parameter gradients, running
    statistics), also under `checkpoint` (the recompute folds nothing);
  * every batch-spanning loss (CE, both scal losses, Lovasz over an odd
    105-voxel grid with class 4 in one rank's scene only, focal, depth BCE,
    the traj L2, BEVStereoOCC's CE, the render losses), split over the two
    ranks' rows, and held by both as seq replicas: the ranks' values add up
    to the whole batch's, their input gradients to its gradient;
  * the render split over 'seq' against the dense `nerf_head_losses` and
    the JAX render under `shard_map` on a (4, 2) mesh, at
    `tests/test_ops.py::test_sharded_render_matches_dense`'s tolerances
    (losses rtol 2e-5, field gradients rtol 2e-4, atol 1e-6), with the
    residual policy per process;
  * the eval with seq replicas: the histogram counts each sample once over
    the data group, twice over the default group (the repaired fault);
  * one finetune step of `tests/test_torch_train_step.py`'s tiny Swin
    config, 2 processes x batch 1 against the JAX step at batch 2, at that
    file's tolerances and with masks off as it has them, and with drop path
    and dropout on against the port's one-process step at batch 2 (the
    same masks drawn for the global batch); the two ranks' parameters bit
    for bit alike.

Losses split over processes sum in another order than in one process: the
values are held at rtol 1e-5 and the gradients at rtol 1e-4 / atol 1e-7
(f32); BatchNorm's E[x^2] - E[x]^2 (flax's) against torch's two-pass
variance at rtol 1e-5 / atol 1e-6.
"""

import functools
import pickle

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import preworld_tpu.models.preworld as jax_preworld
import torch_dist
from preworld_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from preworld_tpu.data.synthetic import tiny_config as jax_tiny_config
from preworld_tpu.models import PreWorld as JaxPreWorld
from preworld_tpu.models.swin import SwinTransformer as JaxSwin
from preworld_tpu.parallel import batch_shardings
from preworld_tpu.parallel import make_mesh as jax_make_mesh
from preworld_tpu.train.train_state import TrainState as JaxTrainState
from preworld_tpu.train.train_state import make_optimizer as jax_make_optimizer
from preworld_tpu.train.train_state import make_train_step as jax_make_train_step
from preworld_tpu_torch import parallel
from preworld_tpu_torch.data import tiny_config, to_device
from preworld_tpu_torch.models import PreWorld
from preworld_tpu_torch.models.layers import BatchNorm2d
from preworld_tpu_torch.models.nerf_head import (
    NerfHeadConfig,
    nerf_head_losses,
)
from preworld_tpu_torch.train import (
    create_train_state,
    make_optimizer,
    make_train_step,
)
from preworld_tpu_torch.utils import (
    flax_to_torch_state,
    load_flax_params,
    torch_state,
)
from test_torch_train_step import (
    BASE_LR,
    FAST_COMPILE,
    FINETUNE,
    INIT_EMA_UPDATES,
    SWIN,
    _NoDropout,
    _random_variables,
    _with_render_mlps,
)

WORLD = 2
VALUE_TOL = dict(rtol=1e-5, atol=1e-9)
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)
STEP_CONFIG = dict(**SWIN, **FINETUNE)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- layout

@pytest.mark.parametrize("n_data,n_seq", [(1, 1), (2, 1), (1, 2), (4, 2),
                                          (2, 4), (8, 1)])
def test_mesh_layout_matches_jax(n_data, n_seq):
    """Rank d * n_seq + s sits at (d, s) of the JAX mesh; the data group of
    s is column s, the seq group of d row d."""
    ids = np.vectorize(lambda d: d.id)(jax_make_mesh(
        n_data, n_seq, jax.devices()[:n_data * n_seq]).devices)
    data, seq = parallel.layout(n_data, n_seq)
    assert data == [ids[:, s].tolist() for s in range(n_seq)]
    assert seq == [ids[d].tolist() for d in range(n_data)]
    for r in range(n_data * n_seq):
        m = parallel.Mesh(n_data, n_seq, r)
        assert ids[m.data_rank, m.seq_rank] == r


@pytest.mark.parametrize("n_rays", [64, 63])
@pytest.mark.parametrize("n_data,n_seq", [(4, 2), (2, 2), (1, 2), (8, 1)])
def test_shard_batch_matches_jax_batch_shardings(n_data, n_seq, n_rays):
    """Each rank's rows (and, for `rays`, the render's ray slice) are the
    shard the JAX `batch_shardings` put on its device: rays split over
    'seq' only when the count divides."""
    rng = np.random.default_rng(0)
    batch = {"imgs": rng.normal(size=(8, 3, 2)).astype(np.float32),
             "rays": rng.normal(size=(8, n_rays, 16)).astype(np.float32),
             "voxel_semantics": rng.integers(0, 18, (8, 4, 4, 2))}
    mesh = jax_make_mesh(n_data, n_seq, jax.devices()[:n_data * n_seq])
    shardings = batch_shardings(mesh, batch)
    for r, device in enumerate(mesh.devices.reshape(-1)):
        pm = parallel.Mesh(n_data, n_seq, r)
        got = parallel.shard_batch(pm, batch)
        got["rays"] = parallel.seq_rays(pm, torch.from_numpy(
            got["rays"]))[0].numpy()
        for k, v in batch.items():
            idx = shardings[k].devices_indices_map(v.shape)[device]
            np.testing.assert_array_equal(got[k], v[idx], err_msg=k)


# ------------------------------------------------------------ two ranks

def _port_step(state_dict, batch_np):
    """The port's one-process step at the global batch, masks on."""
    model = PreWorld(tiny_config(**STEP_CONFIG))
    model.load_state_dict(state_dict)
    opt = make_optimizer(model.parameters(), base_lr=BASE_LR)
    st = create_train_state(model, opt, INIT_EMA_UPDATES)
    st, metrics = make_train_step()(st, to_device(batch_np, "cpu"),
                                    torch.Generator().manual_seed(0))
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                state=torch_state(model),
                g={n: opt.state[p]["mu"].numpy() / 0.1
                   for n, p in model.named_parameters()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results of every case; the JAX finetune step on the
    global batch with masks off (as tests/test_torch_train_step.py), which
    compiles while the ranks run; the port's one-process step with masks
    on."""
    tmp = tmp_path_factory.mktemp("ranks")
    jcfg = jax_tiny_config(**STEP_CONFIG)
    batch_np = jax_synthetic_batch(jcfg, WORLD, 64, seed=3)
    batch_np.pop("rays")
    batch_np["imgs"][:, :, 1] = 2.0 * batch_np["imgs"][:, :, 1] + 1.0
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    mp = pytest.MonkeyPatch()
    launch = None
    try:
        mp.setattr(jax_preworld, "SwinTransformer",
                   functools.partial(JaxSwin, drop_path_rate=0.0))
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        jmodel = JaxPreWorld(jcfg)
        shapes = jax.eval_shape(lambda b: jmodel.init(
            {"params": jax.random.PRNGKey(0)}, b, train=True), jbatch)
        jvars = _random_variables(shapes, np.random.default_rng(5))
        params = jvars["params"]
        model = PreWorld(tiny_config(**STEP_CONFIG))
        load_flax_params(model, _with_render_mlps(params, model),
                         jvars["batch_stats"])
        state_path, batch_path = str(tmp / "state.pt"), str(tmp / "b.pkl")
        torch.save(model.state_dict(), state_path)
        with open(batch_path, "wb") as fh:
            pickle.dump(batch_np, fh)
        step = dict(config=STEP_CONFIG, state_path=state_path,
                    batch_path=batch_path)
        launch = torch_dist.Launch([
            ("collectives", "collectives", {}),
            ("batchnorm", "batchnorm", {}),
            ("losses", "losses", {}),
            ("render", "render", {}),
            ("evaluation", "evaluation", {}),
            ("step", "train_step", step),
            ("step_masks", "train_step", dict(step, masks=True)),
        ], WORLD, tmp)
        tx = jax_make_optimizer(base_lr=BASE_LR)
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jvars["batch_stats"], opt_state=tx.init(params),
            ema_params=params, ema_updates=jnp.asarray(INIT_EMA_UPDATES))
        args = (state, jbatch, jax.random.PRNGKey(0))
        new, jmetrics = jax.jit(jax_make_train_step(jmodel, tx)).lower(
            *args).compile(compiler_options=FAST_COMPILE)(*args)
        jax_result = dict(
            metrics={k: float(v) for k, v in jmetrics.items()},
            state=flax_to_torch_state(new.params, new.batch_stats),
            ema=flax_to_torch_state(new.ema_params),
            g=flax_to_torch_state(jax.tree_util.tree_map(
                lambda m: m / 0.1, new.opt_state[1][0].mu)))
        before = torch_state(model)
        port_masks = _port_step(model.state_dict(), batch_np)
        ranks = launch.results()
    finally:
        mp.undo()
        if launch is not None:
            launch.ranks.close()
    return dict(ranks=ranks, jax=jax_result, port_masks=port_masks,
                before=before)


def test_collectives(runs):
    """all_reduce: the sum on every rank, gradient the summed cotangent;
    gather_rows: rank order, gradient this rank's rows of the summed
    cotangent; allreduce_grads sums, fills a one-rank gradient, keeps a
    no-rank one None."""
    c = [r["collectives"] for r in runs["ranks"]]
    xs = [np.arange(6.0).reshape(2, 3) + 10.0 * r for r in range(WORLD)]
    rows = [np.full((2, 3), r + 1.0) for r in range(WORLD)]
    weights = [np.arange(12.0).reshape(4, 3) * (r + 1.0)
               for r in range(WORLD)]
    for r in range(WORLD):
        np.testing.assert_array_equal(c[r]["y"], sum(xs))
        np.testing.assert_array_equal(c[r]["x_grad"], np.full((2, 3), 3.0))
        np.testing.assert_array_equal(c[r]["gathered"],
                                      np.concatenate(rows))
        np.testing.assert_array_equal(c[r]["rows_grad"],
                                      sum(weights)[2 * r:2 * r + 2])
        g = c[r]["grads"]
        np.testing.assert_array_equal(g[0], np.full(3, 3.0))
        np.testing.assert_array_equal(g[1], np.ones(3))
        assert g[2] is None
        assert c[r]["nbytes"] == 24


def test_sync_batchnorm_matches_the_concatenated_batch(runs):
    rng = np.random.default_rng(7)
    x = rng.normal(1.0, 2.0, (4, 3, 5, 6)).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    bn = BatchNorm2d(3)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.5, 0.5, -1.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    bn.train()
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(gy)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    for kind in ("plain", "remat"):
        got = [r["batchnorm"][kind] for r in runs["ranks"]]
        np.testing.assert_allclose(np.concatenate([g["y"] for g in got]),
                                   y.detach().numpy(), **tol)
        np.testing.assert_allclose(
            np.concatenate([g["x_grad"] for g in got]), xt.grad.numpy(),
            **tol)
        np.testing.assert_allclose(sum(g["w_grad"] for g in got),
                                   bn.weight.grad.numpy(), **tol)
        np.testing.assert_allclose(sum(g["b_grad"] for g in got),
                                   bn.bias.grad.numpy(), **tol)
        for g in got:  # folded once, from the global moments
            np.testing.assert_allclose(g["mean"], bn.running_mean.numpy(),
                                       **tol)
            np.testing.assert_allclose(g["var"], bn.running_var.numpy(),
                                       **tol)


# the render's seq split is test_render_split_over_seq_matches_dense_and_jax
LOSS_CASES = [(name, layout) for layout in ("data", "seq")
              for name in torch_dist.loss_fns()
              if not (name == "render" and layout == "seq")]


@pytest.mark.parametrize("name,layout", LOSS_CASES)
def test_loss_split_over_ranks_adds_up_to_the_whole_batch(runs, name,
                                                          layout):
    """'data': each rank holds its row of the batch; 'seq': both hold the
    whole batch (seq replicas, each at 1 / n_seq)."""
    fn, arrays, diff = torch_dist.loss_fns()[name]
    ts = [torch.from_numpy(a) for a in arrays]
    for i in diff:
        ts[i].requires_grad_()
    want = fn(*ts)
    want.backward()
    got = [r["losses"][layout, name] for r in runs["ranks"]]
    np.testing.assert_allclose(sum(g["value"] for g in got),
                               float(want.detach()), **VALUE_TOL)
    for j, i in enumerate(diff):
        parts = [g["grads"][j] for g in got]
        grad = np.concatenate(parts) if layout == "data" else sum(parts)
        np.testing.assert_allclose(grad, ts[i].grad.numpy(), **GRAD_TOL)


def _jax_render(mesh):
    """The JAX render losses of `render_inputs` and the gradient of their
    total in the density, under `mesh` (None: dense)."""
    from preworld_tpu.models.nerf_head import NerfHeadConfig as JaxNerfConfig
    from preworld_tpu.models.nerf_head import (
        nerf_head_losses as jax_nerf_head_losses,
    )

    de, se, co, rays, bda = (jnp.asarray(a)
                             for a in torch_dist.render_inputs())

    def losses(d):
        return jax_nerf_head_losses(d, se, co, rays, bda, JaxNerfConfig(),
                                    mesh=mesh)

    value = jax.jit(losses)(de)
    grad = jax.jit(jax.grad(lambda d: sum(losses(d).values())))(de)
    return {k: float(v) for k, v in value.items()}, np.asarray(grad)


def test_render_split_over_seq_matches_dense_and_jax(runs):
    """Two ranks of a (1, 2) mesh each render every scene's half of the
    rays: their loss dicts add up to the dense render's and to the JAX
    render's under shard_map on a (4, 2) mesh; the field gradients too.
    Per scene, one distortion sum and one loss-sum all_reduce, forward and
    backward; each process saves its rays' residuals only (the sampled
    field and the keep mask, `tests/test_torch_render.py`)."""
    got = [r["render"] for r in runs["ranks"]]
    fields = [torch.from_numpy(a).requires_grad_()
              for a in torch_dist.render_inputs()[:3]]
    rays, bda = (torch.from_numpy(a) for a in torch_dist.render_inputs()[3:])
    dense = nerf_head_losses(*fields, rays, bda, NerfHeadConfig())
    sum(dense.values()).backward()
    jax_losses, jax_grad = _jax_render(jax_make_mesh(4, 2, jax.devices()))
    tol = dict(rtol=2e-5, atol=1e-6)
    assert set(got[0]["losses"]) == set(dense) == set(jax_losses)
    for k in dense:
        split = sum(g["losses"][k] for g in got)
        np.testing.assert_allclose(split, float(dense[k].detach()), **tol,
                                   err_msg=k)
        np.testing.assert_allclose(split, jax_losses[k], **tol, err_msg=k)
    gtol = dict(rtol=2e-4, atol=1e-6)
    for i, f in enumerate(fields):
        np.testing.assert_allclose(sum(g["grads"][i] for g in got),
                                   f.grad.numpy(), **gtol)
    np.testing.assert_allclose(sum(g["grads"][0] for g in got), jax_grad,
                               **gtol)
    S, B = NerfHeadConfig().spec.num_samples, rays.shape[0]
    for g in got:
        assert g["rays"] == rays.shape[1] // WORLD
        assert g["launched"] == {"render": 4 * B}
        residuals = 21 * g["rays"] * S * 4 + g["rays"] * S
        field = 21 * int(np.prod(fields[0].shape[1:])) * 4
        assert g["saved"] <= residuals + field + g["inputs"] + 256


def test_eval_counts_each_sample_once_over_the_data_group(runs):
    """Seq replicas hold the same samples. Over the mesh's data group the
    histogram and the temporal count are one process's; over the default
    group (the only group before the mesh) each sample counts twice."""
    for r in runs["ranks"]:
        e = r["evaluation"]
        np.testing.assert_array_equal(e["mesh"]["hist"], e["local_hist"])
        np.testing.assert_array_equal(e["default_group"]["hist"],
                                      WORLD * e["local_hist"])
        assert e["mesh"]["temporal"]["count"] == 3
        assert e["default_group"]["temporal"]["count"] == 3 * WORLD
        assert e["mesh"]["miou"]["count"] == 3


def _live(g):
    total = np.sqrt(sum((w ** 2).sum() for w in g.values()))
    return [k for k, w in g.items() if np.linalg.norm(w) > 1e-4 * total]


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _check_step(got, want, before):
    """tests/test_torch_train_step.py's tolerances: losses rtol 1e-4, the
    pre-clip norm rtol 0.01, clipped gradients rel-L2 0.05 globally and
    0.15 per live tensor, BatchNorm statistics rtol 1e-3 / atol 1e-5, the
    update atol 1e-6 where the gradient's sign is settled."""
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        tol = dict(rtol=0.01) if k == "grad_norm" else dict(rtol=1e-4)
        np.testing.assert_allclose(got["metrics"][k], v, err_msg=k, **tol)
    live = _live(want["g"])
    assert _rel(np.concatenate([got["g"][k].ravel() for k in live]),
                np.concatenate([want["g"][k].ravel() for k in live])) < 0.05
    for k in live:
        assert _rel(got["g"][k], want["g"][k]) < 0.15, k
    stats = [k for k in want["state"] if k.endswith(("running_mean",
                                                     "running_var"))]
    assert stats
    for k in stats:
        assert not np.array_equal(got["state"][k], before[k]), k
        np.testing.assert_allclose(got["state"][k], want["state"][k],
                                   rtol=1e-3, atol=1e-5, err_msg=k)
    for k in live:
        g = want["g"][k]
        sure = np.abs(g) > 0.5 * np.abs(g).max()
        np.testing.assert_allclose((got["state"][k] - before[k])[sure],
                                   (want["state"][k] - before[k])[sure],
                                   rtol=0, atol=1e-6, err_msg=k)


def test_finetune_step_matches_the_jax_step_on_the_global_batch(runs):
    """2 processes x batch 1 against the JAX step at batch 2 (masks off):
    losses, gradient norm, clipped gradients, BatchNorm statistics, the
    update and the EMA; both ranks' metrics and parameters alike."""
    ranks = [r["step"] for r in runs["ranks"]]
    want = runs["jax"]
    _check_step(ranks[0], want, runs["before"])
    assert ranks[0]["metrics"]["grad_norm"] > 5.0  # the clip is active
    for k in _live(want["g"]):
        g = want["g"][k]
        sure = np.abs(g) > 0.5 * np.abs(g).max()
        np.testing.assert_allclose(ranks[0]["ema"][k][sure],
                                   want["ema"][k][sure], rtol=0, atol=3e-7,
                                   err_msg=k)
    for k, w in want["ema"].items():
        np.testing.assert_allclose(ranks[0]["ema"][k], w, rtol=0, atol=3e-6,
                                   err_msg=k)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    for k, v in ranks[0]["state"].items():  # BN statistics too
        np.testing.assert_array_equal(v, ranks[1]["state"][k], err_msg=k)
    # the render MLPs, which the finetune loss never reaches, have no
    # gradient on any rank and keep None through the all-reduce
    heads = ("density_mlp.", "semantic_mlp.", "color_mlp.")
    for r in ranks:
        assert r["no_grad"] == sorted(k for k in r["state"]
                                      if k.startswith(heads))
    counts = ranks[0]["counts"]
    assert counts["batchnorm"] > 0 and counts["metrics"] == 1
    assert counts["grads"] >= 2


def test_masked_step_matches_the_one_process_step(runs):
    """Drop path and dropout on: each rank draws the global batch's masks
    and keeps its rows, so 2 processes x batch 1 take the port's
    one-process step at batch 2."""
    ranks = [r["step_masks"] for r in runs["ranks"]]
    _check_step(ranks[0], runs["port_masks"], runs["before"])
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ranks[0]["metrics"]["loss_total"] != \
        runs["ranks"][0]["step"]["metrics"]["loss_total"]
