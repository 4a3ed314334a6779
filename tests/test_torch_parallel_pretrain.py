"""The pretrain step with the rays split over 'seq': two gloo processes
of a (1, 2) mesh, each rendering 32 of the scene's 64 rays, against the
JAX step on the whole batch (CPU, f32).

The tiny pretrain config, weights, batch and tolerances of
`tests/test_torch_pretrain_step.py` (the depth net's dropout off on both
sides, the density head's bias at 9): losses rtol 1e-4, the pre-clip norm
rtol 0.01, clipped gradients rel-L2 0.05 globally and 0.15 per tensor,
BatchNorm statistics rtol 1e-3 / atol 1e-5, the update atol 1e-6 and the
EMA atol 3e-7 where the gradient's sign is settled. The two ranks hold the
same scene, so BatchNorm syncs nothing (a data group of one rank) and
each rank's voxel-side losses count 1 / 2; the render's sums go over the
seq group: per scene one all_reduce of the distortion sums and one of the
loss sums, each forward and backward. Both ranks' metrics and parameters
are alike bit for bit. In its own file for the budget of one JAX
train-step compile a file.
"""

import pickle

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from preworld_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from preworld_tpu.data.synthetic import tiny_config as jax_tiny_config
from preworld_tpu.models import PreWorld as JaxPreWorld
from preworld_tpu.train.train_state import TrainState as JaxTrainState
from preworld_tpu.train.train_state import make_optimizer as jax_make_optimizer
from preworld_tpu.train.train_state import make_train_step as jax_make_train_step
from preworld_tpu_torch.utils import flax_to_torch_state, torch_state
from test_torch_parallel import _check_step, _live
from test_torch_pretrain_step import (
    BASE_LR,
    FAST_COMPILE,
    INIT_EMA_UPDATES,
    LOSSES,
    PRETRAIN,
    _NoDropout,
    _port_model,
    _random_variables,
)

WORLD = 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' steps, and the JAX step (compiled while they run)."""
    tmp = tmp_path_factory.mktemp("ranks")
    jcfg = jax_tiny_config(**PRETRAIN)
    batch_np = jax_synthetic_batch(jcfg, 1, 64, seed=3)
    batch_np["imgs"][:, :, 1] = 2.0 * batch_np["imgs"][:, :, 1] + 1.0
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    mp = pytest.MonkeyPatch()
    launch = None
    try:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        jmodel = JaxPreWorld(jcfg)
        shapes = jax.eval_shape(lambda b: jmodel.init(
            {"params": jax.random.PRNGKey(0)}, b, train=True), jbatch)
        jvars = _random_variables(shapes, np.random.default_rng(5))
        dense = jvars["params"]["density_mlp"]["Dense_1"]
        dense["bias"] = np.full_like(dense["bias"], 9.0)
        params = jvars["params"]
        model = _port_model(params, jvars["batch_stats"])
        state_path, batch_path = str(tmp / "state.pt"), str(tmp / "b.pkl")
        torch.save(model.state_dict(), state_path)
        with open(batch_path, "wb") as fh:
            pickle.dump(batch_np, fh)
        launch = torch_dist.Launch([("step", "train_step", dict(
            config=PRETRAIN, state_path=state_path, batch_path=batch_path,
            n_seq=WORLD))], WORLD, tmp)
        tx = jax_make_optimizer(base_lr=BASE_LR)
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jvars["batch_stats"], opt_state=tx.init(params),
            ema_params=params, ema_updates=jnp.asarray(INIT_EMA_UPDATES))
        args = (state, jbatch, jax.random.PRNGKey(0))
        new, jmetrics = jax.jit(jax_make_train_step(jmodel, tx)).lower(
            *args).compile(compiler_options=FAST_COMPILE)(*args)
        want = dict(
            metrics={k: float(v) for k, v in jmetrics.items()},
            state=flax_to_torch_state(new.params, new.batch_stats),
            ema=flax_to_torch_state(new.ema_params),
            g=flax_to_torch_state(jax.tree_util.tree_map(
                lambda m: m / 0.1, new.opt_state[1][0].mu)))
        ranks = [r["step"] for r in launch.results()]
    finally:
        mp.undo()
        if launch is not None:
            launch.ranks.close()
    return dict(ranks=ranks, jax=want, before=torch_state(model))


def test_seq_split_pretrain_step_matches_the_jax_step(runs):
    ranks, want = runs["ranks"], runs["jax"]
    assert sorted(k for k in ranks[0]["metrics"] if k.startswith(
        "loss_") and k != "loss_total") == LOSSES
    _check_step(ranks[0], want, runs["before"])
    for k in _live(want["g"]):
        g = want["g"][k]
        sure = np.abs(g) > 0.5 * np.abs(g).max()
        np.testing.assert_allclose(ranks[0]["ema"][k][sure],
                                   want["ema"][k][sure], rtol=0, atol=3e-7,
                                   err_msg=k)


def test_seq_ranks_agree_and_reduce_over_the_seq_group_only(runs):
    ranks = runs["ranks"]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    for k, v in ranks[0]["state"].items():
        np.testing.assert_array_equal(v, ranks[1]["state"][k], err_msg=k)
    for r in ranks:
        assert r["counts"]["render"] == 4
        assert "batchnorm" not in r["counts"]
        assert r["counts"]["metrics"] == 1
