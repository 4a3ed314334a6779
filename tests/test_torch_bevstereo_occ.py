"""The BEVStereoOCC baseline of the PyTorch port against the JAX package
(CPU, f32).

A tiny Swin config (embed 16, one block per stage, window 4) on both
sides from the same seeded flax variables and numpy batch, the port's
weights through `utils/flax_bridge` loaded strictly (the `predicter` MLP
included, and no PreWorld head: the JAX module never builds them):

  * the loss dict in train mode (`loss_occ`, the mean CE of the log-softmax;
    `loss_depth`, the LSS depth BCE at weight 0.05) at rtol 1e-4 / atol 1e-5,
    as `tests/test_torch_train_step.py` holds PreWorld's losses, with drop
    path and the depth net's dropout at 0 on both sides;
  * `predict`: the logits at rtol = atol = 1e-3 and `semantic_occ` on every
    voxel whose top-2 margin exceeds 1e-3;
  * `build_model(device="cpu")` of a `BEVStereo4DOCC` config gives the JAX
    builder's model type and config field for field.
"""

import dataclasses
import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import preworld_tpu.models.preworld as jax_preworld
from preworld_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from preworld_tpu.data.synthetic import tiny_config as jax_tiny_config
from preworld_tpu.models import BEVStereoOCC as JaxBEVStereoOCC
from preworld_tpu.models.swin import SwinTransformer as JaxSwin
from preworld_tpu_torch.data import tiny_config, to_device
from preworld_tpu_torch.models import BEVStereoOCC
from preworld_tpu_torch.utils import load_flax_params

TOL = dict(rtol=1e-4, atol=1e-5)
RTOL = ATOL = 1e-3
MARGIN = 1e-3
CFG = dict(backbone="swin", swin_embed_dims=16, swin_depths=(1, 1, 1, 1),
           swin_num_heads=(1, 2, 4, 8), swin_window=4, if_post_finetune=False,
           if_render=False, use_lss_depth_loss=True)
INFER = ("imgs", "sensor2egos", "ego2globals", "intrins", "post_rots",
         "post_trans", "bda")
BEVSTEREO_TINY_CFG = """
grid_config = dict(
    x=[-8.0, 8.0, 0.8], y=[-8.0, 8.0, 0.8], z=[-1.0, 5.4, 0.8],
    depth=[1.0, 9.0, 0.5],
)
data_config = dict(input_size=(64, 128), Ncams=2)
model = dict(
    type="BEVStereo4DOCC",
    backbone="swin",
    swin=dict(embed_dims=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
              window_size=4),
    neck_out_channels=24,
    num_trans_channels=8,
    out_dim=8,
    use_lss_depth_loss=True,
)
"""


def _random_variables(shapes, rng):
    """Seeded numpy values for a flax variables tree: kernels N(0,
    1/fan_in), norm scales 1 + N(0, 0.1), other params and BN means N(0,
    0.1), BN variances U(0.5, 1.5)."""

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


@pytest.fixture(scope="module")
def run():
    jcfg = jax_tiny_config(**CFG)
    batch_np = jax_synthetic_batch(jcfg, 1, 64, seed=3)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jinfer = {k: jbatch[k] for k in INFER}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_preworld, "SwinTransformer",
                   functools.partial(JaxSwin, drop_path_rate=0.0))
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        jmodel = JaxBEVStereoOCC(jcfg)
        shapes = jax.eval_shape(lambda b: jmodel.init(
            {"params": jax.random.PRNGKey(0)}, b, train=True), jbatch)
        jvars = _random_variables(shapes, np.random.default_rng(5))
        jlosses, jlogits, jpred = jax.jit(lambda v, b, bi: (
            jmodel.apply(v, b, train=True, mutable=["batch_stats"])[0],
            jmodel.apply(v, bi, method=lambda m, x: m.occ_logits(x)[0]),
            jmodel.apply(v, bi)))(jvars, jbatch, jinfer)
    finally:
        mp.undo()

    model = BEVStereoOCC(tiny_config(**{
        k: v for k, v in CFG.items()
        if k not in ("if_render", "use_lss_depth_loss")}))
    loaded = load_flax_params(model, jvars["params"], jvars["batch_stats"])
    model.img_backbone.drop_path_rate = 0.0
    model.view_transformer.depth_net.aspp.dropout_rate = 0.0
    batch = to_device(batch_np, "cpu")
    model.eval()
    with torch.no_grad():
        logits = model.occ_logits(batch)[0].numpy()
    pred = model.predict(batch)["semantic_occ"].numpy()
    model.train()
    losses = model.loss(batch, torch.Generator().manual_seed(0))
    return dict(jvars=jvars, loaded=loaded, jlosses=jlosses,
                jlogits=np.asarray(jlogits),
                jpred=np.asarray(jpred["semantic_occ"]),
                losses={k: float(v.detach()) for k, v in losses.items()},
                logits=logits, pred=pred, model=model)


def test_bridge_loads_the_predicter_strictly(run):
    params = run["jvars"]["params"]
    assert "predicter" in params
    assert not {"occupancy_head", "density_mlp", "semantic_mlp",
                "color_mlp"} & set(params)
    assert {n for n in run["loaded"] if n.startswith("predicter.")} == {
        "predicter.Dense_0.weight", "predicter.Dense_0.bias",
        "predicter.Dense_1.weight", "predicter.Dense_1.bias"}
    sd = run["model"].state_dict()
    for layer in ("Dense_0", "Dense_1"):
        np.testing.assert_array_equal(
            sd[f"predicter.{layer}.weight"].numpy(),
            params["predicter"][layer]["kernel"].T)
        np.testing.assert_array_equal(sd[f"predicter.{layer}.bias"].numpy(),
                                      params["predicter"][layer]["bias"])
    partial = dict(params)
    partial.pop("predicter")
    with pytest.raises(KeyError, match="no flax leaf"):
        load_flax_params(BEVStereoOCC(run["model"].cfg), partial,
                         run["jvars"]["batch_stats"])


def test_loss_dict_matches_jax(run):
    assert set(run["losses"]) == {"loss_occ", "loss_depth"}
    assert set(run["losses"]) == set(run["jlosses"])
    for k, v in run["jlosses"].items():
        np.testing.assert_allclose(run["losses"][k], float(v), **TOL,
                                   err_msg=k)


def test_predict_matches_jax(run):
    np.testing.assert_allclose(run["logits"], run["jlogits"], rtol=RTOL,
                               atol=ATOL)
    top2 = np.sort(run["jlogits"], axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > MARGIN
    assert sure.mean() > 0.9
    assert run["pred"].dtype == np.int32
    np.testing.assert_array_equal(run["pred"][sure], run["jpred"][sure])


def test_build_model_matches_jax(tmp_path):
    from preworld_tpu.train.builder import build_model as jax_build_model
    from preworld_tpu.utils.config import Config as JaxConfig
    from preworld_tpu_torch.train import build_model
    from preworld_tpu_torch.utils import Config

    path = tmp_path / "bevstereo_tiny.py"
    path.write_text(BEVSTEREO_TINY_CFG)
    model = build_model(Config.fromfile(str(path)), device="cpu")
    want = jax_build_model(JaxConfig.fromfile(str(path)))
    assert type(model) is BEVStereoOCC and type(want) is JaxBEVStereoOCC
    assert next(model.parameters()).device.type == "cpu"
    got = model.cfg
    assert dataclasses.asdict(got.grid) == dataclasses.asdict(want.cfg.grid)
    for f in dataclasses.fields(got):
        if f.name not in ("grid", "dtype", "nerf"):
            assert getattr(got, f.name) == getattr(want.cfg, f.name), f.name
    traj = tmp_path / "traj_tiny.py"
    traj.write_text(BEVSTEREO_TINY_CFG.replace("BEVStereo4DOCC",
                                               "PreWorld4DTraj"))
    from preworld_tpu.models import PreWorld4DTraj as JaxPreWorld4DTraj
    from preworld_tpu_torch.models import PreWorld4DTraj

    model = build_model(Config.fromfile(str(traj)), device="cpu")
    want = jax_build_model(JaxConfig.fromfile(str(traj)))
    assert type(model) is PreWorld4DTraj and type(want) is JaxPreWorld4DTraj
