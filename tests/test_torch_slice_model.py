"""Whole-slice parity of the PyTorch port against the JAX PreWorld (CPU, f32).

The same seeded weights (a flax variables tree filled from numpy) go into
both models, the port's through `utils/flax_bridge`; the same numpy batch
goes through `PreWorld.predict`'s path in both. On CPU tensors the port's
kernel wrappers run their plain versions, and the JAX model takes its XLA
paths. Compared: pooling voxel ids exactly, occupancy logits and density at
rtol = atol = 1e-3, and semantic_occ / geo_occ on every voxel whose top-2
margin (or distance of the density to the threshold) exceeds 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preworld_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from preworld_tpu.data.synthetic import tiny_config as jax_tiny_config
from preworld_tpu.geometry.frustum import create_frustum as jax_create_frustum
from preworld_tpu.geometry.frustum import (
    frustum_pixel_indices as jax_frustum_pixel_indices,
)
from preworld_tpu.geometry.frustum import frustum_to_lidar as jax_frustum_to_lidar
from preworld_tpu.geometry.frustum import voxel_indices as jax_voxel_indices
from preworld_tpu.geometry.transforms import (
    curr2adjsensor_chain as jax_curr2adjsensor_chain,
)
from preworld_tpu.geometry.transforms import (
    sensor2keyego_chain as jax_sensor2keyego_chain,
)
from preworld_tpu.models import PreWorld as JaxPreWorld
from preworld_tpu_torch.data import synthetic_batch, tiny_config, to_device
from preworld_tpu_torch.geometry import (
    create_frustum,
    curr2adjsensor_chain,
    frustum_pixel_indices,
    frustum_to_lidar,
    sensor2keyego_chain,
    voxel_indices,
)
from preworld_tpu_torch.models import PreWorld
from preworld_tpu_torch.utils import load_flax_params

RTOL = ATOL = 1e-3
MARGIN = 1e-3

SWIN = dict(backbone="swin", swin_embed_dims=16, swin_depths=(1, 1, 1, 1),
            swin_num_heads=(1, 2, 4, 8), swin_window=4)
CONFIGS = {"swin": SWIN, "tiny": {}}


def _heads(m, b):
    vf, _ = m.extract_voxel_feat(b, train=False)
    density, semantic, _ = m.predict_attributes(vf)
    return m.occupancy_logits(vf, train=False), density, semantic


def _random_variables(shapes, rng):
    """Seeded numpy values for a flax variables tree (from its shapes):
    kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1), other params and
    BatchNorm means N(0, 0.1), BatchNorm variances U(0.5, 1.5) -- positive,
    so eval-mode BatchNorm is a sharp test of the bridge."""

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(0.0, fan_in ** -0.5, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = rng.normal(1.0, 0.1, shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _run(name):
    over = dict(CONFIGS[name], if_post_finetune=True, if_render=False,
                use_lss_depth_loss=False)
    jcfg = jax_tiny_config(**over)
    batch_np = jax_synthetic_batch(jcfg, 1, 64, seed=3, with_labels=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jmodel = JaxPreWorld(jcfg)
    # shapes through both head branches, so every head's params exist
    shapes = jax.eval_shape(
        lambda b: jmodel.init({"params": jax.random.PRNGKey(0)}, b,
                              method=_heads), jbatch)
    jvars = _random_variables(shapes, np.random.default_rng(5))
    # one jitted program: eager flax compiles op by op, which takes far
    # longer on CPU
    (jlogits, jdensity, jsemantic), jpred = jax.jit(lambda v, b: (
        jmodel.apply(v, b, method=_heads),
        jmodel.apply(v, b, method=lambda m, b_: m.predict(b_))))(
            jvars, jbatch)

    pcfg = tiny_config(**{k: v for k, v in over.items()
                          if k not in ("if_render", "use_lss_depth_loss")})
    model = PreWorld(pcfg).eval()
    load_flax_params(model, jvars["params"], jvars["batch_stats"])
    pbatch = to_device(synthetic_batch(pcfg, 1, seed=3, with_labels=False),
                       "cpu")
    with torch.no_grad():
        vf, _ = model.extract_voxel_feat(pbatch)
        density, semantic, _ = model.predict_attributes(vf)
        logits = model.occupancy_logits(vf)
        pred = model.predict(pbatch)
    return dict(
        jcfg=jcfg, batch_np=batch_np, pcfg=pcfg, model=model,
        jlogits=np.asarray(jlogits), jdensity=np.asarray(jdensity),
        jsemantic=np.asarray(jsemantic),
        jpred={k: np.asarray(v) for k, v in jpred.items()},
        logits=logits.numpy(), density=density.numpy(),
        semantic=semantic.numpy(),
        pred={k: v.numpy() for k, v in pred.items()},
    )


@pytest.fixture(scope="module")
def slice_runs():
    return {name: _run(name) for name in CONFIGS}


def _margin(x):
    top2 = np.sort(x, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_shapes(slice_runs, name):
    r = slice_runs[name]
    sx, sy, sz = (int(v) for v in r["pcfg"].grid.size)
    assert r["logits"].shape == (1, sx, sy, sz, r["pcfg"].num_classes)
    for k in ("semantic_occ", "geo_occ"):
        assert r["pred"][k].shape == (1, sx, sy, sz)
        assert r["pred"][k].dtype == np.int32
        assert r["pred"][k].min() >= 0 and r["pred"][k].max() <= 17


def test_geometry_matches_jax():
    """Frustum template and pixel ids exactly; the pose chains at 1e-6
    (f32; the JAX chain runs on jnp arrays in f32 too)."""
    cfg = jax_tiny_config()
    for down in (4, 16):
        np.testing.assert_array_equal(
            create_frustum(cfg.grid, cfg.input_size, down),
            jax_create_frustum(cfg.grid, cfg.input_size, down))
    np.testing.assert_array_equal(frustum_pixel_indices(2, 3, 4, 5, 6),
                                  jax_frustum_pixel_indices(2, 3, 4, 5, 6))
    rng = np.random.default_rng(0)
    b = jax_synthetic_batch(cfg, 2, 8, seed=1, with_labels=False)
    # perturb the poses beyond the synthetic ring: yaw and lift per frame
    for t in range(cfg.num_frames):
        a = rng.uniform(-0.3, 0.3)
        b["ego2globals"][:, t, :, :2, :2] = [[np.cos(a), -np.sin(a)],
                                             [np.sin(a), np.cos(a)]]
        b["ego2globals"][:, t, :, 2, 3] = rng.uniform(-1, 1)
    js, jg = jnp.asarray(b["sensor2egos"]), jnp.asarray(b["ego2globals"])
    ts, tg = torch.from_numpy(b["sensor2egos"]), torch.from_numpy(
        b["ego2globals"])
    np.testing.assert_allclose(sensor2keyego_chain(ts, tg).numpy(),
                               np.asarray(jax_sensor2keyego_chain(js, jg)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        curr2adjsensor_chain(ts, tg, cfg.temporal_frames).numpy(),
        np.asarray(jax_curr2adjsensor_chain(js, jg, cfg.temporal_frames)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_voxel_ids_exact(slice_runs, name):
    r = slice_runs[name]
    b = r["batch_np"]
    cfg = r["jcfg"]
    fr = jax_create_frustum(cfg.grid, cfg.input_size, 16)
    s2k_j = jax_sensor2keyego_chain(jnp.asarray(b["sensor2egos"]),
                                    jnp.asarray(b["ego2globals"]))
    tb = to_device(b, "cpu")
    s2k_t = sensor2keyego_chain(tb["sensor2egos"], tb["ego2globals"])
    for fid in range(cfg.temporal_frames):
        want = jax_voxel_indices(jax_frustum_to_lidar(
            jnp.asarray(fr), s2k_j[:, fid], jnp.asarray(b["intrins"][:, fid]),
            jnp.asarray(b["post_rots"][:, fid]),
            jnp.asarray(b["post_trans"][:, fid]), jnp.asarray(b["bda"])),
            cfg.grid)
        got = voxel_indices(frustum_to_lidar(
            torch.from_numpy(fr), s2k_t[:, fid], tb["intrins"][:, fid],
            tb["post_rots"][:, fid], tb["post_trans"][:, fid], tb["bda"]),
            r["pcfg"].grid)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (np.asarray(want) < cfg.grid.num_voxels).any()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_occupancy_logits(slice_runs, name):
    r = slice_runs[name]
    np.testing.assert_allclose(r["logits"], r["jlogits"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_density_branch(slice_runs, name):
    r = slice_runs[name]
    np.testing.assert_allclose(r["density"], r["jdensity"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(r["semantic"], r["jsemantic"], rtol=RTOL,
                               atol=ATOL)
    # the density > test_threshold rule, on decided voxels
    cfg = r["pcfg"]
    empty = cfg.num_classes - 1
    occ_t = np.where(r["density"] > cfg.test_threshold,
                     r["semantic"].argmax(-1), empty)
    occ_j = np.where(r["jdensity"] > cfg.test_threshold,
                     r["jsemantic"].argmax(-1), empty)
    sure = ((np.abs(r["jdensity"] - cfg.test_threshold) > MARGIN)
            & (_margin(r["jsemantic"]) > MARGIN))
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(occ_t[sure], occ_j[sure])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_predict_occ(slice_runs, name):
    r = slice_runs[name]
    sure = _margin(r["jlogits"]) > MARGIN
    assert sure.mean() > 0.9
    for k in ("semantic_occ", "geo_occ"):
        np.testing.assert_array_equal(r["pred"][k][sure], r["jpred"][k][sure])
