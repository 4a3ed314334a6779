"""Streaming inference and `align_after_vt` of the PyTorch port against the
JAX package (CPU, f32).

  * `ego_motion_grid` / `shift_voxel_feature` against the JAX functions on
    an identity motion, a 1-cell translation and a yaw + translation under
    a flipping BEV augmentation: the grid and the warp on JAX's grid at
    atol 1e-5, the whole warp within the bound its grid's difference
    allows;
  * `init_sequential_cache`: `pool_vox` exactly, shapes and dtypes;
  * 3 streaming steps (frames 2, 1, 0 of the synthetic batch, whose ego
    moves 0.4 m a frame, i.e. half a cell) against JAX's
    `predict_sequential`: the cached `bev_feat` / `stereo_feat` and the
    occupancy logits at rtol = atol = 1e-3, `semantic_occ` on every voxel
    whose top-2 margin exceeds 1e-3;
  * at constant pose, the third streaming step agrees with the full
    forward on >= 0.99 of voxels (`tools/verify_streaming.py`'s protocol at
    the tiny size);
  * `predict(align_after_vt=True)` against JAX's: logits at 1e-3,
    occupancy on the margin rule;
  * the bench entry and `verify_streaming` with no card print no JSON line
    and exit non-zero.

The same seeded flax variables go into both models, the port's through
`utils/flax_bridge`; the JAX side's streaming logits are read with flax's
`capture_intermediates` from the occupancy head's call inside
`predict_sequential`. On CPU tensors the port's kernel wrappers run their
plain versions and the JAX model its XLA paths.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preworld_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from preworld_tpu.data.synthetic import tiny_config as jax_tiny_config
from preworld_tpu.geometry.frustum import GridConfig as JaxGridConfig
from preworld_tpu.models import PreWorld as JaxPreWorld
from preworld_tpu.models.temporal_align import (
    ego_motion_grid as jax_ego_motion_grid,
)
from preworld_tpu.models.temporal_align import (
    shift_voxel_feature as jax_shift_voxel_feature,
)
from preworld_tpu_torch.data import frame_batch, tiny_config, to_device
from preworld_tpu_torch.geometry import GridConfig
from preworld_tpu_torch.models import PreWorld
from preworld_tpu_torch.models.temporal_align import (
    ego_motion_grid,
    shift_voxel_feature,
)
from preworld_tpu_torch.tools.verify_streaming import (
    constant_pose,
    streaming_agreement,
)
from preworld_tpu_torch.utils import load_flax_params

REPO = Path(__file__).resolve().parent.parent
RTOL = ATOL = 1e-3
MARGIN = 1e-3
HEADS = dict(if_post_finetune=True, if_render=False, use_lss_depth_loss=False)
GRID = dict(x=(-8.0, 8.0, 0.8), y=(-8.0, 8.0, 0.8), z=(-1.0, 5.4, 0.8),
            depth=(1.0, 9.0, 0.5))


def _margin(x):
    top2 = np.sort(x, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


# ------------------------------------------------------ ego-motion warp

def _rig_poses(rng, yaw, shift):
    """(1, 2, 4, 4) camera poses: a random rigid camera 0 and its copy
    turned by `yaw` about z and moved by `shift` (x, y), for the previous
    frame; camera 1 random (unused by the warp)."""

    def rigid(a, t):
        m = np.eye(4, dtype=np.float32)
        m[:2, :2] = [[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]]
        m[:3, 3] = t
        return m

    cam = rigid(rng.uniform(-1, 1), rng.uniform(-1, 1, 3))
    other = rigid(rng.uniform(-1, 1), rng.uniform(-1, 1, 3))
    move = rigid(yaw, (shift[0], shift[1], 0.0))
    curr = np.stack([cam, other])[None]
    prev = np.stack([move @ cam, other])[None]
    return curr, prev


MOTIONS = {
    "identity": (0.0, (0.0, 0.0), (1.0, 1.0, 1.0)),
    "one_cell": (0.0, (0.8, 0.0), (1.0, 1.0, 1.0)),
    "yaw_flip": (0.12, (0.9, -0.5), (-1.0, 1.0, 1.0)),
}


@pytest.mark.parametrize("name", list(MOTIONS))
def test_ego_motion_warp_matches_jax(name, monkeypatch):
    """The grid at atol 1e-5; the warp on JAX's own grid at atol 1e-5; the
    whole warp within the interpolation's Lipschitz bound of the two grids'
    difference. The two f32 pose chains differ by an ulp of a 4x4 product,
    which moves a sample by ~5e-7 of the normalised range: ~5e-6 cells,
    and up to ~2e-5 in a feature whose neighbours differ by ~4."""
    from preworld_tpu_torch.models import temporal_align

    yaw, shift, flip = MOTIONS[name]
    rng = np.random.default_rng(len(name))
    curr, prev = _rig_poses(rng, yaw, shift)
    bda = np.diag(np.asarray(flip, np.float32))[None]
    feat = rng.normal(size=(1, 8, 20, 20, 3)).astype(np.float32)
    jgrid, grid = JaxGridConfig(**GRID), GridConfig(**GRID)
    jargs = [jnp.asarray(a) for a in (curr, prev, bda)]
    targs = [torch.from_numpy(a) for a in (curr, prev, bda)]
    want_g = np.asarray(jax_ego_motion_grid(*jargs, jgrid))
    got_g = ego_motion_grid(*targs, grid).numpy()
    np.testing.assert_allclose(got_g, want_g, atol=1e-5, rtol=0)
    want = np.asarray(jax_shift_voxel_feature(jnp.asarray(feat), *jargs,
                                              jgrid))
    got = shift_voxel_feature(torch.from_numpy(feat), *targs, grid).numpy()
    # the f32 feature's steps between neighbours along x and y, in units of
    # the normalised grid (align_corners: (size - 1) / 2 cells a unit)
    slope = (np.abs(np.diff(feat, axis=3)).max() * (feat.shape[3] - 1)
             + np.abs(np.diff(feat, axis=2)).max() * (feat.shape[2] - 1)) / 2
    bound = float(np.abs(got_g - want_g).max()) * slope + 1e-5
    np.testing.assert_allclose(got, want, atol=bound, rtol=0)
    with monkeypatch.context() as mp:
        mp.setattr(temporal_align, "ego_motion_grid",
                   lambda *a: torch.from_numpy(want_g.copy()))
        on_jax_grid = temporal_align.shift_voxel_feature(
            torch.from_numpy(feat), *targs, grid).numpy()
    np.testing.assert_allclose(on_jax_grid, want, atol=1e-5, rtol=0)
    if name == "identity":
        np.testing.assert_allclose(got, feat, atol=1e-5, rtol=0)
    if name == "one_cell":
        # the previous camera sat one cell ahead in x: cell x reads x - 1
        np.testing.assert_allclose(got[:, :, :, 1:], feat[:, :, :, :-1],
                                   atol=1e-5, rtol=0)


# ------------------------------------------------- the model, both sides

def _random_variables(shapes, rng):
    """Seeded numpy values for a flax variables tree: kernels N(0,
    1/fan_in), norm scales 1 + N(0, 0.1), other params and BatchNorm means
    N(0, 0.1), BatchNorm variances U(0.5, 1.5)."""

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


def _heads(m, b):
    vf, _ = m.extract_voxel_feat(b, train=False)
    density, semantic, _ = m.predict_attributes(vf)
    return m.occupancy_logits(vf, train=False), density, semantic


def _aavt_logits(m, b):
    vf, _ = m.extract_voxel_feat(b, train=False, align_after_vt=True)
    return m.occupancy_logits(vf, train=False)


def _occ_head_only(mdl, method_name):
    return mdl.name == "occupancy_head" and method_name == "__call__"


@pytest.fixture(scope="module")
def runs():
    jcfg = jax_tiny_config(**HEADS)
    batch_np = jax_synthetic_batch(jcfg, 1, 64, seed=3, with_labels=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jmodel = JaxPreWorld(jcfg)
    shapes = jax.eval_shape(
        lambda b: jmodel.init({"params": jax.random.PRNGKey(0)}, b,
                              method=_heads), jbatch)
    jvars = _random_variables(shapes, np.random.default_rng(5))

    # JAX: cache on frame 2, then frames 2, 1, 0; the aavt request
    @jax.jit
    def jstep(v, b, cache):
        (out, new), inter = jmodel.apply(
            v, b, cache, method=JaxPreWorld.predict_sequential,
            capture_intermediates=_occ_head_only)
        logits = inter["intermediates"]["occupancy_head"]["__call__"][0]
        return out, new, logits

    jcache = jmodel.apply(jvars, frame_batch(jbatch, 2),
                          method=JaxPreWorld.init_sequential_cache)
    jinit = {k: np.asarray(v) for k, v in jcache.items()}
    jsteps = []
    for t in (2, 1, 0):
        out, jcache, logits = jstep(jvars, frame_batch(jbatch, t), jcache)
        jsteps.append({"occ": np.asarray(out["semantic_occ"]),
                       "logits": np.asarray(logits),
                       **{k: np.asarray(jcache[k])
                          for k in ("bev_feat", "stereo_feat")}})
    jaavt_logits, jaavt = jax.jit(lambda v, b: (
        jmodel.apply(v, b, method=_aavt_logits),
        jmodel.apply(v, b, method=lambda m, b_: m.predict(
            b_, align_after_vt=True))))(jvars, jbatch)

    pcfg = tiny_config(if_post_finetune=True)
    model = PreWorld(pcfg).eval()
    load_flax_params(model, jvars["params"], jvars["batch_stats"])
    pbatch = to_device(batch_np, "cpu")
    init = cache = model.init_sequential_cache(frame_batch(pbatch, 2))
    steps = []
    for t in (2, 1, 0):
        frame = frame_batch(pbatch, t)
        out, _ = model.predict_sequential(frame, cache)
        vf, cache = model.sequential_voxel_feat(frame, cache)
        with torch.no_grad():
            logits = model.occupancy_logits(vf)
        steps.append({"occ": out["semantic_occ"].numpy(),
                      "logits": logits.numpy(),
                      **{k: cache[k].numpy()
                         for k in ("bev_feat", "stereo_feat")}})
    with torch.no_grad():
        vf, _ = model.extract_voxel_feat(pbatch, align_after_vt=True)
        aavt_logits = model.occupancy_logits(vf).numpy()
    aavt = model.predict(pbatch, align_after_vt=True)
    return dict(
        pcfg=pcfg, model=model, batch_np=batch_np, pbatch=pbatch,
        jinit=jinit, init=init, jsteps=jsteps, steps=steps,
        jaavt_logits=np.asarray(jaavt_logits),
        jaavt={k: np.asarray(v) for k, v in jaavt.items()},
        aavt_logits=aavt_logits,
        aavt={k: v.numpy() for k, v in aavt.items()})


def test_init_sequential_cache_matches_jax(runs):
    jinit, init, cfg = runs["jinit"], runs["init"], runs["pcfg"]
    assert sorted(init) == sorted(jinit)
    np.testing.assert_array_equal(init["pool_vox"].numpy(),
                                  jinit["pool_vox"])
    assert (jinit["pool_vox"] < cfg.grid.num_voxels).any()
    sx, sy, sz = (int(v) for v in cfg.grid.size)
    H, W = cfg.input_size
    assert tuple(init["bev_feat"].shape) == (1, sz, sy, sx,
                                             cfg.num_trans_channels)
    assert tuple(init["stereo_feat"].shape) == (cfg.num_cams, H // 4, W // 4,
                                                16)
    for k in jinit:
        assert tuple(init[k].shape) == jinit[k].shape, k
        assert init[k].numpy().dtype == jinit[k].dtype, k
        if k != "pool_vox":
            np.testing.assert_array_equal(init[k].numpy(), jinit[k])


@pytest.mark.parametrize("step", [0, 1, 2])
def test_streaming_step_matches_jax(runs, step):
    want, got = runs["jsteps"][step], runs["steps"][step]
    for k in ("bev_feat", "stereo_feat", "logits"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    sure = _margin(want["logits"]) > MARGIN
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(got["occ"][sure], want["occ"][sure])
    assert got["occ"].dtype == np.int32
    # predict_sequential's heads are the factored step's
    np.testing.assert_array_equal(got["occ"], got["logits"].argmax(-1))


def test_streaming_matches_full_forward_at_constant_pose(runs):
    batch = to_device(constant_pose(runs["batch_np"]), "cpu")
    assert streaming_agreement(runs["model"], batch) >= 0.99


def test_streaming_on_a_translating_ego_is_align_after_vt(runs):
    """The ego only translates, so the third streaming step's adjacent
    feature is predict(align_after_vt=True)'s: frame 1 pooled in its own ego
    against frame 2's stereo feature, then warped to the key ego."""
    np.testing.assert_allclose(runs["steps"][2]["logits"],
                               runs["aavt_logits"], rtol=1e-5, atol=1e-5)


def test_align_after_vt_matches_jax(runs):
    np.testing.assert_allclose(runs["aavt_logits"], runs["jaavt_logits"],
                               rtol=RTOL, atol=ATOL)
    sure = _margin(runs["jaavt_logits"]) > MARGIN
    assert sure.mean() > 0.9
    for k in ("semantic_occ", "geo_occ"):
        np.testing.assert_array_equal(runs["aavt"][k][sure],
                                      runs["jaavt"][k][sure])


@pytest.mark.parametrize("tool", ["bench", "verify_streaming"])
def test_tools_without_a_card_print_nothing_and_fail(tool):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", f"preworld_tpu_torch.tools.{tool}"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
