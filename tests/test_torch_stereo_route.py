"""The stereo cost volume's route by feature shape, against the JAX package
(CPU, f32).

`compute_stereo_cost_volume` takes K3 wherever the JAX package's
`plane_sweep_supported` holds, as the JAX package takes its homography
kernel there; any other shape takes the grid route (`gen_stereo_grid` +
the plain grid-sample cost volume), as the JAX package does off its
kernel. At 256 channels it takes K3 and equals the JAX entry on its
Pallas kernel (interpret mode) at 1e-4. At 96 channels (Swin-T's stage 0),
with a 3-D post-aug that the homography route could not take, it equals
the JAX `stereo_cost_volume` on the same grid at 1e-5, and the JAX
`compute_stereo_cost_volume` (grid route) end to end at 1e-4: the two grid
chains differ by f32 composition noise (1.1e-5 in normalised coordinates
here), which random features amplify. A PreWorld on the grid route runs
such a batch instead of refusing it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preworld_tpu.data.synthetic import camera_rig
from preworld_tpu.geometry.frustum import GridConfig, create_frustum
from preworld_tpu.models.depthnet import (
    stereo_cost_volume as jax_stereo_cost_volume,
)
from preworld_tpu.models.view_transformer import (
    compute_stereo_cost_volume as jax_compute_stereo_cost_volume,
)
from preworld_tpu.ops.cost_volume_pallas import (
    plane_sweep_supported as jax_plane_sweep_supported,
)
from preworld_tpu_torch.data import synthetic_batch, tiny_config, to_device
from preworld_tpu_torch.models import PreWorld
from preworld_tpu_torch.models.depthnet import gen_stereo_grid
import preworld_tpu_torch.models.view_transformer as port_vt
from preworld_tpu_torch.models.view_transformer import (
    compute_stereo_cost_volume,
)
from preworld_tpu_torch.ops.cost_volume_pallas import plane_sweep_supported

TOL = 1e-5


@pytest.mark.parametrize("shape", [
    (6, 128, 352, 128), (6, 128, 352, 96), (2, 32, 88, 128), (2, 16, 32, 16),
    (2, 20, 88, 128), (2, 200, 88, 128), (2, 32, 600, 128),
    (6, 128, 352, 256)])
def test_route_follows_jax_support(shape):
    """The route test is a copy of the JAX package's support test."""
    assert plane_sweep_supported(shape) == jax_plane_sweep_supported(shape)


def _rig(rng, input_size, N, planar=False):
    """A camera ring whose adjacent frame is 1.2 m ahead and yawed 4
    degrees, with a rotation + translation post-aug whose z row is tilted
    (a 3-D post-aug), or not (`planar`)."""
    grid_cfg = GridConfig(x=(-40.0, 40.0, 0.4), y=(-40.0, 40.0, 0.4),
                          z=(-1.0, 5.4, 6.4), depth=(1.0, 25.0, 1.0))
    frustum = create_frustum(grid_cfg, input_size, 4)
    rig = camera_rig(N, input_size, rng)
    yaw = np.deg2rad(4.0)
    adj = np.eye(4, dtype=np.float32)
    adj[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    adj[0, 3] = 1.2
    s2e = rig["sensor2ego"]
    k2s = np.stack([np.linalg.inv(s2e[n]) @ np.linalg.inv(adj) @ s2e[n]
                    for n in range(N)]).astype(np.float32)[None]
    th = 0.04
    tilt = (0.0, 0.0) if planar else (0.002, -0.001)
    pr = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                   [*tilt, 1]], np.float32)
    post_rots = np.broadcast_to(pr, (1, N, 3, 3)).copy()
    post_trans = rng.normal(0, 2.0, (1, N, 3)).astype(np.float32)
    return frustum, k2s, rig["intrin"][None], post_rots, post_trans


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_k3_route_at_256_channels_matches_jax(monkeypatch):
    """256 stereo channels: the JAX package takes its homography kernel, so
    the port takes K3 (its wrapper is called once; on CPU tensors it runs
    K3's plain version), and the two entries agree at 1e-4."""
    import preworld_tpu.ops.cost_volume_pallas as cvp

    orig = cvp.plane_sweep_cost_hom
    monkeypatch.setattr(
        cvp, "plane_sweep_cost_hom",
        lambda prev, curr, hom, bias=0.0: orig(prev, curr, hom, bias=bias,
                                               interpret=True))
    calls = []
    k3 = port_vt.plane_sweep_cost_hom
    monkeypatch.setattr(port_vt, "plane_sweep_cost_hom",
                        lambda *a, **k: calls.append(1) or k3(*a, **k))
    rng = np.random.default_rng(3)
    input_size = (64, 176)
    N, C = 2, 256
    H, W = input_size[0] // 4, input_size[1] // 4
    frustum, k2s, intr, prots, ptrans = _rig(rng, input_size, N, planar=True)
    prev = rng.normal(size=(N, H, W, C)).astype(np.float32)
    curr = rng.normal(size=(N, H, W, C)).astype(np.float32)
    assert plane_sweep_supported(prev.shape)

    got = compute_stereo_cost_volume(
        _t(frustum), {"intrin": _t(intr), "post_rot": _t(prots),
                      "post_tran": _t(ptrans)},
        {"prev_feat": _t(prev), "curr_feat": _t(curr), "k2s_sensor": _t(k2s)},
        input_size, 5.0).numpy()
    assert len(calls) == 1
    want = np.asarray(jax_compute_stereo_cost_volume(
        jnp.asarray(frustum),
        {"intrin": jnp.asarray(intr), "post_rot": jnp.asarray(prots),
         "post_tran": jnp.asarray(ptrans)},
        {"prev_feat": jnp.asarray(prev), "curr_feat": jnp.asarray(curr),
         "k2s_sensor": jnp.asarray(k2s)}, input_size, bias=5.0,
        use_fused=True))
    assert got.shape == want.shape == (N, frustum.shape[0], H, W)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_grid_route_at_96_channels_matches_jax():
    rng = np.random.default_rng(7)
    input_size = (64, 176)
    N, C = 2, 96
    H, W = input_size[0] // 4, input_size[1] // 4
    geo = _rig(rng, input_size, N)
    frustum, k2s, intr, prots, ptrans = geo
    prev = rng.normal(size=(N, H, W, C)).astype(np.float32)
    curr = rng.normal(size=(N, H, W, C)).astype(np.float32)
    assert not plane_sweep_supported(prev.shape)
    t = _t

    got = compute_stereo_cost_volume(
        t(frustum), {"intrin": t(intr), "post_rot": t(prots),
                     "post_tran": t(ptrans)},
        {"prev_feat": t(prev), "curr_feat": t(curr), "k2s_sensor": t(k2s)},
        input_size, 5.0).numpy()
    assert got.shape == (N, frustum.shape[0], H, W)
    assert got.dtype == np.float32
    grid = gen_stereo_grid(*[t(a) for a in geo], input_size).numpy()
    same_grid = np.asarray(jax_stereo_cost_volume(
        jnp.asarray(prev), jnp.asarray(curr), jnp.asarray(grid), bias=5.0))
    np.testing.assert_allclose(got, same_grid, rtol=TOL, atol=TOL)

    want = np.asarray(jax_compute_stereo_cost_volume(
        jnp.asarray(frustum),
        {"intrin": jnp.asarray(intr), "post_rot": jnp.asarray(prots),
         "post_tran": jnp.asarray(ptrans)},
        {"prev_feat": jnp.asarray(prev), "curr_feat": jnp.asarray(curr),
         "k2s_sensor": jnp.asarray(k2s)}, input_size, bias=5.0))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (np.abs(got - want) > TOL).mean() < 0.01


def test_grid_route_model_takes_3d_post_augs():
    """The tiny backbone's 16 stereo channels take the grid route: a 3-D
    post-aug runs through `extract_voxel_feat`, and only the K3 route's
    models check for it."""
    cfg = tiny_config(if_post_finetune=True)
    model = PreWorld(cfg).eval()
    assert not model.stereo_on_plane_sweep
    batch = to_device(synthetic_batch(cfg, 1, seed=0), "cpu")
    batch["post_rots"][0, :, :, 2, 0] = 0.01
    with torch.no_grad():
        vf, depth = model.extract_voxel_feat(batch)
    assert torch.isfinite(vf).all() and torch.isfinite(depth).all()
