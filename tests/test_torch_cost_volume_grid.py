"""K7, the grid plane-sweep cost volume, against the JAX package (CPU, f32).

The port's plain K7 (`plane_sweep_cost` on CPU tensors, i.e.
`plane_sweep_cost_plain`) against:
  * the Pallas `plane_sweep_cost` in interpret mode on the JAX smooth-warp
    rig (tests/test_ops.py `TestPlaneSweepKernel.
    test_matches_xla_on_smooth_warp`: BN 2, H 16, W 128, C 128, D 4, with
    out-of-image samples), pre-softmax cost and softmax at atol 1e-4;
  * the XLA `stereo_cost_volume` on the realistic-geometry rig
    (`test_matches_xla_on_realistic_geometry`: 3 cameras, 1.2 m and 4 degrees
    of ego motion, 128x352 input, C 128, D 22) at atol 1e-4 on every
    element: the port samples exactly, where the TPU kernel's window drops a
    tail of far samples;
and `stereo_cost_volume_fused` against the softmax of the JAX kernel. A
CUDA-side tensor never falls back to the plain version: an unsupported
width or a tensor off the card raises.
"""

import flax.linen as jnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preworld_tpu.data.synthetic import camera_rig
from preworld_tpu.geometry.frustum import GridConfig, create_frustum
from preworld_tpu.models.depthnet import gen_stereo_grid as jax_gen_stereo_grid
from preworld_tpu.models.depthnet import (
    stereo_cost_volume as jax_stereo_cost_volume,
)
from preworld_tpu.ops.cost_volume_pallas import (
    plane_sweep_cost as jax_plane_sweep_cost,
)
from preworld_tpu_torch.models.depthnet import (
    stereo_cost_volume,
    stereo_cost_volume_fused,
)
from preworld_tpu_torch.ops.cost_volume_pallas import (
    plane_sweep_cost,
    plane_sweep_cost_plain,
)

TOL = 1e-4
BIAS = 5.0


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def smooth():
    """The JAX smooth-warp rig and the Pallas kernel's cost on it."""
    rng = np.random.default_rng(0)
    BN, H, W, C, D = 2, 16, 128, 128, 4
    prev = rng.normal(size=(BN, H, W, C)).astype(np.float32)
    curr = rng.normal(size=(BN, H, W, C)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    gx = np.zeros((BN, D, H, W), np.float32)
    gy = np.zeros((BN, D, H, W), np.float32)
    for d in range(D):
        shift = 3.0 * (d + 1) / D
        gx[:, d] = (xs + shift + rng.normal(0, 0.3, (H, W))) / (W - 1) * 2 - 1
        gy[:, d] = (ys + 0.5 * shift + rng.normal(0, 0.3, (H, W))) / (H - 1) * 2 - 1
    gx[:, :, :2, :4] = -1.5  # out-of-image samples
    grid = np.stack([gx, gy], -1).reshape(BN, D * H, W, 2)
    cost = np.asarray(jax_plane_sweep_cost(
        jnp.asarray(prev), jnp.asarray(curr), jnp.asarray(grid), bias=BIAS,
        interpret=True))
    return prev, curr, grid, cost


def test_plain_matches_pallas_on_smooth_warp(smooth):
    prev, curr, grid, want = smooth
    got = plane_sweep_cost(_t(prev), _t(curr), _t(grid), BIAS)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the out-of-image corner took the "sampled nothing" bias
    assert (got[:, :, :2, :4] > BIAS).all()
    np.testing.assert_allclose(
        torch.softmax(-got, dim=1).numpy(),
        np.asarray(jnn.softmax(-jnp.asarray(want), axis=1)), rtol=0, atol=TOL)


def test_fused_cost_volume_matches_kernel_softmax(smooth):
    prev, curr, grid, want = smooth
    got = stereo_cost_volume_fused(_t(prev), _t(curr), _t(grid), BIAS)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jnn.softmax(-jnp.asarray(want), axis=1)),
        rtol=0, atol=TOL)
    # bf16 features give bf16 probabilities; the grid stays f32
    half = stereo_cost_volume_fused(_t(prev).bfloat16(), _t(curr).bfloat16(),
                                    _t(grid), BIAS)
    assert half.dtype == torch.bfloat16 and half.shape == got.shape


def test_plain_matches_xla_on_realistic_geometry():
    rng = np.random.default_rng(7)
    input_size = (128, 352)
    N, C, cv_down = 3, 128, 4
    H, W = input_size[0] // cv_down, input_size[1] // cv_down
    grid_cfg = GridConfig(x=(-40.0, 40.0, 0.4), y=(-40.0, 40.0, 0.4),
                          z=(-1.0, 5.4, 6.4), depth=(1.0, 23.0, 1.0))
    frustum = jnp.asarray(create_frustum(grid_cfg, input_size, cv_down))
    rig = camera_rig(N, input_size, rng)
    yaw = np.deg2rad(4.0)
    adj = np.eye(4, dtype=np.float32)
    adj[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    adj[0, 3] = 1.2
    s2e = rig["sensor2ego"]
    k2s = np.stack([np.linalg.inv(s2e[n]) @ np.linalg.inv(adj) @ s2e[n]
                    for n in range(N)]).astype(np.float32)
    grid = np.asarray(jax_gen_stereo_grid(
        frustum, jnp.asarray(k2s)[None], jnp.asarray(rig["intrin"])[None],
        jnp.asarray(np.broadcast_to(np.eye(3, dtype=np.float32),
                                    (1, N, 3, 3))),
        jnp.zeros((1, N, 3)), input_size))
    prev = rng.normal(size=(N, H, W, C)).astype(np.float32)
    curr = rng.normal(size=(N, H, W, C)).astype(np.float32)
    want = np.asarray(jax_stereo_cost_volume(
        jnp.asarray(prev), jnp.asarray(curr), jnp.asarray(grid), bias=BIAS,
        depth_chunk=1))
    got = stereo_cost_volume_fused(_t(prev), _t(curr), _t(grid), BIAS)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the port's own grid route (F.grid_sample) gives the same
    np.testing.assert_allclose(
        got.numpy(), stereo_cost_volume(_t(prev), _t(curr), _t(grid),
                                        BIAS).numpy(), rtol=0, atol=TOL)
    # the rig samples outside the image somewhere
    cost = plane_sweep_cost_plain(_t(prev), _t(curr), _t(grid), BIAS)
    assert (cost > BIAS + 1.0).any()


@pytest.mark.parametrize("C,match", [(96, "K7 takes C = 128 k"),
                                     (1664, "K7 takes C = 128 k"),
                                     (128, "expected a CUDA tensor")])
def test_kernel_path_raises_instead_of_falling_back(C, match):
    """A tensor off the CPU goes to the kernel or raises: an unbuilt width,
    or a device that is not the card (meta tensors here)."""
    prev = torch.empty((1, 8, 16, C), dtype=torch.bfloat16, device="meta")
    grid = torch.empty((1, 4 * 8, 16, 2), device="meta")
    with pytest.raises(ValueError, match=match):
        plane_sweep_cost(prev, prev, grid, BIAS)
