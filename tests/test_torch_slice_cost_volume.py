"""Stereo cost-volume parity of the PyTorch port against the JAX package
(CPU, f32).

`gen_stereo_homography`, `gen_stereo_grid` and the plain grid-path
`stereo_cost_volume` against the JAX functions; the plain K3
(`plane_sweep_cost_hom` on CPU tensors) against the Pallas
`plane_sweep_cost_hom` in interpret mode and against the exact XLA oracle
`stereo_cost_volume` fed the same homography-derived coordinates; and
`compute_stereo_cost_volume` end to end against the JAX XLA path. The rig is
`TestPlaneSweepHom._geometry`'s (tests/test_ops.py): 128x352 input, cv
stride 4 (H % 8 == 0), C = 128, D = 24. Tolerance 1e-4 (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preworld_tpu.data.synthetic import camera_rig
from preworld_tpu.geometry.frustum import GridConfig, create_frustum
from preworld_tpu.models.depthnet import gen_stereo_grid as jax_gen_stereo_grid
from preworld_tpu.models.depthnet import (
    gen_stereo_homography as jax_gen_stereo_homography,
)
from preworld_tpu.models.depthnet import (
    stereo_cost_volume as jax_stereo_cost_volume,
)
from preworld_tpu.models.view_transformer import (
    compute_stereo_cost_volume as jax_compute_stereo_cost_volume,
)
from preworld_tpu.ops.cost_volume_pallas import (
    plane_sweep_cost_hom as jax_plane_sweep_cost_hom,
)
from preworld_tpu_torch.data import synthetic_batch, tiny_config, to_device
from preworld_tpu_torch.models import PreWorld
from preworld_tpu_torch.models.depthnet import (
    gen_stereo_grid,
    gen_stereo_homography,
)
from preworld_tpu_torch.models.depthnet import (
    stereo_cost_volume as port_stereo_cost_volume,
)
from preworld_tpu_torch.models.view_transformer import (
    compute_stereo_cost_volume,
)
from preworld_tpu_torch.ops.cost_volume_pallas import (
    plane_sweep_cost_hom,
    plane_sweep_cost_hom_plain,
)

TOL = 1e-4
BIAS = 5.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _geometry(rng, input_size, N, cv_down, with_postaug=False,
              yaw_deg=4.0, ahead=1.2):
    """Numpy copy of TestPlaneSweepHom._geometry: a camera ring whose
    adjacent frame is `ahead` m ahead and yawed `yaw_deg` degrees (1.2 m
    and 4 degrees there)."""
    grid_cfg = GridConfig(x=(-40.0, 40.0, 0.4), y=(-40.0, 40.0, 0.4),
                          z=(-1.0, 5.4, 6.4), depth=(1.0, 25.0, 1.0))
    frustum = create_frustum(grid_cfg, input_size, cv_down)
    rig = camera_rig(N, input_size, rng)
    yaw = np.deg2rad(yaw_deg)
    adj = np.eye(4, dtype=np.float32)
    adj[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    adj[0, 3] = ahead
    s2e = rig["sensor2ego"]
    k2s = np.stack([np.linalg.inv(s2e[n]) @ np.linalg.inv(adj) @ s2e[n]
                    for n in range(N)]).astype(np.float32)[None]
    if with_postaug:
        th = 0.04
        pr = np.array([[np.cos(th), -np.sin(th), 0],
                       [np.sin(th), np.cos(th), 0],
                       [0, 0, 1]], np.float32) * np.array(
            [[0.95], [1.05], [1.0]], np.float32)
        post_rots = np.broadcast_to(pr, (1, N, 3, 3)).copy()
        post_trans = rng.normal(0, 2.0, (1, N, 3)).astype(np.float32)
    else:
        post_rots = np.broadcast_to(np.eye(3, dtype=np.float32),
                                    (1, N, 3, 3)).copy()
        post_trans = np.zeros((1, N, 3), np.float32)
    return frustum, k2s, rig["intrin"][None], post_rots, post_trans


def _hom_grid(hom, H, W):
    """The (BN, D*H, W, 2) normalized grid that the homographies define,
    behind-camera samples at -2 (the grid path's sentinel)."""
    BN, D = hom.shape[:2]
    ww = np.broadcast_to(np.arange(W, dtype=np.float32)[None], (H, W))
    hh = np.broadcast_to(np.arange(H, dtype=np.float32)[:, None], (H, W))
    pix = np.stack([ww, hh, np.ones_like(ww)], -1)
    proj = np.einsum("ndij,hwj->ndhwi", hom, pix).astype(np.float32)
    z = proj[..., 2]
    px = np.where(z < 1e-3, -2.0, proj[..., 0] / z / (0.5 * (W - 1)) - 1.0)
    py = np.where(z < 1e-3, -2.0, proj[..., 1] / z / (0.5 * (H - 1)) - 1.0)
    return np.stack([px, py], -1).reshape(BN, D * H, W, 2).astype(np.float32)


def test_homography_matches_jax():
    """With a rotation + scale + translation post-aug, and one camera's z
    row flipped so part of the frustum lies behind it."""
    rng = np.random.default_rng(11)
    input_size = (64, 128)
    geo = list(_geometry(rng, input_size, 2, 4, with_postaug=True))
    geo[1][0, 1, 2, :] *= -1.0
    want = np.asarray(jax_gen_stereo_homography(
        *[jnp.asarray(a) for a in geo], input_size))
    got = gen_stereo_homography(*[_t(a) for a in geo], input_size).numpy()
    assert got.shape == want.shape == (2, geo[0].shape[0], 3, 3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_stereo_grid_matches_jax():
    """Same rig as above, behind-camera sentinel (-2) included; grid values
    are normalized coordinates of magnitude ~1."""
    rng = np.random.default_rng(11)
    input_size = (64, 128)
    geo = list(_geometry(rng, input_size, 2, 4, with_postaug=True))
    geo[1][0, 1, 2, :] *= -1.0
    want = np.asarray(jax_gen_stereo_grid(
        *[jnp.asarray(a) for a in geo], input_size))
    got = gen_stereo_grid(*[_t(a) for a in geo], input_size).numpy()
    assert got.shape == want.shape
    assert (want == -2.0).any()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def sweep():
    rng = np.random.default_rng(7)
    input_size = (128, 352)
    N, C, cv_down = 3, 128, 4
    H, W = input_size[0] // cv_down, input_size[1] // cv_down
    geo = _geometry(rng, input_size, N, cv_down)
    hom = np.asarray(jax_gen_stereo_homography(
        *[jnp.asarray(a) for a in geo], input_size))
    prev = rng.normal(size=(N, H, W, C)).astype(np.float32)
    curr = rng.normal(size=(N, H, W, C)).astype(np.float32)
    cost = plane_sweep_cost_hom(_t(prev), _t(curr), _t(hom), BIAS)
    return dict(geo=geo, input_size=input_size, hom=hom, prev=prev,
                curr=curr, H=H, W=W, cost=cost)


def test_kernel_plain_matches_pallas(sweep):
    s = sweep
    got = s["cost"].numpy()
    np.testing.assert_array_equal(got, plane_sweep_cost_hom_plain(
        _t(s["prev"]), _t(s["curr"]), _t(s["hom"]), BIAS).numpy())
    want = np.asarray(jax_plane_sweep_cost_hom(
        jnp.asarray(s["prev"]), jnp.asarray(s["curr"]), jnp.asarray(s["hom"]),
        bias=BIAS, interpret=True))
    assert got.shape == want.shape
    # the empty-sample bias fired somewhere, and agrees
    assert ((got >= BIAS) & (want >= BIAS)).any()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_kernel_plain_matches_xla_oracle(sweep):
    """softmax(-cost) against stereo_cost_volume (F.grid_sample semantics,
    align_corners, zeros padding) on the grid the homographies define."""
    s = sweep
    ref = np.asarray(jax_stereo_cost_volume(
        jnp.asarray(s["prev"]), jnp.asarray(s["curr"]),
        jnp.asarray(_hom_grid(s["hom"], s["H"], s["W"])), bias=BIAS,
        depth_chunk=8))
    got = torch.softmax(-s["cost"], dim=1).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_kernel_plain_matches_xla_oracle_on_a_yawed_rig():
    """A rig yawed 12 degrees and 3 m ahead, whose per-plane footprints of
    a 64-pixel row tile span up to 6 rows: past the Pallas kernel's 4-row
    window (ROADMAP Queue 3, caveats), so the exact XLA stereo_cost_volume
    is the oracle. softmax(-cost) of the plain K3 against it."""
    from preworld_tpu_torch.ops.cost_volume_pallas import sample_positions

    rng = np.random.default_rng(7)
    input_size = (128, 352)
    N, C = 3, 128
    H, W = input_size[0] // 4, input_size[1] // 4
    geo = _geometry(rng, input_size, N, 4, yaw_deg=12.0, ahead=3.0)
    hom = np.asarray(jax_gen_stereo_homography(
        *[jnp.asarray(a) for a in geo], input_size))
    _, gy, ok = sample_positions(_t(hom), H, W)
    y0 = torch.where(ok, torch.floor(gy), torch.nan)[..., :64]
    rows = (y0.nan_to_num(-1e9).amax(-1) - y0.nan_to_num(1e9).amin(-1) + 2)
    assert rows[ok[..., :64].any(-1)].max() > 4
    prev = rng.normal(size=(N, H, W, C)).astype(np.float32)
    curr = rng.normal(size=(N, H, W, C)).astype(np.float32)
    ref = np.asarray(jax_stereo_cost_volume(
        jnp.asarray(prev), jnp.asarray(curr),
        jnp.asarray(_hom_grid(hom, H, W)), bias=BIAS, depth_chunk=8))
    got = torch.softmax(-plane_sweep_cost_hom(_t(prev), _t(curr), _t(hom),
                                              BIAS), dim=1).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_plain_grid_cost_volume_matches_jax(sweep):
    """The port's plain grid-path cost volume (F.grid_sample) against the
    JAX one on the same grid."""
    s = sweep
    grid = _hom_grid(s["hom"], s["H"], s["W"])
    want = np.asarray(jax_stereo_cost_volume(
        jnp.asarray(s["prev"]), jnp.asarray(s["curr"]), jnp.asarray(grid),
        bias=BIAS))
    got = port_stereo_cost_volume(_t(s["prev"]), _t(s["curr"]), _t(grid),
                                  BIAS).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_compute_stereo_cost_volume_matches_jax(sweep, monkeypatch):
    """The model-facing entry (homography + K3 + softmax, cast to the
    feature dtype) against the JAX entry on its homography path (the Pallas
    kernel in interpret mode) at 1e-4; and against the JAX XLA grid path,
    which reaches the same samples through another f32 coordinate chain:
    as in test_ops.py's TestPlaneSweepHom, that chain's composition noise
    moves a few softmax values past 1e-4 (at most 1e-3 here)."""
    import preworld_tpu.ops.cost_volume_pallas as cvp

    orig = cvp.plane_sweep_cost_hom
    monkeypatch.setattr(
        cvp, "plane_sweep_cost_hom",
        lambda prev, curr, hom, bias=0.0: orig(prev, curr, hom, bias=bias,
                                               interpret=True))
    s = sweep
    frustum, k2s, intr, prots, ptrans = s["geo"]
    jcams = {"intrin": jnp.asarray(intr), "post_rot": jnp.asarray(prots),
             "post_tran": jnp.asarray(ptrans)}
    jstereo = {"prev_feat": jnp.asarray(s["prev"]),
               "curr_feat": jnp.asarray(s["curr"]),
               "k2s_sensor": jnp.asarray(k2s)}

    def jax_entry(fused):
        return np.asarray(jax_compute_stereo_cost_volume(
            jnp.asarray(frustum), jcams, jstereo, s["input_size"], bias=BIAS,
            use_fused=fused, use_table=False))

    cams = {"intrin": _t(intr), "post_rot": _t(prots),
            "post_tran": _t(ptrans)}
    stereo = {"prev_feat": _t(s["prev"]), "curr_feat": _t(s["curr"]),
              "k2s_sensor": _t(k2s)}
    got = compute_stereo_cost_volume(_t(frustum), cams, stereo,
                                     s["input_size"], BIAS).numpy()
    want = jax_entry(True)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    grid_path = jax_entry(False)
    np.testing.assert_allclose(got, grid_path, rtol=1e-3, atol=1e-3)
    assert (np.abs(got - grid_path) > TOL).mean() < 1e-3


def test_non_planar_post_aug_raises():
    """The homography is exact only for 2-D image post-augs: a PreWorld
    whose stereo cost volume takes K3 (128 stereo channels) refuses a 3-D
    one before it queues any work."""
    cfg = tiny_config(if_post_finetune=True, backbone="swin",
                      swin_embed_dims=128, swin_depths=(1, 1, 1, 1))
    batch = to_device(synthetic_batch(cfg, 1, seed=0, with_labels=False),
                      "cpu")
    batch["post_rots"][0, 1, 1, 2, 0] = 0.01
    with pytest.raises(ValueError, match="2-D image post-augs"):
        PreWorld(cfg).eval().extract_voxel_feat(batch)
