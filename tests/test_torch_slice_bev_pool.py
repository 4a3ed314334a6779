"""Voxel-pooling parity of the PyTorch port against the JAX package
(CPU, f32).

The plain K4 path, through the port's wrapper `bev_pool_fused` on CPU
tensors (which runs `ops/bev_pool.bev_pool`) and through the kernel's own
prep (`bev_pool_prepare`: sort by voxel id; `interval_starts_plain`: the
boundary pass's interval starts) walked by `_walk_intervals`, against the
Pallas `bev_pool_fused` in interpret mode and the f64
`bev_pool_dense_oracle`. The id distributions mirror TestBevPoolPallas
(tests/test_ops.py): random ids with sentinels, all points in one voxel,
all points out of range, and ids packed at tile boundaries and the last
in-range voxel; and B = 2 with one voxel holding most points.
The boundary pass's plain twin is also held against searchsorted.
Tolerance rtol = atol = 1e-4.
"""

import numpy as np
import pytest
import torch

from preworld_tpu.geometry.frustum import frustum_pixel_indices
from preworld_tpu.ops.bev_pool import bev_pool_dense_oracle
from preworld_tpu.ops.bev_pool_pallas import bev_pool_fused as jax_bev_pool_fused
from preworld_tpu_torch.ops.bev_pool import bev_pool
from preworld_tpu_torch.ops.bev_pool_pallas import (
    bev_pool_fused,
    bev_pool_prepare,
    interval_starts_plain,
)

TOL = dict(rtol=1e-4, atol=1e-4)
SHAPE = (1, 2, 6, 4, 5)  # (B, N, D, Hf, Wf)
NVOX = int(1.5 * 512)


def _walk_intervals(order, starts, depth, pix, feat):
    """Plain interval walk over the kernel's prepared points, reading each
    point's depth and pixel through the sort's order."""
    C = feat.shape[-1]
    nv = starts.numel() - 1
    counts = (starts[1:] - starts[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(nv), counts)
    o = order[:int(starts[-1])]
    vals = (feat.reshape(-1, C)[pix.reshape(-1)[o].long()]
            * depth.reshape(-1)[o, None])
    out = torch.zeros((nv, C), dtype=feat.dtype)
    out.index_add_(0, seg, vals)
    return out


def _random_ids(rng):
    return rng.integers(0, NVOX + 1, size=SHAPE)


def _one_voxel(rng):
    return np.full(SHAPE, 7)


def _out_of_range(rng):
    return np.full(SHAPE, 10_000)


def _boundary(rng):
    ids = np.array([0, 511, 512, 513, 1023, NVOX - 1, NVOX, NVOX + 7])
    return rng.choice(ids, size=SHAPE)


@pytest.mark.parametrize("ids", [_random_ids, _one_voxel, _out_of_range,
                                 _boundary])
def test_bev_pool_matches_pallas_and_oracle(ids):
    rng = np.random.default_rng(3)
    B, N, D, H, W = SHAPE
    C = 8
    vox = ids(rng).astype(np.int32)
    depth = rng.uniform(size=SHAPE).astype(np.float32)
    feat = rng.normal(size=(B, N, H, W, C)).astype(np.float32)
    pix = frustum_pixel_indices(B, N, D, H, W)

    want = np.asarray(jax_bev_pool_fused(depth, feat, vox, pix, NVOX,
                                         pts_cap=512, interpret=True))
    oracle = bev_pool_dense_oracle(depth, feat, vox, pix, NVOX)
    np.testing.assert_allclose(want, oracle, **TOL)

    t = [torch.from_numpy(a) for a in (depth, feat, vox, pix)]
    got = bev_pool_fused(*t, NVOX).numpy()
    np.testing.assert_array_equal(got, bev_pool(*t, NVOX).numpy())
    assert got.shape == (NVOX, C) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)

    ids, order = bev_pool_prepare(t[2])
    starts = interval_starts_plain(ids, NVOX)
    assert starts.shape == (NVOX + 1,) and starts.dtype == torch.int32
    assert int(starts[-1]) == int((vox < NVOX).sum())
    walked = _walk_intervals(order, starts, t[0], t[3], t[1]).numpy()
    np.testing.assert_allclose(walked, oracle, **TOL)


def _sorted_ids(ids):
    return torch.sort(torch.from_numpy(ids.astype(np.int32)).reshape(-1),
                      stable=True)[0]


def _skewed(rng, shape=(2, 2, 6, 4, 5)):
    """B = 2: four fifths of the points in voxel 5, the rest spread with
    sentinels (num_voxels and far past it) and many empty voxels."""
    ids = rng.integers(0, NVOX + 1, size=shape)
    ids[rng.uniform(size=shape) < 0.8] = 5
    ids[rng.uniform(size=shape) < 0.05] = NVOX + 900
    return ids


@pytest.mark.parametrize("case", ["empty_voxels", "sentinels", "b2_skewed",
                                  "all_out_of_range", "no_points",
                                  "negative_ids"])
def test_interval_starts_plain_matches_searchsorted(case):
    """The boundary pass's plain twin gives every voxel's first sorted point,
    as torch.searchsorted does: runs of empty voxels, sentinel ids at and
    past num_voxels, B = 2 with one voxel holding most points, no point in
    range, no point at all, and negative ids (which sort first and belong to
    no voxel)."""
    rng = np.random.default_rng(5)
    ids = {
        "empty_voxels": lambda: rng.choice([3, 4, 300, NVOX - 1], size=SHAPE),
        "sentinels": lambda: rng.integers(NVOX - 20, NVOX + 20, size=SHAPE),
        "b2_skewed": lambda: _skewed(rng),
        "all_out_of_range": lambda: np.full(SHAPE, NVOX + 3),
        "no_points": lambda: np.zeros((0,), np.int64),
        "negative_ids": lambda: rng.integers(-30, NVOX + 30, size=SHAPE),
    }[case]()
    s = _sorted_ids(ids)
    got = interval_starts_plain(s, NVOX)
    want = torch.searchsorted(s, torch.arange(NVOX + 1, dtype=torch.int32))
    assert got.dtype == torch.int32 and got.shape == (NVOX + 1,)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_bev_pool_skewed_matches_pallas():
    """B = 2 with one voxel holding most points (the slices' case on the
    card): the port's bev_pool_fused and the kernel's walk over its prep
    against the Pallas bev_pool_fused in interpret mode and the oracle."""
    rng = np.random.default_rng(9)
    shape = (2, 2, 6, 4, 5)
    B, N, D, H, W = shape
    C = 8
    vox = _skewed(rng, shape).astype(np.int32)
    assert np.bincount(vox[vox < NVOX]).max() > 0.7 * vox.size
    depth = rng.uniform(size=shape).astype(np.float32)
    feat = rng.normal(size=(B, N, H, W, C)).astype(np.float32)
    pix = frustum_pixel_indices(B, N, D, H, W)
    want = np.asarray(jax_bev_pool_fused(depth, feat, vox, pix, NVOX,
                                         pts_cap=512, interpret=True))
    oracle = bev_pool_dense_oracle(depth, feat, vox, pix, NVOX)
    t = [torch.from_numpy(a) for a in (depth, feat, vox, pix)]
    got = bev_pool_fused(*t, NVOX).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    ids, order = bev_pool_prepare(t[2])
    walked = _walk_intervals(order, interval_starts_plain(ids, NVOX), t[0],
                             t[3], t[1]).numpy()
    np.testing.assert_allclose(walked, oracle, **TOL)
