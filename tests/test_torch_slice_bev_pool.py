"""Voxel-pooling parity of the PyTorch port against the JAX package
(CPU, f32).

The plain K4 path, through the port's wrapper `bev_pool_fused` on CPU
tensors (which runs `ops/bev_pool.bev_pool`) and through the kernel's own
prep (`bev_pool_prepare`: sort by voxel id, interval starts) walked by
`_walk_intervals`, against the Pallas `bev_pool_fused` in
interpret mode and the f64 `bev_pool_dense_oracle`. The id distributions
mirror TestBevPoolPallas (tests/test_ops.py): random ids with sentinels,
all points in one voxel, all points out of range, and ids packed at tile
boundaries and the last in-range voxel. Tolerance rtol = atol = 1e-4.
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
)

TOL = dict(rtol=1e-4, atol=1e-4)
SHAPE = (1, 2, 6, 4, 5)  # (B, N, D, Hf, Wf)
NVOX = int(1.5 * 512)


def _walk_intervals(depth_s, pix_s, starts, feat):
    """Plain interval walk over the kernel's prepared points."""
    C = feat.shape[-1]
    nv = starts.numel() - 1
    counts = (starts[1:] - starts[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(nv), counts)
    n = int(starts[-1])
    vals = feat.reshape(-1, C)[pix_s[:n].long()] * depth_s[:n, None]
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

    d_s, p_s, starts = bev_pool_prepare(t[0], t[2], t[3], NVOX)
    assert starts.shape == (NVOX + 1,) and starts.dtype == torch.int32
    assert int(starts[-1]) == int((vox < NVOX).sum())
    walked = _walk_intervals(d_s, p_s, starts, t[1]).numpy()
    np.testing.assert_allclose(walked, oracle, **TOL)
