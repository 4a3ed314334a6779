"""Lift-splat voxel pooling, plain PyTorch version.

Counterpart of `preworld_tpu/ops/bev_pool.py`:

    out[v] = sum_{p : vox(p) = v} depth[p] * feat[pix(p)]

Points whose id is `num_voxels` (the out-of-range sentinel) or above are
dropped. This is the plain version of kernel K4
(`ops/bev_pool_pallas.py::bev_pool_fused`). `bev_pool_dense_oracle` is
the JAX package's O(P * V) float64 oracle, for tests.
"""

from __future__ import annotations

import numpy as np
import torch


def bev_pool(depth, feat, vox_idx, pix_idx, num_voxels: int):
    """Splat per-frustum-point depth * context into the voxel grid.

    depth: (B, N, D, Hf, Wf); feat: (B, N, Hf, Wf, C); vox_idx, pix_idx:
    (B, N, D, Hf, Wf) integer. Returns (num_voxels, C) in feat.dtype,
    accumulated in f32.
    """
    C = feat.shape[-1]
    d = depth.reshape(-1).float()
    v = vox_idx.reshape(-1).long()
    p = pix_idx.reshape(-1).long()
    keep = v < num_voxels
    vals = feat.reshape(-1, C)[p[keep]].float() * d[keep, None]
    out = torch.zeros((num_voxels, C), dtype=torch.float32, device=feat.device)
    out.index_add_(0, v[keep], vals)
    return out.to(feat.dtype)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def bev_pool_dense_oracle(depth, feat, vox_idx, pix_idx, num_voxels: int):
    """O(P * V) float64 reference on tensors or arrays, point by point; ids
    of `num_voxels` and above are dropped. Returns a (num_voxels, C) numpy
    array."""
    C = feat.shape[-1]
    d = _np(depth).reshape(-1)
    v = _np(vox_idx).reshape(-1)
    p = _np(pix_idx).reshape(-1)
    f = _np(feat).reshape(-1, C)
    out = np.zeros((num_voxels, C), np.float64)
    for i in range(d.shape[0]):
        if v[i] < num_voxels:
            out[v[i]] += d[i] * f[p[i]]
    return out
