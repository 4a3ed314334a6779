"""Lift-splat voxel pooling, plain PyTorch version.

Counterpart of `preworld_tpu/ops/bev_pool.py`:

    out[v] = sum_{p : vox(p) = v} depth[p] * feat[pix(p)]

Points whose id is `num_voxels` (the out-of-range sentinel) or above are
dropped. This is the plain version of kernel K4
(`ops/bev_pool_pallas.py::bev_pool_fused`).
"""

from __future__ import annotations

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

