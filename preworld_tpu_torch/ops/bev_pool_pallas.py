"""K4: voxel pooling over voxel-sorted frustum points.

Counterpart of `preworld_tpu/ops/bev_pool_pallas.py` (same module name;
nothing here is Pallas). `bev_pool_fused` keeps the JAX package's prep
outside the kernel -- sort the points by voxel id carrying depth and pixel
index, then find every voxel's interval of sorted points -- and on a CUDA
tensor launches `csrc/bev_pool.cu`, which walks the intervals with one
thread per (voxel, channel), gathers feat[pix] * depth itself and writes
zeros for empty voxels (no atomics: deterministic). On a CPU tensor it runs
the plain `ops.bev_pool.bev_pool`.

`bev_pool_fused` is differentiable in depth and feat. Its backward is the
JAX package's custom VJP (`_bev_pool_fused_bwd`, XLA there, plain PyTorch
here, on either device): with G = grad_out[vox] gathered in the original
(b, n, d, h, w) point order and zero for out-of-range ids,
d_depth = <G, feat> per point and d_feat = sum over d of depth * G. No
scatter and no un-sort.
"""

from __future__ import annotations

import torch

from . import _cuda
from .bev_pool import bev_pool


def bev_pool_prepare(depth, vox_idx, pix_idx, num_voxels: int):
    """Sort points by voxel id; returns (depth, pix, starts) with
    starts (num_voxels + 1,) int32 such that voxel v owns the sorted points
    [starts[v], starts[v+1]). Sentinel points sort past starts[num_voxels]."""
    v = vox_idx.reshape(-1).to(torch.int32)
    v_s, order = torch.sort(v, stable=True)
    d_s = depth.reshape(-1)[order].contiguous()
    p_s = pix_idx.reshape(-1)[order].to(torch.int32).contiguous()
    bounds = torch.arange(num_voxels + 1, dtype=torch.int32, device=v.device)
    starts = torch.searchsorted(v_s, bounds).to(torch.int32)
    return d_s, p_s, starts


def bev_pool_fused_bwd(depth, feat, vox_idx, num_voxels: int, g):
    """(d_depth, d_feat) of `bev_pool_fused` for the cotangent g
    (num_voxels, C), accumulated in f32, in the inputs' dtypes."""
    C = feat.shape[-1]
    valid = (vox_idx < num_voxels)[..., None]
    safe = vox_idx.clamp(0, num_voxels - 1).reshape(-1).long()
    G = g.float()[safe].reshape(*vox_idx.shape, C)
    G = torch.where(valid, G, 0.0)
    d_depth = torch.einsum("bndhwc,bnhwc->bndhw", G, feat.float())
    d_feat = torch.einsum("bndhwc,bndhw->bnhwc", G, depth.float())
    return d_depth.to(depth.dtype), d_feat.to(feat.dtype)


def _forward_cuda(depth, feat, vox_idx, pix_idx, num_voxels: int):
    C = feat.shape[-1]
    bf = torch.bfloat16
    _cuda.require(feat, "feat", bf)
    if depth.dtype != bf:
        raise TypeError(f"depth: expected {bf}, got {depth.dtype}")
    if depth.numel() != vox_idx.numel() or depth.numel() != pix_idx.numel():
        raise ValueError("depth, vox_idx and pix_idx must have one entry per point")
    d_s, p_s, starts = bev_pool_prepare(depth, vox_idx, pix_idx, num_voxels)
    _cuda.require(d_s, "depth", bf)
    _cuda.require(p_s, "pix", torch.int32)
    _cuda.require(starts, "starts", torch.int32, (num_voxels + 1,))
    out = torch.empty((num_voxels, C), dtype=bf, device=feat.device)
    rc = _cuda.lib().pw_bev_pool_intervals(
        d_s.data_ptr(), p_s.data_ptr(), starts.data_ptr(), feat.data_ptr(),
        out.data_ptr(), num_voxels, C, _cuda.stream_ptr(feat.device))
    _cuda.check(rc, "bev_pool_fused")
    _cuda.launches["bev_pool_fused"] += 1
    return out


class _BevPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, depth, feat, vox_idx, pix_idx, num_voxels):
        ctx.save_for_backward(depth, feat, vox_idx)
        ctx.num_voxels = num_voxels
        fwd = bev_pool if feat.device.type == "cpu" else _forward_cuda
        return fwd(depth, feat, vox_idx, pix_idx, num_voxels)

    @staticmethod
    def backward(ctx, g):
        depth, feat, vox_idx = ctx.saved_tensors
        d_depth, d_feat = bev_pool_fused_bwd(depth, feat, vox_idx,
                                             ctx.num_voxels, g)
        return d_depth, d_feat, None, None, None


def bev_pool_fused(depth, feat, vox_idx, pix_idx, num_voxels: int):
    """K4 wrapper, differentiable in depth and feat. depth (B, N, D, Hf,
    Wf); feat (B, N, Hf, Wf, C); vox_idx, pix_idx (B, N, D, Hf, Wf).
    Returns (num_voxels, C) in feat.dtype: the CUDA kernel on a CUDA
    tensor, else the plain `bev_pool`."""
    return _BevPool.apply(depth, feat, vox_idx, pix_idx, num_voxels)
