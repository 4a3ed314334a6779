"""K4: voxel pooling over voxel-sorted frustum points.

Counterpart of `preworld_tpu/ops/bev_pool_pallas.py` (same module name;
nothing here is Pallas). `bev_pool_fused` keeps the JAX package's sort
outside the kernel (`bev_pool_prepare`: torch.sort of the voxel ids, stable)
and on a CUDA tensor launches `csrc/bev_pool.cu` (`bev_pool_sorted`): a
boundary pass over the sorted ids writes every voxel's interval start
(plain twin `interval_starts_plain`, equal to torch.searchsorted) and each
point's depth and pixel, read through the sort's order, in sorted order;
long intervals are summed by slices of sorted points; the interval walk
gathers feat[pix] * depth itself and writes zeros for empty voxels (no
atomics: deterministic). On a CPU tensor it runs the plain
`ops.bev_pool.bev_pool`.

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


def bev_pool_prepare(vox_idx):
    """Sort the points by voxel id (stable): (ids, order), the sorted int32
    ids and the sort's int64 permutation. The kernel reads each point's
    depth and pixel through `order`."""
    return torch.sort(vox_idx.reshape(-1).to(torch.int32), stable=True)


def interval_starts_plain(ids, num_voxels: int):
    """The kernel's boundary pass in plain PyTorch: with u the sorted ids
    clipped to [-1, num_voxels], sorted point i starts the voxels (u[i-1],
    u[i]] (u[-1] = -1, u[P] = num_voxels). Returns starts (num_voxels + 1,)
    int32: voxel v owns the sorted points [starts[v], starts[v+1]); sentinel
    points sort past starts[num_voxels], points with a negative id before
    starts[0]. Equal to torch.searchsorted(ids, arange)."""
    u = ids.clamp(-1, num_voxels).long()
    lo = torch.cat([u.new_full((1,), -1), u])  # u[i-1], i = 0 ... P
    hi = torch.cat([u, u.new_full((1,), num_voxels)])  # u[i]
    first = torch.arange(u.numel() + 1, dtype=torch.int32, device=ids.device)
    return torch.repeat_interleave(first, hi - lo)


def bev_pool_flops(P: int, C: int, num_voxels: int) -> int:
    """What `torch.utils.flop_counter` counts for K4's plain twin
    (`ops.bev_pool.bev_pool`) on P points of C channels: 0. Its depth x
    feature products are elementwise and its sums an `index_add_`, which
    the counter does not count (it counts products and convolutions), so
    the forward FLOP count (`utils/flops.py`) leaves this kernel's work
    out on either device."""
    return 0


def bev_pool_bytes(depth, feat, vox_idx, pix_idx, num_voxels: int):
    """The bytes `bev_pool_fused` counts as one kernel call: its operands as
    passed and its (num_voxels, C) result in feat's dtype. The sort and the
    boundary pass's scratch are inside the call and not counted."""
    return (_cuda.operand_bytes(depth, feat, vox_idx, pix_idx)
            + _cuda.result_bytes((num_voxels, feat.shape[-1]), feat.dtype))


def bev_pool_transcendentals(depth, feat, vox_idx, pix_idx,
                             num_voxels: int):
    """What `utils/flops.py` counts as transcendentals for K4's plain twin:
    0 (products and an index add)."""
    return 0


def bev_pool_sorted(ids, order, depth, pix, feat, num_voxels: int):
    """K4's kernels on CUDA tensors, after the sort: the boundary pass, the
    long intervals' slices and the interval walk. ids, order from
    `bev_pool_prepare`; depth (P,) bf16 and pix (P,) int32 in the points'
    original order; feat (num_pixels, C) bf16, C % 8 == 0 up to 256.
    Returns (out (num_voxels, C) bf16, starts (num_voxels + 1,) int32)."""
    P, C = ids.numel(), feat.shape[-1]
    bf = torch.bfloat16
    _cuda.require(ids, "ids", torch.int32, (P,))
    _cuda.require(order, "order", torch.int64, (P,))
    _cuda.require(depth, "depth", bf, (P,))
    _cuda.require(pix, "pix", torch.int32, (P,))
    _cuda.require(feat, "feat", bf)
    if C % 8 or not 0 < C <= 256:
        raise ValueError(f"K4 takes C % 8 == 0 up to 256, got {C}")
    dev = feat.device
    lib = _cuda.lib()
    # scratch: packed (pixel, depth) of the sorted points, then the starts;
    # the long intervals' partial sums per slice of sorted points
    ints = torch.empty(2 * P + num_voxels + 1, dtype=torch.int32, device=dev)
    parts = torch.empty((2, lib.pw_bev_pool_slices(P), C), dtype=torch.float32,
                        device=dev)
    out = torch.empty((num_voxels, C), dtype=bf, device=dev)
    rc = lib.pw_bev_pool_intervals(
        ids.data_ptr(), order.data_ptr(), depth.data_ptr(), pix.data_ptr(),
        feat.data_ptr(), ints.data_ptr() + 8 * P, ints.data_ptr(),
        parts.data_ptr(), out.data_ptr(), P, num_voxels, C,
        _cuda.stream_ptr(dev))
    _cuda.check(rc, "bev_pool_fused")
    _cuda.launches["bev_pool_fused"] += 1
    _cuda.flops["bev_pool_fused"] += bev_pool_flops(P, C, num_voxels)
    return out, ints[2 * P:]


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
    if depth.numel() != vox_idx.numel() or depth.numel() != pix_idx.numel():
        raise ValueError("depth, vox_idx and pix_idx must have one entry per point")
    ids, order = bev_pool_prepare(vox_idx)
    return bev_pool_sorted(
        ids, order, depth.reshape(-1).contiguous(),
        pix_idx.reshape(-1).to(torch.int32).contiguous(),
        feat.reshape(-1, feat.shape[-1]), num_voxels)[0]


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


@_cuda.counted("bev_pool_fused", bev_pool_bytes, bev_pool_transcendentals)
def bev_pool_fused(depth, feat, vox_idx, pix_idx, num_voxels: int):
    """K4 wrapper, differentiable in depth and feat. depth (B, N, D, Hf,
    Wf); feat (B, N, Hf, Wf, C); vox_idx, pix_idx (B, N, D, Hf, Wf).
    Returns (num_voxels, C) in feat.dtype: the CUDA kernel on a CUDA
    tensor, else the plain `bev_pool`."""
    return _BevPool.apply(depth, feat, vox_idx, pix_idx, num_voxels)
