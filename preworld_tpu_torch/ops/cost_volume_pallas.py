"""K3: the homography plane-sweep stereo cost volume.

Counterpart of `preworld_tpu/ops/cost_volume_pallas.py::plane_sweep_cost_hom`
(same module name; nothing here is Pallas):

    cost[bn, d, y, x] = sum_c |curr[bn, y, x, c] - bilinear(prev[bn], H_d (x, y, 1))[c]|
                        + bias * [sample[C-4] == 0]

`H_d` maps output feature-pixel indices homogeneously to previous-frame
feature-pixel coordinates (`models.depthnet.gen_stereo_homography`);
sampling is align-corners bilinear with zeros padding, and a plane whose
homogeneous z is below 1e-3 (behind the camera) samples nothing. Every
sample is exact: the TPU kernel's window approximations are not carried
over. The caller applies softmax(-cost) over D.

On a CUDA tensor `plane_sweep_cost_hom` launches `csrc/cost_volume.cu`;
on a CPU tensor it runs `plane_sweep_cost_hom_plain`. The two compute the
sample coordinates and bilinear weights with the same operations in the
same order.
"""

from __future__ import annotations

import torch

from . import _cuda

# depth planes per step of the plain version (bounds its (BN, planes, H, W, C)
# f32 sample tensors)
_DEPTH_CHUNK = 8
# the one channel width the kernel is built for: Swin stage 0 of Swin-B
_KERNEL_C = 128


def plane_sweep_cost_hom_plain(prev, curr, hom, bias: float = 0.0):
    """Plain PyTorch K3 (f32 arithmetic), chunked over depth planes.

    prev, curr: (BN, H, W, C); hom: (BN, D, 3, 3). Returns (BN, D, H, W) f32.
    """
    BN, H, W, C = prev.shape
    D = hom.shape[1]
    dev = prev.device
    flat = prev.float().reshape(BN, H * W, C)
    cf = curr.float()[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    bn_idx = torch.arange(BN, device=dev)[:, None]
    ci = max(C - 4, 0)
    out = torch.empty((BN, D, H, W), dtype=torch.float32, device=dev)
    h_all = hom.float().reshape(BN, D, 9)
    for d0 in range(0, D, _DEPTH_CHUNK):
        d1 = min(d0 + _DEPTH_CHUNK, D)
        h = [h_all[:, d0:d1, i][:, :, None, None] for i in range(9)]
        den = h[6] * xs + (h[7] * ys + h[8])
        bad = den < 1e-3
        inv = 1.0 / den
        gx = (h[0] * xs + h[1] * ys + h[2]) * inv
        gy = (h[3] * xs + h[4] * ys + h[5]) * inv
        inb = ~bad & (gx > -1.0) & (gx < W) & (gy > -1.0) & (gy < H)
        gx = torch.where(inb, gx, torch.zeros_like(gx))
        gy = torch.where(inb, gy, torch.zeros_like(gy))
        x0f, y0f = torch.floor(gx), torch.floor(gy)
        wx1, wy1 = gx - x0f, gy - y0f
        wx0, wy0 = 1.0 - wx1, 1.0 - wy1
        x0, y0 = x0f.long(), y0f.long()

        def corner(dy, dx):
            xi, yi = x0 + dx, y0 + dy
            ok = inb & (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(BN, -1)
            v = flat[bn_idx, idx].reshape(*ok.shape, C)
            return v * ok[..., None]

        top = corner(0, 0) * wx0[..., None] + corner(0, 1) * wx1[..., None]
        bot = corner(1, 0) * wx0[..., None] + corner(1, 1) * wx1[..., None]
        s = top * wy0[..., None] + bot * wy1[..., None]
        cost = (cf - s).abs().sum(-1)
        out[:, d0:d1] = cost + (s[..., ci] == 0.0).float() * bias
    return out


def plane_sweep_cost_hom(prev, curr, hom, bias: float = 0.0):
    """K3 wrapper: the CUDA kernel on a CUDA tensor, else the plain version."""
    if prev.device.type == "cpu":
        return plane_sweep_cost_hom_plain(prev, curr, hom, bias)
    BN, H, W, C = prev.shape
    D = hom.shape[1]
    if C != _KERNEL_C:
        raise ValueError(f"K3 takes C = {_KERNEL_C}, got {C}")
    bf = torch.bfloat16
    _cuda.require(prev, "prev", bf)
    _cuda.require(curr, "curr", bf, prev.shape)
    _cuda.require(hom, "hom", torch.float32, (BN, D, 3, 3))
    out = torch.empty((BN, D, H, W), dtype=torch.float32, device=prev.device)
    rc = _cuda.lib().pw_plane_sweep_cost_hom(
        prev.data_ptr(), curr.data_ptr(), hom.data_ptr(), out.data_ptr(),
        BN, D, H, W, C, float(bias), _cuda.stream_ptr(prev.device))
    _cuda.check(rc, "plane_sweep_cost_hom")
    _cuda.launches["plane_sweep_cost_hom"] += 1
    return out
