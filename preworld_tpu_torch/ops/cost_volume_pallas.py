"""K3 and K7: the plane-sweep stereo cost volume.

Counterpart of `preworld_tpu/ops/cost_volume_pallas.py::plane_sweep_cost_hom`
(K3) and `::plane_sweep_cost` (K7) (same module name; nothing here is
Pallas):

    cost[bn, d, y, x] = sum_c |curr[bn, y, x, c] - bilinear(prev[bn], (gx, gy))[c]|
                        + bias * [sample[C-4] == 0]

K3 takes the sample position (gx, gy) of output pixel (x, y) on plane d
from the plane's homography `H_d` (x, y, 1)
(`models.depthnet.gen_stereo_homography`; a homogeneous z below 1e-3,
behind the camera, samples nothing); K7 from a precomputed (BN, D*H, W, 2)
normalised grid (`models.depthnet.gen_stereo_grid`), unnormalised as
((g + 1) * 0.5) * (size - 1). A position samples when -1 < gx < W and
-1 < gy < H; sampling is align-corners bilinear with zeros padding. Every
sample is exact: the TPU kernels' window approximations are not carried
over. The caller applies softmax(-cost) over D.

On a CUDA tensor `plane_sweep_cost_hom` / `plane_sweep_cost` launch
`csrc/cost_volume.cu`; on a CPU tensor they run their `_plain` twins, which
share one sampling helper (`_sample_cost`). Kernel and plain version
compute the sample coordinates and bilinear weights with the same
operations in the same order. `plane_sweep_supported` (the JAX package's
test) is the route test of the model's stereo cost volume: K3 where it
holds (every such width is a multiple of 128; K3 is built for 128 ...
1536), else the grid route. K7 is reached only through
`models.depthnet.stereo_cost_volume_fused`, as in the JAX package.
"""

from __future__ import annotations

import torch

from . import _cuda

# depth planes per step of the plain version (bounds its (BN, planes, H, W, C)
# f32 sample tensors)
_DEPTH_CHUNK = 8
# the kernel's builds: C = 128 k, k = 1 ... 12
_KERNEL_CHUNK, _KERNEL_MAX_C = 128, 1536
# the TPU kernel's output tile (rows, lane width), which its support test
# reads
TH, TW = 8, 128


def plane_sweep_supported(feat_shape) -> bool:
    """The JAX package's `plane_sweep_supported` (a copy): True iff the TPU
    kernel's layout assumptions hold for (BN, H, W, C) stereo features: H
    a multiple of the 8-row output tile, C a multiple of 128 lanes, and H
    and the 128-padded W within the ranges its packed window starts
    encode."""
    _, H, W, C = feat_shape
    wh = min(48, H)
    wp = max(-(-W // TW) * TW, 256)
    return (
        H % TH == 0 and C % 128 == 0 and H - wh <= 127
        and wp - min(224, wp) <= 15 * 16
    )


def _sample_cost(flat, cf, gx, gy, ok, bias: float):
    """The plain cost of one chunk of planes from its sample positions:
    flat (BN, H*W, C) and cf (BN, 1, H, W, C) f32; gx, gy (BN, planes, H, W)
    f32 pixel coordinates; ok (BN, planes, H, W) bool, False where the
    position samples nothing. Align-corners bilinear with zeros padding, in
    the kernel's order of operations. Returns (BN, planes, H, W) f32."""
    BN, _, H, W, C = cf.shape
    inb = ok & (gx > -1.0) & (gx < W) & (gy > -1.0) & (gy < H)
    gx = torch.where(inb, gx, torch.zeros_like(gx))
    gy = torch.where(inb, gy, torch.zeros_like(gy))
    x0f, y0f = torch.floor(gx), torch.floor(gy)
    wx1, wy1 = gx - x0f, gy - y0f
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    x0, y0 = x0f.long(), y0f.long()
    bn_idx = torch.arange(BN, device=flat.device)[:, None]

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
    return cost + (s[..., max(C - 4, 0)] == 0.0).float() * bias


def _plain_cost(prev, curr, D: int, coords, bias: float):
    """The plain cost volume (BN, D, H, W) f32, chunked over depth planes;
    coords(d0, d1, xs, ys) gives the chunk's (gx, gy, ok)."""
    BN, H, W, C = prev.shape
    dev = prev.device
    flat = prev.float().reshape(BN, H * W, C)
    cf = curr.float()[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    out = torch.empty((BN, D, H, W), dtype=torch.float32, device=dev)
    for d0 in range(0, D, _DEPTH_CHUNK):
        d1 = min(d0 + _DEPTH_CHUNK, D)
        out[:, d0:d1] = _sample_cost(flat, cf, *coords(d0, d1, xs, ys), bias)
    return out


def _hom_coords(h_all, d0: int, d1: int, xs, ys):
    """Planes [d0, d1)'s sample positions (gx, gy) and in-front flags from
    the (BN, D, 9) f32 homographies, in the kernel's order of operations."""
    h = [h_all[:, d0:d1, i][:, :, None, None] for i in range(9)]
    den = h[6] * xs + (h[7] * ys + h[8])
    inv = 1.0 / den
    gx = (h[0] * xs + h[1] * ys + h[2]) * inv
    gy = (h[3] * xs + h[4] * ys + h[5]) * inv
    return gx, gy, ~(den < 1e-3)


def sample_positions(hom, H: int, W: int):
    """K3's sample positions of every (pixel, plane): gx, gy (BN, D, H, W)
    f32 and ok (BN, D, H, W) bool, True where the position samples (in
    front of the camera and -1 < gx < W, -1 < gy < H)."""
    BN, D = hom.shape[:2]
    dev = hom.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    gx, gy, ok = _hom_coords(hom.float().reshape(BN, D, 9), 0, D, xs, ys)
    return gx, gy, ok & (gx > -1.0) & (gx < W) & (gy > -1.0) & (gy < H)


def plane_sweep_cost_hom_plain(prev, curr, hom, bias: float = 0.0):
    """Plain PyTorch K3 (f32 arithmetic), chunked over depth planes.

    prev, curr: (BN, H, W, C); hom: (BN, D, 3, 3). Returns (BN, D, H, W) f32.
    """
    BN, D = hom.shape[:2]
    h_all = hom.float().reshape(BN, D, 9)
    def coords(d0, d1, xs, ys):
        return _hom_coords(h_all, d0, d1, xs, ys)

    return _plain_cost(prev, curr, D, coords, bias)


def plane_sweep_cost_plain(prev, curr, grid, bias: float = 0.0):
    """Plain PyTorch K7 (f32 arithmetic), chunked over depth planes.

    prev, curr: (BN, H, W, C); grid: (BN, D*H, W, 2) normalised (x, y).
    Returns (BN, D, H, W) f32.
    """
    BN, H, W, _ = prev.shape
    D = grid.shape[1] // H
    g = grid.float().reshape(BN, D, H, W, 2)

    def coords(d0, d1, xs, ys):
        gc = g[:, d0:d1]
        gx = ((gc[..., 0] + 1.0) * 0.5) * (W - 1)
        gy = ((gc[..., 1] + 1.0) * 0.5) * (H - 1)
        return gx, gy, torch.ones_like(gx, dtype=torch.bool)

    return _plain_cost(prev, curr, D, coords, bias)


def plane_sweep_cost_flops(BN: int, D: int, H: int, W: int, C: int) -> int:
    """What `torch.utils.flop_counter` counts for the plain twins of K3 and
    K7 at these shapes: 0. Their arithmetic (sample positions, bilinear
    weights, the |curr - sample| channel sum) is gathers and elementwise
    operations, and the counter counts only products and convolutions
    (`mm`, `bmm`, `addmm`, `convolution`, attention), so the forward FLOP
    count (`utils/flops.py`) leaves these kernels' work out on either
    device."""
    return 0


def plane_sweep_cost_hom_bytes(prev, curr, hom, bias: float = 0.0):
    """The bytes `plane_sweep_cost_hom` counts as one kernel call: its
    operands as passed and its (BN, D, H, W) f32 result."""
    BN, H, W, _ = prev.shape
    return (_cuda.operand_bytes(prev, curr, hom)
            + _cuda.result_bytes((BN, hom.shape[1], H, W), torch.float32))


def plane_sweep_cost_bytes(prev, curr, grid, bias: float = 0.0):
    """The bytes `plane_sweep_cost` counts as one kernel call: its operands
    as passed and its (BN, D, H, W) f32 result, D = grid rows / H."""
    BN, H, W, _ = prev.shape
    return (_cuda.operand_bytes(prev, curr, grid)
            + _cuda.result_bytes((BN, grid.shape[1] // H, H, W),
                                 torch.float32))


def plane_sweep_cost_transcendentals(prev, curr, sampling, bias: float = 0.0):
    """What `utils/flops.py` counts as transcendentals for the plain twins
    of K3 and K7: 0 (a reciprocal, floors and products; no function of the
    counted list)."""
    return 0


def _check_width(C: int, name: str) -> None:
    if C % _KERNEL_CHUNK or not 0 < C <= _KERNEL_MAX_C:
        raise ValueError(f"{name} takes C = {_KERNEL_CHUNK} k up to "
                         f"{_KERNEL_MAX_C}, got {C}")


@_cuda.counted("plane_sweep_cost_hom", plane_sweep_cost_hom_bytes,
               plane_sweep_cost_transcendentals)
def plane_sweep_cost_hom(prev, curr, hom, bias: float = 0.0):
    """K3 wrapper: the CUDA kernel on a CUDA tensor, else the plain version."""
    if prev.device.type == "cpu":
        return plane_sweep_cost_hom_plain(prev, curr, hom, bias)
    BN, H, W, C = prev.shape
    D = hom.shape[1]
    _check_width(C, "K3")
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
    _cuda.flops["plane_sweep_cost_hom"] += plane_sweep_cost_flops(
        BN, D, H, W, C)
    return out


@_cuda.counted("plane_sweep_cost", plane_sweep_cost_bytes,
               plane_sweep_cost_transcendentals)
def plane_sweep_cost(prev, curr, grid, bias: float = 0.0):
    """K7 wrapper: the CUDA kernel on a CUDA tensor, else the plain version.

    prev, curr: (BN, H, W, C) bf16, C = 128 k up to 1536; grid: (BN, D*H, W,
    2) f32. The grid stays f32: the JAX package's bench casts it to the
    features' bf16, which would round sample positions by up to 1/512 of
    the map's width (0.7 pixel at 352). Returns (BN, D, H, W) f32.
    """
    if prev.device.type == "cpu":
        return plane_sweep_cost_plain(prev, curr, grid, bias)
    BN, H, W, C = prev.shape
    _check_width(C, "K7")
    if grid.dim() != 4 or grid.shape[1] % H:
        raise ValueError(f"K7: grid {tuple(grid.shape)} is not (BN, D*H, W, 2)")
    D = grid.shape[1] // H
    bf = torch.bfloat16
    _cuda.require(prev, "prev", bf)
    _cuda.require(curr, "curr", bf, prev.shape)
    _cuda.require(grid, "grid", torch.float32, (BN, D * H, W, 2))
    out = torch.empty((BN, D, H, W), dtype=torch.float32, device=prev.device)
    rc = _cuda.lib().pw_plane_sweep_cost_grid(
        prev.data_ptr(), curr.data_ptr(), grid.data_ptr(), out.data_ptr(),
        BN, D, H, W, C, float(bias), _cuda.stream_ptr(prev.device))
    _cuda.check(rc, "plane_sweep_cost")
    _cuda.launches["plane_sweep_cost"] += 1
    _cuda.flops["plane_sweep_cost"] += plane_sweep_cost_flops(BN, D, H, W, C)
    return out
