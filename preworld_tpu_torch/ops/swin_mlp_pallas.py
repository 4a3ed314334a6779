"""K2: the Swin MLP half-block, out = x + rs * (fc2(GELU(fc1(LN2(x)))) + b2).

Counterpart of `preworld_tpu/ops/swin_mlp_pallas.py` (same module name;
nothing here is Pallas). `fused_swin_mlp` is differentiable (an autograd
`Function` saving only its inputs). On a CUDA tensor its forward launches
the hand-written kernels in `csrc/swin_mlp.cu` (LN2 row statistics, then
fc1 and fc2 on the TMA + wgmma GEMM of `csrc/gemm_sm90.cuh`) and its
backward the chain in `csrc/swin_mlp_bwd.cu` (K2b); on a CPU tensor they
run `fused_swin_mlp_plain` and autograd through it
(`fused_swin_mlp_bwd_plain`). GELU is the exact erf form; `row_scale`
(drop path) gets no gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda


def fused_swin_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2, row_scale=None):
    """Plain PyTorch K2, rounding where the kernel rounds.

    x: (..., C); w1 (Hd, C), w2 (C, Hd) in the PyTorch Linear layout;
    row_scale: (M,) per flattened row, or None. LN in f32, the LN output
    and the hidden in x.dtype, products accumulated in f32.
    """
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = (xc * torch.rsqrt(var + 1e-5) * ln_w.float() + ln_b.float()).to(dt)
    h = F.gelu(y.float() @ w1.float().t() + b1.float()).to(dt)
    o = h.float() @ w2.float().t() + b2.float()
    if row_scale is not None:
        o = o * row_scale.float().reshape(x.shape[:-1] + (1,))
    return (xf + o).to(dt)


def fused_swin_mlp_bwd_plain(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, dy):
    """Plain K2 backward: autograd through `fused_swin_mlp_plain`. Returns
    the gradients of (x, ln_w, ln_b, w1, b1, w2, b2) in their dtypes."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in
                  (x, ln_w, ln_b, w1, b1, w2, b2)]
        out = fused_swin_mlp_plain(*leaves, row_scale)
        return torch.autograd.grad(out, leaves, dy.to(out.dtype))


def _check(x, w1):
    C = x.shape[-1]
    Hd = w1.shape[0]
    M = x.numel() // C
    if C % 128 or Hd % 128:
        raise ValueError(f"K2 does not take C={C}, hidden={Hd}")
    if -(-M // 128) > 65535:
        raise ValueError(f"K2: {M} rows exceed the launch grid")
    return M, C, Hd


def _forward_cuda(x, ln_w, ln_b, w1, b1, w2, b2, row_scale):
    M, C, Hd = _check(x, w1)
    bf = torch.bfloat16
    _cuda.require(x, "x", bf)
    w1 = _cuda.bf16(w1, "w1", (Hd, C))
    w2 = _cuda.bf16(w2, "w2", (C, Hd))
    lw = _cuda.f32(ln_w, "ln_w", C)
    lb = _cuda.f32(ln_b, "ln_b", C)
    c1 = _cuda.f32(b1, "b1", Hd)
    c2 = _cuda.f32(b2, "b2", C)
    rs = _cuda.f32(row_scale, "row_scale", M)
    stats = torch.empty((M, 2), dtype=torch.float32, device=x.device)
    hidden = torch.empty((M, Hd), dtype=bf, device=x.device)
    out = torch.empty_like(x)
    rc = _cuda.lib().pw_swin_mlp(
        x.data_ptr(), lw.data_ptr(), lb.data_ptr(), w1.data_ptr(),
        c1.data_ptr(), w2.data_ptr(), c2.data_ptr(), _cuda.ptr(rs),
        stats.data_ptr(), hidden.data_ptr(), out.data_ptr(), M, C, Hd,
        _cuda.stream_ptr(x.device))
    _cuda.check(rc, "fused_swin_mlp")
    _cuda.launches["fused_swin_mlp"] += 1
    return out


def fused_swin_mlp_bwd(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, dy):
    """K2b wrapper: gradients of (x, ln_w, ln_b, w1, b1, w2, b2) for the
    cotangent dy. The CUDA kernel chain on a CUDA tensor (dx in bf16, the
    rest in f32), else `fused_swin_mlp_bwd_plain`."""
    if x.device.type == "cpu":
        return fused_swin_mlp_bwd_plain(x, ln_w, ln_b, w1, b1, w2, b2,
                                        row_scale, dy)
    M, C, Hd = _check(x, w1)
    bf, f = torch.bfloat16, torch.float32
    dev = x.device
    _cuda.require(x, "x", bf)
    w1 = _cuda.bf16(w1, "w1", (Hd, C))
    w2 = _cuda.bf16(w2, "w2", (C, Hd))
    dy = _cuda.require(dy.to(bf).contiguous(), "dy", bf, x.shape)
    lw = _cuda.f32(ln_w, "ln_w", C)
    lb = _cuda.f32(ln_b, "ln_b", C)
    c1 = _cuda.f32(b1, "b1", Hd)
    rs = _cuda.f32(row_scale, "row_scale", M)
    lib = _cuda.lib()
    dx = torch.empty_like(x)
    dln = torch.empty((2, C), dtype=f, device=dev)
    dw1 = torch.empty((Hd, C), dtype=f, device=dev)
    db1 = torch.empty((Hd,), dtype=f, device=dev)
    dw2 = torch.empty((C, Hd), dtype=f, device=dev)
    db2 = torch.empty((C,), dtype=f, device=dev)
    h_buf = torch.empty((M, Hd), dtype=bf, device=dev)
    hpre_buf = torch.empty((M, Hd), dtype=f, device=dev)
    dyb_buf = torch.empty((M, C), dtype=bf, device=dev)
    stats = torch.empty((M, 2), dtype=f, device=dev)
    part = torch.empty((lib.pw_swin_mlp_bwd_part_elems(M, C, Hd),), dtype=f,
                       device=dev)
    rc = lib.pw_swin_mlp_bwd(
        x.data_ptr(), lw.data_ptr(), lb.data_ptr(), w1.data_ptr(),
        c1.data_ptr(), w2.data_ptr(), _cuda.ptr(rs), dy.data_ptr(),
        dx.data_ptr(), dln.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
        dw2.data_ptr(), db2.data_ptr(), h_buf.data_ptr(), hpre_buf.data_ptr(),
        dyb_buf.data_ptr(), stats.data_ptr(), part.data_ptr(), M, C, Hd,
        _cuda.stream_ptr(dev))
    _cuda.check(rc, "fused_swin_mlp_bwd")
    _cuda.launches["fused_swin_mlp_bwd"] += 1
    return dx, dln[0], dln[1], dw1, db1, dw2, db2


class _Mlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, row_scale):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2, row_scale)
        fwd = fused_swin_mlp_plain if x.device.type == "cpu" else _forward_cuda
        return fwd(x, ln_w, ln_b, w1, b1, w2, b2, row_scale)

    @staticmethod
    def backward(ctx, dy):
        return tuple(fused_swin_mlp_bwd(*ctx.saved_tensors, dy)) + (None,)


def fused_swin_mlp(x, ln_w, ln_b, w1, b1, w2, b2, row_scale=None):
    """K2 wrapper, differentiable: the CUDA kernels on a CUDA tensor, else
    the plain version. Arguments as in `fused_swin_mlp_plain`."""
    return _Mlp.apply(x, ln_w, ln_b, w1, b1, w2, b2, row_scale)
