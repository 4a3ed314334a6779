"""K1: the Swin attention half-block on the padded (B, Hp, Wp, C) layout.

Counterpart of `preworld_tpu/ops/swin_block_pallas.py` (the module keeps
its name so the two are easy to pair; nothing here is Pallas):

    out = x + row_scale * proj(WMSA(zeropad(LN1(x))))

`x` and `out` are in image order; a shifted block attends over the layout
rolled by (-shift, -shift), which the kernel reaches through its indexing
(the JAX kernel takes x pre-rolled and the caller rolls around it). Pad
tokens are zeroed after LN1, as in the reference "zero-pad after norm1"
semantics. `fused_swin_attn_block` is differentiable (an autograd
`Function` that saves only its inputs, as the JAX custom VJP does). On a
CUDA tensor its forward launches the hand-written kernel chain in
`csrc/swin_block.cu` (LN1 row statistics, the LN1 + qkv product and the
proj product with its residual epilogue on the TMA + wgmma GEMM of
`csrc/gemm_sm90.cuh`, window attention between them) and its backward
the chain in `csrc/swin_block_bwd.cu` (K1b); on a CPU tensor they run
`fused_swin_attn_block_plain` and autograd through it
(`fused_swin_attn_block_bwd_plain`). The region ids and
`row_scale` (drop path) get no gradient; the rel-bias gradient flows back
to the caller's bias table through its index gather.

The shift mask enters as the (nH*nW, N) region-id table of
`models.swin.shifted_window_region_ids`: two tokens of a window may attend
to each other (mask 0) iff their ids agree, else the mask is -100.
"""

from __future__ import annotations

import torch

from . import _cuda
from .window_attn_pallas import (
    fused_window_attention_plain,
    window_partition,
    window_reverse,
)


def region_mask(region_ids: torch.Tensor) -> torch.Tensor:
    """(nW, N) region ids -> (nW, N, N) additive mask of 0 / -100."""
    ids = region_ids
    return torch.where(ids[:, None, :] != ids[:, :, None],
                       torch.tensor(-100.0, device=ids.device),
                       torch.tensor(0.0, device=ids.device))


def fused_swin_attn_block_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                                rel_bias, region_ids, row_scale, heads, ws,
                                H, W, shift):
    """Plain PyTorch K1, rounding where the kernel rounds.

    LN in f32, the LN output, qkv, probabilities and attention output in
    x.dtype, every product accumulated in f32, the residual added in f32.
    Weights in the PyTorch Linear layout: wqkv (3C, C), wproj (C, C).
    """
    B, Hp, Wp, C = x.shape
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + 1e-5) * ln_w.float() + ln_b.float()
    ok = ((torch.arange(Hp, device=x.device) < H)[:, None]
          & (torch.arange(Wp, device=x.device) < W)[None, :])
    y = (y * ok[None, :, :, None]).to(dt)
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    yw = window_partition(y, ws)
    qkv = (yw.float() @ wqkv.float().t() + bqkv.float()).to(dt)
    mask = None if region_ids is None else region_mask(region_ids)
    o = fused_window_attention_plain(qkv, rel_bias, mask, heads)
    po = o.float() @ wproj.float().t() + bproj.float()
    po = window_reverse(po, ws, Hp, Wp)
    if shift:
        po = torch.roll(po, (shift, shift), dims=(1, 2))
    if row_scale is not None:
        po = po * row_scale.float().reshape(B, 1, 1, 1)
    return (xf + po).to(dt)


def fused_swin_attn_block_bwd_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                                    rel_bias, region_ids, row_scale, dy, heads,
                                    ws, H, W, shift):
    """Plain K1 backward: autograd through `fused_swin_attn_block_plain`.
    Returns the gradients of (x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
    rel_bias), each in its input's dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in
                  (x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, rel_bias)]
        out = fused_swin_attn_block_plain(*leaves, region_ids, row_scale,
                                          heads, ws, H, W, shift)
        return torch.autograd.grad(out, leaves, dy.to(out.dtype))


def _check(x, heads, ws):
    B, Hp, Wp, C = x.shape
    N = ws * ws
    if C % heads or C // heads != 32:
        raise ValueError(f"K1 needs head dim 32, got C={C} heads={heads}")
    if C % 128 or Hp % ws or Wp % ws or N % 16 or N > 144:
        raise ValueError(
            f"K1 does not take C={C}, (Hp, Wp)=({Hp}, {Wp}), ws={ws}")
    if -(-B * Hp * Wp // 128) > 65535:
        raise ValueError(f"K1: {B * Hp * Wp} tokens exceed the launch grid")


def _region(region_ids, x, ws):
    if region_ids is None:
        return None
    Hp, Wp = x.shape[1:3]
    reg = region_ids.to(device=x.device, dtype=torch.int32).contiguous()
    return _cuda.require(reg, "region_ids", torch.int32,
                         ((Hp // ws) * (Wp // ws), ws * ws))


def _forward_cuda(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, rel_bias,
                  region_ids, row_scale, heads, ws, H, W, shift):
    B, Hp, Wp, C = x.shape
    N = ws * ws
    _check(x, heads, ws)
    M = B * Hp * Wp
    bf = torch.bfloat16
    _cuda.require(x, "x", bf)
    wqkv = _cuda.bf16(wqkv, "wqkv", (3 * C, C))
    wproj = _cuda.bf16(wproj, "wproj", (C, C))
    lw = _cuda.f32(ln_w, "ln_w", C)
    lb = _cuda.f32(ln_b, "ln_b", C)
    bq = _cuda.f32(bqkv, "bqkv", 3 * C)
    bp = _cuda.f32(bproj, "bproj", C)
    rb = _cuda.f32(rel_bias, "rel_bias", heads * N * N)
    rs = _cuda.f32(row_scale, "row_scale", B)
    reg = _region(region_ids, x, ws)
    stats = torch.empty((M, 2), dtype=torch.float32, device=x.device)
    qkv_buf = torch.empty((M, 3 * C), dtype=bf, device=x.device)
    o_buf = torch.empty((M, C), dtype=bf, device=x.device)
    out = torch.empty_like(x)
    rc = _cuda.lib().pw_swin_attn_block(
        x.data_ptr(), lw.data_ptr(), lb.data_ptr(), wqkv.data_ptr(),
        bq.data_ptr(), wproj.data_ptr(), bp.data_ptr(), rb.data_ptr(),
        _cuda.ptr(reg), _cuda.ptr(rs), stats.data_ptr(), qkv_buf.data_ptr(),
        o_buf.data_ptr(), out.data_ptr(), B, Hp, Wp, C, heads, ws, H, W, shift,
        float(32) ** -0.5, _cuda.stream_ptr(x.device))
    _cuda.check(rc, "fused_swin_attn_block")
    _cuda.launches["fused_swin_attn_block"] += 1
    return out


def fused_swin_attn_block_bwd(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                              rel_bias, region_ids, row_scale, dy, heads, ws,
                              H, W, shift):
    """K1b wrapper: gradients of (x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
    rel_bias) for the cotangent dy. The CUDA kernel chain on a CUDA tensor
    (dx in bf16, the rest in f32), else `fused_swin_attn_block_bwd_plain`."""
    if x.device.type == "cpu":
        return fused_swin_attn_block_bwd_plain(
            x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, rel_bias, region_ids,
            row_scale, dy, heads, ws, H, W, shift)
    B, Hp, Wp, C = x.shape
    N = ws * ws
    _check(x, heads, ws)
    M = B * Hp * Wp
    bf, f = torch.bfloat16, torch.float32
    dev = x.device
    _cuda.require(x, "x", bf)
    wqkv = _cuda.bf16(wqkv, "wqkv", (3 * C, C))
    wproj = _cuda.bf16(wproj, "wproj", (C, C))
    dy = _cuda.require(dy.to(bf).contiguous(), "dy", bf, x.shape)
    lw = _cuda.f32(ln_w, "ln_w", C)
    lb = _cuda.f32(ln_b, "ln_b", C)
    bq = _cuda.f32(bqkv, "bqkv", 3 * C)
    rb = _cuda.f32(rel_bias, "rel_bias", heads * N * N)
    rs = _cuda.f32(row_scale, "row_scale", B)
    reg = _region(region_ids, x, ws)
    lib = _cuda.lib()
    n_part = lib.pw_swin_attn_block_bwd_part_elems(B, Hp, Wp, C, heads, ws)
    dx = torch.empty_like(x)
    dln = torch.empty((2, C), dtype=f, device=dev)
    dwqkv = torch.empty((3 * C, C), dtype=f, device=dev)
    dbqkv = torch.empty((3 * C,), dtype=f, device=dev)
    dwproj = torch.empty((C, C), dtype=f, device=dev)
    dbproj = torch.empty((C,), dtype=f, device=dev)
    drel = torch.empty((heads, N, N), dtype=f, device=dev)
    qkv_buf = torch.empty((M, 3 * C), dtype=bf, device=dev)
    o_buf = torch.empty((M, C), dtype=bf, device=dev)
    dyb_buf = torch.empty((M, C), dtype=bf, device=dev)
    dqkv_buf = torch.empty((M, 3 * C), dtype=bf, device=dev)
    stats = torch.empty((M, 2), dtype=f, device=dev)
    part = torch.empty((n_part,), dtype=f, device=dev)
    rc = lib.pw_swin_attn_block_bwd(
        x.data_ptr(), lw.data_ptr(), lb.data_ptr(), wqkv.data_ptr(),
        bq.data_ptr(), wproj.data_ptr(), rb.data_ptr(), _cuda.ptr(reg),
        _cuda.ptr(rs), dy.data_ptr(), dx.data_ptr(), dln.data_ptr(),
        dwqkv.data_ptr(), dbqkv.data_ptr(), dwproj.data_ptr(),
        dbproj.data_ptr(), drel.data_ptr(), qkv_buf.data_ptr(),
        o_buf.data_ptr(), dyb_buf.data_ptr(), dqkv_buf.data_ptr(),
        stats.data_ptr(), part.data_ptr(), B, Hp, Wp, C, heads, ws, H, W,
        shift, float(32) ** -0.5, _cuda.stream_ptr(dev))
    _cuda.check(rc, "fused_swin_attn_block_bwd")
    _cuda.launches["fused_swin_attn_block_bwd"] += 1
    return dx, dln[0], dln[1], dwqkv, dbqkv, dwproj, dbproj, drel


class _AttnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, rel_bias,
                region_ids, row_scale, heads, ws, H, W, shift):
        ctx.save_for_backward(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                              rel_bias, region_ids, row_scale)
        ctx.geom = (heads, ws, H, W, shift)
        fwd = (fused_swin_attn_block_plain if x.device.type == "cpu"
               else _forward_cuda)
        return fwd(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, rel_bias,
                   region_ids, row_scale, heads, ws, H, W, shift)

    @staticmethod
    def backward(ctx, dy):
        grads = fused_swin_attn_block_bwd(*ctx.saved_tensors, dy, *ctx.geom)
        return tuple(grads) + (None,) * 7


def fused_swin_attn_block(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, rel_bias,
                          region_ids, row_scale, heads, ws, H, W, shift):
    """K1 wrapper, differentiable: the CUDA kernel chains on a CUDA tensor,
    else the plain version. Arguments as in `fused_swin_attn_block_plain`."""
    return _AttnBlock.apply(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, rel_bias,
                            region_ids, row_scale, heads, ws, H, W, shift)
