"""K1: the Swin attention half-block on the padded (B, Hp, Wp, C) layout.

Counterpart of `preworld_tpu/ops/swin_block_pallas.py` (the module keeps
its name so the two are easy to pair; nothing here is Pallas):

    out = x + row_scale * proj(WMSA(zeropad(LN1(x))))

`x` and `out` are in image order; a shifted block attends over the layout
rolled by (-shift, -shift), which the kernel reaches through its indexing
(the JAX kernel takes x pre-rolled and the caller rolls around it). Pad
tokens are zeroed after LN1, as in the reference "zero-pad after norm1"
semantics. On a CUDA tensor `fused_swin_attn_block` launches the
hand-written kernel chain in `csrc/swin_block.cu` (LN1+qkv product, window
attention, proj product with residual epilogue); on a CPU tensor it runs
`fused_swin_attn_block_plain`.

The shift mask enters as the (nH*nW, N) region-id table of
`models.swin.shifted_window_region_ids`: two tokens of a window may attend
to each other (mask 0) iff their ids agree, else the mask is -100.
"""

from __future__ import annotations

import torch

from . import _cuda


def region_mask(region_ids: torch.Tensor) -> torch.Tensor:
    """(nW, N) region ids -> (nW, N, N) additive mask of 0 / -100."""
    ids = region_ids
    return torch.where(ids[:, None, :] != ids[:, :, None],
                       torch.tensor(-100.0, device=ids.device),
                       torch.tensor(0.0, device=ids.device))


def _windows(t, ws):
    """(B, Hp, Wp, K) -> (B*nH*nW, N, K), windows row-major per image."""
    B, Hp, Wp, K = t.shape
    t = t.reshape(B, Hp // ws, ws, Wp // ws, ws, K).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(-1, ws * ws, K)


def _unwindows(t, ws, B, Hp, Wp):
    K = t.shape[-1]
    t = t.reshape(B, Hp // ws, Wp // ws, ws, ws, K).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(B, Hp, Wp, K)


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
    d = C // heads
    N = ws * ws
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
    yw = _windows(y, ws)
    Bw = yw.shape[0]
    qkv = (yw.float() @ wqkv.float().t() + bqkv.float()).to(dt)
    q, k, v = qkv.reshape(Bw, N, 3, heads, d).permute(2, 0, 3, 1, 4)
    s = (q.float() @ k.float().transpose(-1, -2)) * (float(d) ** -0.5)
    if region_ids is not None:
        m = region_mask(region_ids)
        s = (s.reshape(B, -1, heads, N, N) + m[None, :, None]).reshape(
            Bw, heads, N, N)
    s = s + rel_bias.float()[None]
    p = torch.softmax(s, dim=-1).to(dt)
    o = (p.float() @ v.float()).to(dt)
    o = o.permute(0, 2, 1, 3).reshape(Bw, N, C)
    po = o.float() @ wproj.float().t() + bproj.float()
    po = _unwindows(po, ws, B, Hp, Wp)
    if shift:
        po = torch.roll(po, (shift, shift), dims=(1, 2))
    if row_scale is not None:
        po = po * row_scale.float().reshape(B, 1, 1, 1)
    return (xf + po).to(dt)


def fused_swin_attn_block(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, rel_bias,
                          region_ids, row_scale, heads, ws, H, W, shift):
    """K1 wrapper: the CUDA kernel chain on a CUDA tensor, else the plain
    version. Arguments as in `fused_swin_attn_block_plain`."""
    if x.device.type == "cpu":
        return fused_swin_attn_block_plain(
            x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, rel_bias, region_ids,
            row_scale, heads, ws, H, W, shift)
    B, Hp, Wp, C = x.shape
    N = ws * ws
    if C % heads or C // heads != 32:
        raise ValueError(f"K1 needs head dim 32, got C={C} heads={heads}")
    if C % 128 or Hp % ws or Wp % ws or N % 16 or N > 144:
        raise ValueError(
            f"K1 does not take C={C}, (Hp, Wp)=({Hp}, {Wp}), ws={ws}")
    M = B * Hp * Wp
    if -(-M // 128) > 65535:
        raise ValueError(f"K1: {M} tokens exceed the launch grid")
    bf = torch.bfloat16
    _cuda.require(x, "x", bf)
    _cuda.require(wqkv, "wqkv", bf, (3 * C, C))
    _cuda.require(wproj, "wproj", bf, (C, C))
    lw = _cuda.f32(ln_w, "ln_w", C)
    lb = _cuda.f32(ln_b, "ln_b", C)
    bq = _cuda.f32(bqkv, "bqkv", 3 * C)
    bp = _cuda.f32(bproj, "bproj", C)
    rb = _cuda.f32(rel_bias, "rel_bias", heads * N * N)
    rs = _cuda.f32(row_scale, "row_scale", B)
    reg = None
    if region_ids is not None:
        reg = region_ids.to(device=x.device, dtype=torch.int32).contiguous()
        _cuda.require(reg, "region_ids", torch.int32,
                      ((Hp // ws) * (Wp // ws), N))
    qkv_buf = torch.empty((M, 3 * C), dtype=bf, device=x.device)
    o_buf = torch.empty((M, C), dtype=bf, device=x.device)
    out = torch.empty_like(x)
    rc = _cuda.lib().pw_swin_attn_block(
        x.data_ptr(), lw.data_ptr(), lb.data_ptr(), wqkv.data_ptr(),
        bq.data_ptr(), wproj.data_ptr(), bp.data_ptr(), rb.data_ptr(),
        _cuda.ptr(reg), _cuda.ptr(rs), qkv_buf.data_ptr(), o_buf.data_ptr(),
        out.data_ptr(), B, Hp, Wp, C, heads, ws, H, W, shift,
        float(32) ** -0.5, _cuda.stream_ptr(x.device))
    _cuda.check(rc, "fused_swin_attn_block")
    _cuda.launches["fused_swin_attn_block"] += 1
    return out
