"""K2: the Swin MLP half-block, out = x + rs * (fc2(GELU(fc1(LN2(x)))) + b2).

Counterpart of `preworld_tpu/ops/swin_mlp_pallas.py` (same module name;
nothing here is Pallas). On a CUDA tensor `fused_swin_mlp` launches the
hand-written kernels in `csrc/swin_mlp.cu`; on a CPU tensor it runs
`fused_swin_mlp_plain`. GELU is the exact erf form.
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


def fused_swin_mlp(x, ln_w, ln_b, w1, b1, w2, b2, row_scale=None):
    """K2 wrapper: the CUDA kernels on a CUDA tensor, else the plain version."""
    if x.device.type == "cpu":
        return fused_swin_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2, row_scale)
    C = x.shape[-1]
    Hd = w1.shape[0]
    M = x.numel() // C
    if C % 128 or Hd % 128:
        raise ValueError(f"K2 does not take C={C}, hidden={Hd}")
    if -(-M // 128) > 65535:
        raise ValueError(f"K2: {M} rows exceed the launch grid")
    bf = torch.bfloat16
    _cuda.require(x, "x", bf)
    _cuda.require(w1, "w1", bf, (Hd, C))
    _cuda.require(w2, "w2", bf, (C, Hd))
    lw = _cuda.f32(ln_w, "ln_w", C)
    lb = _cuda.f32(ln_b, "ln_b", C)
    c1 = _cuda.f32(b1, "b1", Hd)
    c2 = _cuda.f32(b2, "b2", C)
    rs = _cuda.f32(row_scale, "row_scale", M)
    hidden = torch.empty((M, Hd), dtype=bf, device=x.device)
    out = torch.empty_like(x)
    rc = _cuda.lib().pw_swin_mlp(
        x.data_ptr(), lw.data_ptr(), lb.data_ptr(), w1.data_ptr(),
        c1.data_ptr(), w2.data_ptr(), c2.data_ptr(), _cuda.ptr(rs),
        hidden.data_ptr(), out.data_ptr(), M, C, Hd,
        _cuda.stream_ptr(x.device))
    _cuda.check(rc, "fused_swin_mlp")
    _cuda.launches["fused_swin_mlp"] += 1
    return out
