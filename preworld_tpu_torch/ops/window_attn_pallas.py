"""K5 / K6: window multi-head self-attention on a precomputed qkv, and
their backward passes K5b / K6b.

Counterpart of `preworld_tpu/ops/window_attn_pallas.py` (same module name;
nothing here is Pallas), with the JAX interface:

    out = softmax(q k^T d^-1/2 + bias + mask) v    per window and head

  * `fused_window_attention` (K5): packed windows, qkv (Bn, N, 3C) with
    channels [q heads | k heads | v heads], q unscaled -> (Bn, N, C);
    window i takes mask[i % nW];
  * `band_window_attention` (K6): the padded image layout, qkv
    (B, Hp, Wp, 3C) already rolled (the caller rolls) -> (B, Hp, Wp, C);
    windows row-major, mask (nH*nW, N, N);
  * bias (heads, N, N), the relative-position bias; mask an additive
    (nW, N, N) f32 mask or None.

`*_bwd` return (dqkv in qkv's layout, dbias (heads, N, N) f32) for the
cotangent dout; the `*_vjp` functions are differentiable in qkv and bias
(autograd Functions saving only their inputs, as the JAX custom VJPs do);
the mask gets no gradient. On a CUDA tensor the wrappers launch
`csrc/window_attn.cu` / `csrc/window_attn_bwd.cu` (bf16 qkv, head dim 32,
N % 16 == 0, N <= 144) or raise; on a CPU tensor they run the plain
versions, the backward as autograd through the plain forward. `window_g`
(the TPU kernel's windows per grid step) is accepted and ignored.
"""

from __future__ import annotations

import torch

from . import _cuda

_HEAD_DIM = 32  # the one head dim the kernels are built for
_MAX_N = 144  # tokens per window, at most


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, K) -> (B*nH*nW, ws*ws, K), windows row-major per image."""
    B, H, W, K = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, K).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, K)


def window_reverse(wins: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """Inverse of window_partition."""
    K = wins.shape[-1]
    B = wins.shape[0] // ((H // ws) * (W // ws))
    x = wins.reshape(B, H // ws, W // ws, ws, ws, K).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, K)


def fused_window_attention_plain(qkv, bias, mask, heads, window_g=8):
    """Plain K5, rounding where the kernel rounds: scores, softmax and the
    output sums in f32, the probabilities and the output in qkv.dtype.
    Also the window attention of K1's plain version and of the Swin's
    plain route."""
    Bn, N, C3 = qkv.shape
    C = C3 // 3
    d = C // heads
    dt = qkv.dtype
    q, k, v = qkv.reshape(Bn, N, 3, heads, d).permute(2, 0, 3, 1, 4)
    s = (q.float() @ k.float().transpose(-1, -2)) * float(d) ** -0.5
    s = s + bias.float()[None]
    if mask is not None:
        idx = torch.arange(Bn, device=qkv.device) % mask.shape[0]
        s = s + mask.float()[idx][:, None]
    p = torch.softmax(s, dim=-1).to(dt)
    o = (p.float() @ v.float()).to(dt)
    return o.permute(0, 2, 1, 3).reshape(Bn, N, C)


def band_window_attention_plain(qkv, bias, mask, heads, ws):
    """Plain K6: K5's maths on the windows of the image layout."""
    Hp, Wp = qkv.shape[1:3]
    out = fused_window_attention_plain(window_partition(qkv, ws), bias, mask,
                                       heads)
    return window_reverse(out, ws, Hp, Wp)


def _grads(fn, qkv, bias, dout):
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (qkv, bias)]
        out = fn(*leaves)
        return torch.autograd.grad(out, leaves, dout.to(out.dtype))


def fused_window_attention_bwd_plain(qkv, bias, mask, dout, heads, window_g=8):
    """Plain K5b: autograd through `fused_window_attention_plain`."""
    return _grads(lambda q, b: fused_window_attention_plain(q, b, mask, heads),
                  qkv, bias, dout)


def band_window_attention_bwd_plain(qkv, bias, mask, dout, heads, ws):
    """Plain K6b: autograd through `band_window_attention_plain`."""
    return _grads(lambda q, b: band_window_attention_plain(q, b, mask, heads, ws),
                  qkv, bias, dout)


def fused_window_attention_flops(Bn: int, N: int, C: int) -> int:
    """What `torch.utils.flop_counter` counts for
    `fused_window_attention_plain` on Bn windows of N tokens and C
    channels a q, k or v: QK^T and PV, 2 Bn N N C each whatever the heads
    (2 FLOPs a multiply-add; the scale, bias, mask and softmax count 0)."""
    return 2 * Bn * N * N * C * 2


def band_window_attention_flops(B: int, Hp: int, Wp: int, C: int,
                                ws: int) -> int:
    """K5's count on the B (Hp / ws) (Wp / ws) windows of the image layout."""
    return fused_window_attention_flops(B * (Hp // ws) * (Wp // ws), ws * ws,
                                        C)


def fused_window_attention_bwd_flops(Bn: int, N: int, C: int) -> int:
    """What `torch.utils.flop_counter` counts for
    `fused_window_attention_bwd_plain` at these shapes: the forward it
    reruns, and QK^T and PV twice more each (the gradients of both
    operands)."""
    return 3 * fused_window_attention_flops(Bn, N, C)


def band_window_attention_bwd_flops(B: int, Hp: int, Wp: int, C: int,
                                    ws: int) -> int:
    """K5b's count on the B (Hp / ws) (Wp / ws) windows of the image
    layout."""
    return 3 * band_window_attention_flops(B, Hp, Wp, C, ws)


def fused_window_attention_bytes(qkv, bias, mask, heads, window_g=8):
    """The bytes `fused_window_attention` counts as one kernel call: its
    operands as passed and its (Bn, N, C) result in qkv's dtype."""
    Bn, N, C3 = qkv.shape
    return (_cuda.operand_bytes(qkv, bias, mask)
            + _cuda.result_bytes((Bn, N, C3 // 3), qkv.dtype))


def band_window_attention_bytes(qkv, bias, mask, heads, ws):
    """The bytes `band_window_attention` counts as one kernel call: its
    operands as passed and its (B, Hp, Wp, C) result in qkv's dtype."""
    B, Hp, Wp, C3 = qkv.shape
    return (_cuda.operand_bytes(qkv, bias, mask)
            + _cuda.result_bytes((B, Hp, Wp, C3 // 3), qkv.dtype))


def fused_window_attention_transcendentals(qkv, bias, mask, heads,
                                           window_g=8):
    """What `utils/flops.py` counts as transcendentals for
    `fused_window_attention_plain`: one softmax exp a score, Bn heads N^2."""
    Bn, N = qkv.shape[:2]
    return Bn * heads * N * N


def band_window_attention_transcendentals(qkv, bias, mask, heads, ws):
    """K5's count on the windows of the image layout: B Hp Wp heads ws^2."""
    B, Hp, Wp = qkv.shape[:3]
    return B * Hp * Wp * heads * ws * ws


def _check(qkv, heads, N, name):
    C3 = qkv.shape[-1]
    if C3 % 3 or (C3 // 3) % heads or C3 // 3 // heads != _HEAD_DIM:
        raise ValueError(f"{name} needs head dim {_HEAD_DIM}, got C={C3 // 3} "
                         f"heads={heads}")
    if N % 16 or N > _MAX_N:
        raise ValueError(f"{name} does not take windows of {N} tokens")
    _cuda.require(qkv, "qkv", torch.bfloat16)


def _operands(qkv, bias, mask, heads, N, name):
    """bias as contiguous f32 (heads*N*N,), mask as contiguous f32 (nW, N, N)
    on qkv's device, or None; the kernels read the mask in 8-byte pairs,
    so a view that starts off a 16-byte boundary is copied."""
    rb = _cuda.f32(bias, "bias", heads * N * N)
    if mask is None:
        return rb, None
    m = mask.to(device=qkv.device, dtype=torch.float32).contiguous()
    if m.dim() != 3 or tuple(m.shape[1:]) != (N, N):
        raise ValueError(f"{name}: mask of shape {tuple(m.shape)}, expected "
                         f"(nW, {N}, {N})")
    return rb, m if m.data_ptr() % 16 == 0 else m.clone()


@_cuda.counted("fused_window_attention", fused_window_attention_bytes,
               fused_window_attention_transcendentals)
def fused_window_attention(qkv, bias, mask, heads, window_g=8):
    """K5 forward: the CUDA kernel on a CUDA tensor, else the plain one."""
    if qkv.device.type == "cpu":
        return fused_window_attention_plain(qkv, bias, mask, heads)
    Bn, N, C = qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3
    _check(qkv, heads, N, "K5")
    rb, m = _operands(qkv, bias, mask, heads, N, "K5")
    out = torch.empty((Bn, N, C), dtype=qkv.dtype, device=qkv.device)
    rc = _cuda.lib().pw_window_attn_packed(
        qkv.data_ptr(), rb.data_ptr(), _cuda.ptr(m), out.data_ptr(), Bn, N,
        1 if m is None else m.shape[0], C, heads, float(_HEAD_DIM) ** -0.5,
        _cuda.stream_ptr(qkv.device))
    _cuda.check(rc, "fused_window_attention")
    _cuda.launches["fused_window_attention"] += 1
    _cuda.flops["fused_window_attention"] += fused_window_attention_flops(
        Bn, N, C)
    return out


def _band_geometry(qkv, ws):
    B, Hp, Wp, C3 = qkv.shape
    if Hp % ws or Wp % ws:
        raise ValueError(f"K6: ({Hp}, {Wp}) is not a multiple of window {ws}")
    return B, Hp, Wp, C3 // 3


@_cuda.counted("band_window_attention", band_window_attention_bytes,
               band_window_attention_transcendentals)
def band_window_attention(qkv, bias, mask, heads, ws):
    """K6 forward: the CUDA kernel on a CUDA tensor, else the plain one."""
    if qkv.device.type == "cpu":
        return band_window_attention_plain(qkv, bias, mask, heads, ws)
    B, Hp, Wp, C = _band_geometry(qkv, ws)
    N = ws * ws
    _check(qkv, heads, N, "K6")
    rb, m = _operands(qkv, bias, mask, heads, N, "K6")
    if m is not None and m.shape[0] != (Hp // ws) * (Wp // ws):
        raise ValueError(f"K6: mask for {m.shape[0]} windows, the image has "
                         f"{(Hp // ws) * (Wp // ws)}")
    out = torch.empty((B, Hp, Wp, C), dtype=qkv.dtype, device=qkv.device)
    rc = _cuda.lib().pw_window_attn_band(
        qkv.data_ptr(), rb.data_ptr(), _cuda.ptr(m), out.data_ptr(), B, Hp,
        Wp, ws, C, heads, float(_HEAD_DIM) ** -0.5,
        _cuda.stream_ptr(qkv.device))
    _cuda.check(rc, "band_window_attention")
    _cuda.launches["band_window_attention"] += 1
    _cuda.flops["band_window_attention"] += band_window_attention_flops(
        B, Hp, Wp, C, ws)
    return out


def _bwd_buffers(qkv, dout, heads, windows, N):
    """The backward's operands and outputs: dout as bf16, dqkv, drel and the
    d-bias scratch."""
    dev = qkv.device
    dout = _cuda.require(dout.to(torch.bfloat16).contiguous(), "dout",
                         torch.bfloat16, qkv.shape[:-1] + (qkv.shape[-1] // 3,))
    n_part = _cuda.lib().pw_window_attn_bwd_part_elems(windows, heads, N)
    return (dout, torch.empty_like(qkv),
            torch.empty((heads, N, N), dtype=torch.float32, device=dev),
            torch.empty((n_part,), dtype=torch.float32, device=dev))


def fused_window_attention_bwd(qkv, bias, mask, dout, heads, window_g=8):
    """K5b: (dqkv (Bn, N, 3C), dbias (heads, N, N) f32). The CUDA kernel
    on a CUDA tensor, else `fused_window_attention_bwd_plain`."""
    if qkv.device.type == "cpu":
        return fused_window_attention_bwd_plain(qkv, bias, mask, dout, heads)
    Bn, N, C = qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3
    _check(qkv, heads, N, "K5b")
    rb, m = _operands(qkv, bias, mask, heads, N, "K5b")
    dout, dqkv, drel, part = _bwd_buffers(qkv, dout, heads, Bn, N)
    rc = _cuda.lib().pw_window_attn_packed_bwd(
        qkv.data_ptr(), rb.data_ptr(), _cuda.ptr(m), dout.data_ptr(),
        dqkv.data_ptr(), drel.data_ptr(), part.data_ptr(), Bn, N,
        1 if m is None else m.shape[0], C, heads, float(_HEAD_DIM) ** -0.5,
        _cuda.stream_ptr(qkv.device))
    _cuda.check(rc, "fused_window_attention_bwd")
    _cuda.launches["fused_window_attention_bwd"] += 1
    _cuda.flops["fused_window_attention_bwd"] += \
        fused_window_attention_bwd_flops(Bn, N, C)
    return dqkv, drel


def band_window_attention_bwd(qkv, bias, mask, dout, heads, ws):
    """K6b: (dqkv (B, Hp, Wp, 3C), dbias (heads, N, N) f32). The CUDA
    kernel on a CUDA tensor, else `band_window_attention_bwd_plain`."""
    if qkv.device.type == "cpu":
        return band_window_attention_bwd_plain(qkv, bias, mask, dout, heads,
                                               ws)
    B, Hp, Wp, C = _band_geometry(qkv, ws)
    N = ws * ws
    _check(qkv, heads, N, "K6b")
    rb, m = _operands(qkv, bias, mask, heads, N, "K6b")
    windows = B * (Hp // ws) * (Wp // ws)
    dout, dqkv, drel, part = _bwd_buffers(qkv, dout, heads, windows, N)
    rc = _cuda.lib().pw_window_attn_band_bwd(
        qkv.data_ptr(), rb.data_ptr(), _cuda.ptr(m), dout.data_ptr(),
        dqkv.data_ptr(), drel.data_ptr(), part.data_ptr(), B, Hp, Wp, ws, C,
        heads, float(_HEAD_DIM) ** -0.5, _cuda.stream_ptr(qkv.device))
    _cuda.check(rc, "band_window_attention_bwd")
    _cuda.launches["band_window_attention_bwd"] += 1
    _cuda.flops["band_window_attention_bwd"] += \
        band_window_attention_bwd_flops(B, Hp, Wp, C, ws)
    return dqkv, drel


class _FusedWindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, mask, heads):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.heads = heads
        return fused_window_attention(qkv, bias, mask, heads)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = fused_window_attention_bwd(qkv, bias, mask, dout,
                                                 ctx.heads)
        return dqkv, dbias.to(bias.dtype), None, None


class _BandWindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, mask, heads, ws):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.geom = (heads, ws)
        return band_window_attention(qkv, bias, mask, heads, ws)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = band_window_attention_bwd(qkv, bias, mask, dout,
                                                *ctx.geom)
        return dqkv, dbias.to(bias.dtype), None, None, None


def fused_window_attention_vjp(qkv, bias, mask, heads, window_g=8):
    """K5, differentiable in qkv and bias (K5b in the backward)."""
    return _FusedWindowAttention.apply(qkv, bias, mask, heads)


def band_window_attention_vjp(qkv, bias, mask, heads, ws):
    """K6, differentiable in qkv and bias (K6b in the backward)."""
    return _BandWindowAttention.apply(qkv, bias, mask, heads, ws)
