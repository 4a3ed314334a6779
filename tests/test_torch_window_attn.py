"""K5 / K6 window attention and their backward passes K5b / K6b: the port's
plain versions (what the wrappers run on CPU tensors) against the Pallas
kernels of `preworld_tpu/ops/window_attn_pallas.py` in interpret mode, on
the same numpy inputs (f32): values at 1e-5, dqkv and dbias at 2e-5.

Cases as in tests/test_ops.py's TestFusedWindowAttention: unmasked, masked
with a random 0 / -100 mask, and an odd window count; the band kernel at
H 8, W 12, ws 4 (an odd trailing window per band row). The autograd
Functions give the backward functions' gradients, and on a tensor that is
not on the CPU the wrappers go to the kernel's checks, never to the plain
version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preworld_tpu.models import swin as jax_swin
from preworld_tpu.ops.window_attn_pallas import (
    _band_window_attention_bwd as jax_band_bwd,
)
from preworld_tpu.ops.window_attn_pallas import (
    _fused_window_attention_bwd as jax_fused_bwd,
)
from preworld_tpu.ops.window_attn_pallas import (
    band_window_attention as jax_band,
)
from preworld_tpu.ops.window_attn_pallas import (
    fused_window_attention as jax_fused,
)
from preworld_tpu_torch.models import swin as torch_swin
from preworld_tpu_torch.ops import window_attn_pallas as wa

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _inputs(seed, lead, N, h, d, nW, masked):
    rng = np.random.default_rng(seed)
    C = h * d
    qkv = rng.normal(size=lead + (3 * C,)).astype(np.float32)
    bias = rng.normal(size=(h, N, N)).astype(np.float32)
    mask = (np.where(rng.random((nW, N, N)) > 0.7, -100.0, 0.0)
            .astype(np.float32) if masked else None)
    dout = rng.normal(size=lead + (C,)).astype(np.float32)
    return qkv, bias, mask, dout


PACKED = {"unmasked": dict(masked=False, Bn=6, nW=3),
          "masked": dict(masked=True, Bn=6, nW=3),
          "odd_window_count": dict(masked=True, Bn=9, nW=9)}


@pytest.mark.parametrize("case", list(PACKED))
def test_fused_window_attention_matches_pallas(case):
    """K5 and K5b: N 16, 4 heads of 8 (test_ops.py's shapes)."""
    c = PACKED[case]
    h, N = 4, 16
    qkv, bias, mask, dout = _inputs(3, (c["Bn"], N), N, h, 8, c["nW"],
                                    c["masked"])
    want = np.asarray(jax_fused(_j(qkv), _j(bias), _j(mask), h, window_g=4,
                                interpret=True))
    got = wa.fused_window_attention(_t(qkv), _t(bias), _opt(mask), h)
    np.testing.assert_allclose(got.numpy(), want, **VAL)

    jdq, jdb = jax_fused_bwd(_j(qkv), _j(bias), _j(mask), _j(dout), h,
                             window_g=4, interpret=True)
    dq, db = wa.fused_window_attention_bwd(_t(qkv), _t(bias), _opt(mask),
                                           _t(dout), h)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), **GRAD)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), **GRAD)


def _opt(a):
    return None if a is None else _t(a)


@pytest.mark.parametrize("masked", [False, True])
def test_band_window_attention_matches_pallas(masked):
    """K6 and K6b on the image layout: B 2, H 8, W 12, ws 4 (nH 2, nW 3),
    2 heads of 32; the mask per window of the image, row-major."""
    h, d, ws, B, Hp, Wp = 2, 32, 4, 2, 8, 12
    N = ws * ws
    nwin = (Hp // ws) * (Wp // ws)
    qkv, bias, mask, dout = _inputs(5, (B, Hp, Wp), N, h, d, nwin, masked)
    want = np.asarray(jax_band(_j(qkv), _j(bias), _j(mask), h, ws,
                               interpret=True))
    got = wa.band_window_attention(_t(qkv), _t(bias), _opt(mask), h, ws)
    np.testing.assert_allclose(got.numpy(), want, **VAL)

    jdq, jdb = jax_band_bwd(_j(qkv), _j(bias), _j(mask), _j(dout), h, ws,
                            interpret=True)
    dq, db = wa.band_window_attention_bwd(_t(qkv), _t(bias), _opt(mask),
                                          _t(dout), h, ws)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), **GRAD)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), **GRAD)


@pytest.mark.parametrize("band", [False, True])
def test_backward_at_the_flagship_window(band):
    """K5b and K6b at the flagship window 12 (N 144, the window the card's
    backward splits into nine 16-row strips): one 24x24 image (2x2
    windows), 2 heads of 32, the SW-MSA mask of shift 6 from the JAX
    `shifted_window_mask` and from the port's own copy."""
    h, d, ws, Hp, Wp = 2, 32, 12, 24, 24
    N = ws * ws
    jmask = np.asarray(jax_swin.shifted_window_mask(Hp, Wp, ws, ws // 2))
    mask = torch_swin.shifted_window_mask(Hp, Wp, ws, ws // 2)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    qkv, bias, _, dout = _inputs(11, (1, Hp, Wp), N, h, d, 4, False)
    if band:
        jdq, jdb = jax_band_bwd(_j(qkv), _j(bias), _j(jmask), _j(dout), h,
                                ws, interpret=True)
        dq, db = wa.band_window_attention_bwd(_t(qkv), _t(bias), mask,
                                              _t(dout), h, ws)
    else:
        qkv = qkv.reshape(2, ws, 2, ws, 3 * h * d).transpose(0, 2, 1, 3, 4)
        qkv = qkv.reshape(4, N, 3 * h * d)
        dout = dout.reshape(4, N, h * d)
        jdq, jdb = jax_fused_bwd(_j(qkv), _j(bias), _j(jmask), _j(dout), h,
                                 window_g=2, interpret=True)
        dq, db = wa.fused_window_attention_bwd(_t(qkv), _t(bias), mask,
                                               _t(dout), h)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), **GRAD)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), **GRAD)


@pytest.mark.parametrize("band", [False, True])
def test_vjp_functions_give_the_backward(band):
    """The autograd Functions' gradients are the backward functions'
    outputs; the mask gets none."""
    h, ws = 2, 4
    N = ws * ws
    lead = (2, 8, 12) if band else (6, N)
    qkv, bias, mask, dout = _inputs(7, lead, N, h, 32, 6 if band else 3,
                                    True)
    q, b = _t(qkv).requires_grad_(True), _t(bias).requires_grad_(True)
    m = _t(mask)
    if band:
        out = wa.band_window_attention_vjp(q, b, m, h, ws)
        want = wa.band_window_attention_bwd(_t(qkv), _t(bias), m, _t(dout),
                                            h, ws)
    else:
        out = wa.fused_window_attention_vjp(q, b, m, h)
        want = wa.fused_window_attention_bwd(_t(qkv), _t(bias), m, _t(dout),
                                             h)
    got = torch.autograd.grad(out, (q, b), _t(dout))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("shape,heads,match", [
    ((4, 16, 3 * 64), 4, "head dim 32"),   # d = 16
    ((4, 49, 3 * 64), 2, "49 tokens"),     # N % 16 != 0
    ((4, 16, 3 * 64), 2, "CUDA tensor"),   # a shape K5 takes
])
def test_wrappers_never_fall_back_off_the_cpu(shape, heads, match):
    """A tensor that is not on the CPU goes to the kernel's checks (here
    on the meta device, which no kernel takes): the wrapper raises and
    never runs the plain version."""
    qkv = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    N = shape[1]
    bias = torch.zeros((heads, N, N))
    with pytest.raises(ValueError, match=match):
        wa.fused_window_attention(qkv, bias, None, heads)
    with pytest.raises(ValueError, match=match):
        wa.fused_window_attention_bwd(qkv, bias, None, qkv[..., :shape[2] // 3],
                                      heads)
