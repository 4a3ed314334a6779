"""Gradient parity of the port's differentiable kernel wrappers against the
JAX package's custom VJPs (CPU, f32).

K1 (`fused_swin_attn_block`) and K2 (`fused_swin_mlp`) are autograd
Functions whose backward, on CPU tensors, is autograd through the plain
forward; they are held against `fused_swin_attn_block_vjp` /
`fused_swin_mlp_vjp` with the Pallas backward kernels in interpret mode, at
the shapes of TestFusedSwinAttnBlock and TestFusedSwinMlp
(tests/test_ops.py): pad filled with garbage 37.0, shifted and unshifted,
with and without a drop-path row scale. Tolerance rtol = atol = 5e-5 (f32,
only the summation order differs). K4 (`bev_pool_fused`) against the JAX
`bev_pool_fused` VJP at rtol 1e-4, atol 1e-5 (TestBevPoolPallas's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preworld_tpu.geometry.frustum import frustum_pixel_indices
from preworld_tpu.models.swin import shifted_window_mask
from preworld_tpu.ops.bev_pool_pallas import bev_pool_fused as jax_bev_pool_fused
from preworld_tpu.ops.swin_block_pallas import fused_swin_attn_block_vjp
from preworld_tpu.ops.swin_mlp_pallas import fused_swin_mlp_vjp
from preworld_tpu_torch.models.swin import (
    WindowMSA,
    relative_position_index,
    shifted_window_region_ids,
)
from preworld_tpu_torch.ops import (
    bev_pool_fused,
    fused_swin_attn_block,
    fused_swin_mlp,
)

TOL = dict(rtol=5e-5, atol=5e-5)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


@pytest.mark.parametrize("shifted,drop,C", [
    pytest.param(False, False, 128, id="False-False"),
    pytest.param(True, False, 128, id="True-False"),
    pytest.param(True, True, 128, id="True-True"),
    pytest.param(False, False, 256, id="c256-shift0"),
    pytest.param(True, False, 256, id="c256-shift2")])
def test_attn_block_grads_match_jax_vjp(shifted, drop, C):
    """B 2, H 7, W 10 (padded 8 x 12), C 128, 4 heads, ws 4. The JAX
    kernel takes x and the cotangent pre-rolled by -shift; the port works
    in image order. Every input gradient, the bias one as (heads, N, N).
    C 256 (8 heads; B 1, 3 x 7 real tokens padded to 4 x 8, 32 rows): the
    card's backward products then tile the weight gradients 128 x 256 and
    take a row count short of one 64-row box."""
    if C == 128:
        rng = np.random.default_rng(3)
        B, H, W, heads, ws = 2, 7, 10, 4, 4
    else:
        rng = np.random.default_rng(6)
        B, H, W, heads, ws = 1, 3, 7, 8, 4
    N = ws * ws
    Hp, Wp = H + (-H) % ws, W + (-W) % ws
    shift = ws // 2 if shifted else 0
    x = np.full((B, Hp, Wp, C), 37.0, np.float32)
    x[:, :H, :W] = rng.normal(size=(B, H, W, C))
    ct = rng.normal(size=(B, Hp, Wp, C)).astype(np.float32)
    ln_w = rng.normal(1.0, 0.1, C).astype(np.float32)
    ln_b = rng.normal(0.0, 0.1, C).astype(np.float32)
    wqkv = (rng.normal(size=(C, 3 * C)) * C ** -0.5).astype(np.float32)
    bqkv = rng.normal(0.0, 0.1, 3 * C).astype(np.float32)
    wproj = (rng.normal(size=(C, C)) * C ** -0.5).astype(np.float32)
    bproj = rng.normal(0.0, 0.1, C).astype(np.float32)
    table = rng.normal(0.0, 0.5, ((2 * ws - 1) ** 2, heads)).astype(np.float32)
    bias = table[relative_position_index(ws).reshape(-1)].reshape(
        N, N, heads).transpose(2, 0, 1).copy()
    rs = np.array([0.0, 1.25], np.float32) if drop else None
    mask = shifted_window_mask(Hp, Wp, ws, shift) if shift else None

    def roll(a, s):
        return np.roll(a, (s, s), axis=(1, 2))

    def loss(x_, *p):
        out = fused_swin_attn_block_vjp(
            x_, *p, mask, None if rs is None else jnp.asarray(rs), heads, ws,
            H, W, shift, True)
        return (out * jnp.asarray(roll(ct, -shift))).sum()

    jargs = [jnp.asarray(a) for a in (roll(x, -shift), ln_w, ln_b, wqkv, bqkv,
                                      wproj, bproj, bias)]
    want = jax.jit(jax.grad(loss, argnums=tuple(range(8))))(*jargs)
    want = [np.asarray(w) for w in want]
    want[0] = roll(want[0], shift)
    want[3], want[5] = want[3].T, want[5].T

    region = (_t(shifted_window_region_ids(Hp, Wp, ws, shift).astype(np.int32))
              if shift else None)
    leaves = [_t(a, True) for a in (x, ln_w, ln_b, wqkv.T, bqkv, wproj.T,
                                    bproj, bias)]
    out = fused_swin_attn_block(*leaves, region,
                                None if rs is None else _t(rs), heads, ws, H,
                                W, shift)
    got = torch.autograd.grad(out, leaves, _t(ct))
    names = ("x", "ln_w", "ln_b", "wqkv", "bqkv", "wproj", "bproj", "bias")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


def test_rel_bias_grad_reaches_table():
    """The (heads, N, N) bias gradient flows back to the bias table through
    WindowMSA.rel_bias's index gather: a sum over equal offsets."""
    torch.manual_seed(0)
    msa = WindowMSA(32, 2, 3)
    g = torch.randn(2, 9, 9)
    (msa.rel_bias() * g).sum().backward()
    idx = relative_position_index(3).reshape(-1)
    want = np.zeros(((2 * 3 - 1) ** 2, 2), np.float32)
    np.add.at(want, idx, g.permute(1, 2, 0).reshape(-1, 2).numpy())
    np.testing.assert_allclose(msa.relative_position_bias_table.grad.numpy(),
                               want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("M,drop,C", [
    pytest.param(256, False, 128, id="256-False"),
    pytest.param(300, False, 128, id="300-False"),
    pytest.param(300, True, 128, id="300-True"),
    pytest.param(35, True, 256, id="c256-35"),
    pytest.param(300, True, 256, id="c256-300")])
def test_mlp_grads_match_jax_vjp(M, drop, C):
    """C 128, hidden 512 (TestFusedSwinMlp._grad_case): every input
    gradient against the Pallas backward in interpret mode. C 256, hidden
    1024, at 35 and 300 rows: ragged, short of one 128-row tile and one
    64-row box, and 300 over the card's split and tile edges."""
    rng = np.random.default_rng((2 if drop else 1) + (C // 256) * 10)
    Hd = 4 * C
    x = rng.normal(size=(M, C)).astype(np.float32)
    ls = rng.normal(size=C).astype(np.float32)
    lb = rng.normal(size=C).astype(np.float32)
    w1 = (rng.normal(size=(C, Hd)) * 0.05).astype(np.float32)
    b1 = rng.normal(size=Hd).astype(np.float32)
    w2 = (rng.normal(size=(Hd, C)) * 0.05).astype(np.float32)
    b2 = rng.normal(size=C).astype(np.float32)
    ct = rng.normal(size=(M, C)).astype(np.float32)
    rs = ((rng.random(M) > 0.3).astype(np.float32) / 0.7) if drop else None

    def loss(*args):
        out = fused_swin_mlp_vjp(*args, None if rs is None else jnp.asarray(rs),
                                 128, 256, True)
        return (out * jnp.asarray(ct)).sum()

    want = jax.jit(jax.grad(loss, argnums=tuple(range(7))))(
        *[jnp.asarray(a) for a in (x, ls, lb, w1, b1, w2, b2)])
    want = [np.asarray(w) for w in want]
    want[3], want[5] = want[3].T, want[5].T
    leaves = [_t(a, True) for a in (x, ls, lb, w1.T, b1, w2.T, b2)]
    out = fused_swin_mlp(*leaves, None if rs is None else _t(rs))
    got = torch.autograd.grad(out, leaves, _t(ct))
    for name, g, w in zip(("x", "ln_w", "ln_b", "w1", "b1", "w2", "b2"), got,
                          want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


def test_bev_pool_grads_match_jax_vjp():
    """TestBevPoolPallas.test_grads_match_xla's case: random ids with
    out-of-range sentinels, f32."""
    rng = np.random.default_rng(1)
    B, N, D, H, W, C = 1, 2, 6, 4, 5, 8
    nvox = int(1.5 * 512)
    depth = rng.uniform(size=(B, N, D, H, W)).astype(np.float32)
    feat = rng.normal(size=(B, N, H, W, C)).astype(np.float32)
    vox = rng.integers(0, nvox + 1, size=(B, N, D, H, W)).astype(np.int32)
    pix = frustum_pixel_indices(B, N, D, H, W)
    g = np.random.default_rng(2).normal(size=(nvox, C)).astype(np.float32)

    def f(d, fe):
        return (jax_bev_pool_fused(d, fe, vox, pix, nvox, pts_cap=512,
                                   interpret=True) * g).sum()

    want = jax.jit(jax.grad(f, argnums=(0, 1)))(depth, feat)
    d, fe = _t(depth, True), _t(feat, True)
    got = torch.autograd.grad(
        bev_pool_fused(d, fe, _t(vox), _t(np.asarray(pix)), nvox), (d, fe),
        _t(g))
    for name, a, w in zip(("depth", "feat"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
