"""Swin parity of the PyTorch port against the JAX package (CPU, f32).

K1 (attention half-block) and K2 (MLP half-block): the port's wrappers on
CPU tensors run their plain versions, held against the Pallas kernels
`fused_swin_attn_block` / `fused_swin_mlp` in interpret mode on the same
numpy inputs, with the pad region filled with garbage (37.0) to prove the
in-kernel masking. Then a small `SwinTransformer` (embed 128, depths (2, 2))
against the JAX module's XLA path, with the flax weights carried across by
the bridge. Tolerance rtol = atol = 5e-5 (f32; only summation order
differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preworld_tpu.models.swin import SwinTransformer as JaxSwin
from preworld_tpu.models.swin import shifted_window_mask
from preworld_tpu.ops.swin_block_pallas import (
    fused_swin_attn_block as jax_attn_block,
)
from preworld_tpu.ops.swin_mlp_pallas import fused_swin_mlp as jax_mlp
from preworld_tpu_torch.models.swin import (
    SwinTransformer,
    relative_position_index,
    shifted_window_region_ids,
)
from preworld_tpu_torch.ops.swin_block_pallas import (
    fused_swin_attn_block,
    fused_swin_attn_block_plain,
)
from preworld_tpu_torch.ops.swin_mlp_pallas import (
    fused_swin_mlp,
    fused_swin_mlp_plain,
)
from preworld_tpu_torch.utils import load_flax_params

TOL = dict(rtol=5e-5, atol=5e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shifted,drop", [(False, False), (True, False),
                                          (True, True)])
def test_attn_block_matches_pallas(shifted, drop):
    """TestFusedSwinAttnBlock's shapes: B 2, H 7, W 10, C 128, 4 heads,
    ws 4; pad content 37.0. The port takes x in image order and rolls in
    its indexing; the Pallas kernel takes x pre-rolled."""
    rng = np.random.default_rng(3)
    B, H, W, C, heads, ws = 2, 7, 10, 128, 4, 4
    N = ws * ws
    Hp, Wp = H + (-H) % ws, W + (-W) % ws
    shift = ws // 2 if shifted else 0
    x = np.full((B, Hp, Wp, C), 37.0, np.float32)
    x[:, :H, :W] = rng.normal(size=(B, H, W, C))
    ln_w = rng.normal(1.0, 0.1, C).astype(np.float32)
    ln_b = rng.normal(0.0, 0.1, C).astype(np.float32)
    wqkv = (rng.normal(size=(C, 3 * C)) * C ** -0.5).astype(np.float32)
    bqkv = rng.normal(0.0, 0.1, 3 * C).astype(np.float32)
    wproj = (rng.normal(size=(C, C)) * C ** -0.5).astype(np.float32)
    bproj = rng.normal(0.0, 0.1, C).astype(np.float32)
    table = rng.normal(0.0, 0.5, ((2 * ws - 1) ** 2, heads)).astype(np.float32)
    bias = table[relative_position_index(ws).reshape(-1)].reshape(
        N, N, heads).transpose(2, 0, 1)
    rs = (np.array([0.0, 1.25], np.float32) if drop else None)

    want = np.asarray(jax_attn_block(
        jnp.asarray(np.roll(x, (-shift, -shift), axis=(1, 2))),
        jnp.asarray(ln_w), jnp.asarray(ln_b),
        jnp.asarray(wqkv), jnp.asarray(bqkv), jnp.asarray(wproj),
        jnp.asarray(bproj), jnp.asarray(bias),
        shifted_window_mask(Hp, Wp, ws, shift) if shift else None,
        None if rs is None else jnp.asarray(rs), heads, ws, H, W, shift,
        interpret=True))
    want = np.roll(want, (shift, shift), axis=(1, 2))

    region = (_t(shifted_window_region_ids(Hp, Wp, ws, shift).astype(np.int32))
              if shift else None)
    args = (_t(x), _t(ln_w), _t(ln_b), _t(wqkv.T), _t(bqkv), _t(wproj.T),
            _t(bproj), _t(bias), region, None if rs is None else _t(rs),
            heads, ws, H, W, shift)
    got = fused_swin_attn_block(*args).numpy()
    np.testing.assert_array_equal(got, fused_swin_attn_block_plain(*args).numpy())
    np.testing.assert_allclose(got[:, :H, :W], want[:, :H, :W], **TOL)


@pytest.mark.parametrize("drop", [False, True])
def test_mlp_matches_pallas(drop):
    rng = np.random.default_rng(5)
    B, Hp, Wp, C = 2, 8, 12, 128
    Hd = 4 * C
    x = rng.normal(size=(B, Hp, Wp, C)).astype(np.float32)
    ln_w = rng.normal(1.0, 0.1, C).astype(np.float32)
    ln_b = rng.normal(0.0, 0.1, C).astype(np.float32)
    w1 = (rng.normal(size=(C, Hd)) * C ** -0.5).astype(np.float32)
    b1 = rng.normal(0.0, 0.1, Hd).astype(np.float32)
    w2 = (rng.normal(size=(Hd, C)) * Hd ** -0.5).astype(np.float32)
    b2 = rng.normal(0.0, 0.1, C).astype(np.float32)
    rs = None
    if drop:
        rs = np.repeat(np.array([0.0, 1.25], np.float32), Hp * Wp)

    want = np.asarray(jax_mlp(
        jnp.asarray(x), jnp.asarray(ln_w), jnp.asarray(ln_b), jnp.asarray(w1),
        jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2),
        None if rs is None else jnp.asarray(rs), block_rows=64,
        hidden_chunk=256, interpret=True))
    args = (_t(x), _t(ln_w), _t(ln_b), _t(w1.T), _t(b1), _t(w2.T), _t(b2),
            None if rs is None else _t(rs))
    got = fused_swin_mlp(*args).numpy()
    np.testing.assert_array_equal(got, fused_swin_mlp_plain(*args).numpy())
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("window", [4, 7])
def test_swin_transformer_matches_jax(window):
    """Embed 128, depths (2, 2): stage 0 at 8x12 runs a shifted block; at
    stage 1 (4x6) the window clamps to 4 and the shift drops to 0. Window 7
    also pads stage 0 to 14x14 with an odd window count."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 32, 48, 3)).astype(np.float32)
    kw = dict(depths=(2, 2), num_heads=(4, 8), window_size=window,
              out_indices=(0, 1))
    jm = JaxSwin(embed_dims=128, drop_path_rate=0.0, use_fused_attn=False,
                 use_fused_mlp=False, **kw)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), False, False)
    want = jm.apply(variables, jnp.asarray(x), False, False)
    want0 = jm.apply(variables, jnp.asarray(x), False, True)

    m = SwinTransformer((32, 48), embed_dims=128, **kw).eval()
    load_flax_params(m, jax.tree_util.tree_map(np.asarray,
                                               variables["params"]))
    with torch.no_grad():
        got = m(_t(x))
        got0 = m(_t(x), stage0_only=True)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert len(got0) == len(want0) == 1
    for g, w in zip(got + got0, tuple(want) + tuple(want0)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
