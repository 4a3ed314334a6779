"""The port's Swin routes against the JAX package (CPU, f32).

  * `SwinBlock` on the per-block routes, shifted, in train mode: the band
    (K6) and window (K5) routes against the JAX `SwinBlock` with
    `use_fused_attn=True` (its Pallas kernels in interpret mode), the plain
    route (a 7x7 window, N % 16 != 0) against the JAX XLA route: output and
    every parameter gradient, rtol = atol = 2e-5 (f32; only summation order
    differs). The JAX parameter tree loads through the bridge with no name
    missing or left over.
  * `SwinTransformer`'s per-stage route table for four configurations;
    `stage_route` against the routes the JAX `SwinTransformer` takes for
    every setting of its four knobs, at widths 64 and 128 and window areas
    16 and 49; and a mixed-width transformer (a per-block stage handing
    over to a padded-layout stage) against the JAX one on its TPU routes,
    outputs at 2e-5.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import preworld_tpu.ops.swin_block_pallas as sbp
import preworld_tpu.ops.swin_mlp_pallas as smp
import preworld_tpu.ops.window_attn_pallas as wap
from preworld_tpu.models.swin import SwinBlock as JaxSwinBlock
from preworld_tpu.models.swin import SwinTransformer as JaxSwin
from preworld_tpu_torch.models.swin import SwinBlock, SwinTransformer
from preworld_tpu_torch.models.swin import shifted_window_mask, stage_route
from preworld_tpu_torch.utils import load_flax_params
from preworld_tpu_torch.utils.flax_bridge import flax_to_torch_state

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def interpret(monkeypatch):
    """Run every Pallas kernel of the JAX Swin in interpret mode."""
    fwa, bwa = wap.fused_window_attention_vjp, wap.band_window_attention_vjp
    blk, mlp = sbp.fused_swin_attn_block_vjp, smp.fused_swin_mlp_vjp
    monkeypatch.setattr(
        wap, "fused_window_attention_vjp",
        lambda qkv, bias, mask, h, g=8, interp=False: fwa(qkv, bias, mask, h,
                                                          g, True))
    monkeypatch.setattr(
        wap, "band_window_attention_vjp",
        lambda qkv, bias, mask, h, ws, interp=False: bwa(qkv, bias, mask, h,
                                                         ws, True))
    monkeypatch.setattr(
        sbp, "fused_swin_attn_block_vjp",
        lambda x, ls, lb, wq, bq, wp, bp, bias, mask, rs, h, ws, H, W, shift,
        interp=False: blk(x, ls, lb, wq, bq, wp, bp, bias, mask, rs, h, ws, H,
                          W, shift, True))
    monkeypatch.setattr(
        smp, "fused_swin_mlp_vjp",
        lambda x, ls, lb, w1, b1, w2, b2, rs, br, hc, interp: mlp(
            x, ls, lb, w1, b1, w2, b2, rs, br, hc, True))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# case -> (port route, C, heads, window, JAX SwinBlock knobs, port fused
# MLP); the *_128 cases are the routes the knobs open at a width that is a
# multiple of 128: K5 with K2, and plain attention with K2
BLOCKS = {
    "band": ("band", 128, 4, 4, dict(use_fused_attn=True, use_fused_mlp=True,
                                     use_band_attn=True), True),
    "window": ("window", 96, 3, 4, dict(use_fused_attn=True,
                                        use_fused_mlp=True,
                                        use_band_attn=False), False),
    "plain": ("plain", 64, 2, 7, dict(use_fused_attn=False,
                                      use_fused_mlp=False), False),
    "window_128": ("window", 128, 4, 4, dict(use_fused_attn=True,
                                             use_fused_mlp=True,
                                             use_band_attn=False), True),
    "plain_128": ("plain", 128, 4, 4, dict(use_fused_attn=False,
                                           use_fused_mlp=True), True),
}


@pytest.mark.parametrize("case", list(BLOCKS))
def test_swin_block_route_matches_jax(interpret, case):
    """B 2, H 7, W 10 (9 x 14 for the 7x7 window), padded per block to
    the window, shifted, train mode; the 4x4 window pads to 8 x 12, three
    windows per band row."""
    route, C, heads, ws, knobs, fused_mlp = BLOCKS[case]
    rng = np.random.default_rng(0)
    B, (H, W) = 2, ((7, 10) if ws == 4 else (9, 14))
    x = rng.normal(size=(B, H * W, C)).astype(np.float32)
    ct = rng.normal(size=(B, H * W, C)).astype(np.float32)
    jblk = JaxSwinBlock(C, heads, ws, shift=True, **knobs)
    params = jblk.init(jax.random.PRNGKey(0), jnp.asarray(x), (H, W),
                       train=True)

    def loss(p):
        out = jblk.apply(p, jnp.asarray(x), (H, W), train=True)
        return (out * jnp.asarray(ct)).sum(), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)

    blk = SwinBlock(C, heads, ws, ws // 2, route=route, fused_mlp=fused_mlp)
    load_flax_params(blk, jax.tree_util.tree_map(np.asarray,
                                                 params["params"]))
    Hp, Wp = H + (-H) % ws, W + (-W) % ws
    mask = shifted_window_mask(Hp, Wp, ws, ws // 2)
    out = blk(_t(x).reshape(B, H, W, C), (H, W), mask)
    (out.reshape(B, H * W, C) * _t(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().reshape(B, H * W, C).numpy(),
                               np.asarray(want), **TOL)
    want_grads = flax_to_torch_state(grads["params"])
    got_grads = {n: p.grad for n, p in blk.named_parameters()}
    assert sorted(got_grads) == sorted(want_grads)
    for name, g in want_grads.items():
        np.testing.assert_allclose(got_grads[name].numpy(), g, err_msg=name,
                                   **TOL)


ROUTE_TABLE = {
    "swin_b": (dict(), [("block", True)] * 4),
    "swin_t_widths": (dict(embed_dims=96, depths=(2, 2, 6, 2),
                           num_heads=(3, 6, 12, 24)),
                      [("window", False)] * 2 + [("block", True)] * 2),
    "block_off": (dict(use_block_attn=False), [("band", True)] * 4),
    "window_7": (dict(window_size=7), [("plain", True)] * 4),
}


@pytest.mark.parametrize("name", list(ROUTE_TABLE))
def test_stage_routes(name):
    """Per-stage (attention route, K2 MLP) at the flagship input 512x1408:
    Swin-B's default takes the block kernels everywhere; Swin-T's widths
    96 and 192 take K5; the block kernel off takes K6; a 7x7 window (49
    tokens) takes the plain attention, with K2 where C % 128 == 0."""
    kw, want = ROUTE_TABLE[name]
    with torch.device("meta"):
        m = SwinTransformer((512, 1408), **kw)
    assert m.stage_routes == want
    for i, depth in enumerate(m.depths):
        for j in range(depth):
            blk = getattr(m, f"stage{i}_block{j}")
            assert (blk.route, blk.fused_mlp) == want[i]


# JAX kernel entry (module, attribute) -> the route its call reveals; each
# stand-in returns zeros of the kernel's output shape
_JAX_ROUTE_KERNELS = {
    (sbp, "fused_swin_attn_block_vjp"): ("block", lambda x, *a: x),
    (wap, "band_window_attention_vjp"): (
        "band", lambda qkv, *a: qkv[..., :qkv.shape[-1] // 3]),
    (wap, "fused_window_attention_vjp"): (
        "window", lambda qkv, *a: qkv[..., :qkv.shape[-1] // 3]),
    (smp, "fused_swin_mlp_vjp"): ("mlp", lambda x, *a: x),
}
KNOB_NAMES = ("use_fused_attn", "use_block_attn", "use_band_attn")


def _jax_routes(monkeypatch, knobs, ws):
    """{C: (attention route, K2 MLP)} of the two stages (C 64 and 128, both
    with the window `ws`) of a JAX SwinTransformer with `knobs`, read from
    the kernel entries it calls while it traces; `None` for
    `use_fused_attn` / `use_fused_mlp` is given as True (the JAX package's
    TPU default)."""
    seen = {}
    for (mod, attr), (route, out) in _JAX_ROUTE_KERNELS.items():
        def record(*a, route=route, out=out):
            C = a[0].shape[-1] // (1 if route in ("block", "mlp") else 3)
            seen.setdefault(C, set()).add(route)
            return jnp.zeros_like(out(*a))
        monkeypatch.setattr(mod, attr, record)
    kw = {k: v for k, v in knobs.items()}
    for k in ("use_fused_attn", "use_fused_mlp"):
        kw[k] = True if kw[k] is None else kw[k]
    m = JaxSwin(embed_dims=64, depths=(1, 1), num_heads=(2, 4),
                window_size=ws, out_indices=(0, 1), **kw)
    x = jax.ShapeDtypeStruct((1, 8 * ws, 8 * ws, 3), jnp.float32)
    jax.eval_shape(lambda a: m.init(jax.random.PRNGKey(0), a, False, False),
                   x)
    routes = {}
    for C in (64, 128):
        got = seen.get(C, set())
        attn = got - {"mlp"}
        assert len(attn) <= 1, got
        routes[C] = (attn.pop() if attn else "plain", "mlp" in got)
    return routes


@pytest.mark.parametrize(
    "values", list(itertools.product((None, True, False), repeat=3)))
def test_stage_route_matches_jax_knobs(monkeypatch, values):
    """Every setting of the three attention knobs, with `use_fused_mlp`
    cycling through None, True and False, at window areas 16 (K5 / K6 /
    block-capable) and 49 (plain only): the port's `stage_route` picks the
    route the JAX `SwinTransformer` takes."""
    knobs = dict(zip(KNOB_NAMES, values))
    knobs["use_fused_mlp"] = (None, True, False)[
        sum(3 ** i * (None, True, False).index(v)
            for i, v in enumerate(values)) % 3]
    for ws in (4, 7):
        want = _jax_routes(monkeypatch, knobs, ws)
        for C in (64, 128):
            assert stage_route(C, ws * ws, **knobs) == want[C], (ws, C)


@pytest.mark.parametrize("knobs", [dict(), dict(use_block_attn=False)])
def test_bridge_loads_per_block_trees(knobs):
    """The JAX Swin's parameter tree with per-block stages (window, and
    band with the block kernel off) has exactly the port's names and
    shapes."""
    kw = dict(embed_dims=64, depths=(2, 2, 2), num_heads=(2, 4, 8),
              window_size=4, out_indices=(1, 2), **knobs)
    x = jax.ShapeDtypeStruct((1, 64, 96, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda a: JaxSwin(use_fused_attn=True, use_fused_mlp=True,
                          **kw).init(jax.random.PRNGKey(0), a, False, False),
        x)
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    shapes["params"])
    m = SwinTransformer((64, 96), **kw)
    routes = {r for r, _ in m.stage_routes}
    assert routes == ({"window", "block"} if not knobs else
                      {"window", "band"})
    assert len(load_flax_params(m, params)) == len(m.state_dict())


def test_mixed_width_transformer_matches_jax(interpret):
    """Embed 64, depths (2, 2), heads (2, 4): stage 0 (C 64, 8 x 12) runs
    per block on K5 with a shifted block; stage 1 (C 128, 4 x 6, the
    window clamped to 4) on the padded layout with K1 and K2. The JAX
    model takes its TPU routes (Pallas in interpret mode)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 32, 48, 3)).astype(np.float32)
    kw = dict(embed_dims=64, depths=(2, 2), num_heads=(2, 4), window_size=4,
              out_indices=(0, 1))
    jm = JaxSwin(drop_path_rate=0.0, use_fused_attn=True, use_fused_mlp=True,
                 **kw)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), False, False)
    want = jm.apply(variables, jnp.asarray(x), False, False)
    want0 = jm.apply(variables, jnp.asarray(x), False, True)

    m = SwinTransformer((32, 48), **kw).eval()
    assert m.stage_routes == [("window", False), ("block", True)]
    load_flax_params(m, jax.tree_util.tree_map(np.asarray,
                                               variables["params"]))
    with torch.no_grad():
        got = m(_t(x))
        got0 = m(_t(x), stage0_only=True)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got + got0, tuple(want) + tuple(want0)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
