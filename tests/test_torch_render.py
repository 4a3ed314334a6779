"""The render head of the port against the JAX package (CPU, f32).

`ops/render.py`: `sample_ray_points`, `cumdist_mask` (exact),
`raw2alpha` and `alpha2weight` with the early exit both firing and not, at
1e-6, and `alpha2weight`'s gradient against `jax.grad`.
`models/nerf_head.py`: `render_scene` dense and in ray chunks, what its
autograd graph keeps (the JAX residual policy: the sampled field and the
keep mask, never the mask loop again in the backward), and the five
`nerf_head_losses` and their gradients in the density,
semantic and colour fields against `jax.grad`, at 1e-5: values at rtol
1e-5 (with an atol of 1e-5 of the largest magnitude), gradients at rel-L2
1e-5 (the two backward passes add the field's corner contributions in
other orders, so a single element may differ by a few 1e-5 relative).
The JAX renderer samples through its corner tables
(`ops/field_sample.py`), the port through `F.grid_sample`: the same
trilinear function.

The scene is tiny_config's render head (16 m x 16 m grid, 20 x 20 x 8
field, 38 samples per ray) with 96 rays per sample, two samples; densities
large enough that about half of the rays exit early; a few rays beyond
`max_depth` (masked) carrying out-of-range labels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preworld_tpu.models import nerf_head as jax_nerf
from preworld_tpu.ops import render as jax_render
from preworld_tpu_torch.data import tiny_nerf_config
from preworld_tpu_torch.models import nerf_head
from preworld_tpu_torch.models.nerf_head import (
    nerf_head_losses,
    nusc_class_weights,
    render_scene,
)
from preworld_tpu_torch.ops import render

CFG = tiny_nerf_config()
SPEC = CFG.spec
JCFG = jax_nerf.NerfHeadConfig(
    spec=jax_render.RaySamplingSpec(**dataclasses.asdict(SPEC)),
    max_depth=CFG.max_depth)
B, R = 2, 96
X, Y, Z = 20, 20, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / \
        np.linalg.norm(want)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    density = (rng.normal(size=(B, X, Y, Z)) * 8.0 + 11.0).astype(np.float32)
    semantic = rng.normal(size=(B, X, Y, Z, 17)).astype(np.float32)
    color = rng.normal(size=(B, X, Y, Z, 3)).astype(np.float32)
    rays = np.zeros((B, R, 16), np.float32)
    rays[..., 2] = rng.uniform(1.0, 9.0, (B, R))
    rays[..., 3] = rng.integers(0, 17, (B, R))
    rays[:, :6, 2] = 12.0  # beyond max_depth: masked
    rays[:, :3, 3] = 40.0  # an out-of-range label on a masked ray
    origins = rng.uniform(-1.0, 1.0, (B, R, 3))
    origins[..., 2] = 1.5
    dirs = rng.normal(size=(B, R, 3))
    dirs[..., 2] *= 0.1
    rays[..., 4:7] = origins
    rays[..., 7:10] = dirs
    rays[..., 13:16] = rng.uniform(0, 1, (B, R, 3))
    a = np.linspace(0.0, 0.3, 3)
    bda = np.stack([np.array([[np.cos(t), -np.sin(t), 0],
                              [np.sin(t), np.cos(t), 0], [0, 0, 1]])
                    for t in a[:B]]).astype(np.float32)
    return density, semantic, color, rays, bda


def test_sample_ray_points_and_cumdist_mask(scene):
    *_, rays, bda = scene
    ro, rd = rays[0, :, 4:7], rays[0, :, 7:10]
    jpts, jinner, jt = jax_render.sample_ray_points(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(bda[1]),
        jax_render.RaySamplingSpec(**dataclasses.asdict(SPEC)))
    pts, inner, t = render.sample_ray_points(_t(ro), _t(rd), _t(bda[1]), SPEC)
    assert pts.shape == (R, SPEC.num_samples, 3)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(inner.numpy(), np.asarray(jinner))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=0,
                               atol=1e-6)
    # the mask from the same points is exact
    want = np.asarray(jax_render.cumdist_mask(
        jnp.asarray(pts.numpy()), jnp.asarray(inner.numpy()), JCFG.spec))
    got = render.cumdist_mask(pts, inner, SPEC)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1  # it drops some outer samples


def _alphas(early):
    rng = np.random.default_rng(11 if early else 12)
    scale = 0.8 if early else 1e-5
    alpha = (rng.uniform(size=(8, 40)) * scale).astype(np.float32)
    mask = rng.uniform(size=alpha.shape) > 0.2
    return alpha, mask


@pytest.mark.parametrize("early", [True, False])
def test_raw2alpha_and_alpha2weight(early):
    alpha, mask = _alphas(early)
    dens = np.linspace(-20, 30, 64, dtype=np.float32)
    np.testing.assert_allclose(
        render.raw2alpha(_t(dens), SPEC.act_shift, 0.5).numpy(),
        np.asarray(jax_render.raw2alpha(jnp.asarray(dens), SPEC.act_shift,
                                        0.5)), rtol=1e-6, atol=1e-6)
    jw, jlast = jax_render.alpha2weight(jnp.asarray(alpha), jnp.asarray(mask))
    w, last = render.alpha2weight(_t(alpha), _t(mask))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=1e-6,
                               atol=1e-6)
    # the early exit fires on every row, or on none
    exited = (w.numpy() == 0) & mask & (alpha > 0)
    assert exited.any(axis=1).all() if early else not exited.any()

    cw = np.random.default_rng(5).normal(size=alpha.shape).astype(np.float32)

    def jloss(a):
        w, last = jax_render.alpha2weight(a, jnp.asarray(mask))
        return (w * cw).sum() + last.sum()

    a = _t(alpha).requires_grad_(True)
    w, last = render.alpha2weight(a, _t(mask))
    ((w * _t(cw)).sum() + last.sum()).backward()
    assert _rel_l2(a.grad.numpy(), jax.grad(jloss)(jnp.asarray(alpha))) < 1e-5


@pytest.mark.parametrize("ray_chunk", [0, 32])
def test_render_scene_matches_jax(scene, ray_chunk):
    density, semantic, color, rays, bda = scene
    mask = (rays[1, :, 2] > 0) & (rays[1, :, 2] <= CFG.max_depth)
    mask = mask.astype(np.float32)
    want = jax_nerf.render_scene(
        jnp.asarray(density[1]), jnp.asarray(semantic[1]),
        jnp.asarray(color[1]), jnp.asarray(rays[1, :, 4:7]),
        jnp.asarray(rays[1, :, 7:10]), jnp.asarray(bda[1]),
        dataclasses.replace(JCFG, ray_chunk=ray_chunk), jnp.asarray(mask))
    got = render_scene(
        _t(density[1]), _t(semantic[1]), _t(color[1]), _t(rays[1, :, 4:7]),
        _t(rays[1, :, 7:10]), _t(bda[1]),
        dataclasses.replace(CFG, ray_chunk=ray_chunk), _t(mask))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].detach().numpy(), want[k], 1e-5)
    # about half of the rays exit early, the rest pass through
    last = got["alphainv_last"].detach().numpy()
    assert 0.2 < (last < 1e-3).mean() < 0.8


def _render_inputs(scene, ray_chunk):
    """Scene 1's fields (differentiable) and the rest of render_scene's
    arguments."""
    density, semantic, color, rays, bda = scene
    mask = ((rays[1, :, 2] > 0) & (rays[1, :, 2] <= CFG.max_depth))
    fields = [_t(a[1]).requires_grad_(True) for a in (density, semantic, color)]
    return fields, (_t(rays[1, :, 4:7]), _t(rays[1, :, 7:10]), _t(bda[1]),
                    dataclasses.replace(CFG, ray_chunk=ray_chunk),
                    _t(mask.astype(np.float32)))


@pytest.mark.parametrize("ray_chunk", [0, 32])
def test_render_scene_saves_only_its_residuals(scene, ray_chunk):
    """Autograd keeps the (21, R, S) f32 sampled field and the (R, S) bool
    keep mask (the JAX `save_only_these_names("render_sampled",
    "render_keep")`), besides the field and the rays it was given and the
    scalars of the distortion reduction: each storage counted once."""
    fields, (ro, rd, bda, cfg, mask) = _render_inputs(scene, ray_chunk)
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        saved[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        render_scene(*fields, ro, rd, bda, cfg, mask)
    S, n = SPEC.num_samples, 21
    residuals = n * R * S * 4 + R * S
    inputs = n * X * Y * Z * 4 + sum(t.untyped_storage().nbytes()
                                     for t in (ro, rd, bda, mask))
    assert sum(saved.values()) <= residuals + inputs + 256


@pytest.mark.parametrize("ray_chunk", [0, 32])
def test_render_backward_skips_the_mask_loop(scene, ray_chunk, monkeypatch):
    """The backward reruns no `cumdist_mask` (its keep mask is saved), and
    the chunked render's field gradients are the dense render's."""
    calls = []

    def counted(*args):
        calls.append(1)
        return render.cumdist_mask(*args)

    monkeypatch.setattr(nerf_head, "cumdist_mask", counted)
    fields, rest = _render_inputs(scene, ray_chunk)
    out = render_scene(*fields, *rest)
    forward_calls = len(calls)
    assert forward_calls == (R // ray_chunk if ray_chunk else 1)
    sum(v.sum() for v in out.values()).backward()
    assert len(calls) == forward_calls
    dense, rest = _render_inputs(scene, 0)
    sum(v.sum() for v in render_scene(*dense, *rest).values()).backward()
    for a, b in zip(fields, dense):
        assert float(a.grad.abs().max()) > 0
        assert _rel_l2(a.grad.numpy(), b.grad.numpy()) < 1e-6


def test_nerf_head_losses_and_grads_match_jax(scene):
    density, semantic, color, rays, bda = scene

    def jfn(de, se, co):
        return jax_nerf.nerf_head_losses(de, se, co, jnp.asarray(rays),
                                         jnp.asarray(bda), JCFG)

    jargs = tuple(jnp.asarray(a) for a in (density, semantic, color))
    want = jfn(*jargs)
    jgrads = jax.grad(lambda *a: sum(jfn(*a).values()), argnums=(0, 1, 2))(
        *jargs)

    args = [_t(a).requires_grad_(True) for a in (density, semantic, color)]
    got = nerf_head_losses(*args, _t(rays), _t(bda), CFG)
    assert sorted(got) == sorted(want) == sorted(
        ["loss_render_depth", "loss_render_semantic", "loss_render_color",
         "loss_sdf_entropy", "loss_sdf_distortion"])
    for k in want:
        v = float(got[k].detach())
        assert np.isfinite(v), k
        np.testing.assert_allclose(v, float(want[k]), rtol=1e-5, err_msg=k)
    sum(got.values()).backward()
    for a, g, name in zip(args, jgrads, ("density", "semantic", "color")):
        assert float(a.grad.abs().max()) > 0, name
        assert _rel_l2(a.grad.numpy(), g) < 1e-5, name


def test_class_weights_match_jax():
    np.testing.assert_array_equal(nusc_class_weights(17),
                                  jax_nerf.nusc_class_weights(17))
