"""The port's dev tools (`preworld_tpu_torch/tools/bench_{stages,bytes,swin,
nerf_bisect}.py`) on the CPU, against the JAX tools where they compute a
number.

bench_stages: the five probe scalars of the port against the JAX probes
(`tools/bench_stages.py::make_probes`' `frame_loop`, copied here: the JAX
function builds only the flagship) at the tiny config, f32, the same
seeded flax weights in both (the port's through `utils/flax_bridge`). The
four sums of features agree to 1e-4 of the sum of their magnitudes (f32
sums of a few thousand to 100,000 terms in another order; the features
agree to ~1e-6). `full_predict` sums argmax labels in [0, 17]: a voxel
whose top-2 logits lie within 1e-3 of each other may take the other
label (`tests/test_torch_slice_model.py`'s margin), so the sums may differ
by at most 17 x 1 % of the 3,200 voxels.
bench_bytes: `full_predict`'s count is `count_forward`'s of the request.
bench_swin: the block probe runs K1 + K2 once each and agrees with the
same block on the plain route. bench_nerf_bisect: each term's gradient
"without the term's key" against `jax.grad` of the JAX losses with that
term's weight 0 (depth: `use_depth_sup=False`), density + 9, on the JAX
tool's scene cut to 96 rays on a 20 x 20 x 8 field: at rel-L2 1e-5 (the
JAX and torch scatters add the corners in other orders), except the
density gradient while the depth term is in the sum, at 1e-3: rays that
start below the field render depths of ~1e-6, whose log amplifies f32
rounding (the port's f32 gradient lies 6.9e-3 from its f64 one there, and
moves 1.2e-5 when the fields move by 1e-7 relative; JAX and the port agree
to 1.7e-4). All JAX work is one jitted program; the four CLIs stop
without a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preworld_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from preworld_tpu.data.synthetic import tiny_config as jax_tiny_config
from preworld_tpu.geometry.transforms import (
    curr2adjsensor_chain as jax_curr2adjsensor_chain,
)
from preworld_tpu.geometry.transforms import (
    sensor2keyego_chain as jax_sensor2keyego_chain,
)
from preworld_tpu.models import PreWorld as JaxPreWorld
from preworld_tpu.models import nerf_head as jax_nerf
from preworld_tpu.models.view_transformer import (
    get_mlp_input as jax_get_mlp_input,
)
from preworld_tpu.ops import render as jax_render
from preworld_tpu_torch.data import tiny_config, tiny_nerf_config, to_device
from preworld_tpu_torch.models import PreWorld
from preworld_tpu_torch.models.swin import SwinBlock
from preworld_tpu_torch.tools import (
    bench_bytes,
    bench_nerf_bisect,
    bench_stages,
    bench_swin,
)
from preworld_tpu_torch.utils.flax_bridge import flax_to_torch_state
from preworld_tpu_torch.utils.flops import count_flops, count_forward

OVER = dict(if_post_finetune=True, if_render=False, use_lss_depth_loss=False)
SUM_TOL = 1e-4
MARGIN = 1e-3
FLIP_SHARE = 0.01
GRAD_REL_L2 = 1e-5
DEPTH_DENSITY_REL_L2 = 1e-3
NERF = tiny_nerf_config()
JNERF = jax_nerf.NerfHeadConfig(
    spec=jax_render.RaySamplingSpec(**dataclasses.asdict(NERF.spec)),
    max_depth=NERF.max_depth)
# the JAX tool's patches, by term
JAX_PATCHES = {"depth": {"use_depth_sup": False},
               "semantic": {"weight_semantic": 0.0},
               "color": {"weight_color": 0.0},
               "entropy": {"weight_entropy_last": 0.0},
               "distortion": {"weight_distortion": 0.0}}
NERF_SIZE = dict(R=96, X=20, Y=20, Z=8)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: parallel test workers on one host share its
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_frame_loop(m, batch, with_vt, with_bev, with_cost=True):
    """`tools/bench_stages.py::make_probes`' frame_loop (a copy)."""
    c = m.cfg
    imgs = batch["imgs"]
    B, T, N = imgs.shape[:3]
    s2keyego = jax_sensor2keyego_chain(batch["sensor2egos"],
                                       batch["ego2globals"])
    curr2adj = jax_curr2adjsensor_chain(batch["sensor2egos"],
                                        batch["ego2globals"],
                                        c.temporal_frames)
    stereo_feat_prev = None
    bev_feats = []
    acc = jnp.float32(0)
    for fid in range(c.num_frames - 1, -1, -1):
        frame_imgs = imgs[:, fid]
        if fid >= c.temporal_frames:
            x = frame_imgs.reshape(B * N, *frame_imgs.shape[2:])
            stereo_feat_prev = m.img_backbone(x, False, True)[0]
            continue
        feat, stereo_feat = m._encode_image(frame_imgs, False)
        if not with_vt:
            acc += feat.astype(jnp.float32).sum()
            acc += stereo_feat.astype(jnp.float32)[0, 0, 0, 0]
            stereo_feat_prev = stereo_feat
            continue
        cams = {
            "sensor2keyego": s2keyego[:, fid],
            "intrin": batch["intrins"][:, fid],
            "post_rot": batch["post_rots"][:, fid],
            "post_tran": batch["post_trans"][:, fid],
            "bda": batch["bda"],
            "mlp_input": jax_get_mlp_input(
                s2keyego[:, 0], batch["ego2globals"][:, 0],
                batch["intrins"][:, fid], batch["post_rots"][:, fid],
                batch["post_trans"][:, fid], batch["bda"],
            ),
        }
        stereo = {
            "prev_feat": stereo_feat_prev if with_cost else None,
            "curr_feat": stereo_feat,
            "k2s_sensor": curr2adj[:, fid],
        }
        voxel, depth = m.view_transformer(feat, cams, stereo, False)
        voxel = m.pre_process_net(voxel, False)[0]
        bev_feats.append(voxel)
        stereo_feat_prev = stereo_feat
    if not with_vt:
        return acc
    x = jnp.concatenate(bev_feats, axis=-1)
    if not with_bev:
        return x.astype(jnp.float32).sum()
    feats = m.bev_backbone(x, False)
    x = m.bev_neck(feats, train=False)
    x = m.final_conv(x.astype(jnp.float32), train=False)
    return x.sum()


JAX_PROBES = (
    ("encode_3frames", lambda m, b: jax_frame_loop(m, b, False, False)),
    ("plus_vt_zerocost", lambda m, b: jax_frame_loop(m, b, True, False, False)),
    ("plus_viewtransform", lambda m, b: jax_frame_loop(m, b, True, False)),
    ("plus_bev_encoder", lambda m, b: jax_frame_loop(m, b, True, True)),
    ("full_predict",
     lambda m, b: m.predict(b)["semantic_occ"].sum().astype(jnp.float32)),
)


def _random_variables(shapes, rng):
    """Seeded numpy values for a flax variables tree: kernels N(0,
    1/fan_in), norm scales 1 + N(0, 0.1), other params and BatchNorm means
    N(0, 0.1), BatchNorm variances U(0.5, 1.5)."""
    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.normal(0.0, int(np.prod(shape[:-1])) ** -0.5, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = rng.normal(1.0, 0.1, shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_loss_sum(cfg, rays, bda):
    def total(de, se, co):
        return sum(jax_nerf.nerf_head_losses(de, se, co, rays, bda,
                                             cfg).values())
    return total


@pytest.fixture(scope="module")
def runs():
    """The port's probes with the flax weights, and one jitted JAX program:
    the five JAX probes, their logits' top-2 margins, and the render
    gradients of the base loss and of each term's patch."""
    jcfg = jax_tiny_config(**OVER)
    batch_np = jax_synthetic_batch(jcfg, 1, 64, seed=0, with_labels=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jmodel = JaxPreWorld(jcfg)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, b, train=False), jbatch)
    jvars = _random_variables(shapes, np.random.default_rng(5))

    fields = [t.numpy() for t in bench_nerf_bisect.make_inputs(
        9.0, seed=0, **NERF_SIZE)]
    *jfields, jrays, jbda = (jnp.asarray(a) for a in fields)

    def program(v, b, de, se, co):
        probes = [jmodel.apply(v, b, method=fn) for _, fn in JAX_PROBES]

        def margin(m, b_):
            vf, _ = m.extract_voxel_feat(b_, train=False)
            top2 = jnp.sort(m.occupancy_logits(vf, train=False), -1)[..., -2:]
            return top2[..., 1] - top2[..., 0]

        grads = {term: jax.grad(_jax_loss_sum(
            dataclasses.replace(JNERF, **patch), jrays, jbda),
            argnums=(0, 1, 2))(de, se, co)
            for term, patch in [("base", {})] + list(JAX_PATCHES.items())}
        return probes, jmodel.apply(v, b, method=margin), grads

    jprobes, jmargin, jgrads = jax.jit(program)(jvars, jbatch, *jfields)

    model, _, probes = bench_stages.make_probes(tiny_config(**OVER))
    flat = flax_to_torch_state(jvars["params"], jvars["batch_stats"])
    missing, unexpected = model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in flat.items()}, strict=False)
    # the render MLPs, which predict does not reach, keep their init
    assert unexpected == [] and {k.split(".")[0] for k in missing
                                 if not k.endswith("num_batches_tracked")} \
        == {"density_mlp", "semantic_mlp", "color_mlp"}
    batch = to_device(batch_np, "cpu")
    return dict(
        model=model, batch=batch, probes=probes,
        outs={name: fn(model, batch) for name, fn, _ in probes},
        jprobes=dict(zip([n for n, _ in JAX_PROBES],
                         (float(p) for p in jprobes))),
        jmargin=np.asarray(jmargin), fields=fields,
        jgrads={k: [np.asarray(g) for g in v] for k, v in jgrads.items()})


@pytest.mark.parametrize("name", [n for n, _ in JAX_PROBES[:4]])
def test_probe_sums_match_jax(runs, name):
    """The four feature sums: within SUM_TOL of the sum of the magnitudes
    of what they add."""
    reduce = dict((n, r) for n, _, r in runs["probes"])[name]
    out = runs["outs"][name]
    got = float(reduce(out))
    scale = float(reduce(jax.tree_util.tree_map(torch.abs, out)))
    assert np.isfinite(got) and scale > 0
    assert abs(got - runs["jprobes"][name]) <= SUM_TOL * scale


def test_full_predict_matches_jax(runs):
    """The label sum: at most FLIP_SHARE of the voxels flipped, and none
    where the JAX logits' top-2 margin exceeds MARGIN."""
    reduce = dict((n, r) for n, _, r in runs["probes"])["full_predict"]
    got = float(reduce(runs["outs"]["full_predict"]))
    unsure = int((runs["jmargin"] <= MARGIN).sum())
    allowed = 17 * min(unsure, int(FLIP_SHARE * runs["jmargin"].size))
    assert got > 0
    assert abs(got - runs["jprobes"]["full_predict"]) <= allowed


def test_bench_bytes_full_predict_is_count_forward(runs):
    """bench_bytes' last row counts one request, exactly `count_forward`;
    the rows' differences add up to it."""
    model, batch = runs["model"], runs["batch"]
    counts = bench_bytes.count_probes(model, batch, runs["probes"])
    rows = bench_bytes.rows(counts)
    want = count_forward(model, batch)
    assert [r["probe"] for r in rows] == [n for n, _ in JAX_PROBES]
    name, last = counts[-1]
    assert name == "full_predict"
    assert (last["flops"], last["bytes"]) == (want["flops"], want["bytes"])
    assert sum(r["delta_gb"] for r in rows) == pytest.approx(
        want["bytes"] / 1e9, rel=1e-12)
    assert all(r["gb"] > 0 for r in rows)


def test_bench_swin_block_probe():
    """At a tiny stage (C 128, 10 x 20 tokens, window 4): the probe runs K1
    and K2 once each (their plain twins here) and agrees, on the real
    tokens, with the same block on the plain route in bf16."""
    C, hw, heads, ws = 128, (10, 20), 4, 4
    blk, x = bench_swin.make_block(C, hw, heads, "cpu", ws=ws)
    assert x.shape == (6, 12, 20, C) and x.dtype == torch.float32
    run = bench_swin.block_fn(blk, hw)
    res = count_flops(lambda: run(x), blk)
    assert sorted(res["bytes_by_kernel"]) == ["fused_swin_attn_block",
                                              "fused_swin_mlp"]
    out = run(x)[:, :hw[0], :hw[1]].float()
    plain = SwinBlock(C, heads, ws, 0, route="plain", fused_mlp=False)
    plain.load_state_dict(blk.state_dict())
    with torch.no_grad():
        want = plain(x[:, :hw[0], :hw[1]].to(torch.bfloat16), hw,
                     None).float()
    assert torch.isfinite(out).all()
    rel = float((out - want).norm() / want.norm())
    assert rel < 0.01


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / \
        np.linalg.norm(want)


@pytest.mark.parametrize("term", ["base"] + list(bench_nerf_bisect.TERMS))
def test_nerf_bisect_grads_match_jax(runs, term):
    """loss_grads without the term's key against jax.grad with its weight
    0: each field's gradient at rel-L2 GRAD_REL_L2 (the density's at
    DEPTH_DENSITY_REL_L2 while the depth term counts), zero where the JAX
    one is zero (the dropped semantic or colour term's own field)."""
    drop = None if term == "base" else bench_nerf_bisect.TERMS[term]
    got = bench_nerf_bisect.loss_grads(
        NERF, *(torch.from_numpy(a) for a in runs["fields"]), drop=drop)
    for i, (g, want) in enumerate(zip(got, runs["jgrads"][term])):
        if not np.any(want):
            assert not bool(g.any())
            continue
        tol = DEPTH_DENSITY_REL_L2 if i == 0 and term != "depth" \
            else GRAD_REL_L2
        assert _rel_l2(g.numpy(), want) < tol


def test_nerf_scatter_is_the_render_backward():
    """scatter_grad is grid_sample's field gradient through the render's
    layout: the autograd gradient of F.grid_sample at the flipped points;
    the 5 % mask leaves ~5 % of the samples live."""
    field, pts, g, live = bench_nerf_bisect.scatter_inputs(
        R=32, S=12, X=20, Y=20, Z=8)
    field = torch.randn(field.shape, generator=torch.Generator().manual_seed(0))
    got = bench_nerf_bisect.scatter_grad(field, pts, g)
    f = field.clone().requires_grad_(True)
    out = torch.nn.functional.grid_sample(
        f, pts.flip(-1).reshape(1, 32, 12, 1, 3), mode="bilinear",
        padding_mode="zeros", align_corners=True)
    want, = torch.autograd.grad(out, f, g[None, ..., None])
    torch.testing.assert_close(got, want)
    assert 0.02 < float(live.float().mean()) < 0.08


@pytest.mark.parametrize("tool", [bench_stages, bench_bytes, bench_swin,
                                  bench_nerf_bisect])
def test_cli_refuses_without_a_card(tool, monkeypatch):
    """No card and no `--device cpu`: it raises before any work; no
    fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
