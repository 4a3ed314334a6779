"""The train step's masks drawn a step ahead (`models/mask_plan.py`), on
the CPU at a tiny Swin config with drop path and the ASPP dropout on.

The reference is the inline draws: `draw_drop_scales` and the f32 ASPP
mask `(u < keep) / keep` from a generator of the same state, in the
stereo loop's order (frames 2, 1, 0; the ASPP mask on frames 1 and 0).

  * over consecutive train-mode forwards on one generator, every scale and
    mask the model uses, and the generator's state after each step, equal
    the inline draws bit for bit, every step after the first a plan hit
    (also with a shortened thread switch interval);
  * a generator reseeded or drawn from between steps, or other batch rows,
    gives a miss and the inline values;
  * under a 2-rank mesh each rank's draws, made on the worker after the
    step left `use_mesh`, are its `draw_rows` slice of the global draw;
  * a `make_train_step` step that hits equals one that draws inline;
  * the ASPP mask scaled in f32, bf16 and f16 equals the f32 mask cast;
  * `predict` and `predict_sequential` make no plan and draw nothing;
  * a worker's exception is raised on the caller's thread.
"""

import copy
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from preworld_tpu_torch import parallel
from preworld_tpu_torch.data import (
    frame_batch,
    synthetic_batch,
    tiny_config,
    to_device,
)
from preworld_tpu_torch.models import PreWorld
from preworld_tpu_torch.train import (
    create_train_state,
    make_optimizer,
    make_train_step,
)
from preworld_tpu_torch.utils import init_weights, trace

SWIN = dict(backbone="swin", swin_embed_dims=16, swin_depths=(1, 1, 1, 1),
            swin_num_heads=(1, 2, 4, 8), swin_window=4)
FINETUNE = dict(if_post_finetune=True, if_render=False,
                use_lss_depth_loss=False)


@pytest.fixture(autouse=True)
def tracing_on():
    trace.reset()
    trace.enable(True)
    yield
    trace.enable(False)
    trace.reset()


def _model(**kw):
    torch.manual_seed(0)
    model = PreWorld(tiny_config(**{**SWIN, **FINETUNE, **kw}))
    init_weights(model, seed=0, fan_in=True)
    return model.train()


def _batch(model, b=1, seed=1):
    return to_device(synthetic_batch(model.cfg, b, seed=seed,
                                     with_labels=True, num_rays=64), "cpu")


def _aspp_shape(model):
    c, vt = model.cfg, model.view_transformer
    return (c.input_size[0] // vt.downsample,
            c.input_size[1] // vt.downsample, c.neck_out_channels)


def _inline(model, gen, rows):
    """The masks of one step drawn inline, in the loop's order, as
    (kind, value): the drop scales as drawn, the ASPP mask as the f32
    scaled mask."""
    c = model.cfg
    keep = 1.0 - model.view_transformer.depth_net.aspp.dropout_rate
    out = []
    for fid in range(c.num_frames - 1, -1, -1):
        stage0 = fid >= c.temporal_frames
        out.append(("drop", model.img_backbone.draw_drop_scales(
            rows, gen, stage0)))
        if not stage0:
            out.append(("aspp", (torch.rand((rows, *_aspp_shape(model)),
                                            generator=gen) < keep).float()
                        / keep))
    return out


def _record(model):
    """Hooks that log what the backbone and the view transformer are
    handed: (kind, drop scales or the scaled ASPP mask)."""
    log = []
    model.img_backbone.register_forward_pre_hook(
        lambda m, args: log.append(("drop", args[2])))
    model.view_transformer.register_forward_pre_hook(
        lambda m, args: log.append(("aspp", args[4])))
    return log


def _assert_same(got, want, dtype=torch.float32):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (kind, g), (_, w) in zip(got, want):
        if kind == "aspp":
            assert g.dtype == dtype
            assert torch.equal(g, w.to(dtype))
            continue
        assert len(g) == len(w)
        for gb, wb in zip(g, w):
            assert (gb is None) == (wb is None)
            if gb is not None:
                assert all(torch.equal(x, y) for x, y in zip(gb, wb))


def _plan_counts():
    return {k: v for k, v in trace.counters.items()
            if k.startswith("mask_plan_")}


def _forward(model, batch, gen):
    with torch.no_grad():
        model.extract_voxel_feat(batch, train=True, generator=gen)


@pytest.mark.parametrize("switch", [None, 1e-6])
def test_consecutive_steps_hit_and_equal_inline_draws(switch):
    model = _model()
    batch = _batch(model)
    rows = batch["imgs"].shape[0] * model.cfg.num_cams
    log = _record(model)
    gen = torch.Generator().manual_seed(2**31 + 7)
    ref = torch.Generator().manual_seed(2**31 + 7)
    old = sys.getswitchinterval()
    try:
        if switch is not None:
            sys.setswitchinterval(switch)
        for step in range(4):
            log.clear()
            _forward(model, batch, gen)
            _assert_same(log, _inline(model, ref, rows))
            assert torch.equal(gen.get_state(), ref.get_state()), step
    finally:
        sys.setswitchinterval(old)
    assert _plan_counts() == {"mask_plan_misses": 1, "mask_plan_hits": 3}


@pytest.mark.parametrize("between", ["reseed", "draw"])
def test_generator_moved_between_steps_misses(between):
    model = _model()
    batch = _batch(model)
    rows = batch["imgs"].shape[0] * model.cfg.num_cams
    log = _record(model)
    gen = torch.Generator().manual_seed(11)
    ref = torch.Generator().manual_seed(11)
    _forward(model, batch, gen)
    _inline(model, ref, rows)
    for g in (gen, ref):
        if between == "reseed":
            g.manual_seed(12)
        else:
            torch.rand(3, generator=g)
    log.clear()
    _forward(model, batch, gen)
    _assert_same(log, _inline(model, ref, rows))
    assert torch.equal(gen.get_state(), ref.get_state())
    assert _plan_counts() == {"mask_plan_misses": 2}


def test_other_rows_miss():
    model = _model()
    log = _record(model)
    gen = torch.Generator().manual_seed(5)
    ref = torch.Generator().manual_seed(5)
    for b in (1, 2):
        batch = _batch(model, b)
        log.clear()
        _forward(model, batch, gen)
        _assert_same(log, _inline(model, ref, b * model.cfg.num_cams))
    assert torch.equal(gen.get_state(), ref.get_state())
    assert _plan_counts() == {"mask_plan_misses": 2}


@pytest.mark.parametrize("rank", [0, 1])
def test_mesh_rows_are_the_global_draws_slice(rank):
    """Step 1 inside `use_mesh` draws inline and hands step 2 to the
    worker, which is held until the step has left the mesh and is done
    before step 2 enters it: step 2's draws, made on the worker with no
    mesh active, still take the rank's rows of the global batch's."""
    model = _model()
    planner = model._mask_plan
    n = 2
    mesh = parallel.Mesh(2, 1, rank)
    gen = torch.Generator().manual_seed(3)
    ref = torch.Generator().manual_seed(3)
    hold = threading.Event()
    planner._pool = ThreadPoolExecutor(1)
    blocker = planner._pool.submit(hold.wait, 30)
    got = []
    try:
        for _ in range(2):
            with parallel.use_mesh(mesh):
                draws = model._mask_draws(n)
                step = planner.step(gen, draws, False)
                got.append([step.take(d.kind) for d in draws])
            hold.set()
            planner._plan.end.result(timeout=30)
    finally:
        hold.set()
        assert blocker.result(timeout=30)
    assert _plan_counts() == {"mask_plan_misses": 1, "mask_plan_hits": 1}
    keep = 1.0 - model.view_transformer.depth_net.aspp.dropout_rate
    sl = slice(rank * n, (rank + 1) * n)
    for values in got:
        want = _inline(model, ref, 2 * n)
        assert len(values) == len(want)
        for g, (kind, w) in zip(values, want):
            if kind == "aspp":
                assert torch.equal(g.float() / keep, w[sl])
                continue
            for gb, wb in zip(g, w):
                if wb is None:
                    assert gb is None
                    continue
                assert all(torch.equal(x, y[sl]) for x, y in zip(gb, wb))
    assert torch.equal(gen.get_state(), ref.get_state())


def test_train_step_hit_equals_inline():
    """From equal models and generator states, one step that takes the
    worker's plan and one that draws inline give the same losses,
    gradients and parameters, bit for bit."""
    a = _model()
    b = copy.deepcopy(a)
    batch = _batch(a)
    ga = torch.Generator().manual_seed(2**32 + 1)
    # an eval-mode forward that draws: BatchNorm keeps its statistics
    a.eval()
    _forward(a, batch, ga)
    gb = torch.Generator()
    gb.set_state(ga.get_state())
    trace.reset()
    out = []
    for model, gen in ((a, ga), (b, gb)):
        state = create_train_state(model, make_optimizer(model.parameters()))
        _, metrics = make_train_step()(state, batch, gen)
        out.append((metrics, {n: p.grad.clone() for n, p
                              in model.named_parameters()
                              if p.grad is not None},
                    {n: p.detach().clone() for n, p
                     in model.named_parameters()}))
    assert _plan_counts() == {"mask_plan_hits": 1, "mask_plan_misses": 1}
    (ma, grads_a, pa), (mb, grads_b, pb) = out
    assert ma.keys() == mb.keys()
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert grads_a.keys() == grads_b.keys() and grads_a
    assert all(torch.equal(grads_a[k], grads_b[k]) for k in grads_a)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert torch.equal(ga.get_state(), gb.get_state())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rate", [0.5, 0.3])
def test_scaled_aspp_mask_equals_the_f32_mask_cast(dtype, rate):
    model = _model(backbone="tiny", dtype=dtype)
    model.view_transformer.depth_net.aspp.dropout_rate = rate
    gen = torch.Generator().manual_seed(9)
    ref = torch.Generator().manual_seed(9)
    draws = model._mask_draws(3)
    assert [d.kind for d in draws] == ["aspp", "aspp"]
    step = model._mask_plan.step(gen, draws, False)
    keep = 1.0 - rate
    for _ in draws:
        got = model._aspp_dropout(step, torch.device("cpu"))
        want = (torch.rand((3, *_aspp_shape(model)), generator=ref)
                < keep).float() / keep
        assert got.dtype == dtype
        assert torch.equal(got, want.to(dtype))


def test_inference_makes_no_plan_and_draws_nothing(monkeypatch):
    model = _model().eval()
    monkeypatch.setattr(model, "_mask_draws", lambda rows: pytest.fail(
        "inference drew masks"))
    batch = to_device(synthetic_batch(model.cfg, 1, seed=4,
                                      with_labels=False), "cpu")
    model.predict(batch)
    cache = model.init_sequential_cache(frame_batch(batch, 2))
    model.predict_sequential(frame_batch(batch, 1), cache)
    assert model._mask_plan._pool is None
    assert model._mask_plan._plan is None
    assert _plan_counts() == {}


def test_worker_exception_reaches_the_caller(monkeypatch):
    model = _model()
    batch = _batch(model)
    real = model.img_backbone.draw_drop_scales
    main = threading.main_thread()

    def draw(*args, **kw):
        if threading.current_thread() is not main:
            raise ValueError("drawn off the caller's thread")
        return real(*args, **kw)

    monkeypatch.setattr(model.img_backbone, "draw_drop_scales", draw)
    gen = torch.Generator().manual_seed(1)
    _forward(model, batch, gen)
    with pytest.raises(ValueError, match="off the caller's thread"):
        _forward(model, batch, gen)
    assert _plan_counts() == {"mask_plan_misses": 1, "mask_plan_hits": 1}
