"""The port's forward FLOP count (`preworld_tpu_torch/utils/flops.py`) and
`python -m preworld_tpu_torch.tools.get_flops`, on the CPU.

Each forward kernel wrapper's `*_flops` function, which the wrapper adds to
`_cuda.flops` at every launch on the card, must equal what
`torch.utils.flop_counter.FlopCounterMode` counts for the wrapper's plain
twin at the same shapes (what the CPU runs): then a CPU count and a card
count of one config are the same integer (`chip_smoke.py`'s `flops` phase
checks that on the card). The parameters the forward reads must be those
the JAX tool counts: a flax `init` creates exactly the parameters its call
reaches. Each backward wrapper's `*_bwd_flops` must likewise equal the
counter's count of its plain backward, so that `count_step` (a loss and
its backward) counts one integer on both devices. Every comparison here
is exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from preworld_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from preworld_tpu.data.synthetic import tiny_config as jax_tiny_config
from preworld_tpu.models import PreWorld as JaxPreWorld
from preworld_tpu.train.builder import build_model as jax_build_model
from preworld_tpu.utils.config import Config as JaxConfig
from preworld_tpu_torch.data import synthetic_batch, tiny_config, to_device
from preworld_tpu_torch.models import PreWorld
from preworld_tpu_torch.models.layers import ConvNormAct
from preworld_tpu_torch.models.swin import shifted_window_region_ids
from preworld_tpu_torch.ops import bev_pool_pallas as k4
from preworld_tpu_torch.ops import cost_volume_pallas as k3
from preworld_tpu_torch.ops import swin_block_pallas as k1
from preworld_tpu_torch.ops import swin_mlp_pallas as k2
from preworld_tpu_torch.ops import window_attn_pallas as k5
from preworld_tpu_torch.tools import get_flops
from preworld_tpu_torch.train import build_model
from preworld_tpu_torch.utils import Config
from preworld_tpu_torch.utils.flax_bridge import _walk, torch_name
from preworld_tpu_torch.utils.flops import (
    count_forward,
    count_step,
    loss_backward,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINETUNE = "configs/preworld/preworld_7frame_finetune.py"
TINY = """
_base_ = ["{base}"]
data_config = dict(input_size=(64, 128), Ncams=2)
grid_config = dict(x=[-8.0, 8.0, 0.8], y=[-8.0, 8.0, 0.8],
                   z=[-1.0, 5.4, 0.8], depth=[1.0, 9.0, 0.5])
model = dict(backbone="tiny", neck_out_channels=64, num_trans_channels=16,
             out_dim=16, dtype="float32", remat=False)
"""
# the head flags of the two train stages, as the config files set them
STAGES = {"finetune": dict(if_post_finetune=True),
          "pretrain": dict(if_post_finetune=False, if_render=True,
                           use_lss_depth_loss=True)}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: parallel test workers on one host share its
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def counted(fn) -> int:
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _k1(g):
    B, Hp, Wp, C, heads, ws, shift = 1, 8, 8, 64, 2, 4, 2
    ids = torch.from_numpy(shifted_window_region_ids(Hp, Wp, ws, shift))
    args = (torch.randn(B, Hp, Wp, C, generator=g), torch.ones(C),
            torch.zeros(C), torch.randn(3 * C, C, generator=g),
            torch.zeros(3 * C), torch.randn(C, C, generator=g), torch.zeros(C),
            torch.randn(heads, ws * ws, ws * ws, generator=g), ids, None,
            heads, ws, 7, 7, shift)
    return (lambda: k1.fused_swin_attn_block(*args),
            k1.fused_swin_attn_block_flops(B, Hp, Wp, C, ws))


def _k2(g):
    M, C, Hd = 10, 64, 256
    args = (torch.randn(2, 5, C, generator=g), torch.ones(C), torch.zeros(C),
            torch.randn(Hd, C, generator=g), torch.zeros(Hd),
            torch.randn(C, Hd, generator=g), torch.zeros(C))
    return (lambda: k2.fused_swin_mlp(*args),
            k2.fused_swin_mlp_flops(M, C, Hd))


def _cost_inputs(g, BN=1, H=8, W=16, C=8):
    return (torch.randn(BN, H, W, C, generator=g),
            torch.randn(BN, H, W, C, generator=g))


def _k3(g):
    prev, curr = _cost_inputs(g)
    hom = torch.eye(3).repeat(1, 4, 1, 1) + 0.05 * torch.randn(
        1, 4, 3, 3, generator=g)
    return (lambda: k3.plane_sweep_cost_hom(prev, curr, hom, 1.0),
            k3.plane_sweep_cost_flops(1, 4, 8, 16, 8))


def _k7(g):
    prev, curr = _cost_inputs(g)
    grid = torch.rand(1, 4 * 8, 16, 2, generator=g) * 2 - 1
    return (lambda: k3.plane_sweep_cost(prev, curr, grid, 1.0),
            k3.plane_sweep_cost_flops(1, 4, 8, 16, 8))


def _k4(g):
    B, N, D, Hf, Wf, C, nv = 1, 2, 3, 4, 5, 8, 50
    pts = (B, N, D, Hf, Wf)
    depth = torch.rand(pts, generator=g)
    feat = torch.randn(B, N, Hf, Wf, C, generator=g)
    vox = torch.randint(0, nv + 1, pts, generator=g)
    pix = torch.randint(0, B * N * Hf * Wf, pts, generator=g)
    return (lambda: k4.bev_pool_fused(depth, feat, vox, pix, nv),
            k4.bev_pool_flops(depth.numel(), C, nv))


def _window_inputs(g, lead, C, heads, N, windows):
    qkv = torch.randn(*lead, 3 * C, generator=g)
    bias = torch.randn(heads, N, N, generator=g)
    mask = torch.where(torch.rand(windows, N, N, generator=g) < 0.3, -100.0,
                       0.0)
    return qkv, bias, mask


def _k5(g):
    Bn, N, C, heads = 6, 16, 64, 2
    qkv, bias, mask = _window_inputs(g, (Bn, N), C, heads, N, 3)
    return (lambda: k5.fused_window_attention(qkv, bias, mask, heads),
            k5.fused_window_attention_flops(Bn, N, C))


def _k6(g):
    B, Hp, Wp, C, heads, ws = 1, 8, 12, 64, 2, 4
    qkv, bias, mask = _window_inputs(g, (B, Hp, Wp), C, heads, ws * ws, 6)
    return (lambda: k5.band_window_attention(qkv, bias, mask, heads, ws),
            k5.band_window_attention_flops(B, Hp, Wp, C, ws))


KERNEL_CASES = {"K1": _k1, "K2": _k2, "K3": _k3, "K4": _k4, "K5": _k5,
                "K6": _k6, "K7": _k7}


@pytest.mark.parametrize("kernel", sorted(KERNEL_CASES))
def test_kernel_flops_equal_the_counter_on_the_plain_twin(kernel):
    """The wrapper's FLOP function at the launch's shapes equals
    FlopCounterMode's count of its plain twin (the CPU path) at those
    shapes; nonzero for the kernels with products, 0 for the gathers and
    sums of K3, K4 and K7."""
    run, want = KERNEL_CASES[kernel](torch.Generator().manual_seed(0))
    got = counted(run)
    assert got == want
    assert (want > 0) == (kernel in ("K1", "K2", "K5", "K6"))


def test_conv3d_count():
    """A ConvNormAct 3-D conv counts 2 x output elements x Cin x k^3."""
    cin, cout, k = 4, 6, 3
    layer = ConvNormAct(cin, cout, k, ndim=3).eval()
    x = torch.randn(1, 5, 6, 7, cin)
    assert counted(lambda: layer(x)) == 2 * (cout * 5 * 6 * 7) * cin * k ** 3


def _jax_param_names(jcfg, batch):
    """Torch names of the flax params that `init` of the inference call
    creates (the JAX get_flops count)."""
    model = JaxPreWorld(jcfg)
    shapes = jax.eval_shape(lambda b: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        b, train=False), batch)
    return {torch_name(p): int(np.prod(v.shape))
            for p, v in _walk(shapes["params"])}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_params_read_equal_the_jax_init(stage):
    """At the tiny config of each train stage: the flax init of the
    inference call holds exactly the parameters the port's forward reads
    (same names, same count); the port builds the other stage's heads
    besides, which the forward does not read. The finetune stage's tree
    comes from a real init, the pretrain stage's from `jax.eval_shape` of
    it, as the JAX get_flops takes it (one XLA compile of the init is ~20 s
    here)."""
    jcfg = jax_tiny_config(**STAGES[stage])
    jb = {k: jnp.asarray(v) for k, v in
          jax_synthetic_batch(jcfg, 1, with_labels=False).items()}
    if stage == "finetune":
        variables = jax.jit(lambda b: JaxPreWorld(jcfg).init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, b, train=False))(jb)
        want = {torch_name(p): int(np.prod(v.shape))
                for p, v in _walk(variables["params"])}
    else:
        want = _jax_param_names(jcfg, jb)
    model = PreWorld(tiny_config(**STAGES[stage])).eval()
    res = count_forward(model, to_device(
        synthetic_batch(model.cfg, 1, with_labels=False), "cpu"))
    read = set(dict(model.named_parameters())) - set(res["unread"])
    assert read == set(want)
    assert res["params"] == sum(want.values())
    assert res["params_built"] > res["params"]
    assert res["kernel_flops"] == 0 and res["kernels"] == {}
    assert res["flops"] == res["aten_flops"] > 0


def test_flagship_params_equal_the_jax_count(tmp_path):
    """The finetune config file's model (Swin-B at 512x1408, 6 cameras):
    the JAX get_flops count (`jax.eval_shape` of the init) equals the
    port's parameters on the meta device less those its forward does not
    read, which a tiny model of the same config file names (the heads of
    the other stage)."""
    tiny = tmp_path / "tiny.py"
    tiny.write_text(TINY.format(base=os.path.join(REPO, FINETUNE)))
    small = build_model(Config.fromfile(str(tiny)), device="cpu").eval()
    unread = set(count_forward(small, to_device(synthetic_batch(
        small.cfg, 1, with_labels=False), "cpu"))["unread"])
    assert {n.split(".")[0] for n in unread} == {
        "density_mlp", "semantic_mlp", "color_mlp"}

    jmodel = jax_build_model(JaxConfig.fromfile(FINETUNE))
    jb = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
        jax_synthetic_batch(jmodel.cfg, 1, with_labels=False))
    want = _jax_param_names(jmodel.cfg, jb)
    port = build_model(Config.fromfile(FINETUNE), device="meta")
    got = {n: p.numel() for n, p in port.named_parameters() if n not in unread}
    assert set(got) == set(want)
    assert sum(got.values()) == sum(want.values())


def test_cli_prints_params_and_count_forward_total(tmp_path, capsys):
    """`get_flops --device cpu` on a tiny config file: the params line and
    the total of `count_forward` on the same model and batch."""
    cfg = tmp_path / "tiny.py"
    cfg.write_text(TINY.format(base=os.path.join(REPO, FINETUNE)))
    res = get_flops.main([str(cfg), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"params: {res['params'] / 1e6:.2f} M" in out
    assert f"({res['flops']})" in out
    model = build_model(Config.fromfile(str(cfg)), device="cpu").eval()
    again = count_forward(model, to_device(
        synthetic_batch(model.cfg, 1, with_labels=False), "cpu"))
    assert again["flops"] == res["flops"] and again["params"] == res["params"]
    assert res["device"] == "cpu"


def test_cli_refuses_without_a_card(tmp_path, monkeypatch):
    """No card and no `--device cpu`: it raises; no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "tiny.py"
    cfg.write_text(TINY.format(base=os.path.join(REPO, FINETUNE)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_flops.main([str(cfg)])


def _bwd_cases(g):
    """Each backward kernel: (its plain backward on the forward cases'
    shapes, its `*_bwd_flops` there)."""
    B, Hp, Wp, C, heads, ws, shift = 1, 8, 8, 64, 2, 4, 2
    ids = torch.from_numpy(shifted_window_region_ids(Hp, Wp, ws, shift))
    x = torch.randn(B, Hp, Wp, C, generator=g)
    k1_args = (x, torch.ones(C), torch.zeros(C),
               torch.randn(3 * C, C, generator=g), torch.zeros(3 * C),
               torch.randn(C, C, generator=g), torch.zeros(C),
               torch.randn(heads, ws * ws, ws * ws, generator=g), ids, None,
               torch.randn(x.shape, generator=g), heads, ws, 7, 7, shift)
    M, C2, Hd = 10, 64, 256
    x2 = torch.randn(2, 5, C2, generator=g)
    k2_args = (x2, torch.ones(C2), torch.zeros(C2),
               torch.randn(Hd, C2, generator=g), torch.zeros(Hd),
               torch.randn(C2, Hd, generator=g), torch.zeros(C2), None,
               torch.randn(x2.shape, generator=g))
    Bn, N, C5 = 6, 16, 64
    qkv, bias, mask = _window_inputs(g, (Bn, N), C5, 2, N, 3)
    k5_args = (qkv, bias, mask, torch.randn(Bn, N, C5, generator=g), 2)
    qkv6, bias6, mask6 = _window_inputs(g, (1, 8, 12), 64, 2, 16, 6)
    k6_args = (qkv6, bias6, mask6, torch.randn(1, 8, 12, 64, generator=g),
               2, 4)
    return {
        "K1b": (lambda: k1.fused_swin_attn_block_bwd(*k1_args),
                k1.fused_swin_attn_block_bwd_flops(B, Hp, Wp, C, ws)),
        "K2b": (lambda: k2.fused_swin_mlp_bwd(*k2_args),
                k2.fused_swin_mlp_bwd_flops(M, C2, Hd)),
        "K5b": (lambda: k5.fused_window_attention_bwd(*k5_args),
                k5.fused_window_attention_bwd_flops(Bn, N, C5)),
        "K6b": (lambda: k5.band_window_attention_bwd(*k6_args),
                k5.band_window_attention_bwd_flops(1, 8, 12, 64, 4)),
    }


@pytest.mark.parametrize("kernel", ["K1b", "K2b", "K5b", "K6b"])
def test_backward_flops_equal_the_counter_on_the_plain_backward(kernel):
    """Each backward wrapper's FLOP function (which it adds to
    `_cuda.flops` at a launch on the card) equals FlopCounterMode's count
    of its plain backward (the CPU path: the rerun forward and each
    product's two gradients) at the forward cases' shapes: 3 x the
    forward's."""
    run, want = _bwd_cases(torch.Generator().manual_seed(0))[kernel]
    with FlopCounterMode(display=False) as counter:
        run()
    assert counter.get_total_flops() == want > 0
    fwd = KERNEL_CASES[kernel[:2]](torch.Generator().manual_seed(0))[1]
    assert want == 3 * fwd


def test_count_step_equals_the_counter_on_loss_and_backward():
    """`count_step` of the tiny finetune step (the loss dict's sum and its
    backward, gradients on) equals FlopCounterMode's total of the same
    loss plus backward from the same weights, batch and masks; it counts
    more than the forward alone and reaches the parameters."""
    cfg = tiny_config(if_post_finetune=True, if_render=False,
                      use_lss_depth_loss=False)
    model = PreWorld(cfg)
    batch = to_device(synthetic_batch(cfg, 1, seed=3, with_labels=True),
                      "cpu")
    got = count_step(loss_backward(model, batch,
                                   torch.Generator().manual_seed(0)), model)
    model.zero_grad(set_to_none=True)
    with FlopCounterMode(display=False) as counter:
        loss_backward(model, batch, torch.Generator().manual_seed(0))()
    assert got["flops"] == got["aten_flops"] == counter.get_total_flops()
    assert got["kernel_flops"] == 0 and got["kernels"] == {}
    fwd = count_forward(model.eval(), batch)["flops"]
    assert got["flops"] > 2 * fwd
    assert 0 < got["params_with_grad"] <= sum(
        p.numel() for p in model.parameters())
