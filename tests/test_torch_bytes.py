"""The port's byte and transcendental counts (`preworld_tpu_torch/utils/
flops.py`) and `python -m preworld_tpu_torch.tools.get_flops`' new lines,
on the CPU.

The counting mode's definition on hand-counted cases (every count here is
exact): a Linear, a chain of views (0 bytes), an expanded operand (its
storage), a slice (its elements), an in-place add (read and write), a
copy and a fill (no read of what they overwrite), `empty` (0), a
normalisation (its output, not its saved statistics), and the
transcendental functions. Each forward kernel wrapper, as one kernel call:
its `*_bytes` equal to the bytes of its operands as passed plus its
result's, its `*_transcendentals` equal to the mode's count of its plain
twin, and none of the plain twin's ops counted beside it (while the FLOP
counter still counts the plain twin, as before). The reference config
(2 Swin blocks a stage, 128x352, 2 cameras) counted twice in bf16, as
`chip_smoke.py` counts it on both devices: the same integers.
"""

import os

import pytest
import torch
import torch.nn.functional as F

from preworld_tpu_torch.data import synthetic_batch, to_device
from preworld_tpu_torch.geometry import GridConfig
from preworld_tpu_torch.models import PreWorld, PreWorldConfig
from preworld_tpu_torch.models.layers import Linear
from preworld_tpu_torch.models.swin import shifted_window_region_ids
from preworld_tpu_torch.ops import _cuda
from preworld_tpu_torch.ops import bev_pool_pallas as k4
from preworld_tpu_torch.ops import cost_volume_pallas as k3
from preworld_tpu_torch.ops import swin_block_pallas as k1
from preworld_tpu_torch.ops import swin_mlp_pallas as k2
from preworld_tpu_torch.ops import window_attn_pallas as k5
from preworld_tpu_torch.tools import get_flops
from preworld_tpu_torch.utils import init_weights
from preworld_tpu_torch.utils.flops import _BytesAccessed, count_flops

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


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: parallel test workers on one host share its
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def accessed(fn):
    """(bytes, {op: bytes}, transcendentals) of fn() under the mode."""
    mode = _BytesAccessed()
    with torch.no_grad(), mode:
        fn()
    return sum(mode.by_op.values()), dict(mode.by_op), mode.transcendentals


F32 = 4


def test_linear():
    """x (4, 8), weight (16, 8), bias (16): one addmm reads the bias, x and
    the transposed weight (a view, 0 itself) and writes (4, 16)."""
    layer = Linear(8, 16)
    x = torch.randn(4, 8)
    n, by_op, _ = accessed(lambda: layer(x))
    assert by_op == {"aten.addmm.default": (16 + 32 + 128 + 64) * F32}
    assert n == 960


def test_view_chain_counts_nothing():
    x = torch.randn(4, 8)
    assert accessed(lambda: x.view(2, 16).t().unsqueeze(0).expand(
        3, 16, 2)[..., :1].reshape(3, 16))[0] == 0


def test_expanded_operand_counts_its_storage():
    """(1, 8) expanded to (4, 8) reads its 8 elements, not 32."""
    a, x = torch.randn(1, 8), torch.randn(4, 8)
    assert accessed(lambda: a.expand(4, 8) + x)[0] == (8 + 32 + 32) * F32


def test_slice_counts_its_elements():
    """A (4, 2) slice of (4, 8): 8 elements read, 8 written, 8 exps."""
    x = torch.randn(4, 8)
    assert accessed(lambda: x[:, :2].exp()) == (
        64, {"aten.exp.default": 64}, 8)


def test_in_place_add_reads_and_writes():
    y, x = torch.randn(4, 8), torch.randn(4, 8)
    assert accessed(lambda: y.add_(x)) == (
        3 * 32 * F32, {"aten.add_.Tensor": 3 * 32 * F32}, 0)


@pytest.mark.parametrize("op", ["copy_", "fill_"])
def test_overwrites_do_not_read_their_target(op):
    y, x = torch.randn(4, 8), torch.randn(4, 8)
    fn = (lambda: y.copy_(x)) if op == "copy_" else (lambda: y.fill_(1.0))
    assert accessed(fn)[0] == (64 if op == "copy_" else 32) * F32


def test_empty_counts_nothing():
    x = torch.randn(3)
    assert accessed(lambda: torch.empty(100))[0] == 0
    assert accessed(lambda: torch.empty_like(x))[0] == 0


def test_norm_counts_its_output_only():
    """layer_norm reads x and writes its output; the mean and rstd it
    returns for a backward are not counted (the CPU and the card return
    them in other dtypes)."""
    x = torch.randn(4, 8)
    assert accessed(lambda: F.layer_norm(x, (8,))) == (
        64 * F32, {"aten.native_layer_norm.default": 64 * F32}, 0)


@pytest.mark.parametrize("fn,want", [
    (lambda x: x.exp(), 12), (lambda x: torch.sigmoid(x), 12),
    (lambda x: torch.softmax(x, -1), 12), (lambda x: F.gelu(x), 12),
    (lambda x: x.abs().pow(0.5), 12), (lambda x: x.pow(2), 0),
    (lambda x: x.abs().rsqrt(), 12), (lambda x: torch.relu(x), 0),
    (lambda x: x.sum().exp(), 1)])
def test_transcendentals(fn, want):
    """One a output element of the listed functions; pow with an integer
    exponent and the rest count 0."""
    x = torch.randn(3, 4)
    assert accessed(lambda: fn(x))[2] == want


# each forward kernel: (counter key, wrapper, arguments, plain twin)
def _k1(g):
    B, Hp, Wp, C, heads, ws, shift = 1, 8, 8, 64, 2, 4, 2
    ids = torch.from_numpy(shifted_window_region_ids(Hp, Wp, ws, shift))
    args = (torch.randn(B, Hp, Wp, C, generator=g), torch.ones(C),
            torch.zeros(C), torch.randn(3 * C, C, generator=g),
            torch.zeros(3 * C), torch.randn(C, C, generator=g), torch.zeros(C),
            torch.randn(heads, ws * ws, ws * ws, generator=g), ids, None,
            heads, ws, 7, 7, shift)
    return ("fused_swin_attn_block", k1.fused_swin_attn_block, args,
            k1.fused_swin_attn_block_plain)


def _k2(g):
    C, Hd = 64, 256
    args = (torch.randn(2, 5, C, generator=g), torch.ones(C), torch.zeros(C),
            torch.randn(Hd, C, generator=g), torch.zeros(Hd),
            torch.randn(C, Hd, generator=g), torch.zeros(C),
            torch.rand(10, generator=g))
    return "fused_swin_mlp", k2.fused_swin_mlp, args, k2.fused_swin_mlp_plain


def _cost_inputs(g, BN=1, H=8, W=16, C=8):
    return (torch.randn(BN, H, W, C, generator=g),
            torch.randn(BN, H, W, C, generator=g))


def _k3(g):
    hom = torch.eye(3).repeat(1, 4, 1, 1) + 0.05 * torch.randn(
        1, 4, 3, 3, generator=g)
    return ("plane_sweep_cost_hom", k3.plane_sweep_cost_hom,
            (*_cost_inputs(g), hom, 1.0), k3.plane_sweep_cost_hom_plain)


def _k7(g):
    grid = torch.rand(1, 4 * 8, 16, 2, generator=g) * 2 - 1
    return ("plane_sweep_cost", k3.plane_sweep_cost,
            (*_cost_inputs(g), grid, 1.0), k3.plane_sweep_cost_plain)


def _k4(g):
    B, N, D, Hf, Wf, C, nv = 1, 2, 3, 4, 5, 8, 50
    pts = (B, N, D, Hf, Wf)
    args = (torch.rand(pts, generator=g),
            torch.randn(B, N, Hf, Wf, C, generator=g),
            torch.randint(0, nv + 1, pts, generator=g),
            torch.randint(0, B * N * Hf * Wf, pts, generator=g), nv)
    return "bev_pool_fused", k4.bev_pool_fused, args, k4.bev_pool


def _window_inputs(g, lead, C, heads, N, windows):
    qkv = torch.randn(*lead, 3 * C, generator=g)
    bias = torch.randn(heads, N, N, generator=g)
    mask = torch.where(torch.rand(windows, N, N, generator=g) < 0.3, -100.0,
                       0.0)
    return qkv, bias, mask


def _k5(g):
    args = (*_window_inputs(g, (6, 16), 64, 2, 16, 3), 2)
    return ("fused_window_attention", k5.fused_window_attention, args,
            k5.fused_window_attention_plain)


def _k6(g):
    args = (*_window_inputs(g, (1, 8, 12), 64, 2, 16, 6), 2, 4)
    return ("band_window_attention", k5.band_window_attention, args,
            k5.band_window_attention_plain)


KERNEL_CASES = {"K1": _k1, "K2": _k2, "K3": _k3, "K4": _k4, "K5": _k5,
                "K6": _k6, "K7": _k7}
FORMULAS = {"K1": (k1.fused_swin_attn_block_bytes,
                   k1.fused_swin_attn_block_transcendentals),
            "K2": (k2.fused_swin_mlp_bytes, k2.fused_swin_mlp_transcendentals),
            "K3": (k3.plane_sweep_cost_hom_bytes,
                   k3.plane_sweep_cost_transcendentals),
            "K4": (k4.bev_pool_bytes, k4.bev_pool_transcendentals),
            "K5": (k5.fused_window_attention_bytes,
                   k5.fused_window_attention_transcendentals),
            "K6": (k5.band_window_attention_bytes,
                   k5.band_window_attention_transcendentals),
            "K7": (k3.plane_sweep_cost_bytes,
                   k3.plane_sweep_cost_transcendentals)}


def _nbytes(t):
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


@pytest.mark.parametrize("kernel", sorted(KERNEL_CASES))
def test_kernel_call_counts_its_operands_and_result(kernel):
    """Under `count_flops` on the CPU, the wrapper counts as one call: its
    `*_bytes` are the nbytes of the operands as passed plus the result's,
    and no op of its plain twin is counted beside it; the FLOP counter
    still sees the plain twin (its `*_flops` are added on the card
    only)."""
    name, wrapper, args, _ = KERNEL_CASES[kernel](
        torch.Generator().manual_seed(0))
    bytes_fn, trans_fn = FORMULAS[kernel]
    res = count_flops(lambda: wrapper(*args), torch.nn.Module())
    with torch.no_grad():
        out = wrapper(*args)
    want = sum(map(_nbytes, args)) + out.numel() * out.element_size()
    assert bytes_fn(*args) == want
    assert res["bytes_by_kernel"] == {name: want}
    assert res["kernel_bytes"] == res["bytes"] == want
    assert res["aten_bytes"] == 0 and res["bytes_by_op"] == {}
    assert res["transcendentals"] == trans_fn(*args)
    assert res["kernels"] == {} and res["kernel_flops"] == 0
    assert all(v == 0 for v in _cuda.launches.values())


@pytest.mark.parametrize("kernel", sorted(KERNEL_CASES))
def test_kernel_transcendentals_equal_the_mode_on_the_plain_twin(kernel):
    """`*_transcendentals` at the launch's shapes is the mode's count of
    the plain twin on the same arguments: one exp a score (K1, K5, K6) and
    one rsqrt a row (K1, K2), one GELU a hidden element (K2); 0 for the
    gathers and sums of K3, K4 and K7."""
    _, _, args, plain = KERNEL_CASES[kernel](torch.Generator().manual_seed(0))
    _, trans_fn = FORMULAS[kernel]
    want = accessed(lambda: plain(*args))[2]
    assert trans_fn(*args) == want
    assert (want > 0) == (kernel in ("K1", "K2", "K5", "K6"))


def test_scopes_are_off_outside_a_count():
    """Outside a count a wrapper adds no bytes and its ops are not in a
    kernel scope."""
    _cuda.reset_launches()
    name, wrapper, args, _ = _k2(torch.Generator().manual_seed(0))
    with torch.no_grad():
        wrapper(*args)
    assert not _cuda.in_kernel()
    assert _cuda.bytes[name] == 0 and _cuda.transcendentals[name] == 0


def _reference_config(dtype):
    """chip_smoke.py's reference config: flagship widths, 2 Swin blocks a
    stage, 128x352, 2 cameras, 20x20x8 grid, finetune heads."""
    grid = GridConfig(x=(-8.0, 8.0, 0.8), y=(-8.0, 8.0, 0.8),
                      z=(-1.0, 5.4, 0.8), depth=(1.0, 9.0, 0.5))
    return PreWorldConfig(grid=grid, input_size=(128, 352), num_cams=2,
                          swin_depths=(2, 2, 2, 2), if_post_finetune=True,
                          dtype=dtype)


@pytest.fixture(scope="module")
def reference_counts():
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = PreWorld(_reference_config(dtype)).eval()
        init_weights(model, seed=1, fan_in=True)
        batch = to_device(synthetic_batch(model.cfg, 1, seed=7,
                                          with_labels=False), "cpu")
        out[dtype] = [count_flops(lambda: model.predict(batch), model)
                      for _ in range(2 if dtype == torch.bfloat16 else 1)]
    return out


def test_reference_count_is_the_same_integer_twice(reference_counts):
    a, b = reference_counts[torch.bfloat16]
    keys = ("flops", "bytes", "aten_bytes", "kernel_bytes",
            "transcendentals", "bytes_by_op", "bytes_by_kernel")
    assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
    assert a["bytes"] == a["aten_bytes"] + a["kernel_bytes"]
    assert a["aten_bytes"] == sum(a["bytes_by_op"].values())
    assert a["kernel_bytes"] == sum(a["bytes_by_kernel"].values())


def test_reference_count_in_bf16(reference_counts):
    """In bf16, as chip_smoke compares the card with the CPU: the four
    kernels of the path count as calls (K1, K2, K3, K4), transcendentals
    come from both; the f32 model has the same FLOPs and transcendentals
    and more bytes."""
    bf, f32 = reference_counts[torch.bfloat16][0], \
        reference_counts[torch.float32][0]
    assert sorted(bf["bytes_by_kernel"]) == sorted([
        "fused_swin_attn_block", "fused_swin_mlp", "plane_sweep_cost_hom",
        "bev_pool_fused"])
    assert bf["kernels"] == {} and bf["kernel_flops"] == 0
    assert bf["transcendentals"] > 0 and bf["aten_bytes"] > 0
    assert bf["flops"] == f32["flops"]
    assert bf["transcendentals"] == f32["transcendentals"]
    assert bf["kernel_bytes"] < f32["kernel_bytes"]


def test_cli_prints_bytes_and_transcendentals(tmp_path, capsys):
    """`get_flops --device cpu` on a tiny config file: the bytes accessed
    and transcendentals lines, with count_forward's integers."""
    cfg = tmp_path / "tiny.py"
    cfg.write_text(TINY.format(base=os.path.join(REPO, FINETUNE)))
    res = get_flops.main([str(cfg), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"bytes accessed: {res['bytes'] / 1e9:.3f} GB ({res['bytes']};" \
        in out
    assert f"transcendentals: {res['transcendentals']}\n" in out
    assert res["bytes"] > 0 and res["transcendentals"] > 0
