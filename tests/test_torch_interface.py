"""The port's interface against the JAX package's, on the CPU.

The package boundary: every name in each JAX `__init__.py`'s `__all__`
(read with `ast`, no import of the JAX package) imports from the port's
package of the same path, apart from LEAVE_BEHIND (ROADMAP.md P17). The
names the port gained for it, against their JAX counterparts:
`CustomResNet` (2-D) on an NHWC input in eval mode, flax-initialised with
perturbed BatchNorm statistics and carried across by `utils/flax_bridge.py`,
f32 within rtol / atol 1e-4; `interpolate_to` on 1, 2 and 3 channel-last
spatial dims at non-integer ratios, within 1e-5; `bev_pool_dense_oracle`,
`convert_conv_bn_sequences` and `verify_tree_shapes` exactly. All JAX
work is one jitted program. The bench entry's line (`tools/bench.py::
headline_line`) has `bench.py`'s keys (read with `ast`) without
`train_bench_error`, plus the port's own, and the docstring lists them;
`PREWORLD_BENCH_TRAIN=0` skips the train steps. `bench_parts --batch 2`
times a train step of a batch of 2 (the tiny config in place of the
flagship model, on the CPU).
"""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preworld_tpu.models.layers import interpolate_to as jax_interpolate_to
from preworld_tpu.models.resnet import CustomResNet as JaxCustomResNet
from preworld_tpu.ops.bev_pool import (
    bev_pool_dense_oracle as jax_bev_pool_dense_oracle,
)
from preworld_tpu.utils import torch_port as jax_torch_port
from preworld_tpu_torch.models import CustomResNet, CustomResNet3D
from preworld_tpu_torch.models.layers import interpolate_to
from preworld_tpu_torch.ops import bev_pool, bev_pool_dense_oracle
from preworld_tpu_torch.tools import bench, bench_parts
from preworld_tpu_torch.utils import load_flax_params
from preworld_tpu_torch.utils.torch_port import (
    convert_conv_bn_sequences,
    verify_tree_shapes,
)

REPO = Path(__file__).resolve().parents[1]
# JAX names the port leaves behind (ROADMAP.md P17): the XLA grid samplers
# (the port uses F.grid_sample or its kernels) and the NamedSharding helpers
# (the port's shard_batch places the batch)
LEAVE_BEHIND = {
    "ops": {"grid_sample_2d", "grid_sample_3d"},
    "parallel": {"batch_shardings", "replicate_sharding"},
}
JAX_INITS = sorted(p.parent.relative_to(REPO / "preworld_tpu").as_posix()
                   for p in (REPO / "preworld_tpu").glob("*/__init__.py"))
# (channel-last input shape, sizes) of the interpolate_to cases
INTERP_CASES = [((2, 7, 3), (5,)), ((1, 5, 3), (12,)),
                ((1, 7, 5, 3), (5, 12)), ((1, 7, 5, 7, 2), (5, 12, 4))]
RESNET = dict(num_layer=(1, 2, 1), num_channels=(8, 16, 32),
              stride=(1, 2, 2), backbone_output_ids=(0, 1, 2))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: parallel test workers on one host share its
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_all(package: str) -> list:
    """`__all__` of the JAX package's `package/__init__.py`, by ast."""
    tree = ast.parse((REPO / "preworld_tpu" / package /
                      "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


@pytest.mark.parametrize("package", JAX_INITS)
def test_every_jax_name_imports_from_the_port(package):
    import importlib

    names = jax_all(package)
    port = importlib.import_module(f"preworld_tpu_torch.{package}")
    left = LEAVE_BEHIND.get(package, set())
    assert left <= set(names), "a leave-behind name left the JAX __all__"
    missing = [n for n in names if n not in left and not hasattr(port, n)]
    assert not missing
    assert set(names) - left <= set(port.__all__)
    assert all(hasattr(port, n) for n in port.__all__)


def test_the_packages_load_no_jax_in_a_fresh_process():
    code = (
        "import sys\n"
        "for m in ('models', 'ops', 'geometry', 'parallel', 'utils'):\n"
        "    __import__('preworld_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'preworld_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _perturbed(tree, key):
    """BatchNorm scales and biases, means and variances moved off their
    init values (variances kept positive), so eval-mode BN is a sharp
    test of the bridge."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    keys = jax.random.split(key, len(leaves))
    out = []
    for (path, leaf), k in zip(leaves, keys):
        name = path[-1].key
        noise = jax.random.normal(k, leaf.shape, leaf.dtype)
        if name == "var":
            leaf = 0.5 + jax.random.uniform(k, leaf.shape, leaf.dtype)
        elif name in ("scale", "bias", "mean"):
            leaf = leaf + 0.1 * noise
        out.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, out)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX side of the parity tests, in one jitted program: the 2-D
    CustomResNet's init and eval-mode outputs, and every interpolate_to
    case with align_corners False and True."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 16, 16, 8)).astype(np.float32)
    interp_in = [rng.normal(size=s).astype(np.float32)
                 for s, _ in INTERP_CASES]
    model = JaxCustomResNet(**RESNET)

    def run(x, interp_in):
        variables = model.init(jax.random.PRNGKey(0), x)
        variables = {"params": _perturbed(variables["params"],
                                          jax.random.PRNGKey(1)),
                     "batch_stats": _perturbed(variables["batch_stats"],
                                               jax.random.PRNGKey(2))}
        outs = model.apply(variables, x, train=False)
        interp = {(i, ac): jax_interpolate_to(v, sizes, align_corners=ac)
                  for i, (v, (_, sizes)) in enumerate(zip(interp_in,
                                                          INTERP_CASES))
                  for ac in (False, True)}
        return variables, outs, interp

    variables, outs, interp = jax.jit(run)(jnp.asarray(x),
                                           [jnp.asarray(v) for v in interp_in])
    return dict(x=x, interp_in=interp_in,
                variables=jax.tree_util.tree_map(np.asarray, variables),
                outs=[np.asarray(o) for o in outs],
                interp={k: np.asarray(v) for k, v in interp.items()})


def test_custom_resnet_2d_matches_jax(jax_runs):
    model = CustomResNet(8, **RESNET).eval()
    load_flax_params(model, jax_runs["variables"]["params"],
                     jax_runs["variables"]["batch_stats"])
    with torch.no_grad():
        outs = model(torch.from_numpy(jax_runs["x"]))
    assert len(outs) == len(jax_runs["outs"]) == 3
    for got, want in zip(outs, jax_runs["outs"]):
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert [o.shape for o in outs] == [(1, 16, 16, 8), (1, 8, 8, 16),
                                       (1, 4, 4, 32)]
    assert model.layer0_block0.conv1.Conv_0.weight.dim() == 4


def _cna_keys(prefix: str) -> list:
    return [f"{prefix}.Conv_0.weight"] + [
        f"{prefix}.BatchNorm_0.{leaf}" for leaf in (
            "weight", "bias", "running_mean", "running_var",
            "num_batches_tracked")]


def test_custom_resnet3d_names_are_unchanged():
    """CustomResNet3D's constructor and state_dict keys, in order, as they
    were before it became CustomResNet with ndim 3: the bridge, the
    checkpoints and `utils/torch_port.py::_custom_resnet3d` rely on them."""
    model = CustomResNet3D(4, num_layer=(1, 2), num_channels=(8, 16),
                           stride=(1, 2), backbone_output_ids=(0, 1))
    want = []
    for block, down in (("layer0_block0", True), ("layer1_block0", True),
                        ("layer1_block1", False)):
        for conv in (["downsample"] if down else []) + ["conv1", "conv2"]:
            want += _cna_keys(f"{block}.{conv}")
    state = model.state_dict()
    assert list(state) == want
    assert state["layer1_block0.downsample.Conv_0.weight"].shape == (
        16, 8, 3, 3, 3)
    out = model(torch.zeros(1, 4, 4, 2, 4))
    assert [o.shape for o in out] == [(1, 4, 4, 2, 8), (1, 2, 2, 1, 16)]


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("case", range(len(INTERP_CASES)))
def test_interpolate_to_matches_jax(jax_runs, case, align_corners):
    x = torch.from_numpy(jax_runs["interp_in"][case])
    sizes = INTERP_CASES[case][1]
    got = interpolate_to(x, sizes, align_corners=align_corners).numpy()
    want = jax_runs["interp"][(case, align_corners)]
    assert got.shape == want.shape == (x.shape[0], *sizes, x.shape[-1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _bev_pool_inputs(seed: int = 0, num_voxels: int = 40):
    rng = np.random.default_rng(seed)
    B, N, D, H, W, C = 1, 2, 3, 2, 4, 5
    depth = rng.uniform(size=(B, N, D, H, W)).astype(np.float32)
    feat = rng.normal(size=(B, N, H, W, C)).astype(np.float32)
    vox = rng.integers(0, num_voxels + 1, (B, N, D, H, W)).astype(np.int32)
    vox.reshape(-1)[:6] = num_voxels  # out of range: dropped by both
    pix = rng.integers(0, B * N * H * W, (B, N, D, H, W)).astype(np.int32)
    return depth, feat, vox, pix, num_voxels


def test_bev_pool_dense_oracle_matches_jax_and_bev_pool():
    depth, feat, vox, pix, nv = _bev_pool_inputs()
    want = jax_bev_pool_dense_oracle(depth, feat, vox, pix, nv)
    got = bev_pool_dense_oracle(depth, feat, vox, pix, nv)
    assert got.dtype == np.float64 and got.shape == (nv, feat.shape[-1])
    np.testing.assert_array_equal(got, want)
    tensors = [torch.from_numpy(a) for a in (depth, feat, vox, pix)]
    np.testing.assert_array_equal(bev_pool_dense_oracle(*tensors, nv), want)
    pooled = bev_pool(*tensors, nv).numpy()
    np.testing.assert_allclose(pooled, want, rtol=1e-5, atol=1e-6)
    assert np.abs(want).sum() > 0


def _torch_style_state(rng) -> dict:
    """A conv with bias, its BN, a linear and an LN, as a torch state dict
    of numpy arrays."""
    return {
        "neck.conv.weight": rng.normal(size=(8, 4, 3, 3)).astype(np.float32),
        "neck.conv.bias": rng.normal(size=(8,)).astype(np.float32),
        "neck.bn.weight": rng.normal(size=(8,)).astype(np.float32),
        "neck.bn.bias": rng.normal(size=(8,)).astype(np.float32),
        "neck.bn.running_mean": rng.normal(size=(8,)).astype(np.float32),
        "neck.bn.running_var": rng.uniform(0.5, 1.5, (8,)).astype(np.float32),
        "head.fc.weight": rng.normal(size=(3, 8)).astype(np.float32),
        "head.fc.bias": rng.normal(size=(3,)).astype(np.float32),
        "head.ln.weight": rng.normal(size=(8,)).astype(np.float32),
        "head.ln.bias": rng.normal(size=(8,)).astype(np.float32),
    }


KEY_MAP = {"neck.conv": ("neck", "Conv_0"), "neck.bn": ("neck", "BatchNorm_0"),
           "head.fc": ("head", "Dense_0"), "head.ln": ("head", "LayerNorm_0"),
           "head.absent": ("head", "Dense_1")}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_convert_conv_bn_sequences_matches_jax():
    state = _torch_style_state(np.random.default_rng(0))
    got = convert_conv_bn_sequences(state, KEY_MAP)
    want = jax_torch_port.convert_conv_bn_sequences(state, KEY_MAP)
    for g, w in zip(got, want):
        gl, wl = dict(_leaves(g)), dict(_leaves(w))
        assert list(gl) == list(wl)
        for k in wl:
            assert gl[k].dtype == wl[k].dtype
            np.testing.assert_array_equal(gl[k], wl[k], err_msg=str(k))
    params, stats = got
    assert params["neck"]["Conv_0"]["kernel"].shape == (3, 3, 4, 8)
    assert params["head"]["Dense_0"]["kernel"].shape == (8, 3)
    assert set(params["head"]["LayerNorm_0"]) == {"scale", "bias"}
    assert set(stats["neck"]["BatchNorm_0"]) == {"mean", "var"}


def test_verify_tree_shapes_matches_jax():
    params, _ = convert_conv_bn_sequences(
        _torch_style_state(np.random.default_rng(1)), KEY_MAP)
    template = {"neck": {"Conv_0": {"kernel": np.zeros((3, 3, 4, 8)),
                                    "bias": np.zeros(8)},
                         "BatchNorm_0": {"scale": np.zeros(8),
                                         "bias": np.zeros(7)}},
                "head": {"Dense_0": {"kernel": np.zeros((8, 3)),
                                     "bias": np.zeros(3)}}}
    got = verify_tree_shapes(template, params)
    want = jax_torch_port.verify_tree_shapes(template, params)
    assert got == want
    assert (("neck", "BatchNorm_0", "bias"), (7,), (8,)) in got
    assert (("head", "LayerNorm_0"), None, None) in got
    assert verify_tree_shapes(params, params) == []


# ------------------------------------------------------------ the bench line

def _jax_bench_keys() -> dict:
    """{metric: the keys of `bench.py`'s JSON dict of that metric}, by
    ast."""
    out = {}
    for node in ast.walk(ast.parse((REPO / "bench.py").read_text())):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "metric" in keys:
                metric = node.values[keys.index("metric")].value
                out[metric] = set(keys)
    return out


COUNT = {"flops": 9.6e12, "bytes": 2.3e10}
LAUNCHES = {"fused_swin_attn_block": 24}
TRAIN = {"pretrain_step_s": 1.5, "finetune_step_s": 0.4}
PORT_KEYS = {"card", "launches_per_request", "launches_per_streaming_step"}
# the four counts of a request, which the port's streaming line also
# carries for a streaming step
COUNT_KEYS = {"tflops_fwd", "mfu", "gb_accessed_fwd", "hbm_util"}


def _doc_keys() -> tuple:
    """(the docstring table's keys, the keys its `--streaming` sentence
    names)."""
    doc = bench.__doc__
    table = doc.split("then the port's own three:\n\n")[1].split("\n\n")[0]
    keys = re.findall(r"^  (\w+)  ", table, flags=re.M)
    sentence = doc.split("Under `--streaming` the line keeps")[1]
    sentence = sentence.split("\n\n")[0]
    return keys, re.findall(r"`(\w+)`", sentence)


def test_bench_line_has_bench_py_keys():
    jax_keys = _jax_bench_keys()
    line = bench.headline_line(12.5, COUNT, "H100, 700 W", LAUNCHES,
                               (20.0, LAUNCHES), TRAIN)
    assert set(line) == (jax_keys["6cam_occ_inference_fps"]
                         - {"train_bench_error"}) | PORT_KEYS
    assert line["metric"] == "6cam_occ_inference_fps"
    assert line["vs_baseline"] == round(12.5 / 8, 3) == 1.562
    assert line["baseline_assumed_fps"] == 4.0
    assert line["baseline_peg_source"].startswith("arXiv:2112.11790")
    assert line["streaming_fps"] == 20.0
    assert line["pretrain_step_s"] == 1.5 and line["finetune_step_s"] == 0.4
    assert line["tflops_fwd"] == 9.6 and line["mfu"] == 9.6e12 * 12.5 / 989e12
    doc_keys, _ = _doc_keys()
    assert len(doc_keys) == len(set(doc_keys)) and set(doc_keys) == set(line)


def test_streaming_bench_line_has_bench_py_keys():
    jax_keys = _jax_bench_keys()
    line = bench.headline_line(30.3, COUNT, "cpu", LAUNCHES)
    assert set(line) == (jax_keys["6cam_occ_streaming_fps"] | COUNT_KEYS
                         | {"card", "launches_per_streaming_step"})
    assert line["metric"] == "6cam_occ_streaming_fps"
    assert line["vs_baseline"] == round(30.3 / 8, 3)
    assert line["baseline_assumed_fps"] == 4.0
    assert line["launches_per_streaming_step"] == LAUNCHES
    _, doc_streaming = _doc_keys()
    assert set(doc_streaming) == set(line)


def test_bench_train_env_skips_the_train_steps(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a train step ran")

    monkeypatch.setattr(bench_parts, "bench_train_step", refuse)
    monkeypatch.setenv("PREWORLD_BENCH_TRAIN", "0")
    train = bench.train_step_seconds(torch.device("cpu"))
    assert train == {"pretrain_step_s": None, "finetune_step_s": None}
    line = bench.headline_line(12.5, COUNT, "cpu", LAUNCHES, (20.0, {}), train)
    assert line["pretrain_step_s"] is None and line["finetune_step_s"] is None
    calls = []
    monkeypatch.setattr(bench_parts, "bench_train_step",
                        lambda config, name, device: calls.append(
                            (config, name)) or [{"s": 0.25}])
    for value in ("1", None):
        calls.clear()
        if value is None:
            monkeypatch.delenv("PREWORLD_BENCH_TRAIN")
        else:
            monkeypatch.setenv("PREWORLD_BENCH_TRAIN", value)
        train = bench.train_step_seconds(torch.device("cpu"))
        assert train == {"pretrain_step_s": 0.25, "finetune_step_s": 0.25}
        assert calls == [(config, key)
                         for key, config in bench.TRAIN_CONFIGS.items()]


def test_bench_parts_batch_2(monkeypatch, capsys):
    """`bench_parts finetune_step --batch 2 --device cpu` with the tiny
    config's model in place of the flagship's: a synthetic batch of 2
    reaches the step, and the row is `finetune_train_step_b2`."""
    import preworld_tpu_torch.train as train
    from preworld_tpu_torch.data import tiny_config
    from preworld_tpu_torch.models import PreWorld

    read = []

    def tiny_model(cfg, device="cuda"):
        read.append(dict(cfg["model"]))
        return PreWorld(tiny_config(if_post_finetune=True, if_render=False,
                                    use_lss_depth_loss=False)).to(device)

    real_step = train.make_train_step
    batches = []

    def recording_step(*args, **kwargs):
        step = real_step(*args, **kwargs)

        def run(state, batch, gen):
            batches.append(tuple(batch["imgs"].shape))
            return step(state, batch, gen)

        return run

    monkeypatch.setattr(train, "build_model", tiny_model)
    monkeypatch.setattr(train, "make_train_step", recording_step)
    assert bench_parts.main(["finetune_step", "--batch", "2", "--device",
                             "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu"
    rows = [json.loads(ln) for ln in lines[1:]]
    assert [r["stage"] for r in rows] == ["finetune_train_step_b2"]
    assert rows[0]["s"] > 0
    assert read and read[0]["if_post_finetune"]
    assert len(batches) == 4 and all(b[0] == 2 for b in batches)
