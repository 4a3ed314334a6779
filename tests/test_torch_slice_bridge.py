"""The port's weight bridge, synthetic batch, config and import rules.

  * every leaf of a JAX PreWorld params + batch_stats tree maps to exactly
    one port tensor of the right shape, and no port tensor is left
    unmapped (tiny, tiny-Swin and the flagship Swin-B configs, from shapes
    alone);
  * the port's `synthetic_batch` equals the JAX one, array for array;
  * the port's configs keep the JAX fields and defaults;
  * every `preworld_tpu_torch` module imports with `jax` blocked, and none
    imports `preworld_tpu`.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preworld_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from preworld_tpu.data.synthetic import tiny_config as jax_tiny_config
from preworld_tpu.geometry.frustum import GridConfig as JaxGridConfig
from preworld_tpu.models import PreWorld as JaxPreWorld
from preworld_tpu.models import PreWorldConfig as JaxPreWorldConfig
from preworld_tpu_torch.data import synthetic_batch, tiny_config
from preworld_tpu_torch.geometry import GridConfig
from preworld_tpu_torch.models import PreWorld, PreWorldConfig
from preworld_tpu_torch.utils import load_flax_params
from preworld_tpu_torch.utils.flax_bridge import torch_name

REPO = Path(__file__).resolve().parent.parent
SWIN = dict(backbone="swin", swin_embed_dims=16, swin_depths=(1, 1, 1, 1),
            swin_num_heads=(1, 2, 4, 8), swin_window=4)
HEAD_FLAGS = dict(if_post_finetune=True, if_render=False,
                  use_lss_depth_loss=False)
# JAX PreWorldConfig fields the port leaves out
TRAINING_FIELDS = set()
# JAX NerfHeadConfig fields that tune the TPU corner-table gather, whose
# result they leave unchanged; the port samples with F.grid_sample
TPU_NERF_FIELDS = {"table_dtype", "bwd_live_cap"}


def _heads(m, b):
    vf, _ = m.extract_voxel_feat(b, train=False)
    density, semantic, _ = m.predict_attributes(vf)
    return m.occupancy_logits(vf, train=False), density, semantic


def _configs(name):
    if name == "flagship":
        return (JaxPreWorldConfig(**HEAD_FLAGS),
                PreWorldConfig(if_post_finetune=True))
    over = dict(SWIN if name == "swin" else {}, **HEAD_FLAGS)
    pover = {k: v for k, v in over.items()
             if k not in ("if_render", "use_lss_depth_loss")}
    return jax_tiny_config(**over), tiny_config(**pover)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _torch_shape(path, shape):
    """Flax leaf shape -> PyTorch tensor shape (Dense (in, out) -> (out, in);
    conv (*k, in, out) -> (out, in, *k))."""
    if path[-1] != "kernel":
        return tuple(shape)
    if len(shape) == 2:
        return tuple(shape[::-1])
    return (shape[-1], shape[-2]) + tuple(shape[:-2])


@pytest.mark.parametrize("name", ["tiny", "swin", "flagship"])
def test_every_leaf_maps_to_one_port_tensor(name):
    jcfg, pcfg = _configs(name)
    B, T, N = 1, jcfg.num_frames, jcfg.num_cams
    H, W = jcfg.input_size

    def sds(*shape):
        return jax.ShapeDtypeStruct(shape, jnp.float32)

    batch = {"imgs": sds(B, T, N, H, W, 3),
             "sensor2egos": sds(B, T, N, 4, 4),
             "ego2globals": sds(B, T, N, 4, 4),
             "intrins": sds(B, T, N, 3, 3), "post_rots": sds(B, T, N, 3, 3),
             "post_trans": sds(B, T, N, 3), "bda": sds(B, 3, 3)}
    model = JaxPreWorld(jcfg)
    shapes = jax.eval_shape(
        lambda b: model.init({"params": jax.random.PRNGKey(0)}, b,
                             method=_heads), batch)
    mapped = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _leaves(shapes[coll]):
            tname = torch_name(path)
            assert tname not in mapped, f"two leaves map to {tname}"
            mapped[tname] = _torch_shape(path, leaf.shape)

    with torch.device("meta"):
        port = PreWorld(pcfg)
    state = {k: tuple(v.shape) for k, v in port.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    assert sorted(set(mapped) - set(state)) == []  # no leaf left over
    assert sorted(set(state) - set(mapped)) == []  # no tensor unmapped
    bad = {k: (mapped[k], state[k]) for k in state if mapped[k] != state[k]}
    assert bad == {}


def test_load_flax_params_values_and_strictness():
    jcfg, pcfg = _configs("tiny")
    jb = {k: jnp.asarray(v) for k, v in jax_synthetic_batch(
        jcfg, 1, 16, seed=0, with_labels=False).items()}
    variables = jax.jit(lambda b: JaxPreWorld(jcfg).init(
        {"params": jax.random.PRNGKey(0)}, b, method=_heads))(jb)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.5, variables["batch_stats"])
    port = PreWorld(pcfg)
    load_flax_params(port, params, stats)
    sd = port.state_dict()
    conv = params["img_neck"]["conv0"]["Conv_0"]["kernel"]  # HWIO
    np.testing.assert_array_equal(sd["img_neck.conv0.Conv_0.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    dense = params["occupancy_head"]["occ_conv"]["Conv_0"]["kernel"]  # DHWIO
    np.testing.assert_array_equal(
        sd["occupancy_head.occ_conv.Conv_0.weight"].numpy(),
        dense.transpose(4, 3, 0, 1, 2))
    mlp = params["density_mlp"]["Dense_0"]["kernel"]  # (in, out)
    np.testing.assert_array_equal(sd["density_mlp.Dense_0.weight"].numpy(),
                                  mlp.T)
    var = stats["pre_process"]["layer0_block0"]["conv1"]["BatchNorm_0"]["var"]
    np.testing.assert_array_equal(
        sd["pre_process.layer0_block0.conv1.BatchNorm_0.running_var"].numpy(),
        var)

    partial = dict(params)
    partial.pop("color_mlp")
    with pytest.raises(KeyError, match="no flax leaf"):
        load_flax_params(PreWorld(pcfg), partial, stats)


@pytest.mark.parametrize("name,batch_size,seed",
                         [("tiny", 1, 0), ("swin", 2, 3)])
def test_synthetic_batch_matches_jax(name, batch_size, seed):
    jcfg, pcfg = _configs(name)
    want = jax_synthetic_batch(jcfg, batch_size, seed=seed, with_labels=False)
    got = synthetic_batch(pcfg, batch_size, seed=seed)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_configs_keep_jax_fields_and_defaults():
    grid_fields = {f.name for f in dataclasses.fields(JaxGridConfig)}
    assert {f.name for f in dataclasses.fields(GridConfig)} == grid_fields
    for f in grid_fields:
        assert getattr(GridConfig(), f) == getattr(JaxGridConfig(), f)
    jax_fields = {f.name for f in dataclasses.fields(JaxPreWorldConfig)}
    port_fields = {f.name for f in dataclasses.fields(PreWorldConfig)}
    assert port_fields == jax_fields - TRAINING_FIELDS
    jdef, pdef = JaxPreWorldConfig(), PreWorldConfig()
    for f in port_fields - {"grid", "dtype", "nerf"}:
        assert getattr(pdef, f) == getattr(jdef, f), f
    assert pdef.dtype == torch.float32 and jdef.dtype == jnp.float32
    assert pdef.num_frames == jdef.num_frames
    nerf_fields = {f.name for f in dataclasses.fields(jdef.nerf)}
    assert {f.name for f in dataclasses.fields(pdef.nerf)} == \
        nerf_fields - TPU_NERF_FIELDS
    for f in nerf_fields - TPU_NERF_FIELDS - {"spec"}:
        assert getattr(pdef.nerf, f) == getattr(jdef.nerf, f), f
    assert dataclasses.asdict(pdef.nerf.spec) == dataclasses.asdict(
        jdef.nerf.spec)
    spec, jspec = pdef.nerf.spec, jdef.nerf.spec
    for prop in ("bg_len", "num_inner", "num_outer", "num_samples",
                 "act_shift", "dist_thres"):
        assert getattr(spec, prop) == getattr(jspec, prop), prop
    for prop in ("scene_center", "t_midpoints", "xyz_min", "xyz_max"):
        np.testing.assert_array_equal(getattr(spec, prop),
                                      getattr(jspec, prop), err_msg=prop)


def test_port_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'flax', 'preworld_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import preworld_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "importlib.import_module('chip_smoke')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'preworld_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 35


def test_bench_parts_stages_run_on_the_cpu():
    """The port's per-stage bench at small shapes with `--device cpu`
    semantics: each stage row under the JAX tool's keys, a positive time;
    no card is an error, never a fallback."""
    from preworld_tpu_torch.tools import bench_parts

    cpu = torch.device("cpu")
    rows = bench_parts.bench_cost_volume(cpu, BN=1, H=8, W=32, C=128, D=4)
    rows += bench_parts.bench_nerf(cpu, R=32, X=8, Y=8, Z=4)
    assert [r["stage"] for r in rows] == [
        "cost_volume_plain", "cost_volume_fused", "nerf_render_fwd",
        "nerf_render_bwd"]
    assert all(r["ms"] > 0 for r in rows)
    assert bench_parts.card_line(cpu) == "cpu"
    if not torch.cuda.is_available():
        assert bench_parts.main(["cost_volume"]) == 2


def test_tree_turns_needs_trees_and_a_card():
    """The turns tool prints its usage without trees and, with no card,
    fails rather than time anything on the CPU."""
    from preworld_tpu_torch.tools import tree_turns

    assert tree_turns.main([]) == 2
    if not torch.cuda.is_available():
        assert tree_turns.main(["."]) == 2
