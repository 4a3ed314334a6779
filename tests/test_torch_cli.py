"""The port's command-line entry points (`preworld_tpu_torch/tools/`:
train, test, test_temporal, convert_torch_checkpoint) on tiny configs on
the CPU, and the two utilities they add: the conv + BatchNorm fold and the
torch checkpoint key maps, each against the JAX package.

Tiny configs are written per test: the repo's config files as `_base_`,
with the tiny backbone, a 20x20x8 grid, 2 cameras at 64x128 and f32
(`data/synthetic.py::tiny_config`'s sizes). Each CLI runs in-process through
its `main(argv)` with `--device cpu` and returns what it prints.

Tolerances. The fold is exact in real arithmetic; in f32 the folded conv
is held to its unfolded eval forward at rtol / atol 2e-5 (the JAX test's),
and the folded numbers to the JAX fold's at rtol 1e-6. The key maps and
the converted arrays are compared for equality.
"""

import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from preworld_tpu.utils import torch_port as jax_torch_port
from preworld_tpu.utils.fold_bn import fold_conv_bn as jax_fold_conv_bn
from preworld_tpu_torch.data import synthetic_batch, tiny_config, to_device
from preworld_tpu_torch.models import PreWorld
from preworld_tpu_torch.models.layers import ConvNormAct
from preworld_tpu_torch.tools import convert_torch_checkpoint as cli_convert
from preworld_tpu_torch.tools import test as cli_test
from preworld_tpu_torch.tools import test_temporal as cli_temporal
from preworld_tpu_torch.tools import train as cli_train
from preworld_tpu_torch.utils import (
    flax_to_torch_state,
    fold_conv_bn,
    fold_model_conv_bn,
    init_weights,
    torch_port,
)
from test_torch_port import (  # noqa: F401  (fixture)
    _get,
    _walk,
    inverse_swin_key,
    template_tree,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = """
_base_ = ["{base}"]
data_config = dict(input_size=(64, 128), Ncams=2)
grid_config = dict(x=[-8.0, 8.0, 0.8], y=[-8.0, 8.0, 0.8],
                   z=[-1.0, 5.4, 0.8], depth=[1.0, 9.0, 0.5])
model = dict(type="{type}", backbone="tiny", neck_out_channels=64,
             num_trans_channels=16, out_dim=16, dtype="float32",
             remat={remat})
data = dict(samples_per_gpu=1, workers_per_gpu=1,
            train=dict(max_ray_nums=64))
log_interval = 1
"""
# `tests/test_torch_port.py`'s small Swin config as a config file (its 88
# depth bins; a small grid)
SMALL_SWIN = """
_base_ = ["{base}"]
data_config = dict(input_size=(64, 128), Ncams=1)
grid_config = dict(x=[-8.0, 8.0, 0.8], y=[-8.0, 8.0, 0.8],
                   z=[-1.0, 5.4, 0.8], depth=[1.0, 45.0, 0.5])
model = dict(swin=dict(embed_dims=16, depths=(1, 1, 1, 1),
                       num_heads=(1, 2, 4, 8), window_size=4),
             neck_out_channels=24, num_trans_channels=8, out_dim=8,
             dtype="float32", remat=False)
data = dict(samples_per_gpu=1, workers_per_gpu=1)
"""
FINETUNE = "configs/preworld/preworld_7frame_finetune.py"
FINETUNE_TRAJ = "configs/preworld/preworld_7frame_finetune_traj.py"


def write_config(tmp_path, name, text=TINY, base=FINETUNE_TRAJ,
                 mtype="PreWorld4DTraj", remat=False):
    path = tmp_path / f"{name}.py"
    path.write_text(text.format(base=os.path.join(REPO, base), type=mtype,
                                remat=remat))
    return str(path)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the tiny shapes gain nothing from more, and
    parallel test workers on one host share its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------- CLIs

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`train --synthetic --epochs 1 --max-iters 2` on the tiny traj
    config (remat on): its result and work dir."""
    tmp = tmp_path_factory.mktemp("train")
    cfg = write_config(tmp, "traj_tiny", remat=True)
    work = str(tmp / "work")
    result = cli_train.main([cfg, "--work-dir", work, "--synthetic", "--epochs",
                         "1", "--max-iters", "2", "--device", "cpu"])
    return cfg, work, result


def test_train_cli_traj(trained):
    """Two curriculum steps (epoch 0: num_future 2), a checkpoint at step
    2 that holds the EMA, and the JAX loop's per-iteration records."""
    cfg, work, result = trained
    assert result["step"] == 2 and result["work_dir"] == work
    assert os.path.basename(result["checkpoint"]) == "2.pt"
    m = result["metrics"]
    assert "loss_traj_2s" in m and "loss_voxel_ce_0s" in m
    assert not any(k.endswith("_3s") for k in m)
    assert all(np.isfinite(v) for v in m.values())
    ckpt = torch.load(result["checkpoint"], weights_only=True)
    assert ckpt["step"] == 2 and "plan_head.fc1.weight" in ckpt["ema_params"]
    with open(os.path.join(work, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    assert [r["iter"] for r in recs] == [1, 2]


def test_train_cli_resumes(trained, tmp_path):
    """`--auto-resume` restores the saved state and trains on: step 3."""
    cfg, work, _ = trained
    copy = tmp_path / "work"
    os.makedirs(copy / "checkpoints")
    with open(os.path.join(work, "checkpoints", "2.pt"), "rb") as src:
        (copy / "checkpoints" / "2.pt").write_bytes(src.read())
    result = cli_train.main([cfg, "--work-dir", str(copy), "--synthetic",
                         "--auto-resume", "--epochs", "1", "--max-iters", "1",
                         "--device", "cpu"])
    assert result["step"] == 3


def test_train_cli_finetune_validates(tmp_path):
    """The PreWorld finetune config with `--validate`: an mIoU record after
    the epoch."""
    cfg = write_config(tmp_path, "finetune_tiny", base=FINETUNE,
                       mtype="PreWorld")
    work = str(tmp_path / "work")
    result = cli_train.main([cfg, "--work-dir", work, "--synthetic", "--epochs",
                         "1", "--max-iters", "1", "--validate",
                         "--val-samples", "2", "--device", "cpu"])
    assert result["step"] == 1 and "loss_voxel_ce" in result["metrics"]
    with open(os.path.join(work, "metrics.jsonl")) as fh:
        evals = [json.loads(line) for line in fh if '"eval"' in line]
    assert evals and evals[0]["eval"]["count"] == 2


@pytest.mark.parametrize("protocol", ["reference", "aligned"])
def test_test_temporal_cli(trained, capsys, protocol):
    """The 4-D protocol on 2 synthetic samples from the trained work dir:
    the EMA's scores, equal to `evaluate_miou_temporal` run directly on
    the checkpoint."""
    from preworld_tpu_torch.train import (
        create_train_state,
        evaluate_miou_temporal,
        make_optimizer,
        maybe_resume,
    )
    from preworld_tpu_torch.utils import Config

    cfg, work, _ = trained
    got = cli_temporal.main([cfg, work, "--synthetic", "--num-samples", "2",
                              "--protocol", protocol, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(got))
    assert got["count"] == 2 and set(got) >= {"mIoU_0s", "mIoU_3s"}

    from preworld_tpu_torch.train import build_model

    model = build_model(Config.fromfile(cfg), device="cpu")
    state, resumed = maybe_resume(
        create_train_state(model, make_optimizer(model.parameters())), work)
    assert resumed and state.step == 2
    samples = []
    for i in range(2):
        s = {k: v[0] for k, v in synthetic_batch(
            model.cfg, 1, 256, seed=i, with_traj=True).items()}
        for h, f in zip((0, 1, 2, 3), (0, 2, 4, 6)):
            s[f"gt_h{h}"] = (s["temporal_semantics"][f - 1] if f > 0
                             else s["voxel_semantics"])
        samples.append(s)
    steps = cli_temporal.PROTOCOLS[protocol]
    want = evaluate_miou_temporal(model, state, samples, rollout_steps=steps,
                                  device="cpu")
    assert json.dumps(got) == json.dumps(want)


def test_test_cli_fused_and_aavt(tmp_path, capsys):
    """`test --synthetic --fuse-conv-bn --eval miou fscore --out DIR` on the
    tiny finetune config: mIoU and F-score over 3 samples at batch 2, one
    dump each; the same scores as the unfolded run with and without the
    adjacent frame's alignment (the fold is exact and this model's
    predictions are far from ties), each printed as JSON."""
    cfg = write_config(tmp_path, "finetune_tiny", base=FINETUNE,
                       mtype="PreWorld")
    out = tmp_path / "preds"
    common = [cfg, "--synthetic", "--num-samples", "3", "--batch-size", "2",
              "--eval", "miou", "fscore", "--device", "cpu"]
    fused = cli_test.main(common + ["--fuse-conv-bn", "--out", str(out)])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(printed) == json.loads(json.dumps(fused))
    assert fused["count"] == 3 and "fscore" in fused
    assert sorted(os.listdir(out)) == [f"{i:06d}.npz" for i in range(3)]
    plain = cli_test.main(common)
    assert fused["mIoU"] == plain["mIoU"]
    assert cli_test.main(common + ["--no-aavt"])["count"] == 3


@pytest.mark.parametrize("cli", ["train", "test", "test_temporal"])
def test_cli_refuses_without_a_card(tmp_path, monkeypatch, cli):
    """No card and no `--device cpu`: the CLI raises before building
    anything; there is no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"train": cli_train, "test": cli_test,
           "test_temporal": cli_temporal}
    cfg = write_config(tmp_path, "traj_tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod[cli].main([cfg, "--synthetic"])


def test_cli_modules_import_no_jax():
    """The four CLIs import nothing of JAX or the JAX package."""
    import subprocess

    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'preworld_tpu'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from preworld_tpu_torch.tools import convert_torch_checkpoint, "
        "test, test_temporal, train\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


# ------------------------------------------------------------- fold_bn

def test_fold_conv_bn_biased_conv_exact():
    """A ConvNormAct with a conv bias, every fold term non-trivial: the
    folded eval forward equals the unfolded one, and the folded numbers
    equal the JAX fold's on the same tree."""
    rng = np.random.default_rng(1)
    m = ConvNormAct(4, 8, 3, use_bias=True, act=None).eval()
    with torch.no_grad():
        m.Conv_0.weight.copy_(torch.from_numpy(
            rng.normal(0, 0.3, (8, 4, 3, 3)).astype(np.float32)))
        m.Conv_0.bias.copy_(torch.from_numpy(
            rng.normal(size=8).astype(np.float32)))
        bn = m.BatchNorm_0
        bn.weight.copy_(torch.from_numpy(
            (1.0 + 0.3 * rng.normal(size=8)).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(size=8).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(
            rng.normal(size=8).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(
            (0.5 + rng.uniform(size=8)).astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(2, 6, 6, 4)).astype(np.float32))
    with torch.no_grad():
        ref = m(x)
    params = {n: p.detach().clone() for n, p in m.named_parameters()}
    buffers = dict(m.named_buffers())
    fp, fb = fold_conv_bn(params, buffers)

    jp = {"Conv_0": {"kernel": np.transpose(params["Conv_0.weight"].numpy(),
                                            (2, 3, 1, 0)),
                     "bias": params["Conv_0.bias"].numpy()},
          "BatchNorm_0": {"scale": params["BatchNorm_0.weight"].numpy(),
                          "bias": params["BatchNorm_0.bias"].numpy()}}
    js = {"BatchNorm_0": {"mean": buffers["BatchNorm_0.running_mean"].numpy(),
                          "var": buffers["BatchNorm_0.running_var"].numpy()}}
    want = flax_to_torch_state(*jax_fold_conv_bn(jp, js))
    for k, v in want.items():
        got = (fp.get(k) if k in fp else fb[k]).numpy()
        np.testing.assert_allclose(got, np.asarray(v), rtol=1e-6, atol=1e-7,
                                   err_msg=k)

    folded = fold_model_conv_bn(m)
    assert float(folded["Conv_0.bias"].abs().max()) == 0.0
    with torch.no_grad():
        out = m(x)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_fold_model_keeps_the_eval_function():
    """Every ConvNormAct of the tiny model folded: the same occupancy
    logits in eval mode (atol 1e-4, logits of order 1)."""
    model = PreWorld(tiny_config(if_post_finetune=True, if_render=False,
                                 use_lss_depth_loss=False)).eval()
    init_weights(model, seed=3, fan_in=True)
    batch = to_device(synthetic_batch(model.cfg, 1, with_labels=False),
                      "cpu")
    with torch.no_grad():
        ref = model.occupancy_logits(model.extract_voxel_feat(batch)[0])
        fold_model_conv_bn(model)
        got = model.occupancy_logits(model.extract_voxel_feat(batch)[0])
    bns = [mod.BatchNorm_0 for mod in model.modules()
           if isinstance(mod, ConvNormAct) and mod.norm == "bn"]
    assert bns and all(float(b.running_mean.abs().max()) == 0.0 for b in bns)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-4)


# ---------------------------------------------------- checkpoint key maps

def reference_state_dict(shapes):
    """`tests/test_torch_port.py`'s synthetic mmcv state dict over the
    small Swin config's tree: Swin tensors N(0, 1), the rest zeros and
    ones by kind."""
    params_t, stats_t = shapes["params"], shapes.get("batch_stats", {})
    sd = {}
    rng = np.random.default_rng(0)
    for path, leaf in _walk(params_t["img_backbone"]):
        shape = leaf.shape
        if path[-1] == "kernel":
            shape = ((shape[1], shape[0]) if len(shape) == 2
                     else (shape[-1], shape[-2]) + tuple(shape[:-2]))
        sd["img_backbone." + inverse_swin_key(path)] = rng.normal(
            size=shape).astype(np.float32)
    for tprefix, (fpath, kind) in jax_torch_port.full_model_key_map().items():
        sub = _get(params_t, fpath)
        if sub is None:
            continue
        if kind == "bn":
            bsub = _get(stats_t, fpath)
            sd[tprefix + ".weight"] = rng.normal(
                1.0, 0.1, sub["scale"].shape).astype(np.float32)
            sd[tprefix + ".bias"] = np.zeros(sub["bias"].shape, np.float32)
            sd[tprefix + ".running_mean"] = np.zeros(bsub["mean"].shape,
                                                     np.float32)
            sd[tprefix + ".running_var"] = np.ones(bsub["var"].shape,
                                                   np.float32)
            continue
        ks = sub["kernel"].shape
        tshape = {"conv": lambda: (ks[-1], ks[-2]) + tuple(ks[:-2]),
                  "linear": lambda: (ks[1], ks[0]),
                  "dense1x1": lambda: (ks[1], ks[0], 1, 1)}[kind]()
        sd[tprefix + ".weight"] = rng.normal(0, 0.1, tshape).astype(
            np.float32)
        if "bias" in sub:
            sd[tprefix + ".bias"] = np.zeros(sub["bias"].shape, np.float32)
    return sd


def assert_trees_equal(a, b):
    fa = dict(jax_torch_port_walk(a))
    fb = dict(jax_torch_port_walk(b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert np.asarray(fa[k]).tobytes() == np.asarray(fb[k]).tobytes(), k


def jax_torch_port_walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from jax_torch_port_walk(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.fixture(scope="module")
def state_dict(template_tree):
    return reference_state_dict(template_tree[3])


def test_key_maps_match_jax(state_dict):
    """`swin_key_map` on every Swin key, `full_model_key_map`, and the
    converted trees of `convert_full_model`, equal to the JAX package's."""
    for k in state_dict:
        if k.startswith("img_backbone."):
            key = k[len("img_backbone."):]
            assert torch_port.swin_key_map(key) == \
                jax_torch_port.swin_key_map(key), key
    assert torch_port.full_model_key_map() == \
        jax_torch_port.full_model_key_map()
    got = torch_port.convert_full_model(state_dict)
    want = jax_torch_port.convert_full_model(state_dict)
    for g, w in zip(got, want):
        assert_trees_equal(g, w)
    dst = {"a": {"b": 1, "c": 2}, "d": 3}
    src = {"a": {"b": 5}, "e": 6}
    assert torch_port.merge_trees(dst, src) == \
        jax_torch_port.merge_trees(dst, src)


def test_convert_cli_writes_the_jax_pickle(state_dict, tmp_path):
    """The port's converter on a torch checkpoint writes the pickle the JAX
    converter writes (the same trees, byte for byte)."""
    pth = tmp_path / "ckpt.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in state_dict.items()}}, pth)
    out = tmp_path / "port.pkl"
    res = cli_convert.main([str(pth), str(out), "--report"])
    with open(out, "rb") as fh:
        got = pickle.load(fh)
    params, stats = jax_torch_port.convert_full_model(state_dict)
    assert_trees_equal(got["params"], params)
    assert_trees_equal(got["batch_stats"], stats)
    assert res["tensors"] == len(list(jax_torch_port_walk(params)))


def test_load_from_overlays_non_strictly(state_dict, tmp_path):
    """`train --load-from` on the small Swin config: every converted
    tensor lands on its port tensor (none left over), the tensors the
    checkpoint lacks (the heads) keep the seeded init, and the EMA starts
    from the overlaid weights."""
    from preworld_tpu_torch.train import build_model
    from preworld_tpu_torch.utils import Config

    pth = tmp_path / "ckpt.pth"
    torch.save({k: torch.from_numpy(v) for k, v in state_dict.items()}, pth)
    pkl = str(tmp_path / "ported.pkl")
    cli_convert.main([str(pth), pkl])
    with open(pkl, "rb") as fh:
        ported = pickle.load(fh)
    flat = flax_to_torch_state(ported["params"], ported["batch_stats"])

    cfg = write_config(tmp_path, "small_swin", SMALL_SWIN, base=FINETUNE)
    torch.manual_seed(0)
    fresh = build_model(Config.fromfile(cfg), device="cpu").state_dict()
    loaded, unexpected = torch_port.overlay_flax_params(
        build_model(Config.fromfile(cfg), device="cpu"), ported["params"],
        ported["batch_stats"])
    assert not unexpected and sorted(loaded) == sorted(flat)
    assert any(k.startswith("img_backbone.") for k in loaded)

    work = str(tmp_path / "work")
    result = cli_train.main([cfg, "--work-dir", work, "--synthetic", "--epochs",
                         "1", "--max-iters", "0", "--load-from", pkl,
                         "--device", "cpu"])
    ckpt = torch.load(result["checkpoint"], weights_only=True)
    assert ckpt["step"] == 0
    for k, v in flat.items():
        np.testing.assert_array_equal(ckpt["model"][k].numpy(), v, err_msg=k)
        if k in ckpt["ema_params"]:
            np.testing.assert_array_equal(ckpt["ema_params"][k].numpy(), v)
    kept = [k for k in fresh if k not in flat]
    assert any(k.startswith("occupancy_head.") for k in kept)
    for k in kept:
        assert torch.equal(ckpt["model"][k], fresh[k]), k
