"""The port's offline data tools against the JAX ones, on the CPU:
`preworld_tpu_torch.tools.{create_data,gen_depth_gt,gen_seg_gt,
precompute_rays}` against `tools/{create_data,gen_depth_gt,gen_seg_gt,
precompute_rays}.py` on `tests/test_offline_chain.py`'s raw nuScenes
layout (JSON tables, 1600x900 JPEGs, lidar sweeps, lidarseg labels).

The JAX CLIs run in-process (`conftest.run_cli`), the port's through their
`main(argv)`, into separate directories; both pools get 2 workers. Every
comparison is exact: the info pkls deep-equal, each depth / seg `.bin`
byte-equal, each ray cache's `rays` array equal (`np.savez_compressed`
stamps the time into the zip, so the files themselves differ), and the
port's dataset on the port's files gives the JAX dataset's sample on the
JAX files byte for byte, with and without `ray_cache_path`.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import preworld_tpu.data.native as jax_native
from conftest import run_cli
from preworld_tpu.data.nuscenes import NuScenesOccDataset as JaxNuScenes
from preworld_tpu_torch.data import NuScenesOccDataset
from preworld_tpu_torch.tools import (
    create_data,
    gen_depth_gt,
    gen_seg_gt,
    precompute_rays,
)
from test_offline_chain import CAMS, N_SAMPLES, build_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
VERSION = "v1.0-mini"
# the dataset settings of tests/test_offline_chain.py
DATA_CONFIG = dict(
    cams=list(CAMS), input_size=(64, 128), resize=(-0.06, 0.11),
    crop_h=(0.0, 0.0), flip=True, rot=(-5.4, 5.4), resize_test=0.0, Ncams=6)
GRID_CONFIG = dict(x=[-8.0, 8.0, 0.8], y=[-8.0, 8.0, 0.8],
                   z=[-1.0, 5.4, 0.8], depth=[1.0, 9.0, 0.5])


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: parallel test workers on one host share its
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_both(jax_tool, port_main, argv_of):
    """The JAX CLI with argv_of("jax"), the port's with argv_of("port");
    returns what the port's main returned."""
    run_cli(os.path.join(TOOLS, jax_tool), argv_of("jax"))
    return port_main(argv_of("port"))


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The raw layout, then both packages' create_data, gen_depth_gt,
    gen_seg_gt and precompute_rays into their own output paths:
    {"root": ..., "<side>_<what>": path} for side jax / port."""
    tmp = tmp_path_factory.mktemp("chain")
    root = str(tmp / "nusc")
    os.makedirs(root)
    build_fixture(root)
    out = {"root": root, "tmp": tmp}
    for side in ("jax", "port"):
        out[f"{side}_ann"] = os.path.join(
            root, f"{side}-nuscenes_infos_train.pkl")
        for what in ("depth", "seg", "rays"):
            out[f"{side}_{what}"] = str(tmp / f"{side}_{what}")
    run_both("create_data.py", create_data.main, lambda side: [
        "--root-path", root, "--version", VERSION, "--occ-gt-root", "gts",
        "--out-prefix", side, "--train-scenes", "scene-0001",
        "--val-scenes", "scene-0001"])
    out["depth_points"] = run_both(
        "gen_depth_gt.py", gen_depth_gt.main, lambda side: [
            "--ann-file", out[f"{side}_ann"], "--data-root", root,
            "--out-dir", out[f"{side}_depth"], "--workers", "2"])
    out["seg_points"] = run_both("gen_seg_gt.py", gen_seg_gt.main, lambda side: [
        "--ann-file", out[f"{side}_ann"], "--data-root", root,
        "--seg-root", os.path.join(root, "lidarseg", VERSION),
        "--out-dir", out[f"{side}_seg"], "--workers", "2"])
    out["rays_written"] = run_both(
        "precompute_rays.py", precompute_rays.main, lambda side: [
            out[f"{side}_ann"], "--depth-gt-path", out[f"{side}_depth"],
            "--semantic-gt-path", out[f"{side}_seg"],
            "--out-dir", out[f"{side}_rays"], "--data-root", root,
            "--workers", "4"])
    return out


def assert_deep_equal(got, want, path="infos"):
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path  # the same keys, in order
        for k in want:
            assert_deep_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_deep_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert got == want, path


def assert_same_bins(got_dir, want_dir):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        with open(os.path.join(got_dir, name), "rb") as g, \
                open(os.path.join(want_dir, name), "rb") as w:
            assert g.read() == w.read(), name


def test_info_pkls_equal(chain):
    for split in ("train", "val"):
        with open(chain["port_ann"].replace("train", split), "rb") as f:
            got = pickle.load(f)
        with open(chain["jax_ann"].replace("train", split), "rb") as f:
            want = pickle.load(f)
        assert_deep_equal(got, want)
        assert len(got["infos"]) == N_SAMPLES


def test_depth_and_seg_bins_byte_equal(chain):
    for what in ("depth", "seg"):
        assert_same_bins(chain[f"port_{what}"], chain[f"jax_{what}"])
        assert len(os.listdir(chain[f"port_{what}"])) == N_SAMPLES * len(CAMS)
        # the return value counts the points: 12 bytes a record
        total = sum(os.path.getsize(os.path.join(chain[f"port_{what}"], n))
                    for n in os.listdir(chain[f"port_{what}"]))
        assert chain[f"{what}_points"] == total // 12 > 0


def test_seg_label_map_and_both_lidarseg_layouts(chain, tmp_path):
    """A `--label-map` json, a sample whose info names its label file
    (`lidarseg_path`), one whose named file is missing and one with neither
    a path nor a lidar token: outputs byte-equal to the JAX tool's; the
    two without labels write nothing and count 0."""
    root = chain["root"]
    with open(chain["port_ann"], "rb") as f:
        data = pickle.load(f)
    infos = data["infos"]
    infos[0]["lidarseg_path"] = os.path.join(
        "lidarseg", VERSION, f"{infos[0]['lidar_token']}_lidarseg.bin")
    infos[1]["lidarseg_path"] = os.path.join("lidarseg", "missing.bin")
    del infos[2]["lidar_token"]
    ann = tmp_path / "variant.pkl"
    with open(ann, "wb") as f:
        pickle.dump(data, f)
    label_map = tmp_path / "map.json"
    label_map.write_text(json.dumps({str(i): (7 * i) % 17 for i in range(32)}))
    outs = {side: str(tmp_path / side) for side in ("jax", "port")}
    run_both("gen_seg_gt.py", gen_seg_gt.main, lambda side: [
        "--ann-file", str(ann), "--data-root", root,
        "--seg-root", os.path.join(root, "lidarseg", VERSION),
        "--out-dir", outs[side], "--label-map", str(label_map),
        "--workers", "2"])
    assert_same_bins(outs["port"], outs["jax"])
    written = set(os.listdir(outs["port"]))
    for i, info in enumerate(infos):
        names = {os.path.basename(c["data_path"]) + ".bin"
                 for c in info["cams"].values()}
        if i in (1, 2):
            assert not names & written, i
        else:
            assert names <= written, i
    # the map is applied: sample 0's labels differ from the default map's
    name = os.path.basename(infos[0]["cams"][CAMS[0]]["data_path"]) + ".bin"
    mapped = np.fromfile(os.path.join(outs["port"], name), np.float32)
    default = np.fromfile(os.path.join(chain["port_seg"], name), np.float32)
    assert mapped.shape == default.shape
    assert (mapped.reshape(-1, 3)[:, 2] != default.reshape(-1, 3)[:, 2]).any()
    seg_root = os.path.join(root, "lidarseg", VERSION)
    for i in (1, 2):
        assert gen_seg_gt.worker((infos[i], root, seg_root, str(tmp_path),
                                  gen_seg_gt.DEFAULT_LABEL_MAP)) == 0


def test_ray_caches_equal_and_rerun_writes_none(chain):
    names = sorted(os.listdir(chain["jax_rays"]))
    assert sorted(os.listdir(chain["port_rays"])) == names
    assert chain["rays_written"] == len(names) == N_SAMPLES * len(CAMS)
    for name in names:
        got = np.load(os.path.join(chain["port_rays"], name))["rays"]
        want = np.load(os.path.join(chain["jax_rays"], name))["rays"]
        assert got.dtype == want.dtype == np.float32 and got.shape[1] == 13
        np.testing.assert_array_equal(got, want, err_msg=name)
    again = precompute_rays.main([
        chain["port_ann"], "--depth-gt-path", chain["port_depth"],
        "--semantic-gt-path", chain["port_seg"], "--out-dir",
        chain["port_rays"], "--data-root", chain["root"], "--workers", "4"])
    assert again == 0


@pytest.mark.parametrize("cached", [False, True])
def test_dataset_reads_the_port_files_as_jax_reads_its_own(chain, monkeypatch,
                                                           cached):
    """Sample 1 of the train-mode dataset with rays (the JAX chain test's
    settings), the per-sample generator seeded on both sides and the JAX
    native ray builder off: the port's dataset on the port's files equals
    the JAX dataset on the JAX files, key for key and byte for byte."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: real(1234 if seed is None else seed))

    def kwargs(side):
        kw = dict(ann_file=chain[f"{side}_ann"], data_config=DATA_CONFIG,
                  grid_config=GRID_CONFIG, is_train=True, use_rays=True,
                  max_ray_nums=256, depth_gt_path=chain[f"{side}_depth"],
                  semantic_gt_path=chain[f"{side}_seg"],
                  data_root=chain["root"])
        if cached:
            kw["ray_cache_path"] = chain[f"{side}_rays"]
        return kw

    got = NuScenesOccDataset(**kwargs("port"))[1]
    want = JaxNuScenes(**kwargs("jax"))[1]
    assert sorted(got) == sorted(want)
    assert got["rays"].shape[0] == 256 and (got["gt_depth"] > 0).any()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k
