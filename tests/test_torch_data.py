"""The port's data layer (`preworld_tpu_torch/data/`, the ray builders of
`geometry/rays.py` and `bda_matrix`) against the JAX package's, on a
miniature nuScenes tree on disk.

The tree is a copy of the `fake_nuscenes` fixture of `tests/test_dataset.py`
(the reference's formats: bevdetv2 info pkl, camera JPEGs, lidar .bin
sweeps, occupancy labels.npz, sparse depth / seg GT bins). Every array is
compared byte for byte: both packages run the same numpy + PIL arithmetic.
Train-mode samples draw from `np.random.default_rng(None)`, so those cases
patch `numpy.random.default_rng` (for both packages at once) to a seeded
generator. The JAX ray builder takes its native record builder when
`native/libpreworld_native.so` is built; the port never does, so the JAX
side is pinned to its numpy path.
"""

import pickle
import threading
import time

import numpy as np
import pytest
from PIL import Image

import preworld_tpu.data.native as jax_native
import preworld_tpu.geometry.rays as jax_rays
from preworld_tpu.data.loader import DataLoader as JaxDataLoader
from preworld_tpu.data.loader import collate as jax_collate
from preworld_tpu.data.nuplan import NuPlanOccDataset as JaxNuPlanOccDataset
from preworld_tpu.data.nuscenes import NuScenesOccDataset as JaxNuScenes
from preworld_tpu.geometry.transforms import bda_matrix as jax_bda_matrix
from preworld_tpu_torch.data import (
    DataLoader,
    NuPlanOccDataset,
    NuScenesOccDataset,
    collate,
)
from preworld_tpu_torch.data.pipeline import load_occ_gt
from preworld_tpu_torch.geometry import bda_matrix
from preworld_tpu_torch.geometry import rays

W_SRC, H_SRC = 64, 48  # "source camera" resolution
CAMS = ["CAM_A", "CAM_B"]
DATA_CONFIG = dict(
    cams=CAMS, Ncams=2, input_size=(32, 64), src_size=(H_SRC, W_SRC),
    resize=(-0.06, 0.11), rot=(-5.4, 5.4), flip=True, crop_h=(0.0, 0.0),
    resize_test=0.0,
)
GRID_CONFIG = dict(
    x=[-8.0, 8.0, 1.0], y=[-8.0, 8.0, 1.0], z=[-1.0, 3.0, 1.0],
    depth=[1.0, 9.0, 0.5],
)
INDICES = (0, 5, 14, 15, 19)  # scene starts, ends and a middle frame


def quat_identity():
    return [1.0, 0.0, 0.0, 0.0]


@pytest.fixture(scope="module")
def fake_nuscenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("fake_nusc")
    (root / "imgs").mkdir()
    (root / "lidar").mkdir()
    (root / "depth_gt").mkdir()
    (root / "seg_gt").mkdir()
    rng = np.random.default_rng(0)

    n_frames = 20
    infos = []
    for t in range(n_frames):
        scene = "scene-0001" if t < 15 else "scene-0002"
        occ_dir = root / "occ" / scene / f"tok{t:03d}"
        occ_dir.mkdir(parents=True)
        sem = rng.integers(0, 18, (16, 16, 4)).astype(np.uint8)
        np.savez_compressed(
            occ_dir / "labels.npz",
            semantics=sem,
            mask_lidar=rng.uniform(size=sem.shape) > 0.5,
            mask_camera=rng.uniform(size=sem.shape) > 0.3,
        )
        lidar_path = root / "lidar" / f"sweep{t:03d}.bin"
        pts = rng.uniform(-8, 8, (500, 5)).astype(np.float32)
        pts[:, 2] = rng.uniform(0, 2, 500)
        pts.tofile(lidar_path)

        info = {
            "token": f"tok{t:03d}",
            "scene_token": scene,
            "scene_name": scene,
            "frame_idx": t if t < 15 else t - 15,
            "timestamp": 1000 + t,
            "lidar_path": str(lidar_path),
            "lidar2ego_rotation": quat_identity(),
            "lidar2ego_translation": [0.0, 0.0, 1.0],
            "ego2global_rotation": quat_identity(),
            "ego2global_translation": [0.4 * t, 0.0, 0.0],
            "occ_path": str(occ_dir),
            "cams": {},
        }
        for ci, cam in enumerate(CAMS):
            img_path = root / "imgs" / f"t{t}_{cam}.jpg"
            Image.fromarray(
                rng.integers(0, 255, (H_SRC, W_SRC, 3), dtype=np.uint8)
            ).save(img_path)
            info["cams"][cam] = {
                "data_path": str(img_path),
                "cam_intrinsic": np.array(
                    [[40.0, 0, W_SRC / 2], [0, 40.0, H_SRC / 2], [0, 0, 1]]
                ),
                "sensor2ego_rotation": quat_identity(),
                "sensor2ego_translation": [0.0, 0.5 * ci, 1.5],
                "ego2global_rotation": quat_identity(),
                "ego2global_translation": [0.4 * t, 0.0, 0.0],
            }
            # sparse depth/seg GT (u, v, value) triplets
            n = 40
            uv = np.stack(
                [rng.integers(0, W_SRC, n), rng.integers(0, H_SRC, n)], axis=1
            ).astype(np.float32)
            depth = rng.uniform(1.5, 8.0, n).astype(np.float32)
            seg = rng.integers(0, 17, n).astype(np.float32)
            np.concatenate([uv, depth[:, None]], 1).astype(np.float32).tofile(
                root / "depth_gt" / (img_path.name + ".bin")
            )
            np.concatenate([uv, seg[:, None]], 1).astype(np.float32).tofile(
                root / "seg_gt" / (img_path.name + ".bin")
            )
        infos.append(info)
    ann = root / "infos.pkl"
    with open(ann, "wb") as f:
        pickle.dump({"infos": infos, "metadata": {"version": "fake"}}, f)
    return root, str(ann)


@pytest.fixture(autouse=True)
def jax_numpy_rays(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)


def _kwargs(fake_nuscenes, **kw):
    root, ann = fake_nuscenes
    return dict(ann_file=ann, data_config=DATA_CONFIG,
                grid_config=GRID_CONFIG,
                depth_gt_path=str(root / "depth_gt"),
                semantic_gt_path=str(root / "seg_gt"), **kw)


def _ray_cache(fake_nuscenes, out):
    """Per-image ray cache files, as `tools/precompute_rays.py` writes
    them (the port's builders; their parity is checked below)."""
    from preworld_tpu_torch.data.pipeline import (
        imagenet_normalize_01,
        load_seg_map,
        load_sparse_depth,
        pose_to_mat,
    )

    root, ann = fake_nuscenes
    out.mkdir(exist_ok=True)
    with open(ann, "rb") as f:
        infos = pickle.load(f)["infos"]
    for info in infos:
        for c in info["cams"].values():
            path = c["data_path"]
            coor, depth = load_sparse_depth(path, str(root / "depth_gt"))
            seg = load_seg_map(path, str(root / "seg_gt"))[coor[:, 1],
                                                            coor[:, 0]]
            img01 = np.asarray(Image.open(path).convert("RGB"),
                               np.float32) / 255.0
            rgb = imagenet_normalize_01(img01)[coor[:, 1], coor[:, 0]]
            s2e = pose_to_mat(c["sensor2ego_rotation"],
                              c["sensor2ego_translation"])
            e2g = pose_to_mat(c["ego2global_rotation"],
                              c["ego2global_translation"])
            cache = rays.build_image_ray_cache(
                coor.astype(np.float32), depth, seg, rgb,
                np.asarray(c["cam_intrinsic"], np.float32),
                (e2g @ s2e).astype(np.float32))
            np.savez(out / (path.split("/")[-1] + ".npz"), rays=cache)
    return str(out)


def assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


SAMPLE_CASES = {
    "finetune": dict(),
    "rays": dict(use_rays=True, aux_frames=[-1, 1], max_ray_nums=64),
    "rays_cached": dict(use_rays=True, aux_frames=[-1, 1], max_ray_nums=64,
                        cached=True),
    "rays_no_lidar": dict(use_rays=True, aux_frames=[-1, 1],
                          max_ray_nums=200, load_point_depth=False),
}


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_samples_match_jax(fake_nuscenes, tmp_path, monkeypatch, case,
                           mode):
    """Every key of eval-mode samples (seeded by index) and of train-mode
    samples (the per-sample generator patched to a seeded one on both
    sides), byte for byte."""
    kw = dict(SAMPLE_CASES[case])
    if kw.pop("cached", False):
        kw["ray_cache_path"] = _ray_cache(fake_nuscenes, tmp_path / "cache")
    kw = _kwargs(fake_nuscenes, is_train=mode == "train", **kw)
    port, ref = NuScenesOccDataset(**kw), JaxNuScenes(**kw)
    if mode == "train":
        real = np.random.default_rng
        monkeypatch.setattr(np.random, "default_rng",
                            lambda seed=None: real(
                                1234 if seed is None else seed))
    for i in INDICES:
        got, want = port[i], ref[i]
        assert ("gt_depth" in got) == (mode == "train")
        assert ("rays" in got) == ("rays" in case)
        assert_samples_equal(got, want)


def test_evaluate_matches_jax(fake_nuscenes):
    """The 3-D mIoU protocol (camera mask) and nuPlan's (11 classes, no
    mask) on the same predictions."""
    rng = np.random.default_rng(5)
    kw = _kwargs(fake_nuscenes, is_train=False)
    for port_cls, jax_cls in ((NuScenesOccDataset, JaxNuScenes),
                              (NuPlanOccDataset, JaxNuPlanOccDataset)):
        port, ref = port_cls(**kw), jax_cls(**kw)
        preds = [rng.integers(0, getattr(port_cls, "NUM_CLASSES", 18),
                              (16, 16, 4)) for _ in range(6)]
        assert port.evaluate(preds) == ref.evaluate(preds)
    perfect = [load_occ_gt(port.infos[i]["occ_path"])["voxel_semantics"]
               for i in range(3)]
    assert NuScenesOccDataset(**kw).evaluate(perfect)["mIoU"] == 100.0


class _IdxDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.asarray([i]), "x": np.full((2, 3), i, np.float32)}


@pytest.mark.parametrize("count,shuffle,drop_last", [
    (1, True, True), (1, False, True), (1, True, False), (2, True, True),
    (2, False, True)])
def test_loader_matches_jax(count, shuffle, drop_last):
    """Batches and their order, per process and epoch, as the JAX loader
    gives them for the same seed (several processes need drop_last)."""
    for rank in range(count):
        kw = dict(batch_size=4, num_workers=2, seed=3, shuffle=shuffle,
                  drop_last=drop_last, process_index=rank,
                  process_count=count)
        port, ref = DataLoader(_IdxDataset(22), **kw), \
            JaxDataLoader(_IdxDataset(22), **kw)
        assert len(port) == len(ref)
        for epoch in (0, 1):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(port), list(ref)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert_samples_equal(g, w)


def test_loader_over_dataset_matches_jax(fake_nuscenes):
    kw = _kwargs(fake_nuscenes, is_train=False)
    port = DataLoader(NuScenesOccDataset(**kw), batch_size=4, num_workers=2,
                      seed=1)
    ref = JaxDataLoader(JaxNuScenes(**kw), batch_size=4, num_workers=2,
                        seed=1)
    port.set_epoch(2)
    ref.set_epoch(2)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert_samples_equal(g, w)
    assert_samples_equal(collate([port.dataset[3], port.dataset[4]]),
                         jax_collate([ref.dataset[3], ref.dataset[4]]))


class _BoomDataset:
    """10 good samples, sample 5 raises (corrupt-file stand-in)."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("corrupt sample 5")
        return {"x": np.full((3,), float(i), np.float32)}


def test_loader_error_propagates_not_hangs():
    loader = DataLoader(_BoomDataset(), batch_size=2, shuffle=False,
                        num_workers=2, drop_last=True)
    with pytest.raises(ValueError, match="corrupt sample 5"):
        for _ in loader:
            pass


def test_loader_abandoned_iterator_unblocks_producer():
    before = threading.active_count()
    for _ in range(8):
        it = iter(DataLoader(_IdxDataset(64), batch_size=2, num_workers=1,
                             prefetch=1))
        next(it)
        it.close()  # abandon mid-epoch with a full prefetch queue
    # producer threads must observe stop and exit (generous deadline)
    deadline = time.time() + 10.0
    while time.time() < deadline:
        if threading.active_count() <= before + 1:
            break
        time.sleep(0.1)
    assert threading.active_count() <= before + 1, (
        threading.active_count(), before)


@pytest.mark.parametrize("rot,scale,fx,fy", [
    (0.0, 1.0, False, False), (22.5, 1.0, True, False),
    (-13.0, 0.95, False, True), (90.0, 1.05, True, True)])
def test_bda_matrix_matches_jax(rot, scale, fx, fy):
    got, want = bda_matrix(rot, scale, fx, fy), \
        jax_bda_matrix(rot, scale, fx, fy)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def _ray_inputs(seed, n_imgs=4, n=50):
    rng = np.random.default_rng(seed)
    out = dict(coors=[], depths=[], segs=[], rgbs=[], c2ws=[], Ks=[])
    for i in range(n_imgs):
        m = n + 7 * i
        out["coors"].append(np.stack([rng.integers(0, 64, m),
                                      rng.integers(0, 48, m)],
                                     1).astype(np.float32))
        out["depths"].append(rng.uniform(1, 9, m).astype(np.float32))
        out["segs"].append(rng.integers(0, 17, m).astype(np.float32))
        out["rgbs"].append(rng.normal(size=(m, 3)).astype(np.float32))
        c2w = np.eye(4, dtype=np.float32)
        a = rng.uniform(-np.pi, np.pi)
        c2w[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        c2w[:3, 3] = rng.uniform(-2, 2, 3)
        out["c2ws"].append(c2w)
        out["Ks"].append(np.array([[40, 0, 32], [0, 40, 24], [0, 0, 1]],
                                  np.float32))
    return out


def _call_builder(mod, name, inp, seed):
    rng = np.random.default_rng(seed)
    c, K, w = inp["c2ws"][0], inp["Ks"][0], inp["coors"][0]
    if name == "get_rays":
        return mod.get_rays(w[:, 0] + 0.5, w[:, 1] + 0.5, K, c)
    if name == "pts2ray":
        return mod.pts2ray(w, inp["depths"][0], inp["segs"][0],
                           inp["rgbs"][0], c, K)
    if name == "class_balance_weights":
        return mod.class_balance_weights(np.concatenate(inp["segs"]))
    if name == "ray_weights":
        bw = mod.class_balance_weights(np.concatenate(inp["segs"]))
        return [mod.ray_weights(inp["segs"][1], t, bw) for t in (0, -1, 2)]
    if name in ("build_rays", "build_rays_no_wrs", "build_rays_pad"):
        return mod.build_rays(
            inp["coors"], inp["depths"], inp["segs"], inp["rgbs"],
            inp["c2ws"], inp["Ks"], time_ids=[0, -1, 1, 0],
            max_ray_nums=500 if name == "build_rays_pad" else 96,
            use_wrs=name != "build_rays_no_wrs", rng=rng)
    if name == "weighted_ray_sample":
        recs = np.arange(60 * 16, dtype=np.float32).reshape(60, 16)
        return [mod.weighted_ray_sample(recs, np.linspace(0.1, 2, 60), k,
                                        rng) for k in (20, 60, 90)]
    if name == "ray_cache":
        cache = mod.build_image_ray_cache(w, inp["depths"][0],
                                          inp["segs"][0], inp["rgbs"][0], K,
                                          c)
        return [cache, mod.cache_to_records(cache, np.linalg.inv(
            inp["c2ws"][1]).astype(np.float32))]
    if name == "build_rays_dense":
        return mod.build_rays_dense(inp["coors"], inp["rgbs"], inp["c2ws"],
                                    inp["Ks"], 120, rng=rng)
    if name == "dense_pixel_coords":
        return mod.dense_pixel_coords(6, 9)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "get_rays", "pts2ray", "class_balance_weights", "ray_weights",
    "weighted_ray_sample", "build_rays", "build_rays_no_wrs",
    "build_rays_pad", "ray_cache", "build_rays_dense",
    "dense_pixel_coords"])
def test_ray_builders_match_jax(name):
    """Each builder on the same inputs and a generator of the same seed."""
    inp = _ray_inputs(7)
    got = _call_builder(rays, name, inp, 11)
    want = _call_builder(jax_rays, name, inp, 11)
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert (rays.RAY_DIM, rays.RAY_CACHE_DIM, rays.RAY_DENSE_DIM) == \
        (jax_rays.RAY_DIM, jax_rays.RAY_CACHE_DIM, jax_rays.RAY_DENSE_DIM)
