"""The port's trajectory dataset (`preworld_tpu_torch/data/nuscenes_traj.py`)
against the JAX package's, on the miniature nuScenes tree of
`tests/test_torch_data.py` (its fixture, reused).

Samples are compared byte for byte: both packages run the same numpy + PIL
arithmetic. Train-mode samples draw from `np.random.default_rng(None)`, so
those cases patch `numpy.random.default_rng` (for both packages at once) to
a seeded generator; the future rays draw from `seed + idx` on both sides.
The tree has 15 + 5 frames, so the remap runs at `min_future_frames` 6,
`occworld_offset` 2 and 3 future frames (the JAX dataset test's setting).
"""

import pickle

import numpy as np
import pytest

from preworld_tpu.data.nuscenes_traj import (
    NuScenesOccTrajDataset as JaxTrajDataset,
)
from preworld_tpu.data.nuscenes_traj import (
    flatten_ego_state as jax_flatten_ego_state,
)
from preworld_tpu_torch.data import NuScenesOccTrajDataset, flatten_ego_state
from test_torch_data import (  # noqa: F401  (fixtures)
    _kwargs,
    assert_samples_equal,
    fake_nuscenes,
    jax_numpy_rays,
)

REMAP = dict(min_future_frames=6, occworld_offset=2, num_future=3)
CASES = {
    "finetune": dict(),
    "rays": dict(use_rays=True, aux_frames=[-1, 1], max_ray_nums=64),
}


def _pkls(fake_nuscenes, tmp_path):
    """AD-MLP and OccWorld pkls over the tree's tokens: ego state 0..20 and
    waypoints of 0.5 (the JAX dataset test's), plus a per-frame offset so
    that a wrong frame would show."""
    root, ann = fake_nuscenes
    with open(ann, "rb") as f:
        infos = pickle.load(f)["infos"]
    ad = {i["token"]: {"vel": list(np.arange(21, dtype=float) + t)}
          for t, i in enumerate(infos)}
    traj = {"infos": {}}
    for t, i in enumerate(infos):
        traj["infos"].setdefault(i["scene_name"], {})[i["frame_idx"]] = {
            "gt_ego_fut_trajs": np.ones((6, 2), np.float32) * 0.5 + t}
    paths = tmp_path / "ad.pkl", tmp_path / "occworld.pkl"
    for p, obj in zip(paths, (ad, traj)):
        with open(p, "wb") as f:
            pickle.dump(obj, f)
    return dict(ego_gt_path=str(paths[0]), traj_gt_path=str(paths[1]))


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_traj_samples_match_jax(fake_nuscenes, tmp_path, monkeypatch, case,
                                mode):
    """Every key of every sample (the future occupancy with the key
    frame's flips, waypoints, ego state, future rays), byte for byte."""
    kw = _kwargs(fake_nuscenes, is_train=mode == "train", **CASES[case],
                 **REMAP, **_pkls(fake_nuscenes, tmp_path))
    port, ref = NuScenesOccTrajDataset(**kw), JaxTrajDataset(**kw)
    assert port.temp2nusc_map == ref.temp2nusc_map and len(port) > 0
    if mode == "train":
        real = np.random.default_rng
        monkeypatch.setattr(np.random, "default_rng",
                            lambda seed=None: real(
                                1234 if seed is None else seed))
    for i in range(len(port)):
        got, want = port[i], ref[i]
        assert "__bda_flips" not in got
        assert got["temporal_semantics"].shape == (3, 16, 16, 4)
        assert ("temporal_rays" in got) == (case == "rays")
        assert_samples_equal(got, want)


def test_traj_dataset_with_pkls(fake_nuscenes, tmp_path):
    """`tests/test_dataset.py::test_traj_dataset_with_pkls` on the port:
    the AD-MLP ego state and the OccWorld waypoints reach the sample."""
    root, ann = fake_nuscenes
    with open(ann, "rb") as f:
        infos = pickle.load(f)["infos"]
    ad_info = {i["token"]: {"vel": list(np.arange(21, dtype=float))}
               for i in infos}
    traj_info = {"infos": {}}
    for i in infos:
        traj_info["infos"].setdefault(i["scene_name"], {})[
            i["frame_idx"]] = {
                "gt_ego_fut_trajs": np.ones((6, 2), np.float32) * 0.5}
    ego_p, traj_p = tmp_path / "ad.pkl", tmp_path / "occworld.pkl"
    for p, obj in ((ego_p, ad_info), (traj_p, traj_info)):
        with open(p, "wb") as f:
            pickle.dump(obj, f)
    ds = NuScenesOccTrajDataset(
        **_kwargs(fake_nuscenes, is_train=True, **REMAP),
        ego_gt_path=str(ego_p), traj_gt_path=str(traj_p))
    s = ds[0]
    np.testing.assert_allclose(s["ego_states"], np.arange(21, dtype=float))
    np.testing.assert_allclose(s["temporal_trajs"], 0.5)
    assert s["temporal_trajs"].shape == (3, 2)


def test_traj_dataset_without_pkls(fake_nuscenes):
    """No pkls: a zero ego state (21) and zero waypoints."""
    ds = NuScenesOccTrajDataset(**_kwargs(fake_nuscenes, is_train=False,
                                          **REMAP))
    s = ds[1]
    assert s["ego_states"].shape == (21,) and not s["ego_states"].any()
    assert s["temporal_trajs"].shape == (3, 2)
    assert not s["temporal_trajs"].any()


@pytest.mark.parametrize("entry", [
    {"b_accel": [[0.1, 0.2, 0.3], [0.4, 0.5, 0.6]], "a_vel": [1.0, 2.0, 3.0],
     "gt": [9.9, 9.9], "c_cmd": 1.0},
    {"vel": list(np.arange(21, dtype=float))},
    {"x": 2.0, "y": [[1, 2], [3, 4], [5, 6]], "gt": 0.0},
])
def test_flatten_ego_state_matches_jax(entry):
    """Sorted keys, 'gt' skipped, nested lists flattened: the JAX bytes."""
    got, want = flatten_ego_state(entry), jax_flatten_ego_state(entry)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    if "a_vel" in entry:
        np.testing.assert_allclose(
            got, [1.0, 2.0, 3.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 1.0])


def test_evaluate_temporal_matches_jax(fake_nuscenes):
    """The 4-D protocol on the same predictions; perfect predictions (the
    ground truth 0 / 2 / 4 / 6 frames ahead) score 100. Its 6-frame horizon
    needs min_future_frames >= occworld_offset + 6."""
    kw = _kwargs(fake_nuscenes, is_train=False,
                 **dict(REMAP, min_future_frames=8))
    port, ref = NuScenesOccTrajDataset(**kw), JaxTrajDataset(**kw)
    rng = np.random.default_rng(3)
    preds = [{h: rng.integers(0, 18, (16, 16, 4)) for h in range(4)}
             for _ in range(len(port))]
    assert port.evaluate_temporal(preds) == ref.evaluate_temporal(preds)
    perfect = [port.horizon_gts(i) for i in range(len(port))]
    res = port.evaluate_temporal(perfect)
    assert all(v == 100.0 for k, v in res.items() if k.startswith("mIoU"))
