"""4-D forecasting dataset adapter (Occ3D-nuScenes temporal + ego
trajectory).

Counterpart of `preworld_tpu/data/nuscenes_traj.py`, the same numpy code on
the port's `NuScenesOccDataset`:
  * an index remap that keeps key frames with at least `min_future_frames`
    same-scene successors, shifted by `occworld_offset` (OccWorld's
    indexing);
  * per sample: `num_future` future occupancy frames (flipped with the key
    frame's BEV flips), the ego's future waypoints from the OccWorld info
    pkl, the 21-dim AD-MLP ego state and, with `use_rays`, each future
    frame's render rays from a generator seeded `seed + idx`;
  * `evaluate_temporal`: the unmasked mIoU at 0 / 1 / 2 / 3 s against the
    ground truth 0 / 2 / 4 / 6 frames ahead.

Extra files (the formats the reference reads):
  ego_gt_path:  AD-MLP `data_nuscene.pkl`, {token: kinematics dict}
  traj_gt_path: OccWorld `nuscenes_infos_*_temporal_v3_scene.pkl`
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional, Sequence

import numpy as np

from ..metrics.miou import MetricMIoUTemporal
from .nuscenes import NuScenesOccDataset
from .pipeline import flip_voxels, load_occ_gt

FUTURE_INTERVALS = (1, 2, 3, 4, 5, 6)


def _count_layers(obj) -> int:
    if isinstance(obj, (list, tuple)):
        return 1 + max((_count_layers(x) for x in obj), default=0)
    return 0


def flatten_ego_state(ad_entry: Dict) -> np.ndarray:
    """AD-MLP per-token dict -> flat f32 kinematics vector: keys sorted,
    'gt' skipped, nested lists flattened."""
    out = []
    for k in sorted(ad_entry):
        if k == "gt":
            continue
        ele = ad_entry[k]
        if _count_layers(ele) == 2:
            out += list(ele)
        else:
            out.append(ele)
    return np.concatenate(
        [np.ravel(np.asarray(e, np.float32)) for e in out]).astype(np.float32)


class NuScenesOccTrajDataset(NuScenesOccDataset):
    def __init__(self, *args, ego_gt_path: Optional[str] = None,
                 traj_gt_path: Optional[str] = None,
                 min_future_frames: int = 12, occworld_offset: int = 5,
                 num_future: int = 6, **kwargs):
        super().__init__(*args, **kwargs)
        self._keep_flip_meta = True
        self.num_future = num_future
        self.ad_info = {}
        if ego_gt_path:
            with open(ego_gt_path, "rb") as f:
                self.ad_info = pickle.load(f)
        self.traj_info = {}
        if traj_gt_path:
            with open(traj_gt_path, "rb") as f:
                self.traj_info = pickle.load(f)["infos"]
        self.temp2nusc_map = []
        for idx, info in enumerate(self.infos):
            tail = idx + min_future_frames
            if (tail < len(self.infos)
                    and self.infos[tail]["scene_token"] == info["scene_token"]):
                self.temp2nusc_map.append(idx + occworld_offset)

    def __len__(self):
        return len(self.temp2nusc_map)

    def _future_index(self, index: int, t: int) -> int:
        """The info index t frames after `index`, which must lie in the
        same scene (the remap guarantees it for offset + horizon <=
        min_future_frames; the assert keeps a drift of those constants from
        reading another scene's ground truth)."""
        fidx = min(index + t, len(self.infos) - 1)
        assert (self.infos[fidx]["scene_token"]
                == self.infos[index]["scene_token"]), (
            f"future frame +{t} of sample {index} crosses a scene boundary "
            "(check min_future_frames against occworld_offset + horizon)")
        return fidx

    def _future_info(self, index: int, t: int) -> Dict:
        return self.infos[self._future_index(index, t)]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        index = self.temp2nusc_map[idx]
        sample = super().__getitem__(index)
        info = self.infos[index]
        horizons = FUTURE_INTERVALS[: self.num_future]

        temporal_sem = np.stack([
            load_occ_gt(self._data_path(
                self._future_info(index, t)["occ_path"]))["voxel_semantics"]
            for t in horizons])
        if "__bda_flips" in sample:
            fdx, fdy = sample["__bda_flips"]
            temporal_sem = np.stack([flip_voxels({"s": s}, fdx, fdy)["s"]
                                     for s in temporal_sem])
        sample["temporal_semantics"] = temporal_sem.astype(np.int32)

        scene, frame = info.get("scene_name"), info.get("frame_idx")
        if scene in self.traj_info and frame in self.traj_info[scene]:
            trajs = np.asarray(
                self.traj_info[scene][frame]["gt_ego_fut_trajs"], np.float32)
        else:
            trajs = np.zeros((self.num_future, 2), np.float32)
        sample["temporal_trajs"] = trajs[: self.num_future]

        token = info.get("token")
        if token in self.ad_info:
            sample["ego_states"] = flatten_ego_state(self.ad_info[token])
        else:
            sample["ego_states"] = np.zeros(21, np.float32)

        if self.use_rays:
            rng = np.random.default_rng(self._seed + idx)
            sample["temporal_rays"] = np.stack([
                self._rays(self._future_index(index, t), rng)
                for t in horizons])
        sample.pop("__bda_flips", None)
        return sample

    def evaluate_temporal(
            self, preds_by_horizon: Sequence[Dict[int, np.ndarray]]) -> Dict:
        """Unmasked mIoU at 0 / 1 / 2 / 3 s: sample i's predictions {h:
        (X, Y, Z)} against the ground truth 0 / 2 / 4 / 6 frames ahead."""
        metric = MetricMIoUTemporal(num_classes=18)
        for i, preds in enumerate(preds_by_horizon):
            metric.add_batch(preds, self.horizon_gts(i))
        return metric.count_miou()

    def horizon_gts(self, idx: int) -> Dict[int, np.ndarray]:
        """Sample idx's ground truth per horizon {0, 1, 2, 3}: the
        occupancy 0, 2, 4 and 6 frames ahead."""
        index = self.temp2nusc_map[idx]
        return {h: load_occ_gt(self._data_path(
            self._future_info(index, frames)["occ_path"]))["voxel_semantics"]
            for h, frames in zip(MetricMIoUTemporal.HORIZONS, (0, 2, 4, 6))}
