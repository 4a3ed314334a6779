"""nuScenes Occ3D dataset adapter (bevdetv2 info pkl format).

Counterpart of `preworld_tpu/data/nuscenes.py`, the same numpy + PIL code.
Parity targets:
  * `NuScenesDataset` info loading + adjacent-frame selection
    (`mmdet3d/datasets/nuscenes_dataset.py:139-299`)
  * `NuScenesDatasetOccpancy` ray supervision + evaluation
    (`mmdet3d/datasets/nuscenes_dataset_occ.py:108-386`)
  * the train pipeline of `configs/preworld/nuscenes/bevstereo-occ.py:128-156`
    (PrepareImageInputs -> LoadOccGTFromFile -> LoadAnnotationsBEVDepth ->
    LoadPointsFromFile -> PointToMultiViewDepth -> Collect)

Emits numpy batches in the `PreWorld` layout (B, T, N, ...) — see
`preworld_tpu_torch/models/preworld.py`. The heavy per-sample work (JPEG decode,
aug, ray WRS) runs on CPU workers (see `loader.py`).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from ..geometry.rays import build_rays
from ..geometry.transforms import bda_matrix
from ..metrics.miou import MetricMIoU
from .pipeline import (
    ImgAug,
    aug_homography,
    flip_voxels,
    imagenet_normalize_01,
    load_occ_gt,
    load_seg_map,
    load_sparse_depth,
    mmlab_normalize,
    points_to_depth_map,
    pose_to_mat,
    project_points_to_image,
    sample_img_augmentation,
    transform_image,
)

# dataset-level WRS class counts (`nuscenes_dataset_occ.py:23-29`)
NUSC_CLASS_NUMS = np.array(
    [
        2854504, 7291443, 141614, 4239939, 32248552, 1583610, 364372, 2346381,
        582961, 4829021, 14073691, 191019309, 6249651, 55095657, 58484771,
        193834360, 131378779,
    ],
    np.float64,
)
DYNAMIC_CLASSES = (0, 1, 3, 4, 5, 7, 9, 10)

DEFAULT_CAMS = (
    "CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
    "CAM_BACK_RIGHT", "CAM_BACK", "CAM_BACK_LEFT",
)


def wrs_dataset_balance_weight() -> np.ndarray:
    """exp(0.005*(max/n - 1)) over dataset class counts
    (`nuscenes_dataset_occ.py:127-129`)."""
    return np.exp(
        0.005 * (NUSC_CLASS_NUMS.max() / NUSC_CLASS_NUMS - 1.0)
    ).astype(np.float32)


class NuScenesOccDataset:
    """Map-style dataset over bevdetv2 info pkls."""

    def __init__(
        self,
        ann_file: str,
        data_config: Dict,
        grid_config: Dict,
        bda_aug_conf: Optional[Dict] = None,
        is_train: bool = True,
        sequential: bool = True,
        multi_adj_frame_id_cfg=(1, 2, 1),
        stereo: bool = True,
        use_rays: bool = False,
        aux_frames: Sequence[int] = (-3, -2, -1, 1, 2, 3),
        max_ray_nums: int = 38400,
        depth_gt_path: Optional[str] = None,
        semantic_gt_path: Optional[str] = None,
        ray_cache_path: Optional[str] = None,
        data_root: str = "",
        load_point_depth: bool = True,
        seed: int = 0,
    ):
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        self.infos = list(sorted(data["infos"], key=lambda e: e["timestamp"]))
        self.data_config = data_config
        self.grid_config = grid_config
        self.bda_aug_conf = bda_aug_conf or dict(
            rot_lim=(0.0, 0.0), scale_lim=(1.0, 1.0),
            flip_dx_ratio=0.5, flip_dy_ratio=0.5,
        )
        self.is_train = is_train
        self.sequential = sequential
        self.adj_ids = list(range(*multi_adj_frame_id_cfg))
        if stereo:
            self.adj_ids.append(multi_adj_frame_id_cfg[1])
        self.use_rays = use_rays
        self.aux_frames = list(aux_frames)
        self.max_ray_nums = max_ray_nums
        self.depth_gt_path = depth_gt_path
        self.semantic_gt_path = semantic_gt_path
        self.ray_cache_path = ray_cache_path
        self.data_root = data_root
        self.load_point_depth = load_point_depth
        self.balance_weight = wrs_dataset_balance_weight()
        self._seed = seed

    def __len__(self):
        return len(self.infos)

    # ------------------------------------------------------------------
    def _adj_infos(self, index: int) -> List[Dict]:
        """Previous-frame infos (same scene or repeat current)
        (`nuscenes_dataset.py:285-299`)."""
        info = self.infos[index]
        out = []
        for sid in self.adj_ids:
            sel = max(index - sid, 0)
            if self.infos[sel]["scene_token"] != info["scene_token"]:
                out.append(info)
            else:
                out.append(self.infos[sel])
        return out

    def _cam_pose(self, info: Dict, cam: str):
        c = info["cams"][cam]
        s2e = pose_to_mat(c["sensor2ego_rotation"], c["sensor2ego_translation"])
        e2g = pose_to_mat(c["ego2global_rotation"], c["ego2global_translation"])
        return s2e, e2g

    def _data_path(self, p: str) -> str:
        if os.path.isabs(p) or not self.data_root:
            return p
        return os.path.join(self.data_root, p)

    # ------------------------------------------------------------------
    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            None if self.is_train else self._seed + index
        )
        info = self.infos[index]
        adj_infos = self._adj_infos(index)
        frames = [info] + adj_infos  # key first; order matches num_frames
        cams = list(self.data_config["cams"])
        T, N = len(frames), len(cams)
        H, W = self.data_config["input_size"]

        imgs = np.zeros((T, N, H, W, 3), np.float32)
        sensor2egos = np.zeros((T, N, 4, 4), np.float32)
        ego2globals = np.zeros((T, N, 4, 4), np.float32)
        intrins = np.zeros((T, N, 3, 3), np.float32)
        post_rots = np.zeros((T, N, 3, 3), np.float32)
        post_trans = np.zeros((T, N, 3), np.float32)
        augs: List[ImgAug] = []

        for n, cam in enumerate(cams):
            cam_data = info["cams"][cam]
            src = Image.open(self._data_path(cam_data["data_path"]))
            aug = sample_img_augmentation(
                self.data_config, src.height, src.width, self.is_train, rng
            )
            augs.append(aug)
            rot3, tran3 = aug_homography(aug)
            for t, fr in enumerate(frames):
                fd = fr["cams"][cam]
                img = (
                    src if t == 0
                    else Image.open(self._data_path(fd["data_path"]))
                )
                imgs[t, n] = mmlab_normalize(transform_image(img, aug))
                s2e, e2g = self._cam_pose(fr, cam)
                sensor2egos[t, n] = s2e
                ego2globals[t, n] = e2g
                intrins[t, n] = np.asarray(fd["cam_intrinsic"], np.float32)
                post_rots[t, n] = rot3
                post_trans[t, n] = tran3

        # BEV augmentation (`loading.py:1143-1227`)
        if self.is_train:
            rot_bda = rng.uniform(*self.bda_aug_conf["rot_lim"])
            scale_bda = rng.uniform(*self.bda_aug_conf["scale_lim"])
            flip_dx = rng.uniform() < self.bda_aug_conf["flip_dx_ratio"]
            flip_dy = rng.uniform() < self.bda_aug_conf["flip_dy_ratio"]
        else:
            rot_bda, scale_bda, flip_dx, flip_dy = 0.0, 1.0, False, False
        bda = bda_matrix(rot_bda, scale_bda, flip_dx, flip_dy)

        sample: Dict[str, np.ndarray] = {
            "imgs": imgs,
            "sensor2egos": sensor2egos,
            "ego2globals": ego2globals,
            "intrins": intrins,
            "post_rots": post_rots,
            "post_trans": post_trans,
            "bda": bda,
        }

        # occupancy GT + flips (subclasses flip future frames consistently)
        if getattr(self, "_keep_flip_meta", False):
            sample["__bda_flips"] = (flip_dx, flip_dy)
        if "occ_path" in info:
            occ = load_occ_gt(self._data_path(info["occ_path"]))
            occ = flip_voxels(occ, flip_dx, flip_dy)
            sample.update(occ)

        # lidar depth GT for the key frame (`loading.py:789-844`)
        if self.load_point_depth and "lidar_path" in info and self.is_train:
            sample["gt_depth"] = self._lidar_depth(
                info, cams, intrins[0], post_rots[0], post_trans[0], H, W
            )
        elif self.is_train:
            sample["gt_depth"] = np.zeros((N, H, W), np.float32)

        # rendering supervision rays
        if self.use_rays:
            sample["rays"] = self._rays(index, rng)
        return sample

    # ------------------------------------------------------------------
    def _lidar_depth(self, info, cams, intrins, post_rots, post_trans, H, W):
        pts = np.fromfile(
            self._data_path(info["lidar_path"]), dtype=np.float32
        ).reshape(-1, 5)[:, :3]
        lidar2lidarego = pose_to_mat(
            info["lidar2ego_rotation"], info["lidar2ego_translation"]
        )
        lidarego2global = pose_to_mat(
            info["ego2global_rotation"], info["ego2global_translation"]
        )
        out = np.zeros((len(cams), H, W), np.float32)
        for n, cam in enumerate(cams):
            c = info["cams"][cam]
            cam2camego = pose_to_mat(
                c["sensor2ego_rotation"], c["sensor2ego_translation"]
            )
            camego2global = pose_to_mat(
                c["ego2global_rotation"], c["ego2global_translation"]
            )
            lidar2cam = np.linalg.inv(camego2global @ cam2camego) @ (
                lidarego2global @ lidar2lidarego
            )
            pimg = project_points_to_image(
                pts, lidar2cam, intrins[n], post_rots[n], post_trans[n]
            )
            out[n] = points_to_depth_map(
                pimg, H, W, tuple(self.grid_config["depth"][:2])
            )
        return out

    # ------------------------------------------------------------------
    def _rays(self, index: int, rng) -> np.ndarray:
        """7-frame x 6-cam ray supervision (`nuscenes_dataset_occ.py:197-270`).

        With `ray_cache_path` (tools/precompute_rays.py output), per-image
        records are loaded from the offline cache and only the key-ego rigid
        transform + WRS run here (SURVEY §7 hard-part 5)."""
        if self.ray_cache_path:
            return self._rays_cached(index, rng)
        info = self.infos[index]
        coors, depths, segs, rgbs, c2ws, Ks, time_ids = [], [], [], [], [], [], []
        s2es, e2gs = [], []
        for tix, time_id in enumerate([0] + self.aux_frames):
            sel = index + time_id
            if (
                sel < 0 or sel >= len(self.infos)
                or self.infos[sel]["scene_token"] != info["scene_token"]
            ):
                sel = index
            fr = self.infos[sel]
            for cam in fr["cams"].keys():
                c = fr["cams"][cam]
                path = self._data_path(c["data_path"])
                coor, depth = load_sparse_depth(path, self.depth_gt_path)
                seg_map = load_seg_map(path, self.semantic_gt_path)
                seg = seg_map[coor[:, 1], coor[:, 0]]
                img01 = (
                    np.asarray(Image.open(path).convert("RGB"), np.float32)
                    / 255.0
                )
                rgb = imagenet_normalize_01(img01)[coor[:, 1], coor[:, 0]]
                s2e, e2g = self._cam_pose(fr, cam)
                coors.append(coor.astype(np.float32))
                depths.append(depth)
                segs.append(seg)
                rgbs.append(rgb)
                Ks.append(np.asarray(c["cam_intrinsic"], np.float32))
                s2es.append(s2e)
                e2gs.append(e2g)
                time_ids.append(time_id)
        # sensor -> key ego (key pose from the key frame's own cams,
        # `nuscenes_dataset_occ.py:248-259`: per-cam key ego)
        n_cams = len(info["cams"])
        s2es = np.stack(s2es).reshape(-1, n_cams, 4, 4)
        e2gs = np.stack(e2gs).reshape(-1, n_cams, 4, 4)
        key_e2g = e2gs[0]  # (N, 4, 4) per-cam key ego pose
        c2w = (
            np.linalg.inv(key_e2g)[None] @ e2gs @ s2es
        ).reshape(-1, 4, 4).astype(np.float32)
        return build_rays(
            coors, depths, segs, rgbs, list(c2w), Ks,
            time_ids=time_ids,
            max_ray_nums=self.max_ray_nums,
            dynamic_classes=DYNAMIC_CLASSES,
            balance_weight=self.balance_weight,
            rng=rng,
        )

    # ------------------------------------------------------------------
    def _rays_cached(self, index: int, rng) -> np.ndarray:
        from ..geometry.rays import (
            cache_to_records,
            ray_weights,
            weighted_ray_sample,
        )

        info = self.infos[index]
        cams = list(info["cams"])
        # per-cam key ego pose (`nuscenes_dataset_occ.py:248-259`)
        key_inv = {
            cam: np.linalg.inv(self._cam_pose(info, cam)[1]) for cam in cams
        }
        rays_list, w_list = [], []
        for time_id in [0] + self.aux_frames:
            sel = index + time_id
            if (
                sel < 0 or sel >= len(self.infos)
                or self.infos[sel]["scene_token"] != info["scene_token"]
            ):
                sel = index
            fr = self.infos[sel]
            for cam in fr["cams"]:
                name = os.path.basename(fr["cams"][cam]["data_path"])
                cached = np.load(
                    os.path.join(self.ray_cache_path, name + ".npz")
                )["rays"]
                rec = cache_to_records(cached, key_inv[cam])
                rays_list.append(rec)
                w_list.append(
                    ray_weights(
                        rec[:, 3], time_id, self.balance_weight,
                        DYNAMIC_CLASSES,
                    )
                )
        rays = np.concatenate(rays_list, axis=0)
        weights = np.concatenate(w_list, axis=0)
        return weighted_ray_sample(
            rays, weights, self.max_ray_nums, rng
        ).astype(np.float32)

    # ------------------------------------------------------------------
    def evaluate(self, occ_preds: Sequence[np.ndarray]) -> Dict:
        """3-D mIoU protocol (`nuscenes_dataset_occ.py:361-386`)."""
        metric = MetricMIoU(num_classes=18, use_image_mask=True)
        for index, pred in enumerate(occ_preds):
            info = self.infos[index]
            occ = load_occ_gt(self._data_path(info["occ_path"]))
            metric.add_batch(
                pred,
                occ["voxel_semantics"],
                occ["mask_lidar"],
                occ["mask_camera"],
            )
        return metric.count_miou()
