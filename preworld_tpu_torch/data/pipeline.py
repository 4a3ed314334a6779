"""CPU data pipeline primitives: image aug, normalization, depth projection.

Counterpart of `preworld_tpu/data/pipeline.py`, the same numpy + PIL code.
Parity targets:
  * `PrepareImageInputs` aug + post-homography bookkeeping
    (`mmdet3d/datasets/pipelines/loading.py:901-1140`)
  * `PointToMultiViewDepth` z-buffered lidar depth maps (`loading.py:761-844`)
  * `LoadOccGTFromFile` (`loading.py:16-47`) + BEV-aug voxel flips
    (`loading.py:1217-1225`)
  * mmlab image normalization; torchvision ImageNet normalization for ray RGB

Pure numpy + PIL; every function is deterministic given an explicit rng.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image

# mmlab default (BGR-order stats applied after RGB conversion upstream —
# mmcv img_norm uses these on RGB with to_rgb=True)
MMLAB_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
MMLAB_STD = np.array([58.395, 57.12, 57.375], np.float32)
# torchvision ImageNet stats (ray RGB labels, `nuscenes_dataset_occ.py:133-140`)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def quat_to_rotmat(w: float, x: float, y: float, z: float) -> np.ndarray:
    """Unit-quaternion -> 3x3 rotation matrix (pyquaternion convention)."""
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ],
        np.float64,
    )


def pose_to_mat(rotation_quat, translation) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = quat_to_rotmat(*rotation_quat)
    m[:3, 3] = translation
    return m


def mmlab_normalize(img: Image.Image) -> np.ndarray:
    """PIL RGB -> normalized float32 (H, W, 3) (mmcv imnormalize parity)."""
    arr = np.asarray(img, np.float32)
    return (arr - MMLAB_MEAN) / MMLAB_STD


def imagenet_normalize_01(img01: np.ndarray) -> np.ndarray:
    """[0,1] float RGB -> ImageNet-normalized (ray color labels)."""
    return (img01 - IMAGENET_MEAN) / IMAGENET_STD


@dataclasses.dataclass
class ImgAug:
    resize: float
    resize_dims: Tuple[int, int]  # (W, H)
    crop: Tuple[int, int, int, int]
    flip: bool
    rotate: float


def sample_img_augmentation(
    data_config: Dict,
    src_h: int,
    src_w: int,
    is_train: bool,
    rng: Optional[np.random.Generator] = None,
) -> ImgAug:
    """Parity with `sample_augmentation` (`loading.py:975-1001`)."""
    rng = rng or np.random.default_rng()
    f_h, f_w = data_config["input_size"]
    if is_train:
        resize = float(f_w) / float(src_w)
        resize += rng.uniform(*data_config["resize"])
        new_w, new_h = int(src_w * resize), int(src_h * resize)
        crop_h = int((1 - rng.uniform(*data_config["crop_h"])) * new_h) - f_h
        crop_w = int(rng.uniform(0, max(0, new_w - f_w)))
        crop = (crop_w, crop_h, crop_w + f_w, crop_h + f_h)
        flip = bool(data_config["flip"]) and bool(rng.integers(0, 2))
        rotate = float(rng.uniform(*data_config["rot"]))
    else:
        resize = float(f_w) / float(src_w) + data_config.get("resize_test", 0.0)
        new_w, new_h = int(src_w * resize), int(src_h * resize)
        crop_h = int((1 - np.mean(data_config["crop_h"])) * new_h) - f_h
        crop_w = int(max(0, new_w - f_w) / 2)
        crop = (crop_w, crop_h, crop_w + f_w, crop_h + f_h)
        flip = False
        rotate = 0.0
    return ImgAug(resize, (new_w, new_h), crop, flip, rotate)


def _rot2d(h: float) -> np.ndarray:
    return np.array(
        [[np.cos(h), np.sin(h)], [-np.sin(h), np.cos(h)]], np.float32
    )


def transform_image(img: Image.Image, aug: ImgAug) -> Image.Image:
    """Resize/crop/flip/rotate (`img_transform_core`, `loading.py:955-962`)."""
    img = img.resize(aug.resize_dims)
    img = img.crop(aug.crop)
    if aug.flip:
        img = img.transpose(method=Image.FLIP_LEFT_RIGHT)
    return img.rotate(aug.rotate)


def aug_homography(aug: ImgAug) -> Tuple[np.ndarray, np.ndarray]:
    """post_rot (3,3) / post_tran (3,) for the sampled aug
    (`img_transform`, `loading.py:934-953`)."""
    post_rot2 = np.eye(2, dtype=np.float32) * aug.resize
    post_tran2 = -np.array(aug.crop[:2], np.float32)
    if aug.flip:
        A = np.array([[-1, 0], [0, 1]], np.float32)
        b = np.array([aug.crop[2] - aug.crop[0], 0], np.float32)
        post_rot2 = A @ post_rot2
        post_tran2 = A @ post_tran2 + b
    A = _rot2d(np.deg2rad(aug.rotate))
    b = np.array(
        [aug.crop[2] - aug.crop[0], aug.crop[3] - aug.crop[1]], np.float32
    ) / 2.0
    b = A @ (-b) + b
    post_rot2 = A @ post_rot2
    post_tran2 = A @ post_tran2 + b
    rot3 = np.eye(3, dtype=np.float32)
    tran3 = np.zeros(3, np.float32)
    rot3[:2, :2] = post_rot2
    tran3[:2] = post_tran2
    return rot3, tran3


def points_to_depth_map(
    points_img: np.ndarray,
    height: int,
    width: int,
    depth_range: Tuple[float, float],
    downsample: int = 1,
) -> np.ndarray:
    """Z-buffered sparse depth map (`points2depthmap`, `loading.py:768-787`).

    points_img: (P, 3) of (u, v, depth) in augmented input-image pixels.
    """
    h, w = height // downsample, width // downsample
    depth_map = np.zeros((h, w), np.float32)
    coor = np.round(points_img[:, :2] / downsample)
    depth = points_img[:, 2]
    kept = (
        (coor[:, 0] >= 0)
        & (coor[:, 0] < w)
        & (coor[:, 1] >= 0)
        & (coor[:, 1] < h)
        & (depth < depth_range[1])
        & (depth >= depth_range[0])
    )
    coor, depth = coor[kept], depth[kept]
    ranks = coor[:, 0] + coor[:, 1] * w
    order = np.argsort(ranks + depth / 100.0)
    coor, depth, ranks = coor[order], depth[order], ranks[order]
    keep_first = np.ones(coor.shape[0], bool)
    keep_first[1:] = ranks[1:] != ranks[:-1]
    coor, depth = coor[keep_first].astype(np.int64), depth[keep_first]
    depth_map[coor[:, 1], coor[:, 0]] = depth
    return depth_map


def project_points_to_image(
    points_lidar: np.ndarray,
    lidar2cam: np.ndarray,
    cam2img: np.ndarray,
    post_rot: np.ndarray,
    post_tran: np.ndarray,
) -> np.ndarray:
    """lidar xyz -> (u, v, depth) in augmented image coords
    (`PointToMultiViewDepth.__call__`, `loading.py:789-844`)."""
    lidar2img = np.eye(4)
    lidar2img[:3, :3] = cam2img
    lidar2img = lidar2img @ lidar2cam
    p = points_lidar[:, :3] @ lidar2img[:3, :3].T + lidar2img[:3, 3]
    p = np.concatenate([p[:, :2] / p[:, 2:3], p[:, 2:3]], axis=1)
    p = p @ post_rot.T + post_tran[None, :]
    return p


def load_occ_gt(occ_path: str) -> Dict[str, np.ndarray]:
    """`labels.npz` -> semantics + lidar/camera masks (`loading.py:16-47`)."""
    data = np.load(os.path.join(occ_path, "labels.npz"))
    return {
        "voxel_semantics": data["semantics"],
        "mask_lidar": data["mask_lidar"].astype(bool),
        "mask_camera": data["mask_camera"].astype(bool),
    }


def flip_voxels(
    arrays: Dict[str, np.ndarray], flip_dx: bool, flip_dy: bool
) -> Dict[str, np.ndarray]:
    """Apply the bda flips to voxel GT arrays (`loading.py:1217-1225`)."""
    out = {}
    for k, v in arrays.items():
        if flip_dx:
            v = v[::-1, ...].copy()
        if flip_dy:
            v = v[:, ::-1, ...].copy()
        out[k] = v
    return out


def load_sparse_depth(img_file_path: str, gt_path: str):
    """Per-image `.bin` of (u, v, depth) (`nuscenes_dataset_occ.py:47-56`)."""
    file_name = os.path.split(img_file_path)[-1]
    cam_depth = np.fromfile(
        os.path.join(gt_path, f"{file_name}.bin"), dtype=np.float32
    ).reshape(-1, 3)
    return cam_depth[:, :2].astype(np.int32), cam_depth[:, 2]


def load_seg_map(
    img_file_path: str, gt_path: str, img_size=(900, 1600)
) -> np.ndarray:
    """Sparse lidarseg projection -> dense label map
    (`nuscenes_dataset_occ.py:58-66`)."""
    coor, seg_label = load_sparse_depth(img_file_path, gt_path)
    seg_map = np.zeros(img_size, np.float32)
    seg_map[coor[:, 1], coor[:, 0]] = seg_label
    return seg_map
