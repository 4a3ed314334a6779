"""Ray records and their builders: Weighted Ray Sampling (WRS) for the
render head's supervision.

Counterpart of `preworld_tpu/geometry/rays.py` (numpy, run by the data
pipeline on the host). A batch carries its rays as a fixed-size
(B, R, RAY_DIM) f32 array, one 16-float record per ray,

    [u, v, depth, seg, rays_o(3), rays_d(3), viewdirs(3), rgb(3)]

(pixel, lidar depth, semantic label, origin, direction, unit direction,
colour; reference `ray.py:49-56`). The records are always built by the
numpy `pts2ray`: the port does not load the JAX package's optional native
library (`native/libpreworld_native.so`), whose record builder does the
same arithmetic.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

RAY_DIM = 16
PIXEL = slice(0, 2)
DEPTH = 2
SEMANTIC = 3
ORIGIN = slice(4, 7)
DIRECTION = slice(7, 10)
UNIT_DIRECTION = slice(10, 13)
COLOR = slice(13, 16)


def get_rays(i: np.ndarray, j: np.ndarray, intrinsic: np.ndarray,
             c2w: np.ndarray):
    """Pinhole rays through pixel centers (i, j) in the c2w frame.

    Parity with `ray.py:34-45` (inverse_y=True convention).
    Returns (rays_o, rays_d, viewdirs), each (N, 3).
    """
    dirs = np.stack(
        [
            (i - intrinsic[0, 2]) / intrinsic[0, 0],
            (j - intrinsic[1, 2]) / intrinsic[1, 1],
            np.ones_like(i),
        ],
        axis=-1,
    )
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    return (rays_o.astype(np.float32), rays_d.astype(np.float32),
            viewdirs.astype(np.float32))


def pts2ray(
    coor: np.ndarray,
    label_depth: np.ndarray,
    label_seg: np.ndarray,
    label_img: np.ndarray,
    c2w: np.ndarray,
    intrinsic: np.ndarray,
) -> np.ndarray:
    """Pack per-pixel labels into the 16-float ray record (`ray.py:49-56`)."""
    rays_o, rays_d, viewdirs = get_rays(
        coor[:, 0] + 0.5, coor[:, 1] + 0.5, intrinsic, c2w
    )
    return np.concatenate(
        [
            coor.astype(np.float32),
            label_depth[:, None].astype(np.float32),
            label_seg[:, None].astype(np.float32),
            rays_o,
            rays_d,
            viewdirs,
            label_img.astype(np.float32),
        ],
        axis=1,
    )


def class_balance_weights(seg_labels: np.ndarray,
                          num_classes: int = 17) -> np.ndarray:
    """Per-class WRS balance weight exp(0.005 * (max/n - 1)).

    Parity with `nuscenes_dataset_occ.py:23-29` computed over the batch when no
    dataset-level weight is given (`ray.py:94-99`).
    """
    counts = np.array(
        [(seg_labels == c).sum() for c in range(num_classes)], np.float64
    )
    counts = np.maximum(counts, 1e-12)
    # Clamp the exponent: the reference only ever evaluates this on
    # dataset-level counts, but the per-batch fallback can see near-empty
    # classes where max/n blows exp() to inf and degenerates WRS.
    expo = np.minimum(0.005 * (counts.max() / counts - 1.0), 60.0)
    return np.exp(expo).astype(np.float32)


def ray_weights(
    seg: np.ndarray,
    time_id: int,
    balance_weight: np.ndarray,
    dynamic_classes: Sequence[int] = (0, 1, 3, 4, 5, 7, 9, 10),
    weight_adj: float = 0.3,
    weight_dyn: float = 0.0,
) -> np.ndarray:
    """Per-ray WRS weight for one (frame, cam) image (`ray.py:94-111`):
    class-balance x temporal (1.0 key frame / weight_adj aux, weight_dyn for
    dynamic-class pixels in aux frames)."""
    seg = seg.astype(np.int64)
    w_t = np.full(seg.shape[0], 1.0 if time_id == 0 else weight_adj,
                  np.float32)
    if time_id != 0:
        w_t[np.isin(seg, np.asarray(dynamic_classes))] = weight_dyn
    w_b = balance_weight[np.clip(seg, 0, len(balance_weight) - 1)]
    return w_b * w_t


def weighted_ray_sample(
    rays: np.ndarray,
    weights: np.ndarray,
    num_samples: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Weighted sampling WITHOUT replacement down to `num_samples` rays.

    Parity with torch's WeightedRandomSampler(replacement=False) use in
    `ray.py:116-118`, via the exponential-sort (Efraimidis-Spirakis) trick.
    If fewer rays than requested, pads by repeating (keeps shape static).
    """
    n = rays.shape[0]
    if n >= num_samples:
        keys = rng.exponential(size=n) / np.maximum(weights, 1e-12)
        idx = np.argpartition(keys, num_samples - 1)[:num_samples]
    else:
        extra = rng.integers(0, n, size=num_samples - n)
        idx = np.concatenate([np.arange(n), extra])
    return rays[idx]


def build_rays(
    coors: Sequence[np.ndarray],
    label_depths: Sequence[np.ndarray],
    label_segs: Sequence[np.ndarray],
    label_imgs: Sequence[np.ndarray],
    c2ws: Sequence[np.ndarray],
    intrins: Sequence[np.ndarray],
    time_ids: Sequence[int],
    max_ray_nums: int,
    dynamic_classes: Sequence[int] = (0, 1, 3, 4, 5, 7, 9, 10),
    balance_weight: Optional[np.ndarray] = None,
    weight_adj: float = 0.3,
    weight_dyn: float = 0.0,
    use_wrs: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Generate the fixed-size ray supervision array for one sample.

    Parity with `generate_rays` (`ray.py:59-119`): one entry per (frame, cam)
    image, temporal weight 1.0 for the key frame / `weight_adj` for aux frames,
    0 (`weight_dyn`) for dynamic-class pixels in aux frames, times the
    class-balance weight; then WRS down to `max_ray_nums`.

    Args: lists indexed by (frame, cam) flattened; `time_ids[i]` gives the
    frame offset id of entry i (0 == key frame).
    Returns: (max_ray_nums, 16) float32.
    """
    rng = rng or np.random.default_rng(0)
    ray_list: List[np.ndarray] = []
    weight_list: List[np.ndarray] = []

    if balance_weight is None and use_wrs:
        all_segs = np.concatenate([np.asarray(s) for s in label_segs])
        balance_weight = class_balance_weights(all_segs)

    dyn = np.asarray(dynamic_classes)
    for i in range(len(coors)):
        ray = pts2ray(
            np.asarray(coors[i], np.float32),
            np.asarray(label_depths[i], np.float32),
            np.asarray(label_segs[i], np.float32),
            np.asarray(label_imgs[i], np.float32),
            np.asarray(c2ws[i], np.float32),
            np.asarray(intrins[i], np.float32),
        )
        ray_list.append(ray)
        if use_wrs:
            weight_list.append(
                ray_weights(
                    ray[:, 3], time_ids[i], balance_weight,
                    dyn, weight_adj, weight_dyn,
                )
            )

    rays = np.concatenate(ray_list, axis=0)
    if not use_wrs:
        if rays.shape[0] > max_ray_nums:
            idx = rng.choice(rays.shape[0], max_ray_nums, replace=False)
            rays = rays[idx]
        return _pad_rays(rays, max_ray_nums, rng)
    weights = np.concatenate(weight_list, axis=0)
    rays = weighted_ray_sample(rays, weights, max_ray_nums, rng)
    return rays.astype(np.float32)


def _pad_rays(rays: np.ndarray, n: int,
              rng: np.random.Generator) -> np.ndarray:
    if rays.shape[0] >= n:
        return rays[:n].astype(np.float32)
    extra = rng.integers(0, rays.shape[0], size=n - rays.shape[0])
    return np.concatenate([rays, rays[extra]], axis=0).astype(np.float32)


# --------------------------------------------------------------------------
# Offline ray cache (SURVEY §7 hard-part 5): the reference rebuilds every ray
# record per __getitem__ from 84 files (7 frames x 6 cams x depth/seg .bins +
# full-res JPEG decodes, `nuscenes_dataset_occ.py:197-270`). We precompute
# per-IMAGE records once, in the GLOBAL frame so they are key-frame-agnostic
# (adjacent samples share aux-frame images); per sample only a rigid
# transform into the key ego frame + WRS remain.

RAY_CACHE_DIM = 13  # [u, v, depth, seg, o_global(3), d_global(3), rgb(3)]


def build_image_ray_cache(
    coor: np.ndarray,
    depth: np.ndarray,
    seg: np.ndarray,
    rgb: np.ndarray,
    intrinsic: np.ndarray,
    c2w_global: np.ndarray,
) -> np.ndarray:
    """Key-agnostic per-image records, (M, RAY_CACHE_DIM) float32."""
    rays_o, rays_d, _ = get_rays(
        coor[:, 0] + 0.5, coor[:, 1] + 0.5, intrinsic, c2w_global
    )
    return np.concatenate(
        [
            coor.astype(np.float32),
            np.asarray(depth, np.float32)[:, None],
            np.asarray(seg, np.float32)[:, None],
            rays_o, rays_d,
            np.asarray(rgb, np.float32),
        ],
        axis=1,
    ).astype(np.float32)


def cache_to_records(cached: np.ndarray, key_inv: np.ndarray) -> np.ndarray:
    """(M, 13) global-frame cache + inv(key ego pose) -> (M, 16) ray record
    in the key ego frame (same layout as `pts2ray`)."""
    o = cached[:, 4:7] @ key_inv[:3, :3].T + key_inv[:3, 3]
    d = cached[:, 7:10] @ key_inv[:3, :3].T
    view = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate(
        [cached[:, :4], o, d, view, cached[:, 10:13]], axis=1
    ).astype(np.float32)


RAY_DENSE_DIM = 14


def build_rays_dense(
    coors: Sequence[np.ndarray],
    label_imgs: Sequence[np.ndarray],
    c2ws: Sequence[np.ndarray],
    intrins: Sequence[np.ndarray],
    max_ray_nums: int,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Dense RGB-only ray records, uniformly subsampled.

    Parity with `generate_rays_dense` (`ray.py:123-168`): 14 floats per ray
    [u, v, rays_o(3), rays_d(3), viewdirs(3), rgb(3)] — the `if_dense`
    photometric-only supervision path. Returns (max_ray_nums, 14).
    """
    rng = rng or np.random.default_rng(0)
    ray_list: List[np.ndarray] = []
    for i in range(len(coors)):
        coor = np.asarray(coors[i], np.float32)
        rays_o, rays_d, viewdirs = get_rays(
            coor[:, 0] + 0.5, coor[:, 1] + 0.5,
            np.asarray(intrins[i], np.float32),
            np.asarray(c2ws[i], np.float32),
        )
        ray_list.append(
            np.concatenate(
                [coor, rays_o, rays_d, viewdirs,
                 np.asarray(label_imgs[i], np.float32)],
                axis=1,
            )
        )
    rays = np.concatenate(ray_list, axis=0)
    if rays.shape[0] > max_ray_nums:
        idx = rng.choice(rays.shape[0], max_ray_nums, replace=False)
        rays = rays[idx]
    return _pad_rays(rays, max_ray_nums, rng)


def dense_pixel_coords(height: int, width: int) -> np.ndarray:
    """All pixel coordinates of an image as (h*w, 2) xy
    (`generate_dense_coors`, `nuscenes_dataset_occ.py:31-46`)."""
    xv, yv = np.meshgrid(np.arange(width), np.arange(height), indexing="xy")
    return np.stack([xv.reshape(-1), yv.reshape(-1)],
                    axis=1).astype(np.float32)
