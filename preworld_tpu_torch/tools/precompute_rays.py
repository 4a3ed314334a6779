"""Precompute per-image ray supervision records (offline, run once).

    python -m preworld_tpu_torch.tools.precompute_rays ANN.pkl
        --depth-gt-path D --semantic-gt-path S --out-dir rays_cache
        [--data-root R] [--workers 16]

The port's counterpart of `tools/precompute_rays.py`, with its flags and
defaults and, array for array, its output: each image's records are built
once, in the global frame (key-frame-agnostic, so adjacent samples share
aux-frame caches), and the dataset's `ray_cache_path` fast path then only
applies the key-ego rigid transform and the weighted ray sample per
sample. Output: OUT_DIR/<image_basename>.npz with key 'rays' (M, 13)
float32, [u, v, depth, seg, origin_global(3), dir_global(3),
rgb_imagenet(3)] (`geometry.rays.build_image_ray_cache`); an image whose
cache exists is skipped. Host only (numpy, PIL) on `--workers` threads;
no device is used. Returns the number of caches written.
"""

from __future__ import annotations

import argparse
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image

from ..data.pipeline import (
    imagenet_normalize_01,
    load_seg_map,
    load_sparse_depth,
    pose_to_mat,
)
from ..geometry.rays import build_image_ray_cache


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ann_file")
    p.add_argument("--depth-gt-path", required=True)
    p.add_argument("--semantic-gt-path", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--data-root", default="")
    p.add_argument("--workers", type=int, default=16)
    return p.parse_args(argv)


def image_rays(path: str, c, depth_gt_path: str,
               semantic_gt_path: str) -> np.ndarray:
    """The (M, 13) float32 global-frame records of the image at `path`,
    camera record `c` of its info."""
    coor, depth = load_sparse_depth(path, depth_gt_path)
    seg_map = load_seg_map(path, semantic_gt_path)
    seg = seg_map[coor[:, 1], coor[:, 0]]
    img01 = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    rgb = imagenet_normalize_01(img01)[coor[:, 1], coor[:, 0]]
    s2e = pose_to_mat(c["sensor2ego_rotation"], c["sensor2ego_translation"])
    e2g = pose_to_mat(c["ego2global_rotation"], c["ego2global_translation"])
    return build_image_ray_cache(
        coor.astype(np.float32), depth, seg, rgb,
        np.asarray(c["cam_intrinsic"], np.float32),
        (e2g @ s2e).astype(np.float32),
    )


def main(argv=None) -> int:
    args = parse_args(argv)
    with open(args.ann_file, "rb") as f:
        infos = pickle.load(f)["infos"]
    os.makedirs(args.out_dir, exist_ok=True)

    jobs = {}
    for info in infos:
        for c in info["cams"].values():
            path = c["data_path"]
            if not os.path.isabs(path) and args.data_root:
                path = os.path.join(args.data_root, path)
            jobs.setdefault(os.path.basename(path), (path, c))

    def one(item):
        name, (path, c) = item
        out = os.path.join(args.out_dir, name + ".npz")
        if os.path.exists(out):
            return 0
        rays = image_rays(path, c, args.depth_gt_path, args.semantic_gt_path)
        np.savez_compressed(out, rays=rays)
        return 1

    with ThreadPoolExecutor(args.workers) as pool:
        done = sum(pool.map(one, jobs.items()))
    print(f"wrote {done} new caches ({len(jobs)} images) -> {args.out_dir}")
    return done


if __name__ == "__main__":
    main()
