"""Project lidarseg labels into each camera -> per-image `.bin` of
(u, v, label) float32 triplets.

    python -m preworld_tpu_torch.tools.gen_seg_gt --ann-file INFOS.pkl
        [--data-root R] [--seg-root S] [--out-dir D] [--label-map MAP.json]
        [--workers 8]

The port's counterpart of `tools/gen_seg_gt.py`, with its flags and
defaults and byte for byte its output: `gen_depth_gt`'s projection,
carrying each point's lidarseg class, mapped to the 17 Occ3D classes
(`DEFAULT_LABEL_MAP`, or `--label-map`, a json {src_id: dst_id}), instead
of its depth; `data.pipeline.load_seg_map` reads the files. A sample's
uint8 label file is `{data_root}/{lidarseg_path}` where its info names one,
else `{seg_root}/{lidar_token}_lidarseg.bin`; a sample without one writes
nothing. Host only, on a pool of `--workers` processes; no device is used.
Returns the number of points written.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import pickle

import numpy as np

from .gen_depth_gt import lidar_points, lidar_to_camera

# default nuScenes lidarseg (32 classes) -> Occ3D-nuScenes 17 classes
DEFAULT_LABEL_MAP = {
    0: 0, 1: 0, 5: 0, 7: 0, 8: 0, 10: 0, 11: 0, 13: 0, 19: 0, 20: 0,
    29: 0, 31: 0,
    9: 1, 14: 2, 15: 3, 16: 3, 17: 4, 18: 5, 21: 6, 2: 7, 3: 7, 4: 7,
    6: 7, 12: 8, 22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15,
    30: 16,
}


def label_file(info, data_root: str, seg_root: str):
    """The sample's lidarseg label file, or None where its info names none."""
    path = info.get("lidarseg_path") or None
    if path is not None:
        return os.path.join(data_root, path)
    # default layout: lidarseg/<version>/<lidar_token>_lidarseg.bin
    token = info.get("lidar_token")
    if token is None:
        return None
    return os.path.join(seg_root, f"{token}_lidarseg.bin")


def worker(args):
    info, data_root, seg_root, out_dir, label_map = args
    pts = lidar_points(info, data_root)
    seg_path = label_file(info, data_root, seg_root)
    if seg_path is None or not os.path.exists(seg_path):
        return 0
    labels = np.fromfile(seg_path, dtype=np.uint8)
    lut = np.zeros(256, np.uint8)
    for s, d in label_map.items():
        lut[int(s)] = int(d)
    labels = lut[labels]

    n = 0
    for c in info["cams"].values():
        lidar2cam = lidar_to_camera(info, c)
        K = np.asarray(c["cam_intrinsic"], np.float64)
        p_cam = pts @ lidar2cam[:3, :3].T + lidar2cam[:3, 3]
        front = p_cam[:, 2] > 0.1
        uvz = p_cam[front] @ K.T
        uv = uvz[:, :2] / uvz[:, 2:3]
        lab = labels[front]
        keep = (
            (uv[:, 0] >= 0) & (uv[:, 0] < 1600)
            & (uv[:, 1] >= 0) & (uv[:, 1] < 900)
        )
        rec = np.concatenate(
            [uv[keep], lab[keep, None].astype(np.float64)], axis=1
        ).astype(np.float32)
        fname = os.path.split(c["data_path"])[-1]
        rec.tofile(os.path.join(out_dir, f"{fname}.bin"))
        n += rec.shape[0]
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ann-file", required=True)
    p.add_argument("--data-root", default="data/nuscenes")
    p.add_argument("--seg-root", default="data/nuscenes/lidarseg/v1.0-trainval")
    p.add_argument("--out-dir", default="data/seg_gt_lidarseg")
    p.add_argument("--label-map", default=None, help="json {src: dst}")
    p.add_argument("--workers", type=int, default=8)
    args = p.parse_args(argv)

    label_map = DEFAULT_LABEL_MAP
    if args.label_map:
        with open(args.label_map) as f:
            label_map = {int(k): int(v) for k, v in json.load(f).items()}

    os.makedirs(args.out_dir, exist_ok=True)
    with open(args.ann_file, "rb") as f:
        infos = pickle.load(f)["infos"]
    tasks = [
        (i, args.data_root, args.seg_root, args.out_dir, label_map)
        for i in infos
    ]
    # spawned workers, as in gen_depth_gt
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        total = sum(pool.map(worker, tasks))
    print(f"wrote seg GT for {len(infos)} samples ({total} points)")
    return total


if __name__ == "__main__":
    main()
