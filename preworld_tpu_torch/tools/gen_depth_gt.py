"""Project lidar points into each camera -> per-image sparse depth `.bin`.

    python -m preworld_tpu_torch.tools.gen_depth_gt --ann-file INFOS.pkl
        [--data-root R] [--out-dir D] [--workers 8]

The port's counterpart of `tools/gen_depth_gt.py`, with its flags and
defaults and byte for byte its output: for every sample and camera, the
lidar sweep is moved into the camera frame (f64), points more than 0.1 m
in front of it that land inside the 1600x900 image are kept, and their
(u, v, depth) float32 triplets are written to `{out_dir}/{image file
name}.bin`, the format `data.pipeline.load_sparse_depth` reads. It runs
from the info pkl (no nuscenes-devkit) on a pool of `--workers` processes
on the host; no device is used. Returns the number of points written.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import pickle

import numpy as np

from ..data.pipeline import pose_to_mat


def lidar_points(info, data_root: str) -> np.ndarray:
    """The sample's lidar sweep, (P, 3) float32 x, y, z."""
    return np.fromfile(
        os.path.join(data_root, info["lidar_path"]), dtype=np.float32
    ).reshape(-1, 5)[:, :3]


def lidar_to_camera(info, c) -> np.ndarray:
    """(4, 4) f64 lidar -> camera c transform of the sample `info`."""
    lidar2lidarego = pose_to_mat(
        info["lidar2ego_rotation"], info["lidar2ego_translation"]
    )
    lidarego2global = pose_to_mat(
        info["ego2global_rotation"], info["ego2global_translation"]
    )
    cam2camego = pose_to_mat(
        c["sensor2ego_rotation"], c["sensor2ego_translation"]
    )
    camego2global = pose_to_mat(
        c["ego2global_rotation"], c["ego2global_translation"]
    )
    return np.linalg.inv(camego2global @ cam2camego) @ (
        lidarego2global @ lidar2lidarego
    )


def worker(args):
    info, data_root, out_dir = args
    pts = lidar_points(info, data_root)
    n = 0
    for c in info["cams"].values():
        lidar2cam = lidar_to_camera(info, c)
        K = np.asarray(c["cam_intrinsic"], np.float64)
        p_cam = pts @ lidar2cam[:3, :3].T + lidar2cam[:3, 3]
        front = p_cam[:, 2] > 0.1
        p_cam = p_cam[front]
        uvz = p_cam @ K.T
        uv = uvz[:, :2] / uvz[:, 2:3]
        keep = (
            (uv[:, 0] >= 0) & (uv[:, 0] < 1600)
            & (uv[:, 1] >= 0) & (uv[:, 1] < 900)
        )
        rec = np.concatenate(
            [uv[keep], p_cam[keep, 2:3]], axis=1
        ).astype(np.float32)
        fname = os.path.split(c["data_path"])[-1]
        rec.tofile(os.path.join(out_dir, f"{fname}.bin"))
        n += rec.shape[0]
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ann-file", required=True)
    p.add_argument("--data-root", default="data/nuscenes")
    p.add_argument("--out-dir", default="data/depth_gt")
    p.add_argument("--workers", type=int, default=8)
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    with open(args.ann_file, "rb") as f:
        infos = pickle.load(f)["infos"]
    tasks = [(i, args.data_root, args.out_dir) for i in infos]
    # spawned workers: the caller may hold threads (torch, a test runner)
    # that a forked child would inherit in whatever state they were in
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        total = sum(pool.map(worker, tasks))
    print(f"wrote depth GT for {len(infos)} samples ({total} points)")
    return total


if __name__ == "__main__":
    main()
