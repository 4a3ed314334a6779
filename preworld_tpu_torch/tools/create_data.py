"""Build bevdetv2-style nuScenes info pkls (offline, once).

    python -m preworld_tpu_torch.tools.create_data [--root-path R]
        [--version V] [--occ-gt-root G] [--out-prefix P]
        [--train-scenes S1,S2 --val-scenes S3]

The port's counterpart of `tools/create_data.py`, with its flags and
defaults and the same output: `{root}/{out_prefix}-nuscenes_infos_{train,
val}.pkl`, each `{"infos": [...], "metadata": {"version": V}}` with the
per-sample camera calibration / pose / path records, annotation infos,
scene tokens and the Occ3D `occ_path`, which `data.NuScenesOccDataset`
reads. It joins the raw nuScenes JSON tables (`{root}/{version}/*.json`)
itself (`SimpleNusc`); nuscenes-devkit, where it is installed, gives only
the canonical train / val scene names, else pass `--train-scenes` /
`--val-scenes`. Files only: no device is used. Returns {split: pkl path}.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import numpy as np


class SimpleNusc:
    """Minimal devkit-free reader over the raw nuScenes JSON tables."""

    TABLES = (
        "scene", "sample", "sample_data", "calibrated_sensor", "ego_pose",
        "sensor", "sample_annotation",
    )

    def __init__(self, version: str, root: str):
        self._t = {}
        for name in self.TABLES:
            path = os.path.join(root, version, f"{name}.json")
            with open(path) as f:
                rows = json.load(f)
            self._t[name] = {r["token"]: r for r in rows}
        self.sample = list(self._t["sample"].values())
        # key-frame sample_data per (sample, channel): the devkit's
        # sample['data'] map rebuilt from sample_data rows
        for s in self.sample:
            s.setdefault("data", {})
            s.setdefault("anns", [])
        sensors = self._t["sensor"]
        for sd in self._t["sample_data"].values():
            if not sd.get("is_key_frame", True):
                continue
            cs = self._t["calibrated_sensor"][sd["calibrated_sensor_token"]]
            channel = sensors[cs["sensor_token"]]["channel"]
            self._t["sample"][sd["sample_token"]]["data"][channel] = sd["token"]
        for ann in self._t["sample_annotation"].values():
            self._t["sample"][ann["sample_token"]]["anns"].append(ann["token"])

    def get(self, table: str, token: str):
        return self._t[table][token]


CAM_NAMES = [
    "CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
    "CAM_BACK_RIGHT", "CAM_BACK", "CAM_BACK_LEFT",
]


def build_infos(nusc, scenes, root_path: str, occ_gt_root: str):
    """The info records of every sample of `scenes`, timestamp-sorted, each
    with its frame index within its scene."""
    infos = []
    for sample in nusc.sample:
        scene = nusc.get("scene", sample["scene_token"])
        if scene["name"] not in scenes:
            continue
        lidar_token = sample["data"]["LIDAR_TOP"]
        sd = nusc.get("sample_data", lidar_token)
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = nusc.get("ego_pose", sd["ego_pose_token"])
        info = {
            "token": sample["token"],
            "scene_token": sample["scene_token"],
            "scene_name": scene["name"],
            "frame_idx": sample["token"],  # filled below
            "timestamp": sample["timestamp"],
            "lidar_path": sd["filename"],
            # lidar sample_data token: names the default lidarseg label file
            # (gen_seg_gt reads {seg_root}/{lidar_token}_lidarseg.bin)
            "lidar_token": lidar_token,
            "lidar2ego_rotation": cs["rotation"],
            "lidar2ego_translation": cs["translation"],
            "ego2global_rotation": pose["rotation"],
            "ego2global_translation": pose["translation"],
            "cams": {},
            "occ_path": os.path.join(
                occ_gt_root, scene["name"], sample["token"]
            ),
        }
        for cam in CAM_NAMES:
            cam_token = sample["data"][cam]
            csd = nusc.get("sample_data", cam_token)
            ccs = nusc.get("calibrated_sensor", csd["calibrated_sensor_token"])
            cpose = nusc.get("ego_pose", csd["ego_pose_token"])
            info["cams"][cam] = {
                "data_path": csd["filename"],
                "cam_intrinsic": np.asarray(ccs["camera_intrinsic"]),
                "sensor2ego_rotation": ccs["rotation"],
                "sensor2ego_translation": ccs["translation"],
                "ego2global_rotation": cpose["rotation"],
                "ego2global_translation": cpose["translation"],
            }
        # annotation infos (agent boxes) for BEV aug + planning extensions
        info["ann_infos"] = [nusc.get("sample_annotation", t)
                             for t in sample["anns"]]
        infos.append(info)
    # frame index within scene, timestamp-sorted
    infos.sort(key=lambda e: e["timestamp"])
    counters = {}
    for info in infos:
        c = counters.get(info["scene_token"], 0)
        info["frame_idx"] = c
        counters[info["scene_token"]] = c + 1
    return infos


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root-path", default="data/nuscenes")
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--occ-gt-root", default="data/nuscenes/gts")
    p.add_argument("--out-prefix", default="bevdetv2")
    p.add_argument("--train-scenes", default=None,
                   help="comma-separated scene names (devkit-free splits)")
    p.add_argument("--val-scenes", default=None)
    args = p.parse_args(argv)

    nusc = SimpleNusc(args.version, args.root_path)
    if args.train_scenes is not None or args.val_scenes is not None:
        split_map = {
            "train": (args.train_scenes or "").split(","),
            "val": (args.val_scenes or "").split(","),
        }
        split_map = {k: [s for s in v if s] for k, v in split_map.items()}
    else:
        try:
            from nuscenes.utils import splits
        except ImportError:
            sys.exit(
                "no --train-scenes/--val-scenes given and nuscenes-devkit "
                "(for the canonical split lists) is not installed"
            )
        if args.version == "v1.0-mini":
            split_map = {"train": splits.mini_train, "val": splits.mini_val}
        else:
            split_map = {"train": splits.train, "val": splits.val}
    written = {}
    for split, scenes in split_map.items():
        infos = build_infos(nusc, set(scenes), args.root_path, args.occ_gt_root)
        out = os.path.join(
            args.root_path, f"{args.out_prefix}-nuscenes_infos_{split}.pkl"
        )
        with open(out, "wb") as f:
            pickle.dump(
                {"infos": infos, "metadata": {"version": args.version}}, f
            )
        print(f"wrote {len(infos)} infos -> {out}")
        written[split] = out
    return written


if __name__ == "__main__":
    main()
