"""Render predicted occupancy grids to images (matplotlib, headless).

    python -m preworld_tpu_torch.tools.visualization.visual PRED_DIR
        [--out-dir vis] [--max-samples 20] [--viewpoints builtin|DIR]

The port's counterpart of `tools/visualization/visual.py`, with its flags
and the same images: a BEV class map and a z-coloured 3-D scatter per
sample in the Occ3D palette, and with `--viewpoints` the reference's
7-view panel (6 surround cameras over a top view). Input: .npz prediction
dumps of `python -m preworld_tpu_torch.tools.test --out` (key `semantics`,
(X, Y, Z) uint8 / int) or raw occupancy `labels.npz` files. Host only:
matplotlib, imported inside the functions (the card's machine need not
have it); no device is used. Returns the paths written.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# Occ3D palette (`mmdet3d/models/detectors/bevdet_occ.py:15-35`)
COLORS = np.array(
    [
        [0, 0, 0], [255, 158, 0], [0, 0, 230], [200, 0, 0], [220, 20, 60],
        [200, 200, 200], [255, 140, 0], [233, 150, 70], [255, 61, 99],
        [112, 128, 144], [222, 184, 135], [100, 100, 100], [165, 42, 42],
        [50, 50, 50], [75, 0, 75], [255, 0, 0], [0, 175, 0], [255, 255, 255],
    ],
    np.uint8,
)


def render(sem: np.ndarray, out_path: str, free_idx: int = 17):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(16, 8))

    # BEV: topmost non-free class per (x, y) column
    occ = sem != free_idx
    top_z = np.where(occ.any(-1), occ.shape[-1] - 1 - np.argmax(occ[..., ::-1], -1), -1)
    bev = np.full(sem.shape[:2], free_idx, sem.dtype)
    has = top_z >= 0
    xs, ys = np.nonzero(has)
    bev[xs, ys] = sem[xs, ys, top_z[xs, ys]]
    axes[0].imshow(COLORS[np.clip(bev.T, 0, 17)], origin="lower")
    axes[0].set_title("BEV semantic occupancy")
    axes[0].set_xlabel("x")
    axes[0].set_ylabel("y")

    # sparse 3D scatter
    idx = np.argwhere(occ)
    if idx.shape[0] > 0:
        sub = idx[:: max(1, idx.shape[0] // 60000)]
        ax3 = fig.add_subplot(1, 2, 2, projection="3d")
        axes[1].axis("off")
        c = COLORS[np.clip(sem[sub[:, 0], sub[:, 1], sub[:, 2]], 0, 17)] / 255.0
        ax3.scatter(sub[:, 0], sub[:, 1], sub[:, 2], c=c, s=1, marker="s")
        ax3.set_box_aspect((sem.shape[0], sem.shape[1], sem.shape[2] * 4))
        ax3.set_title("3D occupancy")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


# ---------------------------------------------------------------------------
# Per-camera-viewpoint renders (reference protocol): the reference renders
# each frame from 6 surround viewpoints + a top view through open3d pinhole
# cameras, with sky masking (z-planes above 3 m -> free), ego-car masking,
# horizontal flip of the back cameras, and a merged panel
# (`tools/visualization/visual.py:10-58`, `vis_tool.py:147-200`,
# `viewpoint_params/*.json`). Without open3d, occupied voxel centers are
# projected through the same pinhole model and painted as depth-sorted
# squares with matplotlib. `--viewpoints DIR` consumes the
# reference's own open3d PinholeCameraParameters JSONs for exact pose
# parity; `--viewpoints builtin` uses an original 7-camera rig of the same
# shape (no reference assets required).
# ---------------------------------------------------------------------------

VIEW_NAMES = ["front_left", "front", "front_right",
              "back_left", "back", "back_right", "top"]


def mask_sky(occ, n=3, free_idx=17):
    """Reference `mask_sky` (`visual.py:10-12`): free the top n z-planes."""
    occ = occ.copy()
    occ[:, :, -n:] = free_idx
    return occ


def mask_ego_car(occ, free_idx=17):
    """Reference `mask_ego_car` (`visual.py:14-16`); 200x200x16 grids."""
    occ = occ.copy()
    if occ.shape[:2] == (200, 200):
        occ[93:107, 95:105, 4:8] = free_idx
    return occ


def visual_ego_car(occ):
    """Reference `visual_ego_car` (`visual.py:18-20`): ego cube, class 4."""
    occ = occ.copy()
    if occ.shape[:2] == (200, 200):
        occ[96:103, 98:102, 4:7] = 4
    return occ


def load_viewpoint_json(path):
    """open3d PinholeCameraParameters JSON -> (R, t, K, W, H).

    open3d serializes matrices COLUMN-major; extrinsic is world->camera in
    the CV convention (x right, y down, z forward)."""
    import json

    with open(path) as f:
        d = json.load(f)
    ext = np.array(d["extrinsic"], np.float64).reshape(4, 4, order="F")
    K = np.array(
        d["intrinsic"]["intrinsic_matrix"], np.float64
    ).reshape(3, 3, order="F")
    return (ext[:3, :3], ext[:3, 3], K,
            d["intrinsic"]["width"], d["intrinsic"]["height"])


def _lookat(cam_pos, target, up_hint=(0.0, 0.0, 1.0)):
    """World->camera (R, t) in the CV convention looking at `target`."""
    fwd = np.asarray(target, np.float64) - np.asarray(cam_pos, np.float64)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up_hint, np.float64))
    n = np.linalg.norm(right)
    if n < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    else:
        right /= n
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])  # rows = cam axes in world
    t = -R @ np.asarray(cam_pos, np.float64)
    return R, t


def builtin_viewpoints():
    """Original 7-viewpoint rig of the reference's shape: six surround
    cameras hovering behind/above the ego looking forward-down, one
    top-down view. Same pinhole model as the reference JSONs (1600x900,
    f=780) but ORIGINAL poses — point --viewpoints at the reference's
    viewpoint_params/ directory for exact pose parity."""
    W, H, f = 1600, 900, 780.0
    K = np.array([[f, 0, (W - 1) / 2.0], [0, f, (H - 1) / 2.0], [0, 0, 1.0]])
    views = {}
    yaws = {"front_left": 55.0, "front": 0.0, "front_right": -55.0,
            "back_left": 125.0, "back": 180.0, "back_right": -125.0}
    for name, yaw in yaws.items():
        a = np.deg2rad(yaw)
        d = np.array([np.cos(a), np.sin(a), 0.0])
        cam = -10.0 * d + np.array([0.0, 0.0, 7.0])
        R, t = _lookat(cam, 18.0 * d + np.array([0.0, 0.0, 0.0]))
        views[name] = (R, t, K, W, H)
    R, t = _lookat((0.0, 0.0, 70.0), (0.0, 0.0, 0.0), up_hint=(1.0, 0.0, 0.0))
    views["top"] = (R, t, K, W, H)
    return views


def render_view(sem, R, t, K, W, H, free_idx=17,
                pc_range=(-40.0, -40.0, -1.0), voxel=0.4, scale=0.35):
    """Project occupied voxel centers through a pinhole view -> RGB array."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    idx = np.argwhere(sem != free_idx)
    rgb_w, rgb_h = int(W * scale), int(H * scale)
    fig = plt.figure(figsize=(rgb_w / 100.0, rgb_h / 100.0), dpi=100)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.set_xlim(0, W)
    ax.set_ylim(H, 0)
    ax.axis("off")
    ax.set_facecolor("white")
    if idx.shape[0]:
        pts = (idx + 0.5) * voxel + np.asarray(pc_range)
        cam = pts @ R.T + t
        z = cam[:, 2]
        keep = z > 0.5
        cam, z = cam[keep], z[keep]
        labels = sem[idx[keep, 0], idx[keep, 1], idx[keep, 2]]
        u = K[0, 0] * cam[:, 0] / z + K[0, 2]
        v = K[1, 1] * cam[:, 1] / z + K[1, 2]
        inb = (u >= -50) & (u < W + 50) & (v >= -50) & (v < H + 50)
        u, v, z, labels = u[inb], v[inb], z[inb], labels[inb]
        order = np.argsort(-z)  # painter's algorithm: far first
        u, v, z, labels = u[order], v[order], z[order], labels[order]
        px = K[0, 0] * voxel / z * scale  # apparent voxel size in px
        pt = np.clip(px * 72.0 / 100.0, 0.5, 60.0)
        ax.scatter(u, v, c=COLORS[np.clip(labels, 0, 17)] / 255.0,
                   s=pt ** 2, marker="s", linewidths=0)
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf


def render_viewpoint_panel(sem, out_path, viewpoints="builtin",
                           free_idx=17):
    """The reference's per-frame panel: 6 camera views (sky+ego masked,
    back views h-flipped) over a top view (deeper sky mask + ego cube)."""
    if viewpoints == "builtin":
        views = builtin_viewpoints()
    else:
        views = {
            n: load_viewpoint_json(
                os.path.join(viewpoints, f"cam_{n}.json")
            )
            for n in VIEW_NAMES
        }
    occ_cam = mask_ego_car(mask_sky(sem, n=3, free_idx=free_idx),
                           free_idx=free_idx)
    occ_top = visual_ego_car(
        mask_ego_car(mask_sky(sem, n=6, free_idx=free_idx), free_idx=free_idx)
    )
    tiles = []
    for name in VIEW_NAMES[:6]:
        img = render_view(occ_cam, *views[name], free_idx=free_idx)
        if "back" in name:
            img = img[:, ::-1]  # reference flips the back cameras
        tiles.append(img)
    top = render_view(occ_top, *views["top"], free_idx=free_idx)
    row1 = np.concatenate(tiles[:3], axis=1)
    row2 = np.concatenate(tiles[3:], axis=1)
    pad = np.full((row1.shape[0], (row1.shape[1] - top.shape[1]) // 2, 3),
                  255, np.uint8)
    top_row = np.concatenate(
        [pad, top, np.full((top.shape[0],
                            row1.shape[1] - top.shape[1] - pad.shape[1], 3),
                           255, np.uint8)], axis=1)
    panel = np.concatenate([row1, row2, top_row], axis=0)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.imsave(out_path, panel)
    return panel


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("pred_dir", help="dir of .npz dumps (tools.test --out)")
    p.add_argument("--out-dir", default="vis")
    p.add_argument("--max-samples", type=int, default=20)
    p.add_argument(
        "--viewpoints", default=None,
        help="also render the reference's 7-view panel per sample: "
             "'builtin' (original rig) or a directory of the reference's "
             "open3d viewpoint_params/cam_*.json files (exact pose parity)",
    )
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    files = sorted(
        f for f in os.listdir(args.pred_dir) if f.endswith(".npz")
    )[: args.max_samples]
    for f in files:
        data = np.load(os.path.join(args.pred_dir, f))
        sem = data["semantics"] if "semantics" in data else data[data.files[0]]
        out = os.path.join(args.out_dir, f.replace(".npz", ".png"))
        render(np.asarray(sem), out)
        print("wrote", out)
        written.append(out)
        if args.viewpoints:
            vp_out = os.path.join(
                args.out_dir, f.replace(".npz", "_views.png")
            )
            render_viewpoint_panel(
                np.asarray(sem), vp_out, viewpoints=args.viewpoints
            )
            print("wrote", vp_out)
            written.append(vp_out)
    return written


if __name__ == "__main__":
    main()
