"""Tiny configurations for the benchmark's CPU tests: the program's
`tiny_config` sizes (a small conv backbone, a 20x20x8 grid, 2 cameras at
64x128) and a small Swin (embed 128, two blocks a stage, 64x192), as the
benchmark's configuration dicts and as program configuration files."""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Dict

TINY_GRID = {"x": [-8.0, 8.0, 0.8], "y": [-8.0, 8.0, 0.8],
             "z": [-1.0, 5.4, 0.8], "depth": [1.0, 9.0, 0.5]}
TINY_RENDER = {"point_cloud_range": [-8.0, -8.0, -1.0, 8.0, 8.0, 5.4],
               "radius": 7.0, "step_size": 0.5, "world_len": 20,
               "weight_depth": 1.0, "weight_semantic": 1.0,
               "weight_color": 1.0, "weight_entropy_last": 0.01,
               "weight_distortion": 0.01, "fast_color_thres": 1e-7,
               "max_depth": 10.0, "variance_focus": 0.85}


def sizes(stage: str = "finetune", backbone: str = "tiny") -> Dict:
    finetune = stage == "finetune"
    swin = backbone == "swin"
    return {
        "grid": TINY_GRID, "input_size": [64, 192] if swin else [64, 128],
        "num_cams": 2, "temporal_frames": 2, "extra_ref_frames": 1,
        "backbone": backbone, "swin_embed_dims": 128,
        "swin_depths": [2, 2, 2, 2] if swin else [2, 2, 18, 2],
        "swin_num_heads": [4, 8, 16, 32], "swin_window": 12,
        "neck_out_channels": 64, "num_trans_channels": 16,
        "num_classes": 18, "out_dim": 16, "if_render": not finetune,
        "if_post_finetune": finetune, "use_lss_depth_loss": not finetune,
        "depth_loss_weight": 0.05, "dtype": "float32", "remat": False,
        "render": copy.deepcopy(TINY_RENDER)}


def config(stage: str = "finetune", backbone: str = "tiny",
           program_config: str = "") -> Dict:
    return {"name": f"tiny-{stage}", "program_config": program_config,
            "reference": "model.PreWorldRef",
            "sizes": sizes(stage, backbone),
            "train": {"batch": 2, "labels": (
                ["voxel_semantics", "mask_camera"] if stage == "finetune"
                else ["voxel_semantics", "mask_camera", "gt_depth", "rays"]),
                "rays": 0 if stage == "finetune" else 256, "lr": 1e-4,
                "weight_decay": 0.01, "clip": 5.0, "warmup_iters": 200,
                "ema_decay": 0.999, "ema_init_updates": 10560}}


def write_program_config(path: Path, s: Dict) -> Path:
    """A program configuration file (the repository's format) with the
    sizes `s`."""
    r = s["render"]
    model = {
        "type": "PreWorld", "backbone": s["backbone"], "dtype": s["dtype"],
        "remat": s["remat"],
        "swin": {"embed_dims": s["swin_embed_dims"],
                 "depths": tuple(s["swin_depths"]),
                 "num_heads": tuple(s["swin_num_heads"]),
                 "window_size": s["swin_window"]},
        "neck_out_channels": s["neck_out_channels"],
        "num_trans_channels": s["num_trans_channels"],
        "out_dim": s["out_dim"], "num_classes": s["num_classes"],
        "temporal_frames": s["temporal_frames"],
        "extra_ref_frames": s["extra_ref_frames"],
        "if_render": s["if_render"], "if_post_finetune": s["if_post_finetune"],
        "use_lss_depth_loss": s["use_lss_depth_loss"],
        "depth_loss_weight": s["depth_loss_weight"],
        "nerf_head": {"point_cloud_range": r["point_cloud_range"],
                      "radius": r["radius"], "max_depth": r["max_depth"]},
    }
    text = (f"data_config = dict(Ncams={s['num_cams']}, "
            f"input_size={tuple(s['input_size'])!r})\n"
            f"grid_config = {json.dumps(s['grid'])}\n"
            f"model = {model!r}\n")
    path.write_text(text)
    return path
