"""Config -> model construction.

Counterpart of `preworld_tpu/train/builder.py::build_model`: the same config
tree (a `utils.config.Config` read from `configs/`) becomes the port's
`PreWorldConfig`, with the JAX package's defaults for every missing key.
Only `type="PreWorld"` is ported; the render head's `nerf_head` settings
are not read (the pretrain stage is not ported).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..geometry.frustum import GridConfig
from ..models.preworld import PreWorld, PreWorldConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_grid_config(grid_cfg: Dict[str, Any]) -> GridConfig:
    return GridConfig(x=tuple(grid_cfg["x"]), y=tuple(grid_cfg["y"]),
                      z=tuple(grid_cfg["z"]), depth=tuple(grid_cfg["depth"]))


def build_model(cfg) -> PreWorld:
    """cfg: a `utils.Config` with model / grid_config / data_config."""
    m = cfg["model"]
    if m.get("type", "PreWorld") != "PreWorld":
        raise NotImplementedError(f"model type {m['type']!r} is not ported")
    swin = m.get("swin", {})
    return PreWorld(PreWorldConfig(
        grid=build_grid_config(cfg["grid_config"]),
        input_size=tuple(cfg["data_config"]["input_size"]),
        num_cams=int(cfg["data_config"]["Ncams"]),
        temporal_frames=int(m.get("temporal_frames", 2)),
        extra_ref_frames=int(m.get("extra_ref_frames", 1)),
        backbone=m.get("backbone", "swin"),
        swin_embed_dims=int(swin.get("embed_dims", 128)),
        swin_depths=tuple(swin.get("depths", (2, 2, 18, 2))),
        swin_num_heads=tuple(swin.get("num_heads", (4, 8, 16, 32))),
        swin_window=int(swin.get("window_size", 12)),
        neck_out_channels=int(m.get("neck_out_channels", 512)),
        num_trans_channels=int(m.get("num_trans_channels", 32)),
        num_classes=int(m.get("num_classes", 18)),
        out_dim=int(m.get("out_dim", 32)),
        test_threshold=float(m.get("test_threshold", 8.5)),
        empty_idx=int(m.get("empty_idx", m.get("num_classes", 18) - 1)),
        if_pretrain=bool(m.get("if_pretrain", False)),
        if_render=bool(m.get("if_render", True)),
        if_post_finetune=bool(m.get("if_post_finetune", False)),
        use_lss_depth_loss=bool(m.get("use_lss_depth_loss", True)),
        depth_loss_weight=float(m.get("depth_loss_weight", 0.05)),
        balance_cls_weight=bool(m.get("balance_cls_weight", True)),
        weight_voxel_ce=float(m.get("weight_voxel_ce", 1.0)),
        weight_voxel_sem_scal=float(m.get("weight_voxel_sem_scal", 1.0)),
        weight_voxel_geo_scal=float(m.get("weight_voxel_geo_scal", 1.0)),
        weight_voxel_lovasz=float(m.get("weight_voxel_lovasz", 1.0)),
        use_focal_loss=bool(m.get("use_focal_loss", True)),
        remat=bool(m.get("remat", False)),
        dtype=DTYPES[m.get("dtype", "float32")],
    ))
