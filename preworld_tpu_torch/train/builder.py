"""Config -> model construction.

Counterpart of `preworld_tpu/train/builder.py::build_model`: the same config
tree (a `utils.config.Config` read from `configs/`) becomes the port's
`PreWorldConfig`, with the JAX package's defaults for every missing key,
the render head's `nerf_head` dict included (`build_nerf_config`).
`type="PreWorld"` builds `PreWorld`, `type="PreWorld4DTraj"` the
forecasting model and `type="BEVStereo4DOCC"` the baseline `BEVStereoOCC`,
every type the JAX builder knows. The model is built on the card unless
the caller asks for another device.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..geometry.frustum import GridConfig
from ..models.nerf_head import NerfHeadConfig
from ..models.bevstereo_occ import BEVStereoOCC
from ..models.preworld import PreWorld, PreWorldConfig
from ..models.preworld_traj import PreWorld4DTraj
from ..ops.render import RaySamplingSpec

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_grid_config(grid_cfg: Dict[str, Any]) -> GridConfig:
    return GridConfig(x=tuple(grid_cfg["x"]), y=tuple(grid_cfg["y"]),
                      z=tuple(grid_cfg["z"]), depth=tuple(grid_cfg["depth"]))


def build_nerf_config(nerf_cfg: Dict[str, Any],
                      world_len: int) -> NerfHeadConfig:
    """The JAX `build_nerf_config` less the TPU gather fields `table_dtype`
    and `bwd_live_cap`, which the port does not read."""
    pcr = tuple(nerf_cfg.get("point_cloud_range", (-40, -40, -1, 40, 40, 5.4)))
    spec = RaySamplingSpec(
        point_cloud_range=pcr,
        radius=float(nerf_cfg.get("radius", 39)),
        step_size=float(nerf_cfg.get("step_size", 0.5)),
        world_len=world_len,
    )
    return NerfHeadConfig(
        spec=spec,
        use_depth_sup=bool(nerf_cfg.get("use_depth_sup", True)),
        weight_depth=float(nerf_cfg.get("weight_depth", 1.0)),
        weight_semantic=float(nerf_cfg.get("weight_semantic", 1.0)),
        weight_color=float(nerf_cfg.get("weight_color", 1.0)),
        weight_entropy_last=float(nerf_cfg.get("weight_entropy_last", 0.01)),
        weight_distortion=float(nerf_cfg.get("weight_distortion", 0.01)),
        fast_color_thres=float(nerf_cfg.get("fast_color_thres", 1e-7)),
        balance_cls_weight=bool(nerf_cfg.get("balance_cls_weight", True)),
        max_depth=float(nerf_cfg.get("max_depth", 52.0)),
        variance_focus=float(nerf_cfg.get("variance_focus", 0.85)),
        ray_chunk=int(nerf_cfg.get("ray_chunk", 0)),
    )


def build_model(cfg, device="cuda") -> PreWorld:
    """cfg: a `utils.Config` with model / grid_config / data_config. The
    model's parameters and buffers land on `device` (the card by default;
    pass "cpu" for the CPU)."""
    m = cfg["model"]
    mtype = m.get("type", "PreWorld")
    models = {"PreWorld": PreWorld, "PreWorld4DTraj": PreWorld4DTraj,
              "BEVStereo4DOCC": BEVStereoOCC}
    if mtype not in models:
        raise ValueError(f"unknown model type {mtype!r}")
    swin = m.get("swin", {})
    grid = build_grid_config(cfg["grid_config"])
    return models[mtype](PreWorldConfig(
        grid=grid,
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
        nerf=build_nerf_config(m.get("nerf_head", {}), int(grid.size[0])),
        remat=bool(m.get("remat", False)),
        dtype=DTYPES[m.get("dtype", "float32")],
    )).to(device)
