"""Kernel wrappers (K1-K7, K1b, K2b, K5b, K6b) and their plain PyTorch
versions."""

from .bev_pool import bev_pool, bev_pool_dense_oracle
from .bev_pool_pallas import bev_pool_fused
from .cost_volume_pallas import (
    plane_sweep_cost,
    plane_sweep_cost_hom,
    plane_sweep_cost_hom_plain,
    plane_sweep_cost_plain,
)
from .render import (
    RaySamplingSpec,
    alpha2weight,
    cumdist_mask,
    raw2alpha,
    sample_ray_points,
)
from .swin_block_pallas import (
    fused_swin_attn_block,
    fused_swin_attn_block_bwd,
    fused_swin_attn_block_bwd_plain,
    fused_swin_attn_block_plain,
)
from .swin_mlp_pallas import (
    fused_swin_mlp,
    fused_swin_mlp_bwd,
    fused_swin_mlp_bwd_plain,
    fused_swin_mlp_plain,
)
from .window_attn_pallas import (
    band_window_attention,
    band_window_attention_bwd,
    band_window_attention_vjp,
    fused_window_attention,
    fused_window_attention_bwd,
    fused_window_attention_vjp,
)

# `grid_sample_2d` / `grid_sample_3d` of the JAX package stay behind: the
# port samples with `F.grid_sample` or its kernels (ROADMAP P17).
__all__ = [
    "RaySamplingSpec",
    "alpha2weight",
    "band_window_attention",
    "band_window_attention_bwd",
    "band_window_attention_vjp",
    "bev_pool",
    "bev_pool_dense_oracle",
    "bev_pool_fused",
    "cumdist_mask",
    "fused_swin_attn_block",
    "fused_swin_attn_block_bwd",
    "fused_swin_attn_block_bwd_plain",
    "fused_swin_attn_block_plain",
    "fused_swin_mlp",
    "fused_swin_mlp_bwd",
    "fused_swin_mlp_bwd_plain",
    "fused_swin_mlp_plain",
    "fused_window_attention",
    "fused_window_attention_bwd",
    "fused_window_attention_vjp",
    "plane_sweep_cost",
    "plane_sweep_cost_hom",
    "plane_sweep_cost_hom_plain",
    "plane_sweep_cost_plain",
    "raw2alpha",
    "sample_ray_points",
]
