"""Kernel wrappers (K1-K7, K1b, K2b, K5b, K6b) and their plain PyTorch
versions."""

from .bev_pool import bev_pool
from .bev_pool_pallas import bev_pool_fused
from .cost_volume_pallas import (
    plane_sweep_cost,
    plane_sweep_cost_hom,
    plane_sweep_cost_hom_plain,
    plane_sweep_cost_plain,
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

__all__ = [
    "band_window_attention",
    "band_window_attention_bwd",
    "band_window_attention_vjp",
    "bev_pool",
    "bev_pool_fused",
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
]
