"""Kernel wrappers (K1-K4, K1b, K2b) and their plain PyTorch versions."""

from .bev_pool import bev_pool
from .bev_pool_pallas import bev_pool_fused
from .cost_volume_pallas import plane_sweep_cost_hom, plane_sweep_cost_hom_plain
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

__all__ = [
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
    "plane_sweep_cost_hom",
    "plane_sweep_cost_hom_plain",
]
