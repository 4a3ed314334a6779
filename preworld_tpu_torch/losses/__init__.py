"""Occupancy losses of the finetune step (plain PyTorch)."""

from .voxel import (
    ce_ssc_loss,
    distance_weighted_focal_loss,
    geo_scal_loss,
    lovasz_softmax_loss,
    nusc_class_weights,
    sem_scal_loss,
    voxel_class_weights,
)

__all__ = [
    "ce_ssc_loss",
    "distance_weighted_focal_loss",
    "geo_scal_loss",
    "lovasz_softmax_loss",
    "nusc_class_weights",
    "sem_scal_loss",
    "voxel_class_weights",
]
