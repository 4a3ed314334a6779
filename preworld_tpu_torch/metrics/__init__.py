"""Occupancy metrics (numpy): mIoU, the 4-D forecasting mIoU and the
F-score, counterparts of `preworld_tpu/metrics/`."""

from .fscore import MetricFScore
from .miou import (
    NUPLAN_CLASS_NAMES,
    OCC3D_CLASS_NAMES,
    MetricMIoU,
    MetricMIoUTemporal,
    fast_hist,
    per_class_iou,
)

__all__ = [
    "MetricFScore",
    "MetricMIoU",
    "MetricMIoUTemporal",
    "NUPLAN_CLASS_NAMES",
    "OCC3D_CLASS_NAMES",
    "fast_hist",
    "per_class_iou",
]
