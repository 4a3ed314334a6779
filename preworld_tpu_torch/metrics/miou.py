"""Occ3D-nuScenes mIoU metrics (confusion-matrix based).

Counterpart of `preworld_tpu/metrics/miou.py`, the same numpy code.
Parity: `mmdet3d/datasets/occ_metrics.py:52-185` (Metric_mIoU) and
`:413-595` (Metric_mIoU_Temporal). Pure numpy accumulation on host; the
per-class IoU / masking / horizon-keying semantics match the reference's
evaluation protocol (camera-visible mask for 3D, unmasked for 4D).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

OCC3D_CLASS_NAMES = [
    "others", "barrier", "bicycle", "bus", "car", "construction_vehicle",
    "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck",
    "driveable_surface", "other_flat", "sidewalk", "terrain", "manmade",
    "vegetation", "free",
]

# OpenScene/nuPlan taxonomy (`occ_metrics.py:188-196`), 11 classes + free
NUPLAN_CLASS_NAMES = [
    "vehicle", "place_holder1", "place_holder2", "place_holder3",
    "czone_sign", "bicycle", "generic_object", "pedestrian", "traffic_cone",
    "barrier", "background", "free",
]


def fast_hist(pred: np.ndarray, gt: np.ndarray,
              num_classes: int) -> np.ndarray:
    """Confusion matrix over labels in [0, num_classes) (excludes 255 etc.),
    parity with `hist_info` (`occ_metrics.py:82-108`)."""
    pred = pred.reshape(-1)
    gt = gt.reshape(-1)
    k = (gt >= 0) & (gt < num_classes)
    return np.bincount(
        num_classes * gt[k].astype(int) + pred[k].astype(int),
        minlength=num_classes**2,
    ).reshape(num_classes, num_classes)


def per_class_iou(hist: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.diag(hist) / (hist.sum(1) + hist.sum(0) - np.diag(hist))


class MetricMIoU:
    """3-D occupancy mIoU over 17 semantic classes (+ free).

    Eval protocol parity (`nuscenes_dataset_occ.py:361-386`):
    `use_image_mask=True` restricts to camera-visible voxels; the headline
    number is nanmean over classes 0..16 (free excluded) * 100.
    """

    def __init__(
        self,
        num_classes: int = 18,
        use_image_mask: bool = True,
        use_lidar_mask: bool = False,
        class_names: Optional[Sequence[str]] = None,
    ):
        self.num_classes = num_classes
        self.use_image_mask = use_image_mask
        self.use_lidar_mask = use_lidar_mask
        self.class_names = list(
            class_names
            if class_names is not None
            else (NUPLAN_CLASS_NAMES if num_classes == 12
                  else OCC3D_CLASS_NAMES)
        )
        self.hist = np.zeros((num_classes, num_classes), np.float64)
        self.cnt = 0

    def add_batch(self, pred, gt, mask_lidar=None, mask_camera=None):
        pred = np.asarray(pred)
        gt = np.asarray(gt)
        if self.use_image_mask and mask_camera is not None:
            m = np.asarray(mask_camera).astype(bool)
            pred, gt = pred[m], gt[m]
        elif self.use_lidar_mask and mask_lidar is not None:
            m = np.asarray(mask_lidar).astype(bool)
            pred, gt = pred[m], gt[m]
        self.hist += fast_hist(pred, gt, self.num_classes)
        self.cnt += 1

    def count_miou(self) -> Dict[str, float]:
        iou = per_class_iou(self.hist)
        per_class = {
            self.class_names[i]: round(float(iou[i]) * 100, 2)
            for i in range(self.num_classes)
        }
        miou = round(float(np.nanmean(iou[: self.num_classes - 1])) * 100, 2)
        return {"mIoU": miou, "per_class": per_class, "count": self.cnt}


class MetricMIoUTemporal:
    """4-D forecasting mIoU at 0/1/2/3 s horizons, averaged over 1-3 s.

    Parity: `occ_metrics.py:413-595` — horizons keyed by frame offsets
    {0, 2, 4, 6} <-> {0, 1, 2, 3} s; the headline is the mean of the
    1 s/2 s/3 s mIoUs; no visibility mask
    (`nuscenes_dataset_occ_trajectory.py:479-482`).
    """

    HORIZONS = (0, 1, 2, 3)

    def __init__(self, num_classes: int = 18):
        self.num_classes = num_classes
        self.hists = {
            h: np.zeros((num_classes, num_classes), np.float64)
            for h in self.HORIZONS
        }
        self.cnt = 0

    def add_batch(self, preds_by_horizon: Dict[int, np.ndarray],
                  gts_by_horizon: Dict[int, np.ndarray]):
        for h in self.HORIZONS:
            if h in preds_by_horizon and h in gts_by_horizon:
                self.hists[h] += fast_hist(
                    np.asarray(preds_by_horizon[h]),
                    np.asarray(gts_by_horizon[h]),
                    self.num_classes,
                )
        self.cnt += 1

    def count_miou(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        future = []
        for h in self.HORIZONS:
            iou = per_class_iou(self.hists[h])
            m = round(float(np.nanmean(iou[: self.num_classes - 1])) * 100, 2)
            out[f"mIoU_{h}s"] = m
            if h > 0:
                future.append(m)
        out["mIoU_avg_1_3s"] = round(float(np.mean(future)), 2)
        out["count"] = self.cnt
        return out
