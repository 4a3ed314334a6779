"""F-score metric: chamfer-style accuracy/completeness of occupied voxels.

Counterpart of `preworld_tpu/metrics/fscore.py`, the same numpy code.
Parity: `mmdet3d/datasets/occ_metrics.py:322-410` (Metric_FScore) — voxel
centers of non-void classes compared by nearest-neighbour distance with
0.6 m thresholds; harmonic mean of accuracy and completeness, averaged
over samples. Uses scipy's cKDTree instead of sklearn's KDTree.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy.spatial import cKDTree


class MetricFScore:
    def __init__(
        self,
        threshold_acc: float = 0.6,
        threshold_complete: float = 0.6,
        voxel_size: Sequence[float] = (0.4, 0.4, 0.4),
        pc_range: Sequence[float] = (-40, -40, -1, 40, 40, 5.4),
        void: Sequence[int] = (17, 255),
        use_image_mask: bool = False,
        use_lidar_mask: bool = False,
    ):
        self.threshold_acc = threshold_acc
        self.threshold_complete = threshold_complete
        self.voxel_size = np.asarray(voxel_size)
        self.pc_range = np.asarray(pc_range)
        self.void = tuple(void)
        self.use_image_mask = use_image_mask
        self.use_lidar_mask = use_lidar_mask
        self.cnt = 0
        self.tot_acc = 0.0
        self.tot_cmpl = 0.0
        self.tot_f1 = 0.0
        self.eps = 1e-8

    def _voxel2points(self, voxel: np.ndarray) -> np.ndarray:
        mask = np.ones(voxel.shape, bool)
        for v in self.void:
            mask &= voxel != v
        idx = np.where(mask)
        return np.stack(
            [
                idx[i] * self.voxel_size[i]
                + self.voxel_size[i] / 2
                + self.pc_range[i]
                for i in range(3)
            ],
            axis=1,
        )

    def add_batch(self, pred, gt, mask_lidar=None, mask_camera=None):
        self.cnt += 1
        pred = np.asarray(pred).copy()
        gt = np.asarray(gt).copy()
        if self.use_image_mask and mask_camera is not None:
            pred[~np.asarray(mask_camera, bool)] = 255
            gt[~np.asarray(mask_camera, bool)] = 255
        elif self.use_lidar_mask and mask_lidar is not None:
            pred[~np.asarray(mask_lidar, bool)] = 255
            gt[~np.asarray(mask_lidar, bool)] = 255

        gt_pts = self._voxel2points(gt)
        pred_pts = self._voxel2points(pred)
        if pred_pts.shape[0] == 0 or gt_pts.shape[0] == 0:
            acc = cmpl = f1 = 0.0
        else:
            d_complete, _ = cKDTree(pred_pts).query(gt_pts)
            d_accuracy, _ = cKDTree(gt_pts).query(pred_pts)
            cmpl = float((d_complete < self.threshold_complete).mean())
            acc = float((d_accuracy < self.threshold_acc).mean())
            f1 = 2.0 / (1 / (acc + self.eps) + 1 / (cmpl + self.eps))
        self.tot_acc += acc
        self.tot_cmpl += cmpl
        self.tot_f1 += f1

    def count_fscore(self) -> dict:
        n = max(self.cnt, 1)
        return {
            "fscore": round(self.tot_f1 / n, 4),
            "accuracy": round(self.tot_acc / n, 4),
            "completeness": round(self.tot_cmpl / n, 4),
            "count": self.cnt,
        }
