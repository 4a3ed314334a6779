"""OpenScene/nuPlan large-scale pretraining dataset adapter.

Counterpart of `preworld_tpu/data/nuplan.py`.

The reference only carries broken remnants of this path (undefined
`nuplan_class_frequencies` at `preworld.py:62-65`, a NuPlan metric at
`occ_metrics.py:188`, no dataset class — README 'coming soon'); SURVEY.md §2
directs the rebuild to treat it as "same model, different dataset adapter".

Taxonomy: 11 classes + free (empty_idx=11); grid 200x200x16 at 0.5 m over
[-50, 50] x [-50, 50] x [-4, 4]. Expects bevdetv2-style info pkls (build
with tools/create_data.py pointed at an OpenScene export) whose `occ_path`
entries contain `labels.npz` with `semantics` (and optional masks). Its
12-class CE weights are `losses.voxel.NUPLAN_CLASS_WEIGHT_MASK`.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..metrics.miou import MetricMIoU, NUPLAN_CLASS_NAMES
from .nuscenes import NuScenesOccDataset
from .pipeline import load_occ_gt

NUPLAN_GRID_CONFIG = dict(
    x=[-50.0, 50.0, 0.5],
    y=[-50.0, 50.0, 0.5],
    z=[-4.0, 4.0, 0.5],
    depth=[1.0, 45.0, 0.5],
)


class NuPlanOccDataset(NuScenesOccDataset):
    """OpenScene occupancy dataset; grid/eval differ from nuScenes."""

    NUM_CLASSES = 12
    EMPTY_IDX = 11

    def evaluate(self, occ_preds: Sequence[np.ndarray]) -> Dict:
        """OpenScene protocol: 11-class mIoU, no visibility mask
        (`NuPlan_Metric_mIoU`, `occ_metrics.py:186-320`)."""
        metric = MetricMIoU(
            num_classes=self.NUM_CLASSES,
            use_image_mask=False,
            class_names=NUPLAN_CLASS_NAMES,
        )
        for index, pred in enumerate(occ_preds):
            info = self.infos[index]
            occ = load_occ_gt(self._data_path(info["occ_path"]))
            metric.add_batch(pred, occ["voxel_semantics"])
        return metric.count_miou()
