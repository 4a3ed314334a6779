"""The port's metrics (`preworld_tpu_torch/metrics/`) against the JAX
package's classes on the same arrays, and the hand-computed and golden
cases of `tests/test_metrics_config.py` run against the port, as cases of
one parametrised test. The results are numpy sums and divisions in the
same order, so they are compared exactly."""

import numpy as np
import pytest

from preworld_tpu.metrics import MetricFScore as JaxMetricFScore
from preworld_tpu.metrics import MetricMIoU as JaxMetricMIoU
from preworld_tpu.metrics import MetricMIoUTemporal as JaxMetricMIoUTemporal
from preworld_tpu.metrics import fast_hist as jax_fast_hist
from preworld_tpu.metrics import miou as jax_miou
from preworld_tpu_torch.metrics import (
    NUPLAN_CLASS_NAMES,
    OCC3D_CLASS_NAMES,
    MetricFScore,
    MetricMIoU,
    MetricMIoUTemporal,
    fast_hist,
)


def _samples(seed, n=3, shape=(12, 10, 4), classes=18):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt = rng.integers(0, classes, shape)
        pred = np.where(rng.uniform(size=shape) < 0.6, gt,
                        rng.integers(0, classes, shape))
        gt[rng.uniform(size=shape) < 0.05] = 255
        out.append((pred, gt, rng.uniform(size=shape) > 0.5,
                    rng.uniform(size=shape) > 0.3))
    return out


@pytest.mark.parametrize("kw", [
    dict(), dict(use_image_mask=False), dict(use_image_mask=False,
                                             use_lidar_mask=True),
    dict(num_classes=12, use_image_mask=False)])
def test_miou_matches_jax(kw):
    port, ref = MetricMIoU(**kw), JaxMetricMIoU(**kw)
    for pred, gt, ml, mc in _samples(1, classes=kw.get("num_classes", 18)):
        port.add_batch(pred, gt, ml, mc)
        ref.add_batch(pred, gt, ml, mc)
    assert port.hist.tobytes() == ref.hist.tobytes()
    assert port.count_miou() == ref.count_miou()
    assert port.class_names == ref.class_names


def test_temporal_matches_jax():
    port, ref = MetricMIoUTemporal(), JaxMetricMIoUTemporal()
    for seed in range(3):
        s = _samples(10 + seed, n=4)
        preds = {h: s[h][0] for h in range(4)}
        gts = {h: s[h][1] for h in range(4) if h != seed}
        port.add_batch(preds, gts)
        ref.add_batch(preds, gts)
    assert port.count_miou() == ref.count_miou()


@pytest.mark.parametrize("kw", [dict(), dict(use_image_mask=True),
                                dict(use_lidar_mask=True),
                                dict(threshold_acc=1.0, void=(0, 17, 255))])
def test_fscore_matches_jax(kw):
    port, ref = MetricFScore(**kw), JaxMetricFScore(**kw)
    for pred, gt, ml, mc in _samples(2, n=2, shape=(16, 16, 4)):
        gt = np.where(gt == 255, 17, gt)
        port.add_batch(pred, gt, ml, mc)
        ref.add_batch(pred, gt, ml, mc)
    assert port.count_fscore() == ref.count_fscore()


def test_tables_and_hist_match_jax():
    assert OCC3D_CLASS_NAMES == jax_miou.OCC3D_CLASS_NAMES
    assert NUPLAN_CLASS_NAMES == jax_miou.NUPLAN_CLASS_NAMES
    pred, gt, _, _ = _samples(3)[0]
    assert fast_hist(pred, gt, 18).tobytes() == \
        jax_fast_hist(pred, gt, 18).tobytes()


# --------------------------------------- tests/test_metrics_config.py cases

def _fscore(**kw):
    # unit voxels anchored at the origin: voxel (i,j,k) -> center +0.5
    kw.setdefault("voxel_size", (1.0, 1.0, 1.0))
    kw.setdefault("pc_range", (0, 0, 0, 4, 4, 2))
    kw.setdefault("void", (17, 255))
    return MetricFScore(**kw)


def _pair():
    """gt {(0,0,0),(2,2,1)}, pred {(0,0,0),(3,2,1)}: one exact match, one
    pair 1.0 m apart."""
    gt = np.full((4, 4, 2), 17, np.int64)
    pred = np.full((4, 4, 2), 17, np.int64)
    gt[0, 0, 0] = 3
    gt[2, 2, 1] = 5
    pred[0, 0, 0] = 3
    pred[3, 2, 1] = 5
    return pred, gt


def case_hand_computed_chamfer():
    """acc = cmpl = 0.5 at the 0.6 m threshold, f1 = 2/(1/0.5 + 1/0.5)."""
    m = _fscore()
    m.add_batch(*_pair())
    res = m.count_fscore()
    assert abs(res["accuracy"] - 0.5) < 1e-6
    assert abs(res["completeness"] - 0.5) < 1e-6
    assert abs(res["fscore"] - 0.5) < 1e-4


def case_threshold_admits_neighbor():
    """A 1.1 m threshold counts the 1.0 m pair: perfect scores."""
    m = _fscore(threshold_acc=1.1, threshold_complete=1.1)
    m.add_batch(*_pair())
    assert m.count_fscore()["fscore"] > 0.999


def case_camera_mask_and_averaging():
    """Masked-out voxels become void (255) pre-chamfer, and per-sample
    scores average: (0.5 + 1.0) / 2 = 0.75."""
    m = _fscore(use_image_mask=True)
    pred, gt = _pair()
    m.add_batch(pred, gt, mask_camera=np.ones((4, 4, 2), bool))
    mask = np.ones((4, 4, 2), bool)
    mask[2, 2, 1] = mask[3, 2, 1] = False
    m.add_batch(pred, gt, mask_camera=mask)
    res = m.count_fscore()
    assert res["count"] == 2
    assert abs(res["accuracy"] - 0.75) < 1e-6
    assert abs(res["fscore"] - 0.75) < 1e-3


def case_perfect_prediction():
    m = MetricMIoU(use_image_mask=False)
    gt = np.random.default_rng(0).integers(0, 18, (20, 20, 4))
    m.add_batch(gt, gt)
    assert m.count_miou()["mIoU"] == 100.0


def case_hist_excludes_255():
    h = fast_hist(np.array([0, 2, 5, 17]), np.array([0, 1, 255, 17]), 18)
    assert h.sum() == 3  # 255 excluded
    assert h[1, 2] == 1 and h[0, 0] == 1 and h[17, 17] == 1


def case_camera_mask():
    m = MetricMIoU(use_image_mask=True)
    gt = np.zeros((4, 4, 2), np.int64)
    pred = np.ones((4, 4, 2), np.int64)
    mask = np.zeros((4, 4, 2), bool)
    mask[0, 0, 0] = True
    pred[0, 0, 0] = 0
    m.add_batch(pred, gt, mask_camera=mask)
    assert m.count_miou()["per_class"]["others"] == 100.0


def case_known_iou_value():
    """2-class toy: IoU(class0) = 1/3 by hand."""
    m = MetricMIoU(num_classes=2, use_image_mask=False)
    m.add_batch(np.array([0, 1, 0, 1]), np.array([0, 0, 1, 1]))
    iou = np.diag(m.hist) / (m.hist.sum(1) + m.hist.sum(0)
                             - np.diag(m.hist))
    np.testing.assert_allclose(iou, [1 / 3, 1 / 3])


def case_temporal_avg():
    m = MetricMIoUTemporal()
    gt = np.random.default_rng(1).integers(0, 18, (10, 10, 2))
    m.add_batch({h: gt for h in (0, 1, 2, 3)},
                {h: gt for h in (0, 1, 2, 3)})
    assert m.count_miou()["mIoU_avg_1_3s"] == 100.0


def case_reference_protocol_golden():
    """The reference 4D eval protocol — rollout steps {0,1,3,5} scored
    against GT at +{0,2,4,6} frames — equals a direct transcription of the
    reference's Metric_mIoU_Temporal math (`occ_metrics.py:460-543`)."""
    rng = np.random.default_rng(3)
    shape, n_cls = (8, 8, 4), 18
    steps = {k: rng.integers(0, n_cls, shape) for k in range(7)}
    gts = {f: rng.integers(0, n_cls, shape) for f in (0, 2, 4, 6)}
    stacked = [steps[0], steps[1], steps[3], steps[5]]
    ref = {}
    for f in (0, 2, 4, 6):
        gt, pred = gts[f].flatten(), stacked[f // 2].flatten()
        k = (gt >= 0) & (gt < n_cls)
        h = np.bincount(n_cls * gt[k].astype(int) + pred[k].astype(int),
                        minlength=n_cls ** 2).reshape(n_cls, n_cls)
        iou = np.diag(h) / (h.sum(1) + h.sum(0) - np.diag(h))
        ref[f // 2] = round(float(np.nanmean(iou[: n_cls - 1])) * 100, 2)
    m = MetricMIoUTemporal(num_classes=n_cls)
    m.add_batch({h: steps[s] for h, s in zip((0, 1, 2, 3), (0, 1, 3, 5))},
                {h: gts[f] for h, f in zip((0, 1, 2, 3), (0, 2, 4, 6))})
    res = m.count_miou()
    for h in (0, 1, 2, 3):
        assert res[f"mIoU_{h}s"] == ref[h]
    assert res["mIoU_avg_1_3s"] == round(
        float(np.mean([ref[1], ref[2], ref[3]])), 2)


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_cases(name):
    CASES[name]()
