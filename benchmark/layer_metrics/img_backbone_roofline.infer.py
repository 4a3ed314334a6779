"""Image backbone's share of its roofline: the least time the card could take
for the backbone's work of a frame, the larger of its FLOPs over 989e12
and its bytes over 3.35e12 (`counts/work.py`, on the reference), over the
backbone's device ms a frame."""

from benchmark.counts.work import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

LAYER = "image backbone"
UNIT = "%"
MOVES = "occ_frames_per_s"


def read(s):
    w = s.get("work", {})
    ms = s.get("range_ms", {}).get("img_backbone")
    if not ms or not w.get("img_backbone_flops"):
        return None
    bound = max(w["img_backbone_flops"] / PEAK_BF16_FLOPS,
                w["img_backbone_bytes"] / PEAK_HBM_BYTES)
    return 100.0 * bound / (ms / s["frames"] / 1e3)
