"""Whole frame's share of the card's bf16 dense peak: the reference's
FLOPs of one frame (`counts/work.py`) times the traced run's
frames a second over its unprofiled window, over 989e12."""

from benchmark.counts.work import PEAK_BF16_FLOPS

LAYER = "whole step"
UNIT = "%"
MOVES = "occ_frames_per_s"


def read(s):
    flops = s.get("work", {}).get("flops")
    if not flops or not s.get("rate"):
        return None
    return 100.0 * flops * s["rate"] / PEAK_BF16_FLOPS
