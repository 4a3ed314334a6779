"""Share of the traced span's wall time with no kernel running on the card
(union of kernel intervals); copies count as idle, since h2d_ms shows them."""

LAYER = "device"
UNIT = "%"
MOVES = "occ_frames_per_s"


def read(s):
    if s.get("n_kernels", 0) == 0 or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["kernel_busy_s"] / s["window_s"])
