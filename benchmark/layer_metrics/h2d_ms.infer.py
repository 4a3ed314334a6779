"""Host-to-device copy time a frame: device ms of the traced span's
HtoD copies (the upload of the host inputs)."""

LAYER = "entry and upload"
UNIT = "ms"
MOVES = "occ_frames_per_s"


def read(s):
    if s.get("n_kernels", 0) == 0:
        return None
    return s["h2d_ms"] / s["frames"]
