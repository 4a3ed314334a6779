"""Lovasz-softmax scan time a train step: device ms of the traced span's
top device operations (`device_ops`, the ten longest by name) whose name
holds `scan` in any case (PyTorch's and cub's scan kernels: the cumulative sums over each
class's sorted errors in the Lovasz-softmax loss, once for the key frame
and once a future step), over the steps; none when no such kernel is
among them."""

LAYER = "voxel losses"
UNIT = "ms"
MOVES = "train_samples_per_s"


def read(s):
    ops = [sec for name, sec in s.get("device_ops", []) if "scan" in name.lower()]
    if not ops:
        return None
    return 1e3 * sum(ops) / s["frames"]
