"""A streaming step: `data.to_device(frame)`, `PreWorld.predict_sequential`
on the cache that `init_sequential_cache` made from the stream's first
frame in set-up, the answer `semantic_occ` to the host."""

from __future__ import annotations

import time
from typing import Dict

import torch

from ..harness.check import check_infer, reference, tensors
from ..harness.infer import infer_controls, infer_sample
from ..harness.program import InferEntry

MODULE_RANGES = True
sample = infer_sample


class Entry(InferEntry):
    def __init__(self, model, traffic, device, seed: int, config: Dict):
        from preworld_tpu_torch.data import to_device

        super().__init__(model, traffic, device)
        self.cache = model.init_sequential_cache(
            to_device(traffic.frame(0), device))
        self.next = 0

    def run(self, k: int) -> float:
        from preworld_tpu_torch.data import to_device

        if k != self.next:
            raise ValueError(f"streaming frame {k} after {self.next - 1}")
        self.next += 1
        frame = self.traffic.frame(k)
        t0 = time.perf_counter()
        out, self.cache = self.model.predict_sequential(
            to_device(frame, self.device), self.cache)
        occ = out["semantic_occ"].cpu()
        dt = time.perf_counter() - t0
        self._finish(k, occ)
        return dt

    def close(self):
        super().close()
        self.cache = None


def ref_logits(ref, traffic, k: int, device) -> torch.Tensor:
    """Step k of the stream: frames k - 2, k - 1 and k, pooled with the
    first frame's voxel ids as the program pools every step."""
    vf = ref.stream_voxel_feat([tensors(traffic.frame(j), device)
                                for j in (k - 2, k - 1, k)],
                               tensors(traffic.frame(0), device))
    return ref.occupancy_logits(vf)


def check(config, traffic, outputs, seed, device) -> Dict[str, float]:
    return check_infer(ref_logits, config, traffic, outputs["logits"],
                       outputs["served"], seed, device)


def work(config, traffic, seed, device, k) -> Dict[str, float]:
    """One streaming step; the earlier frames' part comes first."""
    from ..counts.work import count

    ref = reference(config, seed, device).eval()
    f2, f1, f0 = (tensors(traffic.frame(j), device)
                  for j in (k - 2, k - 1, k))
    with torch.no_grad():
        ids = ref.stream_ids(tensors(traffic.frame(0), device))
        v1, st1 = ref.stream_frame(f1, ref.stage0(f2), f2, ids)
        return count(ref, lambda: ref.occupancy_logits(
            ref.stream_step(f0, f1, v1, st1, ids)),
            config["sizes"]["dtype"])


def controls(config, traffic, seed, device, ks) -> Dict[str, Dict]:
    return infer_controls(ref_logits, config, traffic, seed, device, ks)
