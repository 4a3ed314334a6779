"""A request: `data.to_device(request)`, `PreWorld.predict`, the answer
`semantic_occ` to the host."""

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
        super().__init__(model, traffic, device)

    def run(self, k: int) -> float:
        from preworld_tpu_torch.data import to_device

        req = self.traffic.request(k)
        t0 = time.perf_counter()
        out = self.model.predict(to_device(req, self.device))
        occ = out["semantic_occ"].cpu()
        dt = time.perf_counter() - t0
        self._finish(k, occ)
        return dt


def ref_logits(ref, traffic, k: int, device) -> torch.Tensor:
    vf, _ = ref.voxel_feat(tensors(traffic.request(k), device))
    return ref.occupancy_logits(vf)


def check(config, traffic, outputs, seed, device) -> Dict[str, float]:
    return check_infer(ref_logits, config, traffic, outputs["logits"],
                       outputs["served"], seed, device)


def work(config, traffic, seed, device, k) -> Dict[str, float]:
    from ..counts.work import count

    ref = reference(config, seed, device).eval()
    with torch.no_grad():
        return count(ref, lambda: ref_logits(ref, traffic, k, device),
                     config["sizes"]["dtype"])


def controls(config, traffic, seed, device, ks) -> Dict[str, Dict]:
    return infer_controls(ref_logits, config, traffic, seed, device, ks)
