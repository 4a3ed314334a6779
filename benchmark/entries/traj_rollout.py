"""A forecasting request: `data.to_device(request)`,
`PreWorld4DTraj.predict(batch, num_future)`, the answers
`semantic_occ_{k}s` of the key frame and of each future step to the host.

The request carries the traffic's 3-frame input and an ego state
(`harness/forecast.py`). For a captured request `InferEntry`'s hook copies
every occupancy head output and the head's first input, the key frame's
voxel feature, as they come, into host buffers pinned in set-up: the
copies take their place in the request's stream (a captured request is
that much longer, ~400 MB to the host), and nothing stays on the card
that the program does not hold, so the check sets no peak. The check
compares each step's logits and answer with the reference's `rollout`
from the same host inputs and weights, and with the reference's rollout
from the program's own key-frame feature (`check`).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from ..harness.check import compare_logits, reference, rel_l2, tensors
from ..harness.forecast import flags_kept, forecast_traffic
from ..harness.infer import infer_sample
from ..harness.program import InferEntry

MODULE_RANGES = True
sample = infer_sample


def num_future(config: Dict) -> int:
    return config["sizes"]["num_future"]


def grid_shape(sizes: Dict) -> tuple:
    g = sizes["grid"]
    return tuple(int(round((a[1] - a[0]) / a[2]))
                 for a in (g["x"], g["y"], g["z"]))


class Entry(InferEntry):
    def __init__(self, model, traffic, device, seed: int, config: Dict):
        super().__init__(model, forecast_traffic(traffic, config, seed),
                         device)
        self.num_future = num_future(config)
        s = config["sizes"]
        rows = (self.traffic.batch, *grid_shape(s))
        pin = device.type == "cuda"
        # the key frame's feature, then the head's output of each step
        self.bufs = [torch.empty((*rows, c), pin_memory=pin)
                     for c in [s["out_dim"]]
                     + [s["num_classes"]] * (self.num_future + 1)]
        self.steps: List[torch.Tensor] = []
        self.key_feat: Optional[torch.Tensor] = None
        self.key_feats: Dict[int, torch.Tensor] = {}

    def _host(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """x into host buffer i in stream order (a copy of its own where
        the buffer does not fit: a rollout of another length or shape)."""
        x = x.detach()
        if i < len(self.bufs) and (self.bufs[i].shape, self.bufs[i].dtype) \
                == (x.shape, x.dtype):
            return self.bufs[i].copy_(x, non_blocking=True)
        return x.to("cpu", copy=True)

    def _hold(self, module, inputs, output):
        if self.want is not None:
            if not self.steps:
                self.key_feat = self._host(inputs[0], 0)
            self.steps.append(self._host(output, len(self.steps) + 1))

    def run(self, k: int) -> float:
        from preworld_tpu_torch.data import to_device

        req = self.traffic.request(k)
        t0 = time.perf_counter()
        out = self.model.predict(to_device(req, self.device),
                                 num_future=self.num_future)
        occ = torch.stack([out[f"semantic_occ_{s}s"]
                           for s in range(self.num_future + 1)]).cpu()
        dt = time.perf_counter() - t0
        self._finish(k, occ)
        return dt

    def _finish(self, k: int, occ: torch.Tensor) -> None:
        """After request k's timing (the answer's copy waited for the
        buffers' copies): its steps' logits out of the buffers if
        captured."""
        if self.want == k:
            self.kept[k] = torch.stack(self.steps)
            self.key_feats[k] = self.key_feat.clone()
            self.served[k] = occ.numpy()
            self.want = self.key_feat = None
            self.steps = []

    def outputs(self) -> Dict:
        return dict(super().outputs(), key_feats=dict(self.key_feats))

    def close(self):
        super().close()
        self.bufs = []


def ref_rollout(ref, traffic, k: int, device, steps: int,
                ego_of: Optional[int] = None):
    """(the reference's key-frame voxel feature, its logits of request k,
    key frame then each step); `ego_of`: the rollout from the ego state of
    that request instead (a planted fault)."""
    batch = tensors(traffic.request(k), device)
    ego = batch["ego_states"] if ego_of is None else tensors(
        traffic.request(ego_of), device)["ego_states"]
    vf, _ = ref.voxel_feat(batch)
    return vf, ref.rollout(vf, ego, steps)


def check(config, traffic, outputs, seed, device) -> Dict[str, float]:
    """Worst numbers over the compared requests. `outputs`: `logits` and
    `served` (request -> the steps' logits and answers, key frame first)
    and `key_feats` (request -> the key frame's voxel feature the timed
    path computed).
      logit_rel_l2, served_vs_logits  `harness/check.py`'s, over every
          step, against the reference's rollout from the host inputs;
      rollout_rel_l2  `rel_l2` over every step against the reference's
          occupancy head and rollout from the program's own key-frame
          feature: the new heads alone, free of the image path's
          bfloat16 rounding that `logit_rel_l2` bounds;
      steps_compared  the grids compared.
    A request answered with another number of steps than the reference's
    reads infinite."""
    with flags_kept():
        return _check(config, forecast_traffic(traffic, config, seed),
                      outputs, seed, device)


def _check(config, traffic, outputs, seed, device) -> Dict[str, float]:
    ref = reference(config, seed, device).eval()
    F = num_future(config)
    logits, served = outputs["logits"], outputs["served"]
    worst = {"logit_rel_l2": 0.0, "served_vs_logits": 0.0,
             "rollout_rel_l2": 0.0}
    n = 0
    for k in sorted(logits):
        with torch.no_grad():
            _, want = ref_rollout(ref, traffic, k, device, F)
            ego = torch.from_numpy(traffic.request(k)["ego_states"])
            own = ref.rollout(outputs["key_feats"][k].to(device).float(),
                              ego.to(device), F)
        got = torch.as_tensor(logits[k]).to(device)
        if len(got) != len(want):  # a rollout of another length
            worst = {m: float("inf") for m in worst}
            continue
        for s, r in enumerate(want):
            c = compare_logits(got[s], torch.as_tensor(served[k][s]).to(
                device), r)
            c["rollout_rel_l2"] = rel_l2(got[s], own[s])
            worst = {m: max(worst[m], c[m]) for m in worst}
            n += 1
    if not logits:  # nothing compared is no pass
        worst = {m: float("inf") for m in worst}
    worst["steps_compared"] = float(n)
    return worst


def work(config, traffic, seed, device, k) -> Dict[str, float]:
    from ..counts.work import count

    traffic = forecast_traffic(traffic, config, seed)
    ref = reference(config, seed, device).eval()
    with torch.no_grad():
        return count(ref, lambda: ref_rollout(ref, traffic, k, device,
                                              num_future(config)),
                     config["sizes"]["dtype"])


# the reference's precision in each reading of `controls`
PRECISION = {"control": "fp8", "rollout_bf16": "rollout_bf16",
             "tf32": "tf32", "ego_other": "f32", "steps_shifted": "f32"}


def controls(config, traffic, seed, device, ks) -> Dict[str, Dict]:
    """The reference in the program's place, each answering with its
    logits' argmax: in float8 where the configuration computes in
    bfloat16 (`control`); with the rollout's heads and the occupancy head
    in bfloat16 (`rollout_bf16`) and everything with TF32 products
    (`tf32`), the configuration computing both in float32; and the
    planted faults, the ego state of the next request instead of its own
    (`ego_other`) and each step answered with the step before it
    (`steps_shifted`: the key frame's twice, the last step's never)."""
    with flags_kept():
        return _controls(config, forecast_traffic(traffic, config, seed),
                         seed, device, ks)


def _controls(config, traffic, seed, device, ks) -> Dict[str, Dict]:
    F = num_future(config)
    out = {}
    for name, precision in PRECISION.items():
        ref = reference(config, seed, device, precision).eval()
        held = {"logits": {}, "key_feats": {}}
        with torch.no_grad():
            for k in ks:
                vf, steps = ref_rollout(ref, traffic, k, device, F,
                                        ego_of=k + 1 if name == "ego_other"
                                        else None)
                if name == "steps_shifted":
                    steps = steps[:1] + steps[:-1]
                held["logits"][k] = torch.stack([s.cpu() for s in steps])
                held["key_feats"][k] = vf.cpu()
        del ref
        if device.type == "cuda":
            torch.cuda.empty_cache()
        held["served"] = {k: v.argmax(-1).numpy()
                          for k, v in held["logits"].items()}
        out[name] = _check(config, traffic, held, seed, device)
    return out
