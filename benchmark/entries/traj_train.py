"""A forecasting train step: `train.loop.batch_to(batch)`, the step of
`train.make_train_step(ema_decay, num_future=F)` on
`create_train_state(model, make_optimizer(...))`, the loss to the host
with `float`, as `entries/train.py` serves the single-frame stages; F is
the configuration's `num_future`, each future step under remat where the
configuration sets it.

The batch carries the traffic's labelled 3-frame input and the future
labels and ego state (`harness/forecast.py`). The check follows set-up's
first `STEPS` steps against the reference's rollout losses, as
`entries/train.py` does; a loss term the program did not report reads
infinitely far from the reference's. In set-up's first step hooks also
copy to the host the forward's occupancy head outputs, the head's first
input (the key frame's voxel feature) and the waypoints, so that the
check holds the rollout's heads alone to the reference's rollout from
that feature (`heads_gaps`).
"""

from __future__ import annotations

import copy
import gc
from typing import Dict, List

import torch

from ..harness.check import (compare_train, initial_params, ref_train,
                             reference, rel_l2, tensors)
from ..harness.forecast import flags_kept, forecast_traffic
from ..harness.inputs import seed_of
from . import train

MODULE_RANGES = False  # the backward's kernels launch outside them
STEPS = train.STEPS


class Entry(train.Entry):
    def __init__(self, model, traffic, device, seed: int, config: Dict):
        from preworld_tpu_torch.train import make_train_step

        super().__init__(model, forecast_traffic(traffic, config, seed),
                         device, seed, config)
        self.num_future = config["sizes"]["num_future"]
        self.step = make_train_step(config["train"]["ema_decay"],
                                    num_future=self.num_future)
        self.capturing = False
        self.kept.update(steps=[], waypoints=[])
        self.hooks = [model.occupancy_head.register_forward_hook(self._head),
                      model.traj_head.register_forward_hook(self._waypoint)]

    def _head(self, module, inputs, output):
        """The forward's key frame and future steps (a remat recompute in
        the backward comes after them and is left alone)."""
        steps = self.kept["steps"]
        if self.capturing and len(steps) <= self.num_future:
            if not steps:
                self.kept["key_feat"] = inputs[0].detach().to("cpu")
            steps.append(output.detach().to("cpu"))

    def _waypoint(self, module, inputs, output):
        w = self.kept["waypoints"]
        if self.capturing and len(w) < self.num_future:
            w.append(output.detach().to("cpu"))

    def run(self, k: int) -> float:
        self.capturing = k == 0
        try:
            return super().run(k)
        finally:
            self.capturing = False

    def close(self):
        super().close()
        for h in self.hooks:
            h.remove()


def sample(mix: Dict, seed: int) -> List[int]:
    return []  # the check follows set-up's first steps


def compare(prog: Dict, ref: Dict, p0) -> Dict[str, float]:
    """`compare_train`, with each loss term that `ref` has and `prog`
    lacks read as infinite."""
    prog = dict(prog, parts=[{n: a.get(n, float("inf")) for n in b}
                             for a, b in zip(prog["parts"], ref["parts"])])
    return compare_train(prog, ref, p0)


def heads_gaps(config, traffic, prog: Dict, seed: int, device
               ) -> Dict[str, float]:
    """Step 1's forward against the reference's `forecast` in train mode
    at the initial weights, on the first batch, from the program's own
    key-frame feature `key_feat`: the rollout's heads, the occupancy head
    and the waypoints alone, free of the image path's bfloat16 rounding.
      rollout_rel_l2   `rel_l2` of the worst of the key frame's and each
                       step's logits (`steps`);
      waypoint_rel_l2  ||W_prog - W_ref|| / ||W_ref|| over every step's
                       waypoints (`waypoints`).
    Outputs of another number of steps or rows, or none, read
    infinite."""
    inf = {"rollout_rel_l2": float("inf"), "waypoint_rel_l2": float("inf")}
    F = config["sizes"]["num_future"]
    steps, way = prog.get("steps", []), prog.get("waypoints", [])
    if "key_feat" not in prog or len(steps) != F + 1 or len(way) != F:
        return inf
    batch = tensors(traffic.request(0), device)
    if len(prog["key_feat"]) != len(batch["ego_states"]):  # other rows
        return inf
    ref = reference(config, seed, device).train()
    with torch.no_grad():
        logits, want = ref.forecast(prog["key_feat"].to(device).float(),
                                    batch["ego_states"], F)
    got = torch.stack(way).to(device).float()
    want = torch.stack(want)
    out = {"rollout_rel_l2": max(rel_l2(g.to(device), r)
                                 for g, r in zip(steps, logits)),
           "waypoint_rel_l2": float(torch.linalg.vector_norm(got - want)
                                    / torch.linalg.vector_norm(want))}
    del ref
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def check(config, traffic, outputs, seed, device) -> Dict[str, float]:
    with flags_kept():
        traffic = forecast_traffic(traffic, config, seed)
        out = compare(outputs, ref_train(config, traffic, seed, device,
                                         steps=STEPS),
                      initial_params(config, seed, device))
        out.update(heads_gaps(config, traffic, outputs, seed, device))
        return out


def work(config, traffic, seed, device, k) -> Dict[str, float]:
    return train.work(config, forecast_traffic(traffic, config, seed), seed,
                      device, k)


def heads_control(config, traffic, seed, device, precision: str) -> Dict:
    """The reference in `precision` in the program's place in step 1's
    forward: its key-frame feature, logits and waypoints."""
    ref = reference(config, seed, device, precision).train()
    batch = tensors(traffic.request(0), device)
    gen = torch.Generator().manual_seed(seed_of(seed, 5))
    with torch.no_grad():
        vf, _ = ref.voxel_feat(batch, gen)
        logits, way = ref.forecast(vf, batch["ego_states"],
                                   config["sizes"]["num_future"])
    out = {"key_feat": vf.cpu(), "steps": [s.cpu() for s in logits],
           "waypoints": [w.cpu() for w in way]}
    del ref
    return out


def controls(config, traffic, seed, device, ks) -> Dict[str, Dict]:
    """`entries/train.py`'s control, planted faults and witness, the fault
    of a program that rolls out one step fewer (`num_future_short`: the
    reference at num_future - 1 in the program's place), and, by
    `heads_gaps` alone, the reference with the rollout's heads and the
    occupancy head in bfloat16 (`rollout_bf16`) and with TF32 products
    (`tf32`), the configuration computing both in float32."""
    with flags_kept():
        traffic = forecast_traffic(traffic, config, seed)
        out = train.controls(config, traffic, seed, device, ks)
        short = copy.deepcopy(config)
        short["sizes"]["num_future"] -= 1
        p0 = initial_params(config, seed, device)
        ref = ref_train(config, traffic, seed, device, steps=STEPS)
        out["num_future_short"] = compare(
            ref_train(short, traffic, seed, device, steps=STEPS), ref, p0)
        del ref
        gc.collect()
        for precision in ("rollout_bf16", "tf32"):
            held = heads_control(config, traffic, seed, device, precision)
            out[precision] = heads_gaps(config, traffic, held, seed, device)
        return out
