"""A train step: `train.loop.batch_to(batch)`, the step of
`train.make_train_step` on `create_train_state(model, make_optimizer(...))`,
the loss to the host with `float`, as the loop logs it.

The check follows set-up's first `STEPS` steps (`harness/check.py`
`compare_train`): the entry keeps their losses, the optimizer's first
moments after step 1 (the step-1 gradient as it took it) and after the
last, and the parameters and their EMA after the last, on the host."""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from ..harness.check import compare_train, initial_params, ref_train, tensors
from ..harness.inputs import seed_of
from ..harness.program import Entry as Base

MODULE_RANGES = False  # the backward's kernels launch outside them
STEPS = 3
B1 = 0.9


class Entry(Base):
    def __init__(self, model, traffic, device, seed: int, config: Dict):
        from preworld_tpu_torch.train import (
            create_train_state,
            make_optimizer,
            make_train_step,
        )

        super().__init__(model, traffic, device)
        t = config["train"]
        self.state = create_train_state(model, make_optimizer(
            model.parameters(), base_lr=t["lr"],
            weight_decay=t["weight_decay"], clip_norm=t["clip"],
            warmup_iters=t["warmup_iters"]), t["ema_init_updates"])
        self.step = make_train_step(t["ema_decay"])
        self.gen = torch.Generator().manual_seed(seed_of(seed, 5))
        self.kept: Dict = {"losses": [], "parts": []}

    def run(self, k: int) -> float:
        from preworld_tpu_torch.train.loop import batch_to

        batch = self.traffic.request(k)
        t0 = time.perf_counter()
        self.state, metrics = self.step(self.state,
                                        batch_to(batch, self.device),
                                        self.gen)
        loss = float(metrics["loss_total"])
        dt = time.perf_counter() - t0
        if k < STEPS:
            self._keep(k, loss, metrics)
        return dt

    def _keep(self, k: int, loss: float, metrics: Dict) -> None:
        kept = self.kept
        kept["losses"].append(loss)
        kept["parts"].append({n: float(v) for n, v in metrics.items()})
        if k == 0:  # the step-1 gradient as the optimizer took it
            kept["grads"] = {n: m / (1 - B1)
                             for n, m in self._moments().items()}
        if k == STEPS - 1:
            kept["moments"] = self._moments()
            named = list(self.model.named_parameters())
            kept["params"] = {n: p.detach().to("cpu", copy=True)
                              for n, p in named}
            kept["ema"] = {n: self.state.ema_params[n].detach().to(
                "cpu", copy=True) for n, _ in named}

    def _moments(self) -> Dict[str, torch.Tensor]:
        opt = self.state.optimizer
        # a step that left no moment saw no gradient
        return {n: opt.state[p].get("mu", torch.zeros_like(p)).detach()
                .to("cpu", copy=True)
                for n, p in self.model.named_parameters()}

    def outputs(self) -> Dict:
        return self.kept

    def close(self):
        self.state = None
        self.step = None


def sample(mix: Dict, seed: int) -> List[int]:
    return []  # the check follows set-up's first steps


def check(config, traffic, outputs, seed, device) -> Dict[str, float]:
    return compare_train(outputs, ref_train(config, traffic, seed, device,
                                            steps=STEPS),
                         initial_params(config, seed, device))


def work(config, traffic, seed, device, k) -> Dict[str, float]:
    """A step counted on its first sample, times the batch: every counted
    product is per sample."""
    from ..counts.work import count
    from ..harness.check import reference

    ref = reference(config, seed, device)
    ref.train()
    one = {n: v[:1] for n, v in traffic.request(k).items()}
    gen = torch.Generator().manual_seed(seed_of(seed, 6))

    def step():
        out = ref.loss(tensors(one, device), gen)
        sum(out[n] for n in sorted(out)).backward()

    w = count(ref, step, config["sizes"]["dtype"])
    return {n: v * traffic.batch for n, v in w.items()}


def controls(config, traffic, seed, device, ks) -> Dict[str, Dict]:
    """The control (the reference in float8), and the planted faults read
    by the same measure: half of each batch left out (the mean over the
    rest), the EMA's updates counted from 0 (its decay ramp restarted);
    and the reference in bfloat16, the configuration's precision, as a
    witness of what rounding alone reads."""
    p0 = initial_params(config, seed, device)
    ref = ref_train(config, traffic, seed, device, steps=STEPS,
                    extra_ema=0)
    out = {"ema_from_zero": compare_train(dict(ref, ema=ref["ema_extra"]),
                                          ref, p0)}
    for name, kw in (("control", {"precision": "fp8"}),
                     ("half_batch", {"rows": traffic.batch // 2}),
                     ("bf16_witness", {"precision": "bf16"})):
        out[name] = compare_train(ref_train(config, traffic, seed, device,
                                            steps=STEPS, **kw), ref, p0)
        gc.collect()
    return out
