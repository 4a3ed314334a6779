"""The forecasting model's inputs beside the general traffic.

`ForecastTraffic` wraps a `Traffic` (`inputs.py`) and adds to its request
k, from the run's seed and k alone:

  ego_states          (B, 21) f32, N(0, 1): the length of the published
                      data's AD-MLP ego kinematics vector (no value here
                      changes the work);
  temporal_trajs      (B, F, 2) f32, labelled traffic only: the x, y of
                      the drive's next F poses in the key frame's ego frame
                      (past the drive's end, its last pose);
  temporal_semantics  (B, F, X, Y, Z) int32, labelled traffic only: F grids
                      a sample drawn as `voxel_semantics` are, all from one
                      scene's free share and class mix a sample, from a
                      ring of the mix's `ring` batches built here.

F is the configuration's `num_future`. Everything else (`batch`, `mix`,
the images, poses and labels) is the wrapped traffic's.

`flags_kept` keeps the process's TF32 flags across the forecasting
entries' checks and controls, which build references (TF32 off): a
program served after them in the same process (`control.py --program`)
runs as a timed run does.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from .inputs import Traffic

EGO_STATE_DIM = 21


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([seed & ((1 << 64) - 1), 8, *salt])


class ForecastTraffic:
    def __init__(self, traffic: Traffic, num_future: int, seed: int):
        self.base, self.num_future, self.seed = traffic, num_future, seed
        self.future_ring = ([self._future_semantics(_rng(seed, 1, r))
                             for r in range(traffic.mix["ring"])]
                            if traffic.labels else None)

    def __getattr__(self, name):  # batch, mix, sizes, ... of the traffic
        return getattr(self.base, name)

    def _future_semantics(self, rng: np.random.Generator) -> np.ndarray:
        s, mix = self.base.sizes, self.base.mix
        g = s["grid"]
        shape = tuple(int(round((a[1] - a[0]) / a[2]))
                      for a in (g["x"], g["y"], g["z"]))
        n = s["num_classes"]
        out = []
        for _ in range(self.batch):
            free = rng.uniform(*mix["free_share"])
            w = rng.dirichlet(np.full(n - 1, mix["class_concentration"]))
            p = np.append(w * (1.0 - free), free)
            out.append(rng.choice(n, size=(self.num_future, *shape),
                                  p=p / p.sum()).astype(np.int32))
        return np.stack(out)

    def _trajs(self, k: int) -> np.ndarray:
        top = k + self.base.T - 1
        out = np.zeros((self.batch, self.num_future, 2), np.float32)
        for b, d in enumerate(self.base.drives):
            key_inv = np.linalg.inv(d[top].astype(np.float64))
            for j in range(self.num_future):
                pose = d[min(top + 1 + j, len(d) - 1)]
                out[b, j] = (key_inv @ pose)[:2, 3]
        return out

    def request(self, k: int) -> Dict[str, np.ndarray]:
        out = self.base.request(k)
        out["ego_states"] = _rng(self.seed, 2, k).standard_normal(
            (self.batch, EGO_STATE_DIM), dtype=np.float32)
        if self.future_ring is not None:
            out["temporal_trajs"] = self._trajs(k)
            out["temporal_semantics"] = self.future_ring[
                k % len(self.future_ring)]
        return out


def forecast_traffic(traffic, config: Dict, seed: int) -> ForecastTraffic:
    """The cell's traffic with the forecasting inputs (idempotent)."""
    if isinstance(traffic, ForecastTraffic):
        return traffic
    return ForecastTraffic(traffic, config["sizes"]["num_future"], seed)


@contextlib.contextmanager
def flags_kept():
    """The process's TF32 flags as they were, on leaving."""
    kept = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = kept
