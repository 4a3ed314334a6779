"""What the port's command-line entry points share: the device flag, and
the synthetic samples of `--synthetic` runs."""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="where the model runs: the card (cuda, or cuda:N "
                        "for card N; default; no card is an error) or the "
                        "CPU (cpu)")


def resolve_device(name: str) -> torch.device:
    """The device of `--device` (cuda, cuda:N or cpu); raises for a card
    that is not there (there is no fallback to the CPU or to another
    card)."""
    device = torch.device(name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: expected cuda, cuda:N or cpu")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: this entry point runs on the "
                               "card; pass --device cpu to run on the CPU")
        if device.index is not None and \
                device.index >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {name}: "
                               f"{torch.cuda.device_count()} card(s)")
    return device


def synthetic_sample(cfg, seed: int, num_rays: int, with_labels: bool = True,
                     with_traj: bool = False) -> Dict[str, np.ndarray]:
    """One sample (no batch axis) of `data.synthetic_batch`."""
    from ..data import synthetic_batch

    b = synthetic_batch(cfg, 1, num_rays=num_rays, seed=seed,
                        with_labels=with_labels, with_traj=with_traj)
    return {k: v[0] for k, v in b.items()}


class SyntheticDataset:
    """`n` synthetic samples, sample i from seed i."""

    def __init__(self, cfg, n: int, num_rays: int, with_traj: bool = False):
        self.cfg, self.n = cfg, n
        self.num_rays, self.with_traj = num_rays, with_traj

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return synthetic_sample(self.cfg, i, self.num_rays,
                                with_traj=self.with_traj)
