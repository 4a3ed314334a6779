"""What the inference entries share: the sampled inputs and the control."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from .check import check_infer, reference
from .inputs import sample_indices


def infer_sample(mix: Dict, seed: int) -> List[int]:
    """`check_frames` window offsets in `check_window`, from the seed."""
    return sample_indices(seed, mix["check_frames"], *mix["check_window"])


def infer_controls(ref_logits: Callable, config: Dict, traffic, seed: int,
                   device, ks: List[int]) -> Dict[str, Dict]:
    """The control: the reference in float8 in the program's place on the
    inputs ks, its answers its logits' argmax."""
    low = reference(config, seed, device, "fp8").eval()
    with torch.no_grad():
        logits = {k: ref_logits(low, traffic, k, device).cpu() for k in ks}
    del low
    if device.type == "cuda":
        torch.cuda.empty_cache()
    served = {k: v.argmax(-1).numpy() for k, v in logits.items()}
    return {"control": check_infer(ref_logits, config, traffic, logits,
                                   served, seed, device)}
