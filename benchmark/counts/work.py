"""The work of a frame or a step, counted on the reference, and the peaks.

FLOPs are what `torch.utils.flop_counter.FlopCounterMode` counts on the
reference at the cell's shapes: matrix products and convolutions, forward
(a frame) or forward and backward (a step; the reference recomputes
nothing, so no rematerialisation is counted). The image backbone's bytes
are what its calls need at least, each once: the images in the served
precision, the parameters of every module that ran (float32, as the
program reads its master weights), and the features returned in the
served precision. The peaks are the H100 SXM's data sheet, dense.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
SERVED_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def count(model: torch.nn.Module, fn: Callable[[], object],
          served_dtype: str) -> Dict[str, float]:
    """Run fn() once under the counter; returns the total FLOPs, the image
    backbone's FLOPs and bytes."""
    act = SERVED_BYTES[served_dtype]
    backbone = model.img_backbone
    nbytes = [0]
    handles = []

    def io_hook(module, args, out):
        outs = out if isinstance(out, (tuple, list)) else (out,)
        nbytes[0] += act * (args[0].numel() + sum(o.numel() for o in outs))

    def weight_hook(module, args, out):
        nbytes[0] += 4 * sum(p.numel() for p in module.parameters(
            recurse=False))

    handles.append(backbone.register_forward_hook(io_hook))
    for m in backbone.modules():
        if any(True for _ in m.parameters(recurse=False)):
            handles.append(m.register_forward_hook(weight_hook))
    try:
        with FlopCounterMode(display=False) as fc:
            fn()
    finally:
        for h in handles:
            h.remove()
    # the counter names a module by its path from the outermost module
    # whose forward ran: `PreWorldRef.img_backbone`, or the backbone's class
    # when the caller reached it through a method of the model
    names = {"img_backbone", type(backbone).__name__}
    bb = sum(sum(v.values()) for k, v in fc.get_flop_counts().items()
             if k.split(".")[-1] in names and k.count(".") <= 1)
    return {"flops": float(fc.get_total_flops()),
            "img_backbone_flops": float(bb),
            "img_backbone_bytes": float(nbytes[0])}
