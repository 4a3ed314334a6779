"""The program as a user builds it, and what every entry shares.

`build_program` builds the program's model from the repository's
configuration file (`utils.config.Config.fromfile`, `train.build_model`)
and holds it to the sizes of the benchmark's configuration file. An entry
(`benchmark/entries/<name>.py`, named by the mix's `entry`) runs one input
from host inputs to a host result with `run(k)`; `InferEntry` keeps the
occupancy head's logits of chosen inputs for the check: a forward hook
holds the head's output (no copy, no buffer of its own), and once the
input's result is on the host, outside its timing, the logits go to the
host too. Nothing of the program is patched or wrapped.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]


def build_program(config: Dict, device):
    """The program's model of the configuration, checked against its
    sizes; raises if the repository's configuration file has changed."""
    from preworld_tpu_torch.train import build_model
    from preworld_tpu_torch.utils import Config

    model = build_model(Config.fromfile(str(REPO / config["program_config"])),
                        device=device)
    check_sizes(model.cfg, config["sizes"])
    return model


def check_sizes(pc, s: Dict) -> None:
    """Raise unless the program's `PreWorldConfig` has the sizes."""
    got = {
        "grid": {k: list(getattr(pc.grid, k)) for k in ("x", "y", "z",
                                                         "depth")},
        "input_size": list(pc.input_size), "num_cams": pc.num_cams,
        "temporal_frames": pc.temporal_frames,
        "extra_ref_frames": pc.extra_ref_frames, "backbone": pc.backbone,
        "swin_embed_dims": pc.swin_embed_dims,
        "swin_depths": list(pc.swin_depths),
        "swin_num_heads": list(pc.swin_num_heads),
        "swin_window": pc.swin_window,
        "neck_out_channels": pc.neck_out_channels,
        "num_trans_channels": pc.num_trans_channels,
        "num_classes": pc.num_classes, "out_dim": pc.out_dim,
        "if_render": pc.if_render, "if_post_finetune": pc.if_post_finetune,
        "use_lss_depth_loss": pc.use_lss_depth_loss,
        "depth_loss_weight": pc.depth_loss_weight,
        "dtype": str(pc.dtype).replace("torch.", ""), "remat": pc.remat,
    }
    want = {k: s[k] for k in got}
    if got != want:
        diff = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
        raise ValueError(f"the program's configuration differs: {diff}")


class Entry:
    """Base: `run(k)` serves input k and returns its seconds."""

    def __init__(self, model, traffic, device):
        self.model, self.traffic, self.device = model, traffic, device

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class InferEntry(Entry):
    """An inference entry: eval mode, and the logits of the inputs named
    by `capture` kept on the host (`kept`, with the served answers in
    `served`)."""

    def __init__(self, model, traffic, device):
        super().__init__(model, traffic, device)
        model.eval()
        self.want: Optional[int] = None
        self.held: Optional[torch.Tensor] = None
        self.kept: Dict[int, torch.Tensor] = {}
        self.served: Dict[int, np.ndarray] = {}
        self.hook = model.occupancy_head.register_forward_hook(self._hold)

    def _hold(self, module, inputs, output):
        if self.want is not None:
            self.held = output

    def capture(self, k: int) -> None:
        """Keep input k's logits and answer."""
        self.want = k

    def _finish(self, k: int, occ: torch.Tensor) -> None:
        """After input k's timing: its logits to the host if captured."""
        if self.want == k:
            self.kept[k] = self.held.detach().cpu()
            self.served[k] = occ.numpy()
            self.want = self.held = None

    def outputs(self) -> Dict:
        return {"logits": dict(self.kept), "served": dict(self.served)}

    def close(self):
        self.hook.remove()
