"""The reference PreWorld4DTraj: 4-D occupancy forecasting with the ego
trajectory, in plain float32 PyTorch.

`PreWorldRef`'s voxel feature v of the key frame (B, X, Y, Z, C), then
`num_future` unrolls of one weight-shared step (getterupper/PreWorld,
`preworld-7frame-finetune-traj.py`, `type="PreWorld4DTraj"`), each from
the same ego state s (B, 21):

  e  = plan_head(s)                         21 -> 256 -> 256 -> C, ReLU
  v' = fusion_head([v, e on every voxel]) + v   2C -> 4C -> C, softplus
  d  = mean over X, Y, Z of downscale(v')   three 2x2x2 stride-2 convs,
                                            C -> 2C -> 4C -> 4C, with bias
  e' = e + ego_fusion_head([e, d])          5C -> 8C -> 4C -> 2C -> C,
                                            softplus
  w  = traj_head(e')                        C -> 2C -> 2, softplus between:
                                            the step's waypoint

v' is the step's feature: the occupancy head reads it and the next step
starts from it. A request's answer is the occupancy head's logits of v and
of each step's v' (`rollout`); the train stage's losses are the four voxel
losses of the key frame under `_0s` and, for step k, the four voxel losses
against `temporal_semantics[:, k - 1]` and `loss_traj` (the sum over the
two coordinates of the batch mean of (w - temporal_trajs[:, k - 1])^2)
under `_{k}s`. Parameter names equal the program's.

Departures from the published model, none of which changes a compared
value: in train mode each pass of the occupancy head's BatchNorms
normalises with its own batch statistics, as the program's does, but no
running statistic is folded (the program folds the key frame's and then
each step's, in that order; no compared number reads them); with
`checkpoint_backbone` (the train check) each future step, like each
backbone pass, is recomputed in the backward so that the float32 step fits
on one card; an odd axis before a stride-2 convolution gets one zero plane
after the data (flax's "SAME"), which the published sizes never meet
(200 -> 100 -> 50 -> 25, 16 -> 8 -> 4 -> 2). Only the finetune stage
(occupancy losses) is written: the configuration renders no rays.

Besides `PreWorldRef`'s precisions, `set_precision` takes two controls of
the forecasting heads, which the configuration computes in float32:
'rollout_bf16', the rollout's heads and the occupancy head in bfloat16
both ways (every product's operands and result, every module's output,
and the steps' residual streams v' and e'), the image path in float32;
'tf32', everything in float32 with TF32 products (it switches the
process's TF32 flags on; the next `harness.check.reference` switches them
off).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import Conv2d, Conv3d, Linear, MlpSequence, lower, to_cf
from .losses import depth_bce_loss, voxel_losses
from .model import PreWorldRef, RefConfig, _round_output

EGO_STATE_DIM = 21
# the modules of a forecast step and the occupancy head ('rollout_bf16')
ROLLOUT = ("plan_head", "fusion_head", "downscale", "ego_fusion_head",
           "traj_head", "occupancy_head")


class PlanHead(nn.Module):
    def __init__(self, out_dim: int):
        super().__init__()
        self.fc1 = Linear(EGO_STATE_DIM, 256)
        self.fc2 = Linear(256, 256)
        self.fc3 = Linear(256, out_dim)

    def forward(self, x):
        return self.fc3(F.relu(self.fc2(F.relu(self.fc1(x)))))


class EgoFusionHead(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.fc0 = Linear(5 * c, 8 * c)
        self.fc1 = Linear(8 * c, 4 * c)
        self.fc2 = Linear(4 * c, 2 * c)
        self.fc3 = Linear(2 * c, c)

    def forward(self, x):
        x = F.softplus(self.fc0(x))
        x = F.softplus(self.fc1(x))
        x = F.softplus(self.fc2(x))
        return self.fc3(x)


class DownScale3D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.down1 = Conv3d(c, 2 * c, 2, 2)
        self.down2 = Conv3d(2 * c, 4 * c, 2, 2)
        self.down3 = Conv3d(4 * c, 4 * c, 2, 2)

    def forward(self, v):
        x = to_cf(v)
        for conv in (self.down1, self.down2, self.down3):
            odd = [n % 2 for n in x.shape[2:]]
            if any(odd):
                x = F.pad(x, (0, odd[2], 0, odd[1], 0, odd[0]))
            x = conv(x)
        return x.mean(dim=(2, 3, 4))


class PreWorldTrajRef(PreWorldRef):
    def __init__(self, cfg: RefConfig, num_future: int,
                 checkpoint_backbone: bool = False):
        super().__init__(cfg, checkpoint_backbone)
        c = cfg.out_dim
        self.num_future = num_future
        self.plan_head = PlanHead(c)
        self.fusion_head = MlpSequence(2 * c, 4 * c, c)
        self.downscale = DownScale3D(c)
        self.ego_fusion_head = EgoFusionHead(c)
        self.traj_head = MlpSequence(c, 2 * c, 2)
        self.stream = None  # the residual streams' rounding ('bf16')

    @classmethod
    def from_sizes(cls, sizes: Dict, **kw) -> "PreWorldTrajRef":
        return cls(RefConfig.from_sizes(sizes), sizes["num_future"], **kw)

    def set_precision(self, mode: str) -> None:
        """`PreWorldRef`'s modes, 'rollout_bf16' and 'tf32' (see above)."""
        tf32 = mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        rollout = mode == "rollout_bf16"
        super().set_precision("f32" if rollout or tf32 else mode)
        self.stream = "bf16" if rollout else None
        for name in ROLLOUT:
            for m in getattr(self, name).modules():
                if isinstance(m, (Linear, Conv2d, Conv3d)):
                    m.quant = self.stream
                elif rollout:
                    self.__dict__["_round_hooks"].append(
                        m.register_forward_hook(_round_output("bf16")))

    def step(self, v, ego_states):
        """One future step -> (v', the waypoint (B, 2))."""
        e = self.plan_head(ego_states)
        grid_e = e[:, None, None, None, :].expand(*v.shape[:-1], e.shape[-1])
        v = lower(self.fusion_head(torch.cat([v, grid_e], dim=-1)) + v,
                  self.stream)
        e = lower(e + self.ego_fusion_head(torch.cat([e, self.downscale(v)],
                                                     dim=-1)), self.stream)
        return v, self.traj_head(e)

    def rollout(self, vf, ego_states, steps: int) -> List[torch.Tensor]:
        """The occupancy logits of the key frame and of `steps` future
        steps, in order."""
        return self.forecast(vf, ego_states, steps)[0]

    def forecast(self, vf, ego_states, steps: int
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(`rollout`'s logits, the waypoint of each step)."""
        logits, waypoints = [self.occupancy_logits(vf)], []
        for _ in range(steps):
            vf, w = self.step(vf, ego_states)
            logits.append(self.occupancy_logits(vf))
            waypoints.append(w)
        return logits, waypoints

    def _future_losses(self, v, ego_states, target, traj):
        v, w = self.step(v, ego_states)
        terms = voxel_losses(self.occupancy_logits(v), target,
                             self.cfg.num_classes)
        terms["loss_traj"] = ((w - traj) ** 2).mean(dim=0).sum()
        return v, terms

    def future_losses(self, vf, batch) -> Dict[str, torch.Tensor]:
        """The `_{k}s` losses of the `num_future` steps from the key frame's
        voxel feature vf, each step recomputed in the backward with
        `checkpoint_backbone`."""
        losses = {}
        remat = self.checkpoint_backbone and torch.is_grad_enabled()
        for k in range(1, self.num_future + 1):
            args = (vf, batch["ego_states"],
                    batch["temporal_semantics"][:, k - 1].long(),
                    batch["temporal_trajs"][:, k - 1])
            vf, terms = (checkpoint(self._future_losses, *args,
                                    use_reentrant=False) if remat
                         else self._future_losses(*args))
            losses.update({f"{n}_{k}s": v for n, v in terms.items()})
        return losses

    def loss(self, batch, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """The rollout train stage's weighted losses over `num_future`
        steps (call in train mode)."""
        c = self.cfg
        if c.if_render or not c.if_post_finetune:
            raise ValueError("the forecasting reference writes the finetune "
                             "stage only")
        vf, depth = self.voxel_feat(batch, gen)
        losses = {}
        if c.use_lss_depth_loss:
            losses["loss_lss_depth"] = depth_bce_loss(
                depth, batch["gt_depth"], self.downsample, c.grid,
                c.depth_loss_weight)
        losses.update({k + "_0s": v for k, v in voxel_losses(
            self.occupancy_logits(vf), batch["voxel_semantics"].long(),
            c.num_classes).items()})
        losses.update(self.future_losses(vf, batch))
        return losses
