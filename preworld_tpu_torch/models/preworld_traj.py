"""PreWorld4DTraj: 4-D occupancy forecasting with the ego trajectory.

Counterpart of `preworld_tpu/models/preworld_traj.py`. After the voxel
feature of the current frame, a weight-shared step is unrolled `num_future`
times: the ego state's embedding (`plan_head`) is broadcast over the grid
and fused into the voxel feature (`fusion_head`, residual), the fused grid
is pooled to one vector (`downscale`) that updates the ego embedding
(`ego_fusion_head`, residual), and `traj_head` predicts the step's ego
waypoint. Each step's fused feature feeds the heads (occupancy, or the
render fields) and the next step. The heads and the rollout compute in
f32. Module names mirror the flax tree, so `utils/flax_bridge.py` carries
the weights.

Extra batch keys:
  ego_states         (B, 21)            current ego kinematics
  temporal_semantics (B, F, X, Y, Z)    future occupancy targets
  temporal_rays      (B, F, R, 16)      future render rays (if_render)
  temporal_trajs     (B, F, 2)          future ego waypoints

Training: the OccHead runs once for the key frame and once per future step,
so in train mode its BatchNorm folds num_future + 1 batch statistics into
its running ones, in that order. With `cfg.remat` each future step (rollout
and losses) runs under `torch.utils.checkpoint`, the JAX package's `nn.remat`
of `_future_step_losses`; the recompute folds no statistics again. Under a
mesh every loss, `l2_traj_loss` among them, is this rank's share of the
global batch's (`parallel` invariant 1).

With `utils.trace` on, `predict` is the root span of a request, `rollout`
holds the future-step loop of `predict` and of `loss`, `rollout_step` each
step's rollout and `future_losses` a step's losses; the counter
`rollout_steps` adds one for each step the loop runs (a checkpoint's
recompute runs the step again but not the loop, so it counts nothing).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.collectives import batch_sums, replica_share
from ..utils import trace
from .layers import Linear, MlpSequence
from .nerf_head import nerf_head_losses
from .occ_head import DownScale3D
from .preworld import PreWorld, PreWorldConfig
from .view_transformer import depth_bce_loss

EGO_STATE_DIM = 21


class PlanHead(nn.Module):
    """Ego-state MLP 21 -> 256 -> 256 -> out_dim, ReLU."""

    def __init__(self, out_dim: int, in_dim: int = EGO_STATE_DIM):
        super().__init__()
        self.fc1 = Linear(in_dim, 256)
        self.fc2 = Linear(256, 256)
        self.fc3 = Linear(256, out_dim)

    def forward(self, x):
        return self.fc3(F.relu(self.fc2(F.relu(self.fc1(x)))))


class EgoFusionHead(nn.Module):
    """5C -> 8C -> 4C -> 2C -> C with Softplus."""

    def __init__(self, out_dim: int):
        super().__init__()
        c = out_dim
        self.fc0 = Linear(5 * c, 8 * c)
        self.fc1 = Linear(8 * c, 4 * c)
        self.fc2 = Linear(4 * c, 2 * c)
        self.fc3 = Linear(2 * c, c)

    def forward(self, x):
        for fc in (self.fc0, self.fc1, self.fc2):
            x = F.softplus(fc(x))
        return self.fc3(x)


def rollout_curriculum(epoch: int, if_render: bool) -> int:
    """Number of future rollout steps for this epoch."""
    if if_render:
        return 2 if epoch <= 2 else min(epoch - 1, 6)
    return 2 if epoch <= 4 else min((epoch - 3) // 2 + 1, 6)


def l2_traj_loss(pred, gt):
    """Sum over the coordinates of the batch-mean squared error; under a
    mesh, of the global batch, at `replica_share()`."""
    sq, n = batch_sums(((pred - gt) ** 2).sum(dim=0),
                       pred.new_tensor(float(pred.shape[0])))
    return (sq / n).sum() * replica_share()


class PreWorld4DTraj(PreWorld):
    def __init__(self, cfg: PreWorldConfig):
        super().__init__(cfg)
        c = cfg.out_dim
        self.plan_head = PlanHead(c)
        self.fusion_head = MlpSequence(2 * c, 4 * c, c)
        self.downscale = DownScale3D(c)
        self.ego_fusion_head = EgoFusionHead(c)
        self.traj_head = MlpSequence(c, 2 * c, 2)

    @trace.spanned("rollout_step")
    def rollout_step(self, voxel_feats, ego_states):
        """One future step: (B, X, Y, Z, C) f32 feats and (B, 21) ego states
        -> (fused feats (B, X, Y, Z, C), pred_traj (B, 2))."""
        ego_feats = self.plan_head(ego_states)
        grid_ego = ego_feats[:, None, None, None, :].expand_as(voxel_feats)
        fused = self.fusion_head(torch.cat([voxel_feats, grid_ego], dim=-1))
        fused = fused + voxel_feats
        down = self.downscale(fused)
        fused_ego = ego_feats + self.ego_fusion_head(
            torch.cat([ego_feats, down], dim=-1))
        return fused, self.traj_head(fused_ego)

    def _future_step_losses(self, voxel_feats, ego_states, target, traj_gt,
                            rays, bda):
        """One rollout step and its losses, un-suffixed -> (fused feats,
        loss dict)."""
        c = self.cfg
        voxel_feats, pred_traj = self.rollout_step(voxel_feats, ego_states)
        terms: Dict[str, torch.Tensor] = {}
        with trace.span("future_losses"):
            if c.if_post_finetune:
                terms.update(self._voxel_losses(
                    self.occupancy_logits(voxel_feats), target))
            if c.if_render:
                density, semantic, color = self.predict_attributes(
                    voxel_feats)
                terms.update(nerf_head_losses(density, semantic, color, rays,
                                              bda, c.nerf))
            terms["loss_traj"] = l2_traj_loss(pred_traj, traj_gt)
        return voxel_feats, terms

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: torch.Generator,
             num_future: int = 2) -> Dict[str, torch.Tensor]:
        """Rollout training losses: the key frame's under `_0s`, rollout
        step k's under `_{k}s`, `loss_traj_{k}s` among them. Masks come from
        `generator`; BatchNorm follows the module's mode."""
        c = self.cfg
        voxel_feats, depth = self.extract_voxel_feat(batch, train=True,
                                                     generator=generator)
        losses: Dict[str, torch.Tensor] = {}
        if c.use_lss_depth_loss:
            losses["loss_lss_depth"] = depth_bce_loss(
                depth, batch["gt_depth"], self.view_transformer.downsample,
                c.grid, weight=c.depth_loss_weight)
        if c.if_post_finetune:
            losses.update(self._voxel_losses(
                self.occupancy_logits(voxel_feats),
                batch["voxel_semantics"].long(), "_0s"))
        if c.if_render:
            density, semantic, color = self.predict_attributes(voxel_feats)
            losses.update({k + "_0s": v for k, v in nerf_head_losses(
                density, semantic, color, batch["rays"], batch["bda"],
                c.nerf).items()})
        with trace.span("rollout"):
            for step in range(1, num_future + 1):
                trace.count("rollout_steps", 1)
                target = (batch["temporal_semantics"][:, step - 1].long()
                          if c.if_post_finetune else None)
                rays = (batch["temporal_rays"][:, step - 1] if c.if_render
                        else None)
                voxel_feats, terms = self._segment(
                    self._future_step_losses, voxel_feats,
                    batch["ego_states"], target,
                    batch["temporal_trajs"][:, step - 1], rays, batch["bda"])
                losses.update({f"{k}_{step}s": v for k, v in terms.items()})
        return losses

    @torch.no_grad()
    @trace.spanned("predict")
    def predict(self, batch: Dict[str, torch.Tensor],
                num_future: int = 6) -> Dict[str, torch.Tensor]:
        """Occupancy of the current frame and of `num_future` rollout steps:
        `semantic_occ_{k}s`, (B, X, Y, Z) int32, k = 0 .. num_future."""
        voxel_feats, _ = self.extract_voxel_feat(batch)
        out = {"semantic_occ_0s": self._occupancy(voxel_feats)[0]}
        with trace.span("rollout"):
            for step in range(1, num_future + 1):
                trace.count("rollout_steps", 1)
                voxel_feats, _ = self.rollout_step(voxel_feats,
                                                   batch["ego_states"])
                out[f"semantic_occ_{step}s"] = self._occupancy(
                    voxel_feats)[0]
        return out

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                num_future: int = 2):
        """The JAX module's dispatch: the rollout losses for a batch with
        `temporal_trajs`, the rollout prediction for one with `ego_states`,
        else the single-frame prediction."""
        if "temporal_trajs" in batch:
            return self.loss(batch, generator, num_future=num_future)
        if "ego_states" in batch:
            return self.predict(batch)
        return PreWorld.predict(self, batch)
