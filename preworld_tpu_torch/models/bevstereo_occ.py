"""BEVStereoOCC: the plain occupancy baseline (no world-model heads).

Counterpart of `preworld_tpu/models/bevstereo_occ.py`: PreWorld's feature
extractor, then `final_conv` -> the `predicter` MLP (f32) -> 18 class
logits; the loss is the mean cross-entropy of their log-softmax plus the
LSS depth BCE (weight `cfg.depth_loss_weight`), and inference their argmax.
Under a mesh both losses are this rank's shares of the global batch's.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..parallel.collectives import batch_sums, replica_share
from .layers import MlpSequence
from .preworld import PreWorld, PreWorldConfig
from .view_transformer import depth_bce_loss


def occ_ce_loss(logits, target):
    """Mean cross-entropy over every voxel; under a mesh, over the global
    batch's, at `replica_share()`."""
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, target[..., None])[..., 0]
    total, n = batch_sums(ce.sum(), ce.new_tensor(float(ce.numel())))
    return total / n * replica_share()


class BEVStereoOCC(PreWorld):
    def __init__(self, cfg: PreWorldConfig):
        super().__init__(cfg)
        # PreWorld's heads: the JAX module builds them lazily and never
        # calls them, so its parameter tree holds none of them
        del self.occupancy_head, self.density_mlp, self.semantic_mlp
        del self.color_mlp
        self.predicter = MlpSequence(cfg.out_dim, cfg.out_dim * 2,
                                     cfg.num_classes)

    def occ_logits(self, batch, train: bool = False, generator=None):
        """(logits (B, X, Y, Z, num_classes) f32, key-frame depth)."""
        voxel_feats, depth = self.extract_voxel_feat(batch, train=train,
                                                     generator=generator)
        return self.predicter(voxel_feats), depth

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """{'loss_occ', 'loss_depth'}. Call in train mode."""
        c = self.cfg
        logits, depth = self.occ_logits(batch, train=True,
                                        generator=generator)
        return {"loss_occ": occ_ce_loss(logits,
                                        batch["voxel_semantics"].long()),
                "loss_depth": depth_bce_loss(
                    depth, batch["gt_depth"],
                    self.view_transformer.downsample, c.grid,
                    weight=c.depth_loss_weight)}

    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """{'semantic_occ'}: (B, X, Y, Z) int32."""
        logits, _ = self.occ_logits(batch)
        return {"semantic_occ": logits.argmax(-1).to(torch.int32)}
