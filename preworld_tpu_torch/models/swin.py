"""Swin Transformer backbone (Swin-B "stbase" config).

Counterpart of `preworld_tpu/models/swin.py`. Every stage runs on the
stage-persistent padded (B, Hp, Wp, C) layout: the input is padded once
per stage to a multiple of the window, every block runs the two half-block
kernels on it (K1 `ops/swin_block_pallas.py`, K2 `ops/swin_mlp_pallas.py`;
their plain versions on CPU tensors), and the stage slices the real region
once at its end. The window is clamped to min(window, H, W) and the shift
is 0 when that window covers the whole feature map, as in the JAX package.
PatchMerging uses the unfold channel order c*4 + kh*2 + kw.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.swin_block_pallas import fused_swin_attn_block
from ..ops.swin_mlp_pallas import fused_swin_mlp


def relative_position_index(ws: int) -> np.ndarray:
    """Standard Swin relative-position index table, (ws*ws, ws*ws)."""
    coords = np.stack(
        np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shifted_window_region_ids(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """Per-token shift-region ids for SW-MSA, (nW, ws*ws) float32, windows
    row-major."""
    img_mask = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, h, w, :] = cnt
            cnt += 1
    m = img_mask.reshape(1, H // ws, ws, W // ws, ws, 1)
    return m.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)


class WindowMSA(nn.Module):
    """Parameter holder of the window attention (qkv, proj, bias table)."""

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.num_heads = num_heads
        idx = relative_position_index(window_size).reshape(-1)
        self.register_buffer("_rel_index", torch.from_numpy(idx),
                             persistent=False)

    def rel_bias(self) -> torch.Tensor:
        """(heads, N, N) relative-position bias."""
        N = int(self._rel_index.numel() ** 0.5)
        t = self.relative_position_bias_table[self._rel_index]
        return t.reshape(N, N, self.num_heads).permute(2, 0, 1)


class SwinBlock(nn.Module):
    """One Swin block on the padded layout: K1 (attention half) then K2
    (MLP half). `window_size` is the stage's clamped window; `shift` is the
    roll of a shifted block (0 for W-MSA)."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowMSA(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.mlp_fc2 = nn.Linear(dim * mlp_ratio, dim)
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift = shift

    def forward(self, x, hw, region_ids):
        """x: padded (B, Hp, Wp, C); hw: the real (H, W); region_ids:
        (nW, N) shift-region table of a shifted block, else None."""
        H, W = hw
        a = self.attn
        y = fused_swin_attn_block(
            x, self.norm1.weight, self.norm1.bias, a.qkv.weight, a.qkv.bias,
            a.proj.weight, a.proj.bias, a.rel_bias(), region_ids, None,
            self.num_heads, self.window_size, H, W, self.shift)
        return fused_swin_mlp(
            y, self.norm2.weight, self.norm2.bias, self.mlp_fc1.weight,
            self.mlp_fc1.bias, self.mlp_fc2.weight, self.mlp_fc2.bias)


class PatchMerging(nn.Module):
    """2x2 unfold (c*4 + kh*2 + kw) + LN + Linear(4C -> 2C, no bias)."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False)

    def forward(self, x):
        """x: (B, H, W, C) -> ((B, H2, W2, out_dim), (H2, W2))."""
        B, H, W, C = x.shape
        pad_b, pad_r = H % 2, W % 2
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        H2, W2 = (H + pad_b) // 2, (W + pad_r) // 2
        x = x.reshape(B, H2, 2, W2, 2, C).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(B, H2, W2, C * 4)
        return self.reduction(self.norm(x)), (H2, W2)


class SwinTransformer(nn.Module):
    """Swin backbone: (B, H, W, 3) -> features of out_indices, prefixed by
    the stage-0 stereo feature when return_stereo_feat.

    `input_size` fixes every stage's feature size, hence its clamped
    window (which sizes the relative-position tables) and shifts.
    """

    def __init__(self, input_size: Tuple[int, int], embed_dims: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32),
                 window_size: int = 12, mlp_ratio: int = 4,
                 patch_size: int = 4, out_indices: Sequence[int] = (2, 3),
                 return_stereo_feat: bool = True, patch_norm: bool = True):
        super().__init__()
        self.depths = tuple(depths)
        self.out_indices = tuple(out_indices)
        self.return_stereo_feat = return_stereo_feat
        self.patch_embed = nn.Conv2d(3, embed_dims, patch_size,
                                     stride=patch_size)
        self.patch_norm = (nn.LayerNorm(embed_dims, eps=1e-5) if patch_norm
                           else None)
        dim = embed_dims
        Hs, Ws = input_size[0] // patch_size, input_size[1] // patch_size
        self.stage_hw = []
        for i, depth in enumerate(self.depths):
            self.stage_hw.append((Hs, Ws))
            ws = min(window_size, Hs, Ws)
            for j in range(depth):
                shift = ws // 2 if (j % 2 == 1 and ws < min(Hs, Ws)) else 0
                setattr(self, f"stage{i}_block{j}",
                        SwinBlock(dim, num_heads[i], ws, shift, mlp_ratio))
            if i < len(self.depths) - 1:
                setattr(self, f"downsample{i}", PatchMerging(dim, dim * 2))
            if i in self.out_indices:
                setattr(self, f"out_norm{i}", nn.LayerNorm(dim, eps=1e-5))
            if i < len(self.depths) - 1:
                dim *= 2
                Hs, Ws = (Hs + 1) // 2, (Ws + 1) // 2
        self._region_cache = {}

    def _region_ids(self, Hp, Wp, ws, shift, device):
        key = (Hp, Wp, ws, shift, str(device))
        if key not in self._region_cache:
            ids = shifted_window_region_ids(Hp, Wp, ws, shift)
            self._region_cache[key] = torch.from_numpy(
                ids.astype(np.int32)).to(device)
        return self._region_cache[key]

    def forward(self, x, stage0_only: bool = False) -> Tuple[torch.Tensor, ...]:
        x = self.patch_embed(x.movedim(-1, 1)).movedim(1, -1)
        if self.patch_norm is not None:
            x = self.patch_norm(x)
        outs = []
        for i, depth in enumerate(self.depths):
            Hs, Ws = x.shape[1:3]
            if (Hs, Ws) != self.stage_hw[i]:
                raise ValueError(f"stage {i}: feature {(Hs, Ws)}, built for "
                                 f"{self.stage_hw[i]}")
            ws = getattr(self, f"stage{i}_block0").window_size
            pad_b = (ws - Hs % ws) % ws
            pad_r = (ws - Ws % ws) % ws
            xs = F.pad(x, (0, 0, 0, pad_r, 0, pad_b)).contiguous()
            Hp, Wp = Hs + pad_b, Ws + pad_r
            for j in range(depth):
                blk = getattr(self, f"stage{i}_block{j}")
                region = (self._region_ids(Hp, Wp, ws, blk.shift, x.device)
                          if blk.shift else None)
                xs = blk(xs, (Hs, Ws), region)
            out = xs[:, :Hs, :Ws]
            x = out
            if i < len(self.depths) - 1:
                x, _ = getattr(self, f"downsample{i}")(out)
            if i == 0 and (self.return_stereo_feat or stage0_only):
                outs.append(out)
                if stage0_only:
                    return tuple(outs)
            if i in self.out_indices:
                outs.append(getattr(self, f"out_norm{i}")(out))
        return tuple(outs)
