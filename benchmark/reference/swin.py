"""Swin Transformer in plain PyTorch, float32, the published per-block form.

Each block: LN1, zero padding to whole windows, the cyclic shift of a
shifted block, window attention with the relative-position bias and the
shift-region mask (-100 across regions), the reverse shift, the slice back,
the residual; then LN2, Linear-GELU(erf)-Linear, the residual. The window
is clamped to the stage's feature map and a window that covers the map is
not shifted. Stochastic depth scales each kept branch per image by
1 / keep, from masks drawn by `draw_drop_scales` in the measured program's
order of draws. PatchMerging unfolds 2x2 in the order c*4 + kh*2 + kw.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, Linear


def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_mask(Hp: int, Wp: int, ws: int, shift: int) -> torch.Tensor:
    """(nW, N, N) additive mask of a shifted block: 0 within a region,
    -100 across."""
    img = np.zeros((Hp, Wp), np.float32)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[h, w] = cnt
            cnt += 1
    ids = img.reshape(Hp // ws, ws, Wp // ws, ws).transpose(0, 2, 1, 3)
    ids = torch.from_numpy(ids.reshape(-1, ws * ws).copy())
    return torch.where(ids[:, None, :] != ids[:, :, None],
                       torch.tensor(-100.0), torch.tensor(0.0))


def window_partition(x, ws):
    B, H, W, K = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, K).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, K)


def window_reverse(w, ws, H, W):
    K = w.shape[-1]
    B = w.shape[0] // ((H // ws) * (W // ws))
    x = w.reshape(B, H // ws, W // ws, ws, ws, K).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, K)


class WindowMSA(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.num_heads = num_heads
        self.window_size = window_size
        self.register_buffer("_rel_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1)),
            persistent=False)

    def forward(self, x, mask):
        """x (nW_total, N, C) windows, mask (nW, N, N) or None."""
        Bn, N, C = x.shape
        h = self.num_heads
        d = C // h
        qkv = self.qkv(x)
        q, k, v = qkv.reshape(Bn, N, 3, h, d).permute(2, 0, 3, 1, 4)
        s = (q * d ** -0.5) @ k.transpose(-1, -2)
        bias = self.relative_position_bias_table[self._rel_index]
        s = s + bias.reshape(N, N, h).permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            s = s.reshape(Bn // nW, nW, h, N, N) + mask[None, :, None]
            s = s.reshape(Bn, h, N, N)
        o = torch.softmax(s, dim=-1) @ v
        return self.proj(o.permute(0, 2, 1, 3).reshape(Bn, N, C))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowMSA(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = Linear(dim, dim * mlp_ratio)
        self.mlp_fc2 = Linear(dim * mlp_ratio, dim)
        self.window_size = window_size
        self.shift = shift

    def forward(self, x, drop=None):
        B, H, W, C = x.shape
        ws, shift = self.window_size, self.shift
        y = F.pad(self.norm1(x), (0, 0, 0, (-W) % ws, 0, (-H) % ws))
        Hp, Wp = y.shape[1:3]
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = shift_mask(Hp, Wp, ws, shift).to(x.device)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, Hp,
                           Wp)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + _scale(y[:, :H, :W], None if drop is None else drop[0])
        m = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + _scale(m, None if drop is None else drop[1])


def _scale(y, rs):
    if rs is None:
        return y
    return y * rs.to(y.device, y.dtype).reshape((-1,) + (1,) * (y.dim() - 1))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Linear(4 * dim, out_dim, bias=False)

    def forward(self, x):
        B, H, W, C = x.shape
        pb, pr = H % 2, W % 2
        if pb or pr:
            x = F.pad(x, (0, 0, 0, pr, 0, pb))
        H2, W2 = (H + pb) // 2, (W + pr) // 2
        x = x.reshape(B, H2, 2, W2, 2, C).permute(0, 1, 3, 5, 2, 4)
        return self.reduction(self.norm(x.reshape(B, H2, W2, C * 4)))


class SwinTransformer(nn.Module):
    """(B, H, W, 3) -> (stage-0 feature, normed stage 2, normed stage 3)."""

    def __init__(self, input_size: Tuple[int, int], embed_dims: int,
                 depths: Sequence[int], num_heads: Sequence[int],
                 window_size: int, drop_path_rate: float = 0.1,
                 out_indices: Sequence[int] = (2, 3)):
        super().__init__()
        self.depths = tuple(depths)
        self.drop_path_rate = drop_path_rate
        self.out_indices = tuple(out_indices)
        self.patch_embed = Conv2d(3, embed_dims, 4, stride=4)
        self.patch_norm = nn.LayerNorm(embed_dims, eps=1e-5)
        dim = embed_dims
        Hs, Ws = input_size[0] // 4, input_size[1] // 4
        for i, depth in enumerate(self.depths):
            ws = min(window_size, Hs, Ws)
            for j in range(depth):
                shift = ws // 2 if (j % 2 == 1 and ws < min(Hs, Ws)) else 0
                setattr(self, f"stage{i}_block{j}",
                        SwinBlock(dim, num_heads[i], ws, shift))
            if i < len(self.depths) - 1:
                setattr(self, f"downsample{i}", PatchMerging(dim, dim * 2))
            if i in self.out_indices:
                setattr(self, f"out_norm{i}", nn.LayerNorm(dim, eps=1e-5))
            if i < len(self.depths) - 1:
                dim *= 2
                Hs, Ws = (Hs + 1) // 2, (Ws + 1) // 2

    def draw_drop_scales(self, batch: int, generator: torch.Generator,
                         stage0_only: bool = False):
        """Per block (attention, MLP) scales (batch,) drawn on the host, one
        block after another, attention first; None at rate 0."""
        rates = np.linspace(0, self.drop_path_rate, sum(self.depths))
        if stage0_only:
            rates = rates[:self.depths[0]]
        out = []
        for rate in rates:
            if rate == 0.0:
                out.append(None)
                continue
            keep = 1.0 - float(rate)
            out.append(tuple((torch.rand(batch, generator=generator) < keep)
                             .float() / keep for _ in range(2)))
        return out

    def forward(self, x, stage0_only: bool = False, drops=None):
        x = self.patch_norm(self.patch_embed(x.movedim(-1, 1)).movedim(1, -1))
        outs = []
        k = 0
        for i, depth in enumerate(self.depths):
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(
                    x, None if drops is None else drops[k])
                k += 1
            out = x
            if i < len(self.depths) - 1:
                x = getattr(self, f"downsample{i}")(out)
            if i == 0:
                outs.append(out)
                if stage0_only:
                    return tuple(outs)
            if i in self.out_indices:
                outs.append(getattr(self, f"out_norm{i}")(out))
        return tuple(outs)
