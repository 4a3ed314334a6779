"""Swin Transformer backbone (Swin-B "stbase" config and other widths).

Counterpart of `preworld_tpu/models/swin.py`, with the JAX package's TPU
routes chosen per stage by shape (`stage_route`, the gates of the JAX
`SwinTransformer` and `SwinBlock` with every `None` knob read as on):

  block   C % 128 == 0 and N % 16 == 0: the stage runs on the
          stage-persistent padded (B, Hp, Wp, C) layout, padded once per
          stage, each block the two half-block kernels K1
          (`ops/swin_block_pallas.py`) and K2 (`ops/swin_mlp_pallas.py`);
  band    per block, C % 128 == 0 with the block kernel off
          (`use_block_attn=False`): LN1, pad, roll, the qkv Linear on the
          image layout, K6 (`ops/window_attn_pallas.py::band_window_attention`),
          proj, roll back, slice, residual;
  window  per block, C % 128 != 0 and N % 16 == 0: the same around window
          partition / reverse and K5 (`fused_window_attention`);
  plain   per block, N % 16 != 0: the same with the window attention in
          plain torch (K5's plain version; no kernel, as the JAX package
          takes XLA's einsums there).

N is the stage's window area. Per-block stages run the MLP half on K2
when C % 128 == 0, else Linear-GELU-Linear. On CPU tensors every kernel
wrapper runs its plain version; on CUDA tensors a kernel raises on a shape
it is not built for, and nothing is rerouted. The window is clamped to
min(window, H, W) and the shift is 0 when that window covers the whole
feature map, as in the JAX package. PatchMerging uses the unfold channel
order c*4 + kh*2 + kw. Every route has the same parameter tree.

Stochastic depth in training: block k drops its attention and its MLP
branch per image with rate linspace(0, drop_path_rate, depth)[k], the kept
branches scaled by 1 / keep (K1's per-image and K2's per-row `row_scale`,
or a per-image factor on the per-block routes). `draw_drop_scales` draws
the masks from an explicit `torch.Generator` on the host, so a checkpoint
recompute and the CPU and card runs of one step see the same masks. A
train step takes them from `models/mask_plan.py`, which draws the next
step's on a host worker thread from a copy of the generator's state and
uses them only when the caller's generator is in that state: the same
masks from the same stream, drawn while the card runs the step before.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import draw_rows
from ..ops.swin_block_pallas import fused_swin_attn_block, region_mask
from ..ops.swin_mlp_pallas import fused_swin_mlp
from ..ops.window_attn_pallas import (
    band_window_attention_vjp,
    fused_window_attention_plain,
    fused_window_attention_vjp,
    window_partition,
    window_reverse,
)
from .layers import Conv2d, LayerNorm, Linear

ROUTES = ("block", "band", "window", "plain")


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


def shifted_window_mask(H: int, W: int, ws: int, shift: int,
                        device=None) -> torch.Tensor:
    """Attention mask for SW-MSA: (nW, ws*ws, ws*ws) f32 of 0 / -100."""
    ids = torch.from_numpy(shifted_window_region_ids(H, W, ws, shift))
    return region_mask(ids.to(device))


def stage_route(dim: int, n_tokens: int, use_fused_attn=None,
                use_fused_mlp=None, use_band_attn=None, use_block_attn=None
                ) -> Tuple[str, bool]:
    """(attention route, MLP on K2) of a stage of width `dim` whose window
    holds `n_tokens` tokens: the gates of the JAX `SwinTransformer`
    (stage) and `SwinBlock` (block), each knob with the JAX meaning and
    `None` read as on."""
    fused = True if use_fused_attn is None else bool(use_fused_attn)
    block = fused if use_block_attn is None else bool(use_block_attn)
    if block and dim % 128 == 0 and n_tokens % 16 == 0:
        route = "block"
    else:
        fused = fused and n_tokens % 16 == 0
        band = fused if use_band_attn is None else bool(use_band_attn)
        band = band and fused and dim % 128 == 0
        route = "band" if band else "window" if fused else "plain"
    mlp = True if use_fused_mlp is None else bool(use_fused_mlp)
    return route, mlp and dim % 128 == 0


class WindowMSA(nn.Module):
    """Parameter holder of the window attention (qkv, proj, bias table)."""

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)
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
    """One Swin block. `window_size` is the stage's clamped window; `shift`
    the roll of a shifted block (0 for W-MSA); `route` one of ROUTES and
    `fused_mlp` whether the MLP half runs on K2 (`stage_route`)."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: int, mlp_ratio: int = 4, route: str = "block",
                 fused_mlp: bool = True):
        super().__init__()
        if route not in ROUTES:
            raise ValueError(f"route {route!r} is not one of {ROUTES}")
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowMSA(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = Linear(dim, dim * mlp_ratio)
        self.mlp_fc2 = Linear(dim * mlp_ratio, dim)
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift = shift
        self.route = route
        self.fused_mlp = fused_mlp

    def forward(self, x, hw, mask, drop=None):
        """Block route: x padded (B, Hp, Wp, C), hw the real (H, W), mask
        the (nW, N) region-id table of a shifted block. Per-block routes: x
        (B, H, W, C), mask the (nW, N, N) f32 shift mask. mask is None for
        W-MSA; drop: per-image (attention, MLP) branch scales (B,) of
        stochastic depth, or None. The f32 weights go to the kernel
        wrappers as they are."""
        rs1, rs2 = (None, None) if drop is None else drop
        if self.route == "block":
            H, W = hw
            a = self.attn
            y = fused_swin_attn_block(
                x, self.norm1.weight, self.norm1.bias, a.qkv.weight,
                a.qkv.bias, a.proj.weight, a.proj.bias, a.rel_bias(), mask,
                rs1, self.num_heads, self.window_size, H, W, self.shift)
        else:
            y = x + _branch_scale(self._attention(x, mask), rs1)
        return self._mlp(y, rs2)

    def _attention(self, x, mask):
        """Per-block attention branch: LN1 -> zero pad -> roll -> qkv ->
        window attention -> proj -> roll back -> slice."""
        B, H, W, C = x.shape
        ws, shift, heads = self.window_size, self.shift, self.num_heads
        a = self.attn
        y = F.pad(self.norm1(x), (0, 0, 0, (-W) % ws, 0, (-H) % ws))
        Hp, Wp = y.shape[1:3]
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        bias = a.rel_bias()
        if self.route == "band":
            qkv = a.qkv(y)
            y = a.proj(band_window_attention_vjp(qkv, bias, mask, heads, ws))
        else:
            qkv = a.qkv(window_partition(y, ws))
            attend = (fused_window_attention_vjp if self.route == "window"
                      else fused_window_attention_plain)
            y = window_reverse(a.proj(attend(qkv, bias, mask, heads)), ws,
                               Hp, Wp)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        return y[:, :H, :W]

    def _mlp(self, x, rs):
        """LN2 + MLP + residual on (B, ..., C): K2 or Linear-GELU-Linear."""
        if self.fused_mlp:
            if rs is not None:
                per_image = x.numel() // (x.shape[0] * x.shape[-1])
                rs = rs[:, None].expand(-1, per_image).reshape(-1)
            return fused_swin_mlp(
                x.contiguous(), self.norm2.weight, self.norm2.bias,
                self.mlp_fc1.weight, self.mlp_fc1.bias, self.mlp_fc2.weight,
                self.mlp_fc2.bias, rs)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + _branch_scale(y, rs)


def _branch_scale(y, rs):
    """y times the per-image stochastic-depth scale rs (B,), or y."""
    if rs is None:
        return y
    return y * rs.to(y.dtype).reshape((-1,) + (1,) * (y.dim() - 1))


class PatchMerging(nn.Module):
    """2x2 unfold (c*4 + kh*2 + kw) + LN + Linear(4C -> 2C, no bias)."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Linear(4 * dim, out_dim, bias=False)

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
    window (which sizes the relative-position tables), its shifts and its
    route (`stage_route`, from the four JAX knobs; `stage_routes` lists
    them).
    """

    def __init__(self, input_size: Tuple[int, int], embed_dims: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32),
                 window_size: int = 12, mlp_ratio: int = 4,
                 patch_size: int = 4, out_indices: Sequence[int] = (2, 3),
                 drop_path_rate: float = 0.1,
                 return_stereo_feat: bool = True, patch_norm: bool = True,
                 use_fused_attn: Optional[bool] = None,
                 use_fused_mlp: Optional[bool] = None,
                 use_band_attn: Optional[bool] = None,
                 use_block_attn: Optional[bool] = None):
        super().__init__()
        self.depths = tuple(depths)
        self.drop_path_rate = drop_path_rate
        self.out_indices = tuple(out_indices)
        self.return_stereo_feat = return_stereo_feat
        self.patch_embed = Conv2d(3, embed_dims, patch_size,
                                     stride=patch_size)
        self.patch_norm = (LayerNorm(embed_dims, eps=1e-5) if patch_norm
                           else None)
        dim = embed_dims
        Hs, Ws = input_size[0] // patch_size, input_size[1] // patch_size
        self.stage_hw = []
        self.stage_routes = []
        for i, depth in enumerate(self.depths):
            self.stage_hw.append((Hs, Ws))
            ws = min(window_size, Hs, Ws)
            route = stage_route(dim, ws * ws, use_fused_attn, use_fused_mlp,
                                use_band_attn, use_block_attn)
            self.stage_routes.append(route)
            for j in range(depth):
                shift = ws // 2 if (j % 2 == 1 and ws < min(Hs, Ws)) else 0
                setattr(self, f"stage{i}_block{j}",
                        SwinBlock(dim, num_heads[i], ws, shift, mlp_ratio,
                                  *route))
            if i < len(self.depths) - 1:
                setattr(self, f"downsample{i}", PatchMerging(dim, dim * 2))
            if i in self.out_indices:
                setattr(self, f"out_norm{i}", LayerNorm(dim, eps=1e-5))
            if i < len(self.depths) - 1:
                dim *= 2
                Hs, Ws = (Hs + 1) // 2, (Ws + 1) // 2
        self._mask_cache = {}

    def _shift_mask(self, kind, Hp, Wp, ws, shift, device):
        """The region-id table (block route) or the (nW, N, N) f32 mask
        (per-block routes) of a shifted block, built once per device."""
        key = (kind, Hp, Wp, ws, shift, str(device))
        if key not in self._mask_cache:
            if kind == "block":
                ids = shifted_window_region_ids(Hp, Wp, ws, shift)
                m = torch.from_numpy(ids.astype(np.int32)).to(device)
            else:
                m = shifted_window_mask(Hp, Wp, ws, shift, device)
            self._mask_cache[key] = m
        return self._mask_cache[key]

    def draw_drop_scales(self, batch: int, generator: torch.Generator,
                         stage0_only: bool = False,
                         rows: Optional[Tuple[int, int]] = None):
        """Per-block (attention, MLP) stochastic-depth scales (B,) f32 on
        the host, drawn from `generator` block by block (attention first);
        None for a block whose rate is 0. Under a mesh, this rank's rows of
        the global batch's draws (`parallel.draw_rows`; `rows` its
        (n_data, data_rank) where the caller is not inside the mesh)."""
        rates = np.linspace(0, self.drop_path_rate, sum(self.depths))
        if stage0_only:
            rates = rates[:self.depths[0]]
        out = []
        for rate in rates:
            if rate == 0.0:
                out.append(None)
                continue
            keep = 1.0 - float(rate)
            out.append(tuple(draw_rows(lambda n: (torch.rand(
                n, generator=generator) < keep).float() / keep, batch, rows)
                for _ in range(2)))
        return out

    def forward(self, x, stage0_only: bool = False,
                drop_scales=None) -> Tuple[torch.Tensor, ...]:
        """drop_scales: `draw_drop_scales` output (training), else None."""
        x = self.patch_embed(x.movedim(-1, 1)).movedim(1, -1)
        if self.patch_norm is not None:
            x = self.patch_norm(x)
        outs = []
        for i, depth in enumerate(self.depths):
            Hs, Ws = x.shape[1:3]
            if (Hs, Ws) != self.stage_hw[i]:
                raise ValueError(f"stage {i}: feature {(Hs, Ws)}, built for "
                                 f"{self.stage_hw[i]}")
            block_route = self.stage_routes[i][0] == "block"
            ws = getattr(self, f"stage{i}_block0").window_size
            Hp, Wp = Hs + (-Hs) % ws, Ws + (-Ws) % ws
            # the block route pads once per stage; per-block routes pad
            # (and roll) inside each block
            xs = (F.pad(x, (0, 0, 0, Wp - Ws, 0, Hp - Hs)).contiguous()
                  if block_route else x)
            for j in range(depth):
                blk = getattr(self, f"stage{i}_block{j}")
                mask = (self._shift_mask(blk.route, Hp, Wp, ws, blk.shift,
                                         x.device) if blk.shift else None)
                drop = None
                if drop_scales is not None:
                    drop = drop_scales[sum(self.depths[:i]) + j]
                    if drop is not None:
                        drop = tuple(t.to(x.device, non_blocking=True)
                                     for t in drop)
                xs = blk(xs, (Hs, Ws), mask, drop)
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
