"""Inference-time conv + BatchNorm folding (`--fuse-conv-bn`).

Counterpart of `preworld_tpu/utils/fold_bn.py`, on the port's flat
{name: tensor} dicts. Every `ConvNormAct` whose BatchNorm runs on its
running statistics (`X.Conv_0` + `X.BatchNorm_0`) is rewritten as

    weight' = weight * s,  s = gamma / sqrt(var + eps)  (per out-channel)
    BN      -> gamma' = 1, mean' = 0, var' = 1 - eps,
               beta' = beta - mean * s + s * conv bias   (conv bias' = 0)

which computes the same function in eval mode: the module tree is fixed,
so the BatchNorm stays as an affine no-op carrying the folded bias, as in
the JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

_CONV = "Conv_0.weight"


def fold_conv_bn(params: Mapping[str, torch.Tensor],
                 buffers: Mapping[str, torch.Tensor], eps: float = 1e-5
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(params', buffers') with every `Conv_0` + `BatchNorm_0` pair folded;
    params as `model.named_parameters()` (or an EMA of them), buffers as
    `model.named_buffers()`. Other entries are passed through; the inputs
    are not modified."""
    p, b = dict(params), dict(buffers)
    for name in params:
        prefix = name[: -len(_CONV)]
        bn = prefix + "BatchNorm_0."
        if (name != prefix + _CONV or prefix[-1:] not in ("", ".")
                or bn + "running_mean" not in buffers):
            continue
        gamma, beta = params[bn + "weight"], params[bn + "bias"]
        mean = buffers[bn + "running_mean"]
        var = buffers[bn + "running_var"]
        with torch.no_grad():
            scale = gamma.float() / torch.sqrt(var.float() + eps)
            w = params[name]
            p[name] = (w.float() * scale.view(-1, *[1] * (w.dim() - 1))
                       ).to(w.dtype)
            folded_b = torch.zeros_like(scale)
            conv_bias = prefix + "Conv_0.bias"
            if conv_bias in params:
                folded_b = scale * params[conv_bias].float()
                p[conv_bias] = torch.zeros_like(params[conv_bias])
            p[bn + "weight"] = torch.ones_like(gamma)
            p[bn + "bias"] = (beta.float() - mean.float() * scale
                              + folded_b).to(beta.dtype)
            b[bn + "running_mean"] = torch.zeros_like(mean)
            b[bn + "running_var"] = torch.full_like(var, 1.0 - eps)
    return p, b


def fold_model_conv_bn(model: torch.nn.Module,
                       params: Mapping[str, torch.Tensor] = None,
                       eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Fold `params` (the model's own parameters by default) with the
    model's BatchNorm statistics, write the folded parameters and buffers
    into the model, and return the folded parameters."""
    own = dict(model.named_parameters())
    p, b = fold_conv_bn(own if params is None else params,
                        dict(model.named_buffers()), eps)
    with torch.no_grad():
        for n, t in own.items():
            t.copy_(p[n])
        for n, t in model.named_buffers():
            t.copy_(b[n])
    return {n: p[n] for n in own}
