"""BEVDet / BEVStereo torch checkpoint -> the port's parameters.

A copy of the numpy-only key maps of `preworld_tpu/utils/torch_port.py`
(`swin_key_map`, `full_model_key_map`, `convert_full_model`,
`convert_conv_bn_sequences`, `merge_trees`, `verify_tree_shapes`): a
reference mmcv state dict becomes flax-layout trees
(params, batch_stats) of numpy arrays, the format
`tools/convert_torch_checkpoint.py` pickles. `overlay_flax_params` puts
such trees onto the port's model through the bridge's rename
(`utils/flax_bridge.py`) without strictness, as mmcv's `load_from` loads
with strict=False: tensors the source lacks keep their init.

Tensor layouts (torch -> flax):
  conv weight   (O, I, *k)  -> (*k, I, O)
  linear weight (O, I)      -> (I, O)
  BN weight/bias/running_*  -> scale/bias + batch_stats mean/var
  LN weight/bias            -> scale/bias

Swin block naming: mmcv `stages.{i}.blocks.{j}` -> `stage{i}_block{j}`,
`attn.w_msa.qkv` -> `attn/qkv`, `ffn.layers.0.0` -> `mlp_fc1`,
`ffn.layers.1` -> `mlp_fc2`, `stages.{i}.downsample` -> `downsample{i}`,
output norms `norm{i}` -> `out_norm{i}`.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from .flax_bridge import flax_to_torch_state


def _conv_w(w: np.ndarray) -> np.ndarray:
    # (O, I, *k) -> (*k, I, O)
    nd = w.ndim
    return np.transpose(w, tuple(range(2, nd)) + (1, 0))


def _lin_w(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def swin_key_map(torch_key: str) -> Tuple[Tuple[str, ...], str]:
    """Map one mmcv Swin state_dict key to (flax path, kind).

    kind in {conv, linear, raw, norm_scale, norm_bias,
             bn_mean, bn_var, skip}."""
    k = torch_key
    if k.startswith("patch_embed.projection."):
        leaf = k.rsplit(".", 1)[1]
        if leaf == "weight":
            return ("patch_embed", "kernel"), "conv"
        return ("patch_embed", "bias"), "raw"
    if k.startswith("patch_embed.norm."):
        leaf = k.rsplit(".", 1)[1]
        return ("patch_norm", {"weight": "scale", "bias": "bias"}[leaf]), "raw"
    m = re.match(r"norm(\d)\.(weight|bias)$", k)
    if m:
        i, leaf = m.groups()
        return (
            f"out_norm{i}", {"weight": "scale", "bias": "bias"}[leaf]
        ), "raw"
    m = re.match(r"stages\.(\d+)\.downsample\.(norm|reduction)\.(.+)$", k)
    if m:
        i, sub, leaf = m.groups()
        if sub == "norm":
            return (
                f"downsample{i}", "norm",
                {"weight": "scale", "bias": "bias"}[leaf],
            ), "raw"
        return (f"downsample{i}", "reduction", "kernel"), "linear"
    m = re.match(r"stages\.(\d+)\.blocks\.(\d+)\.(.+)$", k)
    if not m:
        return (), "skip"
    i, j, rest = m.groups()
    base = f"stage{i}_block{j}"
    ln = {"weight": "scale", "bias": "bias"}
    if rest.startswith("norm1."):
        return (base, "norm1", ln[rest.split(".")[-1]]), "raw"
    if rest.startswith("norm2."):
        return (base, "norm2", ln[rest.split(".")[-1]]), "raw"
    if rest == "attn.w_msa.relative_position_bias_table":
        return (base, "attn", "relative_position_bias_table"), "raw"
    if rest == "attn.w_msa.relative_position_index":
        return (), "skip"  # recomputed statically
    if rest.startswith("attn.w_msa.qkv."):
        leaf = rest.rsplit(".", 1)[1]
        if leaf == "weight":
            return (base, "attn", "qkv", "kernel"), "linear"
        return (base, "attn", "qkv", "bias"), "raw"
    if rest.startswith("attn.w_msa.proj."):
        leaf = rest.rsplit(".", 1)[1]
        if leaf == "weight":
            return (base, "attn", "proj", "kernel"), "linear"
        return (base, "attn", "proj", "bias"), "raw"
    if rest.startswith("ffn.layers.0.0."):
        leaf = rest.rsplit(".", 1)[1]
        if leaf == "weight":
            return (base, "mlp_fc1", "kernel"), "linear"
        return (base, "mlp_fc1", "bias"), "raw"
    if rest.startswith("ffn.layers.1."):
        leaf = rest.rsplit(".", 1)[1]
        if leaf == "weight":
            return (base, "mlp_fc2", "kernel"), "linear"
        return (base, "mlp_fc2", "bias"), "raw"
    return (), "skip"


def convert_swin(state_dict: Dict[str, np.ndarray], prefix: str = "img_backbone."):
    """-> (params subtree, batch_stats subtree) for models.swin.SwinTransformer."""
    params: Dict = {}
    for k, v in state_dict.items():
        if not k.startswith(prefix):
            continue
        path, kind = swin_key_map(k[len(prefix):])
        if kind == "skip" or not path:
            continue
        arr = np.asarray(v)
        if kind == "conv":
            arr = _conv_w(arr)
        elif kind == "linear":
            arr = _lin_w(arr)
        _set(params, path, arr)
    return params, {}


def _set(tree: Dict, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def convert_conv_bn_sequences(
    state_dict: Dict[str, np.ndarray],
    key_map: Dict[str, Tuple[str, ...]],
):
    """Generic converter: torch `conv.weight`/`bn.weight`... keys to flax
    params + batch_stats given an explicit name map.

    key_map: torch prefix -> flax path prefix. For each torch prefix P the
    following leaves are translated when present:
       P.weight (conv->kernel), P.bias, P.running_mean/var (batch_stats).
    """
    params: Dict = {}
    stats: Dict = {}
    for tprefix, fpath in key_map.items():
        w = state_dict.get(tprefix + ".weight")
        b = state_dict.get(tprefix + ".bias")
        rm = state_dict.get(tprefix + ".running_mean")
        rv = state_dict.get(tprefix + ".running_var")
        if w is None and b is None:
            continue
        if rm is not None:  # norm layer
            if w is not None:
                _set(params, fpath + ("scale",), np.asarray(w))
            if b is not None:
                _set(params, fpath + ("bias",), np.asarray(b))
            _set(stats, fpath + ("mean",), np.asarray(rm))
            _set(stats, fpath + ("var",), np.asarray(rv))
        else:
            w = np.asarray(w)
            if w.ndim >= 3:
                _set(params, fpath + ("kernel",), _conv_w(w))
            elif w.ndim == 2:
                _set(params, fpath + ("kernel",), _lin_w(w))
            else:  # norm without running stats (LN/GN)
                _set(params, fpath + ("scale",), w)
            if b is not None:
                _set(params, fpath + ("bias",), np.asarray(b))
    return params, stats


def _cna(flax_prefix: Tuple[str, ...], torch_conv: str, torch_bn: str = None):
    """Key-map entries for a ConvNormAct (Conv_0 + BatchNorm_0)."""
    out = {torch_conv: (flax_prefix + ("Conv_0",), "conv")}
    if torch_bn:
        out[torch_bn] = (flax_prefix + ("BatchNorm_0",), "bn")
    return out


def _basic_block(flax_prefix, torch_prefix, norm="bn", has_down=False,
                 down_has_bn=True, mm3d=False):
    """mmdet BasicBlock (conv1/bn1/conv2/bn2[/downsample]) or the reference's
    BasicBlock3D (conv1.conv/conv1.bn/...)."""
    out = {}
    if mm3d:
        out.update(_cna(flax_prefix + ("conv1",), f"{torch_prefix}.conv1.conv",
                        f"{torch_prefix}.conv1.bn"))
        out.update(_cna(flax_prefix + ("conv2",), f"{torch_prefix}.conv2.conv",
                        f"{torch_prefix}.conv2.bn"))
        if has_down:
            out.update(_cna(flax_prefix + ("downsample",),
                            f"{torch_prefix}.downsample.conv",
                            f"{torch_prefix}.downsample.bn"))
    else:
        out.update(_cna(flax_prefix + ("conv1",), f"{torch_prefix}.conv1",
                        f"{torch_prefix}.bn1"))
        out.update(_cna(flax_prefix + ("conv2",), f"{torch_prefix}.conv2",
                        f"{torch_prefix}.bn2"))
        if has_down:
            if down_has_bn:
                out.update(_cna(flax_prefix + ("downsample",),
                                f"{torch_prefix}.downsample.0",
                                f"{torch_prefix}.downsample.1"))
            else:
                out[f"{torch_prefix}.downsample"] = (
                    flax_prefix + ("downsample", "Conv_0"), "conv"
                )
    return out


def _custom_resnet3d(flax_prefix, torch_prefix, num_layer):
    out = {}
    for i, n in enumerate(num_layer):
        for j in range(n):
            out.update(
                _basic_block(
                    flax_prefix + (f"layer{i}_block{j}",),
                    f"{torch_prefix}.layers.{i}.{j}",
                    has_down=(j == 0),
                    mm3d=True,
                )
            )
    return out


def full_model_key_map(num_bev_layers=(1, 2, 4)) -> Dict[str, Tuple]:
    """torch-prefix -> (flax path, kind) for everything the BEVDet stbase
    checkpoint shares with `PreWorld` (backbone handled by convert_swin).

    kinds: conv | linear | dense1x1 (torch 1x1 conv -> flax Dense) | bn | ln
    """
    m: Dict[str, Tuple] = {}

    # FPN_LSS neck (`lss_fpn.py:43-62`: Sequential[Conv,BN,ReLU,Conv,BN,ReLU])
    m.update(_cna(("img_neck", "conv0"), "img_neck.conv.0", "img_neck.conv.1"))
    m.update(_cna(("img_neck", "conv1"), "img_neck.conv.3", "img_neck.conv.4"))

    dn = "img_view_transformer.depth_net"
    f = ("view_transformer", "depth_net")
    m.update(_cna(f + ("reduce_conv",), f"{dn}.reduce_conv.0",
                  f"{dn}.reduce_conv.1"))
    m[f"{dn}.bn"] = (f + ("mlp_bn",), "bn")
    for mlp in ("depth_mlp", "context_mlp"):
        m[f"{dn}.{mlp}.fc1"] = (f + (mlp, "Dense_0"), "linear")
        m[f"{dn}.{mlp}.fc2"] = (f + (mlp, "Dense_1"), "linear")
    for se in ("depth_se", "context_se"):
        m[f"{dn}.{se}.conv_reduce"] = (f + (se, "Dense_0"), "dense1x1")
        m[f"{dn}.{se}.conv_expand"] = (f + (se, "Dense_1"), "dense1x1")
    m[f"{dn}.context_conv"] = (f + ("context_conv",), "conv")
    for i in range(2):
        m.update(_cna(
            f + (f"cost_volumn_net{i}",),
            f"{dn}.cost_volumn_net.{2 * i}", f"{dn}.cost_volumn_net.{2 * i + 1}",
        ))
    for i in range(3):
        m.update(_basic_block(
            f + (f"depth_block{i}",), f"{dn}.depth_conv.{i}",
            has_down=(i == 0), down_has_bn=False,
        ))
    for i in range(1, 5):
        m.update(_cna(
            f + ("aspp", f"aspp{i}"),
            f"{dn}.depth_conv.3.aspp{i}.atrous_conv",
            f"{dn}.depth_conv.3.aspp{i}.bn",
        ))
    m.update(_cna(f + ("aspp", "global_branch"),
                  f"{dn}.depth_conv.3.global_avg_pool.1",
                  f"{dn}.depth_conv.3.global_avg_pool.2"))
    m.update(_cna(f + ("aspp", "proj"), f"{dn}.depth_conv.3.conv1",
                  f"{dn}.depth_conv.3.bn1"))
    m[f"{dn}.depth_conv.4"] = (f + ("depth_pred",), "conv")

    # BEV voxel encoder + neck + pre-process
    m.update(_custom_resnet3d(("bev_backbone",), "img_bev_encoder_backbone",
                              num_bev_layers))
    m.update(_cna(("bev_neck", "fuse"), "img_bev_encoder_neck.conv.conv",
                  "img_bev_encoder_neck.conv.bn"))
    m.update(_custom_resnet3d(("pre_process",), "pre_process", (1,)))
    return m


def convert_full_model(state_dict: Dict[str, np.ndarray],
                       num_bev_layers=(1, 2, 4)):
    """Port every shared module of a BEVDet/BEVStereo torch checkpoint.

    Returns (params overlay, batch_stats overlay); merge onto a fresh init
    with `merge_trees` (heads keep their init — mmcv strict=False parity).
    """
    params, stats = convert_swin(state_dict, prefix="img_backbone.")
    params = {"img_backbone": params}
    stats = {}
    kmap = full_model_key_map(num_bev_layers)
    for tprefix, (fpath, kind) in kmap.items():
        w = state_dict.get(tprefix + ".weight")
        b = state_dict.get(tprefix + ".bias")
        if w is None and b is None:
            continue
        if kind == "bn":
            _set(params, fpath + ("scale",), np.asarray(w))
            _set(params, fpath + ("bias",), np.asarray(b))
            rm = state_dict.get(tprefix + ".running_mean")
            rv = state_dict.get(tprefix + ".running_var")
            if rm is not None:
                _set(stats, fpath + ("mean",), np.asarray(rm))
                _set(stats, fpath + ("var",), np.asarray(rv))
        elif kind == "conv":
            _set(params, fpath + ("kernel",), _conv_w(np.asarray(w)))
            if b is not None:
                _set(params, fpath + ("bias",), np.asarray(b))
        elif kind == "dense1x1":
            w2 = np.asarray(w)
            w2 = w2.reshape(w2.shape[0], w2.shape[1])  # (O, I, 1, 1) -> (O, I)
            _set(params, fpath + ("kernel",), _lin_w(w2))
            if b is not None:
                _set(params, fpath + ("bias",), np.asarray(b))
        elif kind == "linear":
            _set(params, fpath + ("kernel",), _lin_w(np.asarray(w)))
            if b is not None:
                _set(params, fpath + ("bias",), np.asarray(b))
        elif kind == "ln":
            _set(params, fpath + ("scale",), np.asarray(w))
            _set(params, fpath + ("bias",), np.asarray(b))
    return params, stats


def merge_trees(dst: Dict, src: Dict) -> Dict:
    """Recursively overlay src onto dst (dst copied)."""
    out = dict(dst)
    for k, v in src.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_trees(out[k], v)
        else:
            out[k] = v
    return out


def verify_tree_shapes(template: Dict, ported: Dict, path=()) -> list:
    """Return a list of (path, template_shape, ported_shape) mismatches for
    every leaf of `ported` present in `template`."""
    bad = []
    for k, v in ported.items():
        if k not in template:
            bad.append((path + (k,), None, getattr(v, "shape", None)))
            continue
        t = template[k]
        if isinstance(v, dict):
            bad += verify_tree_shapes(t, v, path + (k,))
        else:
            if tuple(t.shape) != tuple(np.shape(v)):
                bad.append((path + (k,), tuple(t.shape), tuple(np.shape(v))))
    return bad


def overlay_flax_params(model: torch.nn.Module, params: Mapping,
                        batch_stats: Mapping = None) -> Tuple[List[str],
                                                             List[str]]:
    """Copy the leaves of flax-layout trees (e.g. `convert_full_model`'s)
    onto `model` where the model has a tensor of that name; every other
    model tensor keeps its value. Raises on a shape mismatch. Returns
    (names loaded, source names with no port tensor)."""
    state = model.state_dict()
    flat = flax_to_torch_state(params, batch_stats)
    unexpected = sorted(k for k in flat if k not in state)
    loaded = sorted(k for k in flat if k in state)
    bad = [(k, flat[k].shape, tuple(state[k].shape)) for k in loaded
           if tuple(flat[k].shape) != tuple(state[k].shape)]
    if bad:
        raise ValueError(f"shape mismatches: {bad[:10]}")
    with torch.no_grad():
        for k in loaded:
            state[k].copy_(torch.from_numpy(flat[k]))
    return loaded, unexpected
