"""Run two or more source trees of this repository in turns on one card.

    python3 -m preworld_tpu_torch.tools.tree_turns TREE [TREE ...]

Each TREE is the root of a checkout of this repository (for example an
unpacked `git archive` of another commit). Each runs in its own process
from its root, in the order given (A B B A cancels drift between the
first and the last runs), so each tree builds and runs its own code:
  * kernels: the tree's `chip_smoke.check_swin`,
    `chip_smoke.check_swin_bwd`, `chip_smoke.check_window_attn`,
    `chip_smoke.check_cost_volume` and `chip_smoke.check_bev_pool`: the
    Swin kernels (K1, K2, their backward chains K1b, K2b, and K5, K6), K3
    and K4 at the flagship shapes; per kernel (launch-counter key) the
    kernel ms summed over those shapes and, where the check times one, the
    summed `F.scaled_dot_product_attention` yardstick; for K4 the whole
    wrapper's ms and, where the tree times them apart, its kernels';
  * forward bits: K1 (W-MSA and SW-MSA) and K2 at every Swin-B stage on
    inputs drawn from a fixed seed, each output's SHA-256, so that turns
    show whether two trees' forward kernels give the same bits;
  * render: `nerf_head_losses` of 38400 rays on a 200x200x16 field (the
    per-stage bench's render, its density raised by 9 so that opacities
    are ~5e-3), forward and gradient in the three fields: the losses, the
    peak device bytes above the inputs, and the gradients' rel-L2 and
    cosine against the first tree's (through a file in a temporary
    directory);
  * end to end: the tree's `chip_smoke.run_flagship` (requests 2-3 of
    the flagship predict, ms, and the profiled request's device-busy ms)
    and `chip_smoke.run_train_flagship` for the finetune and the pretrain
    config (steps 2-3, ms, the peak bytes, the profiled step's device-busy
    ms), each profile's K3, K4 and sort lines and the request's 12 largest
    kernel lines, so that host time shows beside the kernels'.
First line: the card's name and power limit; then one JSON line per turn.
A card is required.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import torch

_RUN = r"""
import hashlib, json, sys
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from preworld_tpu_torch.models.nerf_head import NerfHeadConfig, nerf_head_losses

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
rows = dict(cs.check_swin(gen))
rows.update(cs.check_swin_bwd(gen))
torch.cuda.empty_cache()
rows.update(cs.check_window_attn(gen))
torch.cuda.empty_cache()
from preworld_tpu_torch.models import PreWorldConfig
rows["plane_sweep_cost_hom"] = cs.check_cost_volume(gen, PreWorldConfig())
torch.cuda.empty_cache()
rows["bev_pool_fused"] = [cs.check_bev_pool(gen, PreWorldConfig())]
kernels = {}
for name, rs in rows.items():
    rs = [r for r in rs if not r.get("extra")]
    kernels[name] = {"ms": sum(r["ms"] for r in rs)}
    if all("library_ms" in r for r in rs):
        kernels[name]["library_ms"] = sum(r["library_ms"] for r in rs)
# K4: the whole wrapper's CUDA-event ms (a tree that times only the wrapper
# reports it as its ms)
k4 = rows["bev_pool_fused"][0]
kernels["bev_pool_fused"] = {"wrapper_ms": k4.get("wrapper_ms", k4["ms"]),
                             "kernels_ms": k4["ms"] if "wrapper_ms" in k4
                             else None}

from preworld_tpu_torch.models.swin import shifted_window_region_ids
from preworld_tpu_torch.ops import swin_block_pallas as k1
from preworld_tpu_torch.ops import swin_mlp_pallas as k2

fwd_bits, bf = {}, torch.bfloat16
g = torch.Generator(device="cuda").manual_seed(11)
for C, heads, Hp, Wp, H, W in cs.SWIN_STAGES:
    x = cs.randn(g, (6, Hp, Wp, C), 1.0, bf)
    lw, lb = 1 + cs.randn(g, (C,), 0.1), cs.randn(g, (C,), 0.1)
    w = [cs.randn(g, s, s[1] ** -0.5, bf) for s in
         ((3 * C, C), (C, C), (4 * C, C), (C, 4 * C))]
    b = [cs.randn(g, (s[0],), 0.1) for s in ((3 * C,), (C,), (4 * C,), (C,))]
    rb = cs.window_bias(g, 12, heads)
    reg = torch.from_numpy(shifted_window_region_ids(Hp, Wp, 12, 6).astype(
        "int32")).cuda()
    outs = {f"K1 C{C} shift{sh}": k1.fused_swin_attn_block(
        x, lw, lb, w[0], b[0], w[1], b[1], rb, r, None, heads, 12, H, W, sh)
        for sh, r in ((0, None), (6, reg))}
    outs[f"K2 C{C}"] = k2.fused_swin_mlp(x, lw, lb, w[2], b[2], w[3], b[3])
    for k, o in outs.items():
        fwd_bits[k] = hashlib.sha256(o.view(torch.int16).cpu().numpy()
                                     .tobytes()).hexdigest()[:16]
    del x, outs
torch.cuda.empty_cache()

rng = np.random.default_rng(0)
R, X, Y, Z = 38400, 200, 200, 16
fields = [rng.normal(size=(1, X, Y, Z)) + 9.0,
          rng.normal(size=(1, X, Y, Z, 17)), rng.normal(size=(1, X, Y, Z, 3))]
rays = np.zeros((1, R, 16), np.float32)
rays[..., 2] = rng.uniform(1, 40, (1, R))
rays[..., 3] = rng.integers(0, 17, (1, R))
rays[..., 4:7] = rng.uniform(-2, 2, (1, R, 3))
rays[..., 7:10] = rng.normal(size=(1, R, 3))
rays[..., 13:16] = rng.uniform(0, 1, (1, R, 3))
ins = [torch.from_numpy(a.astype(np.float32)).cuda().requires_grad_(True)
       for a in fields]
rays = torch.from_numpy(rays).cuda()
bda = torch.eye(3, device="cuda")[None]
torch.cuda.synchronize()
base = torch.cuda.memory_allocated()
torch.cuda.reset_peak_memory_stats()
losses = nerf_head_losses(*ins, rays, bda, NerfHeadConfig())
grads = torch.autograd.grad(sum(losses.values()), ins)
torch.cuda.synchronize()
peak = torch.cuda.max_memory_allocated() - base
torch.save([g.cpu() for g in grads], sys.argv[1])
losses_f = {k: float(v) for k, v in losses.items()}
del ins, grads, losses
torch.cuda.empty_cache()
request = cs.run_flagship()
torch.cuda.empty_cache()
step = cs.run_train_flagship()
torch.cuda.empty_cache()
pre = cs.run_train_flagship("configs/preworld/preworld_7frame_pretrain.py",
                            cs.PRETRAIN_ZERO_GRAD_PREFIXES, 38400,
                            cs.PRETRAIN_LOSSES, "pretrain-flagship")


def lines(run, words=("plane_sweep", "bev_pool", "RadixSort")):
    return {k["name"][:60]: [k["ms"], k["count"]]
            for k in run["profile"]["top_kernels"]
            if any(w in k["name"] for w in words)}


print(json.dumps({"kernels": kernels, "forward_sha256": fwd_bits, "render": {
    "losses": losses_f,
    "peak_bytes_above_inputs": peak},
    "flagship": {"request_ms": request["latency_ms"][1:],
                 "busy_ms": request["profile"]["device_busy_ms"],
                 "lines": lines(request),
                 "top": [[k["name"][:60], k["ms"], k["count"]]
                         for k in request["profile"]["top_kernels"][:12]]},
    "finetune": {"step_ms": step["step_ms"][1:],
                 "peak_bytes": step["peak_bytes"],
                 "busy_ms": step["profile"]["device_busy_ms"],
                 "lines": lines(step)},
    "pretrain": {"step_ms": pre["step_ms"][1:],
                 "busy_ms": pre["profile"]["device_busy_ms"],
                 "lines": lines(pre)}}))
"""


def main(argv=None) -> int:
    trees = sys.argv[1:] if argv is None else argv
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("tree_turns: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        first = first_bits = None
        for i, tree in enumerate(trees):
            path = os.path.join(tmp, f"grads{i}.pt")
            proc = subprocess.run([sys.executable, "-c", _RUN, path],
                                  cwd=tree, capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout[-4000:] + proc.stderr[-4000:],
                      file=sys.stderr)
                return 1
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            bits = res.pop("forward_sha256")
            first_bits = first_bits or bits
            res["forward_bits_as_first"] = bits == first_bits
            grads = torch.load(path)
            first = first or grads
            res["render"]["grads_vs_first"] = [
                {"rel_l2": float((g - f).norm() / f.norm()),
                 "cosine": float(torch.nn.functional.cosine_similarity(
                     g.reshape(-1).double(), f.reshape(-1).double(), dim=0))}
                for g, f in zip(grads, first)]
            print(json.dumps({"turn": i, "tree": tree, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
