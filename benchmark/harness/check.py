"""The output check: what the timed path produced against the reference.

The reference model is the class that the configuration file names under
`reference` (`<module>.<class>` of `benchmark/reference/`), built from the
configuration's sizes with the run's weights, in float32 with TF32 off.

Inference entries (`check_infer`): for each sampled frame, the occupancy
logits that the timed path computed and the answer it served, against
the reference's logits from the same host inputs and weights:
  logit_rel_l2     max over frames of ||C(L_prog) - C(L_ref)|| / ||C(L_ref)||,
                   C removing each voxel's mean over the classes (which no
                   class score depends on);
  served_vs_logits max over frames of the share of voxels whose served
                   class is not the best of the logits the timed path
                   computed (exact: the answer is those logits' argmax).
Train entries (`compare_train`): the reference follows the program's
first three steps from the same weights, batches and masks, and the
numbers compare losses, gradients, moments, the parameters' change and
the EMA's change (see there). Each cell's limits file names the numbers
it compares (PERF.md gives why). The reference runs once the window has
closed and the program is freed.
"""

from __future__ import annotations

import importlib
import statistics
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..reference.optim import EMA, AdamW
from .inputs import make_state_dict, seed_of

def reference_class(config: Dict):
    module, name = config["reference"].rsplit(".", 1)
    return getattr(importlib.import_module(
        f"{__package__.rsplit('.', 1)[0]}.reference.{module}"), name)


def reference_meta(config: Dict) -> torch.nn.Module:
    """The reference on the meta device: its parameters' names and shapes,
    from which the run's weights are drawn."""
    with torch.device("meta"):
        return reference_class(config).from_sizes(config["sizes"])


def reference(config: Dict, seed: int, device, precision: str = "f32",
              checkpoint: bool = False) -> torch.nn.Module:
    """The reference with the run's weights. Float32 products stay float32
    from here on: TF32 is switched off, once the program has run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = reference_class(config).from_sizes(
        config["sizes"], checkpoint_backbone=checkpoint).to(device)
    model.load_state_dict(make_state_dict(reference_meta(config), seed,
                                          device))
    model.set_precision(precision)
    return model


def tensors(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def rel_l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    """||C(a) - C(ref)|| / ||C(ref)||, C removing each voxel's mean over
    the classes."""
    a = a.float() - a.float().mean(dim=-1, keepdim=True)
    ref = ref.float() - ref.float().mean(dim=-1, keepdim=True)
    return float(torch.linalg.vector_norm(a - ref)
                 / torch.linalg.vector_norm(ref))


def compare_logits(prog: torch.Tensor, served: torch.Tensor,
                   ref: torch.Tensor) -> Dict[str, float]:
    miss = float((prog.float().argmax(dim=-1) != served.long())
                 .float().mean())
    return {"logit_rel_l2": rel_l2(prog, ref), "served_vs_logits": miss}


def check_infer(ref_logits: Callable, config: Dict, traffic,
                logits: Dict[int, object], served: Dict[int, np.ndarray],
                seed: int, device, precision: str = "f32"
                ) -> Dict[str, float]:
    """Worst numbers over the sampled frames. `logits` maps input index
    to the program's logits (tensors on any device); `ref_logits(ref,
    traffic, k, device)` is the entry's reference for input k."""
    ref = reference(config, seed, device, precision).eval()
    worst = {"logit_rel_l2": 0.0, "served_vs_logits": 0.0}
    for k in sorted(logits):
        with torch.no_grad():
            r = ref_logits(ref, traffic, k, device)
        got = compare_logits(torch.as_tensor(logits[k]).to(device),
                             torch.from_numpy(served[k]).to(device), r)
        worst = {n: max(worst[n], v) for n, v in got.items()}
    if not logits:  # nothing compared is no pass
        worst = {n: float("inf") for n in worst}
    worst["frames_compared"] = float(len(logits))
    return worst


def ref_train(config: Dict, traffic, seed: int, device,
              precision: str = "f32", steps: int = 3,
              rows: Optional[int] = None,
              extra_ema: Optional[int] = None) -> Dict:
    """The reference's first steps, on the host: the losses, the step-1
    clipped gradients, and after the last step the first moments, the
    parameters and their EMA. `rows`: step on the first rows of each batch
    only; `extra_ema`: also `ema_extra`, an EMA whose updates count on
    from there (planted faults)."""
    ref = reference(config, seed, device, precision, checkpoint=True)
    ref.train()
    t = config["train"]
    names = [n for n, _ in ref.named_parameters()]
    params = [p for _, p in ref.named_parameters()]
    opt = AdamW(params, t["lr"], t["weight_decay"], t["clip"],
                t["warmup_iters"])
    emas = [EMA(params, t["ema_decay"], t["ema_init_updates"])]
    if extra_ema is not None:
        emas.append(EMA(params, t["ema_decay"], extra_ema))
    gen = torch.Generator().manual_seed(seed_of(seed, 5))
    losses, parts, g1 = [], [], None
    for k in range(steps):
        for p in params:
            p.grad = None
        batch = traffic.request(k)
        if rows is not None:
            batch = {n: v[:rows] for n, v in batch.items()}
        out = ref.loss(tensors(batch, device), gen)
        total = sum(out[n] for n in sorted(out))
        total.backward()
        losses.append(float(total.detach()))
        parts.append({n: float(v.detach()) for n, v in out.items()})
        grads = opt.step()
        for ema in emas:
            ema.update()
        if k == 0:
            g1 = host(names, grads)
    out = {"losses": losses, "parts": parts, "grads": g1,
           "moments": host(names, opt.mu), "params": host(names, params),
           "ema": host(names, emas[0].avg)}
    if extra_ema is not None:
        out["ema_extra"] = host(names, emas[1].avg)
    return out


def host(names: List[str], tensors_: List[torch.Tensor]
         ) -> Dict[str, torch.Tensor]:
    return {n: t.detach().to("cpu", copy=True)
            for n, t in zip(names, tensors_)}


def leaf_gaps(name: str, prog: Dict[str, float], ref: Dict[str, float]
              ) -> Dict[str, float]:
    """`<name>_worst` and `<name>_median`: the worst and the median leaf of
    | prog - ref | / max(ref, the median leaf's ref), over ref's leaves;
    the worst leaf goes to standard error."""
    med = statistics.median(ref.values())
    gap = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref}
    k = max(gap, key=gap.get)
    print(f"{name} worst leaf {k}: program {prog[k]!r} reference "
          f"{ref[k]!r}", file=sys.stderr)
    return {f"{name}_worst": float(gap[k]),
            f"{name}_median": float(statistics.median(gap.values()))}


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def moving(ref_grads: Dict[str, torch.Tensor]):
    """The leaves whose step-1 reference gradient reaches a thousandth of
    the median leaf's norm, and in each the elements whose gradient
    reaches a thousandth of the median leaf's root mean square: the rest
    is nought but for rounding (a bias before a BatchNorm; a key's bias
    under softmax, a third of a fused qkv bias), and Adam would turn
    rounding into a step of the learning rate."""
    g = {k: norm(v) for k, v in ref_grads.items()}
    med = statistics.median(g.values())
    leaves = [k for k in g if g[k] >= 1e-3 * med]
    rms = statistics.median(g[k] / ref_grads[k].numel() ** 0.5
                            for k in leaves)
    return leaves, {k: ref_grads[k].abs() >= 1e-3 * rms for k in leaves}


def compare_train(prog: Dict, ref: Dict, p0: Dict[str, torch.Tensor]
                  ) -> Dict[str, float]:
    """prog, ref: `ref_train`'s dicts; p0: the initial parameters.

    loss_gap, `<term>_gap`: the largest relative gap of the loss, of each
    loss term, over the steps. grad_gap_*: the step-1 gradient as the
    optimizer took it (the program's, its first moment / (1 - b1));
    moment_gap_*: the first moments after the last step, which hold every
    step's gradient; update_gap_*: the parameters' change over the steps;
    ema_gap_*: the EMA's. Each by its worst and its median leaf
    (`leaf_gaps`) over the `moving` leaves, the changes over their moving
    elements; `elements_left_out` is the share of the others."""
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    out = {"loss_gap": max(rel(a, b) for a, b in
                           zip(prog["losses"], ref["losses"]))}
    for n in ref["parts"][0] if prog["parts"] else ():
        out[f"{n}_gap"] = max(rel(a[n], b[n]) for a, b in
                              zip(prog["parts"], ref["parts"]))
    for i, (a, b) in enumerate(zip(prog["parts"], ref["parts"])):
        print(f"step {i + 1} losses (program, reference): " + ", ".join(
            f"{n} {a.get(n)!r} {b[n]!r}" for n in sorted(b)),
            file=sys.stderr)
    leaves, mask = moving(ref["grads"])
    for name, key in (("grad", "grads"), ("moment", "moments")):
        out.update(leaf_gaps(name + "_gap",
                             {k: norm(prog[key][k]) for k in leaves},
                             {k: norm(ref[key][k]) for k in leaves}))
    changed = [k for k in leaves if mask[k].any()]
    for name, key in (("update", "params"), ("ema", "ema")):
        out.update(leaf_gaps(name + "_gap", {
            k: norm((prog[key][k] - p0[k])[mask[k]]) for k in changed}, {
            k: norm((ref[key][k] - p0[k])[mask[k]]) for k in changed}))
    out["leaves_compared"] = float(len(leaves))
    out["elements_left_out"] = float(
        sum(int((~mask[k]).sum()) for k in leaves)
        / sum(mask[k].numel() for k in leaves))
    return out


def initial_params(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    meta = reference_meta(config)
    names = {n for n, _ in meta.named_parameters()}
    sd = make_state_dict(meta, seed, device)
    return {n: v.cpu() for n, v in sd.items() if n in names}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limited number within its limit; no limits is no pass."""
    return bool(limits) and all(numbers.get(k, float("inf")) <= v
                                for k, v in limits.items())
