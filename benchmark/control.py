"""The output check's control and planted faults, read on the card.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--program <n> ...] [--look <count>]

For each of `--seeds`, at the cell's own sizes and inputs, the entry's
`controls` put the reference in the program's place and read it as a run
reads the program (`harness/check.py`): the control (the reference's
bfloat16 parts in float8, the precision below the configuration's) and,
for the train entry, the planted faults (half of each batch; the EMA's
ramp restarted) and a witness (the reference in bfloat16). A state or an
EMA left unchanged reads 1 by the measure itself and needs no run.

With `--program`, the program's own readings on those seeds first, in the
same process, through the run's own set-up and serving (`harness/main.py`
`build`, `prepare`, `serve`; the model built once, its weights drawn anew
for each seed): the warm inputs and the window's inputs up to the last
compared one, checked as a run checks them. `--look <count>` adds, for
the train entry's first count seeds, an element-by-element look at the
leaves that read worst.

One JSON line per seed and reading. The benchmark's runs never run this;
PERF.md keeps the readings that the limits in `limits/` were set from.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seed: int, device, man=None):
    """{reading: numbers} of the control and the faults for one seed."""
    from benchmark.harness.inputs import make_traffic
    from benchmark.harness.manifest import Manifest

    man = man or Manifest()
    cell = man.cell(workload)
    config, mix = man.config(cell), man.traffic(cell)
    kind = man.entry(mix)
    traffic = make_traffic(config, mix, seed, device)
    ks = [mix["warm"] + j for j in kind.sample(mix, seed)]
    return kind.controls(config, traffic, seed, device, ks)


def program_readings(workload: str, seeds, device, man=None, look=0):
    """Yield (seed, numbers) of the program on each seed; `look` train
    seeds (the first ones) also get `look_train`."""
    import gc

    import torch

    from benchmark.harness.main import build, free_program, prepare, serve
    from benchmark.harness.manifest import Manifest

    man = man or Manifest()
    cell = man.cell(workload)
    config, mix, kind, model = build(man, cell, device)
    for i, seed in enumerate(seeds):
        traffic, e, ks = prepare(config, mix, kind, model, seed, device)
        serve(e, mix["warm"], ks, mix["max_frames"])
        outputs = e.outputs()
        free_program(e)
        del e
        numbers = kind.check(config, traffic, outputs, seed, device)
        if i < look and "grads" in outputs:
            look_train(config, traffic, outputs, seed, device)
        del outputs
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        yield seed, numbers


def look_train(config, traffic, prog, seed, device) -> None:
    """Standard error: for the worst leaves of the gradient and of the
    change, element by element, the program against the reference."""
    import statistics

    import torch

    from benchmark.harness.check import initial_params, moving, norm, \
        ref_train

    ref = ref_train(config, traffic, seed, device)
    p0 = initial_params(config, seed, device)
    leaves, mask = moving(ref["grads"])
    g = {k: norm(ref["grads"][k]) for k in leaves}
    med = statistics.median(g.values())
    rms = statistics.median(g[k] / ref["grads"][k].numel() ** 0.5
                            for k in leaves)

    def worst(values_prog, values_ref, n=3):
        m = statistics.median(values_ref.values())
        return sorted(values_ref, key=lambda k: -abs(
            values_prog[k] - values_ref[k]) / max(values_ref[k], m))[:n]

    gp = {k: norm(prog["grads"][k]) for k in leaves}
    for k in worst(gp, g):
        a = prog["grads"][k].double().flatten()
        b = ref["grads"][k].double().flatten()
        cos = float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))
        print(f"look grad {k}: n {a.numel()} norm program {gp[k]!r} "
              f"reference {g[k]!r} (median leaf {med!r}) cosine {cos!r}",
              file=sys.stderr)
    d = {k: norm(ref["params"][k] - p0[k]) for k in leaves}
    dp = {k: norm(prog["params"][k] - p0[k]) for k in leaves}
    for k in worst(dp, d):
        gr = ref["grads"][k].double().abs().flatten()
        a = (prog["params"][k] - p0[k]).double().flatten()
        b = (ref["params"][k] - p0[k]).double().flatten()
        small = gr < 1e-3 * rms
        flips = float(((a * b) < 0).double().mean())
        print(f"look change {k}: n {a.numel()} whole norm program {dp[k]!r}"
              f" reference {d[k]!r}; elements with |g_ref| under "
              f"{1e-3 * rms!r}: {int(small.sum())}, |g_ref| there max "
              f"{float(gr[small].max()) if small.any() else 0.0!r}, change "
              f"there program {float(a[small].norm())!r} reference "
              f"{float(b[small].norm())!r}; the rest program "
              f"{float(a[~small].norm())!r} reference "
              f"{float(b[~small].norm())!r}; sign flips {flips!r}; "
              f"|g_ref| < eps 1e-8: {int((gr < 1e-8).sum())}",
              file=sys.stderr)
    del ref
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--program", type=int, nargs="*", default=[],
                   help="seeds for the program's own readings")
    p.add_argument("--look", type=int, default=0,
                   help="how many of the program's seeds get a look")
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    for seed, numbers in program_readings(args.workload, args.program,
                                          device, look=args.look):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": "program", "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        for name, numbers in readings(args.workload, seed, device).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": name, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
