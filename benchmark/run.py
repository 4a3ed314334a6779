"""Run one cell of the benchmark once, on the card, and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell comes from BENCHMARK.json at the checkout's root. The last line
of standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checks`, each number of the output check beside its limit (also the
last lines of standard error). With no CUDA device the run fails and
prints no result; it never falls back to the CPU.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("benchmark: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    from benchmark.harness.main import run

    return run(args, T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())
