"""FLOPs and bytes of the flagship predict's cumulative-truncation probes
(dev tool).

    python -m preworld_tpu_torch.tools.bench_bytes [--device cuda|cpu]

The port's counterpart of `tools/bench_bytes.py`: the five probes of
`bench_stages` (the same model, weights and batch; without the scalar
sums, so `full_predict` is one request's count, `count_forward`), each
counted by `utils/flops.py::count_flops`; successive differences attribute the
request's FLOPs and bytes to its stages. The JAX tool only compiles and
reads XLA's cost analysis; the port's count runs each probe once, on the
card unless `--device cpu` (no card is an error, never a fallback; the
two devices give the same integers). FLOPs: the products and convolutions
as `torch.utils.flop_counter` defines them, the kernels' by the same
definition; bytes: each aten op's reads and writes, each kernel call its
operands and result (XLA's definition; the eager ops are not fused). The
first line is the card's `nvidia-smi` name and power limit, then one JSON
line a probe under the JAX tool's keys: `probe`, `gb`, `delta_gb`,
`tflops`, `delta_tflops`.
"""

from __future__ import annotations

import argparse
import json

from .cli import add_device_arg, resolve_device


def count_probes(model, batch, probes) -> list:
    """`count_flops` of each probe: [(name, count dict)]."""
    from ..utils.flops import count_flops

    return [(name, count_flops(lambda fn=fn: fn(model, batch), model))
            for name, fn, _ in probes]


def rows(counts) -> list:
    """The JSON rows of `count_probes`' counts, with successive
    differences."""
    out, prev_f, prev_b = [], 0, 0
    for name, c in counts:
        out.append({"probe": name, "gb": c["bytes"] / 1e9,
                    "delta_gb": (c["bytes"] - prev_b) / 1e9,
                    "tflops": c["flops"] / 1e12,
                    "delta_tflops": (c["flops"] - prev_f) / 1e12})
        prev_f, prev_b = c["flops"], c["bytes"]
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(p)
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    from .bench_parts import card_line
    from .bench_stages import make_probes

    print(card_line(device), flush=True)
    counts = count_probes(*make_probes(device=device))
    out = rows(counts)
    for r in out:
        print(json.dumps(r), flush=True)
    return out


if __name__ == "__main__":
    main()
