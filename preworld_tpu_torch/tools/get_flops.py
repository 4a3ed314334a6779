"""Report the parameters and forward FLOPs of a configured model.

    python -m preworld_tpu_torch.tools.get_flops CONFIG [--cfg-options K=V ...]
        [--device cpu]

The port's counterpart of `tools/get_flops.py`, with its flags plus
`--device`: the model of CONFIG (`train.build_model`) predicts one
synthetic inference batch (`data.synthetic_batch(cfg, 1,
with_labels=False)`), on the card unless `--device cpu` (no card and no
flag is an error).

What it counts (`utils/flops.py::count_forward`): the dense products and
convolutions of that forward as `torch.utils.flop_counter.FlopCounterMode`
defines them (2 FLOPs a multiply-add; elementwise operations,
normalisations, softmax, gathers and scatters count 0), plus the
hand-written kernels' products by the same definition, which each kernel
wrapper adds at its launch (ctypes launches are outside the counter's
sight). The CPU and the card give the same integer. `params` counts the
parameters the forward reads, which are those a flax `init` of the same
call creates; the port's model also builds the heads of the other train
stage, which `params built` adds.

Like the JAX tool it also prints the bytes accessed and the
transcendentals (`utils/flops.py`): each aten op's bytes read plus
written, each hand-written kernel counting its operands and result as one
call, as XLA counts a custom call; one transcendental per output element
of exp, log, sqrt, rsqrt, softmax, GELU and the like. The CPU and the card
give the same integers.

The numbers are not the JAX tool's: that reads XLA's cost analysis of the
compiled forward, which counts every elementwise operation as FLOPs too,
fuses elementwise chains (whose intermediates then cost no bytes; the
port's eager ops are not fused, so each writes and rereads its
intermediate), and counts the TPU-only reformulations, such as
`ops/conv3d.py::conv3d_zfold`, which computes each 3-D convolution as a
z-banded 2-D convolution with exact-zero taps, so each BEV-encoder and
head convolution is counted several times over there, in FLOPs and bytes.

Prints `params: X M`, the forward GFLOPs (aten, kernels and their sum), a
line per launched kernel, `bytes accessed` and `transcendentals`; returns
`count_forward`'s dict with the device's name.
"""

from __future__ import annotations

import argparse

from .cli import add_device_arg, resolve_device


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="+", default=[])
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    import torch

    from ..data import synthetic_batch, to_device
    from ..train import build_model
    from ..utils import Config
    from ..utils.flops import count_forward

    cfg = Config.fromfile(args.config).merge_from_options(args.cfg_options)
    model = build_model(cfg, device=device).eval()
    batch = to_device(synthetic_batch(model.cfg, 1, with_labels=False),
                      device)
    res = count_forward(model, batch)
    res["device"] = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")
    print(f"params: {res['params'] / 1e6:.2f} M (params built: "
          f"{res['params_built'] / 1e6:.2f} M)")
    print(f"forward flops: {res['flops'] / 1e9:.2f} GFLOPs ({res['flops']}) "
          f"on {res['device']} (aten {res['aten_flops'] / 1e9:.2f}, kernels "
          f"{res['kernel_flops'] / 1e9:.2f}; FlopCounterMode's definition)")
    for name, k in res["kernels"].items():
        print(f"kernel {name}: {k['launches']} launches, "
              f"{k['flops'] / 1e9:.2f} GFLOPs, {k['bytes'] / 1e9:.3f} GB")
    print(f"bytes accessed: {res['bytes'] / 1e9:.3f} GB ({res['bytes']}; "
          f"aten {res['aten_bytes'] / 1e9:.3f}, kernels "
          f"{res['kernel_bytes'] / 1e9:.3f})")
    print(f"transcendentals: {res['transcendentals']}")
    return res


if __name__ == "__main__":
    main()
