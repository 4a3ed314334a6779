"""Convert a BEVDet / BEVStereo torch checkpoint into a parameter overlay.

    python -m preworld_tpu_torch.tools.convert_torch_checkpoint CKPT.pth OUT.pkl

The port's counterpart of `tools/convert_torch_checkpoint.py`, with the
same output: a pickle of {"params", "batch_stats"}, flax-layout trees of
numpy arrays (`utils/torch_port.py::convert_full_model`), which `train
--load-from` overlays onto a fresh model (heads absent from the source keep
their init). It reads and writes files only; no device is used.
"""

from __future__ import annotations

import argparse
import pickle


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint")
    p.add_argument("out")
    p.add_argument("--report", action="store_true",
                   help="print the source's top-level modules")
    args = p.parse_args(argv)

    import torch

    from ..utils.torch_port import convert_full_model

    ckpt = torch.load(args.checkpoint, map_location="cpu", weights_only=False)
    state = ckpt.get("state_dict", ckpt)
    state_np = {k: v.numpy() for k, v in state.items()
                if hasattr(v, "numpy")}
    params, stats = convert_full_model(state_np)
    with open(args.out, "wb") as fh:
        pickle.dump({"params": params, "batch_stats": stats}, fh)
    n = sum(1 for _ in _leaves(params))
    print(f"ported {n} tensors -> {args.out}")
    modules = sorted({k.split(".")[0] for k in state_np})
    if args.report:
        print("torch top-level modules:", modules)
    return {"tensors": n, "out": args.out, "modules": modules}


if __name__ == "__main__":
    main()
