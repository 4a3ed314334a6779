"""Score a checkpoint on the card: 3-D occupancy mIoU (and the F-score).

    python -m preworld_tpu_torch.tools.test CONFIG [WORK_DIR] [--synthetic]
        [--eval miou fscore] [--fuse-conv-bn] [--no-aavt] [--device cpu]

The port's counterpart of `tools/test.py`, with its flags. WORK_DIR holds
`checkpoints/` (none: the fresh weights, seeded 0); the EMA scores once the
state has stepped. `--synthetic` scores `--num-samples` generated samples
(default 4) instead of the config's val set; `--batch-size` (default 1);
`--out` writes each prediction as `<index>.npz`; `--eval fscore` adds the
F-score to the mIoU; `--fuse-conv-bn` folds every eval BatchNorm into its
convolution first (`utils/fold_bn.py`, on the weights that score).

The reference's test-time alignment of the adjacent frame
(`align_after_vt`) is on by default, `--no-aavt` turns it off; it reaches
only a `predict` that takes it (`BEVStereoOCC`'s does not). The model runs
on the card unless `--device cpu`. Prints the results as one JSON line and
returns them.
"""

from __future__ import annotations

import argparse
import inspect
import json
import logging
import os

import numpy as np
import torch

from .cli import add_device_arg, resolve_device, synthetic_sample


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--eval", nargs="+", default=["miou"],
                   choices=["miou", "mIoU", "fscore"])
    p.add_argument("--fuse-conv-bn", action="store_true")
    p.add_argument("--no-aavt", action="store_true")
    p.add_argument("--cfg-options", nargs="+", default=[])
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)

    from ..data import NuScenesOccDataset
    from ..metrics import MetricFScore
    from ..train import (
        build_model,
        create_train_state,
        eval_params,
        evaluate_miou,
        make_optimizer,
        maybe_resume,
        model_predict_fn,
        rank_padded_indices,
    )
    from ..utils import Config, fold_model_conv_bn

    cfg = Config.fromfile(args.config).merge_from_options(args.cfg_options)
    torch.manual_seed(0)
    model = build_model(cfg, device=device)
    if args.synthetic:
        samples = [synthetic_sample(model.cfg, i, 512)
                   for i in range(args.num_samples or 4)]
    else:
        data_cfg = cfg.get("data", {})
        dataset = NuScenesOccDataset(
            ann_file=data_cfg["val"]["ann_file"],
            data_config=cfg["data_config"], grid_config=cfg["grid_config"],
            is_train=False, data_root=data_cfg.get("data_root", ""))
        n = args.num_samples or len(dataset)
        samples = ({**dataset[i], "_valid": v}
                   for i, v in rank_padded_indices(n))

    state = create_train_state(model, make_optimizer(model.parameters()))
    if args.checkpoint:
        state, resumed = maybe_resume(state, args.checkpoint)
        logging.info("checkpoint restored: %s", resumed)
    if args.fuse_conv_bn:
        # fold the weights that score and install them as both copies
        folded = fold_model_conv_bn(model, eval_params(state))
        state.ema_params = {n: t.detach().clone() for n, t in folded.items()}
        logging.info("folded conv + BN pairs for eval")

    kw = {}
    if "align_after_vt" in inspect.signature(model.predict).parameters:
        kw["align_after_vt"] = not args.no_aavt

    dump_fn = None
    if args.out:
        os.makedirs(args.out, exist_ok=True)

        def dump_fn(i, occ):
            np.savez_compressed(os.path.join(args.out, f"{i:06d}.npz"),
                                semantics=occ)

    fscore = None
    if "fscore" in args.eval:
        g = cfg["grid_config"]
        fscore = MetricFScore(
            voxel_size=(g["x"][2], g["y"][2], g["z"][2]),
            pc_range=(g["x"][0], g["y"][0], g["z"][0],
                      g["x"][1], g["y"][1], g["z"][1]),
            void=(model.cfg.num_classes - 1, 255), use_image_mask=True)
    results = evaluate_miou(
        model, state, samples, num_classes=model.cfg.num_classes,
        use_image_mask=True, batch_size=args.batch_size,
        predict_fn=model_predict_fn(model, **kw), dump_fn=dump_fn,
        fscore_metric=fscore, device=device)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
