"""Score 4-D occupancy forecasting on the card: mIoU at 0 / 1 / 2 / 3 s.

    python -m preworld_tpu_torch.tools.test_temporal CONFIG [WORK_DIR]
        [--synthetic] [--num-samples N] [--protocol reference|aligned]
        [--device cpu]

The port's counterpart of `tools/test_temporal.py`: the config's model as
`PreWorld4DTraj` rolls each sample out 6 steps, and the unmasked temporal
mIoU scores it against the ground truth 0, 2, 4 and 6 frames ahead.
WORK_DIR holds `checkpoints/` (none: the fresh weights, seeded 0).

Prediction per horizon (`--protocol`):
  reference (default): rollout steps {0, 1, 3, 5}, the reference's own
    mapping (its rollout step k is written under key `k + 1`, and the
    horizons read keys {0, 2, 4, 6} at stack position index // 2), which
    its published numbers use;
  aligned: rollout steps {0, 2, 4, 6}, each horizon scored by the step
    trained against it; not comparable with the published numbers.

`--synthetic` scores `--num-samples` generated samples (default 2). The
model runs on the card unless `--device cpu`. Prints the results as one
JSON line and returns them.
"""

from __future__ import annotations

import argparse
import json
import logging

import torch

from .cli import add_device_arg, resolve_device, synthetic_sample

PROTOCOLS = {"reference": (0, 1, 3, 5), "aligned": (0, 2, 4, 6)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--protocol", choices=tuple(PROTOCOLS),
                   default="reference")
    p.add_argument("--cfg-options", nargs="+", default=[])
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)

    from ..data import NuScenesOccTrajDataset
    from ..models import PreWorld4DTraj
    from ..train import (
        build_model,
        create_train_state,
        evaluate_miou_temporal,
        make_optimizer,
        maybe_resume,
        rank_padded_indices,
    )
    from ..utils import Config

    cfg = Config.fromfile(args.config).merge_from_options(args.cfg_options)
    torch.manual_seed(0)
    model = build_model(cfg, device=device)
    if not isinstance(model, PreWorld4DTraj):
        model = PreWorld4DTraj(model.cfg).to(device)

    if args.synthetic:
        def sample_iter():
            for i, valid in rank_padded_indices(args.num_samples or 2):
                s = synthetic_sample(model.cfg, i, 256, with_traj=True)
                s["_valid"] = valid
                for h, f in zip((0, 1, 2, 3), (0, 2, 4, 6)):
                    s[f"gt_h{h}"] = (s["temporal_semantics"][f - 1] if f > 0
                                     else s["voxel_semantics"])
                yield s
    else:
        data_cfg = cfg.get("data", {})
        val = data_cfg.get("val", {})
        dataset = NuScenesOccTrajDataset(
            ann_file=val["ann_file"], data_config=cfg["data_config"],
            grid_config=cfg["grid_config"], is_train=False,
            data_root=data_cfg.get("data_root", ""),
            ego_gt_path=val.get("ego_gt_path"),
            traj_gt_path=val.get("traj_gt_path"))

        def sample_iter():
            for i, valid in rank_padded_indices(args.num_samples
                                                or len(dataset)):
                s = dict(dataset[i], _valid=valid)
                for h, gt in dataset.horizon_gts(i).items():
                    s[f"gt_h{h}"] = gt
                yield s

    state = create_train_state(model, make_optimizer(model.parameters()))
    if args.checkpoint:
        state, resumed = maybe_resume(state, args.checkpoint)
        logging.info("checkpoint restored: %s", resumed)
    results = evaluate_miou_temporal(
        model, state, sample_iter(), rollout_steps=PROTOCOLS[args.protocol],
        num_classes=model.cfg.num_classes, device=device)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
