"""Train a model from a config file on the card.

    python -m preworld_tpu_torch.tools.train CONFIG [--work-dir DIR]
        [--synthetic] [--epochs N] [--max-iters N] [--device cpu] ...

The port's counterpart of `tools/train.py`, with its flags: `--work-dir`
(default work_dirs/<config name>), `--resume-from` (a work dir or a
checkpoint directory; nothing found there is an error), `--auto-resume`
(the latest checkpoint of the work dir), `--load-from` (a pickle from
`convert_torch_checkpoint`, overlaid on the fresh weights and their EMA;
tensors absent from it keep their init), `--seed`, `--validate` (mIoU of
`--val-samples` samples after each epoch), `--synthetic` (generated
samples, no dataset files), `--max-iters` (iterations per epoch),
`--epochs`, `--profile-dir` (a torch.profiler trace of iterations 8-11,
`trace.json`, with the program's spans on: `pw.train_step` and its phases
`pw.forward`, `pw.backward`, `pw.update`, `pw.upload`, `pw.masks`, the
layers; `utils/trace.py`) and `--cfg-options`. The model runs on the card
unless `--device cpu`. Each record of the work dir's metrics.jsonl gives
`time_per_iter` and `data_wait`, the host seconds an iteration waited on
the loader (both means over the records' iterations).

Several processes (`parallel`): under `torchrun` (WORLD_SIZE > 1) each
process joins the process group (`--dist-backend`, nccl on the card and
gloo on the CPU by default) and the mesh of `parallel.n_seq` (config key,
default 1) by world / n_seq. A process runs on `cuda:$LOCAL_RANK` unless
`--device` names the card (`cuda:N`; two processes may share one card over
gloo) or the CPU; a LOCAL_RANK with no card is an error. The global batch
is `samples_per_gpu` x n_data; each process loads its data rank's rows.
Rank 0's weights are copied to every rank before training; rank 0 alone
writes the checkpoints, metrics.jsonl and the JSON line.

`PreWorld4DTraj` trains along the rollout curriculum, `num_future` from
the epoch (`rollout_curriculum`). Prints one JSON line (the work dir, the
step, the last checkpoint and the last iteration's metrics, those of the
global batch) and returns it as a dict.

    torchrun --nproc_per_node 2 -m preworld_tpu_torch.tools.train CONFIG \
        --synthetic --device cuda:0 --dist-backend gloo   # one card
    torchrun --nproc_per_node 4 -m preworld_tpu_torch.tools.train CONFIG
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import pickle

import torch

from ..parallel import broadcast_module, init_from_env, make_mesh
from .cli import SyntheticDataset, add_device_arg, resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--auto-resume", action="store_true")
    p.add_argument("--load-from", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--validate", action="store_true")
    p.add_argument("--val-samples", type=int, default=64)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--profile-dir", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="process group backend under torchrun (default: "
                        "nccl on the card, gloo on the CPU)")
    add_device_arg(p)
    return p.parse_args(argv)


def process_device(name: str) -> torch.device:
    """`--device` for this process: under torchrun a bare `cuda` is the
    card of LOCAL_RANK (an error when there is none)."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and name == "cuda":
        name = f"cuda:{os.environ.get('LOCAL_RANK', os.environ['RANK'])}"
    return resolve_device(name)


def _datasets(cfg, model_cfg, args, is_traj):
    """(train dataset, eval samples or None)."""
    from ..data import NuScenesOccDataset, NuScenesOccTrajDataset

    data_cfg = cfg.get("data", {})
    tr = data_cfg.get("train", {})
    if args.synthetic:
        dataset = SyntheticDataset(
            model_cfg, 64, int(tr.get("max_ray_nums", 4096)) or 4096,
            with_traj=is_traj)
        val = None
        if args.validate:
            val = [dataset[i] for i in range(min(args.val_samples, 64))]
        return dataset, val
    common = dict(
        ann_file=tr["ann_file"], data_config=cfg["data_config"],
        grid_config=cfg["grid_config"], bda_aug_conf=cfg.get("bda_aug_conf"),
        is_train=True, use_rays=bool(tr.get("use_rays", False)),
        aux_frames=tr.get("aux_frames", (-3, -2, -1, 1, 2, 3)),
        max_ray_nums=int(tr.get("max_ray_nums", 38400)),
        depth_gt_path=tr.get("depth_gt_path"),
        semantic_gt_path=tr.get("semantic_gt_path"),
        data_root=data_cfg.get("data_root", ""), seed=args.seed)
    if is_traj:
        dataset = NuScenesOccTrajDataset(
            ego_gt_path=tr.get("ego_gt_path"),
            traj_gt_path=tr.get("traj_gt_path"), **common)
    else:
        dataset = NuScenesOccDataset(**common)
    val = None
    if args.validate:
        val_ds = NuScenesOccDataset(
            ann_file=data_cfg["val"]["ann_file"],
            data_config=cfg["data_config"], grid_config=cfg["grid_config"],
            is_train=False, data_root=data_cfg.get("data_root", ""))
        val = [val_ds[i] for i in range(min(args.val_samples, len(val_ds)))]
    return dataset, val


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = process_device(args.device)
    backend = args.dist_backend or ("nccl" if device.type == "cuda"
                                    else "gloo")
    joined = init_from_env(device, backend)
    try:
        return _train(args, device)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(args, device) -> dict:
    from ..data import DataLoader
    from ..models import PreWorld4DTraj, rollout_curriculum
    from ..train import (
        build_model,
        checkpoint_path,
        create_train_state,
        evaluate_miou,
        latest_step,
        make_optimizer,
        make_train_step,
        maybe_resume,
        model_predict_fn,
        rank_padded_indices,
        train_epochs,
    )
    from ..utils import Config
    from ..utils.torch_port import overlay_flax_params

    cfg = Config.fromfile(args.config).merge_from_options(args.cfg_options)
    mesh = make_mesh(n_seq=int(cfg.get("parallel", {}).get("n_seq", 1)))
    logging.basicConfig(
        level=logging.INFO if mesh.rank == 0 else logging.WARNING,
        format="%(asctime)s %(name)s %(message)s")
    work_dir = args.work_dir or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    torch.manual_seed(args.seed)
    model = build_model(cfg, device=device)
    is_traj = isinstance(model, PreWorld4DTraj)

    load_from = args.load_from or cfg.get("load_from")
    if load_from:
        with open(load_from, "rb") as fh:
            ported = pickle.load(fh)
        loaded, unexpected = overlay_flax_params(
            model, ported["params"], ported.get("batch_stats"))
        logging.info("warm-started %d tensors from %s (%d with no port "
                     "tensor)", len(loaded), load_from, len(unexpected))
    broadcast_module(model)

    opt, lr = cfg.get("optimizer", {}), cfg.get("lr_config", {})
    clip = cfg.get("optimizer_config", {}).get("grad_clip", {})
    ema = cfg.get("ema", {})
    state = create_train_state(model, make_optimizer(
        model.parameters(), base_lr=float(opt.get("lr", 1e-4)),
        weight_decay=float(opt.get("weight_decay", 1e-2)),
        clip_norm=float(clip.get("max_norm", 5)),
        warmup_iters=int(lr.get("warmup_iters", 200))),
        int(ema.get("init_updates", 0)))
    if args.auto_resume or args.resume_from:
        state, resumed = maybe_resume(state, work_dir, args.resume_from,
                                      mesh)
        if resumed:
            logging.info("resumed from checkpoint at step %d", state.step)

    dataset, val_samples = _datasets(cfg, model.cfg, args, is_traj)
    data_cfg = cfg.get("data", {})
    loader = DataLoader(dataset,
                        batch_size=int(data_cfg.get("samples_per_gpu", 1))
                        * mesh.n_data,
                        num_workers=int(data_cfg.get("workers_per_gpu", 2)) * 2,
                        seed=args.seed, process_index=mesh.data_rank,
                        process_count=mesh.n_data)

    ema_decay = float(ema.get("decay", 0.999))
    last = {}

    def recorded(step):
        def run(st, batch, generator):
            st, metrics = step(st, batch, generator)
            last["metrics"] = metrics
            return st, metrics
        return run

    train_step = step_factory = None
    if is_traj:
        @functools.lru_cache(maxsize=8)
        def step_for(num_future):
            return recorded(make_train_step(ema_decay, mesh,
                                            num_future=num_future))

        def step_factory(epoch):
            return step_for(rollout_curriculum(epoch, model.cfg.if_render))
    else:
        train_step = recorded(make_train_step(ema_decay, mesh))

    eval_fn = None
    if args.validate:
        predict_fn = None
        if is_traj:  # the key frame's occupancy
            rollout = model_predict_fn(model, num_future=0)

            def predict_fn(params, batch):
                return {"semantic_occ":
                        rollout(params, batch)["semantic_occ_0s"]}

        mine = [{**val_samples[i], "_valid": valid}
                for i, valid in rank_padded_indices(
                    len(val_samples), mesh.data_rank, mesh.n_data)]

        def eval_fn(st):
            return evaluate_miou(model, st, mine,
                                 num_classes=model.cfg.num_classes,
                                 predict_fn=predict_fn, mesh=mesh)

    max_epochs = args.epochs or int(cfg.get("runner", {}).get("max_epochs", 12))
    state = train_epochs(
        state, train_step, loader, max_epochs=max_epochs, work_dir=work_dir,
        log_interval=int(cfg.get("log_interval", 50)),
        generator=torch.Generator().manual_seed(args.seed + 1),
        step_factory=step_factory, max_iters_per_epoch=args.max_iters,
        eval_fn=eval_fn, profile_dir=args.profile_dir, mesh=mesh)
    ckpt_dir = os.path.join(work_dir, "checkpoints")
    step = latest_step(ckpt_dir)
    result = {
        "work_dir": work_dir, "step": state.step,
        "checkpoint": None if step is None else checkpoint_path(ckpt_dir,
                                                                step),
        "metrics": {k: float(v) for k, v in last.get("metrics", {}).items()},
    }
    if mesh.rank == 0:
        print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
