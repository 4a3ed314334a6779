"""Run port code in several gloo processes on the CPU, for the tests.

`Launch(cases, world, tmp)` starts `world` Python processes joined by gloo
(the environment `torchrun` gives: RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT), each running the named cases of this module in
order; its `results()` are each rank's {key: result}. A case is
`fn(rank, world, **kwargs)` returning numpy arrays and numbers. This module
imports the port only (no JAX), as a user's process would; the inputs are
made from seeds, or read from files the test wrote.
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import os
import pickle
import socket
import subprocess
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> Dict[str, str]:
    """torchrun's environment for `rank` of `world` on this host, two torch
    threads, gloo on the loopback."""
    return dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), GLOO_SOCKET_IFNAME="lo",
                OMP_NUM_THREADS="2")


class Ranks:
    """`world` processes started as ranks 0.. of one gloo world, one argv
    each (`torchrun`'s environment); `wait()` gives their (stdout, stderr)
    and fails on a nonzero exit or the timeout."""

    def __init__(self, argvs: Sequence[Sequence[str]], cwd: str = REPO):
        world, port = len(argvs), free_port()
        self.procs = [subprocess.Popen(
            list(a), env=rank_env(r, world, port), cwd=cwd,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r, a in enumerate(argvs)]

    def wait(self, timeout: float = 180.0) -> List[Tuple[str, str]]:
        outs = []
        try:
            for r, p in enumerate(self.procs):
                out, err = p.communicate(timeout=timeout)
                assert p.returncode == 0, \
                    f"rank {r} exited {p.returncode}:\n{err}"
                outs.append((out, err))
        finally:
            self.close()
        return outs

    def close(self) -> None:
        for p in self.procs:
            p.kill()
            p.wait()


class Launch:
    """`cases`, (key, case name, kwargs) triples, run in order by each of
    `world` ranks; `results()` gives each rank's {key: result}."""

    def __init__(self, cases: Sequence[Tuple[str, str, Dict]], world: int,
                 tmp):
        self.tmp, self.world = str(tmp), world
        with open(os.path.join(self.tmp, "cases.pkl"), "wb") as fh:
            pickle.dump(list(cases), fh)
        code = (f"import sys; sys.path[:0] = [{REPO!r}, {TESTS!r}]; "
                f"import torch_dist; torch_dist.worker({self.tmp!r})")
        self.ranks = Ranks([[sys.executable, "-c", code]] * world)

    def results(self, timeout: float = 180.0) -> List[Dict]:
        self.ranks.wait(timeout)
        out = []
        for r in range(self.world):
            with open(os.path.join(self.tmp, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out


def worker(tmp: str) -> None:
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=90))
    with open(os.path.join(tmp, "cases.pkl"), "rb") as fh:
        cases = pickle.load(fh)
    out = {key: globals()[name](rank, world, **kw) for key, name, kw in cases}
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


def _np(t):
    return None if t is None else t.detach().double().numpy().copy()


# ------------------------------------------------------------ the inputs

def voxel_inputs(B=2, X=3, Y=5, Z=7, C=18, seed=0):
    """Logits and targets over an odd grid (105 voxels a scene): ignored
    (255) and empty (17) voxels, a camera mask, and class 4 in scene 0
    only."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 2.0, (B, X, Y, Z, C)).astype(np.float32)
    target = rng.integers(0, C, (B, X, Y, Z))
    target[target == 4] = 5
    target[0, 0, :2, 0] = 4
    target[rng.uniform(size=target.shape) < 0.1] = 255
    cam = rng.uniform(size=target.shape) > 0.3
    return logits, target, cam


def depth_inputs(B=2, N=2, H=32, W=64, ds=8, D=16, seed=1):
    rng = np.random.default_rng(seed)
    gt = np.where(rng.uniform(size=(B, N, H, W)) > 0.8,
                  rng.uniform(0.5, 12.0, (B, N, H, W)), 0.0).astype(np.float32)
    logits = rng.normal(size=(B, N, D, H // ds, W // ds)).astype(np.float32)
    return logits, gt


def render_inputs(B=4, R=64, X=12, Y=12, Z=6, seed=3):
    """`tests/test_ops.py::test_sharded_render_matches_dense`'s inputs with
    the density shifted by 9 (as `tests/test_torch_pretrain_step.py` sets
    the density head's bias): at its opacities of ~1e-6, 1 - exp(-x) keeps
    ~10 % in f32, and XLA and torch round it apart by far more than the
    test's 2e-5, while at ~5e-3 the two renders agree."""
    rng = np.random.default_rng(seed)
    density = rng.normal(9.0, 1.0, (B, X, Y, Z)).astype(np.float32)
    semantic = rng.normal(size=(B, X, Y, Z, 17)).astype(np.float32)
    color = rng.normal(size=(B, X, Y, Z, 3)).astype(np.float32)
    rays = np.zeros((B, R, 16), np.float32)
    rays[..., 2] = rng.uniform(1, 30, (B, R))
    rays[..., 2, ::5] = 0.0
    rays[..., 3] = rng.integers(0, 17, (B, R))
    rays[..., 4:7] = rng.uniform(-2, 2, (B, R, 3))
    rays[..., 7:10] = rng.normal(size=(B, R, 3))
    rays[..., 13:16] = rng.uniform(0, 1, (B, R, 3))
    bda = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    return density, semantic, color, rays, bda


def loss_fns():
    """name -> (fn(tensors...) -> loss, the numpy inputs, the indices of
    the inputs that take a gradient). Each input's dim 0 is the batch."""
    from preworld_tpu_torch.geometry import GridConfig
    from preworld_tpu_torch.losses import voxel
    from preworld_tpu_torch.models.bevstereo_occ import occ_ce_loss
    from preworld_tpu_torch.models.nerf_head import NerfHeadConfig
    from preworld_tpu_torch.models.nerf_head import nerf_head_losses
    from preworld_tpu_torch.models.preworld_traj import l2_traj_loss
    from preworld_tpu_torch.models.view_transformer import depth_bce_loss

    logits, target, cam = voxel_inputs()
    w = torch.from_numpy(voxel.voxel_class_weights(18))
    grid = GridConfig(x=(-8.0, 8.0, 0.8), y=(-8.0, 8.0, 0.8),
                      z=(-1.0, 5.4, 0.8), depth=(1.0, 9.0, 0.5))
    dlogits, gt = depth_inputs(D=grid.num_depth_bins)
    rng = np.random.default_rng(4)
    pred, tgt = (rng.normal(size=(2, 2)).astype(np.float32)
                 for _ in range(2))
    de, se, co, rays, bda = render_inputs(B=2, R=32, X=6, Y=6, Z=4)
    return {
        "ce_ssc": (lambda x, t: voxel.ce_ssc_loss(x, t, w),
                   (logits, target), (0,)),
        "sem_scal": (lambda x, t, m: voxel.sem_scal_loss(x, t, camera_mask=m),
                     (logits, target, cam), (0,)),
        "geo_scal": (lambda x, t, m: voxel.geo_scal_loss(x, t, camera_mask=m),
                     (logits, target, cam), (0,)),
        "lovasz": (lambda x, t, m: voxel.lovasz_softmax_loss(
            x, t, camera_mask=m), (logits, target, cam), (0,)),
        "focal": (lambda x, t, m: voxel.distance_weighted_focal_loss(
            x, t, w, camera_mask=m), (logits, target, cam), (0,)),
        "depth_bce": (lambda x, g: depth_bce_loss(
            torch.softmax(x, dim=2), g, 8, grid), (dlogits, gt), (0,)),
        "l2_traj": (l2_traj_loss, (pred, tgt), (0,)),
        "occ_ce": (lambda x, t: occ_ce_loss(x, t.clamp(0, 17)),
                   (logits, target), (0,)),
        "render": (lambda d, s, c, r, b: sum(nerf_head_losses(
            d, s, c, r, b, NerfHeadConfig()).values()),
            (de, se, co, rays, bda), (0, 1, 2)),
    }


# ----------------------------------------------------------------- cases

def collectives(rank, world):
    """The differentiable all_reduce and row gather over the world, their
    gradients, and `allreduce_grads`' None rule."""
    import torch.distributed as dist

    from preworld_tpu_torch import parallel

    g = dist.group.WORLD
    x = torch.arange(6.0).reshape(2, 3).add(10.0 * rank).requires_grad_()
    y = parallel.all_reduce(x, g)
    (y * (rank + 1.0)).sum().backward()
    rows = torch.full((2, 3), float(rank + 1), requires_grad=True)
    gathered = parallel.gather_rows(rows, g, rank, world)
    weight = torch.arange(gathered.numel(), dtype=torch.float32).reshape(
        gathered.shape) * (rank + 1.0)
    (gathered * weight).sum().backward()
    ps = [torch.nn.Parameter(torch.zeros(3)) for _ in range(3)]
    ps[0].grad = torch.full((3,), rank + 1.0)
    if rank == 1:
        ps[1].grad = torch.ones(3)
    nbytes = parallel.allreduce_grads(ps, g, bucket_bytes=8)
    return dict(y=_np(y), x_grad=_np(x.grad), gathered=_np(gathered),
                rows_grad=_np(rows.grad), grads=[_np(p.grad) for p in ps],
                nbytes=nbytes)


def batchnorm(rank, world):
    """A BatchNorm2d on this rank's rows of a batch of 4 (outputs, input
    and parameter gradients, running statistics), plainly and under
    `checkpoint` with its recompute folding nothing."""
    from torch.utils.checkpoint import checkpoint

    from preworld_tpu_torch import parallel
    from preworld_tpu_torch.models.layers import (
        BatchNorm2d,
        recompute_context,
    )

    rng = np.random.default_rng(7)
    x = rng.normal(1.0, 2.0, (4, 3, 5, 6)).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    b = 4 // world
    sl = slice(rank * b, (rank + 1) * b)
    mesh = parallel.make_mesh()
    out = {}
    for remat in (False, True):
        torch.manual_seed(0)
        bn = BatchNorm2d(3)
        with torch.no_grad():
            bn.weight.copy_(torch.tensor([1.5, 0.5, -1.0]))
            bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
        bn.train()
        xl = torch.from_numpy(x[sl]).requires_grad_()
        with parallel.use_mesh(mesh):
            if remat:  # as `PreWorld._segment` runs a segment
                y = checkpoint(bn, xl, use_reentrant=False, context_fn=lambda: (
                    contextlib.nullcontext(), recompute_context()))
            else:
                y = bn(xl)
            (y * torch.from_numpy(gy[sl])).sum().backward()
        out["remat" if remat else "plain"] = dict(
            y=_np(y), x_grad=_np(xl.grad), w_grad=_np(bn.weight.grad),
            b_grad=_np(bn.bias.grad), mean=_np(bn.running_mean),
            var=_np(bn.running_var))
    return out


def losses(rank, world):
    """Each loss of `loss_fns` on this rank's rows under a (world, 1) mesh,
    and on the whole batch under a (1, world) mesh (seq replicas): value
    and input gradients."""
    from preworld_tpu_torch import parallel

    out = {}
    for layout in ("data", "seq"):
        mesh = parallel.make_mesh(*((world, 1) if layout == "data"
                                    else (1, world)))
        for name, (fn, arrays, diff) in loss_fns().items():
            if name == "render" and layout == "seq":
                continue  # the render's seq split: the `render` case
            arrays = parallel.shard_batch(mesh, dict(enumerate(arrays)))
            ts = [torch.from_numpy(np.ascontiguousarray(arrays[i]))
                  for i in range(len(arrays))]
            for i in diff:
                ts[i].requires_grad_()
            with parallel.use_mesh(mesh):
                value = fn(*ts)
                value.backward()
            out[layout, name] = dict(value=float(value),
                                     grads=[_np(ts[i].grad) for i in diff])
    return out


def render(rank, world):
    """`nerf_head_losses` of render_inputs under a (1, world) mesh: each
    rank renders every scene's slice of the rays. Its loss dict, field
    gradients, the collectives it launched, and the bytes one scene's
    render saves for the backward."""
    from preworld_tpu_torch import parallel
    from preworld_tpu_torch.models.nerf_head import (
        NerfHeadConfig,
        nerf_head_losses,
        render_scene,
    )

    cfg = NerfHeadConfig()
    fields = [torch.from_numpy(a).requires_grad_()
              for a in render_inputs()[:3]]
    rays, bda = (torch.from_numpy(a) for a in render_inputs()[3:])
    mesh = parallel.make_mesh(1, world)
    parallel.counts.clear()
    with parallel.use_mesh(mesh):
        got = nerf_head_losses(*fields, rays, bda, cfg)
        sum(got.values()).backward()
    launched = dict(parallel.counts)
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        saved[st.data_ptr()] = st.nbytes()
        return t

    local, group = parallel.seq_rays(mesh, rays)
    mask = (local[0, :, 2] > 0).float()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        render_scene(*(f[0].detach().requires_grad_() for f in fields),
                     local[0, :, 4:7], local[0, :, 7:10], bda[0], cfg, mask,
                     group)
    return dict(losses={k: float(v) for k, v in got.items()},
                grads=[_np(f.grad) for f in fields], launched=launched,
                rays=local.shape[1], saved=sum(saved.values()),
                inputs=sum(t.untyped_storage().nbytes() for t in (
                    local[0, :, 4:7], local[0, :, 7:10], bda[0], mask)))


def evaluation(rank, world):
    """The evals of 3 samples that every rank holds (the seq replicas of a
    (1, world) mesh) with a stub predict: the summed histogram and the
    temporal eval's count with the mesh, and without it (the default
    group: each sample once per process)."""
    from types import SimpleNamespace

    from preworld_tpu_torch import parallel
    from preworld_tpu_torch.metrics import MetricMIoU
    from preworld_tpu_torch.train import evaluate

    shape = (4, 4, 2)
    samples = []
    for i in range(3):
        rng = np.random.default_rng(50 + i)
        s = {"imgs": rng.uniform(0.0, 1.0, shape).astype(np.float32),
             "voxel_semantics": rng.integers(0, 5, shape)}
        s.update({f"gt_h{h}": rng.integers(0, 5, shape) for h in range(4)})
        samples.append(s)

    def predict(params, b):
        out = {"semantic_occ": (b["imgs"] * 7.0).to(torch.int32) % 5}
        for k in (0, 1, 3, 5):
            out[f"semantic_occ_{k}s"] = out["semantic_occ"]
        return out

    mesh = parallel.make_mesh(1, world)
    state = SimpleNamespace(step=1, ema_params={})
    mine = [{**samples[i], "_valid": v} for i, v in
            evaluate.rank_padded_indices(3, mesh.data_rank, mesh.n_data)]
    kw = dict(num_classes=5, predict_fn=predict, device="cpu")
    metric = MetricMIoU(num_classes=5, use_image_mask=False)
    for s in samples:
        occ = predict(None, {"imgs": torch.from_numpy(s["imgs"])})
        metric.add_batch(occ["semantic_occ"].numpy(), s["voxel_semantics"],
                         None, None)
    out = {}
    for name, m in (("mesh", mesh), ("default_group", None)):
        out[name] = dict(
            hist=evaluate.all_hosts_sum(metric.hist.copy(), m),
            miou=evaluate.evaluate_miou(None, state, mine, mesh=m,
                                        use_image_mask=False, **kw),
            temporal=evaluate.evaluate_miou_temporal(None, state, mine,
                                                     mesh=m, **kw))
    out["local_hist"] = metric.hist
    return out


def state_digest(model) -> str:
    h = hashlib.sha256()
    for _, p in sorted(model.named_parameters()):
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def train_step(rank, world, config, state_path, batch_path, n_seq=1,
               base_lr=0.1, init_ema_updates=10560, masks=False):
    """One `make_train_step` of the port model `config` (a dict of
    `tiny_config` overrides) from the state dict at `state_path`, on this
    rank's part of the global numpy batch at `batch_path`, under an
    (world / n_seq, n_seq) mesh. `masks`: drop path and the depth net's
    dropout at the model's rates (else 0, as the JAX comparisons need).
    Returns the metrics, the new state, EMA and clipped gradients (Adam's
    first moment / 0.1), the parameters' digest and the collectives."""
    from preworld_tpu_torch import parallel
    from preworld_tpu_torch.data import tiny_config, to_device
    from preworld_tpu_torch.models import PreWorld
    from preworld_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from preworld_tpu_torch.utils import torch_state

    model = PreWorld(tiny_config(**config))
    model.load_state_dict(torch.load(state_path, weights_only=True))
    if not masks:
        if hasattr(model.img_backbone, "drop_path_rate"):
            model.img_backbone.drop_path_rate = 0.0
        model.view_transformer.depth_net.aspp.dropout_rate = 0.0
    with open(batch_path, "rb") as fh:
        batch = pickle.load(fh)
    mesh = parallel.make_mesh(world // n_seq, n_seq)
    local = to_device(parallel.shard_batch(mesh, batch), "cpu")
    opt = make_optimizer(model.parameters(), base_lr=base_lr)
    st = create_train_state(model, opt, init_ema_updates)
    parallel.counts.clear()
    st, metrics = make_train_step(mesh=mesh)(
        st, local, torch.Generator().manual_seed(0))
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        state=torch_state(model), ema=torch_state(model, st.ema_params),
        g={n: opt.state[p]["mu"].numpy() / 0.1
           for n, p in model.named_parameters() if p in opt.state},
        no_grad=sorted(n for n, p in model.named_parameters()
                       if p.grad is None),
        digest=state_digest(model), counts=dict(parallel.counts))
