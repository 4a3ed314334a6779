"""The process mesh: ranks laid out as (data, seq), and the batch's split.

Counterpart of `preworld_tpu/parallel/mesh.py`. There a `jax.sharding.Mesh`
of devices with the axes 'data' (the batch, the reference's DDP) and 'seq'
(the render's rays) places every array, and XLA inserts the collectives.
Here one process runs per card (or, on one card over gloo, per share of it),
and the mesh names the process groups the code reduces over:

  rank r = d * n_seq + s   (d the data index, s the seq index), the order
                           of the JAX mesh's `reshape(n_data, n_seq)`;
  data group               the ranks that share s: one copy of the global
                           batch, each rank holding its rows; BatchNorm
                           moments and the batch-spanning losses sum here;
  seq group                the ranks that share d: the same scenes, each
                           rank rendering its slice of their rays.

A step runs inside `use_mesh(mesh)` (`train.make_train_step(mesh=...)`),
forward and backward, so that BatchNorm, the losses and the mask draws see
it through `current_mesh()`. A mesh of one process is trivial: `use_mesh`
then activates nothing, and the code takes its single-process path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in an (n_data, n_seq) mesh, and its groups
    (None where a group has one rank, or without a process group)."""

    n_data: int
    n_seq: int
    rank: int = 0
    data_group: Optional[object] = None
    seq_group: Optional[object] = None
    world_group: Optional[object] = None

    @property
    def world(self) -> int:
        return self.n_data * self.n_seq

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_seq

    @property
    def seq_rank(self) -> int:
        return self.rank % self.n_seq


def layout(n_data: int, n_seq: int) -> Tuple[List[List[int]], List[List[int]]]:
    """(data groups, seq groups) as rank lists: data group s holds the ranks
    d * n_seq + s over d, seq group d the ranks d * n_seq + s over s."""
    data = [[d * n_seq + s for d in range(n_data)] for s in range(n_seq)]
    seq = [[d * n_seq + s for s in range(n_seq)] for d in range(n_data)]
    return data, seq


def make_mesh(n_data: Optional[int] = None, n_seq: int = 1) -> Mesh:
    """The mesh over the default process group (one process without one).
    Every rank must call it, in the same order as its other group
    creations: `dist.new_group` is collective."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_seq
    if n_data * n_seq != world:
        raise ValueError(f"mesh {n_data} x {n_seq} != {world} processes")
    if world == 1:
        return Mesh(1, 1)
    rank = dist.get_rank()
    groups = {}
    data, seq = layout(n_data, n_seq)
    for kind, lists in (("data", data), ("seq", seq)):
        for ranks in lists:
            if len(ranks) == 1:
                continue  # every rank skips it alike
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[kind] = g
    return Mesh(n_data, n_seq, rank, groups.get("data"), groups.get("seq"),
                dist.group.WORLD)


def shard_batch(mesh: Optional[Mesh], batch: Dict) -> Dict:
    """This rank's rows of a global batch (numpy arrays or tensors): dim 0
    splits over 'data' in contiguous blocks, as the JAX `batch_shardings`
    place it. The ray dim is split where the JAX package splits it, inside
    the render (`seq_rays`), so that a loader's local batch and the
    forecasting model's `temporal_rays` follow the same rule."""
    if mesh is None or mesh.n_data == 1:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % mesh.n_data:
            raise ValueError(f"{k}: batch {v.shape[0]} does not split over "
                             f"{mesh.n_data} data ranks")
        b = v.shape[0] // mesh.n_data
        out[k] = v[mesh.data_rank * b:(mesh.data_rank + 1) * b]
    return out


def seq_rays(mesh: Optional[Mesh], rays: torch.Tensor, dim: int = 1):
    """(this rank's slice of `rays` along `dim`, the seq group it was split
    over or None). The ray dim splits over 'seq' only when it divides (the
    JAX `batch_shardings` rule, and `_render_batch`'s dense fallback)."""
    if mesh is None or mesh.n_seq == 1 or rays.shape[dim] % mesh.n_seq:
        return rays, None
    n = rays.shape[dim] // mesh.n_seq
    return rays.narrow(dim, mesh.seq_rank * n, n), mesh.seq_group


_ACTIVE: List[Optional[Mesh]] = [None]


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make `mesh` the one `current_mesh()` returns inside the block (a
    trivial mesh or None activates nothing). Run a step's forward and
    backward inside it: a checkpointed segment's recompute in the backward
    launches the forward's collectives again."""
    prev = _ACTIVE[0]
    _ACTIVE[0] = mesh if mesh is not None and mesh.world > 1 else None
    try:
        yield
    finally:
        _ACTIVE[0] = prev


def current_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing `use_mesh` block, None outside one."""
    return _ACTIVE[0]


def data_rows() -> Tuple[int, int]:
    """(n_data, data_rank) of the current mesh; (1, 0) outside one."""
    mesh = current_mesh()
    return (1, 0) if mesh is None else (mesh.n_data, mesh.data_rank)


def draw_rows(draw: Callable[[int], torch.Tensor], n_local: int,
              rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """`draw(n)` gives n rows of random masks from a generator that every
    rank holds alike; returns this rank's `n_local` rows of the global
    batch's draw, so that each mask equals the one a single process draws
    at the global batch. rows: (n_data, data_rank), by default the current
    mesh's (`data_rows`); a thread that does not run inside the step's
    `use_mesh` passes the step's."""
    n_data, rank = data_rows() if rows is None else rows
    if n_data == 1:
        return draw(n_local)
    full = draw(n_local * n_data)
    return full[rank * n_local:(rank + 1) * n_local]


def init_from_env(device: torch.device, backend: str) -> bool:
    """Join the process group that `torchrun` describes (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT; the caller picks `device` from LOCAL_RANK or
    its flag); False, joining nothing, when WORLD_SIZE is unset or 1."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return False
    if device.type == "cuda":
        torch.cuda.set_device(device)
    addr = os.environ["MASTER_ADDR"]
    port = os.environ["MASTER_PORT"]
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=int(os.environ["RANK"]), world_size=world)
    return True
