"""Collectives of the port's multi-process step, built from `all_reduce`
and `broadcast` only (gloo has no `all_gather` of CUDA tensors).

`all_reduce` and `gather_rows` are differentiable: the backward of a sum
over a group is the sum over the group of the incoming gradients, so with
local losses that add up to the global loss (`parallel` invariant 1) each
rank's backward gives its share of the global gradient. `counts` adds one
per launch by label ("batchnorm", "loss", "render", "grads", "metrics"),
forward and backward alike.
"""

from __future__ import annotations

import collections
from typing import Iterable, List, Sequence

import torch
import torch.distributed as dist

from .mesh import current_mesh

counts: collections.Counter = collections.Counter()


def _sum_into(t: torch.Tensor, group, label: str) -> None:
    counts[label] += 1
    dist.all_reduce(t, group=group)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, label):
        ctx.group, ctx.label = group, label
        y = x.contiguous().clone()
        _sum_into(y, group, label)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _sum_into(g, ctx.group, ctx.label)
        return g, None, None


def all_reduce(x: torch.Tensor, group, label: str = "loss") -> torch.Tensor:
    """Sum of `x` over `group` (x itself when the group is None), with
    gradient."""
    if group is None:
        return x
    return _AllReduce.apply(x, group, label)


def gather_rows(x: torch.Tensor, group, index: int, size: int,
                label: str = "loss") -> torch.Tensor:
    """The rows of every rank of `group` stacked along dim 0 in rank order
    (each rank holds as many): an all_reduce into a zeroed buffer in which
    this rank, `index` of `size`, fills its own rows. Its gradient is this
    rank's rows of the summed incoming gradient."""
    if group is None:
        return x
    n = x.shape[0]
    before = x.new_zeros((index * n, *x.shape[1:]))
    after = x.new_zeros(((size - 1 - index) * n, *x.shape[1:]))
    return all_reduce(torch.cat([before, x, after]), group, label)


def batch_sums(*sums: torch.Tensor) -> List[torch.Tensor]:
    """The global batch's values of per-rank sums (any shapes, one f32
    all_reduce over the active mesh's data group, with gradient); the
    inputs themselves without a mesh."""
    mesh = current_mesh()
    if mesh is None or mesh.data_group is None:
        return list(sums)
    flat = all_reduce(torch.cat([s.float().reshape(-1) for s in sums]),
                      mesh.data_group)
    out, i = [], 0
    for s in sums:
        out.append(flat[i:i + s.numel()].reshape(s.shape))
        i += s.numel()
    return out


def replica_share() -> float:
    """The weight of a value that every rank of the active mesh computes
    alike (a loss of the global batch): 1 / world, so that the ranks'
    shares add up to it once; 1 without a mesh."""
    mesh = current_mesh()
    return 1.0 if mesh is None else 1.0 / mesh.world


def allreduce_grads(params: Iterable[torch.nn.Parameter], group,
                    bucket_bytes: int = 64 << 20) -> int:
    """Sum the gradients of `params` over `group`, one all_reduce per flat
    bucket of up to `bucket_bytes`; returns the bytes reduced. A parameter
    with a gradient on some rank gets zeros where it has none; one with no
    gradient on any rank keeps None."""
    params = [p for p in params]
    if group is None or not params:
        return 0
    have = torch.tensor([p.grad is not None for p in params],
                        dtype=torch.float32, device=params[0].device)
    _sum_into(have, group, "grads")
    live = [p for p, h in zip(params, have.tolist()) if h > 0]
    for p in live:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    total = 0
    for bucket in _buckets(live, bucket_bytes):
        flat = torch.cat([p.grad.reshape(-1) for p in bucket])
        _sum_into(flat, group, "grads")
        total += flat.numel() * flat.element_size()
        i = 0
        for p in bucket:
            p.grad.copy_(flat[i:i + p.numel()].view_as(p.grad))
            i += p.numel()
    return total


def _buckets(params: Sequence[torch.nn.Parameter], limit: int):
    bucket, size = [], 0
    for p in params:
        nbytes = p.grad.numel() * p.grad.element_size()
        if bucket and size + nbytes > limit:
            yield bucket
            bucket, size = [], 0
        bucket.append(p)
        size += nbytes
    if bucket:
        yield bucket


def broadcast_module(module: torch.nn.Module) -> None:
    """Copy rank 0's parameters and buffers to every rank of the default
    group (no-op without one), so that all replicas start alike."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)
