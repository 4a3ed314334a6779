"""Training across processes: the port's counterpart of the JAX mesh.

The JAX train step is one SPMD program over the global batch on a
('data', 'seq') device mesh (`preworld_tpu/parallel/mesh.py`): XLA takes
BatchNorm moments and batch-spanning losses over the whole batch and sums
the gradients; the render splits each scene's rays over 'seq'. Here each
rank is a process (`torchrun`, or one launched by hand) that runs the
port's single-process step on its rows of the batch and its slice of the
rays, and the step computes the JAX step on the global batch because of
three invariants:

1. **The local losses add up to the JAX total.** Summed over all ranks,
   the ranks' loss dicts equal the JAX `loss_fn` dict on the global batch.
   A loss that spans the batch divides its local numerator by a global
   denominator, or is computed from globally summed statistics and taken
   at `replica_share()` = 1 / world; a loss that seq replicas compute alike
   is so scaled by 1 / n_seq.
2. **Every collective in the forward is differentiable.** Its backward is
   an `all_reduce` of the incoming gradient over the same group
   (`collectives.all_reduce`, a `torch.autograd.Function`). A row
   "all-gather" is an all_reduce into a zeroed buffer in which each rank
   fills its own rows (`gather_rows`); `dist.all_gather` is not used, as
   gloo lacks it for CUDA tensors. So every collective is an `all_reduce`
   or a `broadcast`, and the same code runs over gloo (several processes on
   one card, or the CPU) and NCCL (one process per card).
3. **The step sums gradients over the world.** After `backward()`,
   `allreduce_grads` sums the f32 gradients, one all_reduce per flat
   bucket, before `ClippedAdamW.step`: the clip's global norm is the
   global gradient's, and the replicas stay bit-identical. A parameter
   whose gradient is None on every rank stays None.

Masks are drawn for the global batch from a generator every rank holds
alike, and each rank keeps its rows (`draw_rows`). With one process the
mesh is trivial and no collective is launched.
"""

from .collectives import (
    all_reduce,
    allreduce_grads,
    batch_sums,
    broadcast_module,
    counts,
    gather_rows,
    replica_share,
)
from .mesh import (
    Mesh,
    current_mesh,
    draw_rows,
    init_from_env,
    layout,
    make_mesh,
    seq_rays,
    shard_batch,
    use_mesh,
)

# `batch_shardings` / `replicate_sharding` of the JAX package stay behind:
# they are `NamedSharding` objects, and `shard_batch` places the batch here
# (ROADMAP P17).
__all__ = [
    "Mesh", "all_reduce", "allreduce_grads", "batch_sums",
    "broadcast_module", "counts", "current_mesh", "draw_rows",
    "gather_rows", "init_from_env", "layout", "make_mesh", "replica_share",
    "seq_rays", "shard_batch", "use_mesh",
]
