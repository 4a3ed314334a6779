"""The train step's stochastic-depth and ASPP dropout masks, drawn a step
ahead on a host worker thread.

A train-mode forward of `PreWorld` draws, from the caller's host
`torch.Generator` and in a fixed order (`PreWorld._mask_draws`), the Swin
blocks' stochastic-depth scales and the depth net's ASPP dropout masks.
The CPU generator is one serial stream, and at the flagship size the two
ASPP masks take hundreds of ms to draw while the card waits. The masks
must stay the ones that stream gives: the CPU and card runs of a step,
and the ranks of a mesh, are held to the same masks.

`MaskPlanner` keeps them so and takes the draws off the step's critical
path. When a step takes its last draw, the planner hands the next step's
draws to one worker thread, which makes them from a copy of the
generator's state (`Generator.set_state` on a generator of its own; the
caller's generator is never touched there). At the next step's first
draw, the caller's generator state is compared with the state the plan
started from, and the step's draw keys (rows, the mesh's rows, shapes,
rates) with the plan's:

  hit   the step takes the worker's draws in order, waiting only for
        those not done yet, and its last draw sets the caller's generator
        to the state the worker's draws left, where inline draws leave it;
  miss  (a first step, a generator reseeded or drawn from between steps,
        other rows) the step draws inline from the caller's generator.

Either way the step's masks and the generator's state after it are those
of inline draws, bit for bit. At most one plan is in flight: a step
takes it out of the flight at its first draw, hit or miss. A worker's
exception is raised on the caller's thread by the step that takes the
failed draw.

An ASPP mask is drawn as bool (one byte an element), in pinned host
memory when the model is on a card, so that its upload where the step
consumes it is an asynchronous copy of a quarter of an f32 mask's bytes.
PyTorch's pinned allocator hands a freed block out again only once the
event that its copy recorded has passed. With `utils.trace` on, the
counters `mask_plan_hits` and `mask_plan_misses` count the steps of each
kind; what the caller's thread still spends on the masks (the wait on the
worker, or inline draws) stays inside the `masks` spans.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ..utils import trace


@dataclasses.dataclass(frozen=True)
class Draw:
    """One draw of a train step. `kind` is what the consumer asks for
    (`StepDraws.take`); `key` holds everything that fixes the draw's
    values, compared between a plan and a step; `fn(generator, out)` draws
    it, into `out`, a host bool tensor of `out_shape`, where that is set
    (else `out` is None)."""

    kind: Any
    key: Tuple
    fn: Callable[[torch.Generator, Optional[torch.Tensor]], Any]
    out_shape: Optional[Tuple[int, ...]] = None


def _out(draw: Draw, pin: bool) -> Optional[torch.Tensor]:
    if draw.out_shape is None:
        return None
    return torch.empty(draw.out_shape, dtype=torch.bool, pin_memory=pin)


@dataclasses.dataclass
class _Plan:
    """A step's draws handed to the worker: the key they were planned for,
    the generator state they start from, their results and the state they
    leave, as futures of the worker's tasks."""

    key: Tuple
    start: torch.Tensor
    results: List[Future]
    end: Future


class MaskPlanner:
    """A model's plan in flight and the worker thread that draws it, made
    with the first plan (inference never makes one)."""

    def __init__(self):
        self._pool: Optional[ThreadPoolExecutor] = None
        self._plan: Optional[_Plan] = None

    def step(self, generator: torch.Generator, draws: Sequence[Draw],
             pin: bool) -> Optional["StepDraws"]:
        """The draws of one train-mode forward from `generator`, None when
        it has none. pin: draw the masks into pinned host memory."""
        return StepDraws(self, generator, draws, pin) if draws else None

    def _take(self, generator: torch.Generator, key: Tuple
              ) -> Optional[_Plan]:
        """The plan in flight when it is for `key` and starts from the
        generator's state (a hit), else None; either way it leaves the
        flight."""
        plan, self._plan = self._plan, None
        if plan is not None and plan.key == key \
                and torch.equal(plan.start, generator.get_state()):
            trace.count("mask_plan_hits", 1)
            return plan
        trace.count("mask_plan_misses", 1)
        return None

    def _submit(self, state: torch.Tensor, draws: Sequence[Draw],
                key: Tuple, pin: bool) -> None:
        """Hand `draws` to the worker: one task each, in order, on a
        generator of their own set to `state`, then one that reads the
        state they leave. The buffers are made here, on the caller's
        thread."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(1, thread_name_prefix="mask-plan")
        gen = torch.Generator()
        gen.set_state(state)
        results = [self._pool.submit(d.fn, gen, _out(d, pin)) for d in draws]
        self._plan = _Plan(key, state, results,
                           self._pool.submit(gen.get_state))


class StepDraws:
    """The draws of one train-mode forward, taken in order by `take`."""

    def __init__(self, planner: MaskPlanner, generator: torch.Generator,
                 draws: Sequence[Draw], pin: bool):
        self._planner = planner
        self._gen = generator
        self._draws = list(draws)
        self._pin = pin
        self._key = (tuple(d.key for d in draws), pin)
        self._plan: Optional[_Plan] = None
        self._i = 0

    def take(self, kind):
        """The next draw, which must be of `kind`. The first take decides
        hit or miss; the last submits the next step's plan."""
        i = self._i
        if i >= len(self._draws) or self._draws[i].kind != kind:
            raise RuntimeError(f"mask draw {i} taken as {kind!r}; the step's "
                               f"draws are {[d.kind for d in self._draws]}")
        draw = self._draws[i]
        if i == 0:
            self._plan = self._planner._take(self._gen, self._key)
        if self._plan is not None:
            value = self._plan.results[i].result()
        else:
            value = draw.fn(self._gen, _out(draw, self._pin))
        self._i = i + 1
        if self._i == len(self._draws):
            if self._plan is not None:
                self._gen.set_state(self._plan.end.result())
            self._planner._submit(self._gen.get_state(), self._draws,
                                  self._key, self._pin)
        return value
