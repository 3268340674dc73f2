"""Collective patterns over EDAT primitives.

The paper sketches a naive all-to-one reduction (Listing 5) and notes a
"more complex collective algorithm, such as a tree-based approach, would
work equally well".  These helpers provide both, plus the non-blocking
barrier of Listing 6, as reusable library code.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Optional

from .event import ALL, ANY, SELF, Dep, Event
from .runtime import Context


def barrier(ctx: Context, name: str, task: Callable) -> None:
    """Non-blocking barrier (paper Listing 6): ``task`` runs once every
    rank has fired its arrival event."""
    ctx.submit(task, deps=[(ALL, f"__bar.{name}")])
    ctx.fire(ALL, f"__bar.{name}")


def wait_barrier(ctx: Context, name: str) -> None:
    """Blocking barrier built on ``wait`` (pauses the calling task)."""
    ctx.fire(ALL, f"__bar.{name}")
    ctx.wait([(ALL, f"__bar.{name}")])


def allreduce(ctx: Context, name: str, value: Any, combine: Callable,
              on_result: Callable[[Context, Any], None]) -> None:
    """Naive all-to-all reduction (paper Listing 5 generalised): every rank
    fires its value to everyone; a task with an ALL dependency combines."""

    def task(ctx2, events: List[Event]):
        acc = events[0].data
        for e in events[1:]:
            acc = combine(acc, e.data)
        on_result(ctx2, acc)

    ctx.submit(task, deps=[(ALL, f"__ar.{name}")])
    # one batched fire: a single transport round-trip per destination
    ctx.fire_batch([(r, f"__ar.{name}", value) for r in range(ctx.n_ranks)])


def tree_reduce(ctx: Context, name: str, value: Any, combine: Callable,
                on_result: Callable[[Context, Any], None],
                root: int = 0) -> None:
    """Binomial-tree reduction to ``root``: O(log n) event rounds instead
    of the naive O(n) fan-in.  ``on_result`` runs on the root only."""
    n = ctx.n_ranks
    me = (ctx.rank - root) % n
    levels = max(1, math.ceil(math.log2(n))) if n > 1 else 0

    state = {"acc": value, "lvl": 0}

    def advance(ctx2):
        while True:
            lvl = state["lvl"]
            if lvl >= levels:
                if me == 0:
                    on_result(ctx2, state["acc"])
                return
            bit = 1 << lvl
            if me & bit:
                # sender at this level: fire partial to the parent and stop
                parent = ((me - bit) + root) % n
                ctx2.fire(parent, f"__tr.{name}.{lvl}", state["acc"])
                return
            if me + bit < n:
                # receiver: need the child's partial before advancing
                child = ((me + bit) + root) % n

                def on_child(ctx3, events, _lvl=lvl):
                    state["acc"] = combine(state["acc"], events[0].data)
                    state["lvl"] = _lvl + 1
                    advance(ctx3)

                ctx2.submit(on_child, deps=[(child, f"__tr.{name}.{lvl}")])
                return
            state["lvl"] = lvl + 1

    advance(ctx)
