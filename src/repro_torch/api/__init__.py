"""repro_torch.api — the v2 public surface, re-exported as ``repro_torch.edat``.

One declarative entry point (:class:`Session` / :func:`run`), typed
event channels (:class:`Channel`), task handles and driver-side futures
over the non-blocking event core, plus re-exports of everything a
program touches: core primitives, collective patterns, timers, and the
distribution layer.  This package ships ``py.typed`` — the surface is
fully annotated for downstream type checking.

::

    from repro_torch import edat

    TOKEN = edat.Channel("token", payload=int)

    def main(ctx: edat.Context) -> None:
        left = (ctx.rank - 1) % ctx.n_ranks
        ctx.submit_persistent(relay, deps=[(left, TOKEN)])
        if ctx.rank == 0:
            ctx.fire(1, TOKEN, 1)

    edat.run(main, ranks=4)                             # threads
    edat.run(main, ranks=4, procs=2, transport="socket")  # processes
"""
from typing import Any

# -- core primitives ---------------------------------------------------------
from repro_torch.core import (ALL, ANY, SELF, RANK_FAILED, Context, Dep,
                              EdatDeadlockError, EdatTaskError, Event,
                              EventRouter, InProcTransport, Message, Runtime,
                              Scheduler, TaskHandle, TimerHandle, Transport,
                              dep)
# -- collective patterns (previously deep-import only) -----------------------
from repro_torch.core.patterns import (allreduce, barrier, tree_reduce,
                                       wait_barrier)
# -- distribution layer ------------------------------------------------------
from repro_torch.net import ProcessGroup, SocketTransport, launch_processes
# -- v2 surface --------------------------------------------------------------
from .channels import Channel
from .program import DeferredProgram, Program, deferred
from .session import Future, RankDiedError, Session, run


def fire_after(ctx: Context, delay: float, target: Any, eid: str,
               data: Any = None) -> TimerHandle:
    """Machine-generated timer event (paper §VII): fire ``eid`` at
    ``target`` after ``delay`` seconds.  Facade-level convenience for
    ``ctx.fire_after`` — cancellable via the returned
    :class:`TimerHandle`."""
    return ctx.fire_after(delay, target, eid, data)


__all__ = [
    # v2 entry points
    "Session", "run", "Channel", "Program", "DeferredProgram", "deferred",
    "Future", "RankDiedError", "TaskHandle",
    # core primitives
    "ALL", "ANY", "SELF", "RANK_FAILED", "Dep", "Event", "dep",
    "Context", "Runtime", "EdatDeadlockError", "EdatTaskError",
    "TimerHandle", "Scheduler", "EventRouter",
    "InProcTransport", "Message", "Transport",
    # collectives + timers
    "barrier", "wait_barrier", "allreduce", "tree_reduce", "fire_after",
    # distribution layer
    "ProcessGroup", "SocketTransport", "launch_processes",
]
