"""EDAT core: event-driven asynchronous tasks (Brown, Brown & Bull, 2020).

Public API (v2) — one ``Session`` entry point with typed channels::

    from repro_torch import edat

    GRAD = edat.Channel("grad", payload=dict)

    def main(ctx):
        if ctx.rank == 0:
            ctx.submit(task1)                       # no dependencies
        else:
            ctx.submit(task2, deps=[(0, GRAD)])

    edat.run(main, ranks=2)                         # threads-as-ranks
    edat.run(main, ranks=4, procs=2,
             transport="socket")                    # OS processes over TCP

Structured workloads implement the ``edat.Program`` protocol
(``start(ctx)`` plus declared ``channels``) and return results through
``Session.gather()``.  The v1 idiom (``edat.Runtime(n).run(main)``)
still works but emits a DeprecationWarning — construction, bootstrap,
spawn and teardown now belong to :class:`repro_torch.api.Session`.

This package holds the runtime itself: events/deps (:mod:`.event`),
per-rank scheduling (:mod:`.scheduler`), indexed routing
(:mod:`.router`), ranks/progress/termination/timers (:mod:`.runtime`),
the pluggable transport interface (:mod:`.transport`) and collective
patterns (:mod:`.patterns`).
"""
from .event import ALL, ANY, SELF, RANK_FAILED, Dep, Event, dep
from .router import EventRouter
from .runtime import (Context, EdatDeadlockError, EdatTaskError,
                      RankDiedError, Runtime, TaskHandle, TimerHandle)
from .scheduler import Scheduler
from .transport import InProcTransport, Message, Transport

__all__ = [
    "ALL", "ANY", "SELF", "RANK_FAILED", "Dep", "Event", "dep",
    "Context", "Runtime", "EdatDeadlockError", "EdatTaskError",
    "RankDiedError", "TaskHandle", "TimerHandle",
    "Scheduler", "EventRouter", "InProcTransport", "Message", "Transport",
]
