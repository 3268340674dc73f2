"""The ``Program`` protocol: what a Session runs.

A program is any object with a ``start(ctx)`` SPMD attach point —
``start`` is called once per hosted rank by the session's runtime, and
the object may additionally declare:

* ``channels`` — an iterable of :class:`~repro_torch.api.channels.Channel`
  (or ids) naming the program's event vocabulary.  When declared, the
  session enforces it: firing or depending on an undeclared id raises
  ``KeyError`` at the call site (``__``-prefixed internal ids exempt).
* ``result()`` — called on the process hosting rank 0 *after* clean
  global termination; whatever it returns is what
  :meth:`repro_torch.api.session.Session.gather` hands back to the driver
  (for socket sessions it must pickle).

Plain ``main(ctx)`` callables are accepted everywhere a program is — an
anonymous program with no declared channels and no result.

For socket sessions the program must reach the spawned child processes.
Either pass a picklable program instance, or wrap a (picklable,
module-level) factory with :func:`deferred` so each child builds its own
program — once per *process*, shared by all co-located ranks — which is
how per-process state that cannot pickle (jitted functions, locks,
large regenerable graphs) gets constructed where it is used.
"""
from __future__ import annotations

from typing import Any, Callable, Protocol, runtime_checkable

from repro_torch.core.runtime import Context


@runtime_checkable
class Program(Protocol):
    """Structural protocol: anything with an SPMD ``start(ctx)``."""

    def start(self, ctx: Context) -> None:
        """Attach one rank of the program to the running session."""
        ...  # pragma: no cover - protocol


class DeferredProgram:
    """A program built lazily by ``factory(*args, **kwargs)``.

    For inproc sessions the factory runs once in the driver process; for
    socket sessions it runs once per spawned child process (co-located
    ranks share the instance).  The factory and its arguments must be
    picklable for socket transports (module-level callables + plain
    data), the program it returns need not be.
    """

    __slots__ = ("factory", "args", "kwargs")

    def __init__(self, factory: Callable[..., Any], args: tuple,
                 kwargs: dict):
        self.factory = factory
        self.args = args
        self.kwargs = kwargs

    def build(self) -> Any:
        return self.factory(*self.args, **self.kwargs)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        name = getattr(self.factory, "__name__", repr(self.factory))
        return f"deferred({name}, ...)"


def deferred(factory: Callable[..., Any], *args: Any,
             **kwargs: Any) -> DeferredProgram:
    """Defer program construction to the process that runs it."""
    return DeferredProgram(factory, args, kwargs)
