"""Events — the unit of interaction in EDAT (paper §II.B).

An event is fired from a source rank to a target rank, labelled with a string
event identifier (EID), optionally carrying payload data.  Firing is
*fire-and-forget*: the payload is copied at fire time so the caller may reuse
its buffers immediately (paper §II.B).  ``ref=True`` reproduces the paper's
``EDAT_ADDRESS`` type: the reference itself is the payload (used for the
shared-local-data pattern of paper Listing 10).
"""
from __future__ import annotations

import copy as _copy
import dataclasses
import itertools
from typing import Any

import numpy as np


class _Wildcard:
    """Singleton wildcard ranks (paper: EDAT_SELF / EDAT_ANY / EDAT_ALL)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"EDAT_{self.name}"


#: Event originates from / targets the calling rank itself.
SELF = _Wildcard("SELF")
#: Dependency wildcard: matching EID from any source rank.
ANY = _Wildcard("ANY")
#: Broadcast target / all-ranks dependency (collectives, barriers; paper §II.D).
ALL = _Wildcard("ALL")

#: Reserved EID prefix for machine-generated events (paper §VII further work:
#: timers, resource/hardware events).  User code may *consume* these but the
#: runtime is the only producer.
SYS_PREFIX = "__edat."
RANK_FAILED = SYS_PREFIX + "rank_failed"
TIMER_CANCELLED = SYS_PREFIX + "timer_cancelled"

_uid = itertools.count()


def copy_payload(data: Any) -> Any:
    """Deep-copy an event payload (fire-and-forget semantics).

    Arrays (numpy or anything exposing ``__array__``, e.g. ``jax.Array``) are
    materialised as fresh host numpy arrays; containers recurse; immutable
    scalars pass through.
    """
    if data is None or isinstance(data, (bool, int, float, complex, str, bytes, frozenset)):
        return data
    if isinstance(data, np.ndarray):
        return data.copy()
    if hasattr(data, "__array__") and not isinstance(data, (list, tuple, dict)):
        return np.asarray(data).copy()
    if isinstance(data, tuple):
        return tuple(copy_payload(x) for x in data)
    if isinstance(data, list):
        return [copy_payload(x) for x in data]
    if isinstance(data, dict):
        return {k: copy_payload(v) for k, v in data.items()}
    return _copy.deepcopy(data)


@dataclasses.dataclass
class Event:
    """A delivered event (paper's ``EDAT_Event``): payload + metadata."""

    data: Any
    source: int
    eid: str
    persistent: bool = False
    #: per-(src,dst) monotonically increasing sequence, for FIFO assertions
    seq: int = -1
    uid: int = dataclasses.field(default_factory=lambda: next(_uid))

    @property
    def n_elements(self) -> int:
        d = self.data
        if d is None:
            return 0
        if isinstance(d, np.ndarray):
            return int(d.size)
        if isinstance(d, (list, tuple)):
            return len(d)
        return 1

    @property
    def dtype(self) -> str:
        d = self.data
        if d is None:
            return "none"
        if isinstance(d, np.ndarray):
            return str(d.dtype)
        return type(d).__name__

    def clone(self) -> "Event":
        return Event(
            data=copy_payload(self.data),
            source=self.source,
            eid=self.eid,
            persistent=self.persistent,
            seq=self.seq,
        )


@dataclasses.dataclass(frozen=True)
class Dep:
    """A task's event dependency: ``(source, eid)`` (paper §II.A).

    ``source`` is an int rank, :data:`ANY`, :data:`ALL` or :data:`SELF`
    (resolved to the submitting rank at submission time).

    After wildcard expansion (SELF resolved, ALL expanded per-rank) a dep is
    either *exact* — indexable under the stable ``key`` ``(source, eid)`` —
    or an ANY-source *wildcard*, indexable under ``eid`` alone.  The event
    router uses this split to route deliveries without scanning every
    registered consumer.
    """

    source: Any
    eid: str

    @property
    def key(self) -> tuple:
        """Stable index key for exact deps: ``(source, eid)``."""
        return (self.source, self.eid)

    @property
    def is_any(self) -> bool:
        """True for an ANY-source wildcard dep (matches every source)."""
        return self.source is ANY

    def matches(self, ev: Event) -> bool:
        if self.eid != ev.eid:
            return False
        return self.source is ANY or self.source == ev.source


def dep(source: Any, eid: str) -> Dep:
    """Convenience constructor mirroring the paper's ``<source, id>`` pairs."""
    return Dep(source, eid)
