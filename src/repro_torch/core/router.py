"""Indexed event routing: ``(source, eid)`` -> ordered consumer lists.

The seed scheduler offered every arriving event to *all* registered
consumers in registration order — O(consumers) per delivery, quadratic for
the common many-persistent-tasks pattern (paper §IV.A).  The router keeps
two indices instead:

* an *exact* table keyed by ``(source, eid)`` for resolved deps (SELF and
  ALL are expanded before registration, paper §II.D), and
* a *wildcard* side-table keyed by ``eid`` for ANY-source deps.

Each index bucket holds consumers in registration order, so offering an
event to the merge of the two buckets (by ``reg_order``) preserves the
paper's §II.B precedence rule exactly: "a task submitted before another
task ... has a higher precedence in the consumption of events".  Within a
consumer, dependency-order delivery (§II.A) and persistent-frame refill
(§IV.A) are unchanged — the router only decides *which* consumer is offered
the event, via the same ``try_fill`` protocol the linear scan used.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from .event import Event


class EventRouter:
    """Routes events to consumers in registration-precedence order.

    Consumers are any objects with ``deps`` (a list of expanded
    :class:`~repro_torch.core.event.Dep`), an int ``reg_order`` assigned at
    registration, and a ``try_fill(ev) -> bool`` method.  All methods must
    be called under the owning scheduler's lock.
    """

    __slots__ = ("_exact", "_any")

    def __init__(self):
        self._exact: Dict[Tuple[int, str], List] = {}
        self._any: Dict[str, List] = {}

    def register(self, consumer) -> None:
        """Index ``consumer`` under each distinct dep key.

        Consumers must be registered in increasing ``reg_order`` so each
        bucket stays sorted by precedence (appends preserve this).
        """
        exact_keys = set()
        any_eids = set()
        for d in consumer.deps:
            if d.is_any:
                any_eids.add(d.eid)
            else:
                exact_keys.add(d.key)
        for k in exact_keys:
            self._exact.setdefault(k, []).append(consumer)
        for eid in any_eids:
            self._any.setdefault(eid, []).append(consumer)

    def unregister(self, consumer) -> None:
        """Drop ``consumer`` from every bucket it was indexed under."""
        for table, key in self._keys_of(consumer):
            bucket = table.get(key)
            if bucket is None:
                continue
            try:
                bucket.remove(consumer)
            except ValueError:
                pass
            if not bucket:
                del table[key]

    def _keys_of(self, consumer) -> Iterator[tuple]:
        seen = set()
        for d in consumer.deps:
            k = (1, d.eid) if d.is_any else (0, d.key)
            if k in seen:
                continue
            seen.add(k)
            yield (self._any, d.eid) if d.is_any else (self._exact, d.key)

    def candidates(self, source: int, eid: str) -> Iterator:
        """Consumers that could accept a ``(source, eid)`` event, merged
        from the exact and wildcard buckets by registration precedence."""
        ex = self._exact.get((source, eid))
        an = self._any.get(eid)
        if not an:
            yield from (ex or ())
            return
        if not ex:
            yield from an
            return
        i = j = 0
        while i < len(ex) and j < len(an):
            if ex[i].reg_order <= an[j].reg_order:
                yield ex[i]
                i += 1
            else:
                yield an[j]
                j += 1
        yield from ex[i:]
        yield from an[j:]

    def offer(self, ev: Event) -> Optional[object]:
        """Offer ``ev`` to candidates in precedence order; return the
        consumer that accepted it, or None (caller stores the event)."""
        for c in self.candidates(ev.source, ev.eid):
            if c.try_fill(ev):
                return c
        return None

    def stats(self) -> dict:
        return {
            "exact_keys": len(self._exact),
            "wildcard_eids": len(self._any),
        }
