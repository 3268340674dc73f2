"""Shared plumbing for the always-on runtime metrics layer.

The counters themselves live where the events flow — per-eid dicts inside
each :class:`~repro_torch.core.scheduler.Scheduler` (bumped under the locks the
hot paths already hold) and per-peer vectors inside
:class:`~repro_torch.net.SocketTransport`.  This module holds what is common to
every layer:

* :func:`payload_nbytes` — the cheap payload-size estimate the fire path
  charges to a channel (a handful of ``type`` checks, never a pickle);
* :func:`merge_metrics` — fold per-process metric snapshots (one per
  spawned rank process, or a single in-proc runtime) into the canonical
  ``{"channels", "ranks", "transport"}`` shape that ``Session.stats()``
  exposes and :func:`repro_torch.insights.analyze` consumes;
* :class:`RunStats` — the stats mapping itself.  A plain ``dict`` in
  every respect, but *callable* (``s.stats()`` ≡ ``s.stats``) so the
  accessor idiom and the attribute idiom are both valid.

Channel entry schema (one per event id)::

    {"fires": int,        # events fired on this channel (at the source)
     "bytes": int,        # estimated payload bytes fired
     "wire_fires": int,   # fires whose target lives in another process
     "deliveries": int,   # events delivered to a rank's scheduler
     "consumed": int,     # events consumed to completion by tasks/waiters
     "queued_max": int}   # max(deliveries - consumed): backpressure depth

Rank entry schema::

    {"tasks_executed": int, "busy_s": float,
     "quorum_wait_s": float}   # seconds OTHER ranks spent waiting for the
                               # last event of a multi-dependency frame —
                               # attributed to the rank that fired it, so a
                               # straggler shows a dominant share
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

try:
    import numpy as _np
except ImportError:  # pragma: no cover - numpy is a de-facto hard dep
    _np = None

_FIXED8 = frozenset((bool, int, float))
_SIZED = frozenset((str, bytes, bytearray))
# Payload types safe to hand to multiple consumers without a defensive
# copy: nothing can mutate them behind anyone's back.
_IMMUTABLE = frozenset((bool, int, float, complex, str, bytes, type(None)))


def payload_nbytes(data: Any) -> int:
    """Cheap (non-recursive beyond one level) payload size estimate.

    Exact for the shapes that matter to the insight rules — scalars,
    strings/bytes, numpy arrays, and shallow containers of those — and a
    flat per-item guess otherwise.  Deliberately never pickles: this runs
    on the fire hot path.
    """
    if data is None:
        return 0
    t = type(data)
    if t in _FIXED8:
        return 8
    if t is complex:
        return 16
    if t in _SIZED:
        return len(data)
    if _np is not None:
        if t is _np.ndarray:
            return int(data.nbytes)
        if isinstance(data, _np.generic):
            return int(data.nbytes)
    if t in (list, tuple, set, frozenset):
        n = 0
        for v in data:
            tv = type(v)
            if tv in _FIXED8:
                n += 8
            elif tv in _SIZED:
                n += len(v)
            elif _np is not None and tv is _np.ndarray:
                n += int(v.nbytes)
            else:
                n += 64
        return n
    if t is dict:
        n = 0
        for v in data.values():
            tv = type(v)
            if tv in _FIXED8:
                n += 8
            elif tv in _SIZED:
                n += len(v)
            elif _np is not None and tv is _np.ndarray:
                n += int(v.nbytes)
            else:
                n += 64
        return n
    return 64


class RunStats(dict):
    """Run statistics: a plain dict that is also callable.

    ``Session.stats`` has always been indexable (``s.stats["run_seconds"]``);
    making it callable lets the structured accessor read naturally
    (``s.stats()["channels"]``) without breaking a single existing caller.
    """

    def __call__(self) -> "RunStats":
        return self


def _empty_channel() -> Dict[str, int]:
    return {"fires": 0, "bytes": 0, "wire_fires": 0,
            "deliveries": 0, "consumed": 0, "queued_max": 0}


def _empty_rank() -> Dict[str, Any]:
    return {"tasks_executed": 0, "busy_s": 0.0, "quorum_wait_s": 0.0}


def merge_metrics(parts: Iterable[Tuple[int, Dict[str, Any]]]
                  ) -> Dict[str, Any]:
    """Fold per-process metric snapshots into one canonical view.

    ``parts`` is ``[(lead_rank, snapshot)]`` — one snapshot per process
    (from :meth:`repro_torch.core.runtime.Runtime.metrics`), keyed by the
    process's lead rank so per-peer transport detail stays attributable.
    Counters sum, high-water marks take the max, and per-rank entries
    (each rank executes in exactly one process, but quorum-wait seconds
    are *attributed* to remote ranks by their consumers) sum field-wise.
    """
    channels: Dict[str, Dict[str, int]] = {}
    ranks: Dict[int, Dict[str, Any]] = {}
    transport: Dict[str, Any] = {}
    durable: Dict[str, Any] = {}
    for lead, m in parts:
        if not m:
            continue
        d = m.get("durable")
        if d:
            durable.setdefault("log", d.get("log"))
            for k in ("appends", "batches"):
                durable[k] = durable.get(k, 0) + d.get(k, 0)
            durable["queue_max"] = max(durable.get("queue_max", 0),
                                       d.get("queue_max", 0))
            durable.setdefault("replays", []).extend(d.get("replays") or ())
        for eid, ch in (m.get("channels") or {}).items():
            agg = channels.setdefault(eid, _empty_channel())
            for k in ("fires", "bytes", "wire_fires", "deliveries",
                      "consumed"):
                agg[k] += ch.get(k, 0)
            agg["queued_max"] = max(agg["queued_max"],
                                    ch.get("queued_max", 0))
        for r, rk in (m.get("ranks") or {}).items():
            agg = ranks.setdefault(int(r), _empty_rank())
            agg["tasks_executed"] += rk.get("tasks_executed", 0)
            agg["busy_s"] += rk.get("busy_s", 0.0)
            agg["quorum_wait_s"] += rk.get("quorum_wait_s", 0.0)
            if "trace" in rk:
                agg.setdefault("trace", []).extend(rk["trace"])
                agg["trace_dropped"] = (agg.get("trace_dropped", 0)
                                        + rk.get("trace_dropped", 0))
        t = m.get("transport")
        if t:
            transport.setdefault("kind", t.get("kind"))
            if "coalesce" in t:
                transport.setdefault("coalesce", t["coalesce"])
            for k in ("wire_events_sent", "wire_events_recv",
                      "loopback_events", "wire_bytes", "writes", "dropped"):
                if k in t:
                    transport[k] = transport.get(k, 0) + t[k]
            if "sendq_max" in t:
                transport["sendq_max"] = max(transport.get("sendq_max", 0),
                                             t["sendq_max"])
            for p, pm in (t.get("peers") or {}).items():
                transport.setdefault("peers", {})[f"{lead}->{p}"] = dict(pm)
    out = {"channels": channels, "ranks": ranks, "transport": transport}
    if durable:
        out["durable"] = durable
    return out
