"""repro_torch.durable — durable task log, automated replay, elastic join.

Opt-in fault tolerance for any EDAT program, generalising the elastic
trainer's bespoke recovery (ROADMAP: "Durable task queue"):

* every fire on a durable channel is stamped with an idempotency key
  (``Event._dkey``) and logged *fired* through a batching writer thread;
  when a task consumes the event to completion a *completed* record
  follows;
* on ``RANK_FAILED`` a recovery coordinator (co-located with rank 0)
  diffs the log against completions and re-fires the dead rank's
  unconsumed events onto surviving ranks — or onto a replacement process
  that elastically joined the running Session (``net.bootstrap_join``);
* replay is **at-least-once**: an event consumed but SIGKILLed before
  its *completed* record flushed is re-fired, so durable consumers
  dedup by a key in the payload (see the README contract).  Replayed
  events carry the coordinator's rank as ``Event.source`` — durable
  consumers should depend on ``(ANY, eid)``, not on a pinned source.

Enable with ``Session(durable=True)`` (every user channel) or
``Channel(..., durable=True)`` (just that channel).
"""
from __future__ import annotations

import itertools
import pickle
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from .log import (BatchLogger, COMPLETED, FIRED, MemoryLog, REPLAYED, Record,
                  SqliteLog, open_log)

__all__ = [
    "DurableState", "BatchLogger", "MemoryLog", "SqliteLog", "open_log",
    "FIRED", "COMPLETED", "REPLAYED",
]


class DurableState:
    """Per-runtime durable-mode state: the log + logger, the set of
    durable channels, and the recovery coordinator.

    One instance per :class:`~repro_torch.core.runtime.Runtime`; in a
    distributed Session every process has one (they share the sqlite
    file) but only the process hosting rank 0 runs replay.
    """

    def __init__(self, rt, spec: Optional[dict] = None):
        spec = dict(spec or {})
        self.rt = rt
        self.eids = {str(c) for c in spec.get("channels") or ()}
        self._wcache: Dict[str, bool] = {}   # eid -> wants() verdict
        self.all = bool(spec.get("all", not self.eids))
        self.join_timeout = float(spec.get("join_timeout", 0.0))
        self.settle = float(spec.get("settle", 0.3))
        self.log = open_log(spec.get("path"))
        self.logger = BatchLogger(self.log)
        self._counter = itertools.count()
        # Distinguishes incarnations: a replacement process restarts the
        # counter for the same ranks, so bare (src,dst,eid,n) would collide.
        self._tag = uuid.uuid4().hex[:6]
        # Prebound hot-path quint for Runtime._fire's durable branch:
        # (counter next, incarnation tag, queue append, dead probe,
        # identity-keys flag).  Both transports keep rank liveness in a
        # plain in-place-mutated list, so the probe can be the list's C
        # __getitem__ instead of a Python method frame.  When the
        # transport delivers events by reference (no serialisation) and
        # the log lives in this process, the fire path skips key minting
        # entirely: the journal item carries the Event itself and the
        # object's identity is the idempotency key (see MemoryLog) —
        # explicit keys are only stamped on replayed re-fires.
        dl = getattr(rt.transport, "_dead", None)
        dead = dl.__getitem__ if type(dl) is list else rt.transport.is_dead
        idkeys = (not rt.transport.serializes) and self.log.kind == "memory"
        self._hot = (self._counter.__next__, self._tag, self.logger.append,
                     dead, idkeys)
        self._join_cv = threading.Condition()
        self._busy = 0               # live replay threads (termination veto)
        self._handled: set = set()   # dead ranks already being replayed
        self.replays: List[Dict] = []  # [{dead_rank, channel, events}, ...]
        self._replay_cbs: List[Callable] = []

    # ---------------------------------------------------------------- fire
    def wants(self, eid: str) -> bool:
        w = self._wcache.get(eid)
        if w is None:
            w = self._wcache[eid] = (
                eid in self.eids
                or (self.all and not eid.startswith("__")))
        return w

    def add_eids(self, eids) -> None:
        self.eids.update(str(e) for e in eids)
        self._wcache.clear()

    def next_key(self, src: int, dst: int, eid: str):
        """Idempotency key: a cheap tuple on the hot path (the sqlite
        backend stringifies deterministically at write time — see
        ``log.key_str``)."""
        return (src, dst, eid, next(self._counter), self._tag)

    def on_fired(self, key, eid: str, src: int, dst: int, blob) -> None:
        self.logger.append((key, FIRED, eid, src, dst, blob))

    def on_consumed(self, rank: int, events) -> None:
        """Scheduler hook: events just consumed to completion on ``rank``."""
        self.consumed_hook(rank)(events)

    def consumed_hook(self, rank: int):
        """Per-scheduler completion hook (a closure, not a bound method:
        this runs once per task, so every attribute hop it doesn't take
        matters).  It enqueues the whole just-consumed batch as one
        ``(rank, events)`` item — no per-event loop, no key extraction,
        no record tuples on the task thread; the log backends unpack
        ``Event._dkey`` per event at scan/write time instead.  The
        dead-rank guard keeps a zombie task on a simulated-dead rank
        (kill_rank lets the in-flight task finish) from logging its
        inputs completed — its output fires are dropped, so its inputs
        must stay *pending* or the in-flight item silently vanishes from
        the replay diff."""
        ap = self.logger.append
        dead = self._hot[3]
        def hook(events, _ap=ap, _dead=dead, _rank=rank):
            if not _dead(_rank):
                _ap((_rank, events))
        return hook

    # -------------------------------------------------------------- replay
    def add_replay_callback(self, fn: Callable[[int, bool, int], None]):
        """``fn(dead_rank, revived, n_events)`` runs after each replay."""
        self._replay_cbs.append(fn)

    def busy(self) -> bool:
        return self._busy > 0

    def note_rank_failed(self, dead: int) -> None:
        """Called synchronously from the failure-detection path; spawns the
        replay thread.  The ``_busy`` bump happens *before* the caller
        pokes the termination detector, so the run can't be declared
        quiescent between detection and replay."""
        if 0 not in self.rt._sched:      # coordinator lives beside rank 0
            return
        with self._join_cv:
            if dead in self._handled:
                return
            self._handled.add(dead)
            self._busy += 1
        threading.Thread(target=self._replay, args=(dead,), daemon=True,
                         name="edat-durable-replay-%d" % dead).start()

    def note_joined(self, rank: int) -> None:
        """A replacement process re-hosted ``rank``; unblock any replay
        waiting out ``join_timeout`` and re-arm failure handling for it."""
        with self._join_cv:
            self._handled.discard(rank)
            self._join_cv.notify_all()

    def _replay(self, dead: int) -> None:
        rt = self.rt
        revived = False
        try:
            self.logger.flush()
            if self.join_timeout > 0:
                deadline = time.monotonic() + self.join_timeout
                with self._join_cv:
                    while dead in self._handled:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._join_cv.wait(min(0.1, left))
                    revived = dead not in self._handled
            if self.settle > 0:
                # Survivors' completed-batches need a beat to land in the
                # shared log before we diff it.
                time.sleep(self.settle)
            self.logger.flush()
            pend = self.log.pending(rank=dead)
            if pend:
                plan = rt._durable_plan(
                    pend, prefer=dead if revived else None,
                    targets=self.log.eid_targets())
                if plan:
                    # Journal the replay BEFORE re-firing: a record that is
                    # replayed-but-not-yet-sent when this process dies is
                    # still pending in the log, so the next replay pass
                    # re-fires it — the reverse order could send an event
                    # whose replay record never landed.
                    src0 = min(rt._sched)
                    self.logger.append_many(
                        [(key, REPLAYED, eid, src0, dst, None)
                         for key, eid, dst, _blob in plan])
                    self.logger.flush()
                    rt._durable_send(plan)
                    per_ch: Dict[str, int] = {}
                    for _key, eid, _dst, _blob in plan:
                        per_ch[eid] = per_ch.get(eid, 0) + 1
                    for eid, n in sorted(per_ch.items()):
                        self.replays.append(
                            {"dead_rank": dead, "channel": eid,
                             "events": n})
            for cb in list(self._replay_cbs):
                cb(dead, revived, len(pend))
        except Exception as exc:        # surface through the run, don't hang
            rt._durable_error(exc)
        finally:
            with self._join_cv:
                self._busy -= 1
                self._join_cv.notify_all()
            try:
                rt._poke(force=True)
            except Exception:
                pass

    # ------------------------------------------------------------- export
    def snapshot(self) -> Dict:
        return {
            "log": self.log.kind,
            "appends": self.logger.appends,
            "batches": self.logger.batches,
            "queue_max": self.logger.queue_max,
            "replays": [dict(r) for r in self.replays],
        }

    def close(self) -> None:
        self.logger.close()

    @staticmethod
    def blob(data) -> bytes:
        """Eager payload snapshot — durable payloads must pickle."""
        return pickle.dumps(data, pickle.HIGHEST_PROTOCOL)
