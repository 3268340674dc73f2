"""Durable task log: append-only records of fired/completed events.

Two interchangeable backends behind one tiny API:

* :class:`MemoryLog` — thread-safe dicts, for in-proc runtimes and tests;
* :class:`SqliteLog` — one sqlite file in WAL mode shared by *every*
  process of a distributed Session (each process opens its own
  connection).  ``INSERT OR IGNORE`` on the ``(key, kind)`` primary key
  makes appends idempotent, so at-least-once logging never double-counts.

Records are 6-tuples ``(key, kind, eid, src, dst, blob)``:

* ``key``  — the event's idempotency key, globally unique (minted once at
  fire time; a replay re-uses the original key).  On the hot path the key
  is a cheap ``(src, dst, eid, n, tag)`` tuple; the sqlite backend
  stringifies it deterministically at write time (off the hot path), so
  the same event always lands under the same TEXT key no matter which
  process logged it;
* ``kind`` — ``"fired"`` (blob = pickled payload), ``"completed"``
  (a task consumed the event to completion), ``"replayed"`` (the recovery
  coordinator re-fired it; ``dst`` is the new target, latest wins);
* ``eid``/``src``/``dst`` — channel and endpoints.

Nothing here runs on the fire hot path: the runtime appends through a
:class:`BatchLogger`, whose dedicated writer thread drains the queue and
lands whole batches with one backend call — the same coalescing idiom as
``SocketTransport``'s per-peer writer threads.
"""
from __future__ import annotations

import os
import pickle
import sqlite3
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# key is a str or the hot-path (src, dst, eid, n, tag) tuple; blob is
# bytes, None, or (fired records only) a raw *immutable* payload — the
# sqlite backend pickles it at write time, the in-memory backend keeps
# it raw (immutables are safe to share; replay fires them by reference)
Record = Tuple[object, str, str, int, int, Optional[bytes]]

FIRED = "fired"
COMPLETED = "completed"
REPLAYED = "replayed"

KEY_FMT = "%d>%d/%s#%d@%s"    # deterministic tuple-key stringification


def key_str(key) -> str:
    """Canonical string form of an idempotency key (identity on str)."""
    return key if type(key) is str else KEY_FMT % key


def expand(rec) -> Record:
    """Full 6-tuple record from a possibly-compact queue item.  The
    BatchLogger hot paths enqueue compact forms whose tuple key
    ``(src, dst, eid, n, tag)`` already carries the endpoints:

    * ``(key, blob)``       — fired;
    * ``(key, rank, None)`` — completed (``rank``: the consuming rank,
      which differs from the key's dst for a replayed event);
    * anything of length 6  — already a full record.

    A fourth compact form, ``(rank, [Event, ...])`` with an *int* first
    element — a whole just-consumed batch, one completion per event
    carrying an ``_dkey`` — expands to *many* records, so the backends
    unpack it in their own loops rather than here.
    """
    n = len(rec)
    if n == 2:
        key = rec[0]
        return (key, FIRED, key[2], key[0], key[1], rec[1])
    if n == 3:
        key = rec[0]
        return (key, COMPLETED, key[2], key[0], rec[1], None)
    return rec


class MemoryLog:
    """In-memory task log (single-process durability: survives rank death,
    not process death).  Thread-safe; append-idempotent like the sqlite
    backend.

    The write side is a raw journal: ``append_many`` is one C-speed
    ``list.extend`` — no per-record Python work at all while the program
    runs.  All reconciliation (keying fired/completed/replayed into
    dicts, the pending diff) is deferred to the read side, which only
    runs at replay or inspection time — never on the steady-state path.
    This is the classic journal/recovery split: pay nothing per record
    now, pay once proportional to history when a failure actually needs
    the log.  Each scan folds the journal prefix into the dicts and
    frees it, so repeated reads stay incremental; the writer also
    compacts when the raw journal passes a size threshold, so a long
    run doesn't pin every consumed Event (and its payload) forever.
    """

    kind = "memory"

    #: raw-journal records held before the writer-side compaction scan
    COMPACT_AT = 100_000

    def __init__(self):
        self._mu = threading.Lock()
        self._recs: list = []               # raw compact-or-full items
        self._fired: Dict[object, tuple] = {}
        self._done: Dict[object, tuple] = {}
        self._replayed: Dict[object, Record] = {}
        self._targets: Dict[str, set] = {}  # eid -> ranks ever targeted

    def append_many(self, records: Sequence[Record]) -> None:
        with self._mu:
            recs = self._recs
            recs.extend(records)
            if len(recs) > self.COMPACT_AT:
                self._scan_locked()

    def _scan_locked(self) -> None:
        """Fold journalled records into the keyed dicts (caller holds
        ``_mu``).  First record wins for fired/completed (append-
        idempotent, like sqlite's INSERT OR IGNORE); latest wins for
        replayed (INSERT OR REPLACE)."""
        recs = self._recs
        if not recs:
            return
        fired = self._fired
        done = self._done
        rep = self._replayed
        targets = self._targets
        for rec in recs:
            L = len(rec)
            if L == 2:
                key = rec[0]
                if type(key) is int:          # (rank, events) consumed batch
                    for ev in rec[1]:
                        k = ev.__dict__.get("_dkey")
                        if k is None:
                            # identity-keyed (reference-delivery fire): a
                            # completion only counts for a journalled fire
                            # — other channels' events flow through the
                            # same hook and must not leave ghost records
                            k = id(ev)
                            if k not in fired and k not in rep:
                                continue
                        if k not in done:
                            done[k] = (k, COMPLETED, ev.eid, ev.source,
                                       key, None)
                    continue
                # compact fired
                if key not in fired:
                    fired[key] = rec
                    targets.setdefault(key[2], set()).add(key[1])
            elif L == 3:
                key = rec[0]
                if type(key) is tuple or type(key) is str:
                    done.setdefault(key, rec)  # compact completed
                else:
                    # identity-keyed fired: (Event, dst, blob); keep the
                    # Event in the record — it pins the id against reuse
                    k = id(key)
                    if k not in fired:
                        fired[k] = rec
                        targets.setdefault(key.eid, set()).add(rec[1])
            elif rec[1] == FIRED:
                key = rec[0]
                if key not in fired:
                    fired[key] = tuple(rec)
                    targets.setdefault(rec[2], set()).add(rec[4])
            elif rec[1] == COMPLETED:
                done.setdefault(rec[0], tuple(rec))
            else:                             # latest replay target wins
                rec = tuple(rec)
                key = rec[0]
                if rec[5] is None:            # keep the fired blob
                    prev = rep.get(key)
                    src_rec = fired.get(key, prev)
                    if src_rec is not None:
                        if (len(src_rec) == 3
                                and type(src_rec[0]) is not tuple
                                and type(src_rec[0]) is not str):
                            rec = rec[:5] + (src_rec[2],)
                        else:
                            rec = rec[:5] + (expand(src_rec)[5],)
                rep[key] = rec
                targets.setdefault(rec[2], set()).add(rec[4])
        self._recs = []

    def count(self, kind: str) -> int:
        with self._mu:
            self._scan_locked()
            return len({FIRED: self._fired, COMPLETED: self._done,
                        REPLAYED: self._replayed}[kind])

    def eid_targets(self) -> Dict[str, set]:
        """Channel -> set of ranks ever targeted on it.  Replay uses this
        to redirect a dead target onto a rank known to consume the
        channel, instead of blindly round-robining over all survivors."""
        with self._mu:
            self._scan_locked()
            return {eid: set(ts) for eid, ts in self._targets.items()}

    def pending(self, rank: Optional[int] = None) -> List[Record]:
        """Fired-or-replayed records with no completion (latest target
        wins); restricted to records touching ``rank`` when given."""
        with self._mu:
            self._scan_locked()
            done = self._done
            out: Dict[object, Record] = {}
            for key, rec in self._fired.items():
                if key not in done:
                    if (len(rec) == 3 and type(rec[0]) is not tuple
                            and type(rec[0]) is not str):
                        ev = rec[0]       # identity-keyed (Event, dst, blob)
                        out[key] = (key, FIRED, ev.eid, ev.source,
                                    rec[1], rec[2])
                    else:
                        out[key] = expand(rec)
            for key, rec in self._replayed.items():
                if key not in done:
                    out[key] = rec
            recs = list(out.values())
        if rank is not None:
            recs = [r for r in recs if r[3] == rank or r[4] == rank]
        # str() keeps the order total when tuple and string keys coexist
        recs.sort(key=lambda r: str(r[0]))
        return recs

    def close(self) -> None:
        pass


class SqliteLog:
    """Sqlite-backed task log, sharable across OS processes.

    WAL journaling + a busy timeout let every rank process append
    concurrently; one connection per :class:`SqliteLog` instance, guarded
    by a lock (the batching logger is the only steady writer anyway)."""

    kind = "sqlite"

    def __init__(self, path: str, busy_timeout_s: float = 10.0):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._mu = threading.Lock()
        self._db = sqlite3.connect(path, timeout=busy_timeout_s,
                                   check_same_thread=False)
        with self._mu:
            cur = self._db
            cur.execute("PRAGMA journal_mode=WAL")
            cur.execute("PRAGMA synchronous=NORMAL")
            cur.execute(
                "CREATE TABLE IF NOT EXISTS records ("
                " key TEXT NOT NULL, kind TEXT NOT NULL,"
                " eid TEXT NOT NULL, src INTEGER NOT NULL,"
                " dst INTEGER NOT NULL, blob BLOB,"
                " PRIMARY KEY (key, kind))")
            cur.commit()

    @staticmethod
    def _canon(rec: Record) -> Record:
        """Expanded record with a TEXT key and a BLOB-safe payload:
        compact queue items are expanded, tuple keys stringified, raw
        (deferred-snapshot) payloads pickled.  Runs on the BatchLogger
        writer thread — never on the fire hot path."""
        rec = expand(rec)
        key, blob = rec[0], rec[5]
        if type(key) is str and (blob is None or type(blob) is bytes):
            return rec
        if type(key) is not str:
            key = KEY_FMT % key
        if blob is not None and type(blob) is not bytes:
            blob = pickle.dumps(blob, pickle.HIGHEST_PROTOCOL)
        return (key,) + tuple(rec[1:5]) + (blob,)

    def append_many(self, records: Sequence[Record]) -> None:
        canon = []
        for rec in records:
            if len(rec) == 2 and type(rec[0]) is int:
                # (rank, events) consumed batch: one completion per event
                # that carries an idempotency key
                rank = rec[0]
                for ev in rec[1]:
                    key = ev.__dict__.get("_dkey")
                    if key is not None:
                        canon.append((key_str(key), COMPLETED, ev.eid,
                                      ev.source, rank, None))
            else:
                canon.append(self._canon(rec))
        records = canon
        plain = [r for r in records if r[1] != REPLAYED]
        replayed = [r for r in records if r[1] == REPLAYED]
        with self._mu:
            if plain:
                self._db.executemany(
                    "INSERT OR IGNORE INTO records VALUES (?,?,?,?,?,?)",
                    plain)
            if replayed:                          # latest replay target wins
                self._db.executemany(
                    "INSERT OR REPLACE INTO records VALUES (?,?,?,?,?,?)",
                    replayed)
            self._db.commit()

    def count(self, kind: str) -> int:
        with self._mu:
            row = self._db.execute(
                "SELECT COUNT(*) FROM records WHERE kind=?",
                (kind,)).fetchone()
        return int(row[0])

    def eid_targets(self) -> Dict[str, set]:
        """See :meth:`MemoryLog.eid_targets`."""
        with self._mu:
            rows = self._db.execute(
                "SELECT DISTINCT eid, dst FROM records WHERE kind IN (?, ?)",
                (FIRED, REPLAYED)).fetchall()
        out: Dict[str, set] = {}
        for eid, dst in rows:
            out.setdefault(eid, set()).add(dst)
        return out

    def pending(self, rank: Optional[int] = None) -> List[Record]:
        """See :meth:`MemoryLog.pending` — same contract, SQL diff."""
        q = ("SELECT key, kind, eid, src, dst, blob FROM records r"
             " WHERE kind IN (?, ?) AND NOT EXISTS"
             "  (SELECT 1 FROM records c WHERE c.key = r.key"
             "   AND c.kind = ?)")
        with self._mu:
            rows = self._db.execute(q, (FIRED, REPLAYED,
                                        COMPLETED)).fetchall()
        out: Dict[str, Record] = {}
        for row in rows:                          # fired first, then replayed
            if row[1] == FIRED or row[0] not in out:
                out[row[0]] = tuple(row)
        for row in rows:
            if row[1] == REPLAYED:
                blob = out[row[0]][5] if row[5] is None else row[5]
                out[row[0]] = tuple(row[:5]) + (blob,)
        recs = list(out.values())
        if rank is not None:
            recs = [r for r in recs if r[3] == rank or r[4] == rank]
        recs.sort(key=lambda r: r[0])
        return recs

    def close(self) -> None:
        with self._mu:
            try:
                self._db.commit()
                self._db.close()
            except sqlite3.Error:
                pass


def open_log(path: Optional[str]):
    """Backend factory: a shared sqlite file when ``path`` is given, else
    the in-memory backend."""
    return SqliteLog(path) if path else MemoryLog()


class BatchLogger:
    """Off-hot-path batching appender (the ``SocketTransport`` writer-thread
    idiom): :meth:`append` only enqueues — a dedicated daemon thread drains
    the queue and lands each run of records with one ``append_many`` call.
    Batches grow naturally while a backend write is in flight, so burst
    cost is amortised and the firing task never waits on sqlite."""

    def __init__(self, log):
        self.log = log
        self._q: list = []
        self._cv = threading.Condition()
        self._busy = False           # a backend write is in flight
        self._closed = False
        self.appends = 0             # records landed in the backend
        self.batches = 0             # append_many calls
        self.queue_max = 0           # high-water of the queue, at drain time
        # THE hot path: producers call the list's C methods directly —
        # no Python frame, no lock, no notify.  The journal needs
        # bandwidth, not per-record latency: the writer self-wakes on a
        # 50ms backstop and drains whatever accumulated, so sustained
        # load lands in big batches instead of lock-stepping producer
        # and writer (a notify-per-append variant measured ~24% on the
        # fire A/B).  Only flush() — the replay coordinator's barrier —
        # wakes the writer eagerly.  A list, not a deque: the writer
        # drains with one slice + one del (both single C ops, atomic
        # under the GIL against concurrent appends) instead of a
        # per-record popleft loop.
        self.append = self._q.append
        self.append_many = self._q.extend
        self._t = threading.Thread(target=self._writer, daemon=True,
                                   name="edat-durable-log")
        self._t.start()

    def _writer(self) -> None:
        q = self._q
        while True:
            with self._cv:
                while not q and not self._closed:
                    self._cv.wait(0.05)   # flush()/close() wake it early
                if not q and self._closed:
                    return
                self._busy = True
            n = len(q)
            if n > self.queue_max:
                self.queue_max = n
            batch = q[:n]                 # appends past n are next round's
            del q[:n]
            try:
                if batch:
                    self.log.append_many(batch)
            finally:
                with self._cv:
                    self._busy = False
                    self.appends += len(batch)
                    self.batches += 1 if batch else 0
                    self._cv.notify_all()

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until every record enqueued so far has landed in the
        backend (True) or the timeout passed (False)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            self._cv.notify()
            while self._q or self._busy:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(0.05, left))
        return True

    def close(self, timeout: float = 5.0) -> None:
        self.flush(timeout)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._t.join(timeout)
        self.log.close()
