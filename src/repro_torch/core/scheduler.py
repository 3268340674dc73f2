"""Per-rank scheduler: dependency matching, ready queue, workers, locks.

Implements the paper's semantics precisely:

* FIFO task execution policy (paper §II.F);
* earlier-registered consumers have precedence in consuming events
  (paper §II.B "a task submitted before another task ... has a higher
  precedence in the consumption of events");
* events delivered to a task in *dependency order*, not arrival order
  (paper §II.A);
* persistent tasks keep multiple partially-filled dependency *frames* in
  flight (paper §IV.A);
* persistent events re-fire locally upon consumption (paper §IV.A);
* ``wait`` parks the task, frees the worker (a replacement worker thread is
  spawned so the configured concurrency is preserved) and releases/reacquires
  named locks (paper §IV.B/C);
* named locks auto-release at task end (paper §IV.C).

Delivery is routed through an :class:`~repro_torch.core.router.EventRouter`
index — O(matching consumers) per event instead of O(all consumers) — and
every blocked path (``wait``, named locks, idle workers, slot re-acquisition)
blocks on a condition variable that is notified on the exact state change,
rather than sleep-polling.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .event import ALL, ANY, SELF, Dep, Event
from .router import EventRouter

_inst_uid = itertools.count()

#: per-rank cap on opt-in trace records; beyond it, records are counted
#: (``trace_dropped``) instead of stored, bounding memory on long runs
TRACE_CAP = 50_000


class Slot:
    """One dependency slot of a consumer (one expected event)."""

    __slots__ = ("dep", "event")

    def __init__(self, dep: Dep):
        self.dep = dep
        self.event: Optional[Event] = None

    @property
    def filled(self) -> bool:
        return self.event is not None


def expand_deps(deps: List[Dep], rank: int, n_ranks: int) -> List[Dep]:
    """Resolve SELF and expand ALL into one dep per rank (paper §II.D)."""
    out: List[Dep] = []
    for d in deps:
        if d.source is SELF:
            out.append(Dep(rank, d.eid))
        elif d.source is ALL:
            out.extend(Dep(r, d.eid) for r in range(n_ranks))
        else:
            out.append(d)
    return out


class Frame:
    """A (possibly partial) set of dependency slots (paper §IV.A)."""

    __slots__ = ("slots", "birth", "t_first", "last_src")
    _birth = itertools.count()

    def __init__(self, deps: List[Dep]):
        self.slots = [Slot(d) for d in deps]
        self.birth = next(Frame._birth)
        # quorum tracking (multi-slot frames only): when the first slot
        # filled, and which source rank filled the most recent slot — the
        # metrics layer charges the frame's completion lag to that rank
        self.t_first: Optional[float] = None
        self.last_src = -1

    def note(self, ev: Event) -> None:
        if len(self.slots) > 1:
            if self.t_first is None:
                self.t_first = time.monotonic()
            self.last_src = ev.source

    def try_fill(self, ev: Event) -> bool:
        for s in self.slots:
            if not s.filled and s.dep.matches(ev):
                s.event = ev
                if len(self.slots) > 1:     # note(), inlined: hot path
                    if self.t_first is None:
                        self.t_first = time.monotonic()
                    self.last_src = ev.source
                return True
        return False

    @property
    def complete(self) -> bool:
        return all(s.filled for s in self.slots)

    def events(self) -> List[Event]:
        return [s.event for s in self.slots]  # dependency order (paper §II.A)


class Consumer:
    """Base: an ordered claim on future events (task or waiter)."""

    __slots__ = ("deps", "name", "reg_order", "quorum")

    def __init__(self, deps: List[Dep], name: Optional[str]):
        self.deps = deps
        self.name = name
        self.reg_order = -1
        # (t_first, last_src) of the most recently popped frame — read by
        # the scheduler's metrics layer right after pop_ready()
        self.quorum: Optional[Tuple[Optional[float], int]] = None

    def try_fill(self, ev: Event) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError

    def pop_ready(self) -> Optional[List[Event]]:  # pragma: no cover
        raise NotImplementedError

    @property
    def done(self) -> bool:  # transitory consumers leave the registry when done
        raise NotImplementedError


class TaskConsumer(Consumer):
    """A submitted task (transitory or persistent)."""

    __slots__ = ("fn", "persistent", "frames", "fired")

    def __init__(self, fn, deps, name, persistent):
        super().__init__(deps, name)
        self.fn = fn
        self.persistent = persistent
        self.frames: List[Frame] = [Frame(deps)] if deps else []
        self.fired = False  # transitory + zero-dep: executes exactly once

    def try_fill(self, ev: Event) -> bool:
        # earliest frame missing a matching slot (paper §IV.A)
        for f in self.frames:
            if f.try_fill(ev):
                return True
        if self.persistent:
            f = Frame(self.deps)
            if f.try_fill(ev):
                self.frames.append(f)
                return True
        return False

    def pop_ready(self) -> Optional[List[Event]]:
        for i, f in enumerate(self.frames):
            if f.complete:
                self.frames.pop(i)
                if self.persistent and not self.frames:
                    self.frames.append(Frame(self.deps))
                # only multi-slot frames stamp t_first; skip the tuple
                # allocation for the common single-dep case
                self.quorum = (None if f.t_first is None
                               else (f.t_first, f.last_src))
                return f.events()
        return None

    @property
    def done(self) -> bool:
        return not self.persistent and not self.frames

    def unmet(self) -> bool:
        """True if a transitory task still awaits events (deadlock check)."""
        return not self.persistent and bool(self.frames)


class Waiter(Consumer):
    """A parked task inside ``wait`` (paper §IV.B)."""

    __slots__ = ("frame", "cv", "woken", "parked")

    def __init__(self, deps, cv: threading.Condition):
        super().__init__(deps, None)
        self.frame = Frame(deps)
        self.cv = cv
        self.woken = False
        self.parked = False

    def try_fill(self, ev: Event) -> bool:
        return self.frame.try_fill(ev)

    def pop_ready(self) -> Optional[List[Event]]:
        if self.frame.complete and not self.woken:
            self.woken = True
            f = self.frame
            self.quorum = (None if f.t_first is None
                           else (f.t_first, f.last_src))
            return f.events()
        return None

    @property
    def done(self) -> bool:
        return self.woken


class Instance:
    """A task execution instance on the ready queue."""

    __slots__ = ("fn", "events", "name", "uid", "mrec")

    def __init__(self, fn, events, name, mrec=None):
        self.fn = fn
        self.events = events
        self.name = name
        self.uid = next(_inst_uid)
        # the delivery-time metrics record ([deliv, consumed, pending,
        # qmax]) for single-dep instances dispatched straight from a
        # delivery: _run consume-counts through it without re-probing
        self.mrec = mrec


class _TaskTLS(threading.local):
    def __init__(self):
        self.locks: Optional[set] = None       # names held by current task
        self.exit_after_task = False           # replacement-worker shedding
        self.in_task = False


class Scheduler:
    """One rank's scheduler (paper: one 'process')."""

    def __init__(self, rank: int, n_ranks: int, runtime, target_workers: int,
                 progress_mode: str = "thread", metrics: bool = True,
                 trace: bool = False):
        self.rank = rank
        self.n_ranks = n_ranks
        self.runtime = runtime
        self.target = max(1, target_workers)
        self.progress_mode = progress_mode

        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)

        self._consumers: List[Consumer] = []   # registration order (enumeration)
        self._router = EventRouter()           # (source, eid) -> consumers
        self._reg_counter = itertools.count()
        self._store: Dict[Tuple[int, str], deque] = {}
        self._store_eids: Dict[str, set] = {}  # eid -> non-empty store keys
        self._arrival = itertools.count()      # store-arrival order (for ANY)
        self._ready: deque = deque()

        self._running = 0
        self._parked = 0
        self._resuming = 0                     # woken waiters not yet resumed
        self._loops = 0                        # worker threads in their loop
        self._mail = False                     # transport notify (worker mode)
        self._mail_hooked = False              # transport has a real notify
        self._shutdown = False
        self._main_done = False

        # termination counters (user events only)
        self.sent = 0
        self.received = 0

        # named locks: name -> (owner thread id | None)
        self._locks: Dict[str, Any] = {}
        self._lock_cv = threading.Condition(self._mu)

        self._tls = _TaskTLS()
        self._threads: List[threading.Thread] = []
        self._executed = 0  # stats

        # -- metrics (always-on by default; every bump happens under a lock
        # the hot path already holds, so "off" only saves the dict ops) --
        self.metrics_on = metrics
        self.trace_on = trace
        self._m_fires: Dict[str, List[int]] = {}   # eid -> [n, bytes, wire]
        self._m_deliv: Dict[str, List[int]] = {}   # eid -> [deliv, consumed,
        #                                                    pending, qmax]
        self._m_quorum: Dict[int, float] = {}      # src rank -> wait seconds
        self._busy_s = 0.0
        self._trace: List[tuple] = []
        self._trace_dropped = 0

        #: durable-mode consume hook (repro_torch.durable): called OUTSIDE the
        #: scheduler lock with the just-consumed events, on every path that
        #: retires them — task completion (_run), wait() returns, and
        #: retrieve_any.  None when durable mode is off (zero hot-path cost).
        self.on_consumed: Optional[Callable[[List[Event]], None]] = None

    # ------------------------------------------------------------------ util
    def _spawn_worker(self):
        t = threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"edat-w{self.rank}")
        self._threads.append(t)
        t.start()

    def start(self):
        for _ in range(self.target):
            self._spawn_worker()

    def stop(self):
        with self._mu:
            self._shutdown = True
            self._cv.notify_all()
            self._lock_cv.notify_all()
        for c in list(self._consumers):
            if isinstance(c, Waiter):
                with c.cv:
                    c.cv.notify_all()

    def join(self, timeout: float = 5.0):
        for t in self._threads:
            t.join(timeout)

    def _idle_locked(self) -> bool:
        return (not self._ready and self._running == 0
                and self._resuming == 0 and self._main_done)

    def _notify_mail(self):
        """Transport notify hook (worker-poll mode): a message arrived.

        The flag-up fast path is safe without the lock: if we observe
        ``_mail`` already set, the worker that will clear it polls *after*
        clearing, and our message was enqueued *before* this check — so that
        poll cannot miss it.  This keeps senders off the receiving
        scheduler's mutex during bursts."""
        if self._mail:
            return
        with self._mu:
            self._mail = True
            self._cv.notify_all()

    # -------------------------------------------------------------- delivery
    def deliver(self, ev: Event) -> None:
        self.deliver_many((ev,))

    def deliver_many(self, evs) -> None:
        """Process arriving events under one lock round-trip: offer each to
        the router (precedence order), else store.  Caller: progress thread,
        polling worker, or a distributed transport's reader thread
        (push-mode delivery) — thread-safe under the scheduler lock."""
        ready: List[Instance] = []
        wake: List[Waiter] = []
        refires: List[Event] = []
        with self._mu:
            self.received += len(evs)
            if self.trace_on:
                self._trace_add_locked(
                    ("recv", time.monotonic(), len(evs), evs[0].eid))
            if self.metrics_on:
                # account runs of equal eids and offer their events in one
                # pass: coalesced deliveries are near-always single-channel
                # batches, so this costs one dict probe per run — and the
                # run's record rides along to _offer_locked so single-dep
                # task instances consume-count in _run without re-probing
                md = self._m_deliv
                if len(evs) == 1:          # single event: the common case
                    ev = evs[0]
                    rec = md.get(ev.eid)
                    if rec is None:
                        rec = md[ev.eid] = [0, 0, 0, 0]
                    rec[0] += 1
                    rec[2] += 1
                    if rec[2] > rec[3]:
                        rec[3] = rec[2]
                    self._offer_locked(ev, ready, wake, refires, rec)
                else:
                    i, n = 0, len(evs)
                    while i < n:
                        eid = evs[i].eid
                        j = i + 1
                        while j < n and evs[j].eid == eid:
                            j += 1
                        rec = md.get(eid)
                        if rec is None:
                            rec = md[eid] = [0, 0, 0, 0]
                        k = j - i
                        rec[0] += k
                        rec[2] += k
                        if rec[2] > rec[3]:
                            rec[3] = rec[2]
                        while i < j:
                            self._offer_locked(evs[i], ready, wake,
                                               refires, rec)
                            i += 1
            else:
                for ev in evs:
                    self._offer_locked(ev, ready, wake, refires)
            if ready:
                self._ready.extend(ready)
                self._cv.notify_all()
            # count refires as sent while still holding the lock so the
            # termination detector never sees balanced counters with a
            # re-fire still pending (Mattern consistency)
            self.sent += len(refires)
            idle = self._idle_locked()
        for w in wake:
            with w.cv:
                w.cv.notify_all()
        for ev in refires:
            self.runtime._send_refire(self.rank, ev)
        if idle and not refires:
            self.runtime._poke()

    def _offer_locked(self, ev: Event, ready: List[Instance],
                      wake: List[Waiter], refires: List[Event],
                      mrec: Optional[List[int]] = None) -> None:
        c = self._router.offer(ev)
        if c is not None:
            if ev.persistent:
                refires.append(ev)  # re-fires locally on consumption (§IV.A)
            self._drain_consumer_locked(c, ready, wake, mrec)
            if isinstance(c, TaskConsumer) and c.persistent:
                # a dispatched frame opened fresh slots (paper §IV.A refill):
                # top them up from stored events, which would otherwise sit
                # unconsumed until another matching event happened to arrive
                self._fill_from_store_locked(c, ready, wake, refires)
            return
        self._store_put_locked(ev)

    def _drain_consumer_locked(self, c: Consumer, ready: List[Instance],
                               wake: List[Waiter],
                               mrec: Optional[List[int]] = None) -> None:
        while True:
            evs = c.pop_ready()
            if evs is None:
                break
            if self.metrics_on:
                q = c.quorum        # set only for multi-slot frames
                if q is not None:
                    # charge the frame's completion lag (first slot filled ->
                    # last slot filled, i.e. now) to the rank whose event
                    # arrived last: a straggler accumulates a dominant share
                    lag = time.monotonic() - q[0]
                    if lag > 0.0:
                        self._m_quorum[q[1]] = (
                            self._m_quorum.get(q[1], 0.0) + lag)
            if isinstance(c, TaskConsumer):
                # a single-slot frame's event eid equals the offered eid, so
                # the delivery record (if any) is the right consume record
                ready.append(Instance(c.fn, evs, c.name,
                                      mrec if len(evs) == 1 else None))
            else:
                # waiters resume immediately: their events are consumed now
                # (task instances are counted at completion in _run)
                if self.metrics_on:
                    self._count_consumed_locked(evs)
                if c.parked:
                    # keep the rank non-idle until the woken thread resumes
                    self._resuming += 1
                wake.append(c)  # Waiter: events already in its frame
        if c.done:
            self._remove_consumer_locked(c)

    def _remove_consumer_locked(self, c: Consumer) -> None:
        try:
            self._consumers.remove(c)
        except ValueError:
            pass  # satisfied from store before registration
        self._router.unregister(c)

    # ----------------------------------------------------------------- store
    def _store_put_locked(self, ev: Event) -> None:
        key = (ev.source, ev.eid)
        ev.seq_store = next(self._arrival)  # type: ignore[attr-defined]
        dq = self._store.get(key)
        if dq is None:
            dq = self._store[key] = deque()
            self._store_eids.setdefault(ev.eid, set()).add(key)
        dq.append(ev)

    def _store_pop_locked(self, key: Tuple[int, str]) -> Event:
        dq = self._store[key]
        ev = dq.popleft()
        if not dq:
            del self._store[key]
            keys = self._store_eids.get(key[1])
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._store_eids[key[1]]
        return ev

    def _take_from_store_locked(self, dep: Dep) -> Optional[Event]:
        """Oldest stored event matching ``dep`` (ANY scans only the store
        keys carrying its eid, via the eid side-index)."""
        best_key, best_seq = None, None
        if dep.source is ANY:
            for key in self._store_eids.get(dep.eid, ()):
                dq = self._store.get(key)
                if dq:
                    seq = dq[0].seq_store  # type: ignore[attr-defined]
                    if best_seq is None or seq < best_seq:
                        best_key, best_seq = key, seq
        else:
            if self._store.get(dep.key):
                best_key = dep.key
        if best_key is None:
            return None
        return self._store_pop_locked(best_key)

    def _fill_from_store_locked(self, c: Consumer, ready: List[Instance],
                                wake: List[Waiter],
                                refires: List[Event]) -> None:
        """Greedily satisfy a new consumer from stored events (keeps firing
        new frames for persistent tasks until the store runs dry)."""
        progress = True
        while progress:
            progress = False
            if isinstance(c, TaskConsumer):
                frames = c.frames if c.frames else (
                    [Frame(c.deps)] if c.persistent and c.deps else [])
                if c.persistent and c.deps and not c.frames:
                    c.frames = frames
            for f in (c.frames if isinstance(c, TaskConsumer) else [c.frame]):
                for s in f.slots:
                    if s.filled:
                        continue
                    ev = self._take_from_store_locked(s.dep)
                    if ev is not None:
                        s.event = ev
                        f.note(ev)
                        if ev.persistent:
                            refires.append(ev)
                        progress = True
            self._drain_consumer_locked(c, ready, wake)
            if c.done or not isinstance(c, TaskConsumer) or not c.persistent:
                break

    # ------------------------------------------------------------ submission
    def submit(self, fn: Callable, deps: List[Dep], name: Optional[str],
               persistent: bool) -> None:
        deps = expand_deps(deps, self.rank, self.n_ranks)
        c = TaskConsumer(fn, deps, name, persistent)
        ready: List[Instance] = []
        wake: List[Waiter] = []
        refires: List[Event] = []
        with self._mu:
            c.reg_order = next(self._reg_counter)
            if not deps and not persistent:
                # zero-dependency transitory task: immediately eligible
                ready.append(Instance(fn, [], name))
            else:
                self._fill_from_store_locked(c, ready, wake, refires)
                if not c.done:
                    self._consumers.append(c)
                    self._router.register(c)
            for inst in ready:
                self._ready.append(inst)
            if ready:
                self._cv.notify_all()
            self.sent += len(refires)
        for w in wake:
            with w.cv:
                w.cv.notify_all()
        for ev in refires:
            self.runtime._send_refire(self.rank, ev)

    def remove_task(self, name: str) -> bool:
        """Remove a named (typically persistent) task (paper §IV.A)."""
        with self._mu:
            for c in self._consumers:
                if c.name == name:
                    self._remove_consumer_locked(c)
                    return True
        return False

    # ------------------------------------------------------- wait / retrieve
    def wait(self, deps: List[Dep]) -> List[Event]:
        """Paper §IV.B ``edatWait``: pause task until deps satisfied.

        Blocks on a per-waiter condition variable that ``deliver`` notifies
        when the frame completes — no poll quantum on the wake path.
        """
        deps = expand_deps(deps, self.rank, self.n_ranks)
        cv = threading.Condition()
        w = Waiter(deps, cv)
        ready: List[Instance] = []
        wake: List[Waiter] = []
        refires: List[Event] = []
        evs: Optional[List[Event]] = None
        in_task = False
        with self._mu:
            self._fill_from_store_locked(w, ready, wake, refires)
            assert not ready
            self.sent += len(refires)
            if w.frame.complete:
                w.woken = True
                evs = w.frame.events()
            else:
                w.reg_order = next(self._reg_counter)
                self._consumers.append(w)
                self._router.register(w)
                in_task = self._tls.in_task
                if in_task:
                    # park: free the running slot; spawn a replacement worker
                    # so the configured concurrency is preserved (paper
                    # §IV.B).  The parking thread leaves the pool permanently
                    # (it exits after its task completes) — only on the first
                    # park.
                    self._running -= 1
                    if not self._tls.exit_after_task:
                        self._tls.exit_after_task = True
                        self._loops -= 1
                        self._spawn_worker()
                w.parked = True
                self._parked += 1
                self._cv.notify_all()
        for ev in refires:
            self.runtime._send_refire(self.rank, ev)
        if evs is not None:
            oc = self.on_consumed
            if oc is not None:
                oc(evs)
            return evs
        held = self._release_all_locks()
        with cv:
            while not w.frame.complete and not self._shutdown:
                cv.wait()
        with self._mu:
            if in_task:
                # re-acquire a running slot before resuming (paper: "a worker
                # will continue to run the task"); woken by task completions
                while self._running >= self.target and not self._shutdown:
                    self._cv.wait()
                self._running += 1
            self._parked -= 1
            if w.woken:
                self._resuming -= 1
        self._reacquire_locks(held)
        if self._shutdown and not w.frame.complete:
            raise RuntimeError("EDAT shut down while task was waiting")
        evs = w.frame.events()
        oc = self.on_consumed
        if oc is not None:
            oc(evs)
        return evs

    def retrieve_any(self, deps: List[Dep]) -> List[Event]:
        """Paper §IV.B ``edatRetrieveAny``: non-blocking subset retrieval."""
        deps = expand_deps(deps, self.rank, self.n_ranks)
        got: List[Event] = []
        refires: List[Event] = []
        with self._mu:
            for d in deps:
                ev = self._take_from_store_locked(d)
                if ev is not None:
                    if ev.persistent:
                        refires.append(ev)
                    got.append(ev)
            self.sent += len(refires)
            if self.metrics_on and got:
                self._count_consumed_locked(got)
        for ev in refires:
            self.runtime._send_refire(self.rank, ev)
        if got:
            oc = self.on_consumed
            if oc is not None:
                oc(got)
        return got

    # ----------------------------------------------------------------- locks
    def lock(self, name: str, blocking: bool = True) -> bool:
        me = threading.get_ident()
        with self._mu:
            if self._locks.get(name) == me:
                # reentrant acquisition: still record it so the lock is
                # auto-released at task end (paper §IV.C)
                if self._tls.locks is not None:
                    self._tls.locks.add(name)
                return True
            while self._locks.get(name) is not None:
                if not blocking:
                    return False
                self._lock_cv.wait()  # notified by unlock / shutdown
                if self._shutdown:
                    return False
            self._locks[name] = me
        if self._tls.locks is not None:
            self._tls.locks.add(name)
        return True

    def unlock(self, name: str) -> None:
        with self._mu:
            if self._locks.get(name) == threading.get_ident():
                self._locks[name] = None
                self._lock_cv.notify_all()
        if self._tls.locks is not None:
            self._tls.locks.discard(name)

    def test_lock(self, name: str) -> bool:
        return self.lock(name, blocking=False)

    def _release_all_locks(self) -> List[str]:
        held = sorted(self._tls.locks) if self._tls.locks else []
        for n in held:
            self.unlock(n)
        return held

    def _reacquire_locks(self, names: List[str]) -> None:
        for n in names:  # sorted order: deterministic, reduces deadlock risk
            self.lock(n)

    # --------------------------------------------------------------- workers
    def _worker_loop(self):
        with self._mu:
            self._loops += 1
        poll = self.progress_mode == "worker"
        busy_t0 = 0.0       # busy-span start stamp; 0.0 = currently idle
        while True:
            inst = None
            with self._mu:
                if self._loops > self.target or (
                        self._shutdown and not self._ready):
                    self._loops -= 1
                    if busy_t0:
                        self._busy_s += time.monotonic() - busy_t0
                    return
                if self._ready and self._running < self.target:
                    inst = self._ready.popleft()
                    self._running += 1
            if inst is None:
                if poll and self._poll_once():
                    continue
                with self._mu:
                    if busy_t0:
                        # idle transition: close the busy span (spans keep
                        # per-task timestamps off the execution hot path)
                        self._busy_s += time.monotonic() - busy_t0
                        busy_t0 = 0.0
                    if self._mail:
                        self._mail = False  # message raced our last poll
                    elif not self._ready and not self._shutdown:
                        # woken by: ready work, task completion, shutdown,
                        # or the transport notify hook (worker-poll mode).
                        # A poll-mode transport without a notify hook can't
                        # wake us on arrival: keep the seed's timed poll.
                        if poll and not self._mail_hooked:
                            self._cv.wait(0.002)
                        else:
                            self._cv.wait()
                continue
            if busy_t0 == 0.0 and self.metrics_on:
                busy_t0 = time.monotonic()
            self._run(inst)
            if self._tls.exit_after_task:
                # this thread left the pool when it parked (loops already
                # decremented); a replacement is looping in its stead
                self._tls.exit_after_task = False
                if busy_t0:
                    with self._mu:
                        self._busy_s += time.monotonic() - busy_t0
                return

    def _poll_once(self) -> bool:
        """Idle-worker progress polling (paper §II.F alternative mode)."""
        return self.runtime._progress_poll(self.rank)

    def _run(self, inst: Instance):
        ctx = self.runtime._ctx(self.rank)
        self._tls.locks = set()
        self._tls.in_task = True
        # busy time is span-based (idle->busy transitions in _worker_loop),
        # so per-task timestamps are only taken for the opt-in trace
        t0 = time.monotonic() if self.trace_on else 0.0
        try:
            inst.fn(ctx, inst.events)
        except Exception as e:  # noqa: BLE001 - report any task failure
            self.runtime._task_failed(self.rank, inst, e)
        finally:
            self._tls.in_task = False
            for n in sorted(self._tls.locks):
                self.unlock(n)  # auto-release (paper §IV.C)
            self._tls.locks = None
            dur = (time.monotonic() - t0) if self.trace_on else 0.0
            with self._mu:
                self._running -= 1
                self._executed += 1
                if self.metrics_on:
                    rec = inst.mrec       # consume accounting: the delivery
                    if rec is not None:   # record rode in on the instance
                        rec[1] += 1
                        rec[2] -= 1
                    else:                 # multi-dep / store-filled / 0-dep
                        md = self._m_deliv
                        for ev in inst.events:
                            rec = md.get(ev.eid)
                            if rec is None:
                                rec = md[ev.eid] = [0, 0, 0, 0]
                            rec[1] += 1
                            rec[2] -= 1
                if self.trace_on:
                    self._trace_add_locked(
                        ("task", t0, dur,
                         inst.name or getattr(inst.fn, "__name__", "?"),
                         len(inst.events)))
                self._cv.notify_all()
                idle = self._idle_locked()
            oc = self.on_consumed
            if oc is not None and inst.events:
                # completion record even if the task raised: the event WAS
                # consumed; the error aborts the whole run regardless
                oc(inst.events)
            if idle:
                self.runtime._poke()

    # --------------------------------------------------------------- metrics
    def count_fire_locked(self, eid: str, n: int, nbytes: int,
                          wire: int) -> None:
        """Charge ``n`` fires on channel ``eid`` (caller holds ``_mu`` —
        the fire paths bump this alongside ``sent``)."""
        rec = self._m_fires.get(eid)
        if rec is None:
            rec = self._m_fires[eid] = [0, 0, 0]
        rec[0] += n
        rec[1] += nbytes
        rec[2] += wire

    def _count_consumed_locked(self, evs) -> None:
        md = self._m_deliv
        for ev in evs:
            rec = md.get(ev.eid)
            if rec is None:
                rec = md[ev.eid] = [0, 0, 0, 0]
            rec[1] += 1
            rec[2] -= 1

    def _trace_add_locked(self, rec: tuple) -> None:
        if len(self._trace) < TRACE_CAP:
            self._trace.append(rec)
        else:
            self._trace_dropped += 1

    def metrics_snapshot(self) -> dict:
        """Consistent snapshot of this rank's counters (takes ``_mu``)."""
        with self._mu:
            out = {
                "fires": {e: tuple(v) for e, v in self._m_fires.items()},
                "deliveries": {e: tuple(v)
                               for e, v in self._m_deliv.items()},
                "quorum_wait_s": dict(self._m_quorum),
                "tasks_executed": self._executed,
                "busy_s": self._busy_s,
            }
            if self.trace_on:
                out["trace"] = list(self._trace)
                out["trace_dropped"] = self._trace_dropped
            return out

    # ---------------------------------------------------------- termination
    def set_main_done(self):
        with self._mu:
            self._main_done = True
            idle = self._idle_locked()
        if idle:
            self.runtime._poke()

    def status(self) -> dict:
        with self._mu:
            unmet = sum(1 for c in self._consumers
                        if isinstance(c, TaskConsumer) and c.unmet())
            stored_transitory = sum(
                sum(1 for e in dq if not e.persistent)
                for dq in self._store.values())
            return dict(
                sent=self.sent, received=self.received,
                idle=self._idle_locked(),
                parked=self._parked, unmet=unmet,
                stored=stored_transitory, executed=self._executed,
            )
