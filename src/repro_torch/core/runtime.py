"""EDAT runtime: ranks, progress, distributed termination, timers, failures.

``Runtime`` plays the role of the paper's library init/finalise pair
(§II, §II.E): it spawns one SPMD main thread per rank, runs progress (a
dedicated progress thread per rank, or idle-worker polling — both modes of
paper §II.F), and detects global termination with a Mattern-style
four-counter quiescence check driven through the transport itself.

Termination detection is *wakeup-driven*: schedulers poke an activity epoch
whenever a rank transitions to idle (and on timer/failure state changes),
and the detector blocks on that epoch instead of sleep-polling.  The
four-counter logic itself (two consecutive idle polls with globally
``sent == received`` and empty mailboxes) is unchanged.

A ``Runtime`` may host *all* ranks (threads-as-ranks over
:class:`InProcTransport`) or a subset of them (one OS process hosting one
*or several* ranks over :class:`repro_torch.net.SocketTransport`, declared via
the transport's ``local_ranks``; co-located ranks exchange messages
through the transport's in-process loopback).  In the distributed case
every cross-rank interaction —
status polling for the Mattern detector, the termination broadcast, task
failure propagation, detector wakeups — travels through the transport as
CONTROL messages; rank 0 owns the detector, the other processes block until
its ``terminate`` broadcast arrives.  Counter balancing uses the
transport's per-peer sent/received vectors restricted to the alive ranks,
so events exchanged with a failed process stay balanced without reading its
(unreachable) memory.

Beyond-paper (but anticipated in the paper's §VII "further work"): machine
generated events — timer events (``fire_after``) and rank-failure events
(``RANK_FAILED``) — and node-failure injection used by the fault-tolerant
trainer built on top.
"""
from __future__ import annotations

import functools
import heapq
import itertools
import pickle
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from .deprecation import warn_deprecated
from .event import (ALL, ANY, SELF, RANK_FAILED, SYS_PREFIX, TIMER_CANCELLED,
                    Dep, Event, copy_payload)
from .metrics import _FIXED8, _IMMUTABLE, payload_nbytes
from ..durable.log import FIRED
from .scheduler import Scheduler
from .transport import CONTROL, EVENT, InProcTransport, Message, Transport

DepLike = Union[Dep, Tuple[Any, str]]
FireLike = Union[Tuple[Any, str], Tuple[Any, str, Any]]


class EdatDeadlockError(RuntimeError):
    """Raised when the system is quiescent but the paper's termination
    conditions (§II.E) cannot be met: a transitory task has unmet
    dependencies, a task is parked forever, or transitory events remain
    unconsumed.  (The paper's library would hang; we diagnose.)"""


class EdatTaskError(RuntimeError):
    """A task raised; re-raised from :meth:`Runtime.run`."""


class RankDiedError(EdatTaskError):
    """A rank's process died (SIGKILL, crash, lost heartbeat) and the run
    cannot complete from this observer's point of view — notably when the
    dead rank is the termination coordinator (rank 0), whose terminate
    broadcast will never arrive.  Driver-side ``Future``s surface it; the
    process launcher treats it as an orderly child outcome (exit 0)."""


class TimerHandle:
    def __init__(self, runtime: "Runtime", tid: int):
        self._rt = runtime
        self.tid = tid

    def cancel(self) -> bool:
        """Cancel the timer.  True only if it had not yet fired."""
        return self._rt._cancel_timer(self.tid)


class TaskHandle:
    """Handle for a submitted task (v2 API): returned by ``ctx.submit`` /
    ``ctx.submit_persistent``.  ``remove()`` deregisters a *named* task
    (the paper's ``edatRemoveTask``); unnamed handles return False."""

    __slots__ = ("_sched", "rank", "name", "persistent")

    def __init__(self, sched: "Scheduler", name: Optional[str],
                 persistent: bool):
        self._sched = sched
        self.rank = sched.rank
        self.name = name
        self.persistent = persistent

    def remove(self) -> bool:
        """Remove the task from its rank's registry.  True iff it was
        still registered (requires the task to have been named)."""
        if self.name is None:
            return False
        return self._sched.remove_task(self.name)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        kind = "persistent" if self.persistent else "task"
        return f"TaskHandle({kind} {self.name!r} on rank {self.rank})"


class Context:
    """Per-rank public API — mirrors the paper's C API Pythonically.

    ===========================  =======================================
    paper                        here
    ===========================  =======================================
    ``edatGetRank``              ``ctx.rank``
    ``edatSubmitTask``           ``ctx.submit(fn, deps)``
    ``edatSubmitPersistentTask`` ``ctx.submit_persistent(fn, deps)``
    ``edatFireEvent``            ``ctx.fire(target, eid, data)``
    ``edatFirePersistentEvent``  ``ctx.fire(..., persistent=True)``
    ``edatWait``                 ``ctx.wait(deps)``
    ``edatRetrieveAny``          ``ctx.retrieve_any(deps)``
    ``edatLock/Unlock/TestLock`` ``ctx.lock / ctx.unlock / ctx.test_lock``
    ``EDAT_SELF/ANY/ALL``        ``edat.SELF / edat.ANY / edat.ALL``
    ``EDAT_ADDRESS``             ``ctx.fire(..., ref=True)``
    (batched fire)               ``ctx.fire_batch([(t, eid, data), ...])``
    ===========================  =======================================
    """

    def __init__(self, runtime: "Runtime", rank: int):
        self._rt = runtime
        self.rank = rank
        self.n_ranks = runtime.n_ranks
        #: declared channel table ({eid: Channel-or-None}), or None (no
        #: enforcement).  Set by :meth:`declare_channels` when a v2
        #: ``Program`` declares its typed channels.
        self._declared: Optional[Dict[str, Any]] = None

    # -- channels ------------------------------------------------------------
    def declare_channels(self, channels: Sequence[Any]) -> None:
        """Declare this rank's event vocabulary (v2 typed channels).

        Once declared, firing or depending on an *undeclared* event id
        raises ``KeyError`` immediately at the call site — the fast
        replacement for the silent never-matching typo of stringly-typed
        eids — and fires on a declared *typed* channel are payload-type
        checked even when addressed by the raw id string.  Ids starting
        with ``"__"`` (runtime-internal and machine-generated events,
        collective-pattern eids) are exempt."""
        self._declared = {str(c): (c if hasattr(c, "validate") else None)
                          for c in channels}
        dur_eids = [str(c) for c in channels if getattr(c, "durable", False)]
        if dur_eids:
            self._rt._durable_add(dur_eids)

    def _check_eid(self, eid: str) -> None:
        d = self._declared
        if d is not None and eid not in d and not eid.startswith("__"):
            raise KeyError(
                f"event id {eid!r} is not a declared channel of this "
                f"program (declared: {sorted(d)})")

    def _check_fire(self, eid: str, data: Any) -> None:
        """Declared-vocabulary enforcement for one fire: unknown id ->
        KeyError (via :meth:`_check_eid`, the one source of truth for the
        exemption rule); declared typed channel -> payload validation
        (also for raw-string addressing)."""
        self._check_eid(eid)
        ch = self._declared.get(eid)
        if ch is not None:
            ch.validate(data)

    def _pre_fire(self, eid: str, data: Any) -> None:
        """The one guard every fire path (fire / fire_batch / fire_after)
        runs: declared vocabulary enforcement when the program declared
        channels, else duck-typed payload validation for a typed Channel
        eid (a ``validate`` attribute — the core never imports
        :mod:`repro_torch.api`).  Plain-string fires without a declaration stay
        check-free."""
        if self._declared is not None:
            self._check_fire(eid, data)
        elif type(eid) is not str:
            validate = getattr(eid, "validate", None)
            if validate is not None:
                validate(data)

    def _check_deps(self, deps: List[Dep]) -> List[Dep]:
        """Declared-vocabulary check for dependency eids (submit / wait /
        retrieve_any paths); returns ``deps`` for call-site chaining."""
        if self._declared is not None:
            for dp in deps:
                self._check_eid(dp.eid)
        return deps

    # -- tasks ---------------------------------------------------------------
    def submit(self, fn: Callable, deps: Sequence[DepLike] = (),
               name: Optional[str] = None) -> TaskHandle:
        d = self._check_deps(_deps(deps))
        sched = self._rt._sched[self.rank]
        sched.submit(fn, d, name, False)
        return TaskHandle(sched, name, False)

    def submit_persistent(self, fn: Callable, deps: Sequence[DepLike],
                          name: Optional[str] = None) -> TaskHandle:
        d = _deps(deps)
        if not d:
            raise ValueError("a persistent task needs >= 1 dependency")
        self._check_deps(d)
        sched = self._rt._sched[self.rank]
        sched.submit(fn, d, name, True)
        return TaskHandle(sched, name, True)

    def remove_task(self, name: str) -> bool:
        return self._rt._sched[self.rank].remove_task(name)

    # -- events --------------------------------------------------------------
    def fire(self, target: Any, eid: str, data: Any = None, *,
             persistent: bool = False, ref: bool = False) -> None:
        if eid.startswith(SYS_PREFIX):
            raise ValueError(f"EIDs starting with {SYS_PREFIX!r} are reserved")
        self._pre_fire(eid, data)
        self._rt._fire(self.rank, target, eid, data,
                       persistent=persistent, ref=ref)

    def fire_batch(self, fires: Sequence[FireLike], *,
                   persistent: bool = False, ref: bool = False) -> None:
        """Fire many events with one transport round-trip per destination.

        ``fires`` is a sequence of ``(target, eid)`` or ``(target, eid,
        data)`` tuples; each element has exactly the semantics of a single
        :meth:`fire` (payload copied at fire time, per-(src,dst) FIFO order
        preserved across the batch).
        """
        for f in fires:
            eid = f[1]
            if eid.startswith(SYS_PREFIX):
                raise ValueError(
                    f"EIDs starting with {SYS_PREFIX!r} are reserved")
            self._pre_fire(eid, f[2] if len(f) > 2 else None)
        self._rt._fire_batch(self.rank, fires, persistent=persistent, ref=ref)

    def fire_after(self, delay: float, target: Any, eid: str,
                   data: Any = None) -> TimerHandle:
        """Machine-generated timer event (paper §VII further work)."""
        self._pre_fire(eid, data)
        return self._rt._fire_after(self.rank, delay, target, eid, data)

    # -- pause / poll ----------------------------------------------------------
    def wait(self, deps: Sequence[DepLike]) -> List[Event]:
        return self._rt._sched[self.rank].wait(
            self._check_deps(_deps(deps)))

    def retrieve_any(self, deps: Sequence[DepLike]) -> List[Event]:
        return self._rt._sched[self.rank].retrieve_any(
            self._check_deps(_deps(deps)))

    # -- locks -----------------------------------------------------------------
    def lock(self, name: str) -> None:
        self._rt._sched[self.rank].lock(name)

    def unlock(self, name: str) -> None:
        self._rt._sched[self.rank].unlock(name)

    def test_lock(self, name: str) -> bool:
        return self._rt._sched[self.rank].test_lock(name)

    # -- info -------------------------------------------------------------------
    def alive_ranks(self) -> List[int]:
        return [r for r in range(self.n_ranks) if not self._rt.is_dead(r)]


def _deps(deps: Sequence[DepLike]) -> List[Dep]:
    out = []
    for d in deps:
        out.append(d if isinstance(d, Dep) else Dep(d[0], d[1]))
    return out


class Runtime:
    """An EDAT 'machine': ``n_ranks`` SPMD ranks over a pluggable transport.

    ``progress='thread'`` gives each rank a dedicated progress thread;
    ``progress='worker'`` maps progress polling onto idle workers — the two
    modes of paper §II.F.  In worker mode the transport's notify hook wakes
    an idle worker on message arrival instead of the worker sleep-polling.
    """

    def __init__(self, n_ranks: int, workers_per_rank: int = 1, *,
                 progress: str = "thread",
                 unconsumed: str = "error",
                 transport: Optional[Transport] = None,
                 poll_interval: float = 0.002,
                 metrics: bool = True,
                 trace: bool = False,
                 durable: Optional[Union[bool, dict]] = None):
        assert progress in ("thread", "worker")
        assert unconsumed in ("error", "warn", "ignore")
        self.n_ranks = n_ranks
        self.transport: Transport = transport or InProcTransport(n_ranks)
        self._distributed = bool(self.transport.distributed)
        # loopback-only transports can never put a fire on the wire, so the
        # fire-path metrics skip the per-target membership test entirely
        self._wire_possible = bool(self.transport.serializes)
        local = self.transport.local_ranks
        self._local_ranks: List[int] = (sorted(local) if local is not None
                                        else list(range(n_ranks)))
        #: the rank that runs the Mattern detector and broadcasts terminate
        self._det_rank = 0
        self._metrics_on = bool(metrics)
        self._trace_on = bool(trace)
        self._sched = {r: Scheduler(r, n_ranks, self, workers_per_rank,
                                    progress, metrics=self._metrics_on,
                                    trace=self._trace_on)
                       for r in self._local_ranks}
        self._ctxs = {r: Context(self, r) for r in self._local_ranks}
        self._progress_mode = progress
        self._unconsumed = unconsumed
        # retained as the detector's backstop wait cap (the detector is
        # normally woken by idle-transition pokes, not by this interval)
        self._poll_interval = max(poll_interval, 0.25)
        self._prog_threads: List[threading.Thread] = []
        self._main_threads: List[threading.Thread] = []
        self._shutdown = False
        self._error: Optional[BaseException] = None
        self._err_mu = threading.Lock()
        # activity epoch: bumped on every idle transition / timer change;
        # the termination detector blocks on it instead of sleep-polling
        self._quiet_cv = threading.Condition()
        self._epoch = 0
        # timers
        self._timers: List[Tuple[float, int, int, int, str, Any]] = []
        self._timer_ids = itertools.count()
        self._live_tids: set = set()   # scheduled and not yet fired/cancelled
        self._cancelled: set = set()
        self._timer_cv = threading.Condition()
        self._timer_thread: Optional[threading.Thread] = None
        self._pending_timers = 0
        self.stats: Dict[str, Any] = {}
        # distributed-termination plumbing (CONTROL-message protocol)
        self._status_replies: List[dict] = []
        self._status_cv = threading.Condition()
        self._probe = 0                       # status-poll generation id
        self._term_event = threading.Event()  # set by rank 0's broadcast
        self._remote_stats: Dict[str, Any] = {}
        self._remote_error: Optional[str] = None
        self._remote_poke_mu = threading.Lock()
        self._last_remote_poke = 0.0
        # durable mode (repro_torch.durable): None until activated — either here
        # (durable=True / an eager spec) or lazily by per-channel opt-in
        # (Context.declare_channels -> _durable_add)
        self._durable = None
        self._durable_spec: Optional[dict] = None
        self._dur_mu = threading.Lock()
        if durable:
            spec = dict(durable) if isinstance(durable, dict) else {}
            if spec.get("all", True) or spec.get("channels"):
                self._durable_ensure(spec)
            else:
                self._durable_spec = spec
        if self._distributed:
            # heartbeat/EOF peer-failure detection feeds RANK_FAILED
            self.transport.on_peer_dead = self._on_peer_dead
            if hasattr(self.transport, "on_peer_join"):
                # elastic join: a replacement process re-hosted a dead rank
                self.transport.on_peer_join = self._on_peer_joined
            set_deliver = getattr(self.transport, "set_deliver", None)
            if set_deliver is not None:
                # push mode: the transport's reader threads hand batches
                # straight to delivery, skipping the progress-thread hop;
                # batches may mix co-located destination ranks
                set_deliver(self._push_deliver)
        if (progress == "worker"
                and type(self.transport).set_notify
                is not Transport.set_notify):
            # the transport can wake idle workers on arrival; without a real
            # notify override the workers fall back to timed polling
            for r in self._local_ranks:
                self.transport.set_notify(r, self._sched[r]._notify_mail)
                self._sched[r]._mail_hooked = True

    # --------------------------------------------------------------- wakeups
    def _poke(self, force: bool = False) -> None:
        """Bump the activity epoch and wake the termination detector.

        Unless forced, the wake is suppressed while the cheap quiescence
        gate fails — a busy system pokes on every idle transition (e.g.
        twice per ping-pong hop) and waking the detector each time would put
        context switches on the message critical path.  A suppressed wake
        that raced the real final transition is recovered by the detector's
        backstop timeout."""
        if not force and not self._maybe_quiescent():
            return
        if self._distributed and self._det_rank not in self._sched:
            # the detector lives in another process: nudge it with a CONTROL
            # poke (rate-limited — the backstop wait recovers a skipped one)
            now = time.monotonic()
            send = force
            if not send:
                with self._remote_poke_mu:
                    if now - self._last_remote_poke >= 0.05:
                        self._last_remote_poke = now
                        send = True
            if send:
                self.transport.send(Message(CONTROL, self._local_ranks[0],
                                            self._det_rank, ("poke", None)))
        with self._quiet_cv:
            self._epoch += 1
            self._quiet_cv.notify_all()

    # ------------------------------------------------------------ durable
    def _durable_ensure(self, spec: Optional[dict] = None):
        """Activate durable mode once (idempotent): build the
        :class:`repro_torch.durable.DurableState` and hook every local
        scheduler's consume path so *completed* records follow fires."""
        with self._dur_mu:
            if self._durable is None:
                if spec is None:
                    spec = self._durable_spec or {"all": False}
                from repro_torch.durable import DurableState
                dur = DurableState(self, spec)
                for r, sch in self._sched.items():
                    sch.on_consumed = dur.consumed_hook(r)
                self._durable = dur
        return self._durable

    def _durable_add(self, eids: Sequence[str]) -> None:
        """Per-channel opt-in (``Channel(..., durable=True)``), called from
        ``Context.declare_channels`` on every rank — idempotent."""
        self._durable_ensure().add_eids(eids)

    def _durable_error(self, exc: BaseException) -> None:
        with self._err_mu:
            if self._error is None:
                self._error = EdatTaskError(f"durable replay failed: {exc}")
                self._error.__cause__ = exc
        self._poke(force=True)

    def _durable_plan(self, records, prefer: Optional[int] = None,
                      targets: Optional[Dict[str, set]] = None
                      ) -> List[Tuple[object, str, int, object]]:
        """Destination selection for replay — the pure half of the old
        ``_durable_refire``, split out so the coordinator can journal the
        REPLAYED records *before* any event is sent (the in-memory log
        prunes on completion, so a fast survivor's *completed* append must
        never reach the queue ahead of the replay record it should prune).

        Dead targets are redirected to ``prefer`` (a freshly joined
        replacement) when alive, else round-robin over survivors the log
        has seen consume that channel (``targets``: eid -> historical dst
        set — a rank that never received the channel likely has no
        consumer for it).  Returns ``[(key, eid, new_dst, blob), ...]``.
        """
        alive = [r for r in range(self.n_ranks) if not self.is_dead(r)]
        if not alive:
            return []
        rr: Dict[str, int] = {}
        plan: List[Tuple[object, str, int, object]] = []
        for key, _kind, eid, _osrc, odst, blob in records:
            if not self.is_dead(odst):
                dst = odst
            elif prefer is not None and not self.is_dead(prefer):
                dst = prefer
            else:
                cand = alive
                if targets:
                    known = [r for r in alive if r in targets.get(eid, ())]
                    if known:
                        cand = known
                i = rr.get(eid, 0)
                rr[eid] = i + 1
                dst = cand[i % len(cand)]
            plan.append((key, eid, dst, blob))
        return plan

    def _durable_send(self, plan) -> None:
        """Re-fire a replay plan (at-least-once — each event keeps its
        original idempotency key).  Dead *sources* are replaced by this
        process's lead rank so the Mattern counters stay inside the alive
        columns."""
        src = min(self._sched)
        sch = self._sched[src]
        for key, eid, dst, blob in plan:
            # the in-memory backend stores immutable payloads raw (no
            # pickle roundtrip on the hot path); bytes means pickled
            data = pickle.loads(blob) if type(blob) is bytes else blob
            ev = Event(data=data, source=src, eid=eid)
            ev._dkey = key
            with sch._mu:
                sch.sent += 1
                if sch.metrics_on:
                    sch.count_fire_locked(
                        eid, 1, payload_nbytes(data),
                        0 if dst in self._sched else 1)
            self.transport.send(Message(EVENT, src, dst, ev))

    def _durable_refire(self, records, prefer: Optional[int] = None,
                        targets: Optional[Dict[str, set]] = None
                        ) -> List[Tuple[object, str, int]]:
        """Plan + send in one step (kept for direct callers/tests; the
        replay coordinator calls the halves separately so it can journal
        between them).  Returns ``[(key, eid, new_dst), ...]``."""
        plan = self._durable_plan(records, prefer=prefer, targets=targets)
        self._durable_send(plan)
        return [(key, eid, dst) for key, eid, dst, _blob in plan]

    def _on_peer_joined(self, rank: int) -> None:
        """Transport elastic-join callback: a replacement process now hosts
        ``rank``.  Re-arm durable failure handling for it and wake the
        detector (the alive set just changed under it)."""
        if self._durable is not None:
            self._durable.note_joined(rank)
        self._poke(force=True)

    # ------------------------------------------------------------ event path
    def _targets(self, src: int, target: Any) -> List[int]:
        """Expand a fire target; reject out-of-range ranks *before* any
        counter is touched (a post-count failure would permanently
        unbalance the Mattern sent/received counters and hang run())."""
        if target is ALL:
            return list(range(self.n_ranks))
        if target is SELF:
            return [src]
        t = int(target)
        if not 0 <= t < self.n_ranks:
            raise ValueError(
                f"fire target rank {t} out of range [0, {self.n_ranks})")
        return [t]

    def _fire(self, src: int, target: Any, eid: str, data: Any, *,
              persistent: bool, ref: bool) -> None:
        dur = self._durable
        if dur is not None:
            durable = dur._wcache.get(eid)  # inlined wants() fast path
            if durable is None:
                durable = dur.wants(eid)
        else:
            durable = False
        # validated before the sent counter is touched: a non-transportable
        # payload raises here, in the firing task, with balanced counters
        self.transport.validate_payload(data)
        targets = self._targets(src, target)
        if durable:
            # Durable-channel fire: plain semantics plus an idempotency key
            # stamped on each Event (``_dkey`` lives in the instance
            # __dict__, so it rides pickle and the in-process loopback
            # alike) and an off-hot-path *fired* log append.  Keys are
            # cheap tuples (the sqlite backend stringifies at write time);
            # immutable payloads skip both the defensive copy and the
            # fire-time pickle — the log's writer thread snapshots them
            # instead, which is safe exactly because nothing can mutate
            # them.  Mutable payloads pay one eager ``pickle.dumps`` that
            # doubles as the per-target defensive copy, so durable
            # payloads must pickle even on the in-proc transport.
            imm = type(data) in _IMMUTABLE
            if imm and type(data) is not bytes:
                # deferred snapshot; raw bytes payloads are excluded so a
                # backend blob is unambiguously always pickle output
                blob = data
            else:
                blob = pickle.dumps(data, pickle.HIGHEST_PROTOCOL)
            copy_free = (ref or imm
                         or (self.transport.serializes
                             and all(t not in self._sched for t in targets)))
            # a zombie task on a simulated-dead rank (kill_rank; the thread
            # finishes its current task) must not log fires the transport
            # will drop — they would leak as forever-pending records
            nx, tag, ap, dead, idk = dur._hot
            log_ok = not dead(src)
            msgs = []
            if idk:
                # reference-delivery transport + in-process log: the Event
                # object itself is the journal entry and its identity the
                # idempotency key — no counter, no key tuple, no setattr
                for t in targets:
                    payload = data if copy_free else pickle.loads(blob)
                    ev = Event(data=payload, source=src, eid=eid,
                               persistent=persistent)
                    if log_ok:
                        ap((ev, t, blob))
                    msgs.append(Message(EVENT, src, t, ev, owned=ref))
            else:
                for t in targets:
                    payload = data if copy_free else pickle.loads(blob)
                    ev = Event(data=payload, source=src, eid=eid,
                               persistent=persistent)
                    key = (src, t, eid, nx(), tag)
                    ev._dkey = key
                    if log_ok:
                        # compact fired form; the log's writer expands it
                        ap((key, blob))
                    msgs.append(Message(EVENT, src, t, ev, owned=ref))
        else:
            # a serialising transport pickles every remote message
            # synchronously inside send — that IS the fire-time snapshot,
            # so the defensive deep-copy is only needed when some target is
            # hosted by THIS process (self-sends and co-located ranks take
            # the transport's loopback, which delivers the object by
            # reference)
            copy_free = ref or (self.transport.serializes
                                and all(t not in self._sched
                                        for t in targets))
            payload = data if copy_free else copy_payload(data)
            # ref=True hands payload ownership over (EDAT_ADDRESS): a
            # deferred-write transport may then serialise it lazily and
            # zero-copy
            msgs = [Message(EVENT, src, t,
                            Event(data=payload
                                  if (copy_free or len(targets) == 1)
                                  else copy_payload(payload),
                                  source=src, eid=eid,
                                  persistent=persistent),
                            owned=ref)
                    for t in targets]
        sch = self._sched[src]
        # sent is counted before the send so the termination detector can
        # never observe balanced counters with the message still in flight;
        # a send to a dead destination is counted by the transport as
        # dropped: termination balances sent == received + dropped
        if sch.metrics_on:
            # count_fire_locked, inlined with the arithmetic hoisted off the
            # lock: this is the fire hot path
            n = len(msgs)
            nbytes = (8 if type(data) in _FIXED8
                      else payload_nbytes(data)) * n
            if not self._wire_possible:
                wire = 0
            elif n == 1:                       # overwhelmingly common
                wire = 0 if targets[0] in self._sched else 1
            else:
                wire = 0
                for t in targets:
                    if t not in self._sched:
                        wire += 1
            with sch._mu:
                sch.sent += n
                rec = sch._m_fires.get(eid)
                if rec is None:
                    rec = sch._m_fires[eid] = [0, 0, 0]
                rec[0] += n
                rec[1] += nbytes
                rec[2] += wire
        else:
            with sch._mu:
                sch.sent += len(msgs)
        if len(msgs) == 1:
            self.transport.send(msgs[0])
        else:
            self.transport.send_many(msgs)

    def _fire_batch(self, src: int, fires: Sequence[FireLike], *,
                    persistent: bool, ref: bool) -> None:
        dur = self._durable
        if dur is not None and any(dur.wants(f[1]) for f in fires):
            # durable fires need a key per (event, target): take the
            # per-fire path (batching is a wire optimisation, not semantics)
            for f in fires:
                self._fire(src, f[0], f[1], f[2] if len(f) > 2 else None,
                           persistent=persistent, ref=ref)
            return
        sch = self._sched[src]
        msgs: List[Message] = []
        agg: Optional[Dict[str, List[int]]] = {} if sch.metrics_on else None
        for f in fires:
            target, eid = f[0], f[1]
            data = f[2] if len(f) > 2 else None
            self.transport.validate_payload(data)
            targets = self._targets(src, target)
            copy_free = ref or (self.transport.serializes
                                and all(t not in self._sched
                                        for t in targets))
            payload = data if copy_free else copy_payload(data)
            for t in targets:
                msgs.append(Message(EVENT, src, t,
                                    Event(data=payload
                                          if (copy_free or len(targets) == 1)
                                          else copy_payload(payload),
                                          source=src, eid=eid,
                                          persistent=persistent),
                                    owned=ref))
            if agg is not None:
                rec = agg.get(eid)
                if rec is None:
                    rec = agg[eid] = [0, 0, 0]
                rec[0] += len(targets)
                rec[1] += payload_nbytes(data) * len(targets)
                rec[2] += sum(1 for t in targets if t not in self._sched)
        if not msgs:
            return
        with sch._mu:
            sch.sent += len(msgs)
            if agg:
                for eid, v in agg.items():
                    sch.count_fire_locked(eid, v[0], v[1], v[2])
        self.transport.send_many(msgs)

    def _send_refire(self, rank: int, ev: Event) -> None:
        """Persistent event consumed -> re-fired locally (paper §IV.A).
        The scheduler already counted it as sent under its own lock."""
        self.transport.send(Message(EVENT, rank, rank, ev.clone()))

    # system events bypass Context validation
    def _fire_sys(self, src: int, target: int, eid: str, data: Any) -> None:
        sch = self._sched[src]
        ev = Event(data=copy_payload(data), source=src, eid=eid)
        with sch._mu:
            sch.sent += 1
            if sch.metrics_on:
                sch.count_fire_locked(
                    eid, 1, payload_nbytes(data),
                    0 if target in self._sched else 1)
        self.transport.send(Message(EVENT, src, target, ev))

    # ------------------------------------------------------------- progress
    def _progress_loop(self, rank: int) -> None:
        while not self._shutdown and not self.transport.is_dead(rank):
            msgs = self.transport.recv_many(rank, timeout=0.5)
            if msgs:
                self._handle_many(rank, msgs)

    def _progress_poll(self, rank: int) -> bool:
        """One poll step for idle-worker progress mode.  True if progressed."""
        msgs = self.transport.drain(rank, max_n=64)
        if not msgs:
            return False
        self._handle_many(rank, msgs)
        return True

    def _push_deliver(self, msgs: List[Message]) -> None:
        """Push-mode entry from a distributed transport's reader threads:
        route each message to its destination rank's scheduler (one call
        may carry messages for several co-located ranks)."""
        by_dst: Dict[int, List[Message]] = {}
        for m in msgs:
            by_dst.setdefault(m.dst, []).append(m)
        for r, ms in by_dst.items():
            if r in self._sched:
                self._handle_many(r, ms)

    def _handle_many(self, rank: int, msgs: List[Message]) -> None:
        events = [m.payload for m in msgs if m.kind == EVENT]
        if events:
            self._sched[rank].deliver_many(events)
        for m in msgs:
            if m.kind == CONTROL:
                self._handle_control(rank, m)

    def _handle_control(self, rank: int, msg: Message) -> None:
        tag, data = msg.payload
        if tag == "status?":
            st = self._local_status(rank)
            st["probe"] = data
            if self._distributed and msg.src not in self._sched:
                # detector lives in another process: reply over the wire
                self.transport.send(
                    Message(CONTROL, rank, msg.src, ("status!", st)))
            else:
                with self._status_cv:
                    self._status_replies.append(st)
                    self._status_cv.notify_all()
        elif tag == "status!":
            with self._status_cv:
                self._status_replies.append(data)
                self._status_cv.notify_all()
        elif tag == "poke":
            with self._quiet_cv:
                self._epoch += 1
                self._quiet_cv.notify_all()
        elif tag == "abort":
            # a task failed in another process; the detector returns as soon
            # as it observes the error
            with self._err_mu:
                if self._error is None:
                    self._error = EdatTaskError(data)
            self._poke(force=True)
        elif tag == "terminate":
            self._remote_stats = data.get("stats") or {}
            self._remote_error = data.get("error")
            self._term_event.set()

    def _local_status(self, rank: int) -> dict:
        """One rank's status reply, extended with the per-process state the
        distributed detector cannot read directly (timers, transport drop
        counter, mailbox depth, per-peer sent/received vectors).  Process-
        wide quantities are reported by the lowest local rank only, so
        summing replies never multi-counts."""
        st = self._sched[rank].status()
        st["rank"] = rank
        st["mailbox"] = self.transport.pending(rank)
        reporter = next((r for r in self._local_ranks
                         if not self.transport.is_dead(r)),
                        self._local_ranks[0])
        if rank == reporter:
            with self._timer_cv:
                st["timers"] = self._pending_timers
            st["dropped"] = self.transport.dropped
            if self._distributed:
                st["sent_to"] = self.transport.sent_vector()
                st["recv_from"] = self.transport.recv_vector()
        else:
            st["timers"] = 0
            st["dropped"] = 0
        return st

    # --------------------------------------------------------------- timers
    def _fire_after(self, src: int, delay: float, target: Any, eid: str,
                    data: Any) -> TimerHandle:
        if target is ALL:
            dst = self.n_ranks          # ALL sentinel in the timer tuple
        elif target is SELF:
            dst = src
        else:
            dst = int(target)
            if not 0 <= dst < self.n_ranks:
                raise ValueError(f"fire target rank {dst} out of range "
                                 f"[0, {self.n_ranks})")
        tid = next(self._timer_ids)
        self.transport.validate_payload(data)
        payload = copy_payload(data)
        with self._timer_cv:
            heapq.heappush(self._timers,
                           (time.monotonic() + delay, tid, src, dst,
                            eid, payload))
            self._live_tids.add(tid)
            self._pending_timers += 1
            self._timer_cv.notify_all()
        return TimerHandle(self, tid)

    def _cancel_timer(self, tid: int) -> bool:
        with self._timer_cv:
            if tid not in self._live_tids:
                return False  # already fired (or already cancelled)
            self._live_tids.discard(tid)
            self._cancelled.add(tid)
            self._pending_timers -= 1
            self._timer_cv.notify_all()
        self._poke()
        return True

    def _timer_loop(self) -> None:
        while not self._shutdown:
            with self._timer_cv:
                if self._shutdown:  # re-check under the cv: shutdown is
                    return          # flagged before its notify is sent
                if not self._timers:
                    self._timer_cv.wait()  # woken on push/cancel/shutdown
                    continue
                when, tid, src, dst, eid, data = self._timers[0]
                if tid in self._cancelled:
                    # cancellation already un-counted it; just drop the entry
                    heapq.heappop(self._timers)
                    self._cancelled.discard(tid)
                    continue
                now = time.monotonic()
                if when > now:
                    self._timer_cv.wait(when - now)
                    continue
                heapq.heappop(self._timers)
                self._live_tids.discard(tid)
            if dst == self.n_ranks:  # ALL
                for t in range(self.n_ranks):
                    self._fire_sys(src, t, eid, data)
            else:
                self._fire_sys(src, dst, eid, data)
            with self._timer_cv:
                # un-count the pending timer only after _fire_sys counted
                # the send: the detector must never observe timers == 0 with
                # the event not yet in the sent counter, or it could declare
                # termination in the gap and drop the timer event
                self._pending_timers -= 1

    # ---------------------------------------------------- failure injection
    def kill_rank(self, rank: int) -> None:
        """Simulate node failure: drop the rank and notify survivors with a
        machine-generated RANK_FAILED event (paper §VII further work)."""
        self.transport.mark_dead(rank)
        if rank in self._sched:
            self._sched[rank].stop()
        # the failure notification is machine-generated at each *survivor*
        # (the dead rank cannot send), sourced from the survivor itself
        for r in self._local_ranks:
            if r != rank and not self.transport.is_dead(r):
                self._fire_sys(r, r, RANK_FAILED, rank)
        if self._durable is not None:
            # marks replay in-flight *before* the poke below, so the
            # detector can't declare termination in the gap
            self._durable.note_rank_failed(rank)
        self._poke(force=True)  # alive-set changed under the detector

    def _on_peer_dead(self, rank: int) -> None:
        """Transport failure-detector callback (distributed): a peer process
        stopped heartbeating or its connection broke.  Mirrors
        :meth:`kill_rank` for the local ranks; every surviving process runs
        the same notification, so each alive rank sees one RANK_FAILED."""
        for r in self._local_ranks:
            if r != rank and not self.transport.is_dead(r):
                self._fire_sys(r, r, RANK_FAILED, rank)
        if self._durable is not None:
            self._durable.note_rank_failed(rank)
        if (self._distributed and rank == self._det_rank
                and self._det_rank not in self._sched):
            # the termination coordinator died: nobody will ever broadcast
            # terminate — fail this process instead of hanging to timeout
            with self._err_mu:
                if self._error is None:
                    self._error = RankDiedError(
                        f"rank {rank} (termination coordinator) failed")
            self._term_event.set()
        self._poke(force=True)

    def is_dead(self, rank: int) -> bool:
        return self.transport.is_dead(rank)

    # -------------------------------------------------------------- failure
    def _task_failed(self, rank: int, inst, exc: BaseException) -> None:
        first = False
        with self._err_mu:
            if self._error is None:
                self._error = EdatTaskError(
                    f"task {inst.name or inst.fn.__name__!r} on rank {rank} "
                    f"raised {type(exc).__name__}: {exc}")
                self._error.__cause__ = exc
                first = True
        if first and self._distributed and self._det_rank not in self._sched:
            # tell the detector process; it broadcasts terminate with the
            # error so every process exits instead of hanging to timeout
            self.transport.send(Message(CONTROL, rank, self._det_rank,
                                        ("abort", str(self._error))))
        self._poke(force=True)  # the detector returns as soon as it sees it

    def _ctx(self, rank: int) -> Context:
        return self._ctxs[rank]

    # -------------------------------------------------------------- metrics
    def metrics(self) -> Optional[Dict[str, Any]]:
        """This process's metric snapshot: per-channel counters merged over
        the local ranks, per-rank execution totals, and the transport's
        wire-level view.  ``None`` when the runtime was built with
        ``metrics=False``.  Shape matches what
        :func:`repro_torch.core.metrics.merge_metrics` consumes; the quorum-wait
        seconds a local consumer attributes to a *remote* rank appear under
        that remote rank's entry (merge sums them)."""
        if not self._metrics_on:
            return None
        channels: Dict[str, Dict[str, int]] = {}
        ranks: Dict[int, Dict[str, Any]] = {}
        for r, sch in self._sched.items():
            snap = sch.metrics_snapshot()
            rk = ranks.setdefault(r, {"tasks_executed": 0, "busy_s": 0.0,
                                      "quorum_wait_s": 0.0})
            rk["tasks_executed"] += snap["tasks_executed"]
            rk["busy_s"] += snap["busy_s"]
            for eid, (n, b, w) in snap["fires"].items():
                ch = channels.setdefault(
                    eid, {"fires": 0, "bytes": 0, "wire_fires": 0,
                          "deliveries": 0, "consumed": 0, "queued_max": 0})
                ch["fires"] += n
                ch["bytes"] += b
                ch["wire_fires"] += w
            for eid, (d, c, _p, qm) in snap["deliveries"].items():
                ch = channels.setdefault(
                    eid, {"fires": 0, "bytes": 0, "wire_fires": 0,
                          "deliveries": 0, "consumed": 0, "queued_max": 0})
                ch["deliveries"] += d
                ch["consumed"] += c
                ch["queued_max"] = max(ch["queued_max"], qm)
            for src, secs in snap["quorum_wait_s"].items():
                srk = ranks.setdefault(
                    src, {"tasks_executed": 0, "busy_s": 0.0,
                          "quorum_wait_s": 0.0})
                srk["quorum_wait_s"] += secs
            if self._trace_on:
                rk.setdefault("trace", []).extend(snap.get("trace", ()))
                rk["trace_dropped"] = (rk.get("trace_dropped", 0)
                                       + snap.get("trace_dropped", 0))
        tmetrics = getattr(self.transport, "metrics", None)
        transport = tmetrics() if callable(tmetrics) else {"kind": "inproc"}
        out = {"channels": channels, "ranks": ranks, "transport": transport}
        if self._durable is not None:
            out["durable"] = self._durable.snapshot()
        return out

    # ------------------------------------------------------------------ run
    def run(self, main: Callable[[Context], None],
            timeout: float = 120.0) -> Dict[str, Any]:
        """Deprecated v1 entry point — use ``edat.run(main, ranks=...)``
        or ``edat.Session`` (the v2 API), which owns runtime construction
        and teardown.  Behaviour is unchanged; a DeprecationWarning is
        emitted once per call site."""
        warn_deprecated(
            "Runtime.run is deprecated: start programs through "
            "edat.run(program, ranks=...) or edat.Session (the v2 API)")
        return self._run_internal(main, timeout=timeout)

    def _run_internal(self, main: Callable[[Context], None],
                      timeout: float = 120.0) -> Dict[str, Any]:
        """Run ``main(ctx)`` SPMD on every local rank; return when the
        paper's four termination conditions (§II.E) hold globally.
        Equivalent to ``edatInit(); main(); edatFinalise()``.  With a
        distributed transport each participating process calls ``run`` with
        the same ``main``; rank 0's process detects global termination and
        broadcasts it to the others."""
        with self._status_cv:
            self._status_replies = []

        for s in self._sched.values():
            s.start()
        if self._progress_mode == "thread":
            for r in self._local_ranks:
                t = threading.Thread(target=self._progress_loop, args=(r,),
                                     daemon=True, name=f"edat-p{r}")
                self._prog_threads.append(t)
                t.start()
        self._timer_thread = threading.Thread(target=self._timer_loop,
                                              daemon=True, name="edat-timer")
        self._timer_thread.start()

        def _main(rank: int):
            try:
                main(self._ctxs[rank])
            except Exception as e:  # noqa: BLE001
                self._task_failed(rank, type("M", (), {
                    "name": f"main[{rank}]", "fn": main})(), e)
            finally:
                self._sched[rank].set_main_done()

        for r in self._local_ranks:
            t = threading.Thread(target=_main, args=(r,), daemon=True,
                                 name=f"edat-main{r}")
            self._main_threads.append(t)
            t.start()

        try:
            if self._det_rank in self._sched or not self._distributed:
                try:
                    self._await_termination(timeout)
                except BaseException as e:
                    self._broadcast_terminate(f"{type(e).__name__}: {e}")
                    raise
                else:
                    err = self._error
                    self._broadcast_terminate(
                        None if err is None
                        else f"{type(err).__name__}: {err}")
            else:
                self._await_remote_termination(timeout)
        finally:
            self._shutdown = True
            for s in self._sched.values():
                s.stop()
            for r in self._local_ranks:
                self.transport.wake(r)
            with self._timer_cv:
                self._timer_cv.notify_all()
            for t in self._main_threads:
                t.join(5.0)
            for s in self._sched.values():
                s.join()
            # the progress and timer threads hold the runtime, and through
            # it every task's closure: end them before run returns, so a
            # caller's gc.collect() frees what the program built
            for t in self._prog_threads + [self._timer_thread]:
                t.join(5.0)
            self.transport.close()
            if self._durable is not None:
                # land every queued log record (sqlite readers outlive us)
                self._durable.close()
        if self._error is not None:
            raise self._error
        return self.stats

    def _broadcast_terminate(self, error: Optional[str]) -> None:
        """Rank 0 (detector) -> everyone else: the run is over (CONTROL)."""
        if not self._distributed:
            return
        payload = {"stats": dict(self.stats), "error": error}
        for r in range(self.n_ranks):
            if r not in self._sched and not self.is_dead(r):
                self.transport.send(Message(CONTROL, self._det_rank, r,
                                            ("terminate", payload)))

    def _await_remote_termination(self, timeout: float) -> None:
        """Non-detector process: block until rank 0 broadcasts terminate
        (or a local/peer failure makes waiting pointless)."""
        deadline = time.monotonic() + timeout
        while not self._term_event.wait(
                min(0.25, max(0.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                if self._error is not None:
                    return  # raised by run() after cleanup
                raise TimeoutError(
                    f"rank(s) {self._local_ranks} did not receive the "
                    f"termination broadcast within {timeout}s")
        if self._remote_stats:
            self.stats.update(self._remote_stats)
        err = self._remote_error
        if err is not None and self._error is None:
            if err.startswith("EdatDeadlockError"):
                self._error = EdatDeadlockError(err)
            else:
                self._error = EdatTaskError(err)

    # ------------------------------------------------- termination detector
    def _poll_status(self) -> List[dict]:
        alive = [r for r in range(self.n_ranks) if not self.is_dead(r)]
        if self._progress_mode == "thread" or self._distributed:
            # formal poll through the transport: remote ranks answer with a
            # CONTROL status! reply; local ranks append directly.  Replies
            # carry the probe id so a late reply from a previous poll can
            # never satisfy (or pollute) this one.
            self._probe += 1
            probe = self._probe
            src = self._det_rank if self._distributed else -1
            with self._status_cv:
                self._status_replies = []
            for r in alive:
                self.transport.send(Message(CONTROL, src, r,
                                            ("status?", probe)))
            deadline = time.monotonic() + 1.0
            with self._status_cv:
                while True:
                    got = [st for st in self._status_replies
                           if st.get("probe") == probe]
                    remaining = deadline - time.monotonic()
                    if len(got) >= len(alive) or remaining <= 0:
                        return got
                    self._status_cv.wait(remaining)
        # in-proc worker-poll mode: workers may all be busy; read directly
        # (safe here because status() takes the scheduler lock)
        return [self._local_status(r) for r in alive]

    def _maybe_quiescent(self) -> bool:
        """Lock-free pre-check gating the formal status poll.  Dirty reads
        are safe here: a false positive only costs one formal poll, a false
        negative is recovered by the next poke or the backstop wait.  This
        keeps the detector off the progress threads' critical path while
        the system is busy (e.g. it never sends CONTROL traffic in the
        middle of a ping-pong exchange)."""
        s = rcv = 0
        for r in self._local_ranks:
            sch = self._sched[r]
            if not self.is_dead(r):
                if (sch._ready or sch._running or sch._resuming
                        or not sch._main_done):
                    return False
            s += sch.sent
            rcv += sch.received
        if self._pending_timers:
            return False
        dur = self._durable
        if dur is not None and dur.busy():
            # a durable replay is in flight: re-fires are imminent, so the
            # counters' balance (or imbalance) right now is meaningless
            return False
        if self._distributed:
            # only local state is readable: locally quiet is the best this
            # gate can certify — the formal CONTROL poll decides globally
            return True
        # no mailbox probe here: an undelivered user event already shows as
        # s > rcv (sent counts at fire, received at delivery), and the formal
        # poll re-checks mailboxes authoritatively — probing them here would
        # contend with the transport's hot path on every idle transition
        return s == rcv + self.transport.dropped

    def _await_termination(self, timeout: float) -> None:
        """Mattern four-counter quiescence: two consecutive stable polls with
        every rank idle and globally sent == received.  Between polls the
        detector blocks on the activity epoch (woken by idle transitions)
        instead of sleep-polling."""
        t0 = time.monotonic()
        prev: Optional[Tuple[int, int, int]] = None
        while True:
            if self._error is not None:
                return
            remaining = timeout - (time.monotonic() - t0)
            if remaining <= 0:
                raise TimeoutError(
                    f"EDAT did not terminate within {timeout}s; "
                    f"status={self._poll_status()}")
            with self._quiet_cv:
                epoch = self._epoch
            if not self._maybe_quiescent():
                prev = None
                with self._quiet_cv:
                    if self._epoch == epoch and self._error is None:
                        self._quiet_cv.wait(min(self._poll_interval,
                                                remaining))
                continue
            sts = self._poll_status()
            alive = [r for r in range(self.n_ranks) if not self.is_dead(r)]
            if len(sts) < len(alive):
                prev = None
                continue
            if self._distributed:
                # cross-process balance: per-peer transport vectors from the
                # replies, restricted to alive columns — events exchanged
                # with a failed process cancel on both sides without ever
                # reading its (unreachable) counters
                alive_set = set(alive)
                s = sum(v for x in sts
                        for j, v in enumerate(x.get("sent_to", ()))
                        if j in alive_set)
                rcv = sum(v for x in sts
                          for j, v in enumerate(x.get("recv_from", ()))
                          if j in alive_set)
                timers = sum(x["timers"] for x in sts)
                mailbox = sum(x["mailbox"] for x in sts)
            else:
                with self._timer_cv:
                    timers = self._pending_timers
                mailbox = sum(self.transport.pending(r) for r in alive)
                s = sum(x["sent"] for x in sts)
                rcv = sum(x["received"] for x in sts)
                # dead ranks: include their final counter snapshots so
                # events they exchanged before failing stay balanced
                for r in range(self.n_ranks):
                    if self.is_dead(r):
                        s += self._sched[r].sent
                        rcv += self._sched[r].received
                rcv += self.transport.dropped
            all_idle = (all(x["idle"] for x in sts)
                        and mailbox == 0 and timers == 0
                        and not (self._durable is not None
                                 and self._durable.busy()))
            if not all_idle or s != rcv:
                prev = None
                if self._distributed:
                    # the local-only quiescence gate cannot veto remote
                    # traffic, so a busy exchange would otherwise trigger a
                    # formal CONTROL poll per idle transition; damp to at
                    # most ~50 polls/s (adds <=20 ms to real termination)
                    time.sleep(0.02)
                with self._quiet_cv:
                    if self._epoch == epoch and self._error is None:
                        self._quiet_cv.wait(min(self._poll_interval,
                                                remaining))
                continue
            if prev == (s, rcv, len(alive)):
                # two consecutive stable, idle, balanced polls -> quiescent
                parked = sum(x["parked"] for x in sts)
                unmet = sum(x["unmet"] for x in sts)
                stored = sum(x["stored"] for x in sts)
                if self._distributed:
                    # scheduler counters (user-event view) of alive ranks;
                    # a dead process's counters are unreachable
                    ev_s = sum(x["sent"] for x in sts)
                    ev_r = sum(x["received"] for x in sts)
                    dropped = sum(x["dropped"] for x in sts)
                else:
                    ev_s, ev_r = s, rcv
                    dropped = self.transport.dropped
                self.stats.update(
                    events_sent=ev_s, events_received=ev_r,
                    tasks_executed=sum(x["executed"] for x in sts),
                    events_dropped=dropped,
                    unconsumed_events=stored)
                if parked or unmet:
                    raise EdatDeadlockError(
                        f"quiescent with {parked} parked task(s) and {unmet} "
                        f"transitory task(s) with unmet dependencies — the "
                        f"paper's termination conditions 1/2 can never hold")
                if stored and self._unconsumed != "ignore":
                    msg = (f"quiescent with {stored} unconsumed transitory "
                           f"event(s) (paper termination condition 4)")
                    if self._unconsumed == "error":
                        raise EdatDeadlockError(msg)
                    import warnings
                    warnings.warn(msg, stacklevel=1)
                return
            # first stable poll: confirm immediately — the counters must
            # hold identical across two polls for quiescence
            prev = (s, rcv, len(alive))
