"""Pluggable transport layer (paper §II.F).

The paper's EDAT library ships an MPI transport behind a pluggable interface;
"other mechanisms can be easily added".  Two transports ship here:

* :class:`InProcTransport` — ranks are threads with private object spaces in
  one process.  The reference implementation: zero-copy mailboxes, payloads
  deep-copied at fire time, ``kill_rank`` failure simulation.
* :class:`repro_torch.net.SocketTransport` — ranks are separate OS processes
  exchanging length-prefixed pickled frames over TCP, with a heartbeat-based
  peer failure detector.  Built by :mod:`repro_torch.net.bootstrap` and launched
  by ``python -m repro_torch.net.launch`` / :func:`repro_torch.net.launch_processes`.

Both preserve the semantics that the correctness arguments rely on:

* per-(src,dst) FIFO delivery (paper §II.B ordering guarantee),
* fire-and-forget payloads (copied or serialised at fire time),
* message counting hooks for distributed termination (Mattern four-counter),
* sends to failed ranks are dropped (node-failure handling).

Batching: :meth:`Transport.send_many` enqueues a whole fire-batch with one
lock (or syscall) round-trip per destination, and :meth:`Transport.drain` /
:meth:`Transport.recv_many` pop every pending message in one round-trip —
the runtime's progress path uses these so a burst of N events costs
O(destinations) round-trips, not O(N).  A minimal transport only has to
implement ``send`` / ``recv`` / ``wake``; the base class supplies working
(looping) batch defaults and inert failure/notification hooks, and the
runtime falls back to timed polling in worker-progress mode.

Coalescing: a transport may additionally *defer* the wire write — enqueue
on ``send`` and drain the queue from a writer thread that packs many
messages into one syscall (``SocketTransport``'s default, knobs
``coalesce`` / ``flush_interval`` / ``max_batch_bytes``).  Such a
transport must still snapshot each non-``owned`` payload synchronously
inside ``send`` (fire-and-forget semantics); ``Message.owned`` marks
payloads whose ownership was handed over at fire time, which may be
encoded lazily and zero-copy.  :meth:`Transport.flush` blocks until
deferred writes have reached the kernel — a no-op for synchronous
transports.

Notification: :meth:`Transport.set_notify` registers a per-rank callback
invoked after messages are enqueued (outside the mailbox lock).  In
idle-worker progress mode the runtime points it at the scheduler's condition
variable so an idle worker wakes on arrival instead of sleep-polling.

Distributed transports (``distributed = True``) additionally declare which
ranks live in this process (``local_ranks``) and keep per-peer sent/received
vectors so the termination detector can balance counters across processes
through CONTROL messages instead of shared memory.
"""
from __future__ import annotations

import abc
import dataclasses
import threading
from collections import deque
from typing import Any, Callable, List, Optional

# message kinds
EVENT = "event"            # user event (counted for termination)
CONTROL = "control"        # runtime control (poll / poll-reply / terminate / abort)


@dataclasses.dataclass
class Message:
    kind: str
    src: int
    dst: int
    payload: Any  # Event for kind=EVENT; (tag, data) tuple for CONTROL
    #: True when the firing task handed payload ownership over (``ref=True``
    #: fires, the paper's EDAT_ADDRESS): nobody mutates the payload after
    #: fire, so a serialising transport may encode it lazily and zero-copy
    #: (pickle protocol-5 out-of-band buffers) instead of snapshotting it
    #: inside ``send``.
    owned: bool = False


class Transport(abc.ABC):
    """Abstract transport: point-to-point ordered messaging between ranks."""

    #: True when ranks live in separate processes; the runtime then speaks
    #: to remote ranks exclusively through CONTROL messages.
    distributed: bool = False
    #: Ranks hosted by this process (None: all ranks are local, in-proc).
    local_ranks = None
    #: True when ``send`` serialises the message synchronously (the wire
    #: encoding *is* the fire-time snapshot): the runtime then skips the
    #: defensive deep-copy for remote-only fires.
    serializes: bool = False

    @abc.abstractmethod
    def send(self, msg: Message) -> bool:
        """Enqueue ``msg`` for delivery.  Returns False if dst is dead."""

    @abc.abstractmethod
    def recv(self, rank: int, timeout: Optional[float]) -> Optional[Message]:
        """Blocking receive for ``rank``; None on timeout/shutdown."""

    @abc.abstractmethod
    def wake(self, rank: int) -> None:
        """Wake a blocked :meth:`recv` (used at shutdown)."""

    def send_many(self, msgs: List[Message]) -> int:
        """Enqueue a batch; returns the number actually delivered.  The
        default loops over :meth:`send`; implementations should batch."""
        return sum(1 for m in msgs if self.send(m))

    def drain(self, rank: int, max_n: Optional[int] = None) -> List[Message]:
        """Pop up to ``max_n`` pending messages (all, if None) without
        blocking.  The default loops over zero-timeout :meth:`recv`;
        implementations should batch."""
        out: List[Message] = []
        while max_n is None or len(out) < max_n:
            m = self.recv(rank, timeout=0)
            if m is None:
                break
            out.append(m)
        return out

    def recv_many(self, rank: int,
                  timeout: Optional[float]) -> List[Message]:
        """Blocking batched receive: wait up to ``timeout`` for at least one
        message, then return everything pending.  The default composes one
        blocking :meth:`recv` with a :meth:`drain`; implementations should
        pop the whole mailbox in a single round-trip."""
        first = self.recv(rank, timeout)
        if first is None:
            return []
        return [first, *self.drain(rank)]

    def set_notify(self, rank: int, fn: Optional[Callable[[], None]]) -> None:
        """Register a callback invoked after message arrival for ``rank``
        (no-op by default; callback must not assume any lock is held).
        Transports that do not override this cannot wake idle workers, so
        the runtime falls back to timed polling in worker-progress mode."""

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until deferred (coalesced) sends have been handed to the
        OS, or ``timeout`` expires.  Transports that write synchronously
        inside :meth:`send` have nothing to wait for — returns True."""
        return True

    def validate_payload(self, data: Any) -> None:
        """Raise ``TypeError`` if ``data`` cannot travel on this transport.
        Called at fire time, *before* any termination counter is touched, so
        a bad payload fails in the firing task with a clear error instead of
        crashing a worker/progress thread mid-delivery.  No-op by default
        (in-proc payloads only need to be copyable)."""

    # -- failure handling (inert defaults for minimal transports) -----------
    def is_dead(self, rank: int) -> bool:
        """True if ``rank`` is known to have failed."""
        return False

    def mark_dead(self, rank: int) -> None:
        """Locally declare ``rank`` failed (failure injection / detection)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support failure injection")

    @property
    def dropped(self) -> int:
        """Messages dropped because their destination was dead."""
        return 0

    def pending(self, rank: int) -> int:
        """Undelivered messages queued for ``rank`` (0 if unknown; the
        sent/received counters still catch in-flight events)."""
        return 0

    def close(self) -> None:
        """Release transport resources (sockets, threads).  No-op default."""


class InProcTransport(Transport):
    """Threads-as-ranks transport with per-destination FIFO mailboxes.

    Each source appends atomically in fire order, so per-(src,dst) order is
    preserved — the same guarantee the paper's MPI transport provides.
    """

    def __init__(self, n_ranks: int):
        self.n_ranks = n_ranks
        self._boxes = [deque() for _ in range(n_ranks)]
        self._cvs = [threading.Condition() for _ in range(n_ranks)]
        self._dead = [False] * n_ranks
        self._notify: List[Optional[Callable[[], None]]] = [None] * n_ranks
        self._dropped = 0  # messages dropped due to dead destinations
        self._mu = threading.Lock()

    # -- failure simulation -------------------------------------------------
    def mark_dead(self, rank: int) -> None:
        with self._mu:
            self._dead[rank] = True
        with self._cvs[rank]:
            # undelivered user events die with the rank: account as dropped
            n_events = sum(1 for m in self._boxes[rank] if m.kind == EVENT)
            with self._mu:
                self._dropped += n_events
            self._boxes[rank].clear()
            self._cvs[rank].notify_all()

    def is_dead(self, rank: int) -> bool:
        return self._dead[rank]

    @property
    def dropped(self) -> int:
        return self._dropped

    # -- Transport API -------------------------------------------------------
    def set_notify(self, rank: int, fn: Optional[Callable[[], None]]) -> None:
        self._notify[rank] = fn

    def send(self, msg: Message) -> bool:
        if self._dead[msg.dst]:
            with self._mu:
                self._dropped += 1
            return False
        cv = self._cvs[msg.dst]
        with cv:
            if self._dead[msg.dst]:  # re-check under the box lock
                with self._mu:
                    self._dropped += 1
                return False
            self._boxes[msg.dst].append(msg)
            cv.notify()
        hook = self._notify[msg.dst]
        if hook is not None:
            hook()  # outside the mailbox lock: hook may take scheduler locks
        return True

    def send_many(self, msgs: List[Message]) -> int:
        delivered = 0
        by_dst: dict = {}
        for m in msgs:
            by_dst.setdefault(m.dst, []).append(m)
        for dst, ms in by_dst.items():
            if self._dead[dst]:
                with self._mu:
                    self._dropped += len(ms)
                continue
            cv = self._cvs[dst]
            with cv:
                if self._dead[dst]:
                    with self._mu:
                        self._dropped += len(ms)
                    continue
                self._boxes[dst].extend(ms)
                cv.notify()
            delivered += len(ms)
            hook = self._notify[dst]
            if hook is not None:
                hook()
        return delivered

    def recv(self, rank: int, timeout: Optional[float]) -> Optional[Message]:
        cv = self._cvs[rank]
        with cv:
            if not self._boxes[rank]:
                cv.wait(timeout)
            if self._boxes[rank]:
                return self._boxes[rank].popleft()
            return None

    def try_recv(self, rank: int) -> Optional[Message]:
        """Non-blocking single-message receive (utility; batch consumers
        use :meth:`drain`)."""
        cv = self._cvs[rank]
        with cv:
            if self._boxes[rank]:
                return self._boxes[rank].popleft()
            return None

    def recv_many(self, rank: int,
                  timeout: Optional[float]) -> List[Message]:
        """Blocking batched receive: wait up to ``timeout`` for the mailbox
        to be non-empty, then pop everything in one lock round-trip."""
        cv = self._cvs[rank]
        with cv:
            if not self._boxes[rank]:
                cv.wait(timeout)
            box = self._boxes[rank]
            if not box:
                return []
            out = list(box)
            box.clear()
            return out

    def drain(self, rank: int, max_n: Optional[int] = None) -> List[Message]:
        """Pop up to ``max_n`` pending messages (all, if None) in FIFO order
        with a single lock round-trip.  Never blocks."""
        with self._cvs[rank]:
            box = self._boxes[rank]
            if not box:
                return []
            if max_n is None or max_n >= len(box):
                out = list(box)
                box.clear()
            else:
                out = [box.popleft() for _ in range(max_n)]
            return out

    def wake(self, rank: int) -> None:
        with self._cvs[rank]:
            self._cvs[rank].notify_all()

    def pending(self, rank: int) -> int:
        """Number of undelivered messages queued for ``rank``."""
        with self._cvs[rank]:
            return len(self._boxes[rank])
