"""TCP socket transport: EDAT ranks as separate OS processes (paper §II.F).

Implements the full :class:`~repro_torch.core.transport.Transport` contract over
stream sockets with length-prefixed pickled frames (:mod:`repro_torch.net.frames`):

* **Placement** — one transport instance serves *all* the ranks of one OS
  process (``local_ranks``); ``placement`` maps every process (identified
  by its lowest hosted rank, the *lead*) to the ranks it hosts.  There is
  exactly **one TCP connection per unordered process pair** — co-located
  ranks share it — and events between co-located ranks never touch a
  socket at all: they take the loopback path straight into the
  destination rank's inbox (verified by the ``wire_*`` counters below).
  The default placement (no ``local_ranks``/``placement``) is the classic
  one-rank-per-process world, fully backward compatible.
* **FIFO** — each process-pair connection is written by exactly one
  writer (the per-process writer thread when coalescing, a per-connection
  lock otherwise) and read by one reader thread, so per-(src,dst)
  delivery order is exactly TCP byte order.  Loopback sends append
  atomically per destination inbox.
* **Coalescing** — the default fast path: ``send``/``send_many`` only
  *enqueue* onto a per-process send queue; a per-process writer thread
  drains the queue and packs many events into **one batch frame per
  syscall** (:func:`frames.encode_batch`, vectored ``sendmsg``) — events
  for different co-located destination ranks share batch frames.  While
  the writer is inside a syscall new sends pile up behind it, so batch
  size adapts to load with no added latency.  Knobs: ``flush_interval``
  (wait this long after the first queued message for a batch to
  accumulate; default 0 — purely opportunistic batching) and
  ``max_batch_bytes`` (approximate cap on one encoded batch; larger
  queues split into multiple frames).  ``coalesce=False`` restores the
  synchronous one-frame-per-send path.
* **Snapshots vs zero-copy** — fire-and-forget requires the payload to be
  snapshotted at fire time.  Ordinary messages are therefore batch-encoded
  *in-band, synchronously inside send* (the pickle is the snapshot; the
  writer thread only does syscalls).  Messages whose payload ownership was
  handed over (``Message.owned``, set by the runtime for ``ref=True``
  fires — the paper's ``EDAT_ADDRESS``) skip the fire-time pickle
  entirely: the writer thread encodes them with pickle protocol-5
  out-of-band buffers, so numpy payloads (BFS frontiers, MONC field
  slices, gradient trees) go from the firing task's buffer to the socket
  **zero-copy**.
* **Notification** — ``set_notify`` wakes an idle worker on arrival
  (worker-progress mode), exactly like the in-proc transport, per rank.
* **Failure detection** — every connection carries heartbeats; a peer
  process that goes silent past ``hb_timeout`` (or whose connection breaks
  without a clean BYE) is declared dead **with every rank it hosts**:
  ``on_peer_dead`` fires once per hosted rank, which the runtime wires to
  its ``RANK_FAILED`` machinery — survivors see one failure event per
  lost rank, exactly like ``kill_rank``.  Sends to dead ranks are dropped
  and counted, mirroring ``InProcTransport``.
* **Termination accounting** — per-peer ``sent_to``/``recv_from`` vectors
  (user events only; sent counts at *enqueue*, before the wire write, and
  received counts when a message is *popped* for delivery, so queued and
  in-flight events always read as in-flight).  The Mattern detector
  balances these across processes, restricted to alive ranks.  The
  parallel ``wire_sent_to``/``wire_recv_from`` vectors count only events
  that crossed (or will cross) a socket — co-located traffic never shows
  up there, which the placement tests assert.  When a peer process dies,
  every queued-but-unwritten user event to it is counted in ``dropped``
  exactly once: the send queue is drained under its condition variable
  with a dead flag raised first, so a send racing the death verdict is
  counted as dropped at enqueue instead of lingering unwritten (which
  would stall the detector to timeout).  The same accounting feeds the
  observability layer: :meth:`metrics` reports per-peer wire bytes,
  write batches, and the send-queue high-water mark alongside the
  wire/loopback event totals, so ``Session.stats()`` can show where the
  bytes went without any extra bookkeeping on the hot path.

Payloads must be picklable; :meth:`validate_payload` enforces this at
``ctx.fire()`` time so the error surfaces in the firing task.

Construction is normally via :func:`repro_torch.net.bootstrap.bootstrap` (or
``bootstrap_from_env``); tests may wire transports directly from
``socket.socketpair()`` ends.
"""
from __future__ import annotations

import pickle
import socket
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.transport import EVENT, Message, Transport

from . import frames

#: quickly-validatable payload leaf types (exact types, not subclasses:
#: a subclass can carry arbitrary unpicklable state — see validate_payload)
_PLAIN = frozenset((type(None), bool, int, float, complex, str, bytes,
                    bytearray))

#: deeply-immutable payload types: a fire-time snapshot is pointless (the
#: firing task cannot mutate them), so they take the deferred-encode path
#: even without ``Message.owned`` — the writer thread packs whole runs of
#: them into one batch frame / one pickle.  Exact types only: an int
#: *subclass* may hold mutable (or unpicklable) attribute state.
_IMMUTABLE = frozenset((type(None), bool, int, float, complex, str, bytes))


class SocketTransport(Transport):
    """Transport for one process's ranks over per-process-pair sockets."""

    distributed = True
    serializes = True

    def __init__(self, rank: int, n_ranks: int,
                 peers: Dict[int, socket.socket], *,
                 local_ranks: Optional[Sequence[int]] = None,
                 placement: Optional[Dict[int, Sequence[int]]] = None,
                 hb_interval: float = 0.5, hb_timeout: float = 5.0,
                 coalesce: bool = True, flush_interval: float = 0.0,
                 max_batch_bytes: int = 1 << 20,
                 dead_procs: Optional[Sequence[int]] = None):
        local = tuple(sorted(set(local_ranks))) if local_ranks else (rank,)
        assert rank in local, f"rank {rank} not in local_ranks {local}"
        if placement is None:
            placement = {local[0]: local}
            placement.update({r: (r,) for r in range(n_ranks)
                              if r not in local})
        self.placement: Dict[int, Tuple[int, ...]] = {
            int(l): tuple(sorted(int(r) for r in rs))
            for l, rs in placement.items()}
        covered = sorted(r for rs in self.placement.values() for r in rs)
        assert covered == list(range(n_ranks)), \
            f"placement {self.placement} does not partition 0..{n_ranks - 1}"
        assert all(l == rs[0] for l, rs in self.placement.items()), \
            "each process must be keyed by its lowest (lead) rank"
        assert self.placement[local[0]] == local
        self.rank = local[0]          # lead local rank
        self.n_ranks = n_ranks
        self.local_ranks = local
        self._proc_of = {r: l for l, rs in self.placement.items()
                         for r in rs}
        remote = set(self.placement) - {self.rank}
        # a transport built by an elastically-joining process starts with
        # some peer processes already dead (no socket to hand over); their
        # per-peer state exists so a later add_peer can splice them in
        dead_set = {int(p) for p in (dead_procs or ())}
        assert dead_set <= remote, \
            f"dead_procs {sorted(dead_set)} not all remote {sorted(remote)}"
        assert set(peers) == remote - dead_set, \
            (f"process {self.rank}{local}: need one socket per peer "
             f"process {sorted(remote - dead_set)}, got {sorted(peers)}")
        self._peers = peers
        self._send_mu = {p: threading.Lock() for p in remote}
        #: per-local-rank inboxes (pull mode) and their condition variables
        self._inbox: Dict[int, deque] = {r: deque() for r in local}
        self._cv = {r: threading.Condition() for r in local}
        self._notify: Dict[int, Optional[Callable[[], None]]] = \
            {r: None for r in local}
        #: callback(rank) invoked (outside locks) when a peer rank is
        #: declared dead by the heartbeat/EOF detector — once per rank the
        #: failed process hosted; set by the Runtime
        self.on_peer_dead: Optional[Callable[[int], None]] = None
        #: callback(rank) invoked (outside locks) when a replacement
        #: process re-hosting a dead peer's ranks is spliced in via
        #: :meth:`add_peer` — once per revived rank; set by the Runtime
        self.on_peer_join: Optional[Callable[[int], None]] = None
        #: push-mode delivery: when the runtime registers this callback the
        #: reader threads hand message batches straight to it, skipping the
        #: inbox and the progress-thread wakeup hop (one fewer context
        #: switch per message on the latency path).  Batches may mix
        #: destination ranks; the runtime routes by ``Message.dst``.
        self._deliver: Optional[Callable[[List[Message]], None]] = None
        self._dmu = threading.Lock()   # guards the _deliver handover

        self._mu = threading.Lock()
        self._dead = [False] * n_ranks
        for p in dead_set:
            for r in self.placement[p]:
                self._dead[r] = True
        self._sock_dead = {p: p in dead_set for p in remote}  # per process
        self._bye = set()          # peer processes that closed cleanly
        self._dropped = 0
        self._sent_to = [0] * n_ranks     # user events enqueued per dst
        self._recv_from = [0] * n_ranks   # user events popped per src
        #: socket-only counterparts: co-located (loopback) traffic never
        #: appears here — the placement tests assert exactly that
        self._wire_sent_to = [0] * n_ranks
        self._wire_recv_from = [0] * n_ranks
        self._last_seen = {p: time.monotonic() for p in remote}
        self._closing = False
        self._close_started = False
        self._splicing = set()     # peer procs with an add_peer in flight

        # writer-side coalescing state (one queue + writer thread per peer
        # process — co-located destinations share batch frames)
        self.coalesce = bool(coalesce)
        self.flush_interval = flush_interval
        self.max_batch_bytes = int(max_batch_bytes)
        self._sendq: Dict[int, deque] = {p: deque() for p in remote}
        self._sendcv = {p: threading.Condition() for p in remote}
        self._wbusy = {p: False for p in remote}  # writer mid-write
        #: set (under the peer's send condvar) when the peer's queue was
        #: dropped on death: an enqueue that raced the verdict counts its
        #: events dropped instead of queueing them forever-unwritten
        self._q_dead = {p: p in dead_set for p in remote}
        # per-peer wire-level observability (bytes handed to the kernel,
        # write batches, send-queue high-water mark)
        self._m_wire_bytes = {p: 0 for p in remote}
        self._m_writes = {p: 0 for p in remote}
        self._m_sendq_max = {p: 0 for p in remote}

        self._hb_interval = hb_interval
        self._hb_timeout = hb_timeout
        self._threads: List[threading.Thread] = []
        #: live reader/writer threads per peer process — add_peer joins a
        #: dead peer's old threads before spawning replacements, so one
        #: connection never has two writers interleaving frame pieces
        self._peer_threads: Dict[int, List[threading.Thread]] = \
            {p: [] for p in remote}
        for p in peers:
            t = threading.Thread(target=self._reader, args=(p,), daemon=True,
                                 name=f"edat-net-r{self.rank}<{p}")
            self._threads.append(t)
            self._peer_threads[p].append(t)
            t.start()
        if self.coalesce:
            for p in peers:
                t = threading.Thread(target=self._writer, args=(p,),
                                     daemon=True,
                                     name=f"edat-net-w{self.rank}>{p}")
                self._threads.append(t)
                self._peer_threads[p].append(t)
                t.start()
        self._hb_stop = threading.Event()
        if hb_interval > 0 and remote:
            t = threading.Thread(target=self._heartbeat_loop, daemon=True,
                                 name=f"edat-net-hb{self.rank}")
            self._threads.append(t)
            t.start()

    # ------------------------------------------------------- local delivery
    def _deliver_local(self, msgs: List[Message], *,
                       from_wire: bool = False) -> None:
        """Hand ``msgs`` (any mix of local destination ranks) to push-mode
        delivery or the per-rank inboxes.  Messages for a locally-dead
        destination are dropped (their events die with the rank)."""
        live: List[Message] = []
        n_dead = 0
        for m in msgs:
            if m.dst in self._inbox and not self._dead[m.dst]:
                live.append(m)
            elif m.kind == EVENT:
                n_dead += 1
        if n_dead:
            with self._mu:
                self._dropped += n_dead
        if not live:
            return
        if from_wire:
            with self._mu:
                for m in live:
                    if m.kind == EVENT:
                        self._wire_recv_from[m.src] += 1
        with self._dmu:
            push = self._deliver
            if push is None:
                by_dst: Dict[int, List[Message]] = {}
                for m in live:
                    by_dst.setdefault(m.dst, []).append(m)
                for r, ms in by_dst.items():
                    with self._cv[r]:
                        self._inbox[r].extend(ms)
                        self._cv[r].notify()
        if push is not None:
            # deliver BEFORE counting: recv_from must never include an
            # event the scheduler has not seen, or the detector could
            # observe balanced counters + idle schedulers while the event
            # sits on a descheduled reader (rcv < sent in the gap is the
            # safe direction — it only delays a poll)
            push(live)
            self._count_popped(live)
        else:
            for r in {m.dst for m in live}:
                hook = self._notify.get(r)
                if hook is not None:
                    hook()  # outside inbox locks (may take sched locks)

    # ---------------------------------------------------------- reader side
    def _reader(self, peer: int) -> None:
        """Per-peer-process reader: one blocking ``recv`` per burst, then
        decode *every* complete frame already buffered and hand the whole
        run of messages (any mix of co-located destination ranks) to the
        scheduler in one delivery — the receive-side mirror of the
        writer's coalescing."""
        sock = self._peers[peer]
        buf = bytearray()
        while True:
            try:
                data = sock.recv(1 << 16)
            except OSError:
                data = b""
            eof = not data
            if data:
                buf += data
                with self._mu:
                    self._last_seen[peer] = time.monotonic()
            decoded, used, corrupt = frames.decode_buffer(buf)
            if used:
                del buf[:used]
            msgs: List[Message] = []
            for frame in decoded:
                kind = frame[0]
                if kind == frames.MSGS:
                    msgs.extend(frame[1])
                elif kind == frames.MSG:
                    msgs.append(frame[1])
                elif kind == frames.BYE:
                    with self._mu:
                        self._bye.add(peer)
                    # keep reading until EOF so late frames cannot be lost
                elif kind == frames.PEER_JOINED:
                    # the coordinator announced an elastic rejoin: dial the
                    # replacement off-thread (the dial blocks) and splice
                    # it in via add_peer when the HELLO lands
                    _, j_lead, j_addr = frame
                    threading.Thread(
                        target=self.dial_peer,
                        args=(int(j_lead), (str(j_addr[0]), int(j_addr[1]))),
                        daemon=True,
                        name=f"edat-net-join{self.rank}>{j_lead}").start()
                # HEARTBEAT: nothing beyond the last_seen update above
            if msgs:
                self._deliver_local(msgs, from_wire=True)
            if eof or corrupt:
                with self._mu:
                    clean = self._closing
                if not clean:
                    self._declare_proc_dead(peer)  # silent after a BYE
                return

    def _heartbeat_loop(self) -> None:
        beat = frames.encode((frames.HEARTBEAT,))
        while not self._hb_stop.wait(self._hb_interval):
            now = time.monotonic()
            for p in list(self._peers):
                with self._mu:
                    if self._sock_dead[p] or p in self._bye or self._closing:
                        continue
                    stale = now - self._last_seen[p] > self._hb_timeout
                if stale:
                    self._declare_proc_dead(p)
                    continue
                if self.coalesce:
                    self._enqueue(p, [("enc", [beat], 0)])
                    continue
                try:
                    with self._send_mu[p]:
                        self._peers[p].sendall(beat)
                except OSError:
                    self._declare_proc_dead(p)

    @staticmethod
    def _teardown(sock: socket.socket) -> None:
        """Force-close: shutdown reaches the peer (and unblocks our reader)
        even while a buffered makefile still holds the fd refcount."""
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _declare_proc_dead(self, peer: int) -> None:
        """Failure detector verdict on a peer *process*: mark every rank it
        hosts dead, close the connection, notify the runtime once per lost
        rank.  A process that already said BYE is marked dead *silently* —
        a broken connection after a clean goodbye is shutdown skew, not a
        failure."""
        with self._mu:
            if self._sock_dead[peer] or self._closing:
                return
            self._sock_dead[peer] = True
            was_clean = peer in self._bye
            newly = [r for r in self.placement[peer] if not self._dead[r]]
            for r in newly:
                self._dead[r] = True
        self._teardown(self._peers[peer])
        self._drop_queue(peer)  # queued-but-unwritten sends die with it
        for r in self.local_ranks:
            self.wake(r)  # a blocked recv should re-check the world
        cb = self.on_peer_dead
        if cb is not None and not was_clean:
            for r in newly:
                cb(r)

    # ----------------------------------------------------- coalescing writer
    def _enqueue(self, proc: int, items: List) -> None:
        """Append items to peer process ``proc``'s send queue in one lock
        round-trip.  Items are either a :class:`Message` (owned payload;
        the writer encodes it late with out-of-band buffers) or ``("enc",
        pieces, n_events)`` (a pre-encoded snapshot frame).

        If the peer died and its queue was already dropped, the items are
        counted as dropped *here* instead of being queued: the lock-free
        dead check in ``send`` can race the death verdict, and an event
        parked on a dead queue would otherwise be counted neither sent-on
        nor dropped — unbalancing the termination accounting."""
        cv = self._sendcv[proc]
        with cv:
            if not self._q_dead[proc]:
                q = self._sendq[proc]
                q.extend(items)
                if len(q) > self._m_sendq_max[proc]:
                    self._m_sendq_max[proc] = len(q)
                cv.notify_all()
                return
        self._count_items_dropped(items)

    def _count_items_dropped(self, items) -> None:
        """Account queue items that will never reach the wire."""
        n = 0
        for it in items:
            if isinstance(it, Message):
                n += 1 if it.kind == EVENT else 0
            else:
                n += it[2]
        if n:
            with self._mu:
                self._dropped += n

    def _drop_queue(self, proc: int) -> None:
        """Discard ``proc``'s queued sends, counting user events dropped.
        Raises the queue's dead flag under the condvar first, so any
        concurrent ``_enqueue`` either lands before the drain (counted
        here) or observes the flag and counts itself — every discarded
        event is accounted exactly once either way."""
        cv = self._sendcv.get(proc)
        if cv is None:
            return
        with cv:
            self._q_dead[proc] = True
            items = list(self._sendq[proc])
            self._sendq[proc].clear()
            cv.notify_all()
        self._count_items_dropped(items)

    @staticmethod
    def _rough_nbytes(msg: Message) -> int:
        """Cheap size estimate used to split oversized write batches."""
        data = getattr(msg.payload, "data", msg.payload)
        n = 512
        if isinstance(data, np.ndarray):
            n += data.nbytes
        elif isinstance(data, dict):
            for v in data.values():
                n += v.nbytes if isinstance(v, np.ndarray) else 64
        elif isinstance(data, (list, tuple)):
            for v in data:
                n += v.nbytes if isinstance(v, np.ndarray) else 64
        return n

    def _writer(self, peer: int) -> None:
        """Per-peer-process writer thread: drain the send queue, pack runs
        of owned messages into batch frames (protocol-5 out-of-band
        buffers), and push everything to the kernel with one vectored
        send."""
        sock = self._peers[peer]
        q = self._sendq[peer]
        cv = self._sendcv[peer]
        while True:
            with cv:
                while not q:
                    if self._sock_dead[peer] or self._closing:
                        return
                    cv.wait()
                if self.flush_interval > 0:
                    # let a batch accumulate behind the first message; loop
                    # on a deadline — every enqueue notifies the condvar,
                    # so a single timed wait would return after one message
                    end = time.monotonic() + self.flush_interval
                    while not self._sock_dead[peer] and not self._closing:
                        left = end - time.monotonic()
                        if left <= 0:
                            break
                        cv.wait(left)
                items = list(q)
                q.clear()
                self._wbusy[peer] = True
            try:
                if self._sock_dead[peer]:
                    # popped concurrently with the death verdict:
                    # _drop_queue saw an empty queue, so count these here
                    self._count_items_dropped(items)
                    return
                try:
                    self._write_items(peer, sock, items)
                except OSError:
                    with self._mu:
                        closing = self._closing
                    if not closing:
                        self._declare_proc_dead(peer)
                    # like the synchronous path, the whole failed write
                    # counts as dropped (some bytes may have made it out,
                    # but the peer is gone either way)
                    self._count_items_dropped(items)
                    return
            finally:
                with cv:
                    self._wbusy[peer] = False
                    cv.notify_all()

    def _write_items(self, peer: int, sock: socket.socket,
                     items: List) -> None:
        pieces: List = []
        run: List[Message] = []
        run_bytes = 0

        def flush_run():
            nonlocal run_bytes
            if not run:
                return
            try:
                pieces.extend(frames.encode_batch(run, oob=True))
            except Exception:
                # an unpicklable slipped past validate_payload: salvage the
                # rest of the run, drop (and count) the poison messages
                for m in run:
                    try:
                        pieces.extend(frames.encode_batch([m], oob=False))
                    except Exception:
                        if m.kind == EVENT:
                            with self._mu:
                                self._dropped += 1
            run.clear()
            run_bytes = 0

        for it in items:
            if isinstance(it, Message):
                run.append(it)
                run_bytes += self._rough_nbytes(it)
                if run_bytes >= self.max_batch_bytes:
                    flush_run()
            else:
                flush_run()
                pieces.extend(it[1])
        flush_run()
        nbytes = 0
        for p in pieces:
            nbytes += len(p) if isinstance(p, (bytes, bytearray)) \
                else memoryview(p).nbytes
        self._sendall_vec(sock, pieces)
        with self._mu:
            self._m_wire_bytes[peer] += nbytes
            self._m_writes[peer] += 1

    @staticmethod
    def _sendall_vec(sock: socket.socket, pieces: List) -> None:
        """Write every piece, scatter/gather where the OS supports it."""
        views = []
        for p in pieces:
            mv = p if isinstance(p, memoryview) else memoryview(p)
            if mv.ndim != 1 or mv.format != "B":
                mv = mv.cast("B")
            if len(mv):
                views.append(mv)
        if not views:
            return
        if not hasattr(sock, "sendmsg"):  # pragma: no cover - posix only
            sock.sendall(b"".join(views))
            return
        i = 0
        while i < len(views):
            sent = sock.sendmsg(views[i:i + 64])
            while sent > 0:
                v = views[i]
                if sent >= len(v):
                    sent -= len(v)
                    i += 1
                else:
                    views[i] = v[sent:]
                    sent = 0

    def flush(self, timeout: Optional[float] = 5.0) -> bool:
        """Block until every peer process's send queue has drained to the
        kernel (or ``timeout`` expires).  Returns True when fully flushed.
        Only meaningful with coalescing; a no-op (True) otherwise."""
        if not self.coalesce:
            return True
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else 1e9)
        ok = True
        for p, cv in self._sendcv.items():
            with cv:
                while ((self._sendq[p] or self._wbusy[p])
                       and not self._sock_dead[p]):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        ok = False
                        break
                    cv.wait(min(left, 0.05))
        return ok

    # ---------------------------------------------------------- send side
    def validate_payload(self, data) -> None:
        if self._quick_picklable(data):
            return
        try:
            pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL)
        except Exception as e:
            raise TypeError(
                f"event payload of type {type(data).__name__!r} is not "
                f"picklable, which SocketTransport requires to cross "
                f"process boundaries: {e}") from e

    @classmethod
    def _quick_picklable(cls, data, depth: int = 0) -> bool:
        """Structural fast path for the common payload shapes (numbers,
        strings, numpy arrays, shallow containers of those) so fire-time
        validation does not pickle a large array twice.  Exact-type checks
        only: a subclass (e.g. a defaultdict with a lambda factory) may
        carry unpicklable state, so anything this cannot *prove* falls
        back to a real ``pickle.dumps`` probe."""
        t = type(data)
        if t in _PLAIN:
            return True
        if t is np.ndarray or isinstance(data, np.generic):
            # hasobject also catches structured dtypes with object fields,
            # which a plain `dtype != object` comparison lets through
            return not data.dtype.hasobject
        if depth >= 3:
            return False
        if t in (list, tuple, set, frozenset):
            return all(cls._quick_picklable(v, depth + 1) for v in data)
        if t is dict:
            return all(cls._quick_picklable(k, depth + 1)
                       and cls._quick_picklable(v, depth + 1)
                       for k, v in data.items())
        return False

    @staticmethod
    def _late_encodable(msg: Message) -> bool:
        """True when the writer thread may serialise ``msg`` lazily: the
        payload was handed over (``owned``) or is deeply immutable, so no
        fire-time snapshot is required."""
        if getattr(msg, "owned", False):
            return True
        return (msg.kind == EVENT
                and type(msg.payload.data) in _IMMUTABLE)

    def _encode_msg(self, msg: Message) -> bytes:
        try:
            return frames.encode((frames.MSG, msg))
        except Exception as e:
            raise TypeError(
                f"message to rank {msg.dst} (eid "
                f"{getattr(msg.payload, 'eid', msg.payload)!r}) cannot be "
                f"pickled for SocketTransport: {e}") from e

    def _encode_snapshot(self, msgs: List[Message]) -> List:
        """Fire-time snapshot of a batch: one in-band batch frame."""
        try:
            return frames.encode_batch(msgs, oob=False)
        except Exception as e:
            m = msgs[0]
            raise TypeError(
                f"message to rank {m.dst} (eid "
                f"{getattr(m.payload, 'eid', m.payload)!r}) cannot be "
                f"pickled for SocketTransport: {e}") from e

    def set_deliver(self, fn: Callable[[List[Message]], None]) -> None:
        """Enable push-mode delivery (used by the Runtime): the reader
        threads call ``fn(batch)`` directly instead of queueing into the
        per-rank inboxes.  Batches may mix co-located destination ranks;
        the runtime routes by ``Message.dst``.  Messages that arrived
        before registration are flushed to ``fn`` under the handover lock,
        so per-(src,dst) FIFO order survives the handover."""
        with self._dmu:
            backlog: List[Message] = []
            for r in self.local_ranks:
                with self._cv[r]:
                    backlog.extend(self._inbox[r])
                    self._inbox[r].clear()
            if backlog:
                fn(backlog)  # deliver-then-count, as in the reader path
                self._count_popped(backlog)
            self._deliver = fn

    def _loopback(self, msgs: List[Message]) -> None:
        """Co-located delivery: no socket, no serialisation — events go
        straight to the destination rank's inbox / push delivery."""
        with self._mu:
            for m in msgs:
                if m.kind == EVENT:
                    self._sent_to[m.dst] += 1
        self._deliver_local(msgs)

    def _queue_remote(self, proc: int, ms: List[Message]) -> None:
        """Coalescing enqueue of ``ms`` (same destination process) with
        the snapshot/late-encode split applied per message run."""
        items: List = []
        snap: List[Message] = []
        snap_ev = 0
        for m in ms:
            if self._late_encodable(m):
                if snap:
                    items.append(("enc", self._encode_snapshot(snap),
                                  snap_ev))
                    snap, snap_ev = [], 0
                items.append(m)
            else:
                snap.append(m)
                snap_ev += 1 if m.kind == EVENT else 0
        if snap:
            items.append(("enc", self._encode_snapshot(snap), snap_ev))
        self._enqueue(proc, items)

    def send(self, msg: Message) -> bool:
        dst = msg.dst
        if dst in self._inbox:            # co-located (including self)
            if self._dead[dst]:
                with self._mu:
                    self._dropped += 1
                return False
            self._loopback([msg])
            return True
        if self._dead[dst]:
            with self._mu:
                self._dropped += 1
            return False
        proc = self._proc_of[dst]
        if self.coalesce:
            if msg.kind == EVENT:
                with self._mu:
                    self._sent_to[dst] += 1
                    self._wire_sent_to[dst] += 1
            if self._late_encodable(msg):
                self._enqueue(proc, [msg])
            else:
                self._enqueue(proc, [("enc", self._encode_snapshot([msg]),
                                     1 if msg.kind == EVENT else 0)])
            return True
        data = self._encode_msg(msg)
        try:
            with self._send_mu[proc]:
                self._peers[proc].sendall(data)
        except OSError:
            self._declare_proc_dead(proc)
            with self._mu:
                self._dropped += 1
            return False
        with self._mu:
            self._m_wire_bytes[proc] += len(data)
            self._m_writes[proc] += 1
            if msg.kind == EVENT:
                self._sent_to[dst] += 1
                self._wire_sent_to[dst] += 1
        return True

    def send_many(self, msgs: List[Message]) -> int:
        local: Dict[int, List[Message]] = {}
        remote: Dict[int, List[Message]] = {}   # peer process -> messages
        n_dead = 0
        for m in msgs:
            if m.dst in self._inbox:
                if self._dead[m.dst]:
                    n_dead += 1
                else:
                    local.setdefault(m.dst, []).append(m)
            elif self._dead[m.dst]:
                n_dead += 1
            else:
                remote.setdefault(self._proc_of[m.dst], []).append(m)
        if n_dead:
            with self._mu:
                self._dropped += n_dead
        delivered = 0
        for dst, ms in local.items():
            self._loopback(ms)
            delivered += len(ms)
        for proc, ms in remote.items():
            if self.coalesce:
                with self._mu:
                    for m in ms:
                        if m.kind == EVENT:
                            self._sent_to[m.dst] += 1
                            self._wire_sent_to[m.dst] += 1
                self._queue_remote(proc, ms)
                delivered += len(ms)
                continue
            blob = b"".join(self._encode_msg(m) for m in ms)
            try:
                with self._send_mu[proc]:
                    self._peers[proc].sendall(blob)
            except OSError:
                self._declare_proc_dead(proc)
                with self._mu:
                    self._dropped += len(ms)
                continue
            with self._mu:
                self._m_wire_bytes[proc] += len(blob)
                self._m_writes[proc] += 1
                for m in ms:
                    if m.kind == EVENT:
                        self._sent_to[m.dst] += 1
                        self._wire_sent_to[m.dst] += 1
            delivered += len(ms)
        return delivered

    # --------------------------------------------------------- receive side
    def _count_popped(self, msgs) -> None:
        # pop-based receives count here, at the moment the caller takes
        # ownership; a Runtime always runs this transport in push mode,
        # where counting happens strictly *after* scheduler delivery
        with self._mu:
            for m in msgs:
                if m.kind == EVENT:
                    self._recv_from[m.src] += 1

    def recv(self, rank: int, timeout: Optional[float]) -> Optional[Message]:
        assert rank in self._inbox
        with self._cv[rank]:
            if not self._inbox[rank]:
                self._cv[rank].wait(timeout)
            if not self._inbox[rank]:
                return None
            msg = self._inbox[rank].popleft()
        self._count_popped((msg,))
        return msg

    def recv_many(self, rank: int,
                  timeout: Optional[float]) -> List[Message]:
        assert rank in self._inbox
        with self._cv[rank]:
            if not self._inbox[rank]:
                self._cv[rank].wait(timeout)
            out = list(self._inbox[rank])
            self._inbox[rank].clear()
        self._count_popped(out)
        return out

    def drain(self, rank: int, max_n: Optional[int] = None) -> List[Message]:
        assert rank in self._inbox
        with self._cv[rank]:
            box = self._inbox[rank]
            if not box:
                return []
            if max_n is None or max_n >= len(box):
                out = list(box)
                box.clear()
            else:
                out = [box.popleft() for _ in range(max_n)]
        self._count_popped(out)
        return out

    def wake(self, rank: int) -> None:
        cv = self._cv.get(rank)
        if cv is None:
            return
        with cv:
            cv.notify_all()

    def set_notify(self, rank: int,
                   fn: Optional[Callable[[], None]]) -> None:
        assert rank in self._inbox
        self._notify[rank] = fn

    # ------------------------------------------------------- failure / info
    def is_dead(self, rank: int) -> bool:
        return self._dead[rank]

    def mark_dead(self, rank: int) -> None:
        """Local failure injection (``kill_rank`` parity): stop sending to
        ``rank`` without invoking the peer-death callback — the caller is
        responsible for its own RANK_FAILED notification.  A remote
        process's connection is only severed once *every* rank it hosts
        has been marked dead (co-located survivors keep using it); a local
        rank's inbox is cleared, its queued events counted as dropped."""
        with self._mu:
            if self._dead[rank]:
                return
            self._dead[rank] = True
        if rank in self._inbox:
            with self._cv[rank]:
                n = sum(1 for m in self._inbox[rank] if m.kind == EVENT)
                self._inbox[rank].clear()
                self._cv[rank].notify_all()
            if n:
                with self._mu:
                    self._dropped += n
            return
        proc = self._proc_of[rank]
        with self._mu:
            sever = (not self._sock_dead[proc]
                     and all(self._dead[r] for r in self.placement[proc]))
            if sever:
                self._sock_dead[proc] = True
        if sever:
            self._teardown(self._peers[proc])  # plain close() would leave
            # the reader's fd alive and keep delivering dead-rank events
            self._drop_queue(proc)

    # --------------------------------------------------------- elastic join
    def add_peer(self, lead: int, sock: socket.socket) -> bool:
        """Splice a replacement process's connection into the live mesh.

        ``lead`` must be the lead rank of a placement entry whose ranks
        are ALL currently dead (the replacement re-hosts exactly the dead
        process's ranks, so the placement never changes shape).  Sequence
        matters: the dead peer's old reader/writer threads are joined
        first (two writers on one socket would interleave frame pieces),
        queue state is reset before the new writer starts (it checks the
        dead flags), counters for the re-hosted ranks are zeroed (the new
        incarnation starts from zero, and the termination balance must be
        computed against *its* traffic), and only then are the ranks
        marked alive — a send observing ``_dead[r] == False`` must find a
        working queue behind it.  Returns False (closing ``sock``) when
        the splice is not applicable."""
        ranks = self.placement.get(lead)
        with self._mu:
            ok = (ranks is not None and lead != self.rank
                  and not self._closing and lead not in self._splicing
                  and self._sock_dead.get(lead, False)
                  and all(self._dead[r] for r in ranks))
            if ok:
                self._splicing.add(lead)   # claim: one splice at a time
        if not ok:
            self._teardown(sock)
            return False
        try:
            for t in self._peer_threads[lead]:
                t.join(5.0)
                if t.is_alive():           # wedged old thread: abort
                    self._teardown(sock)
                    return False
            self._peer_threads[lead] = []
            with self._sendcv[lead]:
                self._sendq[lead].clear()
                self._q_dead[lead] = False
                self._wbusy[lead] = False
            with self._mu:
                self._peers[lead] = sock
                self._sock_dead[lead] = False
                self._bye.discard(lead)
                self._last_seen[lead] = time.monotonic()
                for r in ranks:
                    self._sent_to[r] = 0
                    self._recv_from[r] = 0
                    self._wire_sent_to[r] = 0
                    self._wire_recv_from[r] = 0
            news = [threading.Thread(target=self._reader, args=(lead,),
                                     daemon=True,
                                     name=f"edat-net-r{self.rank}<{lead}")]
            if self.coalesce:
                news.append(threading.Thread(
                    target=self._writer, args=(lead,), daemon=True,
                    name=f"edat-net-w{self.rank}>{lead}"))
            self._peer_threads[lead] = news
            self._threads.extend(news)
            for t in news:
                t.start()
            with self._mu:
                for r in ranks:
                    self._dead[r] = False
        finally:
            with self._mu:
                self._splicing.discard(lead)
        cb = self.on_peer_join
        if cb is not None:
            for r in ranks:
                cb(r)
        for r in self.local_ranks:
            self.wake(r)   # blocked receivers should re-check the world
        return True

    def dial_peer(self, lead: int, addr: Tuple[str, int],
                  timeout: float = 10.0) -> bool:
        """Dial a just-announced replacement process, identify ourselves
        with a HELLO, and splice the connection in via :meth:`add_peer`."""
        try:
            s = socket.create_connection(addr, timeout=timeout)
            frames.send_frame(s, (frames.HELLO, self.rank))
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(None)
        except OSError:
            return False
        return self.add_peer(lead, s)

    def announce_join(self, lead: int, addr: Tuple[str, int]) -> None:
        """Broadcast ``PEER_JOINED`` to every live peer process: each one
        dials the newcomer at ``addr`` and splices it in (the coordinator
        calls this after accepting an elastic JOIN)."""
        frame = frames.encode((frames.PEER_JOINED, lead, tuple(addr)))
        for p in list(self._peers):
            if p == lead:
                continue
            with self._mu:
                if (self._sock_dead.get(p, True) or p in self._bye
                        or self._closing):
                    continue
            if self.coalesce:
                self._enqueue(p, [("enc", [frame], 0)])
                continue
            try:
                with self._send_mu[p]:
                    self._peers[p].sendall(frame)
            except OSError:
                self._declare_proc_dead(p)

    @property
    def dropped(self) -> int:
        return self._dropped

    def pending(self, rank: int) -> int:
        with self._cv[rank]:
            return len(self._inbox[rank])

    def sent_vector(self) -> List[int]:
        with self._mu:
            return list(self._sent_to)

    def recv_vector(self) -> List[int]:
        with self._mu:
            return list(self._recv_from)

    def wire_sent_vector(self) -> List[int]:
        """Per-destination count of user events that took a socket (the
        co-located loopback path never increments this)."""
        with self._mu:
            return list(self._wire_sent_to)

    def wire_recv_vector(self) -> List[int]:
        """Per-source count of user events that arrived over a socket."""
        with self._mu:
            return list(self._wire_recv_from)

    def metrics(self) -> dict:
        """Wire-level observability snapshot for this process (consumed by
        ``Runtime.metrics()`` / ``Session.stats()``): event totals split
        wire vs loopback, drop count, and per-peer-process bytes, write
        batches, and send-queue high-water mark."""
        with self._mu:
            return {
                "kind": "socket",
                "coalesce": self.coalesce,
                "wire_events_sent": sum(self._wire_sent_to),
                "wire_events_recv": sum(self._wire_recv_from),
                "loopback_events": (sum(self._sent_to)
                                    - sum(self._wire_sent_to)),
                "dropped": self._dropped,
                "wire_bytes": sum(self._m_wire_bytes.values()),
                "writes": sum(self._m_writes.values()),
                "sendq_max": max(self._m_sendq_max.values(), default=0),
                "peers": {p: {"wire_bytes": self._m_wire_bytes[p],
                              "writes": self._m_writes[p],
                              "sendq_max": self._m_sendq_max[p]}
                          for p in self._peers},
            }

    # -------------------------------------------------------------- close
    def close(self) -> None:
        """Clean shutdown: BYE every live peer process (so their failure
        detectors stay quiet), flush the write queues, close all sockets,
        release blocked receivers."""
        with self._mu:
            if self._close_started:
                return
            self._close_started = True
        self._hb_stop.set()
        bye = frames.encode((frames.BYE,))
        if self.coalesce:
            # the BYE must take the same path as queued data so it is the
            # *last* frame on the wire; then wait for the writers to drain
            for p in self._peers:
                if not self._sock_dead[p]:
                    self._enqueue(p, [("enc", [bye], 0)])
            self.flush(timeout=1.0)
        else:
            for p, sock in self._peers.items():
                if not self._sock_dead[p]:
                    try:
                        with self._send_mu[p]:
                            sock.sendall(bye)
                    except OSError:
                        pass
        with self._mu:
            self._closing = True
        for cv in self._sendcv.values():
            with cv:
                cv.notify_all()  # writers observe _closing and exit
        for sock in self._peers.values():
            self._teardown(sock)  # readers unblock with EOF -> clean exit
        for r in self.local_ranks:
            self.wake(r)
        for t in self._threads:
            t.join(0.5)
