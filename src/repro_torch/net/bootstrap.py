"""Rendezvous: wire up all-pairs connections for :class:`SocketTransport`.

Coordinator pattern (rank 0 + environment addressing, the usual launcher
contract of distributed runtimes).  The unit of rendezvous is a *process*,
identified by the lowest rank it hosts (its **lead**) — a process may host
several ranks (``local_ranks``), and co-located ranks share the process's
connections:

1. every process opens a listening socket on an ephemeral port;
2. the process hosting rank 0 additionally listens on the well-known
   *coordinator* address (with a bind-retry loop: the launcher probes a
   free port and releases it before the child re-binds it, so a TOCTOU
   loser waits for the squatter instead of crashing);
3. the other processes dial the coordinator and register their lead,
   hosted ranks, and listen address (re-dialing if they reached a
   squatter that hung up or spoke garbage instead of the placement
   reply — the dial side of the same race);
4. the coordinator replies to each with the complete placement
   ``{lead: (address, ranks)}``;
5. each process dials every lower-lead process (identified by a HELLO
   frame), accepts from every higher one — one TCP connection per
   unordered process pair, used bidirectionally by all hosted ranks.

Because every process listens *before* registering with the coordinator,
no peer can learn an address that is not yet accepting — dialing needs no
retry loop (a short one is kept for OS-level accept-queue hiccups).

Environment contract (used by ``python -m repro_torch.net.launch`` and usable by
any external process manager, e.g. one process per node under slurm/k8s):

* ``EDAT_RANK``        — this process's lead rank;
* ``EDAT_LOCAL_RANKS`` — optional comma list of ranks this process hosts
  (default: just ``EDAT_RANK``);
* ``EDAT_NRANKS``      — world size;
* ``EDAT_COORD``       — ``host:port`` of the rank-0 coordinator;
* ``EDAT_HOST``        — optional bind/advertise host (default
  ``127.0.0.1``).
"""
from __future__ import annotations

import errno
import os
import pickle
import socket
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

from . import frames
from .socket_transport import SocketTransport

Addr = Tuple[str, int]


def _listener(host: str, port: int = 0, backlog: int = 64) -> socket.socket:
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(backlog)
    return srv


def _listener_retry(host: str, port: int, deadline: float,
                    backlog: int = 64) -> socket.socket:
    """Bind a well-known port, retrying on EADDRINUSE until ``deadline``.

    The coordinator port is probed by the launcher parent and *released*
    before this child re-binds it — another process can grab it in the
    gap (the classic free-port TOCTOU).  Retrying turns a transient
    squatter (TIME_WAIT, a short-lived test socket, a just-exited
    previous run) into a short wait instead of a crashed world."""
    while True:
        try:
            return _listener(host, port, backlog)
        except OSError as e:
            if e.errno != errno.EADDRINUSE or time.monotonic() >= deadline:
                raise
            time.sleep(0.05)


def _dial(addr: Addr, deadline: float) -> socket.socket:
    last = None
    while time.monotonic() < deadline:
        try:
            return socket.create_connection(
                addr, timeout=max(0.1, deadline - time.monotonic()))
        except OSError as e:
            last = e
            time.sleep(0.05)
    raise RuntimeError(f"bootstrap: could not connect to {addr}: {last}")


def _configure(sock: socket.socket) -> socket.socket:
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(None)
    return sock


def bootstrap(rank: int, n_ranks: int, coord_addr: Addr, *,
              local_ranks: Optional[Sequence[int]] = None,
              host: str = "127.0.0.1", timeout: float = 30.0,
              hb_interval: float = 0.5, hb_timeout: float = 5.0,
              elastic: bool = False,
              **transport_kw) -> SocketTransport:
    """Run the process-level rendezvous and return a connected transport.

    ``rank`` is this process's lead rank; ``local_ranks`` lists every rank
    the process hosts (default: just ``rank`` — the classic one-rank-per-
    process world).  Extra keyword arguments (``coalesce``,
    ``flush_interval``, ``max_batch_bytes``) pass through to
    :class:`SocketTransport`.

    With ``elastic=True`` the rank-0 process keeps the coordinator
    listener open after rendezvous and serves :func:`bootstrap_join`
    requests from replacement processes for the life of the run: a late
    process may re-host a dead process's ranks, and every survivor is
    told to dial it (``PEER_JOINED``) and splices it into the mesh."""
    ranks = tuple(sorted(set(local_ranks))) if local_ranks else (rank,)
    assert rank == ranks[0], \
        f"bootstrap rank {rank} must be the lead of local_ranks {ranks}"
    if len(ranks) == n_ranks:     # one process hosts the whole world
        return SocketTransport(rank, n_ranks, {}, local_ranks=ranks,
                               placement={rank: ranks},
                               hb_interval=hb_interval,
                               hb_timeout=hb_timeout, **transport_kw)
    deadline = time.monotonic() + timeout
    listener = _listener(host)
    my_addr: Addr = (host, listener.getsockname()[1])

    # -- placement exchange through the coordinator -------------------------
    coord = None
    if rank == 0:
        coord = _listener_retry(coord_addr[0], coord_addr[1], deadline)
        coord.settimeout(timeout)
        world: Dict[int, Tuple[Addr, Tuple[int, ...]]] = {
            0: (my_addr, ranks)}
        covered = len(ranks)
        conns = []
        try:
            while covered < n_ranks:
                c, _ = coord.accept()
                c.settimeout(timeout)
                try:
                    frame = frames.recv_frame(c)
                except (OSError, ValueError, pickle.UnpicklingError,
                        EOFError):
                    frame = None
                # a well-known port attracts strays: squatter-era clients
                # of another launch, half-closed dials, port scanners.
                # Anything that is not a plausible HELLO for THIS world
                # (right shape, in-range non-overlapping ranks) is dropped
                # instead of crashing or corrupting the placement.
                if (not isinstance(frame, tuple) or len(frame) != 4
                        or frame[0] != frames.HELLO):
                    c.close()
                    continue
                _, peer_lead, peer_ranks, peer_addr = frame
                try:
                    peer_ranks = tuple(int(r) for r in peer_ranks)
                    peer_addr = (str(peer_addr[0]), int(peer_addr[1]))
                except (TypeError, ValueError, IndexError):
                    c.close()
                    continue
                taken = {r for l, (_, rs) in world.items()
                         if l != peer_lead for r in rs}
                if (not peer_ranks or peer_lead != peer_ranks[0]
                        or any(not 0 <= r < n_ranks for r in peer_ranks)
                        or taken & set(peer_ranks)):
                    c.close()
                    continue
                if peer_lead in world:
                    # a retrying process re-registers with the SAME addr
                    # and ranks (its listener never changed); a mismatch
                    # is a foreign launch colliding on this port
                    if world[peer_lead] != (peer_addr, peer_ranks):
                        c.close()
                        continue
                else:
                    covered += len(peer_ranks)
                    world[peer_lead] = (peer_addr, peer_ranks)
                conns.append(c)
            for c in conns:
                try:
                    frames.send_frame(c, ("addrs", world))
                except OSError:
                    pass  # a retrier abandoned this connection
        finally:
            for c in conns:
                c.close()
            if not elastic:      # elastic: the join server inherits it
                coord.close()
                coord = None
    else:
        # register-with-retry: until the real coordinator owns the port a
        # dial may reach a squatter (the same TOCTOU the coordinator's
        # bind-retry rides out) — EOF, a reset, or garbage instead of the
        # addrs reply just means "not the coordinator yet, try again"
        world = None
        while world is None:
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"bootstrap: no coordinator reply from {coord_addr}")
            c = _dial(coord_addr, deadline)
            c.settimeout(max(0.1, min(timeout,
                                      deadline - time.monotonic())))
            try:
                frames.send_frame(c, (frames.HELLO, rank, ranks, my_addr))
                got = frames.recv_frame(c)
                if (isinstance(got, tuple) and len(got) == 2
                        and got[0] == "addrs" and isinstance(got[1], dict)):
                    world = {int(l): ((str(a[0]), int(a[1])),
                                      tuple(int(r) for r in rs))
                             for l, (a, rs) in got[1].items()}
            except (OSError, TypeError, KeyError, IndexError, ValueError,
                    pickle.UnpicklingError, EOFError):
                world = None  # squatter hung up / spoke garbage: retry
            finally:
                c.close()
            if world is None:
                time.sleep(0.1)
    placement = {l: rs for l, (_, rs) in world.items()}

    # -- all-pairs process mesh: dial down, accept up -----------------------
    peers: Dict[int, socket.socket] = {}
    for q in sorted(world):
        if q >= rank:
            continue
        s = _dial(world[q][0], deadline)
        frames.send_frame(s, (frames.HELLO, rank))
        peers[q] = _configure(s)
    listener.settimeout(timeout)
    try:
        while len(peers) < len(world) - 1:
            s, _ = listener.accept()
            s.settimeout(timeout)
            try:
                frame = frames.recv_frame(s)
            except (OSError, ValueError, pickle.UnpicklingError, EOFError):
                frame = None
            if (not isinstance(frame, tuple) or len(frame) != 2
                    or frame[0] != frames.HELLO or frame[1] not in world
                    or frame[1] <= rank or frame[1] in peers):
                s.close()        # stray connection, not a mesh peer
                continue
            peers[frame[1]] = _configure(s)
    finally:
        listener.close()
    transport = SocketTransport(rank, n_ranks, peers, local_ranks=ranks,
                                placement=placement,
                                hb_interval=hb_interval,
                                hb_timeout=hb_timeout, **transport_kw)
    if coord is not None:
        t = threading.Thread(target=_join_server,
                             args=(coord, transport, timeout),
                             daemon=True, name="edat-net-join-server")
        transport._join_thread = t
        t.start()
    return transport


def _join_server(coord: socket.socket, transport: SocketTransport,
                 timeout: float) -> None:
    """Rank-0 elastic-join service: accept ``JOIN`` requests on the (kept
    alive) coordinator listener for the life of the transport.

    A JOIN is granted only for a placement entry whose ranks are ALL
    currently dead (the replacement re-hosts exactly that process's
    ranks); anything else gets ``NOJOIN`` and the newcomer retries — in
    particular a replacement that races the failure detector simply waits
    out the heartbeat timeout.  On grant: reply ``WELCOME`` with the
    placement and the set of live processes that will dial in, broadcast
    ``PEER_JOINED`` to the survivors, and dial the newcomer ourselves."""
    coord.settimeout(0.5)
    io_timeout = min(timeout, 5.0)
    try:
        while not transport._close_started:
            try:
                c, _ = coord.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            c.settimeout(io_timeout)
            try:
                frame = frames.recv_frame(c)
            except (OSError, ValueError, pickle.UnpicklingError, EOFError):
                frame = None
            if (not isinstance(frame, tuple) or len(frame) != 4
                    or frame[0] != frames.JOIN):
                c.close()        # stray dial on the well-known port
                continue
            _, lead, jranks, addr = frame
            try:
                lead = int(lead)
                jranks = tuple(sorted(int(r) for r in jranks))
                addr = (str(addr[0]), int(addr[1]))
            except (TypeError, ValueError, IndexError):
                c.close()
                continue
            if (transport.placement.get(lead) != jranks
                    or not all(transport.is_dead(r) for r in jranks)):
                try:
                    frames.send_frame(c, (frames.NOJOIN,
                                          f"ranks {jranks} are not a dead "
                                          f"process of this world"))
                except OSError:
                    pass
                c.close()
                continue
            dialers = [l for l, rs in transport.placement.items()
                       if l != lead
                       and not all(transport.is_dead(r) for r in rs)]
            dead = [l for l, rs in transport.placement.items()
                    if l != lead
                    and all(transport.is_dead(r) for r in rs)]
            try:
                frames.send_frame(c, (frames.WELCOME, {
                    "placement": dict(transport.placement),
                    "dead": dead, "dialers": dialers}))
            except OSError:
                c.close()
                continue
            c.close()
            # survivors dial the newcomer concurrently with our own dial
            transport.announce_join(lead, addr)
            transport.dial_peer(lead, addr, timeout=timeout)
    finally:
        try:
            coord.close()
        except OSError:
            pass


def bootstrap_join(rank: int, n_ranks: int, coord_addr: Addr, *,
                   local_ranks: Optional[Sequence[int]] = None,
                   host: str = "127.0.0.1", timeout: float = 30.0,
                   hb_interval: float = 0.5, hb_timeout: float = 5.0,
                   **transport_kw) -> SocketTransport:
    """Elastically join a *running* world as a replacement process.

    The counterpart of :func:`bootstrap` for a process launched after the
    original rendezvous: it re-hosts the ranks of a process that died
    (``local_ranks`` must exactly match a placement entry).  Protocol:
    listen first (so the advertised address is always accepting), send
    ``JOIN`` to the still-open coordinator, retry while it answers
    ``NOJOIN`` (the failure detector may not have declared the dead
    process yet), then accept one HELLO dial from every live process and
    hand the assembled mesh to :class:`SocketTransport` — with any other
    still-dead processes pre-marked via ``dead_procs``."""
    ranks = tuple(sorted(set(local_ranks))) if local_ranks else (rank,)
    assert rank == ranks[0], \
        f"bootstrap_join rank {rank} must be the lead of {ranks}"
    deadline = time.monotonic() + timeout
    listener = _listener(host)
    my_addr: Addr = (host, listener.getsockname()[1])
    info = None
    try:
        while info is None:
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"bootstrap_join: no WELCOME from {coord_addr} for "
                    f"ranks {ranks} within {timeout}s")
            c = _dial(coord_addr, deadline)
            c.settimeout(max(0.1, min(timeout,
                                      deadline - time.monotonic())))
            try:
                frames.send_frame(c, (frames.JOIN, rank, ranks, my_addr))
                got = frames.recv_frame(c)
                if (isinstance(got, tuple) and len(got) == 2
                        and got[0] == frames.WELCOME
                        and isinstance(got[1], dict)):
                    info = got[1]
                # NOJOIN / garbage / EOF: not joinable yet, retry below
            except (OSError, TypeError, KeyError, IndexError, ValueError,
                    pickle.UnpicklingError, EOFError):
                info = None
            finally:
                c.close()
            if info is None:
                time.sleep(0.2)
        placement = {int(l): tuple(int(r) for r in rs)
                     for l, rs in info["placement"].items()}
        dialers = {int(l) for l in info["dialers"]}
        dead = {int(l) for l in info["dead"]}
        assert placement.get(rank) == ranks, \
            f"WELCOME placement {placement} does not host {ranks} at {rank}"
        peers: Dict[int, socket.socket] = {}
        listener.settimeout(1.0)
        while set(peers) != dialers:
            if time.monotonic() >= deadline:
                missing = sorted(dialers - set(peers))
                raise RuntimeError(
                    f"bootstrap_join: processes {missing} never dialed in")
            try:
                s, _ = listener.accept()
            except socket.timeout:
                continue
            s.settimeout(timeout)
            try:
                frame = frames.recv_frame(s)
            except (OSError, ValueError, pickle.UnpicklingError, EOFError):
                frame = None
            if (not isinstance(frame, tuple) or len(frame) != 2
                    or frame[0] != frames.HELLO or frame[1] not in dialers
                    or frame[1] in peers):
                s.close()        # stray connection, not an expected dialer
                continue
            peers[int(frame[1])] = _configure(s)
    finally:
        listener.close()
    return SocketTransport(rank, n_ranks, peers, local_ranks=ranks,
                           placement=placement, dead_procs=sorted(dead),
                           hb_interval=hb_interval, hb_timeout=hb_timeout,
                           **transport_kw)


def bootstrap_from_env(**kw) -> SocketTransport:
    """Rendezvous addressed entirely by ``EDAT_*`` environment variables."""
    rank = int(os.environ["EDAT_RANK"])
    n_ranks = int(os.environ["EDAT_NRANKS"])
    host, port = os.environ["EDAT_COORD"].rsplit(":", 1)
    local = os.environ.get("EDAT_LOCAL_RANKS")
    if local:
        kw.setdefault("local_ranks",
                      tuple(int(r) for r in local.split(",")))
    kw.setdefault("host", os.environ.get("EDAT_HOST", "127.0.0.1"))
    return bootstrap(rank, n_ranks, (host, int(port)), **kw)
