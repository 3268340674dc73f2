"""Multi-process rank launcher for SocketTransport runs.

API (paper's ``mpiexec`` role, for one machine)::

    from repro_torch import edat

    def main(ctx):            # must be importable (module level): children
        ...                   # are spawned, not forked

    stats = edat.launch_processes(4, main)              # 1 rank / process
    stats = edat.launch_processes(4, main, n_procs=2)   # 2 ranks / process

or, for failure-injection control::

    pg = ProcessGroup(4, main, n_procs=2)
    pg.start()
    pg.kill(3)                # SIGKILL the process hosting rank 3: every
    stats = pg.wait()         # rank it hosted dies; survivors' heartbeat
                              # detectors raise RANK_FAILED for each

CLI::

    python -m repro_torch.net.launch --ranks 4 examples/net_pingpong.py:main
    python -m repro_torch.net.launch -n 4 --procs 2 repro_torch.something:main

The spec is ``module.path:callable`` or ``path/to/file.py:callable``
(callable defaults to ``main``); each child resolves it independently, so
file-based specs need no importable package.  With ``n_procs`` (or an
explicit ``placement`` list of rank tuples) each spawned process hosts a
contiguous block of ranks — ``main(ctx)`` still runs once per *rank*, and
co-located ranks exchange events in-process without touching a socket.
Children rendezvous through the rank-0 coordinator
(:mod:`repro_torch.net.bootstrap`); the parent only picks the coordinator port,
spawns, and reaps.

Every child also exports ``EDAT_RANK`` / ``EDAT_LOCAL_RANKS`` /
``EDAT_NRANKS`` / ``EDAT_COORD`` so user code can introspect its
placement.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import multiprocessing as mp
import os
import socket
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

MainSpec = Union[Callable, str]


def _free_port(host: str = "127.0.0.1") -> int:
    """Probe a currently-free port.  Inherently racy (the port is released
    before the coordinator child re-binds it); the bootstrap side closes
    the race with a bind-retry loop — see
    :func:`repro_torch.net.bootstrap._listener_retry`."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]


def default_placement(n_ranks: int, n_procs: int) -> List[Tuple[int, ...]]:
    """Contiguous block placement: ``n_ranks`` over ``n_procs`` processes,
    earlier processes taking the larger blocks."""
    assert 1 <= n_procs <= n_ranks, (n_ranks, n_procs)
    base, extra = divmod(n_ranks, n_procs)
    out, r = [], 0
    for p in range(n_procs):
        k = base + (1 if p < extra else 0)
        out.append(tuple(range(r, r + k)))
        r += k
    return out


def _resolve_spec(spec: str) -> Callable:
    """``pkg.mod:fn`` or ``path/file.py:fn`` (fn defaults to ``main``)."""
    target, _, fn_name = spec.partition(":")
    fn_name = fn_name or "main"
    if target.endswith(".py") or os.sep in target:
        name = "_edat_main_" + os.path.splitext(os.path.basename(target))[0]
        s = importlib.util.spec_from_file_location(name, target)
        if s is None:
            raise ValueError(f"cannot load {target!r}")
        mod = importlib.util.module_from_spec(s)
        sys.modules[name] = mod
        s.loader.exec_module(mod)
    else:
        mod = importlib.import_module(target)
    fn = getattr(mod, fn_name, None)
    if not callable(fn):
        raise ValueError(f"{spec!r}: no callable {fn_name!r} in {target!r}")
    return fn


def _child_entry(ranks: Tuple[int, ...], n_ranks: int, coord_addr,
                 main: MainSpec, runtime_kwargs: Dict[str, Any],
                 run_timeout: float, net: Dict[str, Any], result_q,
                 launch_id: str = "", join: bool = False,
                 ready_file: Optional[str] = None) -> None:
    os.environ["EDAT_RANK"] = str(ranks[0])
    os.environ["EDAT_LOCAL_RANKS"] = ",".join(str(r) for r in ranks)
    os.environ["EDAT_NRANKS"] = str(n_ranks)
    os.environ["EDAT_COORD"] = f"{coord_addr[0]}:{coord_addr[1]}"
    if launch_id:
        # unique per ProcessGroup.start(): lets user code key shared
        # scratch space to THIS launch (a reused coordinator port must
        # not resurrect a previous run's on-disk state)
        os.environ["EDAT_LAUNCH_ID"] = launch_id
    if join:
        # lets user code distinguish an elastic replacement from the
        # original incarnation of its ranks (e.g. chaos programs that
        # stall their first incarnation must not stall the second)
        os.environ["EDAT_JOINED"] = "1"
    try:
        from repro_torch.core.runtime import Runtime
        from .bootstrap import bootstrap, bootstrap_join
        if isinstance(main, str):
            main = _resolve_spec(main)
        if join:
            # replacement process: HELLO into the *running* coordinator
            # and re-host this placement entry's (dead) ranks
            jnet = {k: v for k, v in net.items() if k != "elastic"}
            transport = bootstrap_join(ranks[0], n_ranks, coord_addr,
                                       local_ranks=ranks, **jnet)
        else:
            transport = bootstrap(ranks[0], n_ranks, coord_addr,
                                  local_ranks=ranks, **net)
        if ready_file:
            # the mesh splice is complete: tell the observer (chaos tests
            # key "the replacement is in" off this file's existence)
            with open(ready_file, "w"):
                pass
        rt = Runtime(n_ranks, transport=transport, **runtime_kwargs)
        t0 = time.monotonic()
        stats = rt._run_internal(main, timeout=run_timeout)
        # the wall time of the run itself: stamped *before* the finalize
        # hook so result spooling (pickling a large gathered array) never
        # inflates the in-child run_seconds benchmarks divide by
        run_seconds = time.monotonic() - t0
        # post-run hook (v2 Session result gathering): a main object may
        # carry an `_edat_finalize(ranks, stats)` method, run after clean
        # global termination — e.g. to persist the program's gathered
        # result for the launching parent.  The deliberately-prefixed
        # name cannot collide with an unrelated user method.
        fin = getattr(main, "_edat_finalize", None)
        if fin is not None:
            fin(ranks, stats)
        # every child (not just rank 0's) reports its metric snapshot so
        # the parent can merge per-channel counters across processes
        mt = rt.metrics()
        if mt is not None:
            try:
                result_q.put(("metrics", ranks[0], mt))
            except Exception:
                pass  # unpicklable trace payload etc: stats still flow
        if 0 in ranks:
            stats = dict(stats)
            stats["run_seconds"] = run_seconds
            result_q.put(("ok", stats))
    except BaseException as e:  # noqa: BLE001 - report, then non-zero exit
        if type(e).__name__ == "RankDiedError":
            # the termination coordinator (rank 0's process) died under
            # this rank: an *expected* casualty of fault injection, not a
            # bug in this child — report distinctly and exit cleanly so
            # chaos tests can assert "no survivor crashed"
            try:
                result_q.put(("rankdied", ranks[0], str(e)))
            except Exception:
                pass
            raise SystemExit(0)
        try:
            result_q.put(("err", ranks[0], f"{type(e).__name__}: {e}"))
        except Exception:
            pass
        raise SystemExit(1)


class ProcessGroup:
    """A set of spawned rank processes sharing one SocketTransport world.

    ``n_procs`` (or an explicit ``placement``: a partition of
    ``range(n_ranks)`` into per-process rank tuples) places several ranks
    in one OS process; default is one rank per process."""

    #: ProcessGroup kwargs forwarded to the SocketTransport (via bootstrap)
    #: rather than to the Runtime
    NET_KEYS = ("hb_interval", "hb_timeout", "coalesce", "flush_interval",
                "max_batch_bytes", "elastic")

    def __init__(self, n_ranks: int, main: MainSpec, *,
                 n_procs: Optional[int] = None,
                 placement: Optional[Sequence[Sequence[int]]] = None,
                 run_timeout: float = 120.0,
                 host: str = "127.0.0.1",
                 **kwargs: Any):
        self.n_ranks = n_ranks
        self.main = main
        self.run_timeout = run_timeout
        if placement is not None:
            self.placement = [tuple(sorted(int(r) for r in rs))
                              for rs in placement]
        else:
            self.placement = default_placement(n_ranks, n_procs or n_ranks)
        covered = sorted(r for rs in self.placement for r in rs)
        assert covered == list(range(n_ranks)), \
            f"placement {self.placement} does not partition 0..{n_ranks-1}"
        self._net = {k: kwargs.pop(k) for k in list(kwargs)
                     if k in self.NET_KEYS}
        self._net.setdefault("hb_interval", 0.5)
        self._net.setdefault("hb_timeout", 5.0)
        self.runtime_kwargs = kwargs
        self._host = host
        #: one process per placement entry, keyed by its lead rank
        self._procs: Dict[int, mp.process.BaseProcess] = {}
        self._killed = set()        # ranks whose process we SIGKILLed
        self._q = None
        self._coord: Optional[Tuple[str, int]] = None
        self._launch_id = ""
        #: every (kind, ...) report the children queued, populated by wait()
        self.child_reports: List[tuple] = []

    def _proc_of(self, rank: int) -> Tuple[int, Tuple[int, ...]]:
        for rs in self.placement:
            if rank in rs:
                return rs[0], rs
        raise KeyError(rank)

    def start(self) -> "ProcessGroup":
        import uuid
        ctx = mp.get_context("spawn")
        self._q = ctx.SimpleQueue()
        self._coord = (self._host, _free_port(self._host))
        self._launch_id = uuid.uuid4().hex[:12]
        for rs in self.placement:
            p = ctx.Process(
                target=_child_entry,
                args=(rs, self.n_ranks, self._coord, self.main,
                      self.runtime_kwargs, self.run_timeout, self._net,
                      self._q, self._launch_id),
                daemon=False,
                name="edat-ranks" + "_".join(str(r) for r in rs))
            p.start()
            self._procs[rs[0]] = p
        return self

    def kill(self, rank: int) -> None:
        """SIGKILL the process hosting ``rank`` — the cross-process
        equivalent of ``Runtime.kill_rank``, at process granularity: every
        co-located rank dies with it, and survivors' heartbeat detectors
        raise one RANK_FAILED per lost rank."""
        lead, rs = self._proc_of(rank)
        self._killed.update(rs)
        self._procs[lead].kill()

    def respawn(self, rank: int,
                ready_file: Optional[str] = None) -> None:
        """Launch a replacement process for the (dead) process hosting
        ``rank``: the elastic-join counterpart of :meth:`kill`.  The child
        runs the same ``main`` but rendezvouses through
        :func:`~repro_torch.net.bootstrap.bootstrap_join` against the *running*
        coordinator — requires the group to have been started with
        ``elastic=True``.  ``ready_file`` (if given) is created by the
        child the moment its mesh splice completes, so a chaos test can
        key "the replacement is in" without polling the coordinator.  The
        replacement is expected to exit cleanly: its ranks are removed
        from the killed set."""
        if not self._net.get("elastic"):
            raise RuntimeError(
                "respawn() requires ProcessGroup(..., elastic=True): "
                "without it the coordinator listener is closed after "
                "bootstrap and a replacement has nothing to JOIN")
        lead, rs = self._proc_of(rank)
        old = self._procs.get(lead)
        if old is not None and old.is_alive():
            # a just-delivered SIGKILL needs a moment to reap
            old.join(5.0)
        if old is not None and old.is_alive():
            raise RuntimeError(
                f"process hosting rank {rank} is still alive; respawn is "
                f"for replacing a dead process")
        ctx = mp.get_context("spawn")
        p = ctx.Process(
            target=_child_entry,
            args=(rs, self.n_ranks, self._coord, self.main,
                  self.runtime_kwargs, self.run_timeout, self._net,
                  self._q, self._launch_id, True, ready_file),
            daemon=False,
            name="edat-rejoin" + "_".join(str(r) for r in rs))
        p.start()
        self._procs[lead] = p
        self._killed -= set(rs)

    def join_all(self, timeout: Optional[float] = None) -> bool:
        """Soft join: wait for every process to exit *without* killing
        stragglers.  True iff all processes have exited.  This is the
        non-destructive probe ``Future.result(timeout)`` uses — a timeout
        must leave the round running and retryable, not SIGKILL it."""
        deadline = time.monotonic() + (
            timeout if timeout is not None else self.run_timeout + 30.0)
        for p in self._procs.values():
            p.join(max(0.0, deadline - time.monotonic()))
        return all(not p.is_alive() for p in self._procs.values())

    def wait(self, timeout: Optional[float] = None,
             check: bool = True) -> Dict[str, Any]:
        """Join all processes; return rank 0's stats (with the merged
        cross-process metric counters attached when metrics are on).
        Stragglers past the deadline are killed (tests must fail fast, not
        hang).  With ``check``, any unexpected child failure raises
        ``RuntimeError`` (deliberately ``kill()``-ed processes are
        expected to die)."""
        deadline = time.monotonic() + (
            timeout if timeout is not None else self.run_timeout + 30.0)
        hung = []
        for lead, p in self._procs.items():
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                hung.append(lead)
                p.kill()
                p.join(5.0)
        results = []
        while not self._q.empty():
            results.append(self._q.get())
        self.child_reports = results
        stats = next((x[1] for x in results if x[0] == "ok"), None)
        if check:
            if hung:
                raise RuntimeError(
                    f"process(es) led by ranks {hung} did not exit within "
                    f"the deadline; killed.  child reports: {results}")
            errs = [x for x in results if x[0] == "err"
                    and x[1] not in self._killed]
            bad = [lead for lead, p in self._procs.items()
                   if p.exitcode not in (0, None)
                   and lead not in self._killed]
            if errs or bad:
                raise RuntimeError(
                    f"rank process(es) failed: exitcodes="
                    f"{self.exitcodes()} reports={results}")
        out = dict(stats) if stats is not None else {}
        parts = [(x[1], x[2]) for x in results if x[0] == "metrics"]
        if parts:
            from repro_torch.core.metrics import merge_metrics
            out.update(merge_metrics(parts))
        return out

    def exitcodes(self) -> Dict[int, Optional[int]]:
        """Exit code per *rank* (co-located ranks share their process's)."""
        out = {}
        for rs in self.placement:
            code = self._procs[rs[0]].exitcode
            for r in rs:
                out[r] = code
        return out


def launch_processes(n_ranks: int, main: MainSpec, *,
                     timeout: float = 120.0, join_timeout: float = None,
                     check: bool = True,
                     **kwargs: Any) -> Dict[str, Any]:
    """Spawn rank processes running ``main`` SPMD over SocketTransport;
    block until they all exit and return rank 0's stats (including
    ``run_seconds``, the in-child wall time of ``Runtime.run``).  By
    default each rank gets its own process; ``n_procs=k`` packs the ranks
    into ``k`` processes (``placement`` for full control).  Extra kwargs
    go to :class:`ProcessGroup`: transport knobs (``hb_interval``,
    ``hb_timeout``, ``coalesce``, ``flush_interval``, ``max_batch_bytes``)
    reach the :class:`~repro_torch.net.SocketTransport`; everything else reaches
    the ``Runtime`` (e.g. ``workers_per_rank``, ``progress``,
    ``unconsumed``)."""
    pg = ProcessGroup(n_ranks, main, run_timeout=timeout, **kwargs)
    pg.start()
    return pg.wait(join_timeout, check=check)


def _cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.net.launch",
        description="Run an EDAT main SPMD across local rank processes "
                    "over SocketTransport.")
    ap.add_argument("spec", help="module.path:fn or path/to/file.py:fn "
                                 "(fn defaults to 'main')")
    ap.add_argument("-n", "--ranks", type=int, default=2)
    ap.add_argument("--procs", type=int, default=None,
                    help="number of OS processes to pack the ranks into "
                         "(default: one per rank); co-located ranks "
                         "exchange events without touching a socket")
    ap.add_argument("--workers", type=int, default=1,
                    help="workers per rank (default 1)")
    ap.add_argument("--progress", choices=("thread", "worker"),
                    default="thread")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="per-rank Runtime.run timeout (s)")
    ap.add_argument("--unconsumed", choices=("error", "warn", "ignore"),
                    default="error")
    ap.add_argument("--no-coalesce", action="store_true",
                    help="disable writer-side event coalescing (one frame "
                         "per send; the slow path, for A/B comparisons)")
    ap.add_argument("--flush-interval", type=float, default=0.0,
                    help="writer batching window in seconds (default 0: "
                         "purely opportunistic coalescing)")
    ap.add_argument("--max-batch-bytes", type=int, default=1 << 20,
                    help="approximate cap on one coalesced frame (bytes)")
    args = ap.parse_args(argv)
    _resolve_spec(args.spec)  # fail fast in the parent on a bad spec
    stats = launch_processes(
        args.ranks, args.spec, timeout=args.timeout, n_procs=args.procs,
        workers_per_rank=args.workers, progress=args.progress,
        unconsumed=args.unconsumed, coalesce=not args.no_coalesce,
        flush_interval=args.flush_interval,
        max_batch_bytes=args.max_batch_bytes)
    print(f"[repro_torch.net.launch] {args.ranks} ranks terminated cleanly: "
          f"{stats}")
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
