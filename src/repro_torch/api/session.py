"""``Session`` — the one way EDAT programs start (v2 API).

A session owns everything the v1 surface scattered over
``Runtime(n).run(main)``, ``launch_processes``/``ProcessGroup`` and the
per-use-case ``distributed_*`` helpers: runtime construction,
bootstrap/rendezvous, process spawn, result gathering and teardown.
The same program runs on either transport::

    with edat.Session(ranks=4, procs=2, transport="socket") as s:
        s.run(edat.deferred(bfs_program, 4, scale=12))
        parents = s.gather()["parent"]

    res = edat.run(my_program, ranks=4)          # inproc one-liner

Transports:

* ``"inproc"`` — threads-as-ranks over :class:`InProcTransport` in the
  driver process.  ``run`` is synchronous; the program object is shared
  with the driver, so ``gather()`` is a direct method call.
* ``"socket"`` — one OS process per ``procs`` bucket of ranks over the
  coalescing :class:`~repro_torch.net.SocketTransport` (``placement`` for
  explicit rank->process maps).  The program (or its
  :func:`~repro_torch.api.program.deferred` factory) is pickled to the
  children; the process hosting rank 0 writes ``program.result()`` to a
  session-private spool file after clean termination, and ``gather()``
  reads it back — the generic replacement for the per-use-case out-dir
  persistence glue.

Driver-side futures: :meth:`Session.call` schedules ``fn`` as a task on
a rank and returns a :class:`Future` whose value is delivered by an
event fired at task return (``__sess.result`` to rank 0).  Futures
resolve when the session round runs — ``Future.result()`` triggers the
round if needed — giving blocking driver-side composition over the
non-blocking event core.
"""
from __future__ import annotations

import itertools
import os
import pickle
import shutil
import tempfile
import threading
import time
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

from repro_torch.core.event import ANY
from repro_torch.core.metrics import RunStats, merge_metrics
from repro_torch.core.runtime import Context, RankDiedError, Runtime

from .program import DeferredProgram, Program

ProgramLike = Union[Program, DeferredProgram, Callable[[Context], None]]
DepLike = Tuple[Any, str]

_UNSET = object()

# RankDiedError lives in repro_torch.core.runtime (re-exported here for the
# stable ``edat.RankDiedError`` surface): the same class covers a driver
# future whose callee rank's process died AND a survivor rank observing
# the termination coordinator's death — both "the round cannot complete
# from this observer's point of view".


class Future:
    """Driver-side handle for a :meth:`Session.call` result."""

    def __init__(self, session: "Session", cid: int, rank: int = -1):
        self._session = session
        self.cid = cid
        self.rank = rank
        self._value: Any = _UNSET

    def done(self) -> bool:
        return self._value is not _UNSET

    def _set(self, value: Any) -> None:
        self._value = value

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block until the call's task has run and returned (driving the
        session round if it has not started yet).

        Raises ``TimeoutError`` if the round is still running after
        ``timeout`` seconds — the round is left in flight and the future
        stays retryable (the session is *not* torn down).  Raises
        :class:`RankDiedError` when the round is over but the process
        hosting the callee rank exited abnormally, naming the dead rank."""
        if not self.done():
            self._session._resolve(timeout)
        if not self.done():
            code = self._session._rank_exitcode(self.rank)
            if code not in (None, 0):
                raise RankDiedError(
                    f"call {self.cid} was scheduled on rank {self.rank}, "
                    f"whose process exited with code {code} before the "
                    f"call's task returned")
            raise RuntimeError(
                f"call {self.cid} produced no result (was its process "
                f"killed, or the session round skipped?)")
        return self._value


class _SessionMain:
    """The SPMD main a session hands to its runtime (picklable for
    spawned socket children).  Builds the program once per *process*
    (all co-located rank threads share it), declares its channels on
    every rank context, schedules the driver's queued calls, and — on
    the process hosting rank 0 — spools ``program.result()`` plus the
    collected call results after clean termination (``_edat_finalize``
    is invoked by the launcher post-run)."""

    def __init__(self, program: Optional[Any] = None,
                 deferred: Optional[DeferredProgram] = None,
                 mainfn: Optional[Callable[[Context], None]] = None,
                 calls: Sequence[tuple] = (),
                 result_path: Optional[str] = None):
        self.program = program
        self.deferred = deferred
        self.mainfn = mainfn
        self.calls = list(calls)
        self.result_path = result_path
        self._init_local()

    # -- pickling: per-process state stays behind ----------------------------
    def _init_local(self) -> None:
        self._mu = threading.Lock()
        self._built: Any = _UNSET       # sentinel: a program may be falsy
        self.call_results: Dict[int, Any] = {}

    def __getstate__(self) -> dict:
        return {"program": self.program, "deferred": self.deferred,
                "mainfn": self.mainfn, "calls": self.calls,
                "result_path": self.result_path}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._init_local()

    # -- program resolution ---------------------------------------------------
    def resolved(self) -> Optional[Any]:
        """The program instance for this process (built on first use).
        ``None`` only for anonymous mains / calls-only rounds — a falsy
        program object (e.g. one subclassing a container) still counts."""
        with self._mu:
            if self._built is _UNSET:
                if self.program is not None:
                    self._built = self.program
                elif self.deferred is not None:
                    self._built = self.deferred.build()
                else:
                    self._built = None       # anonymous main / calls only
            return self._built

    # -- SPMD main ------------------------------------------------------------
    def __call__(self, ctx: Context) -> None:
        prog = self.resolved()
        if prog is not None:
            chans = getattr(prog, "channels", None)
            if chans:
                ctx.declare_channels(chans)
        if ctx.rank == 0 and self.calls:
            ctx.submit_persistent(self._collect,
                                  deps=[(ANY, "__sess.result")],
                                  name="__sess.collector")
        for cid, rank, fn, deps in self.calls:
            if rank == ctx.rank:
                ctx.submit(self._call_task(cid, fn), deps=deps)
        if prog is not None:
            prog.start(ctx)
        elif self.mainfn is not None:
            self.mainfn(ctx)

    def _call_task(self, cid: int, fn: Callable) -> Callable:
        def task(ctx: Context, events) -> None:
            val = fn(ctx, events)
            ctx.fire(0, "__sess.result", {"cid": cid, "val": val})
        return task

    def _collect(self, ctx: Context, events) -> None:
        d = events[0].data
        self.call_results[d["cid"]] = d["val"]

    # -- post-run (invoked by the launcher in the rank-0 child via the
    # collision-proof `_edat_finalize` hook name) -----------------------------
    def _edat_finalize(self, ranks: Sequence[int],
                       stats: Dict[str, Any]) -> None:
        if self.result_path is None or 0 not in ranks:
            return
        prog = None if self._built is _UNSET else self._built
        res_fn = getattr(prog, "result", None) if prog is not None else None
        payload = {"has_result": res_fn is not None,
                   "result": res_fn() if res_fn is not None else None,
                   "calls": dict(self.call_results)}
        tmp = self.result_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, self.result_path)


class Session:
    """One EDAT execution context: ``ranks`` SPMD ranks over a chosen
    transport, with construction, spawn, gathering and teardown owned
    here.  Use as a context manager; :func:`repro_torch.api.run` is the
    one-shot convenience.

    Parameters mirror the full v1 surface: ``procs``/``placement`` pack
    ranks into OS processes (socket only), ``coalesce`` /
    ``flush_interval`` / ``max_batch_bytes`` tune the writer-side
    coalescing fast path, ``hb_interval``/``hb_timeout`` the transport
    failure detector, ``workers_per_rank``/``progress``/``unconsumed``
    the per-rank runtime.  ``timeout`` is the default per-round run
    deadline."""

    def __init__(self, ranks: int, *,
                 procs: Optional[int] = None,
                 transport: str = "inproc",
                 workers_per_rank: int = 1,
                 progress: str = "thread",
                 unconsumed: str = "error",
                 coalesce: bool = True,
                 placement: Optional[Sequence[Sequence[int]]] = None,
                 flush_interval: float = 0.0,
                 max_batch_bytes: int = 1 << 20,
                 hb_interval: float = 0.5,
                 hb_timeout: float = 5.0,
                 host: str = "127.0.0.1",
                 timeout: float = 120.0,
                 metrics: bool = True,
                 trace: bool = False,
                 durable: Union[bool, dict, None] = None,
                 elastic: bool = False):
        if transport not in ("inproc", "socket"):
            raise ValueError(f"unknown transport {transport!r} "
                             f"(expected 'inproc' or 'socket')")
        if transport == "inproc" and (procs not in (None, 1)
                                      or placement is not None):
            # a forgotten transport="socket" must not silently run as
            # threads: process packing only exists on the socket transport
            raise ValueError(
                "procs/placement require transport='socket' (inproc "
                "sessions run every rank as a thread in this process)")
        if transport == "inproc" and elastic:
            raise ValueError(
                "elastic=True requires transport='socket' (elastic join "
                "replaces a dead OS process; inproc ranks are threads)")
        self.ranks = int(ranks)
        self.procs = procs
        self.transport = transport
        self.workers_per_rank = workers_per_rank
        self.progress = progress
        self.unconsumed = unconsumed
        self.coalesce = coalesce
        self.placement_spec = placement
        self.flush_interval = flush_interval
        self.max_batch_bytes = max_batch_bytes
        self.hb_interval = hb_interval
        self.hb_timeout = hb_timeout
        self.host = host
        self.timeout = timeout
        #: always-on per-channel/rank/transport counters (``metrics=False``
        #: disables them for A/B overhead runs); ``trace=True`` additionally
        #: records bounded per-rank task/event timelines in the stats
        self.metrics = bool(metrics)
        self.trace = bool(trace)
        #: durable task log + automated replay (:mod:`repro_torch.durable`):
        #: ``True`` journals every user channel, a dict refines it
        #: (``path``/``channels``/``all``/``join_timeout``/``settle``).
        #: Socket rounds default the log to a session-private sqlite file
        #: shared by every rank process (``durable_log_path``).
        self.durable = durable
        #: keep the rank-0 coordinator listening after bootstrap so a
        #: replacement process can elastically join a running socket
        #: round (see :meth:`respawn`)
        self.elastic = bool(elastic)
        self.durable_log_path: Optional[str] = None
        #: rank-0 run stats of the most recent round.  A callable dict:
        #: ``s.stats["run_seconds"]`` and ``s.stats()`` both work; with
        #: metrics on it also carries the structured ``"channels"`` /
        #: ``"ranks"`` / ``"transport"`` sections (merged across processes
        #: for socket rounds)
        self.stats: RunStats = RunStats()
        self._runtime: Optional[Runtime] = None    # inproc, current round
        self._pg = None                            # socket, current round
        self._tmpdir: Optional[str] = None
        self._result_path: Optional[str] = None
        self._gathered: Any = None
        self._has_result = False
        self._calls: List[tuple] = []
        self._futures: Dict[int, Future] = {}
        self._cids = itertools.count()

    # ------------------------------------------------------------- lifecycle
    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def close(self) -> None:
        """Reap any still-running spawned processes and drop spool files.
        Harmless to call twice (context-manager exit does)."""
        if self._pg is not None:
            try:
                self.wait(check=False)
            except Exception:
                pass
        self._cleanup_spool()
        self._runtime = None

    def _cleanup_spool(self) -> None:
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None
            self._result_path = None

    # ------------------------------------------------------------ inproc run
    @property
    def runtime(self) -> Runtime:
        """The inproc round's :class:`Runtime` (built lazily) — exposed so
        drivers can inject faults (``kill_rank``) while ``run`` is in
        flight.  Socket sessions have no in-driver runtime."""
        if self.transport != "inproc":
            raise AttributeError(
                "a socket Session has no in-driver runtime; use "
                "kill()/exitcodes() for process-level fault injection")
        if self._runtime is None:
            self._runtime = Runtime(self.ranks,
                                    workers_per_rank=self.workers_per_rank,
                                    progress=self.progress,
                                    unconsumed=self.unconsumed,
                                    metrics=self.metrics,
                                    trace=self.trace,
                                    durable=self.durable)
        return self._runtime

    def run(self, program: Optional[ProgramLike] = None, *,
            timeout: Optional[float] = None) -> Dict[str, Any]:
        """Run one round of ``program`` (a :class:`Program`, a
        :func:`deferred` factory, or a plain ``main(ctx)``) to global
        termination; returns the rank-0 run stats.  Queued
        :meth:`call`\\ s ride along.  ``gather()`` afterwards returns the
        program's result."""
        if self.transport == "inproc":
            return self._run_inproc(program, timeout or self.timeout)
        self.start(program, timeout=timeout)
        return self.wait()

    def _run_inproc(self, program: Optional[ProgramLike],
                    timeout: float) -> Dict[str, Any]:
        prog, dfr, mainfn = _split_program(program)
        if dfr is not None:
            prog, dfr = dfr.build(), None
        self._gathered, self._has_result = None, False   # round-scoped
        main = _SessionMain(program=prog, mainfn=mainfn,
                            calls=self._take_calls())
        rt = self.runtime
        t0 = time.monotonic()
        try:
            stats = RunStats(rt._run_internal(main, timeout=timeout))
        finally:
            self._runtime = None          # a Runtime is single-shot
        stats.setdefault("run_seconds", time.monotonic() - t0)
        mt = rt.metrics()
        if mt is not None:
            # same canonical shape as the cross-process socket merge
            stats.update(merge_metrics([(0, mt)]))
        self.stats = stats
        for cid, val in main.call_results.items():
            fut = self._futures.pop(cid, None)
            if fut is not None:
                fut._set(val)
        res_fn = getattr(prog, "result", None) if prog is not None else None
        self._has_result = res_fn is not None
        self._gathered = res_fn() if res_fn is not None else None
        return stats

    # ------------------------------------------------------------ socket run
    def start(self, program: Optional[ProgramLike] = None, *,
              timeout: Optional[float] = None) -> "Session":
        """Spawn the socket round without blocking (chaos tests kill
        processes mid-run); :meth:`wait` joins it.  Inproc sessions are
        synchronous — use :meth:`run`."""
        if self.transport != "socket":
            raise RuntimeError("start() is for socket sessions; inproc "
                               "sessions run synchronously via run()")
        if self._pg is not None:
            raise RuntimeError("a round is already in flight; wait() first")
        from repro_torch.net.launch import ProcessGroup
        prog, dfr, mainfn = _split_program(program)
        self._gathered, self._has_result = None, False   # round-scoped
        self._cleanup_spool()
        self._tmpdir = tempfile.mkdtemp(prefix="edat_session_")
        self._result_path = os.path.join(self._tmpdir, "result.pkl")
        main = _SessionMain(program=prog, deferred=dfr, mainfn=mainfn,
                            calls=self._take_calls(),
                            result_path=self._result_path)
        kwargs: Dict[str, Any] = dict(
            run_timeout=timeout or self.timeout, host=self.host,
            workers_per_rank=self.workers_per_rank, progress=self.progress,
            unconsumed=self.unconsumed, coalesce=self.coalesce,
            flush_interval=self.flush_interval,
            max_batch_bytes=self.max_batch_bytes,
            hb_interval=self.hb_interval, hb_timeout=self.hb_timeout,
            metrics=self.metrics, trace=self.trace)
        if self.elastic:
            kwargs["elastic"] = True
        if self.durable:
            spec = (dict(self.durable) if isinstance(self.durable, dict)
                    else {})
            # every rank process appends to one shared sqlite file; it
            # lives beside the result spool so teardown reaps both
            spec.setdefault("path",
                            os.path.join(self._tmpdir, "durable.sqlite"))
            self.durable_log_path = spec["path"]
            kwargs["durable"] = spec
        if self.placement_spec is not None:
            kwargs["placement"] = self.placement_spec
        else:
            kwargs["n_procs"] = self.procs
        self._pg = ProcessGroup(self.ranks, main, **kwargs)
        self._pg.start()
        return self

    def wait(self, timeout: Optional[float] = None,
             check: bool = True) -> Dict[str, Any]:
        """Join the spawned round; returns rank-0 stats.  With ``check``
        (default) unexpected child failures raise; chaos tests pass
        ``check=False`` after :meth:`kill`.  The gathered result (if the
        rank-0 process terminated cleanly) is loaded here."""
        if self._pg is None:
            return self.stats
        pg, self._pg = self._pg, None
        self._last_pg = pg
        try:
            self.stats = RunStats(pg.wait(timeout, check=check) or {})
        finally:
            self._load_spool()
        return self.stats

    def _load_spool(self) -> None:
        path = self._result_path
        if path is None or not os.path.exists(path):
            return
        with open(path, "rb") as f:
            payload = pickle.load(f)
        self._cleanup_spool()
        self._has_result = payload["has_result"]
        self._gathered = payload["result"]
        for cid, val in payload["calls"].items():
            fut = self._futures.pop(cid, None)
            if fut is not None:
                fut._set(val)

    def kill(self, rank: int) -> None:
        """SIGKILL the spawned process hosting ``rank`` (socket rounds) —
        process-granular fault injection; every co-located rank dies and
        survivors see one RANK_FAILED per lost rank."""
        if self._pg is None:
            raise RuntimeError("no spawned round in flight")
        self._pg.kill(rank)

    def respawn(self, rank: int, ready_file: Optional[str] = None) -> None:
        """Launch an elastic replacement for the (dead) process that hosted
        ``rank``; requires ``Session(elastic=True)``.  The newcomer joins
        the running world mid-round, re-hosts every rank of that process
        and — in durable mode — drains the replayed backlog.  When
        ``ready_file`` is given it is touched once the mesh splice is
        complete."""
        if self._pg is None:
            raise RuntimeError("no spawned round in flight")
        self._pg.respawn(rank, ready_file=ready_file)

    @property
    def placement(self) -> Optional[List[Tuple[int, ...]]]:
        """Rank->process placement of the current/last socket round."""
        pg = self._pg or getattr(self, "_last_pg", None)
        return None if pg is None else list(pg.placement)

    def exitcodes(self) -> Dict[int, Optional[int]]:
        """Per-rank exit codes of the current/last socket round."""
        pg = self._pg or getattr(self, "_last_pg", None)
        if pg is None:
            raise RuntimeError("no spawned round to inspect")
        return pg.exitcodes()

    # -------------------------------------------------------------- results
    @property
    def has_result(self) -> bool:
        """True when the last round's program defined ``result()``."""
        return self._has_result

    def gather(self) -> Any:
        """The program's gathered result from the last completed round
        (``None`` for anonymous mains, or when the rank-0 process died
        before finalizing)."""
        if self._pg is not None:
            self.wait()
        return self._gathered

    # ---------------------------------------------------------- driver calls
    def call(self, rank: int, fn: Callable, deps: Sequence[DepLike] = ()
             ) -> Future:
        """Schedule ``fn(ctx, events)`` as a task on ``rank`` for the next
        round; the returned :class:`Future` resolves with ``fn``'s return
        value, delivered by an event fired at task return.  For socket
        sessions ``fn`` (and its return value) must pickle."""
        cid = next(self._cids)
        fut = Future(self, cid, int(rank))
        self._futures[cid] = fut
        self._calls.append((cid, int(rank), fn, list(deps)))
        return fut

    def _take_calls(self) -> List[tuple]:
        calls, self._calls = self._calls, []
        return calls

    def _rank_exitcode(self, rank: int) -> Optional[int]:
        """Exit code of the process that hosted ``rank`` in the current or
        last socket round; None for inproc sessions / unspawned rounds."""
        pg = self._pg or getattr(self, "_last_pg", None)
        if pg is None:
            return None
        return pg.exitcodes().get(rank)

    def _resolve(self, timeout: Optional[float]) -> None:
        """Drive pending futures to resolution: join an in-flight round,
        else run a calls-only round.

        With a ``timeout`` and a spawned round still in flight, the join
        is *soft*: if the deadline passes the round is left running and
        ``TimeoutError`` is raised — a slow round must stay retryable,
        not be SIGKILLed by the deadline (which the hard ``wait`` would
        do, wedging every other future of the round)."""
        if self._pg is not None:
            if timeout is not None and not self._pg.join_all(timeout):
                raise TimeoutError(
                    f"session round still running after {timeout}s; the "
                    f"round is left in flight — retry result() later")
            self.wait()
        elif self._calls:
            self.run(None, timeout=timeout)


def _split_program(program: Optional[ProgramLike]
                   ) -> Tuple[Optional[Any], Optional[DeferredProgram],
                              Optional[Callable]]:
    """Classify a program-like into (instance, deferred, plain-main)."""
    if program is None:
        return None, None, None
    if isinstance(program, DeferredProgram):
        return None, program, None
    if hasattr(program, "start"):
        return program, None, None
    if callable(program):
        return None, None, program
    raise TypeError(
        f"not a program: {program!r} (expected an object with start(ctx), "
        f"an edat.deferred(...) factory, or a main(ctx) callable)")


def run(program: ProgramLike, *, ranks: int,
        procs: Optional[int] = None, transport: str = "inproc",
        timeout: float = 120.0, **session_kwargs: Any) -> Any:
    """One-shot convenience: construct a :class:`Session`, run
    ``program`` to termination, and return its gathered result (or the
    run stats, for programs/mains that define no ``result()``)::

        edat.run(main, ranks=2)
        edat.run(edat.deferred(bfs_program, 4, scale=12),
                 ranks=4, procs=2, transport="socket")
    """
    with Session(ranks, procs=procs, transport=transport,
                 timeout=timeout, **session_kwargs) as s:
        s.run(program)
        return s.gather() if s.has_result else dict(s.stats)
