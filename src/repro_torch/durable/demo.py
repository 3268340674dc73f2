"""Durable work-queue demo + chaos CLI (the CI elastic-join smoke).

A deliberately simple SPMD program exercising the whole durable stack:
rank 0 fires ``items`` work events round-robin over the worker ranks on a
durable channel, workers square the payload and reply on a second durable
channel, rank 0 collects (dedup by item id — replay is at-least-once).
One worker rank can be configured to *dawdle* (``stall_rank``) so a
SIGKILL of its process reliably strands unconsumed events in the log;
the elastic replacement of that process skips the dawdling (it sees
``EDAT_JOINED`` in its environment).

CLI — run a 4-rank/2-process world, SIGKILL the worker process mid-run,
elastically replace it, and assert the converged result is identical to
an uninterrupted run with zero tasks leaked in the durable log::

    python -m repro_torch.durable.demo --ranks 4 --procs 2 --items 48 \
        --kill 2 --replace --timeout 60

``--no-replace`` replays onto the survivors instead (no elastic join);
``--kill -1`` (default) runs without fault injection.  Exit code 0 iff
the run converged to the exact expected result with nothing pending in
the log.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
import time
from typing import Dict, Optional

from repro_torch.core.event import ANY, RANK_FAILED


def expected(items: int) -> Dict[str, int]:
    """The uninterrupted-run reference result."""
    return {"n": items, "sum": sum(i * i + 1 for i in range(items))}


def wait_for_completions(db_path: str, rank: int, n: int = 1,
                         timeout: float = 20.0) -> bool:
    """Poll the durable log until ``rank`` has ``n`` *completed* records
    (i.e. the world is bootstrapped and the rank is consuming work) or
    the timeout passes.  Chaos drivers gate their SIGKILL on this: a kill
    delivered before the victim even registers with the coordinator
    would strand the initial rendezvous, which is launcher territory —
    durable replay protects *running* worlds."""
    import sqlite3
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(db_path):
            try:
                db = sqlite3.connect(db_path, timeout=1.0)
                try:
                    row = db.execute(
                        "SELECT COUNT(*) FROM records WHERE kind=? AND "
                        "dst=?", ("completed", rank)).fetchone()
                finally:
                    db.close()
                if row and int(row[0]) >= n:
                    return True
            except sqlite3.Error:
                pass   # mid-creation / locked: retry
        time.sleep(0.05)
    return False


class WorkQueue:
    """Picklable SPMD main: durable work fan-out with a result spool.

    ``stall_rank`` sleeps ``stall_s`` before each item *in its first
    incarnation only*, giving fault injection a wide window where that
    rank holds unconsumed work.  Consumers depend on ``(ANY, ...)``
    because replayed events carry the recovery coordinator's rank as
    their source (the durable-channel contract), and the collector
    dedups by item id because replay is at-least-once."""

    def __init__(self, items: int, stall_rank: Optional[int] = None,
                 stall_s: float = 0.05, out_path: Optional[str] = None):
        self.items = items
        self.stall_rank = stall_rank
        self.stall_s = stall_s
        self.out_path = out_path
        self.results: Dict[int, int] = {}

    def __getstate__(self) -> dict:
        return {"items": self.items, "stall_rank": self.stall_rank,
                "stall_s": self.stall_s, "out_path": self.out_path}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self.results = {}

    # -- SPMD main ----------------------------------------------------------
    def __call__(self, ctx) -> None:
        ctx.submit_persistent(self._sink, deps=[(ANY, RANK_FAILED)],
                              name="wq.sink")
        if ctx.rank == 0:
            ctx.submit_persistent(self._collect, deps=[(ANY, "wq.done")],
                                  name="wq.collect")
            n_workers = max(1, ctx.n_ranks - 1)
            for i in range(self.items):
                ctx.fire(1 + i % n_workers, "wq.work", {"id": i, "x": i})
        else:
            ctx.submit_persistent(self._work, deps=[(ANY, "wq.work")],
                                  name="wq.work")

    def _work(self, ctx, events) -> None:
        d = events[0].data
        if (ctx.rank == self.stall_rank
                and not os.environ.get("EDAT_JOINED")):
            time.sleep(self.stall_s)
        ctx.fire(0, "wq.done", {"id": d["id"], "val": d["x"] * d["x"] + 1})

    def _collect(self, ctx, events) -> None:
        d = events[0].data
        self.results.setdefault(d["id"], d["val"])   # at-least-once dedup

    def _sink(self, ctx, events) -> None:
        pass   # RANK_FAILED is handled by the durable replay coordinator

    def result(self) -> Dict[str, int]:
        return {"n": len(self.results), "sum": sum(self.results.values())}

    # launcher post-run hook: spool the rank-0 result for the parent
    def _edat_finalize(self, ranks, stats) -> None:
        if self.out_path is None or 0 not in ranks:
            return
        tmp = self.out_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self.result(), f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, self.out_path)


def run_chaos(ranks: int = 4, procs: int = 2, items: int = 48,
              kill: int = -1, replace: bool = True,
              kill_after: float = 0.5, stall_s: float = 0.05,
              timeout: float = 60.0, workdir: Optional[str] = None,
              verbose: bool = True) -> Dict:
    """One full chaos round; returns a report dict (see keys below).

    With ``kill >= 0`` the process hosting that rank is SIGKILLed
    ``kill_after`` seconds in; with ``replace`` a replacement is launched
    mid-run and elastically joins (otherwise survivors absorb the
    replay).  The durable log lives in ``workdir`` (a fresh tempdir by
    default) and is diffed after the run: ``pending`` must be empty."""
    from repro_torch.durable.log import SqliteLog
    from repro_torch.net.launch import ProcessGroup

    own_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="edat_durable_demo_")
    db_path = os.path.join(workdir, "durable.sqlite")
    out_path = os.path.join(workdir, "result.pkl")
    ready_file = os.path.join(workdir, "rejoined")
    prog = WorkQueue(items, stall_rank=kill if kill >= 0 else None,
                     stall_s=stall_s, out_path=out_path)
    pg = ProcessGroup(
        ranks, prog, n_procs=procs, run_timeout=timeout, elastic=True,
        hb_interval=0.1, hb_timeout=1.0, workers_per_rank=1,
        unconsumed="ignore",
        durable={"path": db_path,
                 "join_timeout": 15.0 if (kill >= 0 and replace) else 0.0})
    pg.start()
    if kill >= 0:
        # only kill a *running* world: wait until the victim has consumed
        # at least one item, then let kill_after more seconds of work land
        wait_for_completions(db_path, rank=kill, timeout=timeout / 2)
        time.sleep(kill_after)
        pg.kill(kill)
        if replace:
            pg.respawn(kill, ready_file=ready_file)
    stats = pg.wait(check=False)
    got = None
    if os.path.exists(out_path):
        with open(out_path, "rb") as f:
            got = pickle.load(f)
    log = SqliteLog(db_path)
    pend = log.pending()
    n_fired = log.count("fired")
    n_completed = log.count("completed")
    n_replayed = log.count("replayed")
    log.close()
    want = expected(items)
    report = {
        "ok": got == want and not pend,
        "result": got, "expected": want,
        "pending": len(pend),
        "fired": n_fired, "completed": n_completed,
        "replayed": n_replayed,
        "rejoined": os.path.exists(ready_file),
        "exitcodes": pg.exitcodes(),
        "replays": (stats.get("durable") or {}).get("replays", []),
        "workdir": workdir,
    }
    if verbose:
        print(f"[repro_torch.durable.demo] result={got} expected={want} "
              f"pending={len(pend)} replayed={n_replayed} "
              f"rejoined={report['rejoined']} ok={report['ok']}")
    if own_dir and report["ok"]:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    return report


def _cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.durable.demo",
        description="Durable work-queue chaos demo: SIGKILL a rank "
                    "process mid-run, replay its tasks (optionally onto "
                    "an elastically-joined replacement), assert the "
                    "converged result.")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--items", type=int, default=48)
    ap.add_argument("--kill", type=int, default=-1,
                    help="rank whose process to SIGKILL (-1: no fault)")
    ap.add_argument("--replace", dest="replace", action="store_true",
                    default=True,
                    help="launch an elastic replacement (default)")
    ap.add_argument("--no-replace", dest="replace", action="store_false",
                    help="replay onto survivors only")
    ap.add_argument("--kill-after", type=float, default=0.5)
    ap.add_argument("--stall", type=float, default=0.05,
                    help="per-item dawdle of the doomed rank's first "
                         "incarnation (widens the kill window)")
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args(argv)
    report = run_chaos(ranks=args.ranks, procs=args.procs,
                       items=args.items, kill=args.kill,
                       replace=args.replace, kill_after=args.kill_after,
                       stall_s=args.stall, timeout=args.timeout)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(_cli())
