"""The port's socket transport (``repro_torch.net``) against the original
(``repro.net``), program for program.

Each test runs one program on ``repro`` and on ``repro_torch`` and asserts
the same results and, where the program returns stats, the same event and
task counters.  Ranks run as spawned OS processes (or, for placement, as
two transports joined by a socket pair in this process), so the programs
are module-level and name their package by string: a spawned child imports
this module and picks the runtime itself.
"""
import functools
import importlib
import os
import pickle
import socket
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import _chaos as chaos                                       # noqa: E402

pytestmark = pytest.mark.timeout(300)

PKGS = ("repro", "repro_torch")
COUNTERS = ("events_sent", "events_received", "tasks_executed")
# heartbeats: a SIGKILLed peer is seen by EOF at once, so a generous
# timeout only keeps a loaded machine from declaring a live peer dead
HB = dict(hb_interval=0.2, hb_timeout=10.0)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _both(program):
    """Run ``program(pkg) -> (result, stats)`` on both packages; compare
    results, and the counters where the program returns stats."""
    (r_ref, s_ref), (r_port, s_port) = (program(p) for p in PKGS)
    assert r_port == r_ref
    if s_ref is not None:
        assert ({k: s_port[k] for k in COUNTERS}
                == {k: s_ref[k] for k in COUNTERS})
    return r_port


# ------------------------------------------------------------- programs
class PingPong:
    """Two ranks bat a counter back and forth; rank 0 keeps what it got."""

    def __init__(self, hops):
        self.hops = hops
        self.got = []

    def start(self, ctx):
        def ping(c, events):
            n = events[0].data
            if c.rank == 0:
                self.got.append(n)
            if n < self.hops:
                c.fire(1 - c.rank, "ball", n + 1)

        ctx.submit_persistent(ping, deps=[(1 - ctx.rank, "ball")])
        if ctx.rank == 0:
            ctx.fire(1, "ball", 0)

    def result(self):
        return self.got


class RingSum:
    """Every rank fires (rank+1)^2 on the typed ``val`` channel; rank 0
    gathers the sum (``tests/test_session.py``'s program)."""

    def __init__(self, pkg):
        edat = _mod(pkg, "edat")
        self.channels = (edat.Channel("val", payload=int),
                         edat.Channel("sum", payload=int))
        self.total = None
        self.per_rank = {}

    def start(self, ctx):
        if ctx.rank == 0:
            ctx.submit(self._gather,
                       deps=[(r, "val") for r in range(ctx.n_ranks)],
                       name="gather")
        ctx.fire(0, "val", (ctx.rank + 1) ** 2)

    def _gather(self, ctx, events):
        for e in events:
            self.per_rank[e.source] = e.data
        self.total = sum(e.data for e in events)

    def result(self):
        return {"total": self.total,
                "per_rank": dict(sorted(self.per_rank.items()))}


def _kill_main(ctx, pkg="", ready_path="", out_dir=""):
    """4 ranks / 2 procs: the victim process (ranks 2,3) stalls; each
    surviving rank writes a marker once it has seen RANK_FAILED for both
    ranks the victim hosted."""
    edat = _mod(pkg, "edat")
    seen = set()

    def on_fail(c, events):
        seen.add(events[0].data)
        if seen == {2, 3}:
            open(os.path.join(out_dir, f"failed_seen_{c.rank}"), "w").close()

    ctx.submit_persistent(on_fail, deps=[(edat.ANY, edat.RANK_FAILED)])
    if ctx.rank == 3:
        open(ready_path, "w").close()
        time.sleep(300)          # never finishes: must be SIGKILLed


class WorkQueue:
    """Durable work fan-out (``repro.durable.demo.WorkQueue`` on either
    package): rank 0 fires ``items`` work events round-robin over the
    workers on a durable channel, workers reply ``x*x + 1``, rank 0
    collects, deduplicated by item id.  ``stall_rank`` dawdles in its first
    incarnation only, so a SIGKILL of its process strands logged work."""

    def __init__(self, pkg, items, stall_rank, stall_s, out_path):
        self.pkg = pkg
        self.items = items
        self.stall_rank = stall_rank
        self.stall_s = stall_s
        self.out_path = out_path
        self.results = {}

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if k != "results"}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.results = {}

    def __call__(self, ctx):
        edat = _mod(self.pkg, "edat")
        ctx.submit_persistent(lambda c, e: None,
                              deps=[(edat.ANY, edat.RANK_FAILED)])
        if ctx.rank == 0:
            ctx.submit_persistent(self._collect, deps=[(edat.ANY, "wq.done")])
            for i in range(self.items):
                ctx.fire(1 + i % (ctx.n_ranks - 1), "wq.work",
                         {"id": i, "x": i})
        else:
            ctx.submit_persistent(self._work, deps=[(edat.ANY, "wq.work")])

    def _work(self, ctx, events):
        d = events[0].data
        if ctx.rank == self.stall_rank and not os.environ.get("EDAT_JOINED"):
            time.sleep(self.stall_s)
        ctx.fire(0, "wq.done", {"id": d["id"], "val": d["x"] * d["x"] + 1})

    def _collect(self, ctx, events):
        d = events[0].data
        self.results.setdefault(d["id"], d["val"])

    def _edat_finalize(self, ranks, stats):
        if 0 in ranks:
            with open(self.out_path, "wb") as f:
                pickle.dump({"n": len(self.results),
                             "sum": sum(self.results.values())}, f)


# ------------------------------------------------------------ sessions
def test_socket_ping_pong():
    def program(pkg):
        edat = _mod(pkg, "edat")
        with edat.Session(2, procs=2, transport="socket", timeout=60,
                          **HB) as s:
            stats = s.run(edat.deferred(PingPong, 6))
            return s.gather(), stats

    assert _both(program) == [1, 3, 5]


@pytest.mark.parametrize("transport,procs", [("inproc", None), ("inproc", 1),
                                             ("socket", 1), ("socket", 2)])
def test_run_parity_matrix(transport, procs):
    """The same program on every transport and placement, on both
    packages, yields one result and one set of counters."""
    def program(pkg):
        edat = _mod(pkg, "edat")
        with edat.Session(4, procs=procs, transport=transport,
                          timeout=60) as s:
            stats = s.run(edat.deferred(RingSum, pkg))
            return s.gather(), stats

    assert _both(program) == {"total": 30,
                              "per_rank": {0: 1, 1: 4, 2: 9, 3: 16}}


# -------------------------------------------------------------- frames
def _payloads():
    rng = np.random.default_rng(0)
    return [
        {"id": 3, "prompt": [5, 9, 1], "t": 0.25, "on": True, "s": "x"},
        rng.standard_normal((4, 8)).astype(np.float32),
        (None, b"\x00\xff", [1.5, {"k": rng.integers(0, 9, 6)}]),
        np.arange(12, dtype=np.int64).reshape(3, 4).T,   # not contiguous
        7,
    ]


def _blob(frames, objs):
    return (frames.encode(("hello", 2)) + frames.encode(("hb",))
            + b"".join(bytes(p) for p in frames.encode_batch(objs, oob=True))
            + b"".join(bytes(p) for p in frames.encode_batch(objs, oob=False))
            + frames.encode(("bye",)))


def _same(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def test_frames_identical_bytes_and_cross_decode():
    """Plain and batch frames, numpy buffers out of band and in band:
    the port's encoder writes the reference's bytes, and each decoder
    reads the other's frames, over a socket too."""
    ref, port = _mod("repro", "net.frames"), _mod("repro_torch", "net.frames")
    objs = _payloads()
    blobs = {f: _blob(f, objs) for f in (ref, port)}
    assert blobs[port] == blobs[ref]
    want = [("hello", 2), ("hb",), (ref.MSGS, objs), (ref.MSGS, objs),
            ("bye",)]
    for enc, dec in ((ref, port), (port, ref)):
        decoded, used, corrupt = dec.decode_buffer(bytearray(blobs[enc]))
        assert not corrupt and used == len(blobs[enc])
        assert _same([tuple(d) for d in decoded], want)
        a, b = socket.socketpair()
        try:
            enc.send_frame(a, ("msg", objs[0]))
            a.sendall(b"".join(bytes(p)
                               for p in enc.encode_batch(objs, oob=True)))
            assert dec.recv_frame(b) == ("msg", objs[0])
            kind, got = dec.recv_frame(b)
            assert kind == dec.MSGS and _same(got, objs)
        finally:
            a.close()
            b.close()


# ----------------------------------------------------------- placement
def test_colocated_ranks_exchange_zero_wire_frames():
    """A 4-rank world on 2 transports: every rank streams events to its
    co-located partner and to a remote rank.  Co-located columns of the
    wire counters end at zero; remote columns carry every event."""
    N = 40
    placement = {0: (0, 1), 2: (2, 3)}

    def program(pkg):
        edat = _mod(pkg, "edat")
        SocketTransport = _mod(pkg, "net").SocketTransport
        a, b = socket.socketpair()
        ts = [SocketTransport(0, 4, {2: a}, local_ranks=(0, 1),
                              placement=placement, **HB),
              SocketTransport(2, 4, {0: b}, local_ranks=(2, 3),
                              placement=placement, **HB)]
        rts = [edat.Runtime(4, transport=t, unconsumed="ignore") for t in ts]
        got = {r: {"co": [], "far": []} for r in range(4)}

        def main(ctx):
            def sink(kind):
                return lambda c, events: got[c.rank][kind].append(
                    events[0].data)

            partner, far = ctx.rank ^ 1, (ctx.rank + 2) % 4
            ctx.submit_persistent(sink("co"), deps=[(partner, "co")])
            ctx.submit_persistent(sink("far"), deps=[(far, "far")])
            for i in range(N):
                ctx.fire(partner, "co", i)
                ctx.fire(far, "far", i)

        stats = [None, None]

        def go(i):
            stats[i] = rts[i]._run_internal(main, timeout=60)

        ths = [threading.Thread(target=go, args=(i,)) for i in range(2)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(90)
            assert not t.is_alive(), "placement run wedged"
        wire = [(t.wire_sent_vector(), t.wire_recv_vector()) for t in ts]
        total = {k: stats[0][k] + stats[1][k] for k in COUNTERS}
        return (got, wire), total

    got, wire = _both(program)
    assert all(got[r] == {"co": list(range(N)), "far": list(range(N))}
               for r in range(4))
    assert wire == [([0, 0, N, N], [0, 0, N, N]),
                    ([N, N, 0, 0], [N, N, 0, 0])]


def test_killed_process_surfaces_rank_failed_for_all_hosted_ranks(tmp_path):
    """SIGKILL one process of a 4-rank/2-process world: both survivors
    observe RANK_FAILED for both ranks the victim hosted, then exit 0."""
    def program(pkg):
        out = tmp_path / pkg
        out.mkdir()
        ready = str(out / "ready")
        pg = _mod(pkg, "net.launch").ProcessGroup(
            4, functools.partial(_kill_main, pkg=pkg, ready_path=ready,
                                 out_dir=str(out)),
            n_procs=2, run_timeout=60, **HB)
        pg.start()
        chaos.sigkill_when_ready(pg, 2, ready, timeout=60, settle=0.3)
        stats = pg.wait(60)
        codes = pg.exitcodes()
        seen = sorted(r for r in range(4)
                      if (out / f"failed_seen_{r}").exists())
        return ({r: c == 0 for r, c in codes.items()}, seen,
                stats["tasks_executed"]), None

    assert _both(program) == ({0: True, 1: True, 2: False, 3: False},
                              [0, 1], 4)


def test_elastic_join_replays_durable_work_onto_replacement(tmp_path):
    """SIGKILL the process of a dawdling worker while it holds logged
    work; a replacement joins the running world, the durable log replays
    the stranded work, and the result equals the uninterrupted run's
    with nothing left pending."""
    from repro_torch.durable.demo import expected, wait_for_completions
    items, kill = 32, 2

    def program(pkg):
        out = tmp_path / pkg
        out.mkdir()
        db, res = str(out / "durable.sqlite"), str(out / "result.pkl")
        pg = _mod(pkg, "net.launch").ProcessGroup(
            4, WorkQueue(pkg, items, kill, 0.05, res), n_procs=2,
            run_timeout=90, elastic=True, workers_per_rank=1,
            unconsumed="ignore", durable={"path": db, "join_timeout": 15.0},
            **HB)
        pg.start()
        assert wait_for_completions(db, rank=kill, timeout=45.0)
        time.sleep(0.3)
        pg.kill(kill)
        chaos.wait_for_join(chaos.launch_replacement(pg, kill, str(out)),
                            timeout=45.0)
        pg.wait(check=False)
        with open(res, "rb") as f:
            got = pickle.load(f)
        log = _mod(pkg, "durable.log").SqliteLog(db)
        try:
            replayed, pending = log.count("replayed"), log.pending()
        finally:
            log.close()
        return (got, replayed > 0, pending, pg.exitcodes()), None

    got, replayed, pending, codes = _both(program)
    assert got == expected(items) and replayed and pending == []
    assert all(c == 0 for c in codes.values()), codes
