"""The port's copy of the EDAT runtime against the original, program for
program.

``repro_torch`` carries its own copy of the runtime (``core``, ``api``,
``durable``, ``edat``) so that it imports nothing of ``repro``.  Each test
runs one small program on ``repro.edat`` and on ``repro_torch.edat`` and
asserts the same results and the same event/task counters.
"""
import re
import threading
import time

import pytest

pytest.importorskip("torch")

from repro import edat as ref_edat                           # noqa: E402
from repro_torch import edat as port_edat                    # noqa: E402

COUNTERS = ("events_sent", "events_received", "tasks_executed")


def _both(program):
    """Run ``program(edat) -> (result, stats)`` on both runtimes; compare
    results, and the counters where the program returns stats."""
    (r_ref, s_ref), (r_port, s_port) = (program(e)
                                        for e in (ref_edat, port_edat))
    assert r_port == r_ref
    if s_ref is not None:
        assert ({k: s_port[k] for k in COUNTERS}
                == {k: s_ref[k] for k in COUNTERS})
    return r_port


def _run(edat, n, main, workers=2, **kw):
    with edat.Session(n, workers_per_rank=workers, timeout=30.0, **kw) as s:
        stats = s.run(main)
    return stats


def test_ping_pong():
    def program(edat):
        got = []

        def ping(ctx, events):
            n = events[0].data
            got.append((ctx.rank, n))
            if n < 6:
                ctx.fire(1 - ctx.rank, "ball", n + 1)

        def main(ctx):
            ctx.submit_persistent(ping, deps=[(1 - ctx.rank, "ball")])
            if ctx.rank == 0:
                ctx.fire(1, "ball", 0)

        stats = _run(edat, 2, main)
        return got, stats

    assert _both(program) == [(r % 2 == 0 and 1 or 0, r) for r in range(7)]


def test_any_and_self_deps():
    def program(edat):
        got = []

        def gather(ctx, events):
            got.append(sorted(e.source for e in events[:2]) + [events[2].data])

        def main(ctx):
            if ctx.rank == 0:
                ctx.submit(gather, deps=[(edat.ANY, "x"), (edat.ANY, "x"),
                                         (edat.SELF, "me")])
                ctx.fire(edat.SELF, "me", "self")
            else:
                ctx.fire(0, "x", ctx.rank)

        stats = _run(edat, 3, main)
        return got, stats

    assert _both(program) == [[1, 2, "self"]]


def test_persistent_task():
    def program(edat):
        got = []

        def main(ctx):
            if ctx.rank == 0:
                ctx.submit_persistent(lambda c, e: got.append(e[0].data),
                                      deps=[(1, "e")], name="p")
            else:
                for i in range(5):
                    ctx.fire(0, "e", i)

        stats = _run(edat, 2, main)
        return sorted(got), stats

    assert _both(program) == [0, 1, 2, 3, 4]


def test_named_lock_mutual_exclusion():
    def program(edat):
        state = {"v": 0, "conc": 0, "max": 0}
        mu = threading.Lock()

        def t(ctx, events):
            ctx.lock("L")
            with mu:
                state["conc"] += 1
                state["max"] = max(state["max"], state["conc"])
            v = state["v"]
            time.sleep(0.002)
            state["v"] = v + 1
            with mu:
                state["conc"] -= 1

        def main(ctx):
            for _ in range(8):
                ctx.submit(t)

        stats = _run(edat, 1, main, workers=4)
        return (state["v"], state["max"]), stats

    assert _both(program) == (8, 1)


class _RingSum:
    """A Program with declared channels and a gathered result."""

    def __init__(self, edat):
        self.edat = edat
        self.TOKEN = edat.Channel("token", payload=int)
        self.channels = (self.TOKEN,)
        self.total = None

    def start(self, ctx):
        def relay(c, events):
            v = events[0].data + c.rank
            if c.rank == 0:
                self.total = v
            else:
                c.fire((c.rank + 1) % c.n_ranks, self.TOKEN, v)

        ctx.submit(relay, deps=[((ctx.rank - 1) % ctx.n_ranks, self.TOKEN)])
        if ctx.rank == 0:
            ctx.fire(1, self.TOKEN, 100)

    def result(self):
        return {"total": self.total}


def test_session_gather():
    def program(edat):
        with edat.Session(4) as s:
            stats = s.run(_RingSum(edat))
            return s.gather(), stats

    assert _both(program) == {"total": 106}


def test_session_call_future():
    def program(edat):
        with edat.Session(ranks=2) as s:
            fut = s.call(1, lambda ctx, events: ctx.rank * 100
                         + events[0].data, deps=[(0, "seed")])

            def main(ctx):
                if ctx.rank == 0:
                    ctx.fire(1, "seed", 7)

            stats = s.run(main)
            return (fut.done(), fut.result()), stats

    assert _both(program) == (True, 107)


def test_rank_failed_surfaces():
    def program(edat):
        seen = []
        s = edat.Session(3, workers_per_rank=1)

        def main(ctx):
            ctx.submit(lambda c, e: seen.append((c.rank, e[0].data)),
                       deps=[(edat.ANY, edat.RANK_FAILED)])
            if ctx.rank == 0:
                time.sleep(0.1)
                s.runtime.kill_rank(2)

        s.run(main, timeout=30)
        return sorted(seen), None     # counters depend on the kill's timing

    assert _both(program) == [(0, 2), (1, 2)]


def test_deprecated_runtime_run_warns_under_the_suite_filter():
    """The copied deprecation shim keeps the message the suite's
    ``error:.*is deprecated.*edat`` filter matches."""
    def main(ctx):
        ctx.fire(port_edat.SELF, "e", 1)
        ctx.submit(lambda c, e: None, deps=[(port_edat.SELF, "e")])

    with pytest.warns(DeprecationWarning) as rec:
        port_edat.Runtime(1).run(main)
    assert any(re.match(r".*is deprecated.*edat", str(w.message))
               for w in rec)


@pytest.mark.parametrize("progress", ["thread", "worker"])
def test_run_leaves_no_thread_holding_the_program(progress):
    """When ``run`` returns, the port's progress and timer threads have
    ended, so nothing but the caller holds what the program's tasks
    closed over: one ``gc.collect()`` frees it (a served model's weights,
    on the card)."""
    import gc
    import weakref

    class Held:
        pass

    held = Held()
    ref = weakref.ref(held)

    def main(ctx, held=held):
        ctx.submit_persistent(lambda c, e: held, deps=[(port_edat.SELF, "e")])
        ctx.fire(port_edat.SELF, "e", 1)

    s = port_edat.Session(2, workers_per_rank=1, timeout=30.0,
                          progress=progress)
    with s:
        rt = s.runtime                # the one-shot runtime of this run
        s.run(main)
        assert not any(t.is_alive()
                       for t in rt._prog_threads + [rt._timer_thread])
    del held, main, s, rt
    gc.collect()
    assert ref() is None
