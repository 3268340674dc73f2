"""MONC-style in-situ data analytics (paper §VI, Figs 4-5).

Computational ranks saturate their analytics rank with raw ``field``
events; analytics ranks run the paper's pipeline as EDAT tasks:

  * a persistent *registration* task — a computational core registers, and
    per-core handler + deregistration tasks are submitted (paper Fig 4);
  * per-field persistent handler tasks that process raw data (arithmetic)
    and contribute to an inter-analytics reduction via events;
  * the reduction root is distributed round-robin over analytics ranks per
    (field, timestep) — the paper's explanation for bandwidth levelling
    off rather than degrading;
  * a persistent *writer federator* task on the root consumes the reduced
    value ("writes" it) and records the end-to-end latency.

The baseline (``BespokeAnalytics``) mimics the original MONC comms stack:
a single handler thread pool per rank with one coarse global lock
protecting shared state, synchronous reductions through a shared
structure, and explicit memory-cleaning passes that lock out progress —
the design the paper replaced.

Each raw item's arithmetic runs on the program's ``device`` (the card
unless the caller passes ``device="cpu"``): the handler copies the host
field there, reduces it, and brings the four-value partial back as host
numpy, which is what events carry.  Fields are made with numpy from the
same seeds as ever, and the reduction across analytics ranks stays host
numpy.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import edat
from repro_torch.core.deprecation import warn_deprecated
from repro_torch.core.device import resolve_device

#: ``_analyse`` calls in this process, by device type ("cuda", "cpu")
calls_by_device: Dict[str, int] = {}
_count_lock = threading.Lock()


def reset_counts() -> None:
    with _count_lock:
        calls_by_device.clear()


@dataclasses.dataclass
class InsituCfg:
    n_analytics: int = 2
    items_per_producer: int = 50
    field_elems: int = 512       # elements per raw data item
    n_fields: int = 2


def _analyse(x: torch.Tensor) -> torch.Tensor:
    """The per-item arithmetic of the paper's tests (ops + local reduce):
    sum, sum of squares, min and max of ``x``, on its device."""
    with _count_lock:
        kind = x.device.type
        calls_by_device[kind] = calls_by_device.get(kind, 0) + 1
    return torch.stack([x.sum(), (x * x).sum(), x.min(), x.max()])


def _partial(data: np.ndarray, device: torch.device) -> np.ndarray:
    """One raw host field analysed on ``device``; the partial comes back
    as host numpy (the one sync an item), since event payloads that leave
    torch code are host numpy."""
    return _analyse(torch.from_numpy(data).to(device)).cpu().numpy()


# ------------------------------------------------------------------- EDAT
class EdatAnalytics:
    """1:1 computational:analytics ranks (paper's benchmark setup):
    ranks [0, n) are analytics, ranks [n, 2n) are computational.

    A v2 ``edat.Program`` over ``2 * cfg.n_analytics`` ranks: declares
    its typed channels (including the per-(field, timestep) reduction
    channels, which are enumerable upfront from the config), attaches to
    *any* SPMD context via :meth:`start`, and reports through
    :meth:`result` — so the pipeline runs threads-as-ranks (:meth:`run`)
    or across OS processes (``edat.run(edat.deferred(insitu_program,
    cfg_kw), ranks=2n, transport="socket")``).  Each analytics rank
    knows upfront how many (field, timestep) reductions it roots; when
    its writer federator has consumed them all it fires one
    ``insitu_done`` event, and a transitory gather task on rank 0 folds
    those into ``self.summary`` (result count + mean latency, and the
    port's tally of ``_analyse`` calls by device and the totals) — the
    cross-process replacement for reading ``self.results`` from shared
    memory."""

    def __init__(self, cfg: InsituCfg, workers_per_rank: int = 4,
                 device=None):
        self.cfg = cfg
        self.workers = workers_per_rank
        #: where each raw item's arithmetic runs (``None``: the card)
        self.device = resolve_device(device)
        #: ``Session.stats`` of the last in-proc :meth:`run`
        self.stats = None
        self.results: List[tuple] = []
        self._mu = threading.Lock()
        self.t0 = 0.0
        n = cfg.n_analytics
        self._done_count = [0] * n
        self._lat_sum = [0.0] * n
        # per root rank: the partials it reduced by the device type that
        # analysed them, and its totals (the port's own summary keys)
        self._by_device = [{} for _ in range(n)]
        self._totals = [[] for _ in range(n)]
        #: aggregated by rank 0's gather task: {"results", "mean_latency_s"}
        #: as the reference's, and the port's "calls_by_device" (every
        #: ``_analyse`` call, by device type, whose partial was reduced)
        #: and "totals" (every reduced total, in no order)
        self.summary: Optional[Dict[str, float]] = None
        #: called (on rank 0's process) with the summary dict
        self.on_summary = None

    @property
    def channels(self) -> Sequence[edat.Channel]:
        """The pipeline's typed event vocabulary, enumerable upfront: the
        registration/data/completion channels plus one reduction channel
        per (field, timestep) pair."""
        cfg = self.cfg
        per_field = cfg.items_per_producer // cfg.n_fields
        chans = [edat.Channel("register", payload=int),
                 edat.Channel("field", payload=dict),
                 edat.Channel("dereg", payload=int),
                 edat.Channel("insitu_done", payload=dict)]
        chans += [edat.Channel(f"partial.{fid}.{ts}", payload=dict)
                  for fid in range(cfg.n_fields)
                  for ts in range(per_field)]
        return chans

    def result(self) -> Optional[Dict[str, float]]:
        """Gathered output (rank 0's process): the reduction summary."""
        return self.summary

    def expected_roots(self, rank: int) -> int:
        """How many (field, timestep) reductions ``rank`` roots."""
        cfg = self.cfg
        per_field = cfg.items_per_producer // cfg.n_fields
        return sum(1 for fid in range(cfg.n_fields)
                   for ts in range(per_field)
                   if (fid + ts) % cfg.n_analytics == rank)

    def run(self) -> Dict[str, float]:
        """In-proc convenience: all 2n ranks as threads in one Session."""
        cfg = self.cfg
        n = cfg.n_analytics
        self.t0 = time.monotonic()
        with edat.Session(2 * n, workers_per_rank=self.workers,
                          unconsumed="error", timeout=600) as s:
            self.stats = s.run(self)
        dt = time.monotonic() - self.t0
        raw = cfg.n_analytics * cfg.items_per_producer
        lat = np.mean([r[1] for r in self.results]) if self.results else 0
        return {"raw_items": raw, "results": len(self.results),
                "seconds": dt, "bandwidth_items_s": raw / max(dt, 1e-9),
                "mean_latency_s": float(lat)}

    def start(self, ctx: edat.Context):
        """Attach one rank's role (analytics or computational) to any
        in-proc or distributed runtime."""
        n = self.cfg.n_analytics
        if ctx.rank < n:
            self._analytics_main(ctx)
        else:
            self._producer_main(ctx)

    # -- analytics side -------------------------------------------------------
    def _analytics_main(self, ctx: edat.Context):
        cfg = self.cfg
        n = cfg.n_analytics

        def on_register(ctx2, events):
            core = events[0].data
            # per-core handler + deregistration tasks (paper Fig 4)
            ctx2.submit_persistent(on_field, deps=[(core, "field")],
                                   name=f"handler.{core}")
            ctx2.submit(on_deregister, deps=[(core, "dereg")])

        def on_field(ctx2, events):
            item = events[0].data
            partial = _partial(item["data"], self.device)
            # events are tagged with field+timestep (paper: "data is sent
            # tagged with the timestep and field name"); the reduction root
            # is distributed round-robin over analytics ranks
            root = (item["fid"] + item["ts"]) % n
            eid = f"partial.{item['fid']}.{item['ts']}"
            ctx2.fire(root if root != ctx2.rank else edat.SELF, eid,
                      {"t_fire": item["t_fire"], "partial": partial,
                       "device": self.device.type})

        def on_partial(ctx2, events):
            # reduction across analytics ranks: ALL-sourced dependency on
            # this (field, timestep)'s tagged events
            datas = [e.data for e in events]
            total = np.sum([d["partial"] for d in datas], axis=0)
            t_fire = min(d["t_fire"] for d in datas)
            lat = time.monotonic() - t_fire
            with self._mu:
                self.results.append((total, lat))
                self._done_count[ctx2.rank] += 1
                self._lat_sum[ctx2.rank] += lat
                self._totals[ctx2.rank].append(total)
                tally = self._by_device[ctx2.rank]
                for d in datas:
                    tally[d["device"]] = tally.get(d["device"], 0) + 1
                done = self._done_count[ctx2.rank] == expected
            if done:
                self._fire_done(ctx2)

        def on_deregister(ctx2, events):
            ctx2.remove_task(f"handler.{events[0].data}")

        ctx.submit_persistent(on_register, deps=[(edat.ANY, "register")],
                              name="registration")
        if ctx.rank == 0:
            ctx.submit(self._gather_task,
                       deps=[(r, "insitu_done") for r in range(n)],
                       name="insitu-gather")
        expected = self.expected_roots(ctx.rank)
        if expected == 0:
            # this rank roots nothing (more analytics ranks than (field,
            # timestep) residues): report an empty completion immediately
            self._fire_done(ctx)
        # writer federator: one task per (field, timestep) this rank roots.
        # Dependencies name the n analytics ranks explicitly (EDAT_ALL would
        # also include the computational ranks).
        assert cfg.items_per_producer % cfg.n_fields == 0
        per_field = cfg.items_per_producer // cfg.n_fields
        for fid in range(cfg.n_fields):
            for ts in range(per_field):
                if (fid + ts) % n == ctx.rank:
                    ctx.submit(on_partial,
                               deps=[(r, f"partial.{fid}.{ts}")
                                     for r in range(n)])

    def _fire_done(self, ctx: edat.Context) -> None:
        with self._mu:
            payload = {"rank": ctx.rank,
                       "results": self._done_count[ctx.rank],
                       "lat_sum": self._lat_sum[ctx.rank],
                       "calls_by_device": dict(self._by_device[ctx.rank]),
                       "totals": np.array(self._totals[ctx.rank],
                                          np.float64).reshape(-1, 4)}
        ctx.fire(0 if ctx.rank != 0 else edat.SELF, "insitu_done", payload)

    def _gather_task(self, ctx: edat.Context, events):
        """Rank 0, once: fold every analytics rank's completion report."""
        total = sum(ev.data["results"] for ev in events)
        lat_sum = sum(ev.data["lat_sum"] for ev in events)
        by_device: Dict[str, int] = {}
        for ev in events:
            for kind, k in ev.data["calls_by_device"].items():
                by_device[kind] = by_device.get(kind, 0) + k
        self.summary = {"results": total,
                        "mean_latency_s": lat_sum / max(total, 1),
                        "calls_by_device": by_device,
                        "totals": [t for ev in events
                                   for t in ev.data["totals"]]}
        if self.on_summary is not None:
            self.on_summary(self.summary)

    # -- computational side -----------------------------------------------------
    def _producer_main(self, ctx: edat.Context):
        cfg = self.cfg
        n = cfg.n_analytics
        target = ctx.rank - n          # my analytics core
        ctx.fire(target, "register", ctx.rank)
        rng = np.random.default_rng(ctx.rank)
        for i in range(cfg.items_per_producer):
            fid = i % cfg.n_fields
            data = rng.standard_normal(cfg.field_elems)
            # ref=True: the array is never touched again — the coalescing
            # socket transport ships the field slice zero-copy
            ctx.fire(target, "field",
                     {"fid": fid, "ts": i // cfg.n_fields, "data": data,
                      "t_fire": time.monotonic()}, ref=True)
        ctx.fire(target, "dereg", ctx.rank)


# ------------------------------------------------- distributed (processes)
def insitu_program(cfg_kw: Dict, workers_per_rank: int = 4,
                   device=None) -> EdatAnalytics:
    """Program factory for ``edat.run``/``Session`` (wrap in
    ``edat.deferred`` so each spawned process builds its own pipeline):
    2n ranks, analytics [0, n) and computational [n, 2n)."""
    return EdatAnalytics(InsituCfg(**cfg_kw), workers_per_rank, device)


def _distributed_insitu(cfg: InsituCfg, timeout: float = 180.0,
                        **launch_kwargs) -> Dict[str, float]:
    """Session-backed distributed run returning the v1-shaped metrics
    dict (bandwidth from the in-child ``run_seconds``).  Shared by the
    deprecation shim and the benchmarks."""
    import dataclasses as _dc
    # default matches the v1 helper (children ran the Runtime default of
    # one worker per rank) — the benchmark baselines depend on it
    workers = launch_kwargs.pop("workers_per_rank", 1)
    # v1 launcher kwargs that moved in v2: keep the old contract working
    procs = launch_kwargs.pop("n_procs", None)
    check = launch_kwargs.pop("check", True)
    join_timeout = launch_kwargs.pop("join_timeout", None)
    # resolved here, so a missing card raises before any process spawns
    device = str(resolve_device(launch_kwargs.pop("device", None)))
    with edat.Session(2 * cfg.n_analytics, procs=procs,
                      transport="socket", timeout=timeout,
                      workers_per_rank=workers, **launch_kwargs) as s:
        s.start(edat.deferred(insitu_program, _dc.asdict(cfg), workers,
                              device))
        s.wait(join_timeout, check=check)
        summary = s.gather()
        stats = s.stats
    raw = cfg.n_analytics * cfg.items_per_producer
    dt = max(float(stats.get("run_seconds", 0.0)), 1e-9)
    return {"raw_items": raw, "results": int(summary["results"]),
            "seconds": dt, "bandwidth_items_s": raw / dt,
            "mean_latency_s": float(summary["mean_latency_s"])}


def distributed_insitu(cfg: InsituCfg, timeout: float = 180.0,
                       **launch_kwargs) -> Dict[str, float]:
    """Deprecated v1 helper — use the v2 Session API::

        edat.run(edat.deferred(insitu_program, dataclasses.asdict(cfg)),
                 ranks=2 * cfg.n_analytics, transport="socket")

    Returns the same metrics dict as :meth:`EdatAnalytics.run`, with
    bandwidth computed from the in-child ``run_seconds``."""
    warn_deprecated(
        "distributed_insitu is deprecated: use edat.run(edat.deferred("
        "insitu_program, ...), ranks=2*n, transport='socket')")
    return _distributed_insitu(cfg, timeout, **launch_kwargs)


# ---------------------------------------------------------------- baseline
class BespokeAnalytics:
    """MONC's original design, faithfully bad: coarse global lock, threads
    signalling through shared state, synchronous reduction, periodic
    memory-cleaning that blocks all handlers (paper §VI)."""

    def __init__(self, cfg: InsituCfg, threads_per_rank: int = 4,
                 device=None):
        self.cfg = cfg
        self.nthreads = threads_per_rank
        self.device = resolve_device(device)
        self.results: List[tuple] = []

    def run(self) -> Dict[str, float]:
        cfg = self.cfg
        n = cfg.n_analytics
        glock = threading.Lock()                  # the coarse lock
        pending: Dict[tuple, list] = {}           # (fid, ts) -> partials
        queues = [[] for _ in range(n)]
        qcv = [threading.Condition() for _ in range(n)]
        stop = [False]
        processed = [0]

        t0 = time.monotonic()

        def producer(rank):
            rng = np.random.default_rng(rank + 1000)
            for i in range(cfg.items_per_producer):
                item = {"fid": i % cfg.n_fields, "ts": i // cfg.n_fields,
                        "data": rng.standard_normal(cfg.field_elems),
                        "t_fire": time.monotonic()}
                with qcv[rank]:
                    queues[rank].append(item)
                    qcv[rank].notify()

        def handler(rank, tid):
            clean_counter = 0
            while True:
                with qcv[rank]:
                    if not queues[rank]:
                        if stop[0]:
                            return
                        qcv[rank].wait(0.01)
                        continue
                    item = queues[rank].pop(0)
                partial = _partial(item["data"], self.device)
                key = (item["fid"], item["ts"])
                with glock:                       # all state under one lock
                    lst = pending.setdefault(key, [])
                    lst.append((partial, item["t_fire"]))
                    if len(lst) == n:
                        total = np.sum([p for p, _ in lst], axis=0)
                        t_fire = min(t for _, t in lst)
                        self.results.append(
                            (total, time.monotonic() - t_fire))
                        del pending[key]
                    processed[0] += 1
                    clean_counter += 1
                    if clean_counter % 16 == 0:
                        # "memory cleaning" pass: holds the global lock
                        time.sleep(0.0005)
                        _ = {k: len(v) for k, v in pending.items()}

        producers = [threading.Thread(target=producer, args=(r,))
                     for r in range(n)]
        handlers = [threading.Thread(target=handler, args=(r, t))
                    for r in range(n) for t in range(self.nthreads)]
        for t in handlers + producers:
            t.start()
        for t in producers:
            t.join()
        total_items = n * cfg.items_per_producer
        while processed[0] < total_items:
            time.sleep(0.005)
        stop[0] = True
        for t in handlers:
            t.join()
        dt = time.monotonic() - t0
        lat = np.mean([r[1] for r in self.results]) if self.results else 0
        return {"raw_items": total_items, "results": len(self.results),
                "seconds": dt,
                "bandwidth_items_s": total_items / max(dt, 1e-9),
                "mean_latency_s": float(lat)}
