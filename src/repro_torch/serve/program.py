"""Event-driven LM serving as an EDAT :class:`~repro_torch.api.program.Program`.

The counterpart of ``repro.serve.program`` on the port's copy of the EDAT
runtime, with the same channels, tasks and backpressure.  The model runs on
``device`` (the card unless the caller asks for the CPU), in rank 0's
process only: over the socket transport the client processes never build
it and never touch the card.

Every interaction is an event on a declared typed channel; there is no
polling loop anywhere::

    client --request--> server          (ANY-sourced, open-loop loadgen)
    server --admit--> server            (SELF: slot reserved, prefill task)
    server --decode_tick--> server      (SELF: one self-sustaining chain)
    server --response--> client         (completion, tokens + timings)
    server --backpressure--> clients    (admission queue crossed its bound)

The server rank runs four persistent tasks:

* ``serve.request`` — admission control.  Enqueues the request, fires
  ``backpressure`` on/off signals around the queue bound, and reserves
  free decode slots by firing ``admit`` events.
* ``serve.prefill`` — one ``admit`` event per reserved slot.  Runs the
  prompt-length-dependent prefill *outside* the server lock (a long
  prompt never stalls the decode batch), then takes the lock only to
  splice the prefilled cache into its slot — the per-slot cache reset that
  makes slot reuse safe.
* ``serve.decode`` — the continuous-batching tick.  Exactly one
  self-sustaining ``decode_tick`` chain exists at any time, guarded by a
  ``_ticking`` flag under the server lock: a request arriving mid-decode
  joins the running batch instead of spawning a second chain that would
  burn redundant ticks.  Each tick advances every live slot one greedy
  token; completions fire ``response`` and free their slot for the next
  queued request.
* ``serve.rank_failed`` — a dead client's queued requests are purged
  (responses to it would be dropped by the transport anyway), so the
  server drains cleanly under client SIGKILL.

Client ranks replay an open-loop :class:`~repro_torch.serve.loadgen.LoadSpec`
schedule and throttle while the server signals backpressure.  All
latency accounting happens server-side from the ``t_sched`` stamps the
clients embed in their requests (CLOCK_MONOTONIC is system-wide on
Linux, so cross-process deltas on one box are meaningful).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import edat
from repro_torch.kernels import launch_counts, variant_counts

from .engine import DEFAULT_MAX_LEN, ServeEngine, resolve_device, serving_cfg
from .loadgen import LoadSpec, client_schedule, summarize

REQUEST = edat.Channel("request", payload=dict)
ADMIT = edat.Channel("admit", payload=dict)
DECODE_TICK = edat.Channel("decode_tick")
RESPONSE = edat.Channel("response", payload=dict)
BACKPRESSURE = edat.Channel("backpressure", payload=dict)
READY = edat.Channel("ready")

#: slot sentinel: reserved for a request whose prefill is in flight
_PENDING = "pending"


class ServeProgram:
    """Continuous-batching LM server (rank 0) + open-loop load clients
    (ranks 1..n-1) over the five declared channels above."""

    channels = (REQUEST, ADMIT, DECODE_TICK, RESPONSE, BACKPRESSURE, READY)

    def __init__(self, cfg, *, slots: int = 4,
                 max_len: int = DEFAULT_MAX_LEN,
                 load: Optional[LoadSpec] = None,
                 queue_bound: int = 8,
                 seed: int = 0,
                 throttle_timeout: float = 60.0,
                 ready_file: Optional[str] = None,
                 ready_after: int = 1,
                 device=None,
                 params: Optional[Dict[str, Any]] = None):
        # a torch.device comes resolved (run_serve resolves it in the
        # caller, before any process spawns), so client processes never
        # ask the CUDA driver
        self.device = (device if isinstance(device, torch.device)
                       else resolve_device(device))
        self.params = params
        self.cfg = serving_cfg(cfg, max_len)
        self.slots = slots
        self.max_len = max_len
        self.load = load or LoadSpec()
        self.queue_bound = queue_bound
        self.seed = seed
        self.throttle_timeout = throttle_timeout
        self.ready_file = ready_file
        self.ready_after = ready_after
        # -- server state (rank 0's process only; guarded by the EDAT
        # named lock "server" — every mutating task takes it) ----------
        self._engine: Optional[ServeEngine] = None
        self.queue: List[Dict[str, Any]] = []
        self.live: List[Any] = [None] * slots
        self.records: List[Dict[str, Any]] = []
        self._ticking = False
        self.tick_execs = 0
        self.bp_on = False
        self.bp_signals = 0
        self.served = 0
        self.admitted = 0
        self.dead: set = set()
        self.t_start: Optional[float] = None
        #: the kernels' counts in this process once warm-up is done
        self._counts0: Optional[Dict[str, Tuple[int, int]]] = None
        self._variants0: Optional[Dict[str, Dict[str, int]]] = None

    # -- engine (built lazily: client ranks never pay for the model
    # build) ------------------------------------------------------------------
    @property
    def engine(self) -> ServeEngine:
        if self._engine is None:
            self._engine = ServeEngine(self.cfg, slots=self.slots,
                                       max_len=self.max_len, seed=self.seed,
                                       device=self.device,
                                       params=self.params)
        return self._engine

    # ------------------------------------------------------------------ SPMD
    def start(self, ctx: edat.Context) -> None:
        if ctx.rank == 0:
            self._start_server(ctx)
        else:
            self._run_client(ctx)

    # ---------------------------------------------------------------- server
    def _start_server(self, ctx: edat.Context) -> None:
        # build + warm up before any load arrives, then release the
        # clients: measured latency is serving, not set-up
        self.engine.warmup(self.load.prompt_lens)
        self._counts0 = launch_counts()
        self._variants0 = variant_counts()
        self.t_start = time.monotonic()
        ctx.submit_persistent(self._on_request, deps=[(edat.ANY, REQUEST)],
                              name="serve.request")
        ctx.submit_persistent(self._on_admit, deps=[(edat.SELF, ADMIT)],
                              name="serve.prefill")
        ctx.submit_persistent(self._on_tick, deps=[(edat.SELF, DECODE_TICK)],
                              name="serve.decode")
        ctx.submit_persistent(self._on_rank_failed,
                              deps=[(edat.ANY, edat.RANK_FAILED)],
                              name="serve.rank_failed")
        for rank in range(1, ctx.n_ranks):
            ctx.fire(rank, READY)

    def _on_request(self, ctx: edat.Context, events) -> None:
        ctx.lock("server")
        ev = events[0]
        if ev.source in self.dead:
            return
        req = dict(ev.data)
        req["client"] = ev.source
        req["t_recv"] = time.monotonic()
        self.queue.append(req)
        self._signal_backpressure(ctx)
        self._pump(ctx)

    def _pump(self, ctx: edat.Context) -> None:
        """Admission (server lock held): reserve a free slot per queued
        request and hand it to the prefill task via an ``admit`` event."""
        while self.queue:
            try:
                slot = self.live.index(None)
            except ValueError:
                return                   # every slot live or reserved
            req = self.queue.pop(0)
            self.live[slot] = _PENDING
            self.admitted += 1
            ctx.fire(edat.SELF, ADMIT, {"slot": slot, "req": req})
        self._signal_backpressure(ctx)

    def _on_admit(self, ctx: edat.Context, events) -> None:
        d = events[0].data
        req, slot = d["req"], d["slot"]
        eng = self.engine
        max_new = eng.clip_max_new(len(req["prompt"]), req["max_new"])
        t_admit = time.monotonic()
        # the expensive prompt-length-dependent phase, deliberately
        # outside the server lock: decode ticks keep running
        first, pcache = eng.prefill(req["prompt"])
        ctx.lock("server")
        eng.attach(slot, len(req["prompt"]), first, pcache)
        rec = {"id": req["id"], "client": req["client"],
               "prompt_len": len(req["prompt"]), "tokens": [first],
               "left": max_new - 1,
               "t_sched": req.get("t_sched", req["t_recv"]),
               "t_send": req.get("t_send", req["t_recv"]),
               "t_recv": req["t_recv"], "t_admit": t_admit,
               "t_first": time.monotonic(),
               "throttled_s": req.get("throttled_s", 0.0)}
        self._touch_ready()
        if rec["left"] <= 0:
            self._complete(ctx, slot, rec)
            self._pump(ctx)
        else:
            self.live[slot] = rec
            if not self._ticking:
                # single-chain guard: at most one self-sustaining
                # decode_tick chain, ever
                self._ticking = True
                ctx.fire(edat.SELF, DECODE_TICK)

    def _on_tick(self, ctx: edat.Context, events) -> None:
        ctx.lock("server")
        self.tick_execs += 1
        live_idx = [i for i, s in enumerate(self.live)
                    if isinstance(s, dict)]
        if not live_idx:
            self._ticking = False
            return
        out = self.engine.step(live_idx)
        now = time.monotonic()
        for i in live_idx:
            rec = self.live[i]
            rec["tokens"].append(int(out[i]))
            rec["left"] -= 1
            if rec["left"] <= 0:
                rec["t_done"] = now
                self._complete(ctx, i, rec)
        self._pump(ctx)
        if any(isinstance(s, dict) for s in self.live):
            ctx.fire(edat.SELF, DECODE_TICK)
        else:
            self._ticking = False

    def _complete(self, ctx: edat.Context, slot: int,
                  rec: Dict[str, Any]) -> None:
        """Server lock held: record the request, answer the client, free
        the slot (the cache reset itself happens on the *next* admit's
        splice — a freed slot is never read before it is overwritten)."""
        rec.setdefault("t_done", time.monotonic())
        rec["n_out"] = len(rec["tokens"])
        rec.pop("left", None)
        self.records.append(rec)
        self.served += 1
        self.live[slot] = None
        if rec["client"] not in self.dead:
            ctx.fire(rec["client"], RESPONSE,
                     {"id": rec["id"], "tokens": rec["tokens"],
                      "t_first": rec["t_first"], "t_done": rec["t_done"]})

    def _signal_backpressure(self, ctx: edat.Context) -> None:
        """Event-carried backpressure (server lock held): one ``on``
        signal when the admission queue exceeds its bound, one ``off``
        when it drains to half — clients gate their open-loop schedule
        on it."""
        depth = len(self.queue)
        if not self.bp_on and depth > self.queue_bound:
            self.bp_on = True
            self.bp_signals += 1
            self._fire_bp(ctx, True, depth)
        elif self.bp_on and depth <= self.queue_bound // 2:
            self.bp_on = False
            self._fire_bp(ctx, False, depth)

    def _fire_bp(self, ctx: edat.Context, on: bool, depth: int) -> None:
        for rank in range(1, ctx.n_ranks):
            if rank not in self.dead:
                ctx.fire(rank, BACKPRESSURE, {"on": on, "depth": depth})

    def _on_rank_failed(self, ctx: edat.Context, events) -> None:
        ctx.lock("server")
        dead = events[0].data
        self.dead.add(dead)
        self.queue = [r for r in self.queue if r["client"] != dead]
        self._signal_backpressure(ctx)
        # live slots for the dead client drain normally; their responses
        # are dropped by the transport's dead-peer accounting

    def _touch_ready(self) -> None:
        if self.ready_file and self.admitted >= self.ready_after:
            try:
                with open(self.ready_file, "w") as f:
                    f.write(str(self.admitted))
            except OSError:
                pass

    # ---------------------------------------------------------------- client
    def _run_client(self, ctx: edat.Context) -> None:
        sched = client_schedule(self.load, ctx.rank - 1, ctx.n_ranks - 1,
                                self.cfg.vocab)
        resume = threading.Event()
        resume.set()

        def on_backpressure(c, events):
            if events[0].data["on"]:
                resume.clear()
            else:
                resume.set()

        ctx.submit_persistent(on_backpressure, deps=[(0, BACKPRESSURE)],
                              name=f"client{ctx.rank}.bp")
        ctx.submit_persistent(lambda c, e: None, deps=[(0, RESPONSE)],
                              name=f"client{ctx.rank}.resp")
        ctx.wait([(0, READY)])       # server is built and warm
        t0 = time.monotonic()
        for req in sched:
            target = t0 + req["t"]
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            throttled = 0.0
            if not resume.is_set():
                tw = time.monotonic()
                resume.wait(self.throttle_timeout)
                throttled = time.monotonic() - tw
            ctx.fire(0, REQUEST,
                     {"id": req["id"], "prompt": req["prompt"],
                      "max_new": req["max_new"], "t_sched": target,
                      "t_send": time.monotonic(),
                      "throttled_s": throttled})

    # --------------------------------------------------------------- results
    def result(self) -> Dict[str, Any]:
        """The round's records and counters.  ``kernel_launches`` and
        ``plain_calls`` (``{kernel: n}``, None before the server started)
        count each kernel's wrapper calls in this process since warm-up,
        and ``launches_by_variant`` (``{kernel: {variant: n}}``) the
        launches of each kernel that has variants: read in the server's
        own process, where over sockets the model runs."""
        eng = self._engine
        launched = plain = by_variant = None
        if self._counts0 is not None:
            now = launch_counts()
            launched = {k: now[k][0] - self._counts0[k][0] for k in now}
            plain = {k: now[k][1] - self._counts0[k][1] for k in now}
            vnow = variant_counts()
            by_variant = {k: {v: n - self._variants0[k][v]
                              for v, n in vnow[k].items()} for k in vnow}
        return {
            "records": sorted(self.records, key=lambda r: r["id"]),
            "served": self.served,
            "steps": eng.step_count if eng else 0,
            "prefills": eng.prefill_count if eng else 0,
            "tick_execs": self.tick_execs,
            "slots_leaked": sum(1 for s in self.live if s is not None),
            "queue_left": len(self.queue),
            "bp_signals": self.bp_signals,
            "dead": sorted(self.dead),
            "slots": self.slots,
            "kernel_launches": launched,
            "plain_calls": plain,
            "launches_by_variant": by_variant,
        }


# ----------------------------------------------------------------- factories
def serve_program(arch: str = "gemma3-1b", reduced: bool = True,
                  dtype: Optional[str] = None,
                  overrides: Optional[Dict[str, Any]] = None,
                  **kwargs: Any) -> ServeProgram:
    """Module-level factory for ``edat.deferred``.  ``overrides``
    replaces config fields (a depth cut such as
    ``{"n_layers": 4, "mtp_depth": 0}``); ``dtype`` is one more of them,
    the compute dtype (``"float32"``, ``"bfloat16"``); other keywords go
    to :class:`ServeProgram` (``device``, ``params``, ...)."""
    from repro_torch.configs import ARCHS, reduce_cfg
    spec = ARCHS[arch]
    cfg = reduce_cfg(spec.cfg) if reduced else spec.cfg
    fields = dict(overrides or {})
    if dtype is not None:
        fields["dtype"] = dtype
    return ServeProgram(cfg.replace(**fields), **kwargs)


def run_serve(*, arch: str = "gemma3-1b", reduced: bool = True,
              clients: int = 2, slots: int = 4,
              max_len: int = DEFAULT_MAX_LEN,
              load: Optional[LoadSpec] = None,
              queue_bound: int = 8,
              transport: str = "inproc", procs: Optional[int] = None,
              workers_per_rank: int = 2,
              timeout: float = 600.0,
              seed: int = 0,
              device=None,
              dtype: Optional[str] = None,
              overrides: Optional[Dict[str, Any]] = None,
              params: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One serving round end to end: spin up a Session (server rank 0 +
    ``clients`` loadgen ranks), run the open-loop load to completion,
    and return ``{"result", "stats", "summary", "wall_s"}``.

    ``summary`` rates are computed over the *serving window* (first
    scheduled arrival to last completion), not session wall time, so
    process spawn, model build and warm-up do not pollute tokens/s.

    ``device`` defaults to the card (RuntimeError without one, raised
    here before any process spawns), ``dtype`` overrides the config's, as
    ``overrides`` does its other fields (a depth cut), ``params`` serves a
    reference parameter tree of numpy arrays instead of the seeded init;
    over sockets it is pickled to every rank's process, so at full width
    leave it out and let the server seed its own."""
    device = resolve_device(device)
    load = load or LoadSpec()
    with edat.Session(1 + clients, procs=procs, transport=transport,
                      workers_per_rank=workers_per_rank,
                      unconsumed="ignore", timeout=timeout) as s:
        t0 = time.monotonic()
        s.run(edat.deferred(serve_program, arch=arch, reduced=reduced,
                            slots=slots, max_len=max_len, load=load,
                            queue_bound=queue_bound, seed=seed,
                            device=device, dtype=dtype,
                            overrides=overrides, params=params))
        wall = time.monotonic() - t0
        res = s.gather()
        stats = dict(s.stats)
    recs = res["records"]
    span = (max(r["t_done"] for r in recs) - min(r["t_sched"] for r in recs)
            if recs else 0.0)
    return {"result": res, "stats": stats, "wall_s": wall,
            "summary": summarize(recs, span)}
