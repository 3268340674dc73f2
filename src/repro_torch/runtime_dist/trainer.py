"""Event-driven distributed trainer: EDAT as the coordination layer.

The counterpart of ``repro.runtime_dist.trainer``.  Every rank is an EDAT
rank.  The trainer is a v2 ``edat.Program``: it declares its typed event
channels, *attaches* to any runtime via :meth:`EventDrivenTrainer.start`,
and reports gathered results through :meth:`EventDrivenTrainer.result` —
the same code runs threads-as-ranks in one process
(:meth:`EventDrivenTrainer.run`, the in-proc convenience) or SPMD across OS
processes::

    res = edat.run(edat.deferred(trainer_program, model_cfg, data_cfg,
                                 opt_cfg, trainer_cfg, device=device),
                   ranks=4, procs=2, transport="socket",
                   unconsumed="ignore")

(``edat.deferred`` builds one trainer per spawned process.)  Each process
hosts ``transport.local_ranks`` trainer ranks; co-located ranks exchange
gradient events in-process (no socket frames), remote ranks over the
coalescing socket transport.  All inter-rank interactions are events — the
paper's model:

  * ``grad``    gradient exchange (data-parallel all-to-all of grad events;
                optionally int8-compressed), collected by a
                :class:`QuorumCollector`: K-of-N with a straggler timeout —
                bounded-staleness async DP; quorum=1.0 == synchronous DP.
  * ``ckpt``    async checkpointing: the step task fires a snapshot event
                to a persistent checkpoint task on rank 0; the write
                happens on another worker while the next step computes.
                ``ckpt_dir`` must be shared storage (all processes read it
                during recovery — process memory dies with the rank).
  * ``metric``  in-situ analytics pipeline (MONC pattern, §VI); history
                accumulates on rank 0's process.
  * ``final``   each rank ships its converged parameters to rank 0 on
                completion (the cross-process replacement for reading
                trainer state from shared memory).
  * RANK_FAILED machine-generated failure event (paper §VII).  In-proc it
                comes from ``Runtime.kill_rank``; across processes from
                the socket transport's heartbeat/EOF detector — a
                SIGKILLed process surfaces one RANK_FAILED per rank it
                hosted.  The handler sweeps *every* transport-dead rank
                out of the alive set in one go (so a multi-rank process
                death triggers exactly one coordinated recovery), then the
                leader broadcasts ``recover``: survivors roll back to the
                last durable checkpoint, re-shard the data stream
                (elastic), and continue.  Under a durable-mode runtime
                (``Session(durable=True)``, :mod:`repro_torch.durable`)
                that broadcast instead comes from the replay coordinator's
                callback, after the dead rank's logged events are
                re-homed — same rollback, coordinated ordering.

The trainer is pure data-parallel at the EDAT level.  Inside a rank the
step is the model's loss and ``torch.autograd.grad`` on the rank's device.
What differs from the reference, and why:

  * the port's model reads ``model.params``, so a step takes the
    gradient of the rank's tree as it stood when the step began, through a
    model object of that step's own (:func:`repro_torch.train.
    value_and_grad`): rank threads, and a rollback landing mid-step, never
    share one;
  * payloads are host numpy: gradients and final parameters as float32
    (bf16 -> float32 is exact; the reference carries bf16 on the wire), so
    :meth:`QuorumCollector.reduce` averages in float32; checkpoint
    snapshots carry each leaf in its dtype, bf16 as its ``|V2`` bits, as
    the reference's checkpoint file stores it;
  * the initial weights come from ``torch.Generator(device).manual_seed(
    cfg.seed)`` (torch cannot reproduce ``jax.random``), or from a given
    parameter tree of numpy arrays (``params``: the reference's init,
    carried over as :mod:`repro_torch.bridge` does);
  * ``device=None`` means the card, and without one the trainer raises.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import edat
from repro_torch import checkpoint as ckpt_store
from repro_torch.core.deprecation import warn_deprecated
from repro_torch.data import DataCfg, SyntheticLM
from repro_torch.models.common import init_tree
from repro_torch.optim import OptCfg, make_optimizer
from repro_torch.tree import tree_map
from repro_torch.core.device import resolve_device
from repro_torch.train import value_and_grad

#: typed event channels of the trainer program (v2 API); the runtime's
#: ``__``-prefixed heartbeat plumbing eids are exempt from declaration
CHANNELS = (edat.Channel("go", payload=int),
            edat.Channel("grad", payload=dict),
            edat.Channel("metric", payload=dict),
            edat.Channel("ckpt", payload=dict),
            edat.Channel("final", payload=dict),
            edat.Channel("recover", payload=dict),
            edat.Channel("suspect", payload=int),
            edat.Channel("hb", payload=int))


@dataclasses.dataclass
class TrainerCfg:
    steps: int = 20
    n_ranks: int = 2
    workers_per_rank: int = 2
    ckpt_every: int = 10
    ckpt_dir: Optional[str] = None
    quorum: float = 1.0          # fraction of alive ranks' grads required
    collect_timeout: float = 10.0  # straggler bound (s)
    stale_discount: float = 0.5  # weight applied to late gradient events
    compress: str = "none"       # none | int8
    seed: int = 0
    start_step: int = 0          # resume support
    # heartbeat failure detector (timer events, paper §VII): 0 = off.
    # A rank silent for hb_timeout is *suspected*: survivors treat it as
    # failed (roll back + re-shard); the suspect fences itself on waking.
    # (Across processes the socket transport's own heartbeat detector
    # additionally catches dead *processes* regardless of this knob.)
    hb_interval: float = 0.0
    hb_timeout: float = 3.0
    # test hook: {rank: (step, seconds)} injected stall
    stall: Optional[Dict[int, tuple]] = None


# ------------------------------------------------------- gradient payloads
def _q8_tree(tree):
    def q(x):
        x = np.asarray(x, np.float32)
        amax = float(np.max(np.abs(x))) + 1e-12
        return (np.round(x / amax * 127.0).astype(np.int8), amax)
    return tree_map(q, tree)


def _dq8_tree(tree):
    def dq(leaf):
        q, amax = leaf
        return q.astype(np.float32) * (amax / 127.0)
    return tree_map(dq, tree)


def _host32(t) -> np.ndarray:
    """A leaf as host numpy, floating leaves as float32 (exact for bf16)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.is_floating_point():
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def flatten_params(tree) -> Dict[str, np.ndarray]:
    """Flatten a parameter tree (tensors or numpy leaves) to ``{path:
    numpy array}``, floating leaves as float32 — the on-disk form of the
    distributed trainer's final parameters, and the common currency for
    comparing trainers across transports and packages."""
    flat = ckpt_store.store._flatten(tree_map(_host32, tree))
    return {k.lstrip("/"): v for k, v in flat.items()}


# ----------------------------------------------------------- quorum logic
class QuorumCollector:
    """K-of-N gradient quorum with bounded-staleness fold-in.

    Pure accumulation logic, factored out of the step task so it can be
    property-tested directly: ``offer`` payloads in *any* arrival order,
    and :meth:`reduce` yields the weighted mean

        (sum(fresh) + discount * sum(stale)) / (n_fresh + discount*n_stale)

    independent of that order (fresh gradients fold in ascending rank
    order, stale ones in ascending (step, rank) order, so the
    floating-point result is deterministic).

    * a payload from the collector's epoch at exactly ``step`` is *fresh*;
    * an earlier step from the same epoch is *stale* (discounted fold-in,
      the bounded-staleness rule);
    * other epochs (pre-recovery leftovers) and future steps are ignored.
    """

    def __init__(self, *, step: int, epoch: int, need: int,
                 stale_discount: float,
                 unpack: Callable[[Any], Any] = lambda g: g):
        self.step = step
        self.epoch = epoch
        self.need = need
        self.stale_discount = stale_discount
        self.unpack = unpack
        self.got: Dict[int, Any] = {}
        self.stale: List[tuple] = []    # (step, rank, grads)

    def offer(self, payload: Dict[str, Any]) -> bool:
        """Consider one grad-event payload; True iff it was accepted."""
        if payload["epoch"] != self.epoch:
            return False
        if payload["step"] == self.step:
            self.got[payload["rank"]] = self.unpack(payload["grads"])
            return True
        if payload["step"] < self.step:
            self.stale.append((payload["step"], payload["rank"],
                               self.unpack(payload["grads"])))
            return True
        return False

    @property
    def complete(self) -> bool:
        return len(self.got) >= self.need

    def ensure_own(self, rank: int, grads) -> None:
        """Own grads must participate even if the loopback event lost a
        race with the timeout (no-op when already collected)."""
        self.got.setdefault(rank, grads)

    def reduce(self):
        """Weighted mean over fresh + discounted stale gradients.
        Returns ``(gavg, n_fresh, n_stale)``; ``gavg`` leaves are host
        numpy (float32 for float32 payloads).  New arrays throughout:
        in-proc, co-located ranks share the payloads."""
        gsum = None
        weight = 0.0
        for r in sorted(self.got):      # deterministic fold order
            g = self.got[r]
            gsum = g if gsum is None else tree_map(np.add, gsum, g)
            weight += 1.0
        for _, _, g in sorted(self.stale,   # bounded staleness: discounted,
                              key=lambda t: t[:2]):   # deterministic order
            gsum = tree_map(
                lambda a, b: a + self.stale_discount * b, gsum, g)
            weight += self.stale_discount
        gavg = tree_map(lambda x: x / weight, gsum)
        return gavg, len(self.got), len(self.stale)


class _RankState:
    def __init__(self, rank):
        self.rank = rank
        self.mu = threading.Lock()  # serialises commit vs recovery rollback
        self.params = None
        self.opt_state = None
        self.step = 0
        self.epoch = 0            # bumped on every recovery
        self.alive: List[int] = []
        self.done = False
        self.stepping = False     # exactly one live step chain per rank
        self.chain_dropped = None # epoch of a "go" token eaten by the flag
        self.hb_mute = False      # test hook: simulated hang
        self.stale_used = 0
        self.timeouts = 0


class EventDrivenTrainer:
    """Elastic data-parallel trainer coordinated purely by EDAT events.

    One instance serves every rank of its process: :meth:`start` is the
    SPMD attach point (called once per local rank by ``Runtime.run``),
    :meth:`run` the in-proc convenience that owns a threads-as-ranks
    runtime.  State that crosses ranks does so *only* via events — the
    instance keeps per-rank state for the ranks it hosts, rank 0's
    process additionally accumulating ``history`` (metric events),
    ``final_params`` (final events) and ``recoveries``.

    ``model`` is an uninitialised model (``build_model(cfg)``); every
    rank draws its own parameters from ``cfg.seed``, or takes ``params``
    (numpy leaves, the model's tree) instead.  ``device``:
    ``None`` means ``"cuda"`` and raises without a card; a
    ``torch.device`` is taken as resolved (a spawned process then never
    probes the CUDA driver)."""

    def __init__(self, model, data_cfg: DataCfg, opt_cfg: OptCfg,
                 cfg: TrainerCfg, *, device=None, params=None):
        self.device = (device if isinstance(device, torch.device)
                       else resolve_device(device))
        self.model = model
        self.init_params = params
        self.data = SyntheticLM(data_cfg)
        self.opt = make_optimizer(opt_cfg)
        self.cfg = cfg
        self.history: List[Dict[str, Any]] = []
        self._hist_mu = threading.Lock()
        self._world_mu = threading.Lock()
        self.states = [_RankState(r) for r in range(cfg.n_ranks)]
        self.runtime: Optional[edat.Runtime] = None
        self.ckpt_writes = 0
        #: rollbacks executed by local ranks: {"rank", "step", "epoch"}
        self.recoveries: List[Dict[str, int]] = []
        #: rank -> final parameter tree, gathered on rank 0's process
        self.final_params: Dict[int, Any] = {}
        #: rank -> step its final event reported (same gather path)
        self.final_steps: Dict[int, int] = {}
        #: called (on rank 0's process) with each rank's final payload
        self.on_final: Optional[Callable[[Dict[str, Any]], None]] = None
        #: called (on rank 0's process) after each metric is recorded
        self.on_metric: Optional[Callable[[Dict[str, Any]], None]] = None
        #: True once the durable replay coordinator owns the recovery
        #: trigger (runtime in durable mode; see _arm_durable_recovery)
        self._durable_recovery = False

    # ----------------------------------------------------------- event glue
    def _pack_grads(self, host):
        if self.cfg.compress == "int8":
            return _q8_tree(host)
        return host

    def _unpack_grads(self, payload):
        if self.cfg.compress == "int8":
            return _dq8_tree(payload)
        return payload

    def _to_device(self, tree, like):
        """Host leaves as tensors on this trainer's device, each in the
        dtype of the same leaf of ``like``."""
        return tree_map(lambda a, p: ckpt_store.store.to_tensor(
            a, self.device, p.dtype), tree, like)

    # ------------------------------------------------------------ main SPMD
    channels = CHANNELS

    def result(self) -> Dict[str, Any]:
        """Gathered output (rank 0's process), in transport-independent
        currency: metric history, recoveries, and each reporting rank's
        final parameters flattened to ``{path: numpy array}``."""
        with self._hist_mu:
            return {
                "history": sorted(self.history, key=lambda m: m["step"]),
                "recoveries": list(self.recoveries),
                "final_params": {r: flatten_params(p)
                                 for r, p in self.final_params.items()},
                "final_steps": dict(self.final_steps),
            }

    def run(self, timeout: float = 300.0) -> Dict[str, Any]:
        """In-proc convenience: all ranks as threads in one Session.
        ``final_params`` are the ranks' live trees (tensors on the
        device); ``final_by_rank`` what the final events carried."""
        cfg = self.cfg
        with edat.Session(cfg.n_ranks,
                          workers_per_rank=cfg.workers_per_rank,
                          unconsumed="ignore", timeout=timeout) as s:
            self.runtime = s.runtime
            s.run(self)
        return {
            "history": sorted(self.history, key=lambda m: m["step"]),
            "final_params": [s.params for s in self.states],
            "final_by_rank": dict(self.final_params),
            "recoveries": list(self.recoveries),
            "stale_used": sum(s.stale_used for s in self.states),
            "timeouts": sum(s.timeouts for s in self.states),
            "ckpt_writes": self.ckpt_writes,
        }

    def _init_state(self, st: _RankState):
        cfg = self.cfg
        if self.init_params is not None:
            st.params = tree_map(
                lambda a: ckpt_store.store.to_tensor(a, self.device,
                                                     self.model.dtype),
                self.init_params)
        else:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            st.params = init_tree(self.model.param_specs(), gen,
                                  self.model.dtype, self.device)
        st.opt_state = self.opt.init(st.params)
        st.step = cfg.start_step
        st.alive = list(range(cfg.n_ranks))
        if cfg.ckpt_dir and cfg.start_step > 0:
            proto = {"params": st.params, "opt": st.opt_state}
            step, tree, _ = ckpt_store.restore(cfg.ckpt_dir, proto)
            tree = self._to_device(tree, proto)
            st.params, st.opt_state = tree["params"], tree["opt"]
            st.step = step

    def _ensure_world(self, n_ranks: int) -> None:
        """Reconcile ``cfg.n_ranks`` with the session's actual rank count
        (the session is authoritative — the v1 ``distributed_train``
        helper did the same via ``dataclasses.replace``).  Must run
        before any rank touches its state; racing rank threads are
        serialised by the lock and later arrivals see a match."""
        with self._world_mu:
            if self.cfg.n_ranks != n_ranks:
                self.cfg = dataclasses.replace(self.cfg, n_ranks=n_ranks)
                self.states = [_RankState(r) for r in range(n_ranks)]

    def start(self, ctx: edat.Context) -> None:
        """Attach one rank of the trainer to any (in-proc or distributed)
        runtime: initialise that rank's replica, submit its persistent
        tasks, and fire the first chain token.  Rank 0 (wherever its
        process lives) additionally hosts the metric/checkpoint/final
        collectors and the heartbeat monitor."""
        self._ensure_world(ctx.n_ranks)
        cfg = self.cfg
        self.runtime = ctx._rt
        if ctx.rank == 0:
            self._arm_durable_recovery()
        st = self.states[ctx.rank]
        self._init_state(st)

        # persistent tasks: the step engine, failure handling, recovery
        ctx.submit_persistent(self._step_task, deps=[(edat.SELF, "go")],
                              name="step")
        ctx.submit_persistent(self._on_rank_failed,
                              deps=[(edat.ANY, edat.RANK_FAILED)],
                              name="faildet")
        ctx.submit_persistent(self._on_recover, deps=[(edat.ANY, "recover")],
                              name="recover")
        if ctx.rank == 0:
            ctx.submit_persistent(self._metric_task,
                                  deps=[(edat.ANY, "metric")], name="metrics")
            ctx.submit_persistent(self._final_task,
                                  deps=[(edat.ANY, "final")], name="final")
            if cfg.ckpt_dir:
                ctx.submit_persistent(self._ckpt_task,
                                      deps=[(edat.SELF, "ckpt")], name="ckpt")
            if cfg.hb_interval > 0:
                self._hb_seen = {r: time.monotonic()
                                 for r in range(cfg.n_ranks)}
                self._hb_done: set = set()
                ctx.submit_persistent(self._hb_monitor,
                                      deps=[(edat.SELF, "__hbtick")],
                                      name="hbmon")
                ctx.fire_after(cfg.hb_interval, edat.SELF, "__hbtick")
        if cfg.hb_interval > 0:
            ctx.submit_persistent(self._on_suspect,
                                  deps=[(edat.ANY, "suspect")],
                                  name="suspect")
            # heartbeat pump: timer-driven, independent of the step task
            # (a first step or a long step must NOT look like a hang)
            ctx.submit_persistent(self._hb_pump,
                                  deps=[(edat.SELF, "__hbself")],
                                  name="hbpump")
            ctx.fire_after(cfg.hb_interval / 2, edat.SELF, "__hbself")
        # durable initial checkpoint: the recovery anchor
        if ctx.rank == 0 and cfg.ckpt_dir and cfg.start_step == 0:
            ckpt_store.save(cfg.ckpt_dir, st.step,
                            {"params": st.params, "opt": st.opt_state})
        ctx.fire(edat.SELF, "go")

    # ---------------------------------------------------------------- tasks
    def _step_task(self, ctx: edat.Context, events):
        st = self.states[ctx.rank]
        if st.done or self.runtime.is_dead(ctx.rank):
            return
        token = events[0].data     # chain token: the epoch it was fired for
        with st.mu:
            if token is not None and token != st.epoch:
                return             # stale chain token from before a recovery
            if st.stepping:
                # a duplicate "go" (e.g. two recoveries racing): exactly one
                # step chain may run per rank, or concurrent instances would
                # steal each other's grad events and diverge the replicas.
                # Remember the eaten token so the running instance can revive
                # the chain when it exits.
                st.chain_dropped = st.epoch
                return
            st.stepping = True
        again = False
        try:
            again = self._step_body(ctx, st)
        finally:
            with st.mu:
                st.stepping = False
                revive = (st.chain_dropped is not None
                          and st.chain_dropped == st.epoch and not st.done)
                st.chain_dropped = None
                epoch_now = st.epoch
        if again or revive:
            ctx.fire(edat.SELF, "go", epoch_now)

    def _step_body(self, ctx: edat.Context, st: "_RankState") -> bool:
        """One training step.  Returns True iff the chain should continue
        (the caller fires the next "go" after releasing the chain flag)."""
        cfg = self.cfg
        if cfg.stall and ctx.rank in cfg.stall:
            at, secs = cfg.stall[ctx.rank]
            if st.step == at:
                st.hb_mute = True    # a true hang silences the pump too
                time.sleep(secs)     # injected hang (straggler simulation)
                st.hb_mute = False
        epoch = st.epoch
        alive = sorted(st.alive)
        if ctx.rank not in alive:    # fenced while stalled
            st.done = True
            return False
        shard = alive.index(ctx.rank)
        batch = self.data.batch(st.step, shard, len(alive))
        batch = {k: torch.from_numpy(v).to(self.device, torch.long)
                 for k, v in batch.items()}
        (loss, metrics), grads = value_and_grad(self.model, st.params,
                                                batch)
        host = tree_map(_host32, grads)
        del grads

        payload = {"rank": ctx.rank, "step": st.step, "epoch": epoch,
                   "grads": self._pack_grads(host)}
        # ref=True: the packed tree is freshly materialised and never
        # mutated — co-located ranks share it in-process, remote ranks get
        # the zero-copy out-of-band encode
        ctx.fire(edat.ALL, "grad", payload, ref=True)

        # K-of-N quorum collection with straggler timeout (async DP)
        coll = QuorumCollector(
            step=st.step, epoch=epoch,
            need=max(1, int(np.ceil(cfg.quorum * len(alive)))),
            stale_discount=cfg.stale_discount, unpack=self._unpack_grads)
        deadline = time.monotonic() + cfg.collect_timeout
        while not coll.complete:
            if st.epoch != epoch or st.done:
                # recovery happened under us: abandon this step; the
                # recovery's own chain token (re)starts the stepping
                return False
            evs = ctx.retrieve_any([(edat.ANY, "grad")])
            for ev in evs:
                coll.offer(ev.data)
            if not evs:
                if time.monotonic() > deadline:
                    st.timeouts += 1
                    break
                time.sleep(0.002)
        coll.ensure_own(ctx.rank, host)
        gavg, n_got, n_stale = coll.reduce()
        st.stale_used += n_stale

        snap = None
        with st.mu:
            if st.epoch != epoch or st.done:
                # a rollback landed after collection: committing now would
                # silently clobber the restored checkpoint state
                return False
            gavg = tree_map(lambda a: torch.from_numpy(a).to(self.device),
                            gavg)
            with torch.no_grad():
                params, opt_state, om = self.opt.update(
                    gavg, st.opt_state, st.params, st.step)
            del gavg
            st.params, st.opt_state = params, opt_state
            st.step += 1
            step_now = st.step
            if (cfg.ckpt_dir and ctx.rank == min(alive)
                    and step_now % cfg.ckpt_every == 0):
                to_host = ckpt_store.store.to_numpy
                snap = {"params": tree_map(to_host, st.params),
                        "opt": tree_map(to_host, st.opt_state)}
            if step_now >= cfg.steps:
                st.done = True

        ctx.fire(0, "metric", {"rank": ctx.rank, "step": step_now,
                               "loss": float(loss),
                               "n_grads": n_got, "n_stale": n_stale})
        if snap is not None:
            ctx.fire(0, "ckpt", {"step": step_now, "snap": snap}, ref=True)

        if step_now < cfg.steps:
            return True
        # trained to completion: ship the converged replica to rank 0
        ctx.fire(0, "final",
                 {"rank": ctx.rank, "step": step_now,
                  "params": tree_map(_host32, st.params)}, ref=True)
        if cfg.hb_interval > 0:
            ctx.fire(0, "__hbdone", ctx.rank)
        return False

    def _ckpt_task(self, ctx: edat.Context, events):
        p = events[0].data
        ckpt_store.save(self.cfg.ckpt_dir, p["step"], p["snap"])
        self.ckpt_writes += 1

    def _metric_task(self, ctx: edat.Context, events):
        with self._hist_mu:
            self.history.append(events[0].data)
        hook = self.on_metric
        if hook is not None:
            hook(events[0].data)

    def _final_task(self, ctx: edat.Context, events):
        """Rank 0: collect each rank's converged parameters (ranks that
        die or get fenced never report — elastic by construction)."""
        p = events[0].data
        with self._hist_mu:
            self.final_params[p["rank"]] = p["params"]
            self.final_steps[p["rank"]] = int(p["step"])
        hook = self.on_final
        if hook is not None:
            hook(p)

    def _hb_pump(self, ctx: edat.Context, events):
        st = self.states[ctx.rank]
        if st.done or self.runtime.is_dead(ctx.rank):
            return                   # stop beating; timer chain ends
        if not st.hb_mute:
            ctx.fire(0, "hb", ctx.rank)
        ctx.fire_after(self.cfg.hb_interval / 2, edat.SELF, "__hbself")

    def _hb_monitor(self, ctx: edat.Context, events):
        """Timer-driven failure detector on rank 0 (paper §VII: machine
        generated events drive tasks).  Reads only rank-0-local state plus
        delivered hb/__hbdone events — it never peeks at other ranks'
        memory, so it works unchanged across processes."""
        cfg = self.cfg
        st = self.states[ctx.rank]
        now = time.monotonic()
        for ev in ctx.retrieve_any([(edat.ANY, "hb")] * (4 * cfg.n_ranks)):
            self._hb_seen[ev.data] = now
        for ev in ctx.retrieve_any([(edat.ANY, "__hbdone")] * cfg.n_ranks):
            self._hb_done.add(ev.data)
        suspects = [r for r in sorted(st.alive)
                    if r not in self._hb_done
                    and now - self._hb_seen.get(r, now) > cfg.hb_timeout]
        for r in suspects:
            ctx.fire(edat.ALL, "suspect", r)
        active = [r for r in st.alive
                  if r not in self._hb_done and r not in suspects
                  and not self.runtime.is_dead(r)]
        if active:
            ctx.fire_after(cfg.hb_interval, edat.SELF, "__hbtick")

    def _on_suspect(self, ctx: edat.Context, events):
        suspected = events[0].data
        st = self.states[ctx.rank]
        if suspected == ctx.rank:
            st.done = True          # fence myself: fail-stop enforcement
            return
        with st.mu:
            if suspected not in st.alive:
                return
            st.alive.remove(suspected)
            lead = st.alive and ctx.rank == min(st.alive)
        if ctx.rank == 0:
            self._hb_done.add(suspected)
        if lead and self.cfg.ckpt_dir:
            step = ckpt_store.latest_step(self.cfg.ckpt_dir) or 0
            ctx.fire(edat.ALL, "recover", {"step": step})

    def _on_rank_failed(self, ctx: edat.Context, events):
        st = self.states[ctx.rank]
        dead = events[0].data
        with st.mu:
            if dead not in st.alive:
                # already handled: the heartbeat-suspect path beat this
                # event, or an earlier RANK_FAILED's sweep took it (one
                # SIGKILLed process surfaces one event per hosted rank).
                # Re-firing "recover" here was the known duplicate-recovery
                # flake — two rollbacks racing the restarted step chain
                # could diverge the replicas.
                return
            # process-granularity sweep: every rank the transport already
            # knows to be dead leaves `alive` NOW, so a multi-rank process
            # death triggers exactly one coordinated recovery instead of
            # one per hosted rank.
            swept = [d for d in list(st.alive)
                     if d != ctx.rank and (d == dead
                                           or self.runtime.is_dead(d))]
            for d in swept:
                st.alive.remove(d)
            lead = st.alive and ctx.rank == min(st.alive)
        # leader triggers a coordinated rollback to the last durable ckpt
        if lead and self.cfg.ckpt_dir:
            if self._durable_recovery and not self.runtime.is_dead(0):
                # durable mode with the replay coordinator alive: the
                # rollback broadcast comes from the replay callback,
                # *after* the dead rank's events are re-homed (and after
                # an elastic replacement had its join window)
                return
            step = ckpt_store.latest_step(self.cfg.ckpt_dir) or 0
            ctx.fire(edat.ALL, "recover", {"step": step})

    # ------------------------------------------------- durable-mode recovery
    def _arm_durable_recovery(self) -> None:
        """Runtime in durable mode (``Session(durable=True)``): hand the
        recovery *trigger* to the replay coordinator.  The coordinator
        already diffs the task log on RANK_FAILED and re-homes the dead
        rank's unconsumed events; this callback then broadcasts the
        coordinated ``recover`` rollback exactly once, *after* replay —
        replacing the bespoke leader fire in :meth:`_on_rank_failed`
        (which stays armed as the fallback for the one failure replay
        cannot coordinate: the death of rank 0's own process).  While
        rank 0 is alive it is always ``min(st.alive)``, so no other
        leader races the callback.

        The trainer's own channels stay epoch-scoped rather than durable:
        a replayed gradient from before the rollback is discarded by the
        collector's epoch check anyway, so journaling them would buy
        nothing.  What durable mode contributes here is ordering (replay
        settles, an elastic replacement gets its join window, then one
        rollback) — the fair-weather path is byte-identical."""
        rt = self.runtime
        dur = getattr(rt, "_durable", None)
        if dur is None:
            return
        self._durable_recovery = True

        def _recover_after_replay(dead: int, revived: bool, n: int) -> None:
            if not self.cfg.ckpt_dir or rt.is_dead(0):
                return      # no rollback anchor / coordinator rank itself
            step = ckpt_store.latest_step(self.cfg.ckpt_dir) or 0
            rt._fire(min(rt._sched), edat.ALL, "recover", {"step": step},
                     persistent=False, ref=False)

        dur.add_replay_callback(_recover_after_replay)

    def _on_recover(self, ctx: edat.Context, events):
        st = self.states[ctx.rank]
        if self.runtime.is_dead(ctx.rank) or st.done:
            return
        info = events[0].data
        cfg = self.cfg
        proto = {"params": st.params, "opt": st.opt_state}
        try:
            step, tree, _ = ckpt_store.restore(cfg.ckpt_dir, proto,
                                               step=info["step"])
        except FileNotFoundError:
            return
        tree = self._to_device(tree, proto)
        with st.mu:
            st.params, st.opt_state = tree["params"], tree["opt"]
            st.step = step
            st.epoch += 1        # invalidates in-flight grads
            epoch_now = st.epoch
        with self._hist_mu:
            self.recoveries.append({"rank": ctx.rank, "step": step,
                                    "epoch": epoch_now})
        ctx.fire(edat.SELF, "go", epoch_now)


# ------------------------------------------------- distributed (processes)
def trainer_program(model_cfg, data_cfg, opt_cfg,
                    trainer_cfg: TrainerCfg, *,
                    device=None) -> EventDrivenTrainer:
    """Program factory for ``edat.run``/``Session``: builds the model
    and one :class:`EventDrivenTrainer`.  Wrap in ``edat.deferred`` so
    each spawned process constructs its own trainer — the unpicklable
    parts (locks, tensors) never cross a process boundary.  Resolve
    ``device`` before spawning (:func:`distributed_train` does) and pass
    the ``torch.device``, so no spawned process probes the CUDA driver.
    ``trainer_cfg.ckpt_dir`` must be on storage every process can reach —
    it is both the async checkpoint sink and the recovery source when a
    process dies."""
    from repro_torch.models import build_model
    return EventDrivenTrainer(build_model(model_cfg), data_cfg, opt_cfg,
                              trainer_cfg, device=device)


def distributed_train(n_ranks: int, model_cfg, data_cfg, opt_cfg,
                      trainer_cfg: TrainerCfg, *,
                      n_procs: Optional[int] = None,
                      timeout: float = 300.0,
                      out_dir: Optional[str] = None,
                      device=None,
                      **launch_kwargs) -> Dict[str, Any]:
    """Deprecated v1 helper — use the v2 Session API::

        res = edat.run(edat.deferred(trainer_program, model_cfg, data_cfg,
                                     opt_cfg, trainer_cfg, device=device),
                       ranks=n_ranks, procs=n_procs, transport="socket",
                       unconsumed="ignore")

    Returns ``{"history", "recoveries", "final_params", "stats"}``
    exactly as before (``final_params`` is ``{rank: {path: array}}``).
    With ``out_dir`` the results are additionally persisted in the old
    on-disk layout (history.json / recoveries.json / final_rank*.npz) —
    written after a successful run; a run that fails before rank 0's
    process finalizes leaves ``out_dir`` untouched (v1 wrote
    incrementally and could leave partial files).  ``device`` is
    resolved here, before any process is spawned."""
    warn_deprecated(
        "distributed_train is deprecated: use edat.run(edat.deferred("
        "trainer_program, ...), ranks=..., procs=..., transport='socket')")
    device = resolve_device(device)
    cfg = dataclasses.replace(trainer_cfg, n_ranks=n_ranks)
    # v1 launcher kwargs that moved in v2: keep the old contract working
    check = launch_kwargs.pop("check", True)
    join_timeout = launch_kwargs.pop("join_timeout", None)
    with edat.Session(n_ranks, procs=n_procs, transport="socket",
                      timeout=timeout,
                      workers_per_rank=cfg.workers_per_rank,
                      unconsumed="ignore", **launch_kwargs) as s:
        s.start(edat.deferred(trainer_program, model_cfg, data_cfg,
                              opt_cfg, cfg, device=device))
        s.wait(join_timeout, check=check)
        gathered = s.gather()
        res = dict(gathered or {"history": [], "recoveries": [],
                                "final_params": {}})
        res["stats"] = dict(s.stats)
    # persist only real results: never clobber a previous run's files
    # with empties when rank 0's process died before finalizing
    if out_dir and gathered is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "history.json"), "w") as f:
            json.dump(res["history"], f)
        with open(os.path.join(out_dir, "recoveries.json"), "w") as f:
            json.dump(res["recoveries"], f)
        steps_by_rank = res.get("final_steps", {})
        for r, flat in res["final_params"].items():
            np.savez(os.path.join(out_dir, f"final_rank{r}.npz"),
                     step=np.int64(steps_by_rank.get(r, 0)), **flat)
    return res


def load_distributed_results(out_dir: str) -> Dict[str, Any]:
    """Deprecated v1 helper — results now come straight from
    ``Session.gather()``.  Reads the old on-disk layout (which
    ``distributed_train(out_dir=...)`` still writes): ``history``,
    ``recoveries``, and ``final_params`` ({rank: {path: array}})."""
    warn_deprecated(
        "load_distributed_results is deprecated: read results from "
        "Session.gather() (edat.run returns them directly)")
    out: Dict[str, Any] = {"history": [], "recoveries": [],
                           "final_params": {}}
    hist = os.path.join(out_dir, "history.json")
    if os.path.exists(hist):
        with open(hist) as f:
            out["history"] = json.load(f)
    rec = os.path.join(out_dir, "recoveries.json")
    if os.path.exists(rec):
        with open(rec) as f:
            out["recoveries"] = json.load(f)
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("final_rank") and name.endswith(".npz"):
            r = int(name[len("final_rank"):-len(".npz")])
            with np.load(os.path.join(out_dir, name)) as z:
                out["final_params"][r] = {k: z[k] for k in z.files
                                          if k != "step"}
    return out


# --------------------------------------------------------------- smoke CLI
def _demo_cfgs(n_ranks: int, steps: int, ckpt_dir: Optional[str],
               ckpt_every: int = 4):
    """Small default model/data/opt/trainer configs for the smoke CLI and
    the examples."""
    from repro_torch.models import ModelCfg
    model_cfg = ModelCfg(
        name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=128,
        dtype="float32", remat="none", max_target_length=64)
    data_cfg = DataCfg(vocab=128, seq=32, global_batch=12, seed=7)
    opt_cfg = OptCfg(name="adamw", peak_lr=3e-2, warmup=5, total_steps=200,
                     clip_norm=1.0)
    trainer_cfg = TrainerCfg(steps=steps, n_ranks=n_ranks,
                             ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                             collect_timeout=60.0)
    return model_cfg, data_cfg, opt_cfg, trainer_cfg


def _cli(argv=None) -> int:
    """Distributed-trainer smoke: run the trainer program over a socket
    :class:`edat.Session`, optionally SIGKILL one process mid-training,
    and verify elastic recovery — CI runs this with ``--kill``."""
    import argparse
    import tempfile
    from repro_torch.checkpoint import latest_step

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime_dist.trainer",
        description="Distributed elastic trainer smoke test (v2 Session).")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=3)
    ap.add_argument("--kill", action="store_true",
                    help="SIGKILL the last process once the first real "
                         "checkpoint exists; survivors must recover and "
                         "finish")
    ap.add_argument("--timeout", type=float, default=240.0)
    ap.add_argument("--device", default=None,
                    help="torch device of every rank (default: cuda; "
                         "'cpu' runs on the CPU)")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)

    with tempfile.TemporaryDirectory(prefix="edat_trainer_smoke_") as td:
        ckdir = os.path.join(td, "ck")
        model_cfg, data_cfg, opt_cfg, trainer_cfg = _demo_cfgs(
            a.ranks, a.steps, ckdir, a.ckpt_every)
        with edat.Session(a.ranks, procs=a.procs, transport="socket",
                          timeout=a.timeout,
                          workers_per_rank=trainer_cfg.workers_per_rank,
                          unconsumed="ignore", hb_interval=0.2,
                          hb_timeout=1.5) as s:
            s.start(edat.deferred(trainer_program, model_cfg, data_cfg,
                                  opt_cfg, trainer_cfg, device=device))
            victim_ranks: set = set()
            if a.kill:
                deadline = time.monotonic() + a.timeout
                while ((latest_step(ckdir) or 0) < a.ckpt_every
                       and time.monotonic() < deadline):
                    time.sleep(0.05)
                got = latest_step(ckdir) or 0
                if got < a.ckpt_every:
                    s.wait(5, check=False)
                    print(f"smoke FAILED: no checkpoint appeared "
                          f"(latest={got})")
                    return 1
                victim = a.ranks - 1
                victim_ranks = {r for rs in s.placement for r in rs
                                if victim in rs}
                s.kill(victim)
                print(f"[smoke] killed the process hosting rank {victim} "
                      f"at checkpoint step {got}")
            s.wait(a.timeout, check=not a.kill)
            res = s.gather() or {"history": [], "recoveries": [],
                                 "final_params": {}}
        top = max((m["step"] for m in res["history"]), default=0)
        print(f"[smoke] steps reached: {top}/{a.steps}; "
              f"recoveries: {res['recoveries']}; "
              f"finals from ranks {sorted(res['final_params'])}")
        if top < a.steps:
            print("smoke FAILED: training did not reach the target step")
            return 1
        if a.kill and not res["recoveries"]:
            print("smoke FAILED: no elastic recovery was recorded")
            return 1
        if a.kill:
            survivors = set(range(a.ranks)) - victim_ranks
            if not survivors.issubset(set(res["final_params"])):
                print(f"smoke FAILED: missing finals "
                      f"{survivors - set(res['final_params'])}")
                return 1
        print("[smoke] OK")
        return 0


if __name__ == "__main__":
    import sys
    sys.exit(_cli())
