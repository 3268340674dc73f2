"""Graph500 BFS kernel: EDAT event-driven vs bulk-synchronous reference.

The port of ``repro.graph.bfs``: the same programs, with each level's
frontier expansion on the device (the card unless the caller passes
``device="cpu"``).  The CSR lives there; a rank's parent fragment lives
there until it converges.

EDAT version (paper §V, Fig 2): one *persistent* visit task per rank with
an EDAT_ALL dependency on ``visit`` events.  Each level, every rank fires
exactly one batched visit event to every rank (possibly empty), so the
ALL-dependency frames pair levels deterministically via the per-(src,dst)
FIFO guarantee — the level barrier is *implicit in the event matching*,
no global synchronisation call exists.  A rank's level is vectorised on
the device: the incoming batches go up to it, the parent rule keeps each
vertex's first occurrence across them, and the frontier is expanded with
``indptr`` gathers, ``repeat_interleave``, a stable sort by owner and
``searchsorted`` cuts.  The batches themselves stay host numpy (event
payloads that leave torch code are host numpy, here in page-locked
memory that :data:`host_pool` keeps for later levels and runs), so each
level's expanded edges cross the host once each way.

:class:`EdatBFS` is a v2 ``edat.Program``: it declares its typed event
channels, attaches to any SPMD context via :meth:`EdatBFS.start`, and
returns its gathered output through :meth:`EdatBFS.result` — so the same
code runs threads-as-ranks (:meth:`EdatBFS.run`, the in-proc
convenience) or across OS processes::

    res = edat.run(edat.deferred(bfs_program, n_ranks, scale=12, root=5),
                   ranks=n_ranks, transport="socket")

(:func:`bfs_program` rebuilds the Kronecker graph deterministically in
each spawned process, on that process's device — no broadcast needed.)  On
convergence every rank fires its parent fragment to rank 0 (``ref=True`` —
ownership handover, so the coalescing socket transport ships the numpy
frontier zero-copy); a transitory gather task on rank 0 assembles the full
parent array.  Level batches are also fired ``ref=True`` for the same
reason.

Reference version: classic BSP level-synchronous BFS — compute, exchange,
explicit global barrier per level (threading.Barrier standing in for
MPI_Alltoallv + barrier).  Its exchange buffers hold host numpy batches,
as the reference's do, so both programs move the same bytes through the
host.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import edat
from repro_torch.core.deprecation import warn_deprecated
from repro_torch.core.device import resolve_device
from .kronecker import PartitionedCSR, build_csr, kronecker_edges

#: typed event channels of the BFS program (v2 API)
VISIT = edat.Channel("visit", payload=dict)
BFS_PARENTS = edat.Channel("bfs_parents", payload=dict)

#: frontier expansions (``_expand`` calls) in this process, by device type
#: ("cuda", "cpu")
calls_by_device: Dict[str, int] = {}
_count_lock = threading.Lock()


def reset_counts() -> None:
    with _count_lock:
        calls_by_device.clear()


def _empty_batch() -> np.ndarray:
    return np.empty((0, 2), np.int64)


class _Lease:
    """One piece of a pooled host block, seen by numpy as a (k, 2) int64
    array: every array over it has this object as its base, so the piece
    goes back to its pool when the last of them dies."""
    __slots__ = ("__array_interface__", "block", "__weakref__")

    def __init__(self, block: torch.Tensor, start: int, rows: int):
        self.block = block
        self.__array_interface__ = {
            "shape": (rows, 2), "typestr": "<i8", "version": 3,
            "data": (block.data_ptr() + start, False)}


class HostPool:
    """Page-locked host blocks that the level batches come back through,
    shared by every level, rank and run in this process.  A request takes
    the smallest free range that holds it, in any block (a new block, a
    power of two of bytes, when none does), and its range is free again
    once no array over it is left.  So the blocks that one run's two
    largest levels needed serve any later run, whatever its rank count:
    a run pins host memory only where no earlier run needed as much.
    ``alloc(nbytes)`` makes a block (a uint8 tensor)."""

    ALIGN = 1 << 12
    MIN_BLOCK = 1 << 26

    def __init__(self, alloc: Callable[[int], torch.Tensor]):
        self._alloc = alloc
        self._lock = threading.Lock()
        #: [block, its free ranges [start, end) in bytes, sorted]
        self._blocks: List[list] = []
        self._generation = 0

    @property
    def pinned_bytes(self) -> int:
        with self._lock:
            return sum(b.numel() for b, _ in self._blocks)

    def take(self, rows: int) -> Tuple[torch.Tensor, np.ndarray]:
        """A (rows, 2) int64 piece: as a tensor to copy into, and as the
        numpy array whose views are handed out."""
        size = -(-max(16 * rows, 1) // self.ALIGN) * self.ALIGN
        with self._lock:
            best = None
            for bi, (_, free) in enumerate(self._blocks):
                for fi, (a, b) in enumerate(free):
                    if b - a >= size and (best is None
                                          or b - a < best[2]):
                        best = (bi, fi, b - a)
            if best is None:
                nbytes = max(self.MIN_BLOCK, 1 << (size - 1).bit_length())
                self._blocks.append([self._alloc(nbytes), [(0, nbytes)]])
                best = (len(self._blocks) - 1, 0, nbytes)
            bi, fi, _ = best
            block, free = self._blocks[bi]
            a, b = free[fi]
            if b - a == size:
                free.pop(fi)
            else:
                free[fi] = (a + size, b)
            generation = self._generation
        lease = _Lease(block, a, rows)
        weakref.finalize(lease, self._give_back, generation, bi, a, size)
        piece = block[a:a + 16 * rows].view(torch.int64).view(rows, 2)
        return piece, np.asarray(lease)

    def _give_back(self, generation: int, bi: int, a: int,
                   size: int) -> None:
        with self._lock:
            if generation != self._generation:
                return              # released while the piece was out
            free = self._blocks[bi][1]
            free.append((a, a + size))
            free.sort()
            merged = [free[0]]
            for lo, hi in free[1:]:
                if lo == merged[-1][1]:
                    merged[-1] = (merged[-1][0], hi)
                else:
                    merged.append((lo, hi))
            free[:] = merged

    def release(self) -> None:
        """Drop every block (a piece still out keeps its own block alive
        until its last array dies)."""
        with self._lock:
            self._blocks = []
            self._generation += 1


def _pinned(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


#: the host blocks the card's level batches come back through
host_pool = HostPool(_pinned)


def _upload(batches: Sequence[np.ndarray],
            device: torch.device) -> Optional[torch.Tensor]:
    """The non-empty (k, 2) host batches, in their order, concatenated on
    ``device``; None when all are empty."""
    parts = [torch.from_numpy(b).to(device) for b in batches if len(b)]
    if not parts:
        return None
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _settle(parent: torch.Tensor, inc: Optional[torch.Tensor],
            lo: int) -> torch.Tensor:
    """The reference's parent rule (``np.unique(v, return_index=True)``):
    each incoming vertex keeps its first occurrence across the batches in
    order, and takes that parent if it has none yet.  Returns the fresh
    vertices, sorted, as the new frontier (global ids)."""
    if inc is None:
        return torch.empty(0, dtype=torch.int64, device=parent.device)
    v, order = torch.sort(inc[:, 0] - lo, stable=True)
    first = torch.ones_like(v, dtype=torch.bool)
    first[1:] = v[1:] != v[:-1]
    v, p = v[first], inc[order[first], 1]
    fresh = parent[v] == -1
    v, p = v[fresh], p[fresh]
    parent[v] = p
    return v + lo


def _expand(csr: PartitionedCSR, rank: int,
            frontier: torch.Tensor) -> Tuple[List[np.ndarray], int]:
    """Expand ``rank``'s frontier via its CSR on the device: every (nbr,
    parent) pair in the reference's order, stably grouped by the owner of
    nbr.  Returns one host (k, 2) [nbr, parent] batch per destination rank
    and the edges traversed."""
    dev = frontier.device
    with _count_lock:
        calls_by_device[dev.type] = calls_by_device.get(dev.type, 0) + 1
    n = csr.n_ranks
    lo, _ = csr.local_range(rank)
    indptr, indices = csr.indptr[rank], csr.indices[rank]
    vloc = frontier - lo
    starts = indptr[vloc]
    counts = indptr[vloc + 1] - starts
    total = int(counts.sum())
    if not len(vloc):
        return [_empty_batch() for _ in range(n)], total
    # offset of each expanded edge: its row's start plus its place in the
    # row (arange minus the row's first place)
    firsts = torch.cumsum(counts, 0) - counts
    offs = torch.arange(total, device=dev) + torch.repeat_interleave(
        starts - firsts, counts, output_size=total)
    nbrs = indices[offs]
    del offs
    pars = torch.repeat_interleave(frontier, counts, output_size=total)
    owners, order = torch.sort(csr.owner(nbrs), stable=True)
    pairs = torch.stack([nbrs[order], pars[order]], 1)
    del nbrs, pars, order
    if pairs.is_cuda:
        # into page-locked host memory: a copy into fresh pageable memory
        # runs at the speed of its page faults, and the receiver's upload
        # from these pages is a direct copy too
        piece, out = host_pool.take(total)
        piece.copy_(pairs)
    else:
        out = pairs.numpy()
    cuts = torch.searchsorted(
        owners, torch.arange(n + 1, device=dev)).tolist()
    return [out[cuts[r]:cuts[r + 1]] for r in range(n)], total


def _gather_parent(csr: PartitionedCSR,
                   fragments: Dict[int, np.ndarray]) -> np.ndarray:
    out = np.full(csr.n_vertices, -1, np.int64)
    for r, frag in fragments.items():
        lo, hi = csr.local_range(r)
        out[lo:hi] = frag
    return out


# --------------------------------------------------------------- EDAT BFS
class EdatBFS:
    """Event-driven BFS over a partitioned CSR — an ``edat.Program``.

    ``run(root)`` owns an in-proc Session (threads-as-ranks); for a
    distributed run hand the program (usually via
    ``edat.deferred(bfs_program, ...)``) to ``edat.run``/``Session`` —
    each process hosts ``transport.local_ranks`` and the event flow is
    identical.  The assembled parent array (host numpy) lands in
    ``self.result_parent`` on the process hosting rank 0 (returned by
    :meth:`result`, and passed to ``on_result`` if set).  Each level's
    expansion runs on ``device`` (``None``: the card), where the CSR is
    moved if it is elsewhere."""

    channels = (VISIT, BFS_PARENTS)

    def __init__(self, csr: PartitionedCSR, workers_per_rank: int = 1,
                 progress: str = "thread", root: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        self.csr = csr.to(self.device)
        self.workers = workers_per_rank
        self.progress = progress
        #: default traversal root for start(ctx) (the Program protocol)
        self.root = root
        self.parent: List[Optional[torch.Tensor]] = [None] * csr.n_ranks
        self.traversed = [0] * csr.n_ranks
        self.levels = [0] * csr.n_ranks
        #: per rank: bytes of level batches it took up to the device and
        #: brought back to the host
        self.host_bytes = [0] * csr.n_ranks
        # per rank: its expansions by device type (the port's summary key)
        self._by_device: List[Dict[str, int]] = [{} for _ in
                                                 range(csr.n_ranks)]
        #: full parent array, assembled by rank 0's gather task
        self.result_parent: Optional[np.ndarray] = None
        #: every rank's expansions by device type, folded by the gather
        self.calls_by_device: Optional[Dict[str, int]] = None
        #: called (on rank 0's process) as on_result(parent, traversed)
        self.on_result: Optional[Callable[[np.ndarray, List[int]], None]] \
            = None
        #: test hook: (rank, level, seconds, ready_path) — that rank's
        #: visit task touches ready_path then sleeps at that level,
        #: holding the traversal mid-flight (SIGKILL injection point)
        self.stall: Optional[Tuple[int, int, float, Optional[str]]] = None

    def run(self, root: int, timeout: float = 600.0) -> np.ndarray:
        """In-proc convenience: all ranks as threads in one Session."""
        self.root = root
        with edat.Session(self.csr.n_ranks,
                          workers_per_rank=self.workers,
                          progress=self.progress, unconsumed="error",
                          timeout=timeout) as s:
            self._rt = s.runtime
            s.run(self)
        return self.result_parent

    def result(self) -> Dict[str, object]:
        """Gathered output (rank 0's process): the assembled parent array
        plus per-rank traversed-edge counts, and the port's expansions by
        device type and bytes through the host, over every rank."""
        return {"parent": self.result_parent,
                "traversed": list(self.traversed),
                "calls_by_device": self.calls_by_device,
                "host_bytes": sum(self.host_bytes)}

    def start(self, ctx: edat.Context, root: Optional[int] = None) -> None:
        """Attach the BFS to one rank of any (in-proc or distributed)
        runtime: submit the visit/gather/fail-stop tasks and fire the
        level-0 seed batches."""
        csr = self.csr
        root = self.root if root is None else root
        if root is None:
            raise ValueError("no BFS root: pass start(ctx, root) or set "
                             "EdatBFS(..., root=)")
        lo, hi = csr.local_range(ctx.rank)
        self.parent[ctx.rank] = torch.full((hi - lo,), -1, dtype=torch.int64,
                                           device=self.device)

        ctx.submit_persistent(self._visit_task,
                              deps=[(edat.ALL, VISIT)], name="visit")
        # fail-stop: without this, survivors of a mid-traversal rank loss
        # would idle forever inside the ALL-dependency (the dead rank's
        # level batch never arrives); raising turns RANK_FAILED into a
        # clean abort that the runtime propagates to every process
        ctx.submit_persistent(self._failstop,
                              deps=[(edat.ANY, edat.RANK_FAILED)],
                              name="bfs-failstop")
        if ctx.rank == 0:
            ctx.submit(self._gather_task,
                       deps=[(r, BFS_PARENTS)
                             for r in range(ctx.n_ranks)], name="gather")
        # level 0: everyone fires its (mostly empty) seed batch
        if csr.owner(np.int64(root)) == ctx.rank:
            seed = np.array([[root, root]], np.int64)
        else:
            seed = _empty_batch()
        for r in range(ctx.n_ranks):
            ctx.fire(r if r != ctx.rank else edat.SELF, "visit",
                     {"edges": seed if r == csr.owner(np.int64(root))
                      else _empty_batch(), "active": 1},
                     ref=True)

    def _failstop(self, ctx: edat.Context, events):
        raise RuntimeError(
            f"BFS aborted on rank {ctx.rank}: rank {events[0].data} "
            f"failed mid-traversal")

    def _gather_task(self, ctx: edat.Context, events):
        """Rank 0, once: assemble the global parent array from every
        rank's converged fragment."""
        by_device: Dict[str, int] = {}
        for ev in events:
            d = ev.data
            self.traversed[d["rank"]] = int(d["traversed"])
            self.host_bytes[d["rank"]] = int(d["host_bytes"])
            for kind, k in d["calls_by_device"].items():
                by_device[kind] = by_device.get(kind, 0) + k
        out = _gather_parent(self.csr, {ev.data["rank"]: ev.data["parent"]
                                        for ev in events})
        self.calls_by_device = by_device
        self.result_parent = out
        if self.on_result is not None:
            self.on_result(out, list(self.traversed))

    def _visit_task(self, ctx: edat.Context, events):
        """One execution per level: consume all ranks' batches, expand."""
        csr = self.csr
        rank = ctx.rank
        lo, _ = csr.local_range(rank)
        parent = self.parent[rank]
        level = self.levels[rank]
        self.levels[rank] = level + 1
        if self.stall is not None and self.stall[0] == rank \
                and self.stall[1] == level:
            if self.stall[3]:
                open(self.stall[3], "w").close()
            time.sleep(self.stall[2])

        total_active = sum(ev.data["active"] for ev in events)
        if total_active == 0:
            # converged: nobody fired real work; stop the cascade and ship
            # this rank's fragment to the gatherer
            ctx.fire(0 if rank != 0 else edat.SELF, "bfs_parents",
                     {"rank": rank, "parent": parent.cpu().numpy(),
                      "traversed": self.traversed[rank],
                      "host_bytes": self.host_bytes[rank],
                      "calls_by_device": dict(self._by_device[rank])},
                     ref=True)
            return

        batches = [ev.data["edges"] for ev in events]
        frontier = _settle(parent, _upload(batches, self.device), lo)
        out, traversed = _expand(csr, rank, frontier)
        self.traversed[rank] += traversed
        self.host_bytes[rank] += (sum(b.nbytes for b in batches)
                                  + sum(b.nbytes for b in out))
        kind = self.device.type
        self._by_device[rank][kind] = self._by_device[rank].get(kind, 0) + 1

        active = 1 if len(frontier) else 0
        ctx.fire_batch(
            [(r if r != rank else edat.SELF, "visit",
              {"edges": out[r], "active": active})
             for r in range(ctx.n_ranks)], ref=True)


# ------------------------------------------------- distributed (processes)
def bfs_program(n_ranks: int, scale: int, edgefactor: int = 16,
                seed: int = 20, root: int = 0, *, workers_per_rank: int = 1,
                stall=None, ready_path: Optional[str] = None,
                device=None) -> EdatBFS:
    """Program factory for ``edat.run``/``Session``: regenerates the
    Kronecker graph deterministically on ``device`` (no broadcast needed —
    each spawned process builds its own copy when wrapped in
    ``edat.deferred``), partitions it over ``n_ranks``, and returns the
    :class:`EdatBFS` program rooted at ``root``."""
    edges = kronecker_edges(scale, edgefactor, seed, device=device)
    csr = build_csr(edges, 1 << scale, n_ranks)
    del edges
    bfs = EdatBFS(csr, workers_per_rank=workers_per_rank, root=root,
                  device=device)
    if stall is not None:
        bfs.stall = (stall[0], stall[1], stall[2], ready_path)
    return bfs


def default_root(scale: int, edgefactor: int = 16, seed: int = 20,
                 device=None) -> int:
    """First vertex with nonzero degree (the Graph500 root rule)."""
    edges = kronecker_edges(scale, edgefactor, seed, device=device)
    deg = torch.bincount(edges.reshape(-1), minlength=1 << scale)
    return int(torch.nonzero(deg)[0, 0])


def _distributed_bfs(n_ranks: int, scale: int, edgefactor: int = 16,
                     seed: int = 20, root: Optional[int] = None,
                     timeout: float = 120.0, **launch_kwargs):
    """Session-backed distributed run returning ``(parent, info)`` in the
    v1 shape.  Shared by the deprecation shim and the benchmarks."""
    # resolved here, so a missing card raises before any process spawns
    device = str(resolve_device(launch_kwargs.pop("device", None)))
    if root is None:
        root = default_root(scale, edgefactor, seed, device=device)
    workers = launch_kwargs.pop("workers_per_rank", 1)
    # v1 launcher kwargs that moved in v2: keep the old contract working
    procs = launch_kwargs.pop("n_procs", None)
    check = launch_kwargs.pop("check", True)
    join_timeout = launch_kwargs.pop("join_timeout", None)
    with edat.Session(n_ranks, procs=procs, transport="socket",
                      timeout=timeout, workers_per_rank=workers,
                      **launch_kwargs) as s:
        s.start(edat.deferred(bfs_program, n_ranks, scale,
                              edgefactor=edgefactor, seed=seed, root=root,
                              workers_per_rank=workers, device=device))
        s.wait(join_timeout, check=check)
        res = s.gather()
        stats = s.stats
    parent = res["parent"]
    traversed = int(np.sum(res["traversed"]))
    info = dict(stats)
    dt = max(float(stats.get("run_seconds", 0.0)), 1e-9)
    info.update(root=root, traversed=traversed, teps=traversed / dt,
                events_per_s=stats.get("events_sent", 0) / dt)
    return parent, info


def distributed_bfs(n_ranks: int, scale: int, edgefactor: int = 16,
                    seed: int = 20, root: Optional[int] = None,
                    timeout: float = 120.0, **launch_kwargs):
    """Deprecated v1 helper — use the v2 Session API::

        res = edat.run(edat.deferred(bfs_program, n_ranks, scale=scale,
                                     root=root),
                       ranks=n_ranks, transport="socket")

    Returns ``(parent, info)`` exactly as before: the assembled parent
    array plus run stats (``run_seconds``, ``teps``, ``events_per_s`` —
    all-rank user events/s incl. SELF loopback fires — ``traversed``,
    ``root``).  ``device=`` (``None``: the card) is where each process
    builds its graph and expands."""
    warn_deprecated(
        "distributed_bfs is deprecated: use edat.run(edat.deferred("
        "bfs_program, ...), ranks=..., transport='socket')")
    return _distributed_bfs(n_ranks, scale, edgefactor, seed, root,
                            timeout, **launch_kwargs)


# ---------------------------------------------------------- BSP reference
class ReferenceBFS:
    """Bulk-synchronous level-stepped BFS (the paper's reference analog),
    each rank's level on ``device`` (``None``: the card)."""

    def __init__(self, csr: PartitionedCSR, device=None):
        self.device = resolve_device(device)
        self.csr = csr.to(self.device)
        self.traversed = [0] * csr.n_ranks
        #: per rank: bytes of level batches through the host, as EdatBFS's
        self.host_bytes = [0] * csr.n_ranks

    def run(self, root: int) -> np.ndarray:
        csr = self.csr
        n = csr.n_ranks
        barrier = threading.Barrier(n)
        parent = [torch.full((csr.local_range(r)[1] - csr.local_range(r)[0],),
                             -1, dtype=torch.int64, device=self.device)
                  for r in range(n)]
        # exchange buffers: inbox[dst][src] = batch (host numpy)
        inbox = [[None] * n for _ in range(n)]
        done = [False]
        errors: List[BaseException] = []

        def worker(rank):
            lo, hi = csr.local_range(rank)
            if csr.owner(np.int64(root)) == rank:
                my = np.array([[root, root]], np.int64)
            else:
                my = _empty_batch()
            for r in range(n):
                inbox[r][rank] = my if csr.owner(np.int64(root)) == r \
                    else _empty_batch()
            barrier.wait()
            while not done[0]:
                batches = list(inbox[rank])
                frontier = _settle(parent[rank],
                                   _upload(batches, self.device), lo)
                out, traversed = _expand(csr, rank, frontier)
                self.traversed[rank] += traversed
                self.host_bytes[rank] += (sum(b.nbytes for b in batches)
                                          + sum(b.nbytes for b in out))
                got_any = len(frontier) > 0
                barrier.wait()               # everyone finished computing
                for r in range(n):
                    inbox[r][rank] = out[r]
                self._active[rank] = got_any
                barrier.wait()               # exchange complete
                if rank == 0:
                    done[0] = not any(self._active)
                barrier.wait()               # "broadcast" of done flag

        def guarded(rank):
            # a failed rank breaks the barrier, so no other rank waits on
            # it forever; run() raises the first failure
            try:
                worker(rank)
            except threading.BrokenBarrierError as exc:
                errors.append(exc)
            except BaseException as exc:
                errors.insert(0, exc)
                barrier.abort()

        self._active = [True] * n
        threads = [threading.Thread(target=guarded, args=(r,)) for r in
                   range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return _gather_parent(csr, {r: parent[r].cpu().numpy()
                                    for r in range(n)})


def validate_bfs_tree(edges, parent, root: int) -> bool:
    """Graph500-style validation: root is its own parent, every reached
    vertex's parent edge exists, tree levels are consistent (parent level =
    child level - 1 via BFS from root over the tree).  Runs on ``edges``'
    device (a tensor there, or host numpy on the CPU); ``parent`` may be
    host numpy.  The edge set is the sorted, deduplicated keys min * n +
    max of the non-loop edges, searched for each parent edge."""
    edges = torch.as_tensor(edges)
    dev = edges.device
    parent = torch.as_tensor(parent).to(dev)
    n = len(parent)
    if int(parent[root]) != root:
        return False
    if bool((parent >= n).any()):
        return False        # no edge reaches past the last vertex
    e = edges[:, edges[0] != edges[1]]
    keys = torch.unique(torch.minimum(e[0], e[1]) * n
                        + torch.maximum(e[0], e[1]))
    del e
    reached = torch.nonzero(parent >= 0).squeeze(1)
    v = reached[reached != root]
    if len(v):
        p = parent[v]
        want = torch.minimum(v, p) * n + torch.maximum(v, p)
        if not len(keys):
            return False
        pos = torch.searchsorted(keys, want).clamp_max(len(keys) - 1)
        if not bool((keys[pos] == want).all()):
            return False
    # level consistency via tree walk
    level = torch.full((n,), -1, dtype=torch.int64, device=dev)
    level[root] = 0
    linked, up = parent >= 0, parent.clamp(min=0)
    # iterate: child level = parent level + 1 (tree is acyclic by parent)
    for _ in range(n):
        upd = torch.nonzero((level == -1) & linked
                            & (level[up] >= 0)).squeeze(1)
        if not len(upd):
            break
        level[upd] = level[parent[upd]] + 1
    return bool((level[reached] >= 0).all())
