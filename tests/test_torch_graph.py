"""The port's Graph500 BFS (``repro_torch.graph``) and its Kronecker
generator's draw kernel against the reference's ``repro.graph``, on the
CPU.

Both packages draw the graph from the same numpy PCG64 stream, so every
comparison here is bit-equal: edge lists, the per-rank CSR, the parent
arrays and traversed counts of the EDAT and BSP programs, ``default_root``
and ``validate_bfs_tree``'s verdict.  The port runs at ``device="cpu"``,
where the generator takes its plain version; the CUDA kernel's procedure
(``csrc/kronecker_gen.cu``) is held to numpy's draws through its Python
integer model in ``kernels/kronecker/ref.py``, whose constants are read
back out of the CUDA source.
"""
import os
import re
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
import chip_smoke                                            # noqa: E402
from repro import edat as redat                              # noqa: E402
from repro import graph as rgraph                            # noqa: E402
from repro_torch import edat as pedat                        # noqa: E402
from repro_torch import graph as pgraph                      # noqa: E402
from repro_torch.graph import bfs as pbfs                    # noqa: E402
from repro_torch.graph import kronecker as pkron             # noqa: E402
from repro_torch.kernels.kronecker import ops as kops        # noqa: E402
from repro_torch.kernels.kronecker import ref as kref        # noqa: E402

pytestmark = pytest.mark.timeout(300)

ROOT = os.path.dirname(os.path.dirname(__file__))
CPU = "cpu"
# heartbeats: a spawned child imports torch, which takes seconds, so a
# generous timeout keeps a loaded machine from declaring a live peer dead
HB = dict(hb_interval=0.2, hb_timeout=10.0)


def _graph(scale, edgefactor=16, seed=20):
    """(reference edges, port edges) of one graph."""
    return (rgraph.kronecker_edges(scale, edgefactor, seed),
            pgraph.kronecker_edges(scale, edgefactor, seed, device=CPU))


# ------------------------------------------------------------- generator
@pytest.mark.parametrize("seed", [20, 7])
@pytest.mark.parametrize("edgefactor", [8, 16])
@pytest.mark.parametrize("scale", range(6, 13))
def test_plain_generator_equals_reference(scale, edgefactor, seed):
    kops.reset_counts()
    want, got = _graph(scale, edgefactor, seed)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)
    assert (kops.kernel_launches, kops.plain_calls) == (0, 1)


def test_generator_constants_equal_the_reference():
    A, B, C = rgraph.kronecker.A, rgraph.kronecker.B, rgraph.kronecker.C
    assert (pkron.A, pkron.B, pkron.C) == (A, B, C)
    assert pkron.thresholds() == (A + B, C / (1 - A - B), A / (A + B))


def _numpy_draw(seed, i):
    rng = np.random.default_rng(seed)
    rng.bit_generator.advance(i)
    return rng.random()


@pytest.mark.parametrize("scale,edgefactor", [(10, 16), (25, 16)])
def test_kernel_model_draws_equal_numpy(scale, edgefactor):
    """The model's draw at each (bit, half, edge) index, as the kernel
    forms it (jump-ahead, XSL-RR, >> 11), times 2^-53, is numpy's draw at
    that offset: bits first, middle and last, both halves, edges at both
    ends (at scale 25 the indices pass 2^34)."""
    m = (1 << scale) * edgefactor
    s0, inc = kref.pcg_state(np.random.default_rng(20))
    for bit in (0, 1, scale // 2, scale - 1):
        for half in (0, 1):
            for e in (0, 1, 12345 % m, m - 2, m - 1):
                i = kref.draw_index(bit, half, e, m)
                got = kref.draw(s0, inc, i) * 2.0 ** -53
                assert got == _numpy_draw(20, i), (bit, half, e)


def test_kernel_model_threshold_integers_are_exact():
    """x * 2^-53 > t  <=>  x > threshold_int(t) at and around each of the
    generator's thresholds, and the integers are what the wrapper
    passes."""
    ts = pkron.thresholds()
    ints = kops.thresholds(*ts)
    for t, k in zip(ts, ints):
        assert k == kref.threshold_int(t)
        for x in range(k - 3, k + 4):
            assert (x * 2.0 ** -53 > t) == (x > k), (t, x)


@pytest.mark.parametrize("stride", [1, 37, 256])
def test_kernel_model_thread_procedure_equals_the_plain_draws(stride):
    """Threads of the kernel's grid, by its own procedure (a jump to their
    first edge, the map of m steps a draw, the map of the grid's threads an
    edge), write the plain version's src and dst, before the permutation."""
    scale, edgefactor, seed = 7, 8, 20
    m = (1 << scale) * edgefactor
    plain = kref.kronecker_draws_reference(np.random.default_rng(seed),
                                           scale, m, *pkron.thresholds())
    s0, inc = kref.pcg_state(np.random.default_rng(seed))
    ints = kops.thresholds(*pkron.thresholds())
    threads = range(stride) if stride < 64 else (0, 1, 100, stride - 1)
    for t in threads:
        for e, u, v in kref.thread_edges(t, stride, m, scale, s0, inc, ints):
            assert (u, v) == (int(plain[0, e]), int(plain[1, e])), (t, e)


def test_plain_draws_leave_the_generator_where_the_kernel_does():
    """The plain version's numpy draws and the kernel path's ``advance``
    leave the generator at the same state, so the permutation after them
    is the reference's."""
    scale, m = 6, 64 * 4
    a = np.random.default_rng(3)
    kref.kronecker_draws_reference(a, scale, m, *pkron.thresholds())
    b = np.random.default_rng(3)
    b.bit_generator.advance(kref.DRAWS_PER_BIT * scale * m)
    assert a.bit_generator.state == b.bit_generator.state


def test_kernel_constants_match_the_cuda_source():
    """The multiplier, the 53-bit shift and the draws a bit that the CUDA
    source states are the model's (which equals numpy's, above)."""
    src = (Path(kref.__file__).resolve().parents[2] / "csrc"
           / "kronecker_gen.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (0x[0-9A-Fa-f]+|\d+)",
                             src).group(1), 0)

    mult = (const("PCG_MULT_HI") << 64) | const("PCG_MULT_LO")
    assert mult == kref.PCG_MULT
    assert const("MANTISSA_SHIFT") == kref.MANTISSA_SHIFT == 11
    assert const("DRAWS_PER_BIT") == kref.DRAWS_PER_BIT == 2
    # the kernel's draw index: ii at DRAWS_PER_BIT * b * m + e, jj m later
    assert "ii = draw(DRAWS_PER_BIT * b * m + e)" in src
    assert "jj = draw(DRAWS_PER_BIT * b * m + m + e)" in src
    assert kref.draw_index(3, 0, 5, 100) == 2 * 3 * 100 + 5
    assert kref.draw_index(3, 1, 5, 100) == 2 * 3 * 100 + 100 + 5


def test_kernel_path_raises_for_a_buffered_or_foreign_generator():
    rng = np.random.default_rng(1)
    rng.integers(0, 2, dtype=np.uint32)       # leaves a buffered uint32
    with pytest.raises(ValueError, match="buffered"):
        kref.pcg_state(rng)
    with pytest.raises(ValueError, match="PCG64"):
        kref.pcg_state(np.random.Generator(np.random.MT19937(1)))
    with pytest.raises(ValueError, match="no kernel"):
        kops.kronecker_draws(np.random.default_rng(1), 4, 64,
                             *pkron.thresholds(), device="meta")


# -------------------------------------------------------------------- CSR
@pytest.mark.parametrize("n_ranks", [1, 2, 3, 4])
@pytest.mark.parametrize("scale", [8, 11])
def test_build_csr_equals_reference_rank_for_rank(scale, n_ranks):
    want_edges, edges = _graph(scale)
    want = rgraph.build_csr(want_edges, 1 << scale, n_ranks)
    got = pgraph.build_csr(edges, 1 << scale, n_ranks)
    assert (got.n_vertices, got.n_ranks, got.n_edges, got.block) == (
        want.n_vertices, want.n_ranks, want.n_edges, want.block)
    for r in range(n_ranks):
        assert got.local_range(r) == want.local_range(r)
        assert np.array_equal(got.indptr[r].numpy(), want.indptr[r])
        assert np.array_equal(got.indices[r].numpy(), want.indices[r])
    v = np.arange(1 << scale)
    assert np.array_equal(got.owner(torch.from_numpy(v)).numpy(),
                          want.owner(v))
    assert got.owner(np.int64(5)) == want.owner(np.int64(5))


# -------------------------------------------------------------------- BFS
def _roots(scale, edges):
    """default_root and two more vertices of the graph: the highest and
    the lowest degree among those with an edge."""
    deg = np.bincount(edges.reshape(-1), minlength=1 << scale)
    has = np.nonzero(deg)[0]
    return [rgraph.default_root(scale), int(has[np.argmax(deg[has])]),
            int(has[np.argmin(deg[has])])]


@pytest.mark.parametrize("n_ranks", [1, 2, 3, 4])
@pytest.mark.parametrize("scale", [8, 10])
def test_bfs_parents_and_traversed_equal_reference(scale, n_ranks):
    """EdatBFS and ReferenceBFS on the port give the reference's parent
    arrays bit for bit, and its traversed counts rank for rank, from
    several roots; the EDAT run's expansions all ran on the CPU."""
    want_edges, edges = _graph(scale)
    rcsr = rgraph.build_csr(want_edges, 1 << scale, n_ranks)
    pcsr = pgraph.build_csr(edges, 1 << scale, n_ranks)
    for root in _roots(scale, want_edges):
        redat_bfs, pedat_bfs = rgraph.EdatBFS(rcsr), pgraph.EdatBFS(
            pcsr, device=CPU)
        want = redat_bfs.run(root)
        pbfs.reset_counts()
        got = pedat_bfs.run(root)
        assert isinstance(got, np.ndarray) and got.dtype == np.int64
        assert np.array_equal(got, want), root
        res = pedat_bfs.result()
        assert np.array_equal(res["parent"], redat_bfs.result()["parent"])
        assert res["traversed"] == redat_bfs.result()["traversed"]
        assert pedat_bfs.levels == redat_bfs.levels
        assert res["calls_by_device"] == {"cpu": sum(pedat_bfs.levels)
                                          - n_ranks}
        assert dict(pbfs.calls_by_device) == res["calls_by_device"]
        rbsp, pbsp = rgraph.ReferenceBFS(rcsr), pgraph.ReferenceBFS(
            pcsr, device=CPU)
        want_bsp = rbsp.run(root)
        assert np.array_equal(pbsp.run(root), want_bsp), root
        assert pbsp.traversed == rbsp.traversed
        assert pbsp.host_bytes == pedat_bfs.host_bytes
        assert pgraph.validate_bfs_tree(edges, got, root)


def test_default_root_equals_reference():
    for scale, edgefactor, seed in ((6, 16, 20), (9, 8, 7), (12, 16, 20)):
        assert (pgraph.default_root(scale, edgefactor, seed, device=CPU)
                == rgraph.default_root(scale, edgefactor, seed))


def test_program_api_equals_reference():
    """``bfs_program`` and ``start(ctx, root)`` on an in-proc Session,
    as the reference's v2 API runs it."""
    got = {}
    for name, edat, graph, kw in (("ref", redat, rgraph, {}),
                                  ("port", pedat, pgraph,
                                   {"device": CPU})):
        prog = graph.bfs_program(3, 9, root=rgraph.default_root(9), **kw)
        with edat.Session(3, unconsumed="error", timeout=120) as s:
            s.run(prog)
            got[name] = s.gather()
    assert np.array_equal(got["port"]["parent"], got["ref"]["parent"])
    assert got["port"]["traversed"] == got["ref"]["traversed"]
    with pytest.raises(ValueError, match="no BFS root"):
        pgraph.EdatBFS(pgraph.build_csr(_graph(6)[1], 64, 1),
                       device=CPU).start(None)


# ------------------------------------------------------------- validation
@pytest.mark.parametrize("n_ranks", [1, 3])
@pytest.mark.parametrize("scale", [8, 10])
def test_validate_gives_the_reference_verdict(scale, n_ranks):
    """Sound trees pass on both; each planted fault (the root not its own
    parent, a parent edge missing, an unreachable cycle) fails on both,
    and so do the two faults phase 45 plants on the card."""
    want_edges, edges = _graph(scale)
    root = rgraph.default_root(scale)
    parent = rgraph.EdatBFS(rgraph.build_csr(
        want_edges, 1 << scale, n_ranks)).run(root)
    deg = np.bincount(want_edges.reshape(-1), minlength=1 << scale)
    cases = {"control": parent, **chip_smoke.bfs_cpu_faults(
        parent, root, want_edges), **chip_smoke.bfs_parent_faults(
        parent, root, deg)}
    assert set(cases) == {"control", "root_not_own_parent",
                          "parent_edge_missing", "unreachable_cycle",
                          *chip_smoke.BFS_FAULTS}
    for name, p in cases.items():
        want = rgraph.validate_bfs_tree(want_edges, p, root)
        assert want == (name == "control"), name
        assert pgraph.validate_bfs_tree(edges, p, root) == want, name
        assert pgraph.validate_bfs_tree(want_edges, torch.from_numpy(p),
                                        root) == want, name
    assert not pgraph.validate_bfs_tree(edges, np.where(
        parent == parent.max(), 1 << scale, parent), root)


# ---------------------------------------------------------------- sockets
def _socket_bfs(pkg, root):
    edat = redat if pkg == "repro" else pedat
    graph = rgraph if pkg == "repro" else pgraph
    kw = {"device": CPU} if pkg == "repro_torch" else {}
    with edat.Session(2, transport="socket", procs=1, timeout=120,
                      **HB) as s:
        s.run(edat.deferred(graph.bfs_program, 2, 9, root=root, **kw))
        return s.gather()


def test_socket_program_equals_reference():
    """``bfs_program`` through each package's Session over sockets (2
    ranks, 1 spawned process): the port's parents and traversed counts are
    the reference's, and its children report every expansion on the
    CPU."""
    root = rgraph.default_root(9)
    want, got = _socket_bfs("repro", root), _socket_bfs("repro_torch", root)
    assert np.array_equal(got["parent"], want["parent"])
    assert got["traversed"] == want["traversed"]
    assert set(got["calls_by_device"]) == {"cpu"}
    assert got["host_bytes"] > 0


def test_distributed_bfs_warns_once_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pgraph.distributed_bfs(2, 6)
    assert [str(w.message) for w in caught
            if issubclass(w.category, DeprecationWarning)] == [
        "distributed_bfs is deprecated: use edat.run(edat.deferred("
        "bfs_program, ...), ranks=..., transport='socket')"]


# --------------------------------------------------------------- host pool
def _cpu_pool():
    return pbfs.HostPool(lambda nbytes: torch.empty(nbytes,
                                                    dtype=torch.uint8))


def _live_ranges(pool):
    """(block, start, end) of every byte range of the pool not free."""
    out = []
    for bi, (block, free) in enumerate(pool._blocks):
        at = 0
        for a, b in free + [(block.numel(), block.numel())]:
            if a > at:
                out.append((bi, at, a))
            at = b
    return out


def test_host_pool_reuses_a_piece_once_its_last_view_dies():
    """A piece is a (rows, 2) int64 array over the pool's block; its
    views (as the level batches are) keep it out after the array itself
    is gone, and once the last dies the next request reuses the range."""
    pool = _cpu_pool()
    piece, arr = pool.take(1000)
    piece.copy_(torch.arange(2000).view(1000, 2))
    assert arr.shape == (1000, 2) and arr.dtype == np.int64
    assert np.array_equal(arr[:, 0], np.arange(0, 2000, 2))
    views = [arr[:300], arr[300:]]
    del piece, arr
    assert _live_ranges(pool) == [(0, 0, 16384)]     # 16,000 B, aligned
    _, other = pool.take(10)
    assert _live_ranges(pool) == [(0, 0, 16384 + 4096)]
    assert views[1][0, 0] == 600                      # not overwritten
    del views
    assert _live_ranges(pool) == [(0, 16384, 16384 + 4096)]
    del other
    assert _live_ranges(pool) == []
    _, again = pool.take(1000)
    assert _live_ranges(pool) == [(0, 0, 16384)]
    del again
    assert len(pool._blocks) == 1 and pool.pinned_bytes == pool.MIN_BLOCK


def test_host_pool_serves_every_rank_count_from_one_runs_blocks():
    """Level batches of the same sizes split over 1, 2, 4 and 8 ranks in
    phase 45's order, two levels live at once as in the BFS: once one
    rank has run, no larger rank count adds a block, and no two live
    pieces overlap."""
    rank_counts = chip_smoke.GRAPH_RANKS
    pool = _cpu_pool()
    pool.MIN_BLOCK = 1 << 12
    levels = [37, 51000, 700000, 520000, 3000, 5]
    blocks = []
    for R in rank_counts:
        live = []
        for rows in levels:
            prev, live = live, [pool.take(rows // R + r % 2)[1]
                                for r in range(R)]
            spans = sorted(_live_ranges(pool))
            assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:])
                       if a[0] == b[0])
            del prev
        del live
        assert _live_ranges(pool) == []
        blocks.append(len(pool._blocks))
    assert blocks[1:] == blocks[:1] * (len(rank_counts) - 1)


def test_host_pool_release_drops_its_blocks_but_not_live_pieces():
    pool = _cpu_pool()
    piece, arr = pool.take(0)
    assert arr.shape == (0, 2)
    piece, arr = pool.take(4)
    piece.fill_(7)
    pool.release()
    assert pool.pinned_bytes == 0
    assert (arr == 7).all()                  # its block lives on with it
    del piece, arr                           # gives back to nothing
    _, again = pool.take(4)
    assert len(pool._blocks) == 1 and again.shape == (4, 2)


# -------------------------------------------------------------- phase 45
def _emulate_the_card(monkeypatch, sass=True):
    """``chip_smoke``'s phase 45 at small scales with
    ``GRAPH_DEVICE="cpu"``: the generator's kernel is emulated by its
    plain version drawn from a copy of the generator (which is then
    advanced, as the kernel path leaves it), the card's timers by the
    host clock, its SASS by a fixed loop (none where ``sass`` is
    False)."""
    def emulated(rng, scale, m, ab, c_norm, a_norm, device=None):
        kref.pcg_state(rng)
        twin = np.random.default_rng()
        twin.bit_generator.state = rng.bit_generator.state
        out = kref.kronecker_draws_reference(twin, scale, m, ab, c_norm,
                                             a_norm)
        kops._count(kernel=True)
        rng.bit_generator.advance(kref.DRAWS_PER_BIT * scale * m)
        return out

    for name, value in dict(GRAPH_DEVICE="cpu", GRAPH_SCALE=11,
                            GRAPH_KERNEL_SCALE=8, GRAPH_PARITY_SCALE=10,
                            GRAPH_SAMPLES=50).items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(kops, "kronecker_gen", emulated)
    monkeypatch.setattr(kops, "kronecker_draws", emulated)
    monkeypatch.setattr(kops, "launch_shape",
                        lambda m: {"blocks": 1, "threads_per_block": 256})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: type("P", (), {
                            "multi_processor_count": 132}))
    loop = {"instructions": 83, "loops": 7, "nested_loops": 1}
    for name, fn in dict(
            _free=lambda: None, _empty_host_cache=lambda: None,
            _sass_loop=lambda *a: loop if sass else None,
            _max_sm_clock_hz=lambda: 1.98e9,
            cuda_ms=lambda fn, iters=1, warmup=0: (fn(), 0.0)[1],
            kernel_device_ms=lambda fn, entry, ms=None, **kw: (ms, 1, []),
    ).items():
        monkeypatch.setattr(chip_smoke, name, fn)


def test_phase_45_gates_on_the_cpu_with_the_kernel_emulated(monkeypatch):
    """``chip_smoke.phase_graph`` end to end on the emulated card: every
    gate holds (the planted faults included), the main path launched the
    generator once, and the kernels line carries the generator's entry,
    built as the other kernels' are."""
    _emulate_the_card(monkeypatch)
    out = {}
    chip_smoke.phase_graph(out)
    g = out["graph"]
    assert g["main_path"]["kernel_launches"] == 1
    assert g["main_path"]["plain_calls"] == 0
    assert [r["ranks"] for r in g["runs"]] == list(chip_smoke.GRAPH_RANKS)
    assert [chip_smoke.GRAPH_COLD_RUN in r for r in g["runs"]] == [
        True] + [False] * (len(chip_smoke.GRAPH_RANKS) - 1)
    assert not any(g["fault_verdicts"].values())
    assert g["root"] == rgraph.default_root(chip_smoke.GRAPH_SCALE)
    entry = chip_smoke.kernels_line(out)["kernels"][-1]
    assert (entry["name"], entry["launches"], entry["max_abs_err"]) == (
        "kronecker_gen", 1, 0)
    assert entry["launches_by_path"] == {"graph500-bfs": 1}
    assert (entry["sampled_bit_pairs"], entry["sampled_bad_bit_pairs"]) == (
        chip_smoke.GRAPH_SAMPLES * chip_smoke.GRAPH_SCALE, 0)
    assert entry["shape"]["scale"] == chip_smoke.GRAPH_SCALE
    assert entry["bound_ms"] > 0 and entry["plain_ms"] > 0


def test_phase_45_fails_where_the_kernels_sass_loop_cannot_be_read(
        monkeypatch):
    _emulate_the_card(monkeypatch, sass=False)
    with pytest.raises(AssertionError, match="SASS"):
        chip_smoke._graph_kernel({})


def test_phase_45_device_ms_is_read_in_a_fresh_process_where_not_here(
        monkeypatch):
    """The generator's device ms: the profiler in this process first,
    then in a fresh one; where neither keeps a launch, the phase
    fails."""
    import subprocess
    calls = []

    def here(keeps):
        def kernel_device_ms(fn, entry, ms=None, **kw):
            calls.append("here")
            if not keeps:
                raise AssertionError("profiled [0, 0] launches")
            return 2.5, 5, []
        return kernel_device_ms

    def fresh(rc, stdout):
        def run(cmd, **kw):
            calls.append("fresh")
            assert "_graph_profile_child(25, 3.0)" in cmd[-1]
            return subprocess.CompletedProcess(cmd, rc, stdout, "boom")
        return run

    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda: (1, 2))
    monkeypatch.setattr(chip_smoke.subprocess, "run", fresh(
        0, 'log\n{"device_ms": 2.25, "kept": 5, "windows": [[7, 7]]}\n'))
    monkeypatch.setattr(chip_smoke, "kernel_device_ms", here(True))
    assert chip_smoke._graph_kernel_device_ms(25, 3.0) == (
        2.5, "this process")
    assert calls == ["here"]
    calls.clear()
    monkeypatch.setattr(chip_smoke, "kernel_device_ms", here(False))
    assert chip_smoke._graph_kernel_device_ms(25, 3.0) == (
        2.25, "a fresh process")
    assert calls == ["here", "fresh"]
    for rc, stdout in ((1, "Traceback\n"), (0, "")):
        monkeypatch.setattr(chip_smoke.subprocess, "run", fresh(rc, stdout))
        with pytest.raises(AssertionError, match="fresh process"):
            chip_smoke._graph_kernel_device_ms(25, 3.0)


# ------------------------------------------------------------- durable demo
def test_durable_demo_differs_from_the_reference_only_by_the_rename():
    with open(os.path.join(ROOT, "src", "repro", "durable", "demo.py")) as f:
        want = f.read().replace("repro.", "repro_torch.").replace(
            "from repro import", "from repro_torch import")
    with open(os.path.join(ROOT, "src", "repro_torch", "durable",
                           "demo.py")) as f:
        assert f.read() == want
