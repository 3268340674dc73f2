"""The port's MONC in-situ analytics (``repro_torch.analytics``), its
``insights`` and ``configs/edat_paper.py`` against the reference's
(``repro.analytics``, ``repro.insights``, ``repro.configs.edat_paper``),
on the CPU.

Both packages draw the same fields from the same numpy seeds, so each run
is held to the host recompute of ``chip_smoke.insitu_host_totals`` by the
gate phase 44 applies on the card (``chip_smoke.insitu_gate``): result
counts equal, the totals as multisets with sums within 1e-12 x sum|x|,
sums of squares within 1e-12 x sum x^2, min and max terms bit-equal (the
bespoke baseline sums the ranks' partials in their order of arrival, so
its terms are held within 1e-12 x the sum of the ranks' |min| (|max|)).  The
port runs at ``device="cpu"``; the socket programs run as spawned OS
processes, one package after the other.
"""
import dataclasses
import importlib
import os
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
import chip_smoke                                            # noqa: E402
from repro_torch.analytics import insitu                     # noqa: E402

pytestmark = pytest.mark.timeout(300)

PKGS = ("repro", "repro_torch")
ROOT = os.path.dirname(os.path.dirname(__file__))
# heartbeats: spawned children import torch, which takes seconds, so a
# generous timeout keeps a loaded machine from declaring a live peer dead
HB = dict(hb_interval=0.2, hb_timeout=10.0)
RTOL = chip_smoke.INSITU_RTOL


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _port_kw(pkg):
    """The port's analytics take a device; the reference's do not."""
    return {"device": "cpu"} if pkg == "repro_torch" else {}


def _renamed(path):
    with open(os.path.join(ROOT, "src", "repro", path)) as f:
        return f.read().replace("repro.", "repro_torch.").replace(
            "from repro import", "from repro_torch import")


@pytest.mark.parametrize("path", ["configs/edat_paper.py",
                                  "insights/__init__.py"])
def test_copied_modules_differ_from_the_reference_only_by_the_rename(path):
    with open(os.path.join(ROOT, "src", "repro_torch", path)) as f:
        assert f.read() == _renamed(path)


def test_edat_paper_configs_equal():
    ref, port = (_mod(p, "configs.edat_paper") for p in PKGS)
    for table in ("BFS", "INSITU"):
        assert ({k: dataclasses.asdict(v)
                 for k, v in getattr(port, table).items()}
                == {k: dataclasses.asdict(v)
                    for k, v in getattr(ref, table).items()})


def test_analyse_matches_the_reference_arithmetic():
    """``_analyse`` on a float64 tensor: the reference's four values, on
    the tensor's device, counted by device type."""
    from repro.analytics.insitu import _analyse as ref_analyse
    x = np.random.default_rng(5).standard_normal(4096)
    insitu.reset_counts()
    got = insitu._analyse(torch.from_numpy(x))
    want = ref_analyse(x)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert insitu.calls_by_device == {"cpu": 1}
    got = got.numpy()
    assert abs(got[0] - want[0]) <= RTOL * np.abs(x).sum()
    assert abs(got[1] - want[1]) <= RTOL * (x * x).sum()
    assert np.array_equal(got[2:], want[2:])
    insitu.reset_counts()
    assert insitu.calls_by_device == {}


@pytest.mark.parametrize("n_fields", [1, 2, 4])
@pytest.mark.parametrize("n_analytics", [1, 2, 3])
@pytest.mark.parametrize("program", ["EdatAnalytics", "BespokeAnalytics"])
def test_inproc_totals_match_the_reference(program, n_analytics, n_fields):
    """Both packages reduce every (field, timestep) once, and their totals
    pass phase 44's gate against the host recompute, which rejects both
    planted faults.  n_analytics 3 leaves a rank rooting fewer
    reductions."""
    cfg_kw = dict(n_analytics=n_analytics, items_per_producer=16,
                  field_elems=64, n_fields=n_fields)
    bespoke = program == "BespokeAnalytics"
    counts = {}
    for pkg in PKGS:
        an = _mod(pkg, "analytics")
        cfg = an.InsituCfg(**cfg_kw)
        insitu.reset_counts()
        prog = getattr(an, program)(cfg, 4, **_port_kw(pkg))
        res = prog.run()
        counts[pkg] = res["results"]
        got = [total for total, _ in prog.results]
        gates = {k: chip_smoke.insitu_gate(got, want, any_order=bespoke)
                 for k, want in
                 chip_smoke.insitu_host_totals(cfg, bespoke).items()}
        assert gates["control"]["ok"], (pkg, gates["control"])
        for fault in chip_smoke.INSITU_FAULTS:
            assert not gates[fault]["ok"], (pkg, fault, gates[fault])
        if pkg == "repro_torch":
            calls = {"cpu": n_analytics * cfg.items_per_producer}
            assert insitu.calls_by_device == calls
            if not bespoke:
                assert prog.summary["calls_by_device"] == calls
    assert counts["repro_torch"] == counts["repro"] == 16


def _socket_insitu(pkg):
    edat = _mod(pkg, "edat")
    an = _mod(pkg, "analytics")
    cfg = an.InsituCfg(n_analytics=2, items_per_producer=16,
                       field_elems=128, n_fields=2)
    args = (4, "cpu") if pkg == "repro_torch" else ()
    with edat.Session(2 * cfg.n_analytics, transport="socket", procs=2,
                      timeout=180, workers_per_rank=4, **HB) as s:
        s.run(edat.deferred(an.insitu_program, dataclasses.asdict(cfg),
                            *args))
        summary, stats = s.gather(), s.stats
    assert stats["transport"]["wire_events_sent"] > 0
    if pkg == "repro_torch":
        # the children's own tally and totals, as phase 44 gates them
        assert summary["calls_by_device"] == {
            "cpu": cfg.n_analytics * cfg.items_per_producer}
        gates = {k: chip_smoke.insitu_gate(summary["totals"], want)
                 for k, want in chip_smoke.insitu_host_totals(cfg).items()}
        assert gates["control"]["ok"], gates["control"]
        for fault in chip_smoke.INSITU_FAULTS:
            assert not gates[fault]["ok"], (fault, gates[fault])
    return summary["results"]


def test_socket_program_matches_the_reference():
    insitu.reset_counts()
    got = {pkg: _socket_insitu(pkg) for pkg in PKGS}
    assert got["repro_torch"] == got["repro"] == 16
    # the arithmetic ran in the spawned children, not here
    assert insitu.calls_by_device == {}


def test_distributed_insitu_warns_once_on_both():
    for pkg in PKGS:
        an = _mod(pkg, "analytics")
        cfg = an.InsituCfg(n_analytics=1, items_per_producer=8,
                           field_elems=64, n_fields=2)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):
                res = an.distributed_insitu(cfg, **_port_kw(pkg), **HB)
        assert [str(w.message) for w in caught
                if issubclass(w.category, DeprecationWarning)
                and "distributed_insitu" in str(w.message)] == [
            "distributed_insitu is deprecated: use edat.run(edat.deferred("
            "insitu_program, ...), ranks=2*n, transport='socket')"], pkg
        assert res["results"] == res["raw_items"] == 8


@pytest.mark.parametrize("program", ["EdatAnalytics", "BespokeAnalytics"])
def test_analytics_without_a_card_raise(program, monkeypatch):
    """No device means the card; without one the run raises and nothing
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    an = _mod("repro_torch", "analytics")
    insitu.reset_counts()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(an, program)(an.InsituCfg()).run()
    assert insitu.calls_by_device == {}


# every rule of the reference's insights fires on this dict
STATS = {
    "channels": {
        "tick": {"fires": 1000, "bytes": 8000, "deliveries": 1000,
                 "queued_max": 900},
        "field": {"fires": 40, "bytes": 1 << 20, "deliveries": 40,
                  "queued_max": 600},
        "backpressure": {"fires": 3, "bytes": 120, "deliveries": 3},
        "request": {"fires": 40, "bytes": 9000, "queued_max": 11},
        "__sess.result": {"fires": 10_000, "bytes": 0, "queued_max": 9999},
    },
    "ranks": {0: {"quorum_wait_s": 0.05}, 1: {"quorum_wait_s": 0.05},
              2: {"quorum_wait_s": 0.5}},
    "transport": {"kind": "socket", "coalesce": False,
                  "wire_events_sent": 5000, "writes": 5000,
                  "wire_bytes": 1 << 22},
    "durable": {"replays": [{"channel": "field", "events": 7,
                             "dead_rank": 1}]},
}


def _findings(pkg, stats):
    ins = _mod(pkg, "insights")
    found = ins.analyze(stats)
    return ([(f.rule, f.message, f.data) for f in found],
            ins.render(found))


def test_insights_equal_on_both():
    ref, port = (_findings(p, STATS) for p in PKGS)
    assert port == ref
    assert {rule for rule, _, _ in port[0]} == {
        "scalar-spam", "backpressure", "admission-backpressure",
        "tasks-replayed", "straggler", "chatty-no-coalesce"}


def test_insights_equal_on_a_recorded_analytics_run():
    """The stats of one in-proc run of the port's EDAT program, analysed
    by both packages."""
    an = _mod("repro_torch", "analytics")
    prog = an.EdatAnalytics(an.InsituCfg(n_analytics=3,
                                         items_per_producer=16,
                                         field_elems=64), device="cpu")
    prog.run()
    assert prog.stats["channels"]["field"]["fires"] == 48
    assert _findings("repro_torch", prog.stats) == _findings("repro",
                                                             prog.stats)
