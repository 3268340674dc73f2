"""repro_torch.insights — turn runtime counters into actionable findings.

The runtime's always-on metrics (``Session.stats()``) say *what*
happened per channel, rank, and peer; this package says *why it was
slow* and *what to change* — the Drishti-style counters-to-
recommendations pipeline, specialised to the EDAT runtime's failure
modes.  The programmer fires events and is abstracted from the
mechanism (the paper's pitch), so when a channel backpressures or a
rank straggles the mechanism has to diagnose itself.

Usage::

    from repro_torch.insights import analyze, render

    with edat.Session(ranks=4, transport="socket") as s:
        s.run(program)
        for finding in analyze(s.stats()):
            print(finding)          # [backpressure] channel 'grad': ...

Rules (each reports the triggering numbers in its message):

* **backpressure** — a channel's delivered-but-unconsumed queue grew past
  ``backpressure_depth``: consumers are not keeping up with producers.
  Suggests raising ``max_batch_bytes`` / ``flush_interval`` (socket),
  adding ``workers_per_rank``, or throttling the producer.
* **scalar-spam** — many fires averaging a tiny payload: the per-event
  overhead dominates.  Suggests batching at the call site
  (``ctx.fire_batch`` or aggregating payloads).  A channel that trips
  this rule is skipped by the backpressure rule — the spam *is* the
  root cause of its queue depth.
* **straggler** — one rank owns a dominant share of the total quorum
  wait (time multi-dependency frames spent waiting for their last
  event, attributed to the rank that fired it).
* **chatty-no-coalesce** — coalescing was disabled while many events
  crossed sockets: every event paid a frame + syscall.
* **admission-backpressure** — a serving program fired on a
  ``backpressure`` channel: its admission queue exceeded the configured
  bound and clients were throttled.  Reported against the ``request``
  channel (the producer side that outran admission).  Suggests more
  decode slots, a lower offered rate, or a larger queue bound.
* **tasks-replayed** — the durable recovery coordinator re-fired a dead
  rank's unconsumed events (``Session(durable=True)``); one finding per
  (dead rank, channel) naming the replayed-event count.  Informational:
  the run *survived* a failure — verify results account for
  at-least-once delivery, and consider an elastic replacement
  (``Session.respawn``) if survivor load is a concern.

Machine-generated channels (``__``-prefixed eids) are exempt from the
per-channel rules.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping

__all__ = ["Finding", "analyze", "render"]


@dataclass
class Finding:
    """One rule match: which rule fired, an actionable message carrying
    the triggering numbers, and the raw numbers for programmatic use."""

    rule: str
    message: str
    data: Dict[str, Any] = field(default_factory=dict)

    def __str__(self) -> str:
        return f"[{self.rule}] {self.message}"


def analyze(stats: Mapping[str, Any], *,
            backpressure_depth: int = 512,
            spam_fires: int = 500,
            spam_bytes_per_fire: int = 16,
            straggler_share: float = 0.5,
            straggler_min_s: float = 0.05,
            chatty_wire_events: int = 1000) -> List[Finding]:
    """Pattern-match the run's counters into a list of findings.

    ``stats`` is a ``Session.stats()`` mapping (or any dict with the
    ``channels`` / ``ranks`` / ``transport`` sections produced by
    :func:`repro_torch.core.metrics.merge_metrics`).  Returns ``[]`` for a
    clean run — and for a run with metrics disabled, which has no
    counters to analyze.  Thresholds are keyword-tunable."""
    channels: Mapping[str, Mapping[str, int]] = stats.get("channels") or {}
    ranks: Mapping[Any, Mapping[str, Any]] = stats.get("ranks") or {}
    transport: Mapping[str, Any] = stats.get("transport") or {}
    findings: List[Finding] = []

    for eid in sorted(channels):
        if eid.startswith("__"):
            continue  # machine-generated / session-internal traffic
        ch = channels[eid]
        fires = ch.get("fires", 0)
        nbytes = ch.get("bytes", 0)
        qmax = ch.get("queued_max", 0)
        if fires >= spam_fires and nbytes <= fires * spam_bytes_per_fire:
            avg = nbytes / fires if fires else 0.0
            findings.append(Finding(
                "scalar-spam",
                f"channel {eid!r}: {fires} fires averaging {avg:.0f} B of "
                f"payload — per-event overhead dominates tiny payloads; "
                f"batch at the call site (ctx.fire_batch, or aggregate "
                f"values into one payload before firing)",
                {"eid": eid, "fires": fires, "bytes": nbytes,
                 "avg_bytes": avg}))
            # the spam is the root cause of any queue depth on this
            # channel: don't double-report it as backpressure
            continue
        if qmax >= backpressure_depth:
            if transport.get("kind") == "socket":
                hint = ("raise max_batch_bytes / flush_interval so the "
                        "writer drains larger batches, add "
                        "workers_per_rank, or throttle the producer")
            else:
                hint = "add workers_per_rank or throttle the producer"
            findings.append(Finding(
                "backpressure",
                f"channel {eid!r} backpressured: up to {qmax} events sat "
                f"delivered-but-unconsumed (fires={fires}, "
                f"deliveries={ch.get('deliveries', 0)}) — consumers are "
                f"not keeping up; {hint}",
                {"eid": eid, "queued_max": qmax, "fires": fires,
                 "deliveries": ch.get("deliveries", 0)}))

    bp = channels.get("backpressure") or {}
    bp_fires = bp.get("fires", 0)
    if bp_fires:
        req = channels.get("request") or {}
        findings.append(Finding(
            "admission-backpressure",
            f"channel 'request' outran admission: the server fired "
            f"{bp_fires} backpressure signal(s) because its admission "
            f"queue exceeded the configured bound "
            f"(requests fired={req.get('fires', 0)}, admission queue "
            f"peak={req.get('queued_max', 0)}) — clients were throttled; "
            f"add decode slots, lower the offered rate, or raise the "
            f"queue bound",
            {"eid": "request", "bp_fires": bp_fires,
             "request_fires": req.get("fires", 0),
             "queued_max": req.get("queued_max", 0)}))

    for rep in (stats.get("durable") or {}).get("replays") or ():
        eid = rep.get("channel")
        n = rep.get("events", 0)
        dead = rep.get("dead_rank")
        findings.append(Finding(
            "tasks-replayed",
            f"channel {eid!r}: {n} event(s) fired at dead rank {dead} "
            f"were replayed onto survivors by the durable recovery "
            f"coordinator — the run survived the failure; verify results "
            f"tolerate at-least-once delivery (dedup by an id in the "
            f"payload), and consider an elastic replacement "
            f"(Session.respawn) if survivor load is a concern",
            {"eid": eid, "events": n, "dead_rank": dead}))

    waits = {r: rk.get("quorum_wait_s", 0.0) for r, rk in ranks.items()}
    total_wait = sum(waits.values())
    if len(ranks) >= 3 and total_wait >= straggler_min_s:
        worst = max(waits, key=waits.get)  # type: ignore[arg-type]
        share = waits[worst] / total_wait
        if share >= straggler_share:
            findings.append(Finding(
                "straggler",
                f"rank {worst} is a straggler: {waits[worst]:.3f}s of the "
                f"{total_wait:.3f}s total quorum wait ({share:.0%}) was "
                f"spent waiting for its events to complete multi-"
                f"dependency frames — rebalance its work or overlap it "
                f"with more independent tasks",
                {"rank": worst, "wait_s": waits[worst],
                 "total_wait_s": total_wait, "share": share}))

    if (transport.get("kind") == "socket"
            and transport.get("coalesce") is False):
        n_wire = transport.get("wire_events_sent", 0)
        if n_wire >= chatty_wire_events:
            findings.append(Finding(
                "chatty-no-coalesce",
                f"{n_wire} events crossed sockets with coalescing "
                f"disabled — every event paid one frame + one syscall "
                f"({transport.get('writes', 0)} writes for "
                f"{transport.get('wire_bytes', 0)} B); enable "
                f"coalesce=True (the default) to pack many events per "
                f"syscall",
                {"wire_events_sent": n_wire,
                 "writes": transport.get("writes", 0),
                 "wire_bytes": transport.get("wire_bytes", 0)}))

    return findings


def render(findings: List[Finding]) -> str:
    """Markdown rendering of a findings list (``benchmarks/report.py``)."""
    if not findings:
        return "_no findings — the counters look healthy_\n"
    return "".join(f"- **{f.rule}** — {f.message}\n" for f in findings)
