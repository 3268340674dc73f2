"""Open-loop synthetic load for the serving subsystem.

The generator is *open-loop*: request arrival times are drawn up front
from a Poisson process at the configured aggregate rate, and a client
fires each request at its scheduled instant regardless of how many
responses have come back.  Under overload the arrival schedule does not
slow down to match the server — queueing delay shows up in the measured
latency instead of being silently absorbed by a closed feedback loop,
which is the honest way to measure a saturated server (cf. the
coordinated-omission literature).

Everything is deterministic per ``(spec.seed, client)``: a benchmark can
hand the *same* schedule to the event-driven server and to the
sequential baseline, and a test can regenerate the exact request list a
spawned client fired.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """Knobs of the synthetic workload.

    ``rps`` is the *aggregate* arrival rate across all clients; each of
    ``n`` clients runs an independent Poisson process at ``rps / n``
    (the superposition of independent Poisson processes is Poisson at
    the summed rate, so the offered load is exactly ``rps``).

    Prompt lengths are drawn from the discrete ``prompt_lens`` buckets
    (weighted by ``prompt_weights`` when given) rather than a continuous
    distribution: in the JAX reference every distinct prompt length is a
    fresh XLA compilation of the prefill step, so a handful of buckets
    keeps the compile-cache small while still exercising mixed-length
    admission; the port keeps the buckets so both see the same load.
    Output lengths are uniform ints in ``[max_new_lo, max_new_hi]``.
    """

    rps: float = 8.0
    requests: int = 16                    # total across all clients
    prompt_lens: Tuple[int, ...] = (4, 8, 16)
    prompt_weights: Optional[Tuple[float, ...]] = None
    max_new_lo: int = 4
    max_new_hi: int = 16
    seed: int = 0

    def split(self, n_clients: int) -> List[int]:
        """Per-client request counts (first clients absorb the remainder)."""
        base, rem = divmod(self.requests, n_clients)
        return [base + (1 if c < rem else 0) for c in range(n_clients)]


def client_schedule(spec: LoadSpec, client: int, n_clients: int,
                    vocab: int) -> List[Dict[str, Any]]:
    """The full request list for one client: ``[{id, t, prompt, max_new}]``
    with ``t`` the arrival offset (seconds from load start), sorted.

    Request ids are globally unique (``client * 1_000_000 + i``) so the
    server can attribute records without coordination.
    """
    n = spec.split(n_clients)[client]
    rng = np.random.default_rng((spec.seed, client))
    rate = spec.rps / n_clients
    gaps = rng.exponential(1.0 / rate, size=n) if rate > 0 else np.zeros(n)
    times = np.cumsum(gaps)
    if spec.prompt_weights is not None:
        w = np.asarray(spec.prompt_weights, np.float64)
        w = w / w.sum()
    else:
        w = None
    out = []
    for i in range(n):
        plen = int(rng.choice(spec.prompt_lens, p=w))
        out.append({
            "id": client * 1_000_000 + i,
            "t": float(times[i]),
            "prompt": rng.integers(0, vocab, size=plen).tolist(),
            "max_new": int(rng.integers(spec.max_new_lo,
                                        spec.max_new_hi + 1)),
        })
    return out


def all_requests(spec: LoadSpec, n_clients: int,
                 vocab: int) -> List[Dict[str, Any]]:
    """Every client's schedule merged and sorted by arrival time — the
    exact offered load, for driving the sequential baseline."""
    reqs: List[Dict[str, Any]] = []
    for c in range(n_clients):
        reqs.extend(client_schedule(spec, c, n_clients, vocab))
    reqs.sort(key=lambda r: r["t"])
    return reqs


# ------------------------------------------------------------------ summaries
def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 for an empty input."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return float(s[k])


def summarize(records: Sequence[Mapping[str, Any]],
              wall_s: float) -> Dict[str, Any]:
    """Roll per-request server records into the benchmark's headline
    numbers: requests/s, tokens/s, p50/p99 time-to-first-token and
    per-token decode latency.

    Latencies are measured from ``t_sched`` — the instant the open-loop
    schedule *wanted* to fire the request — not from the actual fire
    time, so client-side throttling (backpressure) and queueing both
    show up in TTFT instead of being hidden.
    """
    ttft = [r["t_first"] - r["t_sched"] for r in records]
    per_tok = [(r["t_done"] - r["t_first"]) / (r["n_out"] - 1)
               for r in records if r["n_out"] > 1]
    n_tokens = sum(r["n_out"] for r in records)
    wall = max(wall_s, 1e-9)
    return {
        "requests": len(records),
        "tokens": n_tokens,
        "wall_s": wall_s,
        "requests_per_s": len(records) / wall,
        "tokens_per_s": n_tokens / wall,
        "ttft_p50_ms": percentile(ttft, 50) * 1e3,
        "ttft_p99_ms": percentile(ttft, 99) * 1e3,
        "per_token_p50_ms": percentile(per_tok, 50) * 1e3,
        "per_token_p99_ms": percentile(per_tok, 99) * 1e3,
    }
