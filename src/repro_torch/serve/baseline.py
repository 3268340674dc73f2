"""The naive sequential serving baseline the benchmark compares against.

One request at a time, batch of one, prefill then decode to completion —
the same steps and the same greedy argmax as the event-driven
server (so tokens match token-for-token), but no continuous batching, no
prefill/decode overlap, no admission control.  Arrivals are replayed in
real time from the same open-loop schedule, so queueing delay under
overload shows up in the baseline's latency numbers exactly as it does
for the event-driven server.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

from .engine import DEFAULT_MAX_LEN, SequentialEngine, serving_cfg


def run_sequential(cfg, requests: Sequence[Mapping[str, Any]], *,
                   max_len: int = DEFAULT_MAX_LEN,
                   seed: int = 0,
                   realtime: bool = True,
                   device=None,
                   params: Optional[Dict[str, Any]] = None
                   ) -> List[Dict[str, Any]]:
    """Serve ``requests`` (a :func:`~repro_torch.serve.loadgen.all_requests`
    list, sorted by arrival offset ``t``) strictly one at a time.
    Returns records in the same schema the event-driven server produces,
    so :func:`~repro_torch.serve.loadgen.summarize` applies to both.

    ``realtime=False`` skips the arrival sleeps (tests that only care
    about tokens, not latency).  ``device``/``params`` as for
    :class:`~repro_torch.serve.engine.ServeEngine`."""
    eng = SequentialEngine(serving_cfg(cfg, max_len), max_len=max_len,
                           seed=seed, device=device, params=params)
    eng.warmup(sorted({len(r["prompt"]) for r in requests}))
    records: List[Dict[str, Any]] = []
    t0 = time.monotonic()
    for req in requests:
        target = t0 + req["t"]
        if realtime:
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        tokens, t_first, t_done = eng.serve_one(req["prompt"],
                                                req["max_new"])
        records.append({
            "id": req["id"], "client": req.get("client", -1),
            "prompt_len": len(req["prompt"]), "tokens": tokens,
            "n_out": len(tokens), "t_sched": target, "t_send": target,
            "t_recv": target, "t_admit": target, "t_first": t_first,
            "t_done": t_done, "throttled_s": 0.0,
        })
    return records
