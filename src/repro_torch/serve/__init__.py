"""repro_torch.serve — event-driven LM serving on the EDAT runtime, in PyTorch.

The port of ``repro.serve``: the PyTorch model stack (prefill / decode
steps, per-slot caches, the flash and SSD kernels on the card) driven
entirely by EDAT events (typed channels, persistent tasks, event-carried
backpressure).  See
:mod:`repro_torch.serve.program` for the channel contract and
:mod:`repro_torch.serve.engine` for the per-slot cache lifecycle.

::

    from repro_torch.serve import LoadSpec, run_serve

    out = run_serve(arch="gemma3-1b", clients=2, slots=4,
                    load=LoadSpec(rps=8, requests=32), device="cuda")
    print(out["summary"])       # requests/s, tokens/s, p50/p99 TTFT ...
"""
from .engine import (DEFAULT_MAX_LEN, SequentialEngine, ServeEngine,
                     resolve_device, serving_cfg)
from .loadgen import (LoadSpec, all_requests, client_schedule, percentile,
                      summarize)
from .baseline import run_sequential
from .program import (ADMIT, BACKPRESSURE, DECODE_TICK, REQUEST, RESPONSE,
                      ServeProgram, run_serve, serve_program)

__all__ = [
    "ServeProgram", "serve_program", "run_serve",
    "ServeEngine", "SequentialEngine", "serving_cfg", "DEFAULT_MAX_LEN",
    "resolve_device",
    "LoadSpec", "client_schedule", "all_requests", "summarize",
    "percentile", "run_sequential",
    "REQUEST", "ADMIT", "DECODE_TICK", "RESPONSE", "BACKPRESSURE",
]
