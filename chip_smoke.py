#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with the card and the CUDA
toolkit::

    python3 chip_smoke.py              # all phases
    python3 chip_smoke.py --phases 1,2,3 --json out/smoke.json

It drives the port only (no jax, nothing of ``repro``), in phases that each
raise on failure.  Five main paths are driven, each at full width and
depth: serving gemma3-1b (flash attention), mamba2-370m (the SSD scan),
recurrentgemma-9b (the RG-LRU recurrence and flash attention on its local
layers) and granite-moe-1b-a400m (flash attention at 16 heads, 8 KV heads
of 64, and the MoE layer), and training gemma3-1b (flash attention in
every forward):

1. environment: the card's name and power limit, torch and CUDA versions;
   TF32 off for float32 products;
2. build: every CUDA kernel from the sources in the checkout, all ``nvcc``
   at once, with each kernel's registers and spills and both SSD kernels'
   shared memory; the tensor-core SSD kernel and the RG-LRU kernels must
   not spill;
3. the flash kernel against its plain PyTorch version on the card, on the
   reference's test cases, ragged tails and the serving paths' shapes
   (gemma3-1b's, recurrentgemma-9b's, the training forward's and
   granite-moe-1b-a400m's), with CUDA-event times of the
   kernel, the plain version and one PyTorch library call computing the
   same function (a yardstick only);
4. gemma3-1b with seeded random weights: prefill through the kernel
   against prefill through plain attention, float32 (gated) and bfloat16
   (reported);
5. gemma3-1b's main path: event-driven serving in bf16 through
   ``run_serve`` on the port's EDAT runtime, with every kernel's launch
   count set to 0 just before it and read just after;
6. float32 serving of gemma3-1b against the sequential baseline, token for
   token;
7. where gemma3-1b's serving time goes: one bf16 prefill and one 4-slot
   decode step, the device's kernel time (``torch.profiler``) against the
   host clock;
8. the SSD kernels against their plain version on the card: the
   reference's test cases, ragged tails, a nonzero initial state (final
   state compared too) and the serving path's shapes, each row with the
   variant it launched (the bf16 tensor-core kernel on the serving path's
   shapes, the SIMT kernel for float32), timed as in phase 3 beside the
   SIMT kernel on the same inputs (no single PyTorch call computes this
   function, so it has no library time); the same check must reject
   faults planted in the plain scan;
9. mamba2-370m: prefill through the SSD kernel against prefill through the
   plain scan, float32 (gated, with the reference's init and again with
   Mamba-2's init of a_log and dt_bias) and bfloat16 (reported); the
   float32 gate must reject faults planted in the plain scan;
10. mamba2-370m's main path: event-driven serving in bf16, counted as in
    phase 5, every SSD launch the tensor-core variant;
11. float32 serving of mamba2-370m against the sequential baseline;
12. where mamba2-370m's serving time goes, as in phase 7, with its SSD
    launches by variant;
13. the RG-LRU kernel against its plain version on the card: the
    reference's test cases, ragged T, a nonzero initial state (final state
    compared too), the serving path's shapes and T = 1100 (five spans of
    the segmented scan) timed as in phase 3 (no single PyTorch call
    computes it), each row with the launch shape and segment length it
    ran, and long-memory cases (Griffin's init of lam); the same check must
    reject faults planted in the plain scan, one dropped carry included;
14. recurrentgemma-9b: prefill through the kernels against prefill through
    the plain versions, bfloat16 at the port's init (reported) and float32
    (gated, with stacked leaves at one layer's fan-in and again with
    Griffin's init of lam on top, with faults planted in the plain scan),
    one parameter tree shared by both models;
15. recurrentgemma-9b's main path: event-driven serving in bf16, counted as
    in phase 5;
16. float32 serving of recurrentgemma-9b against the sequential baseline;
17. where recurrentgemma-9b's serving time goes, as in phase 7, with the
    cost of casting its float32 gate matrices at every decode step;
18. gemma3-1b served over the socket transport, one spawned OS process a
    rank (``run_serve(transport="socket", procs=3)``): the checks of phase
    5 on the kernel counts that the server's own process returns, with the
    session's wall time split and the wire's counters; float32 tokens
    against phase 6's in-proc tokens; client processes that never open
    the card; and a client process SIGKILLed mid-load, after which
    the server drains cleanly;
19. gemma3-1b trained by the event-driven trainer
    (``EventDrivenTrainer.run``, in-proc, 2 ranks, AdamW, bf16, 4 steps of
    2 sequences of 512 a rank): the flash kernel's launches (26 a forward),
    no plain call, the backward's plain recomputes (26 a backward), finite
    losses, bit-equal replicas; one step split into forward and backward,
    the grads' copy to the host, the quorum reduce, the copy back and the
    update (host clock), the forward and backward under the profiler,
    peak device memory and peak RSS; then float32 runs, the kernel path
    against the plain path (loss history and weights), with a fault
    planted in the plain path and one that skips the grad average, each of
    which the gate must reject;
20. granite-moe-1b-a400m: prefill through the kernel against prefill
    through plain attention, the plain path's routers held to the kernel
    path's expert choices (the tokens whose own top-8 differs counted),
    bf16 and float32 at the port's init (reported: there float32
    rounding alone decides the routers' top-8, as the plain path's own
    float32 floor shows) and float32 with every matrix at the fan-in of
    the dims it contracts (gated), then one 4-slot decode step from four
    such prefills' caches, the same check; each call's dropped router
    assignments printed;
21. granite-moe-1b-a400m's main path: event-driven serving in bf16,
    counted as in phase 5;
22. float32 serving of granite-moe-1b-a400m (phase 20's gated weights),
    gated by replay: the served run records its engine calls (prefill,
    attach, step) with the tokens each returned, and a plain-attention
    engine with the same weights replays them fed the served tokens, so
    every step sees the served batch (a capacity-limited MoE's output
    depends on the batch, so served tokens need not equal the sequential
    baseline's); every token must equal the replay's or differ at a top-2
    gap under NEAR_TIE, and the gate must reject faults planted in the
    replay's MoE (top-k weights not renormalised, capacity ignored); the
    sequential baseline's differences and the decode steps that dropped
    an assignment are reported;
23. where granite-moe-1b-a400m's serving time goes, as in phase 7, with
    the MoE steps' (route, dispatch, experts, combine) share of device
    time.

Every phase starts with the card's memory freed and prints its peak
(``torch.cuda.max_memory_allocated``).

It prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` as
its last line; ``--json PATH`` also writes every number to PATH.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

FA_SOURCE = "src/repro_torch/csrc/flash_attention_fwd.cu"
FA_REPLACES = "src/repro/kernels/flash_attention/kernel.py:86"
# (S, H, KH, D, window, softcap, dtype): the reference's FA_CASES
# (tests/test_kernels.py), then ragged tails the TPU kernel does not take
FA_CASES = [
    (256, 4, 4, 64, None, None, "float32"),
    (256, 4, 1, 64, None, None, "float32"),
    (512, 8, 2, 64, None, None, "bfloat16"),
    (512, 4, 4, 128, 128, None, "float32"),
    (256, 4, 2, 128, None, 50.0, "float32"),
    (384, 6, 6, 64, None, None, "float32"),
    (512, 2, 1, 256, 256, None, "bfloat16"),
    (100, 4, 2, 32, None, None, "float32"),
    (300, 4, 2, 32, None, None, "float32"),
]
# the serving path's shapes: gemma3-1b prefill, B=1, 4 heads, 1 KV head,
# head dim 256, bf16; local layers window 512, global layers none; given in
# the model's (B, S, H, D) layout as the path gives them
PATH_S = (100, 256, 384, 511)
PATH_WINDOWS = (512, None)
TIMED = (511, 512)        # the shape whose times stand in the kernels line
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

SSD_SOURCE = "src/repro_torch/csrc/ssd_fwd.cu"
SSD_REPLACES = "src/repro/kernels/ssd/kernel.py:68"
# (B, T, H, G, N, P, chunk, dtype, init_state): the reference's SSD_CASES
# (tests/test_kernels.py), ragged tails and nonzero initial states the TPU
# kernel does not take
SSD_CASES = [
    (2, 256, 4, 1, 32, 32, 64, "float32", False),
    (2, 256, 8, 2, 64, 64, 128, "float32", False),
    (2, 128, 2, 2, 16, 64, 32, "float32", False),
    (2, 256, 4, 1, 128, 64, 128, "bfloat16", False),
    (2, 100, 4, 2, 32, 32, 128, "float32", True),
    (2, 300, 4, 2, 32, 32, 128, "float32", True),
    (2, 300, 8, 1, 128, 64, 128, "bfloat16", True),
]
# the serving path's shapes: mamba2-370m prefill, B=1, 32 heads of 64, one
# group, state 128, chunk 128, bf16 x/b/c as views of the conv output, and
# an initial state (prefill passes the cache's, zeros on a fresh cache;
# here a random one)
SSD_PATH_T = (100, 256, 384, 511)
SSD_TIMED_T = 511
# |kernel - plain| <= SSD_TOL * max|plain| in every case, bf16 inputs too:
# both read the same values (bf16 widens to float32 exactly) and both
# compute in float32, so no bf16 rounding separates them; float32 sums of a
# chunk of products cancel in places, so their rounding scales with the
# output's largest magnitude
SSD_TOL = 1e-4
# the device function of each SSD kernel variant, as the profiler names it
# (neither name holds the other)
SSD_ENTRY = {"mma_bf16": "ssd_mma_bf16_kernel", "simt": "ssd_fwd_kernel"}

GEMMA, MAMBA, RGEMMA = "gemma3-1b", "mamba2-370m", "recurrentgemma-9b"
# the kernel each kind of layer launches once a prefill
KIND_KERNEL = {"attn": "flash_attention_fwd", "local": "flash_attention_fwd",
               "ssd": "ssd_fwd", "rglru": "rglru_fwd"}
MAX_LEN = 512             # = gemma3-1b's window: no prompt outgrows a cache
PREFILL_S = (100, 256, 511)
LOGIT_TOL = 1e-3          # float32 kernel path vs plain path, last logits
FLOOR_FACTOR = 4          # ... or this many plain-path noise floors (SSD)
# faults planted in the plain SSD scan, run chunk by chunk: the c.S_prev
# term between chunks dropped, the state carried between chunks in bf16,
# x/b/c read as bf16; and the control, the same chunk-by-chunk run with no
# fault.  Each check must pass the control and reject the faults named
# here: phase 8's kernel check (bf16 inputs already) the first two; phase
# 9's float32 logit gate bf16 inputs, and with Mamba-2's init (below) the
# dropped term too.  The reference's init forgets within a few steps, so
# no logit gate sees a fault between chunks there; a bf16 state moves the
# logits too little for one at either init.  Phase 9 reports the rest.
SSD_CONTROL = "chunkwise"
SSD_FAULTS = ("no_inter_chunk", "bf16_state", "bf16_inputs")
KERNEL_FAULTS = ("no_inter_chunk", "bf16_state")
LOGIT_FAULTS = {"seeded": ("bf16_inputs",),
                "mamba2_init": ("no_inter_chunk", "bf16_inputs")}
# phase 8's long-memory case: dt = softplus(randn + DT_SHIFT), ~0.02, so
# the state carries across chunks; phase 9's second float32 weight set
# draws a_log and dt_bias as Mamba-2's published init does (A uniform in
# [1, 16], dt log-uniform in [1e-3, 1e-1]) for the same reason
DT_SHIFT = -4.0
NEAR_TIE = 1e-3           # a differing token is a near-tie below this gap

# the serving path's flash shapes on recurrentgemma-9b's 12 local layers:
# B=1, 16 heads, 1 KV head, head dim 256, window 2048, bf16
RG_FA_SHAPE = dict(H=16, KH=1, D=256, window=2048)

GRANITE = "granite-moe-1b-a400m"
# the serving path's flash shapes on granite-moe-1b-a400m's 24 global
# layers: B=1, 16 heads, 8 KV heads (GQA group 2), head dim 64, bf16
GRANITE_FA_SHAPE = dict(H=16, KH=8, D=64, window=None)
# phase 20's 4-slot decode step runs from the caches of prefills of these
# lengths (the last reaches position 511 of MAX_LEN)
DECODE_S = (100, 256, 384, 511)
# faults planted in phase 22's replay engine (its MoE layers): the top-k
# weights left unnormalised, and the capacity ignored (C = T: nothing
# dropped); the gate must reject both and pass the fault-free control
MOE_FAULTS = ("unnormalised_weights", "no_capacity")

RG_SOURCE = "src/repro_torch/csrc/rglru_fwd.cu"
RG_REPLACES = "src/repro/kernels/rglru/kernel.py:59"
# (B, T, W, h0, lam): the reference's RG_CASES (tests/test_kernels.py, drawn
# at B=2: x normal, r and i sigmoids of normals, lam = |normal| + 0.2), then
# ragged T with an initial state, which the TPU kernel does not take
RG_CASES = [(2, 128, 128, False, "test"), (2, 256, 256, False, "test"),
            (2, 128, 512, False, "test"), (2, 512, 128, False, "test"),
            (2, 1, 256, True, "test"), (2, 39, 256, True, "test"),
            (2, 100, 256, True, "test")]
# the serving path's shapes: recurrentgemma-9b prefill, B=1, width 4096,
# float32 x/r/i, an initial state (prefill passes the cache's); and
# RG_LONG_T, past max_len, where the kernel's blocks walk five spans
RG_PATH_T = (100, 256, 384, 511)
RG_TIMED_T = 511
RG_LONG_T = 1100
# |kernel - plain| <= RG_TOL * (1 + |plain|): the reference's rtol = atol
RG_TOL = 2e-4
# faults planted in the plain RG-LRU scan: h rounded to bf16 at every step,
# h0 ignored, the carry reset every RG_PIECE steps, the carry dropped once
# at the kernel's first span boundary (reset_once, where T is past it); the
# control runs the scan in pieces of RG_PIECE steps carrying h, with no
# fault.  Phase 13's check must pass the control and reject every fault at
# T = RG_TIMED_T and RG_LONG_T; phase 14's float32 logit gate must pass the
# control and reject the faults named in RG_LOGIT_FAULTS (prefill starts
# from h0 = 0, so no_h0 does not apply there, and no prefill is past a span)
RG_PIECE = 128
RG_CONTROL = "pieces"
RG_FAULTS = ("bf16_carry", "no_h0", "reset_128", "reset_once")
RG_LOGIT_FAULTS = ("bf16_carry", "reset_128")
# phase 14 runs recurrentgemma-9b at the port's init in bf16 only,
# reported: that init (the reference's rule: a stacked leaf's fan-in is its
# layers axis) saturates the gates, and where r ~ 0 the scan's
# 1 - exp(2 log_a) is a few ulps, so float32 rounding alone moves the
# logits by O(1) through 38 layers.  Its float32 sets are "layer_fan_in"
# (the same draw with every stacked leaf scaled to one layer's fan-in) and
# Griffin's lam on top of it, each gated at LOGIT_TOL
# phase 13's long-memory case and phase 14's second float32 weight set draw
# lam as Griffin's init does (arXiv:2402.19427): a = exp(-8 softplus(lam))
# uniform in [0.9, 0.999], so the state carries across pieces
GRIFFIN_A = (0.9, 0.999)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn`` on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def kernel_device_ms(fn, entry, event_ms=None, iters=20, warmup=3,
                     lead=10, tries=3):
    """Mean device milliseconds of one launch of the kernel whose name
    holds ``entry`` (``fn`` launches it once a call), and how many of the
    window's launches the profiler recorded, from
    ``torch.profiler``'s device events: the kernel's own time, without the
    host's time between launches (which CUDA events around back-to-back
    calls include when a call's host work outlasts its kernel).  The
    profiler can miss the first launches of a window, so each window
    opens with ``lead`` launches that are not counted, and the mean is over
    the last ``iters`` launches it recorded; a window that recorded fewer
    than ``iters`` is profiled again, up to ``tries`` times.  With
    ``event_ms`` (``cuda_ms`` of the same calls) a window whose device time
    is under half of it is flagged in a printed line: there the host's work
    between launches, not the kernel, set the event time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    counts = []
    for _ in range(tries):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(lead + iters):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA and entry in e.name)
        counts.append(len(spans))
        if iters <= len(spans) <= lead + iters:
            ms = sum(t1 - t0 for t0, t1 in spans[-iters:]) / 1e3 / iters
            if event_ms is not None and ms < event_ms / 2:
                log(f"kernel_device_ms FLAG {entry}: device {ms:.5f} ms is "
                    f"under half the event time {event_ms:.5f} ms (the "
                    f"host's work between launches set the event time)")
            return ms, len(spans)
    raise AssertionError(f"profiled {counts} launches of {entry} in "
                         f"windows of {lead + iters} calls, not {iters} or "
                         f"more")


def fa_bound(B, H, KH, S, D, window, dtype):
    """Least time for one causal attention call: each input read once and
    the output written once over the memory rate, against the products
    over the live (q, k) pairs over the peak rate of the dtype."""
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * B * H * S * D + 2 * B * KH * S * D) * elem
    w = window or S
    pairs = sum(min(i + 1, w) for i in range(S))
    flops = 4 * B * H * pairs * D          # q.k and p.v, 2 flops a MAC
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ------------------------------------------------------------------ phases
def phase_env(out):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: " + smi.stderr.strip()
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["card"] = card
    out["torch"] = torch.__version__
    out["cuda"] = torch.version.cuda


def _ptxas_summary(text):
    """(kernel, registers, spill bytes) per compiled entry of a build log."""
    import re
    rows, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append({"entry": name, "registers": int(m.group(1)),
                         "spill_store_bytes": spills})
            name = None
    return rows


def phase_build(out):
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import ops as ssd_ops
    secs = _build.build_all()
    for name, text in _build.build_log.items():
        log(f"-- nvcc {name}.cu\n{text.strip()}")
    log(f"build: {secs:.1f} s for {list(_build.SOURCES)}")
    ptxas = {n: _ptxas_summary(t) for n, t in _build.build_log.items()}
    smem = {v: ssd_ops.smem_bytes(128, 64, 128, kernel=v)
            for v in ssd_ops.VARIANTS}
    log("ssd_fwd ptxas " + json.dumps({
        "kernels": ptxas.get("ssd_fwd"),
        "dynamic_smem_bytes_at_N128_P64_chunk128": smem}))
    log("rglru_fwd ptxas " + json.dumps({"kernels": ptxas.get("rglru_fwd")}))
    out["build_s"] = secs
    out["ptxas"] = ptxas
    out["ssd_smem_bytes"] = smem
    mma = [r for r in ptxas.get("ssd_fwd") or []
           if SSD_ENTRY["mma_bf16"] in r["entry"]]
    if ptxas.get("ssd_fwd") is not None and (
            len(mma) != 1 or mma[0]["spill_store_bytes"]):
        raise AssertionError(f"the tensor-core SSD kernel is missing from "
                             f"the build log or spills: {mma}")
    rg = ptxas.get("rglru_fwd")
    if rg is not None and (not rg or any(r["spill_store_bytes"]
                                         for r in rg)):
        raise AssertionError(f"an RG-LRU kernel is missing from the build "
                             f"log or spills: {rg}")


def _fa_inputs(S, H, KH, D, dtype, B, seed, model_layout):
    """q, k, v as (B, H, S, D): contiguous, or (``model_layout``) as the
    serving path hands them over, transposed views of (B, S, H, D)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    if model_layout:
        return [torch.randn((B, S, h, D), generator=g, device="cuda").to(dt)
                .transpose(1, 2) for h in (H, KH, KH)]
    return [torch.randn((B, h, S, D), generator=g, device="cuda").to(dt)
            for h in (H, KH, KH)]


def _sdpa(q, k, v, *, scale, window):
    """``scaled_dot_product_attention`` with an explicit causal/window
    mask: the library yardstick, timed here and used nowhere in the port."""
    import torch
    import torch.nn.functional as F
    S = q.shape[2]
    i = torch.arange(S, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window is not None:
        mask &= (i[:, None] - i[None, :]) < window
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)


def phase_kernels(out):
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    cases = [dict(S=S, H=H, KH=KH, D=D, window=w, softcap=c, dtype=dt, B=2)
             for (S, H, KH, D, w, c, dt) in FA_CASES]
    cases += [dict(S=S, H=4, KH=1, D=256, window=w, softcap=None,
                   dtype="bfloat16", B=1, path=GEMMA)
              for S in PATH_S for w in PATH_WINDOWS]
    cases += [dict(S=S, softcap=None, dtype="bfloat16", B=1, path=RGEMMA,
                   **RG_FA_SHAPE) for S in PATH_S]
    cases += [dict(S=S, softcap=None, dtype="bfloat16", B=1, path=GRANITE,
                   **GRANITE_FA_SHAPE) for S in PATH_S]
    # the training forward's calls (phase 19): each rank's 2 x 512 tokens
    cases += [dict(S=TRAIN_DATA["seq"], H=4, KH=1, D=256, window=w,
                   softcap=None, dtype="bfloat16",
                   B=TRAIN_DATA["global_batch"] // TRAIN_RANKS,
                   path=f"{GEMMA}-train") for w in PATH_WINDOWS]
    rows = []
    for n, c in enumerate(cases):
        q, k, v = _fa_inputs(c["S"], c["H"], c["KH"], c["D"], c["dtype"],
                             c["B"], seed=n, model_layout=c.get("path",
                                                                False))
        kw = dict(scale=c["D"] ** -0.5, causal=True, window=c["window"],
                  softcap=c["softcap"])
        got = ops.flash_attention_fwd(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = TOL[c["dtype"]]
        ok = bool((err <= tol + tol * want.float().abs()).all())
        row = {k2: c[k2] for k2 in ("B", "S", "H", "KH", "D", "window",
                                    "softcap", "dtype")}
        row.update(max_abs_err=float(err.max()), tol=tol, ok=ok,
                   path=c.get("path", False))   # False, or the path's arch
        if row["path"]:
            row["ms"] = cuda_ms(lambda: ops.flash_attention_fwd(q, k, v,
                                                                **kw))
            (row["device_ms"],
             row["device_launches_recorded"]) = kernel_device_ms(
                lambda: ops.flash_attention_fwd(q, k, v, **kw), "fwd_kernel",
                event_ms=row["ms"])
            row["plain_ms"] = cuda_ms(lambda: ref.attention_ref(q, k, v,
                                                                **kw))
            row["library_ms"] = cuda_ms(_sdpa(q, k, v, scale=kw["scale"],
                                              window=c["window"]))
            row.update(fa_bound(c["B"], c["H"], c["KH"], c["S"], c["D"],
                                c["window"], c["dtype"]))
        log("flash_attention_fwd " + json.dumps(row))
        rows.append(row)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with plain version: {bad}")
    out["flash_attention_cases"] = rows


def _all_ops():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru import ops as rglru
    from repro_torch.kernels.ssd import ops as ssd
    return {"flash_attention_fwd": fa, "ssd_fwd": ssd, "rglru_fwd": rglru}


def path_kernels(cfg):
    """{kernel: the model's layers that launch it once a prefill}."""
    counts = {}
    for kind in cfg.layer_kinds():
        counts[KIND_KERNEL[kind]] = counts.get(KIND_KERNEL[kind], 0) + 1
    return counts


def _counts():
    """(kernel launches, plain calls) of every wrapper, now."""
    from repro_torch.kernels import launch_counts
    return launch_counts()


def _since(before):
    """Kernel launches and plain calls of each wrapper since ``before``,
    leaving out the wrappers with none."""
    now = _counts()
    launched = {k: now[k][0] - before[k][0] for k in now}
    plain = {k: now[k][1] - before[k][1] for k in now}
    return ({k: n for k, n in launched.items() if n},
            {k: n for k, n in plain.items() if n})


def _free():
    """Collect dropped engines and models (the serving runtime holds them
    in reference cycles) and return their memory to the card."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _full_model(arch, dtype, attn_impl, params=None, chunk=None):
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    cfg = ARCHS[arch].cfg.replace(dtype=dtype, attn_impl=attn_impl)
    if chunk is not None:
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
    model = build_model(cfg)
    if params is None:
        model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    else:
        model.set_params(params)
    return model


def _prefill(model, tokens):
    import torch
    with torch.inference_mode():
        cache = model.init_cache(1, MAX_LEN)
        logits, _ = model.prefill(tokens, cache)
    return logits[0, -1].float()


def phase_model(out, arch):
    """Full-width, full-depth prefill through the kernels against prefill
    through the plain versions, same weights (one parameter tree shared by
    both models): float32 gated, bf16 shown.  Every prefill of the kernel
    path must launch each kernel once per layer of its kind and call no
    plain version.

    For the SSD path the plain version also runs at half the chunk size,
    an exact reformulation of the same scan: the two plain runs differ by
    float32 rounding alone, amplified through 48 layers, and that
    difference (``floor``) is this model's noise floor.  The float32 gate
    is then the larger of LOGIT_TOL and FLOOR_FACTOR floors; planted in the
    plain path, the control must pass it and each of LOGIT_FAULTS fail
    it.  For the RG-LRU path the gate is LOGIT_TOL, and the control and
    RG_LOGIT_FAULTS are planted in its plain scan the same way; its bf16 run
    is at the port's init and its float32 runs at the weight sets named
    beside RG_LOGIT_FAULTS.  For granite-moe-1b-a400m the plain path
    routes every token as the kernel path did (``_routed_as``; the tokens
    whose own top-k differs are counted as ``routing_flips``), float32
    is gated at the ``contraction_fan_in`` weights and reported at the
    port's init at the longest S only, where float32 rounding alone
    decides its tokens (see ``_contraction_fan_in``; ``plain_f64_floor``
    shows it), and the gated run and bf16 also run one 4-slot decode step
    (``_decode_check``)."""
    import torch
    res = {}
    runs = [("float32", "seeded"), ("bfloat16", "seeded")]
    if arch == MAMBA:
        runs.append(("float32", "mamba2_init"))
    if arch == RGEMMA:
        runs = [("bfloat16", "seeded"), ("float32", "layer_fan_in"),
                ("float32", "griffin_init")]
    if arch == GRANITE:
        runs.append(("float32", "contraction_fan_in"))
    for dtype, weights in runs:
        # float32 at granite's init is reported, not gated, at one S
        port_init_f32 = (arch, dtype, weights) == (GRANITE, "float32",
                                                   "seeded")
        logit_gate = dtype == "float32" and not port_init_f32
        kmodel = _full_model(arch, dtype, "kernel")
        if weights == "contraction_fan_in":
            _contraction_fan_in(kmodel)
        if weights == "mamba2_init":
            _mamba2_init(kmodel.params.to_dict())
        if weights in ("layer_fan_in", "griffin_init"):
            _layer_fan_in(kmodel)
        if weights == "griffin_init":
            _griffin_init(kmodel.params.to_dict())
        expected = path_kernels(kmodel.cfg)
        rmodel = _full_model(arch, dtype, "ref",
                             params=kmodel.params.to_dict())
        cmodel = (_full_model(arch, dtype, "ref",
                              params=kmodel.params.to_dict(),
                              chunk=kmodel.cfg.ssm.chunk // 2)
                  if arch == MAMBA and dtype == "float32" else None)
        g = torch.Generator(device="cuda").manual_seed(1)
        for S in PREFILL_S[-1:] if port_init_f32 else PREFILL_S:
            toks = torch.randint(0, kmodel.cfg.vocab, (1, S), generator=g,
                                 device="cuda")
            before = _counts()
            with moe_drops() as drops, _moe_choices() as choices:
                lk = _prefill(kmodel, toks)
            launched, plain = _since(before)
            with _routed_as(choices) as flips:
                lr = _prefill(rmodel, toks)
            diff = float((lk - lr).abs().max())
            same = int(lk.argmax()) == int(lr.argmax())
            floor = None
            if cmodel is not None:
                floor = float((_prefill(cmodel, toks) - lr).abs().max())
            gate = max(LOGIT_TOL, FLOOR_FACTOR * (floor or 0.0))
            if cmodel is not None:
                faults = {f: _planted_fault(arch, rmodel, toks, lr, f, gate)
                          for f in (SSD_CONTROL,) + SSD_FAULTS
                          if f == "bf16_inputs" or S > rmodel.cfg.ssm.chunk}
                control, gated = SSD_CONTROL, LOGIT_FAULTS[weights]
            elif arch == RGEMMA and dtype == "float32":
                faults = {f: _planted_fault(arch, rmodel, toks, lr, f, gate)
                          for f in (RG_CONTROL,) + RG_LOGIT_FAULTS
                          if f != "reset_128" or S > RG_PIECE}
                control, gated = RG_CONTROL, RG_LOGIT_FAULTS
            else:
                faults, control, gated = {}, None, ()
            for f, r in faults.items():   # at the floor's scale: reported
                r["gated"] = f == control or f in gated
            t_k = _host_ms(lambda: _prefill(kmodel, toks))
            t_r = _host_ms(lambda: _prefill(rmodel, toks))
            row = {"arch": arch, "dtype": dtype, "weights": weights, "S": S,
                   "max_logit_diff": diff, "same_first_token": same,
                   "max_abs_logit": float(lr.abs().max()),
                   "plain_floor": floor, "gate": gate,
                   "planted_faults": faults,
                   "kernel_launches": launched, "plain_calls": plain,
                   "prefill_ms_kernel_path": t_k,
                   "prefill_ms_plain_path": t_r}
            if arch == GRANITE:
                row.update(moe_dropped=sum(drops),
                           moe_assignments=_assignments(kmodel.cfg, S),
                           routing_flips=sum(flips), gated=logit_gate)
                if dtype == "float32" and S == PREFILL_S[-1]:
                    with _routed_as(choices), _f64_attention():
                        lf = _prefill(rmodel, toks)
                    row["plain_f64_floor"] = float((lf - lr).abs().max())
            log("model " + json.dumps(row))
            res[f"{dtype}_S{S}_{weights}"] = row
            if not torch.isfinite(lk).all():
                raise AssertionError(f"non-finite logits: {row}")
            if launched != expected or plain:
                raise AssertionError(f"prefill launched {launched} and "
                                     f"called plain versions {plain}, not "
                                     f"{expected} launches and none")
            if logit_gate and (diff > gate or not same):
                raise AssertionError(f"float32 kernel path disagrees: {row}")
            missed = [f for f, r in faults.items() if r["gated"]
                      and r["rejected"] == (f == control)]
            if missed:
                raise AssertionError(f"the float32 gate does not tell the "
                                     f"control from planted faults: "
                                     f"{missed}: {row}")
        if arch == GRANITE and not port_init_f32:
            res[f"{dtype}_decode_b4_{weights}"] = _decode_check(
                kmodel, rmodel, weights, g, logit_gate)
        del kmodel, rmodel, cmodel
        _free()
    out[f"model_{arch}"] = res


def _assignments(cfg, T):
    """Router assignments of one call over T tokens: T x top-k x the MoE
    layers."""
    layers = len(cfg.layer_kinds()) - cfg.moe.first_dense
    return T * cfg.moe.top_k * layers


@contextlib.contextmanager
def moe_drops():
    """Count, while open, the router assignments each MoE dispatch drops:
    one int a layer call, appended to the list it yields.  It syncs the
    card once a layer: never open around a timed call."""
    from repro_torch.models import moe
    counts, dispatch = [], moe.dispatch

    def counted(*a, **kw):
        xg, disp = dispatch(*a, **kw)
        counts.append(int((~disp.keep).sum()))
        return xg, disp
    moe.dispatch = counted
    try:
        yield counts
    finally:
        moe.dispatch = dispatch


@contextlib.contextmanager
def _f64_attention():
    """While open, the plain attention computes in float64 and rounds
    back: the same function, rounded elsewhere, so a plain-path result
    under it differs from the float32 plain path's by that path's own
    float32 floor."""
    from repro_torch.models import attention
    plain = attention.ref_attention

    def f64(q, k, v, **kw):
        return plain(q.double(), k.double(), v.double(), **kw).to(q.dtype)
    attention.ref_attention = f64
    try:
        yield
    finally:
        attention.ref_attention = plain


@contextlib.contextmanager
def _moe_choices():
    """Record, while open, each MoE layer call's expert choices (T, k),
    in call order, into the list it yields."""
    from repro_torch.models import moe
    choices, route = [], moe.route

    def recorded(*a, **kw):
        weights, gidx, probs = route(*a, **kw)
        choices.append(gidx)
        return weights, gidx, probs
    moe.route = recorded
    try:
        yield choices
    finally:
        moe.route = route


@contextlib.contextmanager
def _routed_as(choices):
    """While open, each MoE layer call sends every token to the experts
    that ``choices`` (``_moe_choices`` of the same calls on another path)
    holds for it, weighted by this call's own softmax probabilities as
    the router weights its own choice.  A token whose own top-k differs
    (a routing flip: a near-tie that the two paths' rounding decides
    apart) is counted, one int a layer call into the list it yields.  Two
    paths compared under it then differ by what feeds the routers, not by
    a discrete choice that one ulp can turn.  Softmax router only."""
    import torch
    from repro_torch.models import moe
    route, want, flips = moe.route, iter(choices), []

    def routed(p, xf, cfg):
        weights, gidx, probs = route(p, xf, cfg)
        forced = next(want)
        flip = (torch.sort(gidx, dim=-1).values
                != torch.sort(forced, dim=-1).values).any(-1)
        flips.append(int(flip.sum()))
        if flips[-1]:
            w = torch.gather(probs, 1, forced)
            w = w / (torch.sum(w, dim=1, keepdim=True) + 1e-20)
            gidx = torch.where(flip[:, None], forced, gidx)
            weights = torch.where(flip[:, None], w, weights)
        return weights, gidx, probs
    moe.route = routed
    try:
        yield flips
    finally:
        moe.route = route


def _contraction_fan_in(model):
    """Scale, in place, every leaf that the init draws at its fan-in
    (``normal``, no scale) to the fan-in of the dims its product contracts,
    as a model's own init would draw it: the init's rule (the
    reference's) takes the fan-in from a leaf's first axis, which is the
    layers axis of a stacked leaf and the expert axis of an expert stack.
    Batch axes (``layers``, ``expert``) are left out; a leaf whose last
    axis is ``embed`` writes the residual stream and contracts all its
    other axes (``wo``: heads x head dim; an MLP's ``wd``), any other
    contracts its first (``wq``/``wk``/``wv``, ``wg``/``wu``: d_model).
    At granite-moe-1b-a400m's init (24 layers, 32 experts) the attention
    products come out 6.5x too large, so its softmax and its routers'
    top-8 turn on float32 rounding alone (phase 20's ``plain_f64_floor``);
    here no routing decision turns on it."""
    import math
    import torch
    from repro_torch.tree import tree_map

    def scale(spec, leaf):
        if spec.init != "normal" or spec.scale is not None:
            return
        dims = [(n, a) for n, a in zip(spec.shape, spec.axes)
                if a not in ("layers", "expert")]
        fan_in = (math.prod(n for n, _ in dims[:-1])
                  if dims[-1][1] == "embed" else dims[0][0])
        with torch.no_grad():
            leaf.mul_(math.sqrt(spec.shape[0] / fan_in))
    tree_map(scale, model.param_specs(), model.params.to_dict())


def _decode_check(kmodel, rmodel, weights, g, gated):
    """One 4-slot decode step from the caches of four prefills (DECODE_S),
    through the kernel path's prefills and through the plain path's, the
    same tokens fed to both (the kernel path's first tokens) and the
    plain path routed as the kernel path (``_routed_as``): the step's
    last logits, gated (``gated``) as a prefill's are.  In float32 the
    plain path also runs under ``_f64_attention``: its floor."""
    import torch
    from repro_torch.serve.engine import _make_splice
    prompts = [torch.randint(0, kmodel.cfg.vocab, (1, S), generator=g,
                             device="cuda") for S in DECODE_S]
    pos = torch.tensor([[S] for S in DECODE_S], dtype=torch.int32,
                       device="cuda")
    logits, flips, first, dropped = {}, {}, None, None
    runs = [("kernel", kmodel, None), ("plain", rmodel, None)]
    if kmodel.cfg.dtype == "float32" and gated:
        runs.append(("plain_f64", rmodel, _f64_attention))
    for name, model, attention_ctx in runs:
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.inference_mode())
            if attention_ctx is not None:
                stack.enter_context(attention_ctx())
            if name == "kernel":
                choices = stack.enter_context(_moe_choices())
            else:
                flips[name] = stack.enter_context(_routed_as(choices))
            caches = model.init_cache(len(prompts), MAX_LEN)
            splice = _make_splice(model, len(prompts))
            lasts = []
            for slot, toks in enumerate(prompts):
                lg, pc = model.prefill(toks, model.init_cache(1, MAX_LEN))
                lasts.append(lg[0, -1])
                splice(caches, pc, slot)
            if first is None:
                first = torch.stack(lasts).argmax(-1)[:, None]
            with moe_drops() as drops:
                lg, _ = model.decode_step(caches, first, pos)
            if dropped is None:
                dropped = sum(drops)
            logits[name] = lg[:, -1].float()
            del caches
    lk, lr = logits["kernel"], logits["plain"]
    dtype = kmodel.cfg.dtype
    layers = len(kmodel.cfg.layer_kinds()) - kmodel.cfg.moe.first_dense
    row = {"arch": kmodel.cfg.name, "dtype": dtype, "weights": weights,
           "call": "decode_step_b4", "positions": list(DECODE_S),
           "max_logit_diff": float((lk - lr).abs().max()),
           "same_tokens": bool((lk.argmax(-1) == lr.argmax(-1)).all()),
           "max_abs_logit": float(lr.abs().max()), "gate": LOGIT_TOL,
           "plain_f64_floor": (float((logits["plain_f64"] - lr).abs().max())
                               if "plain_f64" in logits else None),
           # tokens of the four prefills and the step whose own routing
           # differs from the kernel path's, and the step's alone
           "routing_flips": {n: sum(f) for n, f in flips.items()},
           "routing_flips_in_step": {n: sum(f[-layers:])
                                     for n, f in flips.items()},
           "gated": gated, "moe_dropped": dropped,
           "moe_assignments": _assignments(kmodel.cfg, len(prompts))}
    log("model " + json.dumps(row))
    if not torch.isfinite(lk).all():
        raise AssertionError(f"non-finite decode logits: {row}")
    if gated and (row["max_logit_diff"] > LOGIT_TOL
                  or not row["same_tokens"]):
        raise AssertionError(f"float32 decode step disagrees: {row}")
    return row


def _layer_fan_in(model):
    """Scale, in place, every stacked leaf that the init draws at its
    fan-in (``normal``, no scale) to one layer's fan-in: by sqrt(layers /
    the layer's fan-in).  The init's rule (the reference's) takes a leaf's
    fan-in from its first axis, the layers axis on a stacked leaf."""
    import math
    import torch
    specs = model.param_specs()

    def walk(spec, leaf, reps):
        if isinstance(spec, dict):
            for k in spec:
                walk(spec[k], leaf[k], reps)
        elif spec.init == "normal" and spec.scale is None:
            layer = spec.shape[1:]
            fan_in = layer[0] if len(layer) >= 2 else max(layer[-1], 1)
            with torch.no_grad():
                leaf.mul_(math.sqrt(reps / fan_in))

    params = model.params.to_dict()
    for si, (_, reps) in enumerate(model.segments):
        if reps > 1:
            walk(specs[f"seg{si}"], params[f"seg{si}"], reps)


def _griffin_init(params):
    """Overwrite, in place, every RG-LRU layer's lam as Griffin's init
    draws it (seeded): a = exp(-8 softplus(lam)) uniform in GRIFFIN_A."""
    import torch
    g = torch.Generator().manual_seed(3)

    def walk(t):
        if not isinstance(t, dict):
            return
        if "lam" in t and "wa" in t:
            lo, hi = GRIFFIN_A
            u = lo + (hi - lo) * torch.rand(t["lam"].shape, generator=g,
                                            dtype=torch.float64)
            with torch.no_grad():
                t["lam"].copy_(torch.log(torch.expm1(-torch.log(u) / 8)))
        for v in t.values():
            walk(v)
    walk(params)


def _mamba2_init(params):
    """Overwrite, in place, every layer's a_log and dt_bias as Mamba-2's
    published init draws them (seeded): A uniform in [1, 16], dt
    log-uniform in [1e-3, 1e-1] and dt_bias its inverse softplus."""
    import math
    import torch
    g = torch.Generator().manual_seed(2)

    def walk(t):
        if not isinstance(t, dict):
            return
        if "a_log" in t and "dt_bias" in t:
            a, d = t["a_log"], t["dt_bias"]
            A = 1 + 15 * torch.rand(a.shape, generator=g)
            dt = torch.exp(math.log(1e-3) + math.log(100) * torch.rand(
                d.shape, generator=g))
            with torch.no_grad():
                a.copy_(torch.log(A))
                d.copy_(dt + torch.log(-torch.expm1(-dt)))
        for v in t.values():
            walk(v)
    walk(params)


def _faulty_ssd(fault, xs, dt, a_log, b, c, *, chunk, init_state=None):
    """The plain SSD scan, chunk by chunk, with one planted fault (see
    SSD_FAULTS), or none (SSD_CONTROL): (y float32, final state)."""
    import torch
    from repro_torch.kernels.ssd.ref import ssd_padded_reference
    if fault == "bf16_inputs":
        return ssd_padded_reference(xs.bfloat16(), dt, a_log, b.bfloat16(),
                                    c.bfloat16(), chunk=chunk,
                                    init_state=init_state)
    s, ys = init_state, []
    for t0 in range(0, xs.shape[1], chunk):
        args = [a[:, t0:t0 + chunk] for a in (xs, dt)] + [a_log] + \
            [a[:, t0:t0 + chunk] for a in (b, c)]
        if fault == "bf16_state" and s is not None:
            s = s.bfloat16().float()
        y, s_next = ssd_padded_reference(*args, chunk=chunk, init_state=s)
        if fault == "no_inter_chunk":
            y, _ = ssd_padded_reference(*args, chunk=chunk)
        ys.append(y)
        s = s_next
    return torch.cat(ys, dim=1), s


def _faulty_scan(fault):
    """``models.mamba2._scan`` on the plain path with ``fault`` planted."""
    def scan(cfg, xs, dt, a_log, b, c, init_state=None):
        return _faulty_ssd(fault, xs, dt, a_log, b, c, chunk=cfg.ssm.chunk,
                           init_state=init_state)
    return scan


def _plain_variant(arch, rmodel, toks, fault):
    """Last logits of a prefill of the plain model with ``fault`` planted
    in its scan (the SSD scan of mamba2-370m, the RG-LRU scan of
    recurrentgemma-9b)."""
    from repro_torch.models import mamba2, rglru
    mod, faulty = ((mamba2, _faulty_scan(fault)) if arch == MAMBA
                   else (rglru, _faulty_rglru_scan(fault)))
    sound = mod._scan
    mod._scan = faulty
    try:
        return _prefill(rmodel, toks)
    finally:
        mod._scan = sound


def _planted_fault(arch, rmodel, toks, lr, fault, gate):
    """The plain model's prefill with ``fault`` planted in its scan: its
    last logits' distance from the sound plain path's, and whether the
    float32 gate rejects it."""
    lf = _plain_variant(arch, rmodel, toks, fault)
    diff = float((lf - lr).abs().max())
    same = int(lf.argmax()) == int(lr.argmax())
    return {"max_logit_diff": diff, "same_first_token": same,
            "gates": diff / gate, "rejected": diff > gate or not same}


def _host_ms(fn, iters=3):
    """Host-clock milliseconds of ``fn`` ending in a device sync."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _load():
    from repro_torch.serve import LoadSpec
    return LoadSpec(rps=8, requests=8, prompt_lens=(100, 256, 384),
                    max_new_lo=16, max_new_hi=32)


def _request_lags(records):
    """Per request, in arrival order: milliseconds from the scheduled
    arrival to the server's admission task holding the server lock
    (``t_recv``), and from its prefill's start to its first token, the
    lock taken again for the splice (``t_first - t_admit``)."""
    recs = sorted(records, key=lambda rec: rec["t_sched"])
    return {"sched_to_recv_ms": [(rec["t_recv"] - rec["t_sched"]) * 1e3
                                 for rec in recs],
            "admit_to_first_ms": [(rec["t_first"] - rec["t_admit"]) * 1e3
                                  for rec in recs]}


def phase_serve(out, arch):
    """The main path of ``arch``: every kernel's counts are set to 0 just
    before the serving run and read just after it."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.serve import run_serve
    load = _load()
    cfg = ARCHS[arch].cfg
    expected = path_kernels(cfg)
    prefills = len(set(load.prompt_lens)) + load.requests
    all_ops = _all_ops()
    torch.cuda.synchronize()
    for ops in all_ops.values():
        ops.reset_counts()                 # the main path's counts only
    res = run_serve(arch=arch, reduced=False, clients=2, slots=4,
                    max_len=MAX_LEN, load=load, transport="inproc",
                    device="cuda")
    torch.cuda.synchronize()
    launches = {k: ops.kernel_launches for k, ops in all_ops.items()}
    plain = {k: ops.plain_calls for k, ops in all_ops.items()}
    ssd_by_variant = dict(all_ops["ssd_fwd"].launches_by_variant)
    r, summary = res["result"], res["summary"]
    log("serve " + json.dumps({
        "arch": arch, "card": out.get("card"), "dtype": cfg.dtype,
        "reading": "smoke, 8 requests", **summary,
        "steps": r["steps"], "tick_execs": r["tick_execs"],
        "prefills": r["prefills"], "kernel_launches": launches,
        "ssd_launches_by_variant": ssd_by_variant,
        "plain_calls": plain, **_request_lags(r["records"])}))
    checks = {
        "served == 8": r["served"] == load.requests,
        "slots_leaked == 0": r["slots_leaked"] == 0,
        "queue_left == 0": r["queue_left"] == 0,
        "tick_execs == steps": r["tick_execs"] == r["steps"],
        **{f"{name} launches == {n} x {prefills}":
           launches[name] == n * prefills for name, n in expected.items()},
        "no other kernel launched": not any(
            n for k, n in launches.items() if k not in expected),
        "plain_calls == 0": not any(plain.values()),
        # the serving path's bf16 views take the tensor-core SSD kernel
        "every ssd_fwd launch mma_bf16":
            ssd_by_variant["mma_bf16"] == launches["ssd_fwd"],
        "tokens in vocab": all(0 <= t < cfg.vocab for rec in r["records"]
                               for t in rec["tokens"]),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve checks failed: {failed}")
    out[f"serve_{arch}"] = {"summary": summary, "steps": r["steps"],
                            "kernel_launches": launches,
                            "ssd_launches_by_variant": ssd_by_variant,
                            "plain_calls": plain}
    if "ssd_fwd" in expected:
        out["ssd_main_path_by_variant"] = ssd_by_variant
    out.setdefault("main_path_launches", {})[arch] = {
        name: launches[name] for name in expected}


def _top2_gap(cfg, prompt, tokens, step, params=None):
    """Top-2 logit gap of the sequential reference at ``step`` (0 = the
    prefill's token), replaying its own tokens."""
    import torch
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, slots=1, max_len=MAX_LEN, device="cuda",
                      params=params)
    with torch.inference_mode():
        toks = torch.tensor([prompt], device="cuda")
        logits, caches = eng._prefill(toks)
        for i in range(step):
            pos = torch.tensor([[len(prompt) + i]], device="cuda")
            tok = torch.tensor([[tokens[i]]], device="cuda")
            logits, caches = eng.model.decode_step(caches, tok, pos)
        top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def _rescaled_numpy(arch, rescale):
    """The port's float32 init of ``arch`` rescaled in place by
    ``rescale`` (``_layer_fan_in``, ``_contraction_fan_in``), as host
    numpy arrays: a parameter tree the serving entry points take as
    ``params``."""
    from repro_torch import bridge
    model = _full_model(arch, "float32", "kernel")
    rescale(model)
    tree = bridge.params_to_numpy(model)
    del model
    _free()
    return tree


def phase_parity(out, arch):
    """float32 served tokens against the sequential baseline's.  For
    recurrentgemma-9b both serve the ``layer_fan_in`` weights (passed as
    ``params``): at the port's init float32 rounding alone moves its logits
    by O(1), past their top-2 gaps (see RG_LOGIT_FAULTS), so batched and
    sequential serving, whose products round differently, part early."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.serve import all_requests, run_sequential, run_serve
    load = _load()
    cfg = ARCHS[arch].cfg.replace(dtype="float32")
    params = _rescaled_numpy(arch, _layer_fan_in) if arch == RGEMMA \
        else None
    res = run_serve(arch=arch, reduced=False, clients=2, slots=4,
                    max_len=MAX_LEN, load=load, device="cuda",
                    dtype="float32", params=params)
    got = {r["id"]: r["tokens"] for r in res["result"]["records"]}
    _free()           # one float32 engine on the card at a time
    reqs = all_requests(load, 2, cfg.vocab)
    seq = run_sequential(cfg, reqs, max_len=MAX_LEN, realtime=False,
                         device="cuda", params=params)
    want = {r["id"]: r["tokens"] for r in seq}
    _free()
    prompts = {r["id"]: r["prompt"] for r in reqs}
    if set(got) != set(want):
        raise AssertionError("served and sequential request ids differ")
    diffs = []
    for rid in sorted(want):
        a, b = got[rid], want[rid]
        if a == b:
            continue
        step = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b)))
        gap = (_top2_gap(cfg, prompts[rid], b, step, params)
               if step < min(len(a), len(b)) else float("inf"))
        diffs.append({"id": rid, "step": step, "top2_gap": gap})
        _free()
    log("parity " + json.dumps({"arch": arch, "requests": len(want),
                                "weights": ("layer_fan_in" if params
                                            else "seeded"),
                                "identical": len(want) - len(diffs),
                                "differing": diffs}))
    bad = [d for d in diffs if not d["top2_gap"] < NEAR_TIE]
    if bad:
        raise AssertionError(f"float32 served tokens differ from the "
                             f"sequential baseline beyond near-ties: {bad}")
    out[f"parity_{arch}"] = {"requests": len(want), "differing": diffs,
                             "served_tokens": got}


def _kernel_time(prof):
    """Device time of the kernels in a profile (ms), their number, and the
    top kernels.  Only device events count: a CPU op's device time is its
    kernels'."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        rows.append((float(t) / 1e3, e.key[:100], int(e.count)))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), sum(r[2] for r in rows), rows[:6]


def phase_profile(out, arch):
    """Where serving time goes on the card: one bf16 prefill (S=384) and
    decode steps of a full 4-slot batch.  The host clock (no profiler)
    gives each call's wall time; ``torch.profiler`` gives the device's
    kernel time for the same call; their ratio is the device's busy
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.serve import ServeEngine
    ssd_ops.reset_counts()
    eng = ServeEngine(ARCHS[arch].cfg, slots=4, max_len=MAX_LEN,
                      device="cuda")
    prompt = list(range(1, 385))
    eng.warmup([len(prompt)])
    first, pcache = eng.prefill(prompt)
    for slot in range(4):
        eng.attach(slot, len(prompt), first, pcache)
    calls = {"prefill_384": lambda: eng.prefill(prompt),
             "decode_step_b4": lambda: eng.step(range(4))}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    res = {}
    for name, fn in calls.items():
        wall = _host_ms(fn, iters=4)
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        device_ms, n_kernels, top = _kernel_time(prof)
        res[name] = {"wall_ms": wall, "device_ms": device_ms,
                     "device_busy_share": device_ms / wall,
                     "kernels": n_kernels, "top_kernels_ms_count": top}
        if arch == GRANITE:
            res[name]["moe_steps"] = _moe_step_times(fn, device_ms)
        log(f"profile {arch} {name} " + json.dumps(res[name]))
    if not res["prefill_384"]["device_ms"] > 0:
        raise AssertionError("the profiler saw no device time")
    if "ssd" in ARCHS[arch].cfg.layer_kinds():
        # the SSD launches of this phase (warm-up, timed and profiled
        # calls), by variant
        res["ssd_launches_by_variant"] = dict(ssd_ops.launches_by_variant)
        log(f"profile {arch} ssd_launches_by_variant "
            + json.dumps(res["ssd_launches_by_variant"]))
        if ssd_ops.launches_by_variant["simt"]:
            raise AssertionError("a bf16 prefill launched the SIMT SSD "
                                 "kernel")
    if arch == RGEMMA:
        res["float32_gates"] = _gate_cost(
            eng, res["decode_step_b4"]["device_ms"])
        log(f"profile {arch} float32_gates "
            + json.dumps(res["float32_gates"]))
    out[f"profile_{arch}"] = res


MOE_STEPS = ("route", "dispatch", "experts", "combine")


def _moe_step_times(fn, device_ms):
    """Device ms of each MoE step (``moe.route``, ``dispatch`` (the table
    and the gather of the expert inputs), ``experts``, ``combine``) summed
    over the layers of one call of ``fn``, and its share of ``device_ms``
    (the same call profiled without the ranges): a second profile with
    each step wrapped in a ``record_function`` range, whose device time
    is that of the kernels launched inside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import moe
    saved = {n: getattr(moe, n) for n in MOE_STEPS}

    def ranged(n, f):
        def call(*a, **kw):
            with record_function(f"moe.{n}"):
                return f(*a, **kw)
        return call
    for n, f in saved.items():
        setattr(moe, n, ranged(n, f))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for n, f in saved.items():
            setattr(moe, n, f)
    ms = {n: 0.0 for n in MOE_STEPS}
    calls = {n: 0 for n in MOE_STEPS}
    for e in prof.key_averages():
        n = e.key[len("moe."):] if e.key.startswith("moe.") else None
        if n in ms and e.device_type == DeviceType.CPU:
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = e.cuda_time_total
            ms[n] += float(t) / 1e3
            calls[n] += int(e.count)
    return {"device_ms": ms, "calls": calls,
            "share_of_device_ms": {n: v / device_ms for n, v in ms.items()},
            "dispatch_and_combine_share":
                (ms["dispatch"] + ms["combine"]) / device_ms}


def _gate_cost(eng, decode_device_ms):
    """What the float32 gates cost a decode step: every RG-LRU layer casts
    its bf16 W x W ``wa`` and ``wi`` to float32 at each call, as the
    reference does, then multiplies the 4 slots' (4, 1, W) float32 input
    by each.  CUDA-event times of the casts alone and of casts and
    products, against the casts' bytes bound and the step's device time."""
    import torch
    with torch.inference_mode():
        gates = [lp["mix"][k] for _, _, _, lp in eng.model.layer_params()
                 if "wa" in lp["mix"] for k in ("wa", "wi")]
        xf = torch.randn((4, 1, gates[0].shape[-1]), device="cuda")
        cast_ms = cuda_ms(lambda: [w.float() for w in gates], iters=5)
        gate_ms = cuda_ms(lambda: [xf @ w.float() for w in gates], iters=5)
    n = sum(w.numel() for w in gates)
    return {"matrices": len(gates), "cast_ms": cast_ms,
            "cast_and_product_ms": gate_ms, "cast_bytes": 6 * n,
            "cast_bound_ms": 6 * n / PEAK_BYTES * 1e3,
            "share_of_decode_device_ms": gate_ms / decode_device_ms}


@contextlib.contextmanager
def moe_fault(fault):
    """Plant one of MOE_FAULTS in the MoE module while open (None: none):
    ``unnormalised_weights`` gives each token's top-k softmax
    probabilities as its weights, ``no_capacity`` a capacity of T slots
    an expert, so no assignment is dropped."""
    import torch
    from repro_torch.models import moe
    saved = moe.route, moe.capacity

    def unnormalised(p, xf, cfg):
        _, gidx, probs = saved[0](p, xf, cfg)
        return torch.gather(probs, 1, gidx), gidx, probs
    if fault == "unnormalised_weights":
        moe.route = unnormalised
    elif fault == "no_capacity":
        moe.capacity = lambda T, k, n_experts, factor: T
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        moe.route, moe.capacity = saved


@contextlib.contextmanager
def record_engine_calls():
    """Record, while open, the calls that an in-proc server makes on its
    :class:`ServeEngine`, with the tokens each returned, into the list it
    yields: ``("prefill", prompt, first)`` and ``("attach", slot,
    prompt_len, first)`` at each admission, ``("step", live, tokens)``
    at each decode step (``tokens``: the whole slot column).  Attach and
    step run under the server's lock, so the list is in the order that
    changed the batch; a prefill touches no shared state and is recorded
    beside the attach that consumes its cache.  The engine's warm-up is
    left out."""
    import threading
    from repro_torch.serve.engine import ServeEngine
    saved = {n: getattr(ServeEngine, n)
             for n in ("prefill", "attach", "step", "warmup")}
    calls, prompts, lock = [], {}, threading.Lock()

    def prefill(self, prompt):
        first, pcache = saved["prefill"](self, prompt)
        with lock:
            prompts[id(pcache)] = list(prompt)
        return first, pcache

    def attach(self, slot, prompt_len, first_token, pcache):
        saved["attach"](self, slot, prompt_len, first_token, pcache)
        with lock:
            prompt = prompts.pop(id(pcache))
        calls.extend([("prefill", prompt, int(first_token)),
                      ("attach", slot, prompt_len, int(first_token))])

    def step(self, live):
        out = saved["step"](self, live)
        calls.append(("step", list(live), [int(t) for t in out]))
        return out

    def warmup(self, *a, **kw):
        saved["warmup"](self, *a, **kw)
        calls.clear()
        prompts.clear()
    for n, f in (("prefill", prefill), ("attach", attach), ("step", step),
                 ("warmup", warmup)):
        setattr(ServeEngine, n, f)
    try:
        yield calls
    finally:
        for n, f in saved.items():
            setattr(ServeEngine, n, f)


def replay_engine_calls(engine, calls):
    """Drive ``engine`` (a fresh :class:`ServeEngine` with the served
    engine's slots and ``max_len``) through ``calls``
    (``record_engine_calls``) with its own prefill, attach and step, fed
    the served tokens: each attach gets the served first token, and after
    each step every live slot's next input is the served token, so a
    token that differs at one call does not carry into the next, and
    every step sees the served batch, dead rows included.  Yields
    ``(call, rows)`` after each call: one row for a prefill, one per live
    slot for a step, none for an attach; each row holds ``served``,
    ``replayed`` (the argmax of the engine's logits at that call) and
    ``top2_gap``."""
    import torch
    model, seen = engine.model, []

    def kept(fn):
        def call(*a, **kw):
            logits, caches = fn(*a, **kw)
            seen.append(logits[:, -1].float())
            return logits, caches
        return call
    model.prefill = kept(model.prefill)
    model.decode_step = kept(model.decode_step)

    def rows(slots, served):
        lg = seen.pop()
        top = torch.topk(lg, 2, dim=-1).values.cpu()
        arg = torch.argmax(lg, dim=-1).cpu()
        return [{"slot": s, "served": int(t), "replayed": int(arg[s]),
                 "top2_gap": float(top[s, 0] - top[s, 1])}
                for s, t in zip(slots, served)]
    pcache = None
    for call in calls:
        if call[0] == "prefill":
            _, pcache = engine.prefill(call[1])
            yield call, rows([0], [call[2]])
        elif call[0] == "attach":
            _, slot, prompt_len, first = call
            engine.attach(slot, prompt_len, first, pcache)
            pcache = None
            yield call, []
        else:
            _, live, served = call
            engine.step(live)
            out = rows(live, [served[s] for s in live])
            for s in live:
                engine.tokens[s, 0] = served[s]
            yield call, out


def _replay(cfg, params, calls, fault):
    """Replay the recorded ``calls`` through a plain-attention engine with
    ``params`` and ``fault`` planted in its MoE layers (None: the
    control): the tokens that differ from the served ones, those beyond a
    near-tie, and the decode steps in which a layer dropped an
    assignment."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg.replace(attn_impl="ref"), slots=4,
                      max_len=MAX_LEN, device="cuda", params=params)
    compared, differing, steps, drop_steps = 0, [], 0, 0
    with moe_fault(fault), moe_drops() as drops:
        for i, (call, rows) in enumerate(replay_engine_calls(eng, calls)):
            compared += len(rows)
            differing += [dict(r, call=i, kind=call[0]) for r in rows
                          if r["served"] != r["replayed"]]
            if call[0] == "step":
                steps += 1
                drop_steps += sum(drops) > 0
            drops.clear()
    del eng
    _free()
    bad = [d for d in differing if not d["top2_gap"] < NEAR_TIE]
    return {"fault": fault, "compared": compared,
            "differing": len(differing), "beyond_near_tie": len(bad),
            "first_differing": differing[:4], "rejected": bool(bad),
            "decode_steps": steps, "decode_steps_with_drops": drop_steps}


def phase_replay(out):
    """float32 serving of granite-moe-1b-a400m, gated by replaying the
    served run's engine calls through a plain-attention engine with the
    same weights, fed the served tokens: the control must pass (every
    token equal or a near-tie) and each of MOE_FAULTS fail.  Both serve
    the ``contraction_fan_in`` weights (passed as ``params``): at the
    port's init float32 rounding alone decides granite's tokens (phase
    20).  The sequential baseline decodes each request alone (T=1, where
    top-8 of 32 never collides), so its tokens may differ where the
    served batch dropped assignments: reported, not gated."""
    from repro_torch.configs import ARCHS
    from repro_torch.serve import all_requests, run_sequential, run_serve
    load = _load()
    cfg = ARCHS[GRANITE].cfg.replace(dtype="float32")
    params = _rescaled_numpy(GRANITE, _contraction_fan_in)
    with record_engine_calls() as calls:
        res = run_serve(arch=GRANITE, reduced=False, clients=2, slots=4,
                        max_len=MAX_LEN, load=load, device="cuda",
                        dtype="float32", params=params)
    r = res["result"]
    served = {rec["id"]: rec["tokens"] for rec in r["records"]}
    del res
    _free()
    runs = {str(f): _replay(cfg, params, calls, f)
            for f in (None,) + MOE_FAULTS}
    seq = run_sequential(cfg, all_requests(load, 2, cfg.vocab),
                         max_len=MAX_LEN, realtime=False, device="cuda",
                         params=params)
    _free()
    seq_diff = []
    for rec in seq:
        a, b = served[rec["id"]], rec["tokens"]
        if a != b:
            seq_diff.append({"id": rec["id"], "first_step": next(
                (i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b))), "tokens": len(b),
                "differing": sum(x != y for x, y in zip(a, b))})
    control = runs["None"]
    report = {"arch": GRANITE, "dtype": "float32",
              "weights": "contraction_fan_in", "requests": len(served),
              "calls": len(calls), "served_steps": r["steps"],
              "near_tie": NEAR_TIE, "replays": runs,
              "sequential_requests_differing": len(seq_diff),
              "sequential_differing": seq_diff}
    log("replay " + json.dumps(report))
    checks = {
        "served == 8": r["served"] == load.requests,
        "every token compared": control["compared"] == load.requests + sum(
            len(c[1]) for c in calls if c[0] == "step"),
        "control passes": not control["rejected"],
        **{f"{f} rejected": runs[f]["rejected"] for f in MOE_FAULTS},
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"replay checks failed: {failed}")
    out[f"replay_{GRANITE}"] = report


# ------------------------------------------------------------- the SSD scan
def ssd_bound(B, T, H, G, N, P, chunk, dtype, init):
    """Least time for one SSD scan: each input read once and each output
    written once over the memory rate, against the operations this T needs
    over the peak rate of the inputs' dtype.  Operations: per chunk of v
    live steps with q = v (v + 1) / 2 causal pairs, c.b^T once per group
    (2 N q), and per head att.x (2 P q), c.S_prev and the state update
    (2 v N P each)."""
    elem = 2 if dtype == "bfloat16" else 4
    state = B * H * N * P * 4
    nbytes = (B * T * H * P * elem + B * T * H * 4 + H * 4
              + 2 * B * T * G * N * elem + B * T * H * P * 4
              + state * (2 if init else 1))
    flops = 0
    for t0 in range(0, T, chunk):
        v = min(chunk, T - t0)
        q = v * (v + 1) // 2
        flops += B * (G * 2 * N * q + H * (2 * P * q + 4 * v * N * P))
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _ssd_inputs(B, T, H, G, N, P, dtype, init, seed, dt_shift=0.0):
    """x, b, c as views of one (B, T, H*P + 2*G*N) buffer, as the model
    slices its conv output; dt a softplus; a_log float32."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    xbc = torch.randn((B, T, H * P + 2 * G * N), generator=g,
                      device="cuda").to(getattr(torch, dtype))
    x = xbc[..., :H * P].reshape(B, T, H, P)
    b = xbc[..., H * P:H * P + G * N].reshape(B, T, G, N)
    c = xbc[..., H * P + G * N:].reshape(B, T, G, N)
    dt = F.softplus(torch.randn((B, T, H), generator=g, device="cuda")
                    + dt_shift)
    a_log = torch.randn((H,), generator=g, device="cuda") * 0.5
    s0 = (torch.randn((B, H, N, P), generator=g, device="cuda")
          if init else None)
    return x, dt, a_log, b, c, s0


def _scaled_err(got, want):
    """Max abs error, the absolute limit SSD_TOL * max|want| applied to
    every element, and whether the error is within it."""
    err = float((got.float() - want.float()).abs().max())
    limit = SSD_TOL * max(1.0, float(want.float().abs().max()))
    return err, limit, err <= limit


def phase_ssd(out):
    import torch
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import ssd_padded_reference
    cases = [dict(B=B, T=T, H=H, G=G, N=N, P=P, chunk=q, dtype=dt, init=i)
             for (B, T, H, G, N, P, q, dt, i) in SSD_CASES]
    cases += [dict(B=1, T=T, H=32, G=1, N=128, P=64, chunk=128,
                   dtype="bfloat16", init=True, path=True)
              for T in SSD_PATH_T]
    cases.append(dict(cases[-1], path=False, dt_shift=DT_SHIFT))
    rows = []
    for n, c in enumerate(cases):
        x, dt, a_log, b, cc, s0 = _ssd_inputs(
            c["B"], c["T"], c["H"], c["G"], c["N"], c["P"], c["dtype"],
            c["init"], seed=100 + n, dt_shift=c.get("dt_shift", 0.0))
        before = dict(ops.launches_by_variant)
        y, fin = ops.ssd_fwd(x, dt, a_log, b, cc, chunk=c["chunk"],
                             init_state=s0)
        yr, fr = ssd_padded_reference(x, dt, a_log, b, cc, chunk=c["chunk"],
                                      init_state=s0)
        torch.cuda.synchronize()
        ran = [v for v, k in ops.launches_by_variant.items()
               if k != before[v]]
        err_y, lim_y, ok_y = _scaled_err(y, yr)
        err_s, lim_s, ok_s = _scaled_err(fin, fr)
        row = {k: c[k] for k in ("B", "T", "H", "G", "N", "P", "chunk",
                                 "dtype", "init")}
        row["dt_shift"] = c.get("dt_shift", 0.0)
        chosen = ops.variant(x.dtype, c["N"], c["P"], c["chunk"],
                             ops.aligned(x, b, cc))
        row.update(variant=ran[0] if len(ran) == 1 else ran,
                   max_abs_err=err_y, max_abs_err_state=err_s,
                   max_abs_y=float(yr.abs().max()), tol=lim_y,
                   tol_state=lim_s,
                   ok=ok_y and ok_s and ran == [chosen],
                   path=c.get("path", False))
        if row["path"] and row["variant"] != "mma_bf16":
            row["ok"] = False              # the serving path's case
        if row["path"]:
            kw = dict(chunk=c["chunk"], init_state=s0)
            # the chosen kernel, then the SIMT kernel on the same inputs
            for key, v in (("", chosen), ("simt_", "simt")):
                row[key + "ms"] = cuda_ms(lambda: ops.ssd_fwd(
                    x, dt, a_log, b, cc, kernel=v, **kw))
                (row[key + "device_ms"],
                 row[key + "device_launches_recorded"]) = kernel_device_ms(
                    lambda: ops.ssd_fwd(x, dt, a_log, b, cc, kernel=v,
                                        **kw),
                    SSD_ENTRY[v], event_ms=row[key + "ms"])
            row["plain_ms"] = cuda_ms(lambda: ssd_padded_reference(
                x, dt, a_log, b, cc, **kw))
            row["library_ms"] = None
            row.update(ssd_bound(c["B"], c["T"], c["H"], c["G"], c["N"],
                                 c["P"], c["chunk"], c["dtype"],
                                 c["init"]))
        if c["T"] == SSD_TIMED_T:
            # this check must pass the control and reject each fault
            row["planted_faults"] = {}
            for f in (SSD_CONTROL,) + KERNEL_FAULTS:
                yf, ff = _faulty_ssd(f, x, dt, a_log, b, cc,
                                     chunk=c["chunk"], init_state=s0)
                ey, _, oy = _scaled_err(yf, yr)
                es, _, os_ = _scaled_err(ff, fr)
                row["planted_faults"][f] = {
                    "max_abs_err": ey, "max_abs_err_state": es,
                    "rejected": not (oy and os_)}
                if row["planted_faults"][f]["rejected"] == (f == SSD_CONTROL):
                    row["ok"] = False
        log("ssd_fwd " + json.dumps(row))
        rows.append(row)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"SSD kernel disagrees with plain version, "
                             f"or its check misjudges a planted fault: "
                             f"{bad}")
    out["ssd_cases"] = rows


# ----------------------------------------------------------- the RG-LRU scan
def rglru_bound(B, T, W, h0):
    """Least time for one RG-LRU scan: x, r, i read and h written once
    (float32), lam, h0 and the final state, over the memory rate, against
    11 float32 operations a (b, t, w) element (log_a, 2 log_a, two exp,
    1 - e, max, sqrt, i x, the product, and the multiply-add of the
    carry) over the float32 rate."""
    nbytes = 4 * (4 * B * T * W + W + B * W * (2 if h0 else 1))
    flops = 11 * B * T * W
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS["float32"]
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _rglru_inputs(B, T, W, h0, lam, seed):
    """x normal, r and i sigmoids of normals, float32; lam as the
    reference's kernel test draws it (``"test"``: |normal| + 0.2) or as
    Griffin's init does (``"griffin"``); h0 normal or None."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, r, i = (torch.randn((B, T, W), generator=g, device="cuda")
               for _ in range(3))
    r, i = torch.sigmoid(r), torch.sigmoid(i)
    if lam == "griffin":
        lo, hi = GRIFFIN_A
        u = lo + (hi - lo) * torch.rand((W,), generator=g, device="cuda",
                                        dtype=torch.float64)
        lv = torch.log(torch.expm1(-torch.log(u) / 8)).float()
    else:
        lv = torch.randn((W,), generator=g, device="cuda").abs() + 0.2
    s0 = torch.randn((B, W), generator=g, device="cuda") if h0 else None
    return x, r, i, lv, s0


def _rg_err(got, want):
    """Max abs error, max of |got - want| / (1 + |want|), and whether every
    element is within RG_TOL * (1 + |want|)."""
    err = (got - want).abs()
    ratio = float((err / (1 + want.abs())).max())
    return float(err.max()), ratio, ratio <= RG_TOL


def _faulty_rglru(fault, x, r, i, lam, h0=None, at=None):
    """The plain RG-LRU scan with one planted fault (RG_FAULTS; reset_once
    drops the carry at step ``at``), or none: in pieces (RG_CONTROL).
    Returns (h float32, final state)."""
    import torch
    from repro_torch.kernels.rglru.ref import rglru_coeffs, rglru_reference
    if fault == "bf16_carry":
        a, b = rglru_coeffs(x, r, i, lam)
        h = (torch.zeros_like(a[:, 0]) if h0 is None else h0.float())
        hs = []
        for t in range(a.shape[1]):
            h = a[:, t] * h + b[:, t]
            h = h.bfloat16().float()
            hs.append(h)
        return torch.stack(hs, dim=1), h
    s = None if fault == "no_h0" else h0
    T = x.shape[1]
    cuts = ([0, at, T] if fault == "reset_once"
            else list(range(0, T, RG_PIECE)) + [T])
    hs = []
    for t0, t1 in zip(cuts, cuts[1:]):
        piece = slice(t0, t1)
        h, fin = rglru_reference(x[:, piece], r[:, piece], i[:, piece], lam,
                                 h0=s)
        hs.append(h)
        s = None if fault in ("reset_128", "reset_once") else fin
    return torch.cat(hs, dim=1), fin


def _faulty_rglru_scan(fault):
    """``models.rglru._scan`` on the plain path with ``fault`` planted."""
    def scan(cfg, xf, r, i, lam, h0=None):
        return _faulty_rglru(fault, xf, r, i, lam, h0)
    return scan


def phase_rglru(out):
    import torch
    from repro_torch.kernels.rglru import ops
    from repro_torch.kernels.rglru.ref import rglru_reference
    cases = [dict(B=B, T=T, W=W, h0=h0, lam=lam)
             for (B, T, W, h0, lam) in RG_CASES]
    cases += [dict(B=1, T=T, W=4096, h0=True, lam="test", path=True)
              for T in RG_PATH_T]
    cases.append(dict(cases[-1], path=False, lam="griffin"))
    cases += [dict(cases[-2], T=RG_LONG_T), dict(cases[-1], T=RG_LONG_T)]
    rows = []
    for n, c in enumerate(cases):
        x, r, i, lv, s0 = _rglru_inputs(c["B"], c["T"], c["W"], c["h0"],
                                        c["lam"], seed=200 + n)
        h, fin = ops.rglru_fwd(x, r, i, lv, h0=s0)
        hr, fr = rglru_reference(x, r, i, lv, h0=s0)
        torch.cuda.synchronize()
        err_h, ratio_h, ok_h = _rg_err(h, hr)
        err_s, ratio_s, ok_s = _rg_err(fin, fr)
        row = {k: c[k] for k in ("B", "T", "W", "h0", "lam")}
        launch = ops.launch_shape(c["B"], c["T"], c["W"])
        row.update(launch=launch, max_abs_err=err_h, max_abs_err_state=err_s,
                   max_err_over_1_plus_abs=max(ratio_h, ratio_s),
                   max_abs_h=float(hr.abs().max()), tol=RG_TOL,
                   ok=ok_h and ok_s, path=c.get("path", False))
        if row["path"]:
            row["ms"] = cuda_ms(lambda: ops.rglru_fwd(x, r, i, lv, h0=s0))
            (row["device_ms"],
             row["device_launches_recorded"]) = kernel_device_ms(
                lambda: ops.rglru_fwd(x, r, i, lv, h0=s0), "rglru_fwd_kernel",
                event_ms=row["ms"])
            row["plain_ms"] = cuda_ms(lambda: rglru_reference(x, r, i, lv,
                                                              h0=s0))
            row["library_ms"] = None
            row.update(rglru_bound(c["B"], c["T"], c["W"], c["h0"]))
        if c["T"] in (RG_TIMED_T, RG_LONG_T):
            # this check must pass the control and reject each fault
            row["planted_faults"] = {}
            span = launch["segments"] * launch["segment_steps"]
            for f in (RG_CONTROL,) + RG_FAULTS:
                if f == "reset_once" and c["T"] <= span:
                    continue
                hf, ff = _faulty_rglru(f, x, r, i, lv, s0, at=span)
                eh, qh, oh = _rg_err(hf, hr)
                es, qs, os_ = _rg_err(ff, fr)
                row["planted_faults"][f] = {
                    "max_abs_err": eh, "max_abs_err_state": es,
                    "max_err_over_1_plus_abs": max(qh, qs),
                    "rejected": not (oh and os_)}
                if row["planted_faults"][f]["rejected"] == (f == RG_CONTROL):
                    row["ok"] = False
        log("rglru_fwd " + json.dumps(row))
        rows.append(row)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"RG-LRU kernel disagrees with plain version, "
                             f"or its check misjudges a planted fault: "
                             f"{bad}")
    out["rglru_cases"] = rows


def _opened_the_card(pid):
    """Whether process ``pid`` has opened an NVIDIA device file: the CUDA
    driver does on its first call (``torch.cuda.is_available()`` too),
    while importing torch only maps the libraries, ``libcuda.so``
    included."""
    fd_dir = f"/proc/{pid}/fd"
    paths = []
    for fd in os.listdir(fd_dir):
        try:
            paths.append(os.readlink(os.path.join(fd_dir, fd)))
        except OSError:
            pass                          # closed while listed
    with open(f"/proc/{pid}/maps") as f:
        paths += [line.split()[-1] for line in f if line.strip()]
    return any(p.startswith("/dev/nvidia") for p in paths)


def _socket_kill_client(load):
    """Serve ``load`` over sockets, one process a rank, and SIGKILL client
    rank 2's process once the server has admitted a request; before the
    kill, record which processes have opened the card."""
    import tempfile
    import torch
    from repro_torch import edat
    from repro_torch.serve import serve_program
    with tempfile.TemporaryDirectory(prefix="smoke_kill_") as tmp:
        ready = os.path.join(tmp, "ready")
        with edat.Session(3, procs=3, transport="socket", timeout=300,
                          workers_per_rank=2, unconsumed="ignore") as s:
            s.start(edat.deferred(serve_program, arch=GEMMA, reduced=False,
                                  slots=4, max_len=MAX_LEN, load=load,
                                  # resolved here, as run_serve does, so
                                  # the clients never ask the driver
                                  device=torch.device("cuda"),
                                  ready_file=ready, ready_after=1))
            deadline = time.monotonic() + 180
            while not os.path.exists(ready):
                if time.monotonic() > deadline:
                    raise TimeoutError("the server admitted no request")
                time.sleep(0.05)
            opened = {rank: _opened_the_card(p.pid)
                      for rank, p in s._pg._procs.items()}
            time.sleep(0.2)
            s.kill(2)
            s.wait(240, check=False)
            return s.exitcodes(), s.gather(), opened


def phase_serve_socket(out):
    """gemma3-1b served over the socket transport at full width, with
    the server rank in its own spawned process: its kernel counts are
    read in that process (since its warm-up), the parent's must not
    move."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.serve import client_schedule, run_serve
    load = _load()
    cfg = ARCHS[GEMMA].cfg
    expected = path_kernels(cfg)
    parent0 = _counts()
    t0 = time.monotonic()
    res = run_serve(arch=GEMMA, reduced=False, clients=2, slots=4,
                    max_len=MAX_LEN, load=load, transport="socket",
                    procs=3, device="cuda")
    session_s = time.monotonic() - t0
    r, summary, wire = res["result"], res["summary"], res["stats"]["transport"]
    launches, plain = r["kernel_launches"], r["plain_calls"]
    recs = r["records"]
    # the clients' release (READY) from their schedules: t_sched is the
    # client's start plus the request's offset
    offset = {q["id"]: q["t"] for c in range(2)
              for q in client_schedule(load, c, 2, cfg.vocab)}
    released = min(rec["t_sched"] - offset[rec["id"]] for rec in recs)
    split = {"session_s": session_s,
             "spawn_build_warmup_s": released - t0,
             "serving_window_s": summary["wall_s"],
             "rest_s": session_s - (released - t0) - summary["wall_s"]}
    log("serve_socket " + json.dumps({
        "arch": GEMMA, "card": out.get("card"), "dtype": cfg.dtype,
        "reading": "smoke, 8 requests", "transport": "socket",
        "procs": 3, **summary, "steps": r["steps"],
        "tick_execs": r["tick_execs"], "prefills": r["prefills"],
        "kernel_launches": launches, "plain_calls": plain, **split,
        **_request_lags(recs),
        "wire": {k: wire.get(k) for k in ("wire_events_sent", "writes",
                                          "wire_bytes", "loopback_events",
                                          "dropped")}}))
    checks = {
        "served == 8": r["served"] == load.requests,
        "prefills == 8": r["prefills"] == load.requests,
        "slots_leaked == 0": r["slots_leaked"] == 0,
        "queue_left == 0": r["queue_left"] == 0,
        "tick_execs == steps": r["tick_execs"] == r["steps"],
        **{f"{name} launches == {n} x prefills":
           launches[name] == n * r["prefills"]
           for name, n in expected.items()},
        "no other kernel launched": not any(
            n for k, n in launches.items() if k not in expected),
        "plain_calls == 0": not any(plain.values()),
        "the parent launched nothing": _counts() == parent0,
        "tokens in vocab": all(0 <= t < cfg.vocab for rec in recs
                               for t in rec["tokens"]),
        "events crossed the wire": wire.get("wire_events_sent", 0) > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"socket serve checks failed: {failed}")
    out["serve_socket"] = {"summary": summary, "steps": r["steps"],
                           "kernel_launches": launches,
                           "plain_calls": plain, "split": split,
                           "wire": wire}
    out.setdefault("main_path_launches", {})[f"{GEMMA} socket"] = {
        name: launches[name] for name in expected}

    # float32: the socket-served tokens against phase 6's in-proc ones
    f32 = cfg.replace(dtype="float32")
    sock = run_serve(arch=GEMMA, reduced=False, clients=2, slots=4,
                     max_len=MAX_LEN, load=load, transport="socket",
                     procs=3, device="cuda", dtype="float32")
    got = {rec["id"]: rec["tokens"] for rec in sock["result"]["records"]}
    want = out.get(f"parity_{GEMMA}", {}).get("served_tokens")
    if want is None:                     # phase 6 did not run: serve here
        inproc = run_serve(arch=GEMMA, reduced=False, clients=2, slots=4,
                           max_len=MAX_LEN, load=load, device="cuda",
                           dtype="float32")
        want = {rec["id"]: rec["tokens"]
                for rec in inproc["result"]["records"]}
        del inproc
        _free()
    prompts = {q["id"]: q["prompt"] for c in range(2)
               for q in client_schedule(load, c, 2, cfg.vocab)}
    if set(got) != set(want):
        raise AssertionError("socket and in-proc request ids differ")
    diffs = []
    for rid in sorted(want):
        a, b = got[rid], want[rid]
        if a == b:
            continue
        step = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b)))
        gap = (_top2_gap(f32, prompts[rid], b, step)
               if step < min(len(a), len(b)) else float("inf"))
        diffs.append({"id": rid, "step": step, "top2_gap": gap})
        _free()
    log("parity_socket " + json.dumps({
        "arch": GEMMA, "requests": len(want), "against": "in-proc float32",
        "identical": len(want) - len(diffs), "differing": diffs}))
    bad = [d for d in diffs if not d["top2_gap"] < NEAR_TIE]
    if bad:
        raise AssertionError(f"float32 socket-served tokens differ from "
                             f"the in-proc ones beyond near-ties: {bad}")
    out["parity_socket"] = {"requests": len(want), "differing": diffs}

    # SIGKILL a client process mid-load: the server drains cleanly
    codes, kres, opened = _socket_kill_client(load)
    survivor = {q["id"] for q in client_schedule(load, 0, 2, cfg.vocab)}
    served = {rec["id"] for rec in kres["records"]} if kres else set()
    log("serve_socket_kill " + json.dumps({
        "exitcodes": codes, "dead": kres and kres["dead"],
        "served": kres and kres["served"], "survivor_requests":
        len(survivor), "opened_the_card": opened}))
    checks = {
        "server and survivor exit 0": codes[0] == 0 and codes[1] == 0,
        "victim exit non-zero": codes[2] not in (None, 0),
        "a result was gathered": kres is not None,
        "dead == [2]": bool(kres) and kres["dead"] == [2],
        "slots_leaked == 0": bool(kres) and kres["slots_leaked"] == 0,
        "queue_left == 0": bool(kres) and kres["queue_left"] == 0,
        "every survivor request served": survivor <= served,
        "plain_calls == 0": bool(kres) and not any(
            kres["plain_calls"].values()),
        "the server opened the card": opened[0],
        "no client opened the card": not opened[1] and not opened[2],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"socket kill checks failed: {failed}")
    out["serve_socket_kill"] = {"exitcodes": codes, "dead": kres["dead"],
                                "served": kres["served"],
                                "opened_the_card": opened}
    torch.cuda.synchronize()


# ---------------------------------------------------- the event-driven trainer
# phase 19: full-width gemma3-1b trained by EventDrivenTrainer.run, in-proc,
# 2 ranks on the one card; every rank's batch is 2 sequences of 512 (S % 128
# == 0: a shape where the reference's ops.supported also takes its kernel)
TRAIN_DATA = dict(vocab=262144, seq=512, global_batch=4, seed=7)
TRAIN_RANKS, TRAIN_STEPS, PARITY_STEPS = 2, 4, 3
# the float32 kernel-vs-plain gate of the trainer.  sgdm (updates linear in
# the grads) at lr 1 with clipping at norm 1: each step moves the weights by
# a unit-norm update, large against the weights' own float32 rounding, so a
# fault that changes the grads shows in the weights.  The kernel and the
# plain forward agree to ~1e-6 relative (phase 3's float32 cases), and the
# backward is the same plain recompute on both paths, so every loss must
# agree within TRAIN_LOSS_RTOL of its size and every weight w within
# TRAIN_PARAM_RTOL * |w| + TRAIN_PARAM_ATOL: the grads' ~1e-6 relative
# difference, carried through three steps into the weights, and ~80 float32
# ulps of each weight; 1e-6 for weights near 0.  The replicas
# of one run must be equal bit for bit (sync DP: both ranks average the
# same grads in the same order and apply the same update).  Planted:
# TRAIN_FAULTS["plain"] in the plain path must fail the parity gate,
# TRAIN_FAULTS["replicas"] must fail the replica gate; the fault-free runs
# pass both
TRAIN_PARITY_OPT = dict(name="sgdm", peak_lr=1.0, warmup=1, total_steps=100,
                        clip_norm=1.0)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL = 1e-5, 1e-6
TRAIN_FAULTS = {"plain": "attention_scale_x1.01",
                "replicas": "own_grads_only"}


def _train_run(dtype, attn_impl, opt, steps, fault=None):
    """One in-proc EventDrivenTrainer.run of full-width gemma3-1b on the
    card; ``fault`` plants one of TRAIN_FAULTS for this run only.
    Returns (trainer, result, host-clock arrival time of each metric)."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataCfg
    from repro_torch.models import attention, build_model
    from repro_torch.optim import OptCfg
    from repro_torch.runtime_dist import trainer as rt
    cfg = ARCHS[GEMMA].cfg.replace(dtype=dtype, attn_impl=attn_impl)
    # a full-width step takes seconds: the straggler bound must not cut a
    # rank out of a synchronous step
    tcfg = rt.TrainerCfg(steps=steps, n_ranks=TRAIN_RANKS,
                         collect_timeout=600.0)
    tr = rt.EventDrivenTrainer(build_model(cfg), DataCfg(**TRAIN_DATA),
                               OptCfg(**opt), tcfg,
                               device=torch.device("cuda"))
    arrivals = []
    tr.on_metric = lambda m: arrivals.append(
        (time.monotonic(), m["rank"], m["step"]))
    plain_attention = attention.ref_attention
    ensure_own = rt.QuorumCollector.ensure_own
    if fault == TRAIN_FAULTS["plain"]:
        attention.ref_attention = (
            lambda *a, scale, **kw: plain_attention(*a, scale=scale * 1.01,
                                                    **kw))
    elif fault == TRAIN_FAULTS["replicas"]:
        def own_only(self, rank, grads):
            self.got = {rank: grads}
        rt.QuorumCollector.ensure_own = own_only
    try:
        t0 = time.monotonic()
        res = tr.run(timeout=900)
        torch.cuda.synchronize()
    finally:
        attention.ref_attention = plain_attention
        rt.QuorumCollector.ensure_own = ensure_own
    res["wall_s"] = time.monotonic() - t0
    res["metric_arrivals_s"] = [(t - t0, r, s) for t, r, s in arrivals]
    return tr, res


def _losses(res):
    return {(m["rank"], m["step"]): m["loss"] for m in res["history"]}


def _replicas_equal(res):
    """Whether rank 0's and rank 1's final trees are equal bit for bit."""
    import torch
    from repro_torch.tree import tree_leaves
    a, b = res["final_params"][:2]
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def _parity(kres, rres):
    """The float32 gate of two runs: its ratios (<= 1 passes)."""
    from repro_torch.tree import tree_leaves
    kl, rl = _losses(kres), _losses(rres)
    if sorted(kl) != sorted(rl):
        raise AssertionError(f"loss histories differ in shape: {sorted(kl)} "
                             f"against {sorted(rl)}")
    loss = max(abs(kl[k] - rl[k]) / (TRAIN_LOSS_RTOL * abs(rl[k]))
               for k in rl)
    param, diff = 0.0, 0.0
    for x, y in zip(tree_leaves(kres["final_params"][0]),
                    tree_leaves(rres["final_params"][0])):
        d = (x.float() - y.float()).abs()
        diff = max(diff, float(d.max()))
        param = max(param, float((d / (TRAIN_PARAM_ATOL + TRAIN_PARAM_RTOL
                                       * y.float().abs())).max()))
    return {"loss_ratio": loss, "param_ratio": param,
            "max_abs_param_diff": diff,
            "max_abs_loss_diff": max(abs(kl[k] - rl[k]) for k in rl),
            "rejected": not (loss <= 1.0 and param <= 1.0)}


def _step_split(tr, data_step):
    """One bf16 step of rank 0, piece by piece, each piece ending in a
    device sync, host clock (ms): the forward and backward (its first,
    cold call is timed apart and left out of the step), the grads'
    device-to-host copy, the quorum reduce of 2 ranks' grads on the host,
    the mean's host-to-device copy and the optimizer update; then the
    forward and backward again under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime_dist.trainer import QuorumCollector, _host32
    from repro_torch.train import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map
    st = tr.states[0]
    batch = {k: torch.from_numpy(v).to("cuda", torch.long)
             for k, v in tr.data.batch(data_step, 0, TRAIN_RANKS).items()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        return val, (time.perf_counter() - t0) * 1e3

    split = {}
    fwd_bwd = lambda: value_and_grad(tr.model, st.params, batch)  # noqa
    # the first call after _free() takes its activations' memory from the
    # CUDA driver (the caching allocator was emptied): timed apart, as cold
    _, split_cold_ms = timed(fwd_bwd)
    (_, grads), split["forward_backward_ms"] = timed(fwd_bwd)
    host, split["grads_to_host_ms"] = timed(
        lambda: tree_map(_host32, grads))
    del grads
    coll = QuorumCollector(step=0, epoch=0, need=TRAIN_RANKS,
                           stale_discount=0.5)
    for r in range(TRAIN_RANKS):    # rank 0's grads stand in for each rank's
        coll.offer({"rank": r, "step": 0, "epoch": 0, "grads": host})
    (gavg, _, _), split["quorum_reduce_ms"] = timed(coll.reduce)
    del host, coll
    gdev, split["mean_to_device_ms"] = timed(lambda: tree_map(
        lambda a: torch.from_numpy(a).to("cuda"), gavg))
    del gavg

    def update():
        with torch.no_grad():
            return tr.opt.update(gdev, st.opt_state, st.params, st.step)
    _, split["optimizer_update_ms"] = timed(update)
    del gdev
    split["step_ms"] = sum(split.values())
    split["forward_backward_cold_ms"] = split_cold_ms
    grad_bytes = sum(p.numel() for p in tree_leaves(st.params)) * 4
    split["grad_bytes_float32"] = grad_bytes
    # the busy share is the profiled call's device time over that same
    # call's host wall (the profiler's own cost included)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_ms = timed(fwd_bwd)
    device_ms, n_kernels, top = _kernel_time(prof)
    split["forward_backward_profile"] = {
        "device_ms": device_ms, "wall_ms": wall_ms, "kernels": n_kernels,
        "device_busy_share": device_ms / wall_ms,
        "top_kernels_ms_count": top}
    return split


def phase_train(out):
    """gemma3-1b trained by the event-driven trainer at full width (the
    training main path), then the float32 parity of its kernel path
    against its plain path, with planted faults."""
    import math
    import resource
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import ops as fa
    cfg = ARCHS[GEMMA].cfg
    expected = path_kernels(cfg)["flash_attention_fwd"] * TRAIN_RANKS \
        * TRAIN_STEPS
    all_ops = _all_ops()
    torch.cuda.synchronize()
    for ops in all_ops.values():
        ops.reset_counts()                 # the main path's counts only
    tr, res = _train_run("bfloat16", "kernel", {"name": "adamw"},
                         TRAIN_STEPS)
    launches = {k: ops.kernel_launches for k, ops in all_ops.items()}
    plain = {k: ops.plain_calls for k, ops in all_ops.items()}
    recomputes = fa.backward_recomputes
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = _losses(res)
    row = {"arch": GEMMA, "card": out.get("card"), "dtype": cfg.dtype,
           "ranks": TRAIN_RANKS, "steps": TRAIN_STEPS, "optimizer": "adamw",
           "data": TRAIN_DATA, "wall_s": res["wall_s"],
           "metric_arrivals_s": res["metric_arrivals_s"],
           "losses": {f"{r}/{s}": v for (r, s), v in losses.items()},
           "kernel_launches": launches, "plain_calls": plain,
           "backward_recomputes": recomputes,
           "timeouts": res["timeouts"],
           "max_memory_allocated_gib": peak_gib}
    checks = {
        f"{len(losses)} losses == ranks x steps":
            len(losses) == TRAIN_RANKS * TRAIN_STEPS,
        "every loss finite": all(math.isfinite(v) for v in losses.values()),
        "replicas equal": _replicas_equal(res),
        f"flash_attention_fwd launches == {expected}":
            launches["flash_attention_fwd"] == expected,
        "no other kernel launched": not any(
            n for k, n in launches.items() if k != "flash_attention_fwd"),
        "plain_calls == 0": not any(plain.values()),
        f"backward_recomputes == {expected}": recomputes == expected,
        "no straggler timeout": res["timeouts"] == 0,
    }
    del res
    _free()
    split = _step_split(tr, TRAIN_STEPS)
    del tr
    _free()
    row["step_split"] = split
    row["peak_rss_gib"] = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                           / 2 ** 20)
    log("train " + json.dumps(row))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train checks failed: {failed}")
    out[f"train_{GEMMA}"] = row
    out.setdefault("main_path_launches", {})[f"{GEMMA}-train"] = {
        "flash_attention_fwd": launches["flash_attention_fwd"]}

    # float32: the kernel path against the plain path, planted faults
    runs = {}
    for name, impl, fault in (("kernel", "kernel", None),
                              ("plain", "ref", None),
                              (TRAIN_FAULTS["plain"], "ref",
                               TRAIN_FAULTS["plain"]),
                              (TRAIN_FAULTS["replicas"], "kernel",
                               TRAIN_FAULTS["replicas"])):
        tr, res = _train_run("float32", impl, TRAIN_PARITY_OPT,
                             PARITY_STEPS, fault)
        del tr
        runs[name] = {"res": res, "replicas_equal": _replicas_equal(res),
                      "wall_s": res["wall_s"]}
        del res["final_params"][1:]       # rank 0's tree is compared
        if name == "kernel":
            continue
        if name != TRAIN_FAULTS["replicas"]:
            runs[name]["gate"] = _parity(runs["kernel"]["res"], res)
        del res["final_params"]           # free the card for the next run
        _free()
    report = {n: {k: v for k, v in r.items() if k != "res"}
              for n, r in runs.items()}
    report["kernel"]["losses"] = {f"{r}/{s}": v for (r, s), v in
                                  _losses(runs["kernel"]["res"]).items()}
    del runs
    _free()
    log("train_parity " + json.dumps({
        "arch": GEMMA, "dtype": "float32", "optimizer": TRAIN_PARITY_OPT,
        "steps": PARITY_STEPS, "loss_rtol": TRAIN_LOSS_RTOL,
        "param_rtol": TRAIN_PARAM_RTOL, "param_atol": TRAIN_PARAM_ATOL,
        **report}))
    checks = {
        "float32 kernel path == plain path": not report["plain"]["gate"][
            "rejected"],
        "the plain fault fails the gate": report[TRAIN_FAULTS["plain"]][
            "gate"]["rejected"],
        "kernel run replicas equal": report["kernel"]["replicas_equal"],
        "plain run replicas equal": report["plain"]["replicas_equal"],
        "the own-grads fault fails the replica gate":
            not report[TRAIN_FAULTS["replicas"]]["replicas_equal"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train parity checks failed: {failed}")
    out[f"train_parity_{GEMMA}"] = report


PHASES = {
    1: ("env", phase_env),
    2: ("build", phase_build),
    3: ("flash_attention kernel", phase_kernels),
    4: ("gemma3-1b model", lambda out: phase_model(out, GEMMA)),
    5: ("gemma3-1b serve (main path)", lambda out: phase_serve(out, GEMMA)),
    6: ("gemma3-1b parity", lambda out: phase_parity(out, GEMMA)),
    7: ("gemma3-1b profile", lambda out: phase_profile(out, GEMMA)),
    8: ("ssd kernel", phase_ssd),
    9: ("mamba2-370m model", lambda out: phase_model(out, MAMBA)),
    10: ("mamba2-370m serve (main path)",
         lambda out: phase_serve(out, MAMBA)),
    11: ("mamba2-370m parity", lambda out: phase_parity(out, MAMBA)),
    12: ("mamba2-370m profile", lambda out: phase_profile(out, MAMBA)),
    13: ("rglru kernel", phase_rglru),
    14: ("recurrentgemma-9b model", lambda out: phase_model(out, RGEMMA)),
    15: ("recurrentgemma-9b serve (main path)",
         lambda out: phase_serve(out, RGEMMA)),
    16: ("recurrentgemma-9b parity", lambda out: phase_parity(out, RGEMMA)),
    17: ("recurrentgemma-9b profile",
         lambda out: phase_profile(out, RGEMMA)),
    18: ("gemma3-1b serve over sockets", phase_serve_socket),
    19: ("gemma3-1b train (event-driven trainer)", phase_train),
    20: ("granite-moe-1b-a400m model", lambda out: phase_model(out, GRANITE)),
    21: ("granite-moe-1b-a400m serve (main path)",
         lambda out: phase_serve(out, GRANITE)),
    22: ("granite-moe-1b-a400m float32 serving", phase_replay),
    23: ("granite-moe-1b-a400m profile",
         lambda out: phase_profile(out, GRANITE)),
}


def kernels_line(out):
    """One entry per kernel.  ``launches`` sums the kernel's launches over
    the main paths this run drove (each counted from 0 just before its
    serving or training run), ``launches_by_path`` splits them by path;
    the numbers of one timed shape stand in the entry, every shape is in
    ``--json``.
    ``ms`` (and ``kernel_ms``) is CUDA events around back-to-back calls
    (``cuda_ms``), the wrapper's host work included where it outlasts the
    kernel; ``device_ms`` beside it is the kernel's own device time
    (``kernel_device_ms``)."""
    fa_rows = out.get("flash_attention_cases", [])
    ssd_rows = out.get("ssd_cases", [])
    rg_rows = out.get("rglru_cases", [])
    by_path = out.get("main_path_launches", {})
    fa_timed = next((r for r in fa_rows if r["path"]
                     and (r["S"], r["window"]) == TIMED), None)
    ssd_timed = next((r for r in ssd_rows if r["path"]
                      and r["T"] == SSD_TIMED_T), None)
    rg_timed = next((r for r in rg_rows if r["path"]
                     and r["T"] == RG_TIMED_T), None)
    entries = []
    for name, source, replaces, rows, timed, tol, rule, keys in (
            ("flash_attention_fwd", FA_SOURCE, FA_REPLACES, fa_rows,
             fa_timed, TOL["bfloat16"],
             f"|kernel - plain| <= {TOL['bfloat16']} * (1 + |plain|)",
             ("B", "S", "H", "KH", "D", "window", "dtype")),
            ("ssd_fwd", SSD_SOURCE, SSD_REPLACES, ssd_rows, ssd_timed,
             ssd_timed["tol"] if ssd_timed else None,
             f"|kernel - plain| <= {SSD_TOL} * max|plain| (tol is that "
             f"limit at the timed shape)",
             ("B", "T", "H", "G", "N", "P", "chunk", "dtype")),
            ("rglru_fwd", RG_SOURCE, RG_REPLACES, rg_rows, rg_timed, RG_TOL,
             f"|kernel - plain| <= {RG_TOL} * (1 + |plain|)",
             ("B", "T", "W", "h0", "lam"))):
        path_err = max((r["max_abs_err"] for r in rows if r["path"]),
                       default=None)
        paths = {arch: n[name] for arch, n in by_path.items() if name in n}
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(paths.values()) if paths else None,
            "launches_by_path": paths,
            "max_abs_err": path_err, "max_err": path_err, "tol": tol,
            "tol_rule": rule,
            "shape": None, "ms": None, "kernel_ms": None, "device_ms": None,
            "plain_ms": None,
            "bound_ms": None, "bound_by": None, "library_ms": None,
        }
        if timed is not None:
            entry.update(shape={k: timed[k] for k in keys},
                         ms=timed["ms"], kernel_ms=timed["ms"],
                         device_ms=timed["device_ms"],
                         plain_ms=timed["plain_ms"],
                         bound_ms=timed["bound_ms"],
                         bound_by=timed["bound_by"],
                         library_ms=timed["library_ms"])
        if name == "flash_attention_fwd":
            # granite-moe-1b-a400m's shape (H=16, KH=8, D=64, no window)
            # at S=511, timed as the entry's
            g = next((r for r in rows if r["path"] == GRANITE
                      and r["S"] == TIMED[0]), None)
            entry["granite"] = g and {
                k: g[k] for k in ("B", "S", "H", "KH", "D", "window",
                                  "dtype", "max_abs_err", "ms",
                                  "device_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")}
        if name == "ssd_fwd":
            entry["library"] = "no single PyTorch call computes the SSD scan"
            # the variant the timed shape launched, the main path's
            # launches by variant, and the SIMT kernel on the same inputs
            entry["variant"] = timed["variant"] if timed else None
            entry["launches_by_variant"] = out.get(
                "ssd_main_path_by_variant")
            entry["simt_ms"] = timed.get("simt_ms") if timed else None
            entry["simt_device_ms"] = (timed.get("simt_device_ms")
                                       if timed else None)
        if name == "rglru_fwd":
            entry["library"] = ("no single PyTorch call computes the RG-LRU "
                                "recurrence")
            # the timed shape's launch: the segmented scan's grid and L
            launch = timed["launch"] if timed else {}
            for k in ("blocks", "threads_per_block", "segment_steps"):
                entry[k] = launch.get(k)
        entries.append(entry)
    return {"kernels": entries}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(map(str, PHASES)),
                    help="comma-separated phase numbers to run")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write every number of the run to PATH")
    args = ap.parse_args(argv)
    phases = [int(p) for p in args.phases.split(",")]
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    out = {}
    for p in phases:
        _free()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        title, fn = PHASES[p]
        log(f"== phase {p}: {title}")
        try:
            fn(out)
        except Exception:
            traceback.print_exc()
            log(f"== phase {p} FAILED")
            return 1
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out.setdefault("peak_memory_gib", {})[p] = peak
        log(f"== phase {p} ok ({time.monotonic() - t0:.1f} s, peak "
            f"{peak:.2f} GiB allocated)")
    line = kernels_line(out)
    out.update(line)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    log(out.get("card", ""))
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
