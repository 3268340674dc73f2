#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with the card and the CUDA
toolkit::

    python3 chip_smoke.py              # all phases
    python3 chip_smoke.py --phases 1,2,3 --json out/smoke.json

It drives the port only (no jax, nothing of ``repro``), in phases that each
raise on failure.  Two paths are driven, gemma3-1b (flash attention) and
mamba2-370m (the SSD scan), each at full width and depth:

1. environment: the card's name and power limit, torch and CUDA versions;
   TF32 off for float32 products;
2. build: every CUDA kernel from the sources in the checkout, all ``nvcc``
   at once, with each kernel's registers and spills;
3. the flash kernel against its plain PyTorch version on the card, on the
   reference's test cases, ragged tails and the serving path's shapes,
   with CUDA-event times of the kernel, the plain version and one PyTorch
   library call computing the same function (a yardstick only);
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
8. the SSD kernel against its plain version on the card: the reference's
   test cases, ragged tails, a nonzero initial state (final state compared
   too) and the serving path's shapes, timed as in phase 3 (no single
   PyTorch call computes this function, so it has no library time); the
   same check must reject faults planted in the plain scan;
9. mamba2-370m: prefill through the SSD kernel against prefill through the
   plain scan, float32 (gated, with the reference's init and again with
   Mamba-2's init of a_log and dt_bias) and bfloat16 (reported); the
   float32 gate must reject faults planted in the plain scan;
10. mamba2-370m's main path: event-driven serving in bf16, counted as in
    phase 5;
11. float32 serving of mamba2-370m against the sequential baseline;
12. where mamba2-370m's serving time goes, as in phase 7.

It prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` as
its last line; ``--json PATH`` also writes every number to PATH.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
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

GEMMA, MAMBA = "gemma3-1b", "mamba2-370m"
PATH_KERNEL = {GEMMA: "flash_attention_fwd", MAMBA: "ssd_fwd"}  # prefill's
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
    smem = ssd_ops.smem_bytes(128, 64, 128)
    log("ssd_fwd ptxas " + json.dumps({
        "kernels": ptxas.get("ssd_fwd"),
        "dynamic_smem_bytes_at_N128_P64_chunk128": smem}))
    out["build_s"] = secs
    out["ptxas"] = ptxas
    out["ssd_smem_bytes"] = smem


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
                   dtype="bfloat16", B=1, path=True)
              for S in PATH_S for w in PATH_WINDOWS]
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
                   path=c.get("path", False))
        if row["path"]:
            row["ms"] = cuda_ms(lambda: ops.flash_attention_fwd(q, k, v,
                                                                **kw))
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
    from repro_torch.kernels.ssd import ops as ssd
    return {"flash_attention_fwd": fa, "ssd_fwd": ssd}


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
    """Full-width, full-depth prefill through the kernel against prefill
    through the plain version, same weights: float32 gated, bf16 shown.

    For the SSD path the plain version also runs at half the chunk size,
    an exact reformulation of the same scan: the two plain runs differ by
    float32 rounding alone, amplified through 48 layers, and that
    difference (``floor``) is this model's noise floor.  The float32 gate
    is then the larger of LOGIT_TOL and FLOOR_FACTOR floors; planted in the
    plain path, the control must pass it and each of LOGIT_FAULTS fail
    it."""
    import torch
    ops = _all_ops()[PATH_KERNEL[arch]]
    res = {}
    runs = [("float32", "seeded"), ("bfloat16", "seeded")]
    if arch == MAMBA:
        runs.append(("float32", "mamba2_init"))
    for dtype, weights in runs:
        kmodel = _full_model(arch, dtype, "kernel")
        if weights == "mamba2_init":
            _mamba2_init(kmodel.params.to_dict())
        n_layers = kmodel.cfg.n_layers
        rmodel = _full_model(arch, dtype, "ref",
                             params=kmodel.params.to_dict())
        cmodel = (_full_model(arch, dtype, "ref",
                              params=kmodel.params.to_dict(),
                              chunk=kmodel.cfg.ssm.chunk // 2)
                  if arch == MAMBA and dtype == "float32" else None)
        g = torch.Generator(device="cuda").manual_seed(1)
        for S in PREFILL_S:
            toks = torch.randint(0, kmodel.cfg.vocab, (1, S), generator=g,
                                 device="cuda")
            before = ops.kernel_launches
            lk = _prefill(kmodel, toks)
            launched = ops.kernel_launches - before
            lr = _prefill(rmodel, toks)
            diff = float((lk - lr).abs().max())
            same = int(lk.argmax()) == int(lr.argmax())
            floor = (float((_prefill(cmodel, toks) - lr).abs().max())
                     if cmodel is not None else None)
            gate = max(LOGIT_TOL, FLOOR_FACTOR * (floor or 0.0))
            faults = ({f: _planted_fault(rmodel, toks, lr, f, gate)
                       for f in (SSD_CONTROL,) + SSD_FAULTS
                       if f == "bf16_inputs" or S > rmodel.cfg.ssm.chunk}
                      if cmodel is not None else {})
            for f, r in faults.items():
                r["gated"] = f == SSD_CONTROL or f in LOGIT_FAULTS[weights]
            t_k = _host_ms(lambda: _prefill(kmodel, toks))
            t_r = _host_ms(lambda: _prefill(rmodel, toks))
            row = {"arch": arch, "dtype": dtype, "weights": weights, "S": S,
                   "max_logit_diff": diff, "same_first_token": same,
                   "max_abs_logit": float(lr.abs().max()),
                   "plain_floor": floor, "gate": gate,
                   "planted_faults": faults,
                   "kernel_launches": launched,
                   "prefill_ms_kernel_path": t_k,
                   "prefill_ms_plain_path": t_r}
            log("model " + json.dumps(row))
            res[f"{dtype}_S{S}_{weights}"] = row
            if not torch.isfinite(lk).all():
                raise AssertionError(f"non-finite logits: {row}")
            if launched != n_layers:
                raise AssertionError(f"prefill launched the kernel "
                                     f"{launched} times, not {n_layers}")
            if dtype == "float32" and (diff > gate or not same):
                raise AssertionError(f"float32 kernel path disagrees: {row}")
            missed = [f for f, r in faults.items() if r["gated"]
                      and r["rejected"] == (f == SSD_CONTROL)]
            if missed:
                raise AssertionError(f"the float32 gate does not tell the "
                                     f"control from planted faults: "
                                     f"{missed}: {row}")
        del kmodel, rmodel, cmodel
        torch.cuda.empty_cache()
    out[f"model_{arch}"] = res


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


def _planted_fault(rmodel, toks, lr, fault, gate):
    """Prefill of the plain model with ``fault`` planted in its scan: its
    last logits' distance from the sound plain path's, and whether the
    float32 gate rejects it."""
    from repro_torch.models import mamba2
    sound = mamba2._scan
    mamba2._scan = _faulty_scan(fault)
    try:
        lf = _prefill(rmodel, toks)
    finally:
        mamba2._scan = sound
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


def phase_serve(out, arch):
    """The main path of ``arch``: every kernel's counts are set to 0 just
    before the serving run and read just after it."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.serve import run_serve
    load = _load()
    cfg = ARCHS[arch].cfg
    name = PATH_KERNEL[arch]
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
    r, summary = res["result"], res["summary"]
    log("serve " + json.dumps({
        "arch": arch, "card": out.get("card"), "dtype": cfg.dtype,
        "reading": "smoke, 8 requests", **summary,
        "steps": r["steps"], "tick_execs": r["tick_execs"],
        "prefills": r["prefills"], "kernel_launches": launches,
        "plain_calls": plain}))
    checks = {
        "served == 8": r["served"] == load.requests,
        "slots_leaked == 0": r["slots_leaked"] == 0,
        "queue_left == 0": r["queue_left"] == 0,
        "tick_execs == steps": r["tick_execs"] == r["steps"],
        f"{name} launches == {cfg.n_layers} x {prefills}":
            launches[name] == cfg.n_layers * prefills,
        "plain_calls == 0": not any(plain.values()),
        "tokens in vocab": all(0 <= t < cfg.vocab for rec in r["records"]
                               for t in rec["tokens"]),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve checks failed: {failed}")
    out[f"serve_{arch}"] = {"summary": summary, "steps": r["steps"],
                            "kernel_launches": launches,
                            "plain_calls": plain}
    out.setdefault("main_path_launches", {})[name] = launches[name]


def _top2_gap(cfg, prompt, tokens, step):
    """Top-2 logit gap of the sequential reference at ``step`` (0 = the
    prefill's token), replaying its own tokens."""
    import torch
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, slots=1, max_len=MAX_LEN, device="cuda")
    with torch.inference_mode():
        toks = torch.tensor([prompt], device="cuda")
        logits, caches = eng._prefill(toks)
        for i in range(step):
            pos = torch.tensor([[len(prompt) + i]], device="cuda")
            tok = torch.tensor([[tokens[i]]], device="cuda")
            logits, caches = eng.model.decode_step(caches, tok, pos)
        top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def phase_parity(out, arch):
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.serve import all_requests, run_sequential, run_serve
    load = _load()
    cfg = ARCHS[arch].cfg.replace(dtype="float32")
    res = run_serve(arch=arch, reduced=False, clients=2, slots=4,
                    max_len=MAX_LEN, load=load, device="cuda",
                    dtype="float32")
    got = {r["id"]: r["tokens"] for r in res["result"]["records"]}
    reqs = all_requests(load, 2, cfg.vocab)
    seq = run_sequential(cfg, reqs, max_len=MAX_LEN, realtime=False,
                         device="cuda")
    want = {r["id"]: r["tokens"] for r in seq}
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
        gap = (_top2_gap(cfg, prompts[rid], b, step)
               if step < min(len(a), len(b)) else float("inf"))
        diffs.append({"id": rid, "step": step, "top2_gap": gap})
        torch.cuda.empty_cache()
    log("parity " + json.dumps({"arch": arch, "requests": len(want),
                                "identical": len(want) - len(diffs),
                                "differing": diffs}))
    bad = [d for d in diffs if not d["top2_gap"] < NEAR_TIE]
    if bad:
        raise AssertionError(f"float32 served tokens differ from the "
                             f"sequential baseline beyond near-ties: {bad}")
    out[f"parity_{arch}"] = {"requests": len(want), "differing": diffs}


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
    from repro_torch.serve import ServeEngine
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
        log(f"profile {arch} {name} " + json.dumps(res[name]))
    if not res["prefill_384"]["device_ms"] > 0:
        raise AssertionError("the profiler saw no device time")
    out[f"profile_{arch}"] = res


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
        y, fin = ops.ssd_fwd(x, dt, a_log, b, cc, chunk=c["chunk"],
                             init_state=s0)
        yr, fr = ssd_padded_reference(x, dt, a_log, b, cc, chunk=c["chunk"],
                                      init_state=s0)
        torch.cuda.synchronize()
        err_y, lim_y, ok_y = _scaled_err(y, yr)
        err_s, lim_s, ok_s = _scaled_err(fin, fr)
        row = {k: c[k] for k in ("B", "T", "H", "G", "N", "P", "chunk",
                                 "dtype", "init")}
        row["dt_shift"] = c.get("dt_shift", 0.0)
        row.update(max_abs_err=err_y, max_abs_err_state=err_s,
                   max_abs_y=float(yr.abs().max()), tol=lim_y,
                   tol_state=lim_s, ok=ok_y and ok_s,
                   path=c.get("path", False))
        if row["path"]:
            kw = dict(chunk=c["chunk"], init_state=s0)
            row["ms"] = cuda_ms(lambda: ops.ssd_fwd(x, dt, a_log, b, cc,
                                                    **kw))
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
}


def kernels_line(out):
    fa_rows = out.get("flash_attention_cases", [])
    ssd_rows = out.get("ssd_cases", [])
    launches = out.get("main_path_launches", {})
    fa_timed = next((r for r in fa_rows if r["path"]
                     and (r["S"], r["window"]) == TIMED), None)
    ssd_timed = next((r for r in ssd_rows if r["path"]
                      and r["T"] == SSD_TIMED_T), None)
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
             ("B", "T", "H", "G", "N", "P", "chunk", "dtype"))):
        path_err = max((r["max_abs_err"] for r in rows if r["path"]),
                       default=None)
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name),
            "max_abs_err": path_err, "max_err": path_err, "tol": tol,
            "tol_rule": rule,
            "shape": None, "ms": None, "kernel_ms": None, "plain_ms": None,
            "bound_ms": None, "bound_by": None, "library_ms": None,
        }
        if timed is not None:
            entry.update(shape={k: timed[k] for k in keys},
                         ms=timed["ms"], kernel_ms=timed["ms"],
                         plain_ms=timed["plain_ms"],
                         bound_ms=timed["bound_ms"],
                         bound_by=timed["bound_by"],
                         library_ms=timed["library_ms"])
        if name == "ssd_fwd":
            entry["library"] = "no single PyTorch call computes the SSD scan"
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
        t0 = time.monotonic()
        title, fn = PHASES[p]
        log(f"== phase {p}: {title}")
        try:
            fn(out)
        except Exception:
            traceback.print_exc()
            log(f"== phase {p} FAILED")
            return 1
        log(f"== phase {p} ok ({time.monotonic() - t0:.1f} s)")
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
