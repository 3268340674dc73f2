#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with the card and the CUDA
toolkit::

    python3 chip_smoke.py              # all phases
    python3 chip_smoke.py --phases 1,2,3 --json out/smoke.json

It drives the port only (no jax, nothing of ``repro``), in phases that each
raise on failure:

1. environment: the card's name and power limit, torch and CUDA versions;
   TF32 off for float32 products;
2. build: every CUDA kernel from the sources in the checkout;
3. each kernel against its plain PyTorch version on the card, on the
   reference's test cases, ragged tails and the serving path's shapes,
   with CUDA-event times of the kernel, the plain version and one PyTorch
   library call computing the same function (a yardstick only);
4. full-width, full-depth gemma3-1b with seeded random weights: prefill
   through the kernel against prefill through plain attention, float32
   (gated) and bfloat16 (reported);
5. the main path: event-driven serving of gemma3-1b in bf16 through
   ``run_serve`` on the port's EDAT runtime, with the kernel's launch
   count read around it;
6. float32 serving against the sequential baseline, token for token;
7. where serving time goes: one bf16 prefill and one 4-slot decode step,
   the device's kernel time (``torch.profiler``) against the host clock.

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

ARCH = "gemma3-1b"
MAX_LEN = 512             # = gemma3-1b's window: no prompt outgrows a cache
PREFILL_S = (100, 256, 511)
LOGIT_TOL = 1e-3          # float32 kernel path vs plain path, last logits
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


def phase_build(out):
    from repro_torch.kernels import _build
    secs = _build.build_all()
    for name, text in _build.build_log.items():
        log(f"-- nvcc {name}.cu\n{text.strip()}")
    log(f"build: {secs:.1f} s for {list(_build.SOURCES)}")
    out["build_s"] = secs


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


def _full_model(dtype, attn_impl, params=None):
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    cfg = ARCHS[ARCH].cfg.replace(dtype=dtype, attn_impl=attn_impl)
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


def phase_model(out):
    import torch
    from repro_torch.kernels.flash_attention import ops
    res = {}
    for dtype in ("float32", "bfloat16"):
        kmodel = _full_model(dtype, "kernel")
        n_layers = kmodel.cfg.n_layers
        rmodel = _full_model(dtype, "ref", params=kmodel.params.to_dict())
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
            t_k = _host_ms(lambda: _prefill(kmodel, toks))
            t_r = _host_ms(lambda: _prefill(rmodel, toks))
            row = {"dtype": dtype, "S": S, "max_logit_diff": diff,
                   "same_first_token": same, "kernel_launches": launched,
                   "prefill_ms_kernel_path": t_k,
                   "prefill_ms_plain_path": t_r}
            log("model " + json.dumps(row))
            res[f"{dtype}_S{S}"] = row
            if not torch.isfinite(lk).all():
                raise AssertionError(f"non-finite logits: {row}")
            if launched != n_layers:
                raise AssertionError(f"prefill launched the kernel "
                                     f"{launched} times, not {n_layers}")
            if dtype == "float32" and (diff > LOGIT_TOL or not same):
                raise AssertionError(f"float32 kernel path disagrees: {row}")
        del kmodel, rmodel
        torch.cuda.empty_cache()
    out["model"] = res


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


def phase_serve(out):
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.serve import run_serve
    load = _load()
    n_layers = ARCHS[ARCH].cfg.n_layers
    prefills = len(set(load.prompt_lens)) + load.requests
    torch.cuda.synchronize()
    ops.reset_counts()                     # the main path's counts only
    res = run_serve(arch=ARCH, reduced=False, clients=2, slots=4,
                    max_len=MAX_LEN, load=load, transport="inproc",
                    device="cuda")
    torch.cuda.synchronize()
    launches, plain = ops.kernel_launches, ops.plain_calls
    r, summary = res["result"], res["summary"]
    log("serve " + json.dumps({
        "card": out.get("card"), "dtype": "bfloat16", **summary,
        "steps": r["steps"], "tick_execs": r["tick_execs"],
        "prefills": r["prefills"], "kernel_launches": launches,
        "plain_calls": plain}))
    checks = {
        "served == 8": r["served"] == load.requests,
        "slots_leaked == 0": r["slots_leaked"] == 0,
        "queue_left == 0": r["queue_left"] == 0,
        "tick_execs == steps": r["tick_execs"] == r["steps"],
        f"launches == {n_layers * prefills}":
            launches == n_layers * prefills,
        "plain_calls == 0": plain == 0,
        "tokens in vocab": all(0 <= t < ARCHS[ARCH].cfg.vocab
                               for rec in r["records"]
                               for t in rec["tokens"]),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve checks failed: {failed}")
    out["serve"] = {"summary": summary, "steps": r["steps"],
                    "kernel_launches": launches, "plain_calls": plain}
    out["main_path_launches"] = {"flash_attention_fwd": launches}


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


def phase_parity(out):
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.serve import all_requests, run_sequential, run_serve
    load = _load()
    cfg = ARCHS[ARCH].cfg.replace(dtype="float32")
    res = run_serve(arch=ARCH, reduced=False, clients=2, slots=4,
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
    log("parity " + json.dumps({"requests": len(want),
                                "identical": len(want) - len(diffs),
                                "differing": diffs}))
    bad = [d for d in diffs if not d["top2_gap"] < NEAR_TIE]
    if bad:
        raise AssertionError(f"float32 served tokens differ from the "
                             f"sequential baseline beyond near-ties: {bad}")
    out["parity"] = {"requests": len(want), "differing": diffs}


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


def phase_profile(out):
    """Where serving time goes on the card: one bf16 prefill (S=384) and
    decode steps of a full 4-slot batch.  The host clock (no profiler)
    gives each call's wall time; ``torch.profiler`` gives the device's
    kernel time for the same call; their ratio is the device's busy
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ARCHS
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(ARCHS[ARCH].cfg, slots=4, max_len=MAX_LEN,
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
        log(f"profile {name} " + json.dumps(res[name]))
    if not res["prefill_384"]["device_ms"] > 0:
        raise AssertionError("the profiler saw no device time")
    out["profile"] = res


PHASES = {1: phase_env, 2: phase_build, 3: phase_kernels, 4: phase_model,
          5: phase_serve, 6: phase_parity, 7: phase_profile}


def kernels_line(out):
    rows = out.get("flash_attention_cases", [])
    timed = next((r for r in rows if r["path"]
                  and (r["S"], r["window"]) == TIMED), None)
    path_err = max((r["max_abs_err"] for r in rows if r["path"]),
                   default=None)
    entry = {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": FA_SOURCE, "replaces": FA_REPLACES,
        "launches": out.get("main_path_launches", {}).get(
            "flash_attention_fwd"),
        "max_abs_err": path_err, "max_err": path_err,
        "tol": TOL["bfloat16"],
        "shape": None, "ms": None, "kernel_ms": None, "plain_ms": None,
        "bound_ms": None, "bound_by": None, "library_ms": None,
    }
    if timed is not None:
        entry.update(shape={k: timed[k] for k in ("B", "S", "H", "KH", "D",
                                                  "window", "dtype")},
                     ms=timed["ms"], kernel_ms=timed["ms"],
                     plain_ms=timed["plain_ms"],
                     bound_ms=timed["bound_ms"], bound_by=timed["bound_by"],
                     library_ms=timed["library_ms"])
    return {"kernels": [entry]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7",
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
        log(f"== phase {p}: {PHASES[p].__name__}")
        try:
            PHASES[p](out)
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
