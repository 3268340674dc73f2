"""Serving launcher: a seeded model's prefill, then greedy decode steps.

The counterpart of ``repro.launch.serve``.  It runs on the card unless
``--device cpu`` is given::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --batch 4 --prompt-len 384 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --reduced --device cpu

The weights are drawn from a seeded ``torch.Generator`` (seed 0), the
prompt from another (seed 1).  Frontends and the encoder-decoder split are
stripped, as in the reference, so every arch serves as a decoder-only LM.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCHS, reduce_cfg
from ..core.device import resolve_device
from ..kernels.flash_attention import ops as fa
from ..models import build_model
from ..train.step import make_prefill_step, make_serve_step


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def generate(model, tokens: torch.Tensor, max_new: int, *,
             timings: dict = None) -> torch.Tensor:
    """The reference CLI's loop: the prompt prefilled into a fresh cache of
    prompt + ``max_new`` slots, the argmax of its last logits the first new
    token, then ``max_new - 1`` greedy serve steps.  Returns the (B,
    max_new) int32 new tokens; ``timings`` gets ``prefill_s`` and
    ``decode_s``."""
    B, S = tokens.shape
    prefill = make_prefill_step(model, max_len=S + max_new)
    serve_step = make_serve_step(model)
    with torch.inference_mode():
        t0 = time.monotonic()
        logits, caches = prefill(tokens)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        _sync(nxt)
        t1 = time.monotonic()
        pos = torch.full((B, 1), S, dtype=torch.int32, device=tokens.device)
        out = [nxt]
        for _ in range(max_new - 1):
            nxt, caches = serve_step(caches, nxt, pos)
            pos = pos + 1
            out.append(nxt)
        toks = torch.cat(out, dim=1)
        _sync(toks)
    if timings is not None:
        timings.update(prefill_s=t1 - t0, decode_s=time.monotonic() - t1)
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    spec = ARCHS[args.arch]
    cfg = reduce_cfg(spec.cfg) if args.reduced else spec.cfg
    if cfg.frontend != "none" or cfg.encdec:
        cfg = cfg.replace(frontend="none", n_frontend_tokens=0,
                          encdec=False)
    total = args.prompt_len + args.max_new
    cfg = cfg.replace(max_target_length=max(cfg.max_target_length, total))
    model = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(0), dev)
    B = args.batch
    tokens = torch.randint(0, cfg.vocab, (B, args.prompt_len),
                           generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    before = dict(fa.launches_by_kind)
    t = {}
    generate(model, tokens, args.max_new, timings=t)
    launches = {f"{v}/{m}": n - before[v, m]
                for (v, m), n in fa.launches_by_kind.items()
                if n != before[v, m]}
    toks = B * (args.max_new - 1)
    dt = t["decode_s"]
    print(f"{args.arch}: prefill({B}x{args.prompt_len}) "
          f"{t['prefill_s']:.2f}s; decode {toks} tokens in {dt:.2f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s); flash launches "
          f"{launches or 0}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
