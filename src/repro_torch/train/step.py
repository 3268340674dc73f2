"""Step builders for serving: prefill_step and serve_step.

The counterpart of ``repro.train.step``; ``make_train_step`` comes with
the training slice of the port.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def make_prefill_step(model, *, max_len: Optional[int] = None) -> Callable:
    """prefill_step(tokens) -> (last_logits, cache).

    ``max_len`` overrides the cache length (default: exactly the prompt).
    The serving engine passes its decode-cache length here so a prefilled
    single-request cache has the same per-layer shapes as one batch slot
    of the decode cache and can be spliced in directly."""

    def prefill_step(tokens):
        B, S = tokens.shape
        caches = model.init_cache(B, max_len or S, device=tokens.device)
        return model.prefill(tokens, caches)

    return prefill_step


def make_serve_step(model) -> Callable:
    """serve_step(caches, tokens, pos) -> (next_tokens, caches).

    One decode step for the whole batch: greedy argmax next token."""

    def serve_step(caches, tokens, pos):
        logits, caches = model.decode_step(caches, tokens, pos)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, caches

    return serve_step
