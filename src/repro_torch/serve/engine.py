"""The compute half of the serving subsystem: batched decode slots with a
per-slot cache lifecycle (K/V and positions for attention layers, conv
tail and state for SSD layers, conv tail and float32 h for RG-LRU
layers).

The counterpart of ``repro.serve.engine``.  :class:`ServeEngine` owns the
model, its parameters, and one decode cache of ``slots`` batch rows.  The
two operations the event layer drives:

* :meth:`prefill` — run the prompt through the model's prefill path into
  a *fresh single-request cache* (length ``max_len``, so its per-layer
  shapes match one slot of the batch cache) and return the first greedy
  token plus that cache.  It touches no shared decode state, so the event
  layer runs it concurrently with decode ticks.  On the card its
  attention goes through the flash kernel, its SSD scan through the SSD
  kernel and its RG-LRU recurrence through the RG-LRU kernel.
* :meth:`attach` / :meth:`step` — splice a prefilled cache into a batch
  slot and advance the whole batch one greedy token.  ``attach``
  overwrites *every* cache leaf of the slot, which is what makes slot
  reuse safe.  ``step`` advances position counters only for the slots
  listed live — a dead slot's position stays pinned.

Tensors here are updated in place where the reference builds new arrays:
``attach`` copies the prefilled cache into the slot row
(``index_copy_``) and the decode step writes K/V (or the conv tail and the
SSD state or RG-LRU h) into the batch cache.

``torch.inference_mode`` is thread-local and the event layer runs prefill
and decode ticks on worker threads, so each method that touches tensors
enters it itself.

Every entry point takes ``device``; ``None`` means ``"cuda"``, and without
a card that raises RuntimeError instead of running on the CPU: pass
``device="cpu"`` for that.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..bridge import params_from_jax_numpy
from ..core.device import resolve_device
from ..models import build_model
from ..train import make_prefill_step, make_serve_step

DEFAULT_MAX_LEN = 128


def serving_cfg(cfg, max_len: int = DEFAULT_MAX_LEN):
    """Normalize a model config for token-in/token-out serving: no
    multimodal frontend, decoder-only, cache length ``max_len``."""
    return cfg.replace(frontend="none", n_frontend_tokens=0, encdec=False,
                       max_target_length=max_len)


def _make_splice(model, slots: int):
    """``splice(caches, pcache, slot)`` copying the single-request cache
    ``pcache`` over batch row ``slot`` of every cache leaf, in place: K/V
    and positions of attention layers, conv tails, SSD states and RG-LRU
    h alike.
    Stacked-layer segments carry a leading ``layers`` dim, so the batch
    axis is per-segment: 1 when the segment repeats, else 0."""
    axes = [1 if r > 1 else 0 for (_, r) in model.segments]

    def splice(caches, pcache, slot):
        leaf = next(iter(caches[0][0].values()))
        idx = torch.tensor([slot], device=leaf.device)
        for seg, pseg, axis in zip(caches, pcache, axes):
            for unit, punit in zip(seg, pseg):
                for key, c in unit.items():
                    if c.shape[axis] != slots:
                        raise ValueError(f"cache {key} has {c.shape[axis]} "
                                         f"rows on axis {axis}, not {slots}")
                    c.index_copy_(axis, idx, punit[key])
        return caches

    return splice


class ServeEngine:
    """Model + batched decode state for one serving process.

    ``params`` (optional): a reference parameter tree of numpy arrays to
    serve instead of the seeded init (see :mod:`repro_torch.bridge`)."""

    def __init__(self, cfg, *, slots: int, max_len: int = DEFAULT_MAX_LEN,
                 seed: int = 0, device=None,
                 params: Optional[Dict[str, Any]] = None):
        self.device = resolve_device(device)
        cfg = serving_cfg(cfg, max_len)
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.model = build_model(cfg)
        if params is not None:
            params_from_jax_numpy(params, self.model, self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.model.init(gen, self.device)
        self._decode = make_serve_step(self.model)
        self._prefill = make_prefill_step(self.model, max_len=max_len)
        self._splice = _make_splice(self.model, slots)
        with torch.inference_mode():
            self.caches = self.model.init_cache(slots, max_len)
        self.tokens = np.zeros((slots, 1), np.int64)
        self.pos = np.zeros((slots, 1), np.int32)
        #: decode-step invocation counter — the single-chain regression
        #: test asserts tick executions == steps exactly
        self.step_count = 0
        self.prefill_count = 0
        self._count_lock = threading.Lock()   # prefills run concurrently

    # ----------------------------------------------------------- prefill
    def clip_max_new(self, prompt_len: int, max_new: int) -> int:
        """Bound a request's output so prompt + output fits the cache."""
        return max(1, min(max_new, self.max_len - prompt_len))

    def prefill(self, prompt: Sequence[int]) -> Tuple[int, Any]:
        """Prompt -> (first greedy token, fresh single-request cache).
        Shared-state free: safe to run outside the server lock."""
        with torch.inference_mode():
            toks = torch.as_tensor(np.asarray(prompt, np.int64)[None, :],
                                   device=self.device)
            logits, pcache = self._prefill(toks)
            first = int(torch.argmax(logits[:, -1], dim=-1)[0])
        with self._count_lock:
            self.prefill_count += 1
        return first, pcache

    def warmup(self, prompt_lens: Sequence[int] = ()) -> None:
        """Run one prefill per prompt bucket and one decode step, then
        reset all decode state and counters, so serving-latency
        measurements start from a warm allocator and built kernels."""
        for plen in sorted(set(prompt_lens)):
            self.prefill([0] * int(plen))
        self.step([])
        with torch.inference_mode():
            self.caches = self.model.init_cache(self.slots, self.max_len)
        self.tokens[:] = 0
        self.pos[:] = 0
        self.step_count = 0
        self.prefill_count = 0

    # ------------------------------------------------------------ decode
    def attach(self, slot: int, prompt_len: int, first_token: int,
               pcache: Any) -> None:
        """Splice a prefilled request into ``slot``: every cache leaf of
        the slot is overwritten (K/V and pos markers of attention layers,
        conv tail and state of SSD layers, conv tail and h of RG-LRU
        layers) — the per-slot cache reset on admit."""
        with torch.inference_mode():
            self._splice(self.caches, pcache, slot)
        self.tokens[slot, 0] = first_token
        self.pos[slot, 0] = prompt_len

    def step(self, live: Sequence[int]) -> np.ndarray:
        """One greedy decode step over the whole batch; returns the
        next-token column (``(slots,)``).  Tokens/positions advance only
        for ``live`` slots — dead rows keep stepping through the batch
        (their output is ignored) but their position is pinned."""
        with torch.inference_mode():
            toks = torch.as_tensor(self.tokens, device=self.device)
            pos = torch.as_tensor(self.pos, device=self.device)
            nxt, self.caches = self._decode(self.caches, toks, pos)
            out = nxt.cpu().numpy()
        self.step_count += 1
        for i in live:
            self.tokens[i, 0] = out[i, 0]
            self.pos[i, 0] += 1
        return out[:, 0]


class SequentialEngine:
    """The naive baseline: one request at a time, batch of one, prefill
    then decode to completion — no continuous batching, no overlap.
    Identical math to :class:`ServeEngine`, so the event-driven server's
    tokens must match this baseline's token-for-token."""

    def __init__(self, cfg, *, max_len: int = DEFAULT_MAX_LEN,
                 seed: int = 0, device=None,
                 params: Optional[Dict[str, Any]] = None):
        self._eng = ServeEngine(cfg, slots=1, max_len=max_len, seed=seed,
                                device=device, params=params)

    @property
    def step_count(self) -> int:
        return self._eng.step_count

    def warmup(self, prompt_lens: Sequence[int] = ()) -> None:
        self._eng.warmup(prompt_lens)

    def serve_one(self, prompt: Sequence[int],
                  max_new: int) -> Tuple[List[int], float, float]:
        """Serve one request to completion; returns ``(tokens, t_first,
        t_done)`` with the same greedy tokens the batched engine emits
        for this prompt."""
        eng = self._eng
        max_new = eng.clip_max_new(len(prompt), max_new)
        first, pcache = eng.prefill(prompt)
        t_first = time.monotonic()
        eng.caches = pcache          # batch of one: the cache IS the slot
        eng.tokens[0, 0] = first
        eng.pos[0, 0] = len(prompt)
        out = [first]
        for _ in range(max_new - 1):
            out.append(int(eng.step([0])[0]))
        return out, t_first, time.monotonic()
