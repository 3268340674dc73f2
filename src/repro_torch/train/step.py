"""Step builders: train_step (microbatch accumulation), prefill_step,
serve_step.

The counterpart of ``repro.train.step``.  The port's model reads its own
parameters (``model.params``), so :func:`value_and_grad` installs the tree
it is given in a model object of its own and takes gradients with
``torch.autograd.grad`` over its leaves.  The model calls ``constrain``
where the reference does (``repro_torch.sharding``): it returns its input
itself on one device and on meta tensors, and redistributes a ``DTensor``
under an active ``DeviceMesh``.  Remat follows the config's
``remat`` inside the model's forward (``models/lm.py``), as the reference's
does.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..optim import Optimizer
from ..tree import tree_map


def value_and_grad(model, params, batch
                   ) -> Tuple[Tuple[torch.Tensor, Dict], Any]:
    """``((loss, metrics), grads)`` of ``model.loss(batch)`` at
    ``params`` (a tree of tensors), as ``jax.value_and_grad`` of the
    reference's loss: the tree goes into a model object of its own
    (``model`` lends only its config), so a caller that installs other
    parameters in ``model`` meanwhile does not reach this call.
    ``grads`` has the tree's structure and each leaf's dtype, and nothing
    keeps the graph alive.  A leaf the loss does not reach (DeepSeek-V3's
    ``router_bias``, which only selects experts) gets zeros, as JAX gives
    it."""
    m = type(model)(model.cfg).set_params(params)
    tree = m.params.to_dict()
    leaves = []
    tree_map(leaves.append, tree)
    loss, metrics = m.loss(batch)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                     materialize_grads=True))
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(lambda _: next(grads), tree))


def make_train_step(model, opt: Optimizer, *, microbatches: int = 1,
                    acc_dtype=torch.float32) -> Callable:
    """Returns train_step(params, opt_state, batch, step) ->
    (params, opt_state, metrics).

    microbatches > 1: gradient accumulation over batch slices in
    ``acc_dtype`` (peak activation memory divides by the accumulation
    factor).  bfloat16 halves the accumulator's bytes at the cost of ~3
    mantissa bits across the accumulation sum."""

    def train_step(params, opt_state, batch, step):
        if microbatches == 1:
            (loss, metrics), grads = value_and_grad(model, params, batch)
        else:
            def split(x, i):
                b = x.shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} does not split into "
                                     f"{microbatches} microbatches")
                n = b // microbatches
                return x[i * n:(i + 1) * n]

            g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype,
                                                   device=p.device), params)
            l_sum = 0.0
            for i in range(microbatches):
                mb = {k: split(v, i) for k, v in batch.items()}
                (loss, _m), g = value_and_grad(model, params, mb)
                g_sum = tree_map(lambda a, b_: a + b_.to(acc_dtype), g_sum, g)
                l_sum = l_sum + loss
            grads = tree_map(lambda g: g / microbatches, g_sum)
            loss = l_sum / microbatches
            metrics = {"ce": loss}
        new_params, new_state, opt_metrics = opt.update(
            grads, opt_state, params, step)
        out = {"loss": loss, **metrics, **opt_metrics}
        return new_params, new_state, out

    return train_step


def make_prefill_step(model, *, max_len: Optional[int] = None) -> Callable:
    """prefill_step(tokens, *, frame_embeds=None, patch_embeds=None) ->
    (last_logits, cache).

    The stub frontends' embeddings go where the reference's batch sends
    them: ``frame_embeds`` (B, S_enc, d) to an encoder-decoder model's
    encoder (its cache is then ``(caches, cross_kv)``), ``patch_embeds``
    (B, P, d) ahead of a vision model's prompt, which lengthens the
    default cache by P.  ``max_len`` overrides the cache length (default:
    exactly the prompt).  The serving engine passes its decode-cache
    length here so a prefilled single-request cache has the same
    per-layer shapes as one batch slot of the decode cache and can be
    spliced in directly."""

    def prefill_step(tokens, *, frame_embeds=None, patch_embeds=None):
        B, S = tokens.shape
        extra = {}
        if frame_embeds is not None:
            extra["frame_embeds"] = frame_embeds
        if patch_embeds is not None:
            extra["patch_embeds"] = patch_embeds
            S += patch_embeds.shape[1]
        caches = model.init_cache(B, max_len or S, device=tokens.device)
        return model.prefill(tokens, caches, **extra)

    return prefill_step


def make_serve_step(model) -> Callable:
    """serve_step(caches, tokens, pos) -> (next_tokens, caches).

    One decode step for the whole batch: greedy argmax next token."""

    def serve_step(caches, tokens, pos):
        logits, caches = model.decode_step(caches, tokens, pos)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, caches

    return serve_step
