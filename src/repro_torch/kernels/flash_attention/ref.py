"""Plain PyTorch version of the flash attention kernel (the oracle).

The counterpart of ``repro.kernels.flash_attention.ref``: float32 logits,
``-2e38`` fill for masked pairs, probabilities cast to ``v``'s dtype before
the product with ``v``.  The CPU path and the backward pass run it; the GPU
forward never does.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0e38


def attention_ref(q, k, v, *, scale: float, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None):
    """q: (B, H, S, D); k/v: (B, KH, S, D[v]) -> (B, H, S, Dv)."""
    B, H, S, D = q.shape
    KH = k.shape[1]
    g = H // KH
    qr = q.reshape(B, KH, g, S, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qr.float(), k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype), v)
    return out.reshape(B, H, S, v.shape[-1])
