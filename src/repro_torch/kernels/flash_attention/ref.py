"""Plain PyTorch versions of the flash attention kernel (the oracles).

:func:`attention_ref` is the counterpart of
``repro.kernels.flash_attention.ref``: float32 logits, ``-2e38`` fill for
masked pairs, probabilities cast to ``v``'s dtype before the product with
``v``.  The CPU path and the backward pass below the chunked length run it;
the GPU forward never does.

:func:`chunked_attention` is the counterpart of the reference's
``repro.models.attention.chunked_attention``: the same attention with an
online softmax over chunks.  Training attention takes it at the lengths
:func:`use_chunked` accepts (S >= ``CHUNKED_THRESHOLD``, a multiple of
``CHUNK``; the threshold is read at call time): the plain training path
(``models.attention``, which re-exports it) and the flash wrapper's
backward (``ops``).
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


CHUNKED_THRESHOLD = 8192  # training attention is chunked from this length
CHUNK = 2048              # ... at multiples of the chunk, as in the reference


def use_chunked(S: int) -> bool:
    """Whether training attention over S tokens (the plain path, and the
    flash kernel's backward) runs :func:`chunked_attention`: the
    reference's rule, with ``CHUNKED_THRESHOLD`` read at call time."""
    return S >= CHUNKED_THRESHOLD and S % CHUNK == 0


def _live(q0, qc, k0, kc, window, causal) -> bool:
    """Whether any (query, key) pair of the chunk rows q0..q0+qc and keys
    k0..k0+kc passes the causal and window masks."""
    if causal and k0 > q0 + qc - 1:
        return False
    return window is None or q0 - (k0 + kc - 1) < window


def _q_block(qb, k, v, q0, *, scale, window, cap, causal, kv_chunk):
    """The rows q0..q0+qc of chunked attention: the reference's ``q_block``
    (its online softmax over kv chunks, float32 logits, fill NEG_INF,
    p cast to v's dtype for p . v), with the chunks that mask every pair
    skipped.  Skipping is exact: a masked chunk after a live one adds
    exp(NEG_INF - m) = 0 at a factor exp(0) = 1, and one before the first
    live chunk is scaled by exp(NEG_INF - m) = 0 there; its gradient is 0
    either way.  qb: (B, qc, KH, g, D); k: (B, S, KH, D); v: (B, S, KH, Dv)
    -> (B, qc, KH, g, Dv) float32."""
    B, qc, KH, g, _ = qb.shape
    S, Dv = k.shape[1], v.shape[-1]
    q_pos = q0 + torch.arange(qc, device=qb.device)
    acc = torch.zeros((B, KH, g, qc, Dv), dtype=torch.float32,
                      device=qb.device)
    m = torch.full((B, KH, g, qc), float("-inf"), device=qb.device)
    l = torch.zeros((B, KH, g, qc), device=qb.device)
    for k0 in range(0, S, kv_chunk):
        if not _live(q0, qc, k0, kv_chunk, window, causal):
            continue
        kb, vb = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
        k_pos = k0 + torch.arange(kv_chunk, device=qb.device)
        lg = torch.einsum("bqkgd,bskd->bkgqs", qb.float(), kb.float()) * scale
        if cap is not None:
            lg = torch.tanh(lg / cap) * cap
        mask = torch.ones((qc, kv_chunk), dtype=torch.bool, device=qb.device)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
        lg = torch.where(mask, lg, NEG_INF)
        m_new = torch.maximum(m, lg.amax(dim=-1))
        p = torch.exp(lg - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(vb.dtype), vb).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4)


def _chunked_shape(q, k, v, q_chunk, kv_chunk):
    """(B, S, H, D, KH, Dv) of a chunked call; S must split into both
    chunks."""
    B, S, H, D = q.shape
    if S % q_chunk or S % kv_chunk or k.shape[1] != S:
        raise ValueError(f"chunked_attention: {S} queries and {k.shape[1]} "
                         f"keys do not split into chunks of {q_chunk} and "
                         f"{kv_chunk}")
    return B, S, H, D, k.shape[2], v.shape[-1]


def _chunked_forward(q, k, v, *, scale, window, cap, causal, q_chunk,
                     kv_chunk):
    B, S, H, D, KH, Dv = _chunked_shape(q, k, v, q_chunk, kv_chunk)
    out = torch.empty((B, S, H, Dv), dtype=v.dtype, device=q.device)
    for q0 in range(0, S, q_chunk):
        qb = q[:, q0:q0 + q_chunk].reshape(B, q_chunk, KH, H // KH, D)
        out[:, q0:q0 + q_chunk] = _q_block(
            qb, k, v, q0, scale=scale, window=window, cap=cap,
            causal=causal, kv_chunk=kv_chunk).reshape(B, q_chunk, H, Dv)
    return out


def chunked_attention_vjp(q, k, v, g, *, scale, window, cap, causal=True,
                          q_chunk=CHUNK, kv_chunk=CHUNK):
    """(dq, dk, dv) of :func:`chunked_attention` at (q, k, v) against the
    output's cotangent ``g``, one q chunk at a time.  Each output row
    depends on its own query alone, so the vjp of one chunk's rows gives
    that chunk's dq and its share of dk and dv; only one chunk's residuals
    (its kv chunks' probabilities) are alive at a time, where a vjp of the
    whole loop would keep every chunk's (O(S^2) in pieces).  dk and dv sum
    the chunks' shares in float32 and are cast to k's and v's dtype; the
    reference's one vjp sums in another order."""
    B, S, H, D, KH, Dv = _chunked_shape(q, k, v, q_chunk, kv_chunk)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kk, vv = k.detach().requires_grad_(), v.detach().requires_grad_()
    with torch.enable_grad():
        for q0 in range(0, S, q_chunk):
            qb = q[:, q0:q0 + q_chunk].detach().requires_grad_()
            out = _q_block(qb.reshape(B, q_chunk, KH, H // KH, D), kk, vv, q0,
                           scale=scale, window=window, cap=cap, causal=causal,
                           kv_chunk=kv_chunk)
            out = out.reshape(B, q_chunk, H, Dv).to(v.dtype)
            gq, gk, gv = torch.autograd.grad(out, (qb, kk, vv),
                                             g[:, q0:q0 + q_chunk])
            dq[:, q0:q0 + q_chunk] = gq
            dk += gk
            dv += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _ChunkedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, window, cap, causal, q_chunk, kv_chunk):
        ctx.save_for_backward(q, k, v)
        ctx.cfg = dict(scale=scale, window=window, cap=cap, causal=causal,
                       q_chunk=q_chunk, kv_chunk=kv_chunk)
        return _chunked_forward(q, k, v, **ctx.cfg)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*chunked_attention_vjp(q, k, v, g, **ctx.cfg),) + (None,) * 6


def chunked_attention(q, k, v, *, scale, window: Optional[int],
                      cap: Optional[float], causal: bool = True,
                      q_chunk: int = CHUNK, kv_chunk: int = CHUNK):
    """The reference's ``chunked_attention``: flash-style online-softmax
    attention in plain ops, O(S * chunk) memory instead of O(S^2).
    q: (B, S, H, D); k: (B, S, KH, D); v: (B, S, KH, Dv) -> (B, S, H, Dv)
    in v's dtype, positions 0..S-1; S a multiple of both chunks.  Its
    backward (:func:`chunked_attention_vjp`) recomputes one q chunk at a
    time from q, k and v, the only tensors it keeps."""
    return _ChunkedAttention.apply(q, k, v, scale, window, cap, causal,
                                   q_chunk, kv_chunk)
