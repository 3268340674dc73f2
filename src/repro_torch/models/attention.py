"""Attention mixers for the PyTorch port: GQA (global and sliding-window)
and DeepSeek-V3's Multi-head Latent Attention (MLA).

The counterpart of ``repro.models.attention``.  Caches carry an explicit
per-slot ``pos`` tensor, so global caches and ring-buffered sliding-window
caches share one masking rule, as in the reference.  An MLA cache holds
only the normalised latent ``c_kv`` and the shared rotated ``k_rope``.

Cache writes are in place (``index_put_`` on the slot rows), where the
reference builds a new cache array: the returned cache is the one passed in.

Which attention runs:

* no cache (training, ``loss``, and the encoder of an encoder-decoder
  model): attention through
  :func:`repro_torch.kernels.flash_attention.ops.flash_attention` when
  ``cfg.attn_impl == "kernel"``, causal or not (``kind == "enc"`` is the
  encoder's non-causal attention; the reference computes that one plain,
  the same function); otherwise :func:`chunked_attention` (the
  plain chunked version, kept beside the kernel's in
  ``kernels/flash_attention/ref.py``) at lengths :func:`use_chunked` takes
  (S >= ``CHUNKED_THRESHOLD`` and a multiple of ``CHUNK``), else
  :func:`ref_attention`, as the reference's ``_train_attention`` routes it;
* a fresh cache (``fresh_cache=True``: every slot empty and the prompt at
  positions ``0..S-1``, which is how prefill runs): attending over the cache
  is exactly causal, sliding-window self-attention over the prompt, so with
  ``attn_impl == "kernel"`` it goes through the flash kernel while K/V are
  written into the cache;
* otherwise (decode): :func:`ref_attention` over the cache.

MLA follows the same rule.  Without a cache, and on a fresh cache under
``attn_impl == "kernel"``, each head's K and V are materialised from the
latent (k = [c_kv W_uk, k_rope], v = c_kv W_uv) and go through the flash
kernel at head dims (nope + rope, v); attending over an empty cache from
position 0 is exactly that causal self-attention.  Otherwise (decode, and
every call under ``attn_impl == "ref"``) :func:`mla_absorbed` attends over
the cache in the reference's absorbed form, op for op: q_nope W_uk against
``c_kv``, no per-head K/V of the cache's length.  The two forms are one
function computed in two orders, so the kernel route and the plain path
differ in formulation as well as in kernel.

A prompt longer than the cache (S > L) raises ValueError.  The reference
then keeps only the last L tokens and earlier queries find every key
masked, so its prefill output is wrong; the port refuses rather than match
or silently differ from it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .common import P, rms_norm, rotary, softcap
from ..configs.config import ModelCfg
from ..kernels.flash_attention import ops as flash_ops
from ..kernels.flash_attention.ref import chunked_attention, use_chunked
from ..sharding.ctx import constrain

NEG_INF = -2.0e38


def ref_attention(q, k, v, *, scale, q_pos, k_pos, window: Optional[int],
                  cap: Optional[float], causal: bool = True):
    """Grouped-query attention, fp32 softmax.

    q: (B, Sq, H, D); k/v: (B, Sk, KH, D); q_pos: (B, Sq); k_pos: (B, Sk).
    Masks: causal (k_pos <= q_pos), optional sliding window, and empty
    cache slots (k_pos < 0)."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    g = H // KH
    qr = q.reshape(B, Sq, KH, g, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qr.float(), k.float()) * scale
    logits = softcap(logits, cap)
    mask = k_pos[:, None, :] >= 0
    if causal:
        mask = mask & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        mask = mask & ((q_pos[:, :, None] - k_pos[:, None, :]) < window)
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, v.shape[-1])


def gqa_specs(cfg: ModelCfg) -> Dict[str, P]:
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sp = {
        "wq": P((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, KH, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, KH, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((H, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.bias:
        sp["bq"] = P((H, hd), ("heads", "head_dim"), "zeros")
        sp["bk"] = P((KH, hd), ("kv_heads", "head_dim"), "zeros")
        sp["bv"] = P((KH, hd), ("kv_heads", "head_dim"), "zeros")
        sp["bo"] = P((d,), ("embed",), "zeros")
    if cfg.qk_norm:
        sp["q_norm"] = P((hd,), ("head_dim",), "zeros")
        sp["k_norm"] = P((hd,), ("head_dim",), "zeros")
    return sp


def gqa_apply(p, x, *, cfg: ModelCfg, kind: str, positions,
              cache: Optional[dict] = None, fresh_cache: bool = False
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """kind: 'attn' (global), 'local' (window=cfg.window) or 'enc' (an
    encoder's: global and not causal, without a cache).

    positions: (B, S) int absolute positions of x's tokens.
    cache: {'k','v': (B, L, KH, D), 'pos': (B, L)} or None (training).
    fresh_cache: the cache is empty and positions are ``0..S-1``."""
    B, S, _ = x.shape
    window = cfg.window if kind == "local" else None
    theta = cfg.local_rope_theta if kind == "local" else cfg.rope_theta

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], plus_one=True)
        k = rms_norm(k, p["k_norm"], plus_one=True)
    if cfg.rope:
        q = rotary(q, positions, theta=theta, fraction=cfg.rope_fraction)
        k = rotary(k, positions, theta=theta, fraction=cfg.rope_fraction)
    q = constrain(q, ("batch", "seq", "heads", "head_dim"))
    k = constrain(k, ("batch", "seq", "kv_heads", "head_dim"))
    scale = cfg.attn_scale if cfg.attn_scale is not None else cfg.hd ** -0.5

    if cache is None:
        out = _train_attention(q, k, v, scale=scale, positions=positions,
                               window=window, cfg=cfg, causal=kind != "enc")
    else:
        L = cache["k"].shape[1]
        if S > L:
            raise ValueError(
                f"{S} tokens do not fit a cache of length {L}: only the last "
                f"{L} could be kept and earlier queries would lose their keys")
        # ring-buffer slot for window caches; append slot for global caches
        slot = (positions % L).long()                          # (B, S)
        bidx = torch.arange(B, device=x.device)[:, None]
        cache["k"][bidx, slot] = k.to(cache["k"].dtype)
        cache["v"][bidx, slot] = v.to(cache["v"].dtype)
        cache["pos"][bidx, slot] = positions.to(cache["pos"].dtype)
        if fresh_cache and cfg.attn_impl == "kernel":
            out = flash_ops.flash_attention(q, k, v, scale=scale, causal=True,
                                            window=window,
                                            softcap=cfg.attn_softcap)
        else:
            out = ref_attention(q, cache["k"], cache["v"], scale=scale,
                                q_pos=positions, k_pos=cache["pos"],
                                window=window, cap=cfg.attn_softcap)

    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if cfg.bias:
        out = out + p["bo"]
    return out, cache


def _train_attention(q, k, v, *, scale, positions, window, cfg: ModelCfg,
                     causal: bool = True):
    if cfg.attn_impl == "kernel":
        return flash_ops.flash_attention(q, k, v, scale=scale, causal=causal,
                                         window=window,
                                         softcap=cfg.attn_softcap)
    if use_chunked(q.shape[1]):
        return chunked_attention(q, k, v, scale=scale, window=window,
                                 cap=cfg.attn_softcap, causal=causal)
    return ref_attention(q, k, v, scale=scale, q_pos=positions,
                         k_pos=positions, window=window,
                         cap=cfg.attn_softcap, causal=causal)


def gqa_cache_spec(cfg: ModelCfg, kind: str, batch: int,
                   max_len: int) -> Dict[str, P]:
    L = min(cfg.window, max_len) if kind == "local" else max_len
    KH, hd = cfg.n_kv_heads, cfg.hd
    return {
        "k": P((batch, L, KH, hd), ("batch", "cache", "kv_heads", "head_dim"),
               "zeros"),
        "v": P((batch, L, KH, hd), ("batch", "cache", "kv_heads", "head_dim"),
               "zeros"),
        "pos": P((batch, L), ("batch", "cache"), "zeros", dtype=torch.int32),
    }


# ================================================================ MLA mixer
def mla_specs(cfg: ModelCfg) -> Dict[str, P]:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.nope_dim + m.rope_dim
    return {
        "wq_a": P((d, m.q_lora), ("embed", "q_lora")),
        "q_norm": P((m.q_lora,), ("q_lora",), "ones"),
        "wq_b": P((m.q_lora, H, qk), ("q_lora", "heads", "head_dim")),
        "wkv_a": P((d, m.kv_lora), ("embed", "kv_lora")),
        "kv_norm": P((m.kv_lora,), ("kv_lora",), "ones"),
        "wk_rope": P((d, m.rope_dim), ("embed", "head_dim")),
        "wk_b": P((m.kv_lora, H, m.nope_dim),
                  ("kv_lora", "heads", "head_dim")),
        "wv_b": P((m.kv_lora, H, m.v_dim), ("kv_lora", "heads", "head_dim")),
        "wo": P((H, m.v_dim, d), ("heads", "head_dim", "embed")),
    }


def mla_expanded(q_nope, q_rope, c_kv, k_rope, *, wk_b, wv_b):
    """Per-head q, K and V of MLA from the latent: q = [q_nope, q_rope]
    (B, S, H, nope + rope), k = [c_kv W_uk, k_rope] with the one rope key
    shared by every head (B, T, H, nope + rope), v = c_kv W_uv
    (B, T, H, v)."""
    k_nope = torch.einsum("btl,lhk->bthk", c_kv, wk_b)
    v = torch.einsum("btl,lhk->bthk", c_kv, wv_b)
    kr = k_rope[:, :, None, :].expand(-1, -1, k_nope.shape[2], -1)
    return (torch.cat([q_nope, q_rope], dim=-1),
            torch.cat([k_nope, kr], dim=-1), v)


def mla_absorbed(q_nope, q_rope, c_kv, k_rope, *, wk_b, wv_b, scale, q_pos,
                 k_pos):
    """The reference's absorbed MLA attention over a cache: logits
    (q_nope W_uk) . c_kv + q_rope . k_rope in float32, causal and
    empty-slot masks, the softmax in float32, then p (in the cache's dtype)
    . c_kv and W_uv.  q_nope/q_rope: (B, S, H, ·); c_kv: (B, T, kv_lora);
    k_rope: (B, T, rope); q_pos: (B, S); k_pos: (B, T) -> (B, S, H, v)."""
    q_abs = torch.einsum("bshk,lhk->bshl", q_nope, wk_b)
    logits = (torch.einsum("bshl,btl->bhst", q_abs.float(), c_kv.float())
              + torch.einsum("bshr,btr->bhst", q_rope.float(),
                             k_rope.float())) * scale
    mask = ((k_pos[:, None, :] <= q_pos[:, :, None])
            & (k_pos[:, None, :] >= 0))
    logits = torch.where(mask[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhst,btl->bshl", probs.to(c_kv.dtype), c_kv)
    return torch.einsum("bshl,lhk->bshk", ctx, wv_b)


def mla_apply(p, x, *, cfg: ModelCfg, positions,
              cache: Optional[dict] = None, fresh_cache: bool = False
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """DeepSeek-V3 Multi-head Latent Attention.

    positions: (B, S) int absolute positions of x's tokens.
    cache: {'c_kv': (B, L, kv_lora), 'k_rope': (B, L, rope), 'pos': (B, L)}
    or None (training).  fresh_cache: the cache is empty and positions are
    ``0..S-1``."""
    m = cfg.mla
    B, S, _ = x.shape
    scale = (m.nope_dim + m.rope_dim) ** -0.5

    q = torch.einsum("bsd,dl->bsl", x, p["wq_a"])
    q = rms_norm(q, p["q_norm"])
    q = torch.einsum("bsl,lhk->bshk", q, p["wq_b"])      # (B,S,H,nope+rope)
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    q_rope = rotary(q_rope, positions, theta=cfg.rope_theta)

    c_kv = torch.einsum("bsd,dl->bsl", x, p["wkv_a"])
    c_kv = rms_norm(c_kv, p["kv_norm"])
    k_rope = torch.einsum("bsd,dr->bsr", x, p["wk_rope"])
    k_rope = rotary(k_rope[:, :, None, :], positions,
                    theta=cfg.rope_theta)[:, :, 0, :]
    w = dict(wk_b=p["wk_b"], wv_b=p["wv_b"])

    if cache is None:
        qf, k, v = mla_expanded(q_nope, q_rope, c_kv, k_rope, **w)
        out = _train_attention(qf, k, v, scale=scale, positions=positions,
                               window=None, cfg=cfg)
    else:
        L = cache["c_kv"].shape[1]
        if S > L:
            raise ValueError(
                f"{S} tokens do not fit a cache of length {L}: only the last "
                f"{L} could be kept and earlier queries would lose their keys")
        slot = (positions % L).long()                          # (B, S)
        bidx = torch.arange(B, device=x.device)[:, None]
        cache["c_kv"][bidx, slot] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][bidx, slot] = k_rope.to(cache["k_rope"].dtype)
        cache["pos"][bidx, slot] = positions.to(cache["pos"].dtype)
        if fresh_cache and cfg.attn_impl == "kernel":
            qf, k, v = mla_expanded(q_nope, q_rope, c_kv, k_rope, **w)
            out = flash_ops.flash_attention(qf, k, v, scale=scale,
                                            causal=True)
        else:
            out = mla_absorbed(q_nope, q_rope, cache["c_kv"],
                               cache["k_rope"], scale=scale, q_pos=positions,
                               k_pos=cache["pos"], **w)

    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, cache


def mla_cache_spec(cfg: ModelCfg, batch: int, max_len: int) -> Dict[str, P]:
    m = cfg.mla
    return {
        "c_kv": P((batch, max_len, m.kv_lora), ("batch", "cache", "kv_lora"),
                  "zeros"),
        "k_rope": P((batch, max_len, m.rope_dim),
                    ("batch", "cache", "head_dim"), "zeros"),
        "pos": P((batch, max_len), ("batch", "cache"), "zeros",
                 dtype=torch.int32),
    }


def init_cache_pos(cache: dict) -> dict:
    """Empty slots are marked pos = -1 (masked out)."""
    out = dict(cache)
    out["pos"] = torch.full_like(cache["pos"], -1)
    return out
