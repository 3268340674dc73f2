"""RecurrentGemma recurrent block (conv1d + RG-LRU) for the PyTorch port.

The counterpart of ``repro.models.rglru``: the same parameter and cache
trees (dense gates, or block-diagonal ones when ``block_heads > 0``), the
causal conv, the gelu output gate and the same cast points: the conv in
the model dtype; ``xf``, the gates and the scan in float32 (``wa``/``wi``
cast to float32 at each call); ``h`` float32 in the cache; ``h`` cast to the
model dtype before the output gate and ``wo``.

Which scan runs:

* no cache (training, ``loss``): :func:`repro_torch.kernels.rglru.ops.rglru`
  when ``cfg.attn_impl == "kernel"``, else the plain version;
* several steps with a cache (prefill): the scan continues from
  ``cache["h"]`` and returns the final state, through the kernel when
  ``cfg.attn_impl == "kernel"`` (the reference runs its plain scan here:
  its TPU kernel starts from zeros and returns no state);
* one step with a cache (decode): the one-step update in plain ops, as in
  the reference.

Cache writes are in place (``copy_`` into the layer's ``conv`` and ``h``),
where the reference builds new arrays: the returned cache is the one
passed in.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .common import P, gelu
from ..configs.config import ModelCfg
from ..kernels.rglru import ops as rglru_ops
from ..kernels.rglru.ref import rglru_coeffs, rglru_reference


def rglru_specs(cfg: ModelCfg) -> Dict[str, P]:
    d = cfg.d_model
    w = cfg.rglru.lru_width or d
    k = cfg.rglru.conv_size
    bh = cfg.rglru.block_heads
    sp = {
        "wy": P((d, w), ("embed", "rec")),
        "wx": P((d, w), ("embed", "rec")),
        "conv_w": P((k, w), ("dconv", "rec"), scale=0.5),
        "conv_b": P((w,), ("rec",), "zeros"),
        "ba": P((w,), ("rec",), "zeros"),
        "bi": P((w,), ("rec",), "zeros"),
        "lam": P((w,), ("rec",), "ones", scale=0.65),  # Λ resonance param
        "wo": P((w, d), ("rec", "embed")),
    }
    if bh:
        # Griffin's block-diagonal gates
        sp["wa"] = P((bh, w // bh, w // bh), ("ssm_heads", None, None))
        sp["wi"] = P((bh, w // bh, w // bh), ("ssm_heads", None, None))
    else:
        sp["wa"] = P((w, w), ("rec", None))   # dense gates (baseline)
        sp["wi"] = P((w, w), ("rec", None))
    return sp


def _gates(p, xf, bh: int):
    """r, i gates in float32: dense or block-diagonal."""
    if bh:
        B, T, W = xf.shape
        xh = xf.reshape(B, T, bh, W // bh)
        r = torch.einsum("bthw,hwv->bthv", xh,
                         p["wa"].float()).reshape(B, T, W)
        i = torch.einsum("bthw,hwv->bthv", xh,
                         p["wi"].float()).reshape(B, T, W)
        return (torch.sigmoid(r + p["ba"].float()),
                torch.sigmoid(i + p["bi"].float()))
    r = torch.sigmoid(xf @ p["wa"].float() + p["ba"].float())
    i = torch.sigmoid(xf @ p["wi"].float() + p["bi"].float())
    return r, i


def _scan(cfg: ModelCfg, xf, r, i, lam, h0=None):
    """(h float32, final state): the kernel route or the plain version."""
    if cfg.attn_impl == "kernel":
        return rglru_ops.rglru(xf, r, i, lam, h0=h0, return_final_state=True)
    return rglru_reference(xf, r, i, lam, h0=h0)


def rglru_apply(p, x, *, cfg: ModelCfg,
                cache: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    B, T, _ = x.shape
    K = cfg.rglru.conv_size
    y_gate = gelu(x @ p["wy"])
    xr = x @ p["wx"]
    lam = p["lam"].float()

    if cache is None or T > 1:
        pad = (torch.zeros((B, K - 1, xr.shape[-1]), dtype=xr.dtype,
                           device=xr.device)
               if cache is None else cache["conv"].to(xr.dtype))
        xp = torch.cat([pad, xr], dim=1)
        conv = sum(xp[:, k:k + T] * p["conv_w"][k] for k in range(K)) \
            + p["conv_b"]
        xf = conv.float()
        r, i = _gates(p, xf, cfg.rglru.block_heads)
        h, h_last = _scan(cfg, xf, r, i, lam,
                          h0=None if cache is None else cache["h"])
        if cache is not None:
            cache["conv"].copy_(xp[:, -(K - 1):])
            cache["h"].copy_(h_last)
    else:
        xp = torch.cat([cache["conv"], xr], dim=1)        # (B, K, W)
        conv = sum(xp[:, k] * p["conv_w"][k] for k in range(K)) \
            + p["conv_b"]
        xf = conv.float()[:, None]
        r, i = _gates(p, xf, cfg.rglru.block_heads)
        a, b = rglru_coeffs(xf, r, i, lam)
        h = a * cache["h"][:, None] + b
        cache["conv"].copy_(xp[:, 1:])
        cache["h"].copy_(h[:, 0])

    out = (h.to(x.dtype) * y_gate) @ p["wo"]
    return out, cache


def rglru_cache_spec(cfg: ModelCfg, batch: int) -> Dict[str, P]:
    w = cfg.rglru.lru_width or cfg.d_model
    return {
        "conv": P((batch, cfg.rglru.conv_size - 1, w),
                  ("batch", "dconv", "rec"), "zeros"),
        "h": P((batch, w), ("batch", "rec"), "zeros", dtype=torch.float32),
    }
