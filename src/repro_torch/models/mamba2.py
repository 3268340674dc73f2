"""Mamba-2 block (state-space duality, SSD) for the PyTorch port.

The counterpart of ``repro.models.mamba2``: the same parameter and cache
trees, the same split of the input projection, the causal depthwise conv
with silu, ``d_skip``, the gated ``rms_norm`` and the same cast points
(the softplus of ``dt`` and the scan in float32, the state float32 in a
bf16 model).

Which scan runs:

* no cache (training, ``loss``): :func:`repro_torch.kernels.ssd.ops.ssd`
  when ``cfg.attn_impl == "kernel"``, else the plain version;
* one step with a cache (decode): the O(1) state update in plain ops, as in
  the reference;
* several steps with a cache (prefill): the scan continues from
  ``cache["state"]`` and returns the final state, through the kernel when
  ``cfg.attn_impl == "kernel"`` (the reference runs its plain version
  here: its TPU kernel starts from zeros and returns no state).

A ragged T needs no padding on the kernel path (the kernel masks the
tail); the plain path pads with zeros after the softplus, so the padded
steps have dt = 0 and leave the state and the first T outputs unchanged.

Cache writes are in place (``copy_`` into the layer's ``conv`` and
``state``), where the reference builds new arrays: the returned cache is
the one passed in.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .common import P, rms_norm, silu, softplus
from ..configs.config import ModelCfg
from ..kernels.ssd import ops as ssd_ops
from ..kernels.ssd.ref import ssd_padded_reference
from ..sharding.ctx import constrain


def _dims(cfg: ModelCfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    d_xbc = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nh, d_xbc


def mamba2_specs(cfg: ModelCfg) -> Dict[str, P]:
    s, d_in, nh, d_xbc = _dims(cfg)
    d = cfg.d_model
    return {
        "in_proj": P((d, 2 * d_in + 2 * s.n_groups * s.d_state + nh),
                     ("embed", "rec")),
        "conv_w": P((s.d_conv, d_xbc), ("dconv", "rec"), scale=0.5),
        "conv_b": P((d_xbc,), ("rec",), "zeros"),
        "a_log": P((nh,), ("ssm_heads",), "ones"),
        "dt_bias": P((nh,), ("ssm_heads",), "zeros"),
        "d_skip": P((nh,), ("ssm_heads",), "ones"),
        "norm": P((d_in,), ("rec",), "ones"),
        "out_proj": P((d_in, d), ("rec", "embed")),
    }


def _split_in(cfg: ModelCfg, zxbcdt):
    s, d_in, nh, d_xbc = _dims(cfg)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + d_xbc]
    dt = zxbcdt[..., d_in + d_xbc:]
    return z, xbc, dt


def _conv1d(xbc, w, b, state: Optional[torch.Tensor]):
    """Depthwise causal conv; state = trailing (d_conv-1) inputs or None."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], K - 1) + tuple(xbc.shape[2:]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state
    xp = torch.cat([pad, xbc], dim=1)                    # (B, T+K-1, C)
    T = xbc.shape[1]
    out = sum(xp[:, i:i + T] * w[i] for i in range(K)) + b
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return silu(out), new_state


def _heads(cfg: ModelCfg, xbc):
    """Views of the conv output: x (B,T,H,P), b and c (B,T,G,N)."""
    s, d_in, nh, _ = _dims(cfg)
    B, T = xbc.shape[:2]
    G, N = s.n_groups, s.d_state
    xs = xbc[..., :d_in].reshape(B, T, nh, s.head_dim)
    b = xbc[..., d_in:d_in + G * N].reshape(B, T, G, N)
    c = xbc[..., d_in + G * N:].reshape(B, T, G, N)
    return xs, b, c


def _scan(cfg: ModelCfg, xs, dt, a_log, b, c, init_state=None):
    """(y float32, final state): the kernel route or the plain version."""
    if cfg.attn_impl == "kernel":
        return ssd_ops.ssd(xs, dt, a_log, b, c, chunk=cfg.ssm.chunk,
                           init_state=init_state, return_final_state=True)
    return ssd_padded_reference(xs, dt, a_log, b, c, chunk=cfg.ssm.chunk,
                                init_state=init_state)


def mamba2_apply(p, x, *, cfg: ModelCfg,
                 cache: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    s, d_in, nh, d_xbc = _dims(cfg)
    B, T, _ = x.shape
    G, N, Pd = s.n_groups, s.d_state, s.head_dim

    zxbcdt = x @ p["in_proj"]
    z, xbc, dt_raw = _split_in(cfg, zxbcdt)
    dt = softplus(dt_raw.float() + p["dt_bias"])

    if cache is None:
        xbc, _ = _conv1d(xbc, p["conv_w"], p["conv_b"], None)
        xs, b, c = _heads(cfg, xbc)
        xs = constrain(xs, ("batch", "seq", "ssm_heads", None))
        y, _ = _scan(cfg, xs, dt, p["a_log"], b, c)
    elif T == 1:
        # single-token decode: O(1) state update (the SSM selling point)
        xp = torch.cat([cache["conv"], xbc], dim=1)
        conv_out = sum(xp[:, i] * p["conv_w"][i]
                       for i in range(s.d_conv)) + p["conv_b"]
        xbc1 = silu(conv_out)[:, None]
        xs = xbc1[..., :d_in].reshape(B, nh, Pd)
        b = xbc1[..., d_in:d_in + G * N].reshape(B, G, N)
        c = xbc1[..., d_in + G * N:].reshape(B, G, N)
        rep = nh // G
        bh = torch.repeat_interleave(b, rep, dim=1)      # (B,H,N)
        ch = torch.repeat_interleave(c, rep, dim=1)
        A = -torch.exp(p["a_log"].float())
        dt1 = dt[:, 0]                                   # (B,H)
        da = torch.exp(dt1 * A)[:, :, None, None]
        upd = (dt1[:, :, None, None] * bh[:, :, :, None]
               * xs.float()[:, :, None, :])
        state = cache["state"] * da + upd                # (B,H,N,P)
        y = torch.einsum("bhn,bhnp->bhp", ch.float(), state)
        y = y[:, None]                                   # (B,1,H,P)
        xs = xs[:, None]
        cache["conv"].copy_(xp[:, 1:])
        cache["state"].copy_(state)
    else:
        # prefill: full-sequence scan from the cached state, carrying the
        # conv tail and the final state out
        xbc, conv_tail = _conv1d(xbc, p["conv_w"], p["conv_b"],
                                 cache["conv"])
        xs, b, c = _heads(cfg, xbc)
        y, final_state = _scan(cfg, xs, dt, p["a_log"], b, c,
                               init_state=cache["state"])
        cache["conv"].copy_(conv_tail)
        cache["state"].copy_(final_state)

    y = y + p["d_skip"].float()[:, None] * xs.float()
    y = y.reshape(B, T, d_in).to(x.dtype)
    y = rms_norm(y * silu(z.float()).to(x.dtype), p["norm"])
    return y @ p["out_proj"], cache


def mamba2_cache_spec(cfg: ModelCfg, batch: int) -> Dict[str, P]:
    s, d_in, nh, d_xbc = _dims(cfg)
    return {
        "conv": P((batch, s.d_conv - 1, d_xbc), ("batch", "dconv", "rec"),
                  "zeros"),
        "state": P((batch, nh, s.d_state, s.head_dim),
                   ("batch", "ssm_heads", "state", None), "zeros",
                   dtype=torch.float32),
    }
