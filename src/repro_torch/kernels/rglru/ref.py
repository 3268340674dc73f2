"""Plain PyTorch version of the RG-LRU recurrence (the oracle).

The counterpart of ``repro.models.rglru._rglru_scan`` (which
``repro.kernels.rglru.ref`` wraps), with the same formulas in float32::

    log_a = -8 * softplus(lam) * r            softplus = logaddexp(., 0)
    b     = sqrt(max(1 - exp(2 * log_a), 1e-12)) * (i * x)
    h_t   = a_t * h_{t-1} + b_t               h_{-1} = h0 (zeros if absent)

The scan composes (a, b) pairs with the reference's ``combine`` in log
depth (Hillis-Steele doubling: ceil(log2 T) rounds of elementwise ops), then
adds ``prod_{<=t} a * h0`` as the reference does.  The CPU path, the plain
model path and the backward pass run it; the GPU forward of the kernel path
never does.
"""
from __future__ import annotations

import torch

C = 8.0  # RG-LRU temperature constant (Griffin paper)


def rglru_coeffs(x, r, i, lam):
    """(a, b) of the recurrence h_t = a_t h_{t-1} + b_t, float32."""
    lam = lam.float()
    log_a = -C * torch.logaddexp(lam, torch.zeros_like(lam)) * r.float()
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i.float() * x.float())
    return a, b


def rglru_reference(x, r, i, lam, h0=None):
    """x, r, i: (B, T, W); lam: (W,); h0: (B, W) float32 or None.

    Returns (h (B, T, W) float32, final state h[:, -1] (B, W))."""
    a, b = rglru_coeffs(x, r, i, lam)
    T = a.shape[1]
    k = 1
    while k < T:
        # element t absorbs the composed pair ending at t - k:
        # (a1, b1) then (a2, b2) is (a1 a2, a2 b1 + b2)
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    h = b if h0 is None else b + a * h0.float()[:, None, :]
    return h, h[:, -1]
