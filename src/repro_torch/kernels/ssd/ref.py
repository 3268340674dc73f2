"""Plain PyTorch version of the SSD chunked scan (the oracle).

The counterpart of ``repro.models.mamba2.ssd_reference`` (which
``repro.kernels.ssd.ref`` re-exports), line for line: the same float32
casts, the causal mask inside the exponent (``-1e30``), groups repeated to
heads, and the inter-chunk state recurrence as a loop over chunks.  The
CPU path, the plain model path and the backward pass run it; the GPU
forward of the kernel path never does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def ssd_reference(x, dt, a_log, b, c, *, chunk: int, init_state=None,
                  return_final_state: bool = False):
    """Chunked SSD scan.

    x: (B, T, H, P)   values per head
    dt: (B, T, H)     softplus-discretised step
    a_log: (H,)       A = -exp(a_log)
    b, c: (B, T, G, N) input/output projections (groups broadcast to heads)
    T must be a multiple of ``chunk``.
    Returns y: (B, T, H, P) float32 [and the final state (B, H, N, P) if
    requested]."""
    B, T, H, Pd = x.shape
    G, N = b.shape[2], b.shape[3]
    nc = T // chunk
    A = -torch.exp(a_log.float())                        # (H,)
    dta = dt.float() * A                                 # (B,T,H) log-decay
    rep = H // G

    xr = x.reshape(B, nc, chunk, H, Pd)
    dtr = dt.reshape(B, nc, chunk, H).float()
    da = dta.reshape(B, nc, chunk, H)
    br = torch.repeat_interleave(b.reshape(B, nc, chunk, G, N), rep, dim=3)
    cr = torch.repeat_interleave(c.reshape(B, nc, chunk, G, N), rep, dim=3)

    cum = torch.cumsum(da, dim=2)                        # (B,nc,Q,H)
    # intra-chunk: y_i += sum_{j<=i} exp(cum_i - cum_j) dt_j (c_i.b_j) x_j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    # mask inside the exponent: exp of masked (positive) entries would be
    # inf and 0*inf => NaN gradients
    decay = torch.exp(torch.where(mask, seg, NEG_INF))
    cb = torch.einsum("bnihd,bnjhd->bnijh", cr.float(), br.float())
    att = cb * decay * dtr[:, :, None, :, :]
    y = torch.einsum("bnijh,bnjhp->bnihp", att, xr.float())

    # chunk-final states: S_n = sum_j exp(cum_last - cum_j) dt_j b_j x_j^T
    last = cum[:, :, -1:, :]                             # (B,nc,1,H)
    w = torch.exp(last - cum) * dtr                      # (B,nc,Q,H)
    states = torch.einsum("bnjh,bnjhd,bnjhp->bnhdp",
                          w, br.float(), xr.float())

    # inter-chunk recurrence over nc:  S <- exp(sum da_n) S + states_n
    chunk_decay = torch.exp(torch.sum(da, dim=2))        # (B,nc,H)
    init = init_state if init_state is not None else \
        torch.zeros((B, H, N, Pd), dtype=torch.float32, device=x.device)
    s = init
    all_states = []
    for n in range(nc):
        s = s * chunk_decay[:, n, :, None, None] + states[:, n]
        all_states.append(s)
    prev = torch.stack([init] + all_states[:-1], dim=1)  # (B,nc,H,N,P)

    # inter-chunk contribution: y_i += exp(cum_i) c_i . S_prev
    y = y + torch.einsum("bnih,bnihd,bnhdp->bnihp",
                         torch.exp(cum), cr.float(), prev)
    y = y.reshape(B, T, H, Pd)
    if return_final_state:
        return y, all_states[-1]                         # (B,H,N,P)
    return y


def ssd_padded_reference(x, dt, a_log, b, c, *, chunk: int,
                         init_state=None):
    """The plain version at any T: zeros past T (dt = 0 there, so the state
    and the first T outputs are those of the unpadded scan).  Returns
    (y (B, T, H, P) float32, final state)."""
    T = x.shape[1]
    pad = (-T) % chunk
    if pad:
        x, b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, b, c))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, fin = ssd_reference(x, dt, a_log, b, c, chunk=chunk,
                           init_state=init_state, return_final_state=True)
    return y[:, :T], fin
