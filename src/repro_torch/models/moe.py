"""Mixture-of-Experts layer (Granite-MoE / DeepSeek-V3 style) for the
PyTorch port.

The counterpart of ``repro.models.moe``: the same router (a softmax, or
DeepSeek-V3's sigmoid affinities with a selection bias), the same
load-balance aux loss, the same sort-based capacity dispatch into an
(E, C, d) table with a drop bin, the same expert products and combine.
Parameters keep the reference's paths and scales, so
:mod:`repro_torch.bridge` copies them leaf for leaf.

Three choices hold the port to the reference's answers:

* top-k is a stable descending sort, so tied scores pick the lower expert
  id first, as ``lax.top_k`` does (``torch.topk`` promises no order);
* the dispatch follows the reference step for step (stable argsort by
  expert, rank within each expert by ``searchsorted``, assignments past
  the capacity C sent to a drop bin that is sliced off, a zero padding row
  at index T), so both drop the same assignments;
* the combine is deterministic: each token adds its own kept
  contributions one at a time, in ascending slot order (ascending expert
  id, the order in which the reference's scatter-add meets them), in the
  expert output's dtype, starting from a zero row.  ``index_add_`` on the
  card adds with atomics in no fixed order, so bf16 sums would change from
  run to run; here two calls on the same inputs give the same bits.

The expert products are batched matrix products, outside any kernel, as
the reference leaves them to XLA.  :func:`moe_apply` looks its steps
(:func:`route`, :func:`capacity`, :func:`dispatch`, :func:`experts`,
:func:`combine`) up at call time, so a check can wrap one of them or
plant a fault in it.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from .common import P, silu
from ..configs.config import ModelCfg
from ..sharding.ctx import constrain


def moe_specs(cfg: ModelCfg) -> Dict[str, P]:
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_expert, m.n_experts
    sp = {
        "router": P((d, E), ("embed", "expert"), scale=d ** -0.5),
        "wg": P((E, d, f), ("expert", "embed", "moe_mlp")),
        "wu": P((E, d, f), ("expert", "embed", "moe_mlp")),
        "wd": P((E, f, d), ("expert", "moe_mlp", "embed")),
    }
    if m.router_scale:  # DeepSeek aux-loss-free bias
        sp["router_bias"] = P((E,), ("expert",), "zeros",
                              dtype=torch.float32)
    if m.n_shared:
        fs = m.d_expert * m.n_shared
        sp["shared_wg"] = P((d, fs), ("embed", "mlp"))
        sp["shared_wu"] = P((d, fs), ("embed", "mlp"))
        sp["shared_wd"] = P((fs, d), ("mlp", "embed"))
    return sp


def top_k(x, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, ties to the lower
    index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, xf, cfg: ModelCfg):
    """xf: (T, d).  Returns (weights (T, k) float32, expert ids (T, k),
    probs (T, E) float32).  The router logits are float32 whatever the
    activations' dtype, as ``preferred_element_type`` makes them in the
    reference."""
    m = cfg.moe
    logits = xf.float() @ p["router"].float()
    if m.router_scale:            # DeepSeek-V3: sigmoid affinity + bias
        affin = torch.sigmoid(logits)
        _, gidx = top_k(affin + p["router_bias"], m.top_k)
        gval = torch.gather(affin, 1, gidx)
        weights = gval / (torch.sum(gval, dim=1, keepdim=True) + 1e-20)
        probs = affin / (torch.sum(affin, dim=-1, keepdim=True) + 1e-20)
    else:                         # Granite: softmax router
        probs = torch.softmax(logits, dim=-1)
        weights, gidx = top_k(probs, m.top_k)
        weights = weights / (torch.sum(weights, dim=1, keepdim=True) + 1e-20)
    return weights, gidx, probs


def aux_loss(gidx, probs, n_experts: int):
    """Load-balance aux loss: E * sum_e f_e * p_e, as the reference writes
    it (its ``* E / E`` included)."""
    T, k = gidx.shape
    E = n_experts
    ones = torch.zeros((T, E), dtype=torch.float32,
                       device=gidx.device).scatter(1, gidx, 1.0)
    f_e = torch.mean(ones, dim=0) * E / k
    p_e = torch.mean(probs, dim=0)
    return torch.sum(f_e * p_e) * E / E


def capacity(T: int, k: int, n_experts: int, factor: float) -> int:
    """Slots per expert: ceil(T k / E * capacity_factor), at least 1."""
    return int(max(1, math.ceil(T * k / n_experts * factor)))


class Dispatch(NamedTuple):
    """Where each assignment went.  ``table`` (E*C,): the token in each
    expert slot, T (the zero padding row) where empty; ``weights`` (E*C,)
    float32: its routing weight, 0 where empty; ``keep`` (T*k,): whether
    each assignment, in expert order, got a slot; ``token_slots`` (T, k):
    each token's slots in ascending order, E*C (a zero row) for a dropped
    one."""

    table: torch.Tensor
    weights: torch.Tensor
    keep: torch.Tensor
    token_slots: torch.Tensor


def dispatch(xf, gidx, weights, C: int,
             n_experts: int) -> Tuple[torch.Tensor, Dispatch]:
    """Sort-based capacity dispatch.  Returns the expert inputs (E, C, d)
    and the :class:`Dispatch` that the combine reads."""
    T, k = gidx.shape
    E, d, dev = n_experts, xf.shape[1], xf.device
    flat_e = gidx.reshape(T * k)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_w = weights.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    first = torch.searchsorted(se, se, side="left")
    pos_in_e = torch.arange(T * k, device=dev) - first  # rank within expert
    keep = pos_in_e < C
    slot = torch.where(keep, se * C + pos_in_e, E * C)  # E*C = drop bin
    table = torch.full((E * C + 1,), T, dtype=torch.long,
                       device=dev).scatter(0, slot, st)[:E * C]
    wtab = torch.zeros((E * C + 1,), dtype=torch.float32, device=dev
                       ).scatter(0, slot, torch.where(keep, sw, 0.0))[:E * C]
    token_slots = torch.empty_like(slot).scatter(0, order, slot)
    token_slots = torch.sort(token_slots.reshape(T, k), dim=1).values
    xg = torch.cat([xf, xf.new_zeros((1, d))])[table]
    xg = constrain(xg.reshape(E, C, d), ("expert", "capacity", "embed"))
    return xg, Dispatch(table, wtab, keep, token_slots)


def experts(p, xg):
    """The expert MLPs on their slots: (E, C, d) -> (E, C, d)."""
    h = silu(torch.bmm(xg, p["wg"])) * torch.bmm(xg, p["wu"])
    h = constrain(h, ("expert", "capacity", "moe_mlp"))
    return constrain(torch.bmm(h, p["wd"]), ("expert", "capacity", "embed"))


def combine(ye, disp: Dispatch):
    """Each token's weighted expert outputs, added one at a time in
    ascending slot order in ``ye.dtype``: (T, d), no atomics."""
    E, C, d = ye.shape
    yflat = ye.reshape(E * C, d) * disp.weights[:, None].to(ye.dtype)
    yflat = torch.cat([yflat, yflat.new_zeros((1, d))])  # the drop row
    T = disp.token_slots.shape[0]
    out = torch.zeros((T, d), dtype=ye.dtype, device=ye.device)
    for j in range(disp.token_slots.shape[1]):
        out = out + yflat[disp.token_slots[:, j]]
    return out


def moe_apply(p, x, *, cfg: ModelCfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_load_balance_loss)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    weights, gidx, probs = route(p, xf, cfg)
    aux = aux_loss(gidx, probs, m.n_experts)
    C = capacity(T, m.top_k, m.n_experts, m.capacity_factor)
    xg, disp = dispatch(xf, gidx, weights, C, m.n_experts)
    out = combine(experts(p, xg), disp)
    if m.n_shared:
        sh = silu(xf @ p["shared_wg"]) * (xf @ p["shared_wu"])
        out = out + sh @ p["shared_wd"]
    return out.reshape(B, S, d), aux
