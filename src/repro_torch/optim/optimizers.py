"""Optimizers: AdamW, int8-moment AdamW, Adafactor, SGD-momentum.

The counterpart of ``repro.optim.optimizers``.  Parameters, gradients and
states are nested dicts of tensors on one device; a state mirrors the
parameter tree under the reference's paths (``{"mu": {<param path>: {"m",
"v"[, "m_s", "v_s", "master"]}}, "count"}`` for AdamW), so a checkpoint of
either package restores path for path in the other.  The cast points are the
reference's: the global norm and every update in float32, ``b1 ** count`` in
float32, decay only where ``p.ndim >= 2``, int8 moments rounded half to even
(``torch.round``, as ``jnp.round``), new parameters cast back to their dtype.

``update`` returns new tensors and leaves its inputs untouched, as the
reference's functional update does.  ``abstract_state`` is ``init`` on the
parameters' meta copies (nothing is allocated), ``state_axes`` the state's
logical axes from the parameters', under the reference's paths: both serve
the dry-run (``launch/cells.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ..tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptCfg:
    name: str = "adamw"          # adamw | adamw8 | adafactor | sgdm
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0
    master_fp32: bool = False    # keep fp32 master copy of bf16 params


@dataclasses.dataclass
class Optimizer:
    cfg: OptCfg
    init: Callable[[Any], Any]
    abstract_state: Callable[[Any], Any]
    state_axes: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any, Any]]


def _abstract(init):
    """``init`` on meta copies of the parameters: the state's tree, shapes
    and dtypes, allocating nothing."""
    return lambda aparams: init(tree_map(lambda p: p.to("meta"), aparams))


def _state_axes(leaf):
    """{"mu": ``leaf`` of each parameter's axes, "count": ()}."""
    return lambda param_axes: {"mu": tree_map(leaf, param_axes),
                               "count": ()}


def _lr(cfg: OptCfg, step):
    from .schedules import cosine_schedule
    return cosine_schedule(step, peak=cfg.peak_lr, warmup=cfg.warmup,
                           total=cfg.total_steps)


def _global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _clipped(cfg: OptCfg, grads):
    if cfg.clip_norm is None:
        return grads, torch.zeros(())
    g = _global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (g + 1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), grads), g


def _split(flat):
    """{path: (new_param, new_state)} -> (params, mu)."""
    return (tree_map(lambda t: t[0], flat), tree_map(lambda t: t[1], flat))


# ---------------------------------------------------------------- quantised
def _q8(x32):
    amax = torch.max(torch.abs(x32)) + 1e-12
    q = torch.round(x32 / amax * 127.0).to(torch.int8)
    return q, amax.float()


def _dq8(q, amax):
    return q.float() * (amax / 127.0)


def make_optimizer(cfg: OptCfg) -> Optimizer:
    if cfg.name in ("adamw", "adamw8"):
        return _adamw(cfg, quantised=cfg.name == "adamw8")
    if cfg.name == "adafactor":
        return _adafactor(cfg)
    if cfg.name == "sgdm":
        return _sgdm(cfg)
    raise ValueError(cfg.name)


def _zeros(shape, p, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=p.device)


def _count0(params):
    leaf = tree_leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


# ------------------------------------------------------------------- adamw
def _adamw(cfg: OptCfg, quantised: bool) -> Optimizer:
    def init(params):
        def leaf(p):
            if quantised:
                z8 = _zeros(p.shape, p, torch.int8)
                sc = _zeros((), p)
                st = {"m": z8, "m_s": sc, "v": z8.clone(), "v_s": sc.clone()}
            else:
                st = {"m": _zeros(p.shape, p), "v": _zeros(p.shape, p)}
            if cfg.master_fp32:
                st["master"] = p.float().clone()
            return st
        return {"mu": tree_map(leaf, params), "count": _count0(params)}

    def update(grads, state, params, step):
        cnt = state["count"] + 1
        lr = _lr(cfg, step)
        grads, gnorm = _clipped(cfg, grads)
        b1c = 1 - cfg.b1 ** cnt.float()
        b2c = 1 - cfg.b2 ** cnt.float()

        def leaf(g, st, p):
            g32 = g.float()
            if quantised:
                m = _dq8(st["m"], st["m_s"])
                v = _dq8(st["v"], st["v_s"])
            else:
                m, v = st["m"], st["v"]
            m = cfg.b1 * m + (1 - cfg.b1) * g32
            v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
            upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            base = st["master"] if cfg.master_fp32 else p.float()
            decay = cfg.weight_decay if p.dim() >= 2 else 0.0
            new = base - lr * (upd + decay * base)
            out = {}
            if quantised:
                out["m"], out["m_s"] = _q8(m)
                out["v"], out["v_s"] = _q8(v)
            else:
                out["m"], out["v"] = m, v
            if cfg.master_fp32:
                out["master"] = new
            return new.to(p.dtype), out

        new_params, new_mu = _split(tree_map(
            leaf, grads, state["mu"], params))
        metrics = {"grad_norm": gnorm, "lr": lr}
        return new_params, {"mu": new_mu, "count": cnt}, metrics

    def axes(ax):
        st = ({"m": ax, "m_s": (), "v": ax, "v_s": ()} if quantised
              else {"m": ax, "v": ax})
        if cfg.master_fp32:
            st["master"] = ax
        return st

    return Optimizer(cfg, init, _abstract(init), _state_axes(axes), update)


# ---------------------------------------------------------------- adafactor
def _adafactor(cfg: OptCfg) -> Optimizer:
    def init(params):
        def leaf(p):
            if p.dim() < 2:
                return {"v": _zeros(p.shape, p)}
            return {"vr": _zeros(p.shape[:-1], p),
                    "vc": _zeros(p.shape[:-2] + p.shape[-1:], p)}
        return {"mu": tree_map(leaf, params), "count": _count0(params)}

    def update(grads, state, params, step):
        cnt = state["count"] + 1
        lr = _lr(cfg, step)
        grads, gnorm = _clipped(cfg, grads)
        decay = 1.0 - cnt.float() ** -0.8

        def leaf(g, st, p):
            g32 = g.float()
            g2 = torch.square(g32) + 1e-30
            if "v" in st:
                v = decay * st["v"] + (1 - decay) * g2
                upd = g32 * torch.rsqrt(v + cfg.eps)
                new_st = {"v": v}
            else:
                vr = decay * st["vr"] + (1 - decay) * torch.mean(g2, dim=-1)
                vc = decay * st["vc"] + (1 - decay) * torch.mean(g2, dim=-2)
                denom = vr / torch.mean(vr, dim=-1, keepdim=True) + 1e-30
                pre = (torch.rsqrt(denom)[..., None]
                       * torch.rsqrt(vc + 1e-30)[..., None, :])
                upd = g32 * pre
                new_st = {"vr": vr, "vc": vc}
            # update clipping (Adafactor RMS rule)
            rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-30)
            upd = upd / torch.clamp(rms, min=1.0)
            base = p.float()
            wd = cfg.weight_decay if p.dim() >= 2 else 0.0
            new = base - lr * (upd + wd * base)
            return new.to(p.dtype), new_st

        new_params, new_mu = _split(tree_map(
            leaf, grads, state["mu"], params))
        return new_params, {"mu": new_mu, "count": cnt}, \
            {"grad_norm": gnorm, "lr": lr}

    def axes(ax):
        if len(ax) < 2:
            return {"v": ax}
        return {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}

    return Optimizer(cfg, init, _abstract(init), _state_axes(axes), update)


# -------------------------------------------------------------------- sgdm
def _sgdm(cfg: OptCfg) -> Optimizer:
    def init(params):
        return {"mu": tree_map(lambda p: {"m": _zeros(p.shape, p)}, params),
                "count": _count0(params)}

    def update(grads, state, params, step):
        cnt = state["count"] + 1
        lr = _lr(cfg, step)
        grads, gnorm = _clipped(cfg, grads)

        def leaf(g, st, p):
            m = cfg.b1 * st["m"] + g.float()
            new = p.float() - lr * m
            return new.to(p.dtype), {"m": m}

        new_params, new_mu = _split(tree_map(
            leaf, grads, state["mu"], params))
        return new_params, {"mu": new_mu, "count": cnt}, \
            {"grad_norm": gnorm, "lr": lr}

    return Optimizer(cfg, init, _abstract(init),
                     _state_axes(lambda ax: {"m": ax}), update)
