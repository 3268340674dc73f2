"""Decoder-only LM assembly for the PyTorch port: segments, loss, decode.

The counterpart of ``repro.models.lm``.  A model is a sequence of
*segments*; each is a repeating unit of layer descriptors whose parameters
carry a leading ``layers`` axis when the unit repeats (the reference scans
over it; here a Python loop walks it).  Parameter and cache trees keep the
reference's paths and layouts, so :mod:`repro_torch.bridge` copies weights
leaf for leaf.

Mixers: ``attn`` and ``local`` (GQA) and ``mla`` (DeepSeek-V3's latent
attention), all in :mod:`.attention`, ``ssd`` (Mamba-2, :mod:`.mamba2`) and
``rglru`` (the RecurrentGemma recurrent block, :mod:`.rglru`); a layer's
MLP half is a dense MLP, a Mixture-of-Experts layer (:mod:`.moe`;
``dense_big`` for an MoE model's leading dense layers) or, for
``mlp == "none"`` (Mamba-2), absent.  DeepSeek-V3's multi-token prediction
(``mtp_depth``) adds one layer of the last layer's kind to the loss; the
serving path never reads it.  A vision frontend's stub patch embeddings
(``patch_embeds``, (B, P, d)) are a prefix: ``loss`` and ``prefill``
prepend them to the embedded tokens and run positions over P + S, and
``loss`` drops the first P hidden rows.  Encoder-decoder models are
:class:`repro_torch.models.encdec.EncDecLM`.

Remat, as the reference's ``jax.checkpoint`` of each ``_unit_body``: when
autograd is on and no cache is passed (training), each *unit* (the layers
of one repeat of a segment's unit) runs under
``torch.utils.checkpoint.checkpoint``.  ``cfg.remat == "full"`` saves
nothing inside a unit; ``"dots"`` saves the products against weights
(:func:`_dots_policy`) and recomputes the rest, attention included;
``"none"`` keeps every activation.  Prefill and decode never remat.
"""
from __future__ import annotations

import functools
import itertools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as attn
from . import mamba2 as m2
from . import moe
from . import rglru as rg
from .common import (P, SpecTrees, any_filled, gelu, init_tree, layer_norm,
                     rms_norm, silu, softcap, stack_spec)
from ..configs.config import ModelCfg
from ..sharding.ctx import constrain
from ..tree import tree_map

Desc = Tuple[str, str]  # (mixer kind, mlp kind)

_LATER = "{}: later slice of the port"


def build_segments(descs: List[Desc]) -> List[Tuple[Tuple[Desc, ...], int]]:
    """Factor a layer list into (unit, repeats) segments, greedily maximising
    unit*repeats coverage (unit length <= 8)."""
    segments = []
    i, n = 0, len(descs)
    while i < n:
        best = (1, 1)
        for u in range(1, 9):
            if i + u > n:
                break
            unit = descs[i:i + u]
            r = 1
            while (i + (r + 1) * u <= n
                   and descs[i + r * u:i + (r + 1) * u] == unit):
                r += 1
            if u * r > best[0] * best[1]:
                best = (u, r)
        u, r = best
        segments.append((tuple(descs[i:i + u]), r))
        i += u * r
    return segments


# --------------------------------------------------------------- norms/mlp
def norm_specs(cfg: ModelCfg) -> Dict[str, P]:
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"w": P((d,), ("embed",), "ones"),
                "b": P((d,), ("embed",), "zeros")}
    init = "zeros" if cfg.norm_plus_one else "ones"
    return {"w": P((d,), ("embed",), init)}


def norm_apply(p, x, cfg: ModelCfg):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"], plus_one=cfg.norm_plus_one)


def mlp_specs(cfg: ModelCfg) -> Dict[str, P]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp in ("gated_silu", "gated_gelu"):
        return {"wg": P((d, f), ("embed", "mlp")),
                "wu": P((d, f), ("embed", "mlp")),
                "wd": P((f, d), ("mlp", "embed"))}
    sp = {"w1": P((d, f), ("embed", "mlp")),
          "w2": P((f, d), ("mlp", "embed"))}
    if cfg.bias:
        sp["b1"] = P((f,), ("mlp",), "zeros")
        sp["b2"] = P((d,), ("embed",), "zeros")
    return sp


def mlp_apply(p, x, cfg: ModelCfg):
    if cfg.mlp in ("gated_silu", "gated_gelu"):
        act = silu if cfg.mlp == "gated_silu" else gelu
        h = act(x @ p["wg"]) * (x @ p["wu"])
        return constrain(h, ("batch", "seq", "mlp")) @ p["wd"]
    h = x @ p["w1"]
    if cfg.bias:
        h = h + p["b1"]
    h = constrain(gelu(h), ("batch", "seq", "mlp")) @ p["w2"]
    if cfg.bias:
        h = h + p["b2"]
    return h


# ------------------------------------------------------------------ layers
MIXER_SPECS = {
    "attn": attn.gqa_specs,
    "local": attn.gqa_specs,
    "mla": attn.mla_specs,
    "ssd": m2.mamba2_specs,
    "rglru": rg.rglru_specs,
}
_MLPS = ("gated_silu", "gated_gelu", "gelu", "none", "moe", "dense_big")


def layer_specs(cfg: ModelCfg, desc: Desc) -> Dict[str, Any]:
    mixer, mlp_kind = desc
    if mixer not in MIXER_SPECS:
        raise NotImplementedError(_LATER.format(f"mixer {mixer!r}"))
    if mlp_kind not in _MLPS:
        raise NotImplementedError(_LATER.format(f"mlp {mlp_kind!r}"))
    sp: Dict[str, Any] = {"ln1": norm_specs(cfg),
                          "mix": MIXER_SPECS[mixer](cfg)}
    if mlp_kind != "none":  # mamba2: the block IS the layer, no FFN half
        sp["ln2"] = norm_specs(cfg)
        sp["mlp"] = (moe.moe_specs(cfg) if mlp_kind == "moe"
                     else mlp_specs(_ff_cfg(cfg, mlp_kind)))
    if cfg.post_norms:
        sp["ln1p"] = norm_specs(cfg)
        if mlp_kind != "none":
            sp["ln2p"] = norm_specs(cfg)
    return sp


def _ff_cfg(cfg: ModelCfg, mlp_kind: str) -> ModelCfg:
    """The config of a dense MLP half: an MoE model's leading dense layers
    (``dense_big``) take ``d_ff_dense``."""
    if mlp_kind == "dense_big" and cfg.moe is not None:
        return cfg.replace(d_ff=cfg.moe.d_ff_dense)
    return cfg


def mixer_apply(kind: str, p, x, *, cfg: ModelCfg, positions, cache,
                fresh_cache: bool = False):
    if kind in ("attn", "local"):
        return attn.gqa_apply(p, x, cfg=cfg, kind=kind, positions=positions,
                              cache=cache, fresh_cache=fresh_cache)
    if kind == "mla":
        return attn.mla_apply(p, x, cfg=cfg, positions=positions,
                              cache=cache, fresh_cache=fresh_cache)
    if kind == "ssd":
        return m2.mamba2_apply(p, x, cfg=cfg, cache=cache)
    if kind == "rglru":
        return rg.rglru_apply(p, x, cfg=cfg, cache=cache)
    raise NotImplementedError(_LATER.format(f"mixer {kind!r}"))


def layer_apply(lp, x, *, cfg: ModelCfg, desc: Desc, positions, cache,
                fresh_cache: bool = False):
    """One layer.  Returns (x, cache, aux): aux is the MoE layer's
    load-balance loss, None for other layers (the reference's zero)."""
    mixer, mlp_kind = desc
    h = norm_apply(lp["ln1"], x, cfg)
    mix, new_cache = mixer_apply(mixer, lp["mix"], h, cfg=cfg,
                                 positions=positions, cache=cache,
                                 fresh_cache=fresh_cache)
    if cfg.post_norms:
        mix = norm_apply(lp["ln1p"], mix, cfg)
    x = constrain(x + mix, ("batch", "residual_seq", "embed"))
    aux = None
    if mlp_kind == "none":
        return x, new_cache, aux
    h = norm_apply(lp["ln2"], x, cfg)
    if mlp_kind == "moe":
        out, aux = moe.moe_apply(lp["mlp"], h, cfg=cfg)
    else:
        out = mlp_apply(lp["mlp"], h, _ff_cfg(cfg, mlp_kind))
    if cfg.post_norms:
        out = norm_apply(lp["ln2p"], out, cfg)
    return (constrain(x + out, ("batch", "residual_seq", "embed")),
            new_cache, aux)


def _unit_apply(x, aux, layers, cfg: ModelCfg, positions, fresh_cache):
    """The layers of one unit in order, as the reference's ``_unit_body``:
    ``layers`` holds (desc, params, cache) a layer; aux adds up their MoE
    losses.  Returns (x, aux)."""
    for desc, lp, cache in layers:
        x, _, a = layer_apply(lp, x, cfg=cfg, desc=desc, positions=positions,
                              cache=cache, fresh_cache=fresh_cache)
        if a is not None:
            aux = aux + a
    return x, aux


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(weights):
    """remat "dots": the reference's ``dots_with_no_batch_dims_saveable``
    as a selective-checkpoint policy.  ``torch.einsum`` lowers a product
    against a weight and attention's q.k and p.v alike to ``bmm`` (batch 1
    at B = KH = 1, as gemma3-1b trains), so the op and its shapes cannot
    tell them apart.  What does is an operand: a product against a weight
    takes a view of a parameter (its storage is one of ``weights``, the
    parameters' storages) with no batch axis of its own (2-d, a batch of
    1, or a batch stride of 0); attention contracts two activations, and
    the MoE's per-expert products carry the expert axis as a batch, as in
    JAX.  Those outputs are saved, everything else recomputed.  A product
    against a cast copy of a weight (the bf16 models' float32 router and
    gate products) is recomputed, where JAX would save it."""
    def weight(t):
        return (isinstance(t, torch.Tensor)
                and t.untyped_storage().data_ptr() in weights
                and (t.dim() == 2 or t.shape[0] == 1 or t.stride(0) == 0))

    def policy(ctx, op, *args, **kwargs):
        if op in _PRODUCTS and any(weight(a) for a in args):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def mixer_cache_spec(cfg: ModelCfg, kind: str, batch: int, max_len: int):
    if kind in ("attn", "local"):
        return attn.gqa_cache_spec(cfg, kind, batch, max_len)
    if kind == "mla":
        return attn.mla_cache_spec(cfg, batch, max_len)
    if kind == "ssd":
        return m2.mamba2_cache_spec(cfg, batch)
    if kind == "rglru":
        return rg.rglru_cache_spec(cfg, batch)
    raise NotImplementedError(_LATER.format(f"{kind!r} cache"))


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dict nodes become submodules
    and leaves become parameters, under the reference's path names
    (``seg0.u0.mix.wq`` in ``state_dict``).  ``tree["mix"]["wq"]`` reads a
    leaf, so the numerics take it where the reference takes a dict."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=val.is_floating_point()))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def keys(self):
        return list(self._parameters) + list(self._modules)

    def to_dict(self) -> Dict[str, Any]:
        """The tree as nested dicts of the live parameters."""
        out: Dict[str, Any] = dict(self._parameters)
        for key, mod in self._modules.items():
            out[key] = mod.to_dict()
        return out


def _index(tree, i: int):
    """Slice layer ``i`` off every leaf of a stacked tree (views)."""
    if isinstance(tree, (dict, ParamTree)):
        return {k: _index(tree[k], i) for k in tree.keys()}
    return tree[i]


# ---------------------------------------------------------------- the model
class TransformerLM(SpecTrees, nn.Module):
    """Decoder-only LM (the dense attention families, Mamba-2,
    RecurrentGemma, Granite-MoE and DeepSeek-V3)."""

    def __init__(self, cfg: ModelCfg):
        super().__init__()
        if cfg.encdec:
            raise ValueError(f"{cfg.name}: an encoder-decoder config "
                             f"builds EncDecLM")
        self.cfg = cfg
        self.descs = self._descs()
        self.segments = build_segments(self.descs)
        self.params: Optional[ParamTree] = None
        self._layer_views: Optional[list] = None

    def _descs(self) -> List[Desc]:
        cfg = self.cfg
        descs = []
        for i, k in enumerate(cfg.layer_kinds()):
            if cfg.moe is not None:
                mlp_kind = "dense_big" if i < cfg.moe.first_dense else "moe"
            else:
                mlp_kind = cfg.mlp
            descs.append((k, mlp_kind))
        return descs

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    # -- specs / parameters --------------------------------------------------
    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        specs: Dict[str, Any] = {
            "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed_tbl"),
                       "embed", scale=cfg.d_model ** -0.5),
            "final_norm": norm_specs(cfg),
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = P((cfg.d_model, cfg.vocab),
                                 ("embed_tbl", "vocab"))
        for si, (unit, reps) in enumerate(self.segments):
            seg: Dict[str, Any] = {}
            for ui, desc in enumerate(unit):
                ls = layer_specs(cfg, desc)
                seg[f"u{ui}"] = stack_spec(ls, reps) if reps > 1 else ls
            specs[f"seg{si}"] = seg
        if cfg.mtp_depth:
            specs["mtp"] = {
                "proj": P((2 * cfg.d_model, cfg.d_model), ("mlp", "embed")),
                "norm_h": norm_specs(cfg),
                "norm_e": norm_specs(cfg),
                "layer": layer_specs(cfg, self.descs[-1]),
            }
        return specs

    def init(self, generator: torch.Generator, device=None
             ) -> "TransformerLM":
        """Materialise seeded parameters on ``device`` (the generator's
        device by default)."""
        device = device if device is not None else generator.device
        return self.set_params(init_tree(self.param_specs(), generator,
                                         self.dtype, device))

    def set_params(self, tree: Dict[str, Any]) -> "TransformerLM":
        """Install a parameter tree (nested dicts of tensors, the
        reference's paths)."""
        self.params = ParamTree(tree)
        self._layer_views = None
        return self

    def layer_params(self) -> List[Tuple[int, int, int, Dict[str, Any]]]:
        """``(segment, unit, rep, params)`` per layer in execution order,
        stacked leaves sliced into per-layer views.  Without autograd the
        views are made once and kept; with it they are made per call, so
        each backward reaches the stacked parameters."""
        if torch.is_grad_enabled():
            return self._slice_layers()
        if self._layer_views is None:
            self._layer_views = self._slice_layers()
        return self._layer_views

    def _slice_layers(self):
        views = []
        for si, (unit, reps) in enumerate(self.segments):
            seg = self.params[f"seg{si}"]
            for r in range(reps):
                for ui in range(len(unit)):
                    up = seg[f"u{ui}"]
                    views.append((si, ui, r, _index(up, r) if reps > 1
                                  else up.to_dict()))
        return views

    # -- forward ---------------------------------------------------------------
    def embed(self, tokens):
        x = self.params["embed"][tokens]
        if self.cfg.scale_embed:
            # sqrt(d) is cast to the activation dtype first, as in the
            # reference (in bf16, 33.94 becomes 33.75)
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def forward(self, x, *, positions, caches=None, fresh_cache=False):
        """x: embedded inputs (B, S, d).  Returns (hidden, caches, aux):
        aux is the layers' MoE load-balance losses summed in layer order.

        caches: list per segment of per-unit cache trees (with a leading
        ``layers`` axis when the segment repeats), updated in place, or
        None for training."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = (cfg.remat != "none" and caches is None
                 and torch.is_grad_enabled())
        kw = dict(use_reentrant=False)
        if remat and cfg.remat == "dots":
            weights = {p.untyped_storage().data_ptr()
                       for p in self.params.parameters()}
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _dots_policy(weights))
        elif remat and cfg.remat != "full":
            raise ValueError(f"remat {cfg.remat!r}: not full, dots or none")
        for (si, r), views in itertools.groupby(self.layer_params(),
                                                key=lambda v: (v[0], v[2])):
            unit, reps = self.segments[si]
            layers = []
            for _, ui, _, lp in views:
                cache = None
                if caches is not None:
                    cache = caches[si][ui]
                    if reps > 1:
                        cache = _index(cache, r)
                layers.append((unit[ui], lp, cache))
            args = (x, aux, layers, cfg, positions, fresh_cache)
            x, aux = (checkpoint(_unit_apply, *args, **kw) if remat
                      else _unit_apply(*args))
        x = norm_apply(self.params["final_norm"], x, cfg)
        return x, caches, aux

    def logits(self, hidden):
        if self.cfg.tie_embeddings:
            lg = torch.einsum("bsd,vd->bsv", hidden, self.params["embed"])
        else:
            lg = torch.einsum("bsd,dv->bsv", hidden, self.params["lm_head"])
        return constrain(softcap(lg, self.cfg.final_softcap),
                         ("batch", "seq", "vocab"))

    def _positions(self, tokens):
        B, S = tokens.shape[:2]
        return torch.arange(S, dtype=torch.int32,
                            device=tokens.device)[None].expand(B, S)

    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {'tokens': (B,S), 'labels': (B,S)} integer tensors, and
        for a vision frontend 'patch_embeds': (B, P, d), whose P hidden rows
        are dropped before the logits."""
        tokens = batch["tokens"]
        x = self.embed(tokens)
        offset = 0
        if self.cfg.frontend == "vision":
            pe = batch["patch_embeds"]
            x = torch.cat([pe.to(x.dtype), x], dim=1)
            offset = pe.shape[1]
        h, _, aux = self.forward(x, positions=self._positions(x))
        h = h[:, offset:]
        ce = _xent(self.logits(h), batch["labels"])
        loss, metrics = ce + 0.001 * aux, {"ce": ce, "aux": aux}
        if self.cfg.mtp_depth:
            mtp = self._mtp_loss(h, tokens, batch["labels"])
            loss, metrics["mtp"] = loss + 0.3 * mtp, mtp
        return loss, metrics

    def _mtp_loss(self, h, tokens, labels):
        """DeepSeek-V3 multi-token prediction (depth 1): predict token
        t + 2 from the trunk's final state at t joined with the embedding
        of token t + 1, through one layer of the last layer's kind (its
        MoE aux loss left out, as in the reference)."""
        cfg, mp = self.cfg, self.params["mtp"]
        h_in = norm_apply(mp["norm_h"], h[:, :-1], cfg)
        e_in = norm_apply(mp["norm_e"], self.embed(tokens[:, 1:]), cfg)
        x = torch.cat([h_in, e_in], dim=-1) @ mp["proj"]
        x2, _, _ = layer_apply(mp["layer"].to_dict(), x, cfg=cfg,
                               desc=self.descs[-1],
                               positions=self._positions(tokens[:, 1:]),
                               cache=None)
        lg = self.logits(norm_apply(self.params["final_norm"], x2, cfg))
        return _xent(lg[:, :-1], labels[:, 2:])

    # -- serving -----------------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int):
        segs = []
        for (unit, reps) in self.segments:
            us = []
            for desc in unit:
                cs = mixer_cache_spec(self.cfg, desc[0], batch, max_len)
                us.append(stack_spec(cs, reps) if reps > 1 else cs)
            segs.append(us)
        return segs

    def init_cache(self, batch: int, max_len: int, device=None):
        """Zeroed caches with every slot marked empty (pos = -1)."""
        if device is None:
            device = self.params["embed"].device
        specs = self.cache_specs(batch, max_len)
        return tree_map(
            lambda s: torch.full(s.shape, -1 if s.dtype == torch.int32 else 0,
                                 dtype=s.dtype or self.dtype, device=device),
            specs)

    def prefill(self, tokens, caches, *, patch_embeds=None):
        """Forward over a prompt from position 0 (a vision frontend's
        ``patch_embeds`` (B, P, d) first, where given); returns
        (last_logits, caches).  Attention caches must be empty
        (``init_cache``), else ValueError: attention then runs as causal
        self-attention over the prompt, which is what attending over an
        empty cache is.  A prompt (prefix included) longer than an
        attention cache is refused too, before any layer writes its cache.
        An SSD or RG-LRU cache needs no check: its scan continues from
        whatever state the cache holds, as the reference's does."""
        attn = [u for seg in caches for u in seg if "pos" in u]
        if any_filled(u["pos"] for u in attn):
            raise ValueError("prefill needs empty caches (init_cache)")
        # every attention cache (GQA K/V, MLA latent) has pos (..., B, L)
        x = self.embed(tokens)
        if self.cfg.frontend == "vision" and patch_embeds is not None:
            x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
        L = min((u["pos"].shape[-1] for u in attn), default=None)
        if L is not None and x.shape[1] > L:
            raise ValueError(f"{x.shape[1]} tokens do not fit an "
                             f"attention cache of length {L}")
        h, caches, _ = self.forward(x, positions=self._positions(x),
                                    caches=caches, fresh_cache=True)
        return self.logits(h[:, -1:]), caches

    def decode_step(self, caches, tokens, pos):
        """One decode step.  tokens: (B,1); pos: (B,1) absolute positions."""
        x = self.embed(tokens)
        h, caches, _ = self.forward(x, positions=pos, caches=caches)
        return self.logits(h), caches


def _xent(logits, labels):
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - ll)
