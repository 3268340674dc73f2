"""Encoder-decoder LM (the Whisper-family backbone) for the PyTorch port.

The counterpart of ``repro.models.encdec``.  The audio conv frontend is a
stub, as in the reference: the caller passes precomputed frame embeddings
(B, S_enc, d).  Sinusoidal positions are added on both stacks.  The
parameter tree keeps the reference's paths: ``embed`` (tied with the
output), the ``enc`` and ``dec`` stacks with a leading ``layers`` axis, and
``enc_norm`` / ``dec_norm``, so :mod:`repro_torch.bridge` copies weights
leaf for leaf.

Which attention runs:

* the encoder's self-attention is not causal (``kind="enc"``): through the
  flash kernel's non-causal branch under ``cfg.attn_impl == "kernel"``,
  else plain (``attention._train_attention``);
* the decoder's self-attention is causal, routed as a decoder-only model's
  (no cache: ``_train_attention``; a fresh cache in ``prefill``: the flash
  kernel; decode: ``ref_attention`` over the cache);
* cross-attention is plain ``ref_attention`` over the encoder's K/V, as in
  the reference (the kernel takes one length for q and k).

Two behaviours of the reference are kept as they are: ``decode`` adds the
sinusoid rows of row 0's positions to every row (``positions[0]``), and
under any ``remat`` but "none" every encoder and decoder layer is
recomputed whole in the backward (its ``nothing_saveable``, so "dots"
acts as "full"); here through ``torch.utils.checkpoint`` per layer, when
autograd is on and no cache is passed.

A model holds its position tables as buffers on its parameters' device:
the decoder's (``max_target_length`` x d), built when its parameters are
set, and the encoder's, built for the frame count of the first call and
again only when that count changes.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from .common import (P, SpecTrees, any_filled, init_tree, sinusoid_positions,
                     stack_spec)
from .lm import (ParamTree, _index, _xent, mlp_apply, mlp_specs, norm_apply,
                 norm_specs)
from ..configs.config import ModelCfg
from ..sharding.ctx import constrain
from ..tree import tree_map


def cross_attn_specs(cfg: ModelCfg) -> Dict[str, P]:
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": P((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, KH, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, KH, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((H, hd, d), ("heads", "head_dim", "embed")),
    }


def cross_attn_apply(p, x, enc_kv, *, cfg: ModelCfg):
    """enc_kv: (k, v) precomputed from the encoder's output, (B, Sk, KH,
    hd) each.  Every query sees every key: q_pos = Sk, k_pos = 0."""
    k, v = enc_kv
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    q_pos = torch.full((B, Sq), Sk, dtype=torch.int32, device=x.device)
    k_pos = torch.zeros((B, Sk), dtype=torch.int32, device=x.device)
    out = attn.ref_attention(q, k, v, scale=cfg.hd ** -0.5, q_pos=q_pos,
                             k_pos=k_pos, window=None, cap=None)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def enc_kv(p, enc_out):
    """Cross-attention K and V of the encoder's output (B, S, d).  ``p``
    holds ``wk``/``wv`` of one layer (d, KH, hd), giving (B, S, KH, hd),
    or of a stack (n, d, KH, hd), giving (n, B, S, KH, hd), as the
    reference's ``vmap`` over the layers axis does."""
    return (torch.einsum("bsd,...dhk->...bshk", enc_out, p["wk"]),
            torch.einsum("bsd,...dhk->...bshk", enc_out, p["wv"]))


def _position_table(length: int, dim: int, device) -> torch.Tensor:
    # a normal tensor (not an inference tensor) wherever it is first made,
    # so that a later training step may read it
    with torch.inference_mode(False), torch.no_grad():
        return sinusoid_positions(length, dim, device=device)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B,
                                                                          S)


class EncDecLM(SpecTrees, nn.Module):
    """Whisper-shaped encoder-decoder transformer; ``n_layers`` per
    stack."""

    def __init__(self, cfg: ModelCfg):
        super().__init__()
        if not cfg.encdec:
            raise ValueError(f"{cfg.name}: not an encoder-decoder config")
        self.cfg = cfg
        self.params: Optional[ParamTree] = None
        self._layer_views: Dict[str, list] = {}
        self.register_buffer("dec_positions", None, persistent=False)
        self.register_buffer("enc_positions", None, persistent=False)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    # -- specs / parameters --------------------------------------------------
    def _enc_layer(self):
        cfg = self.cfg
        return {"ln1": norm_specs(cfg), "mix": attn.gqa_specs(cfg),
                "ln2": norm_specs(cfg), "mlp": mlp_specs(cfg)}

    def _dec_layer(self):
        cfg = self.cfg
        return {"ln1": norm_specs(cfg), "self": attn.gqa_specs(cfg),
                "lnx": norm_specs(cfg), "cross": cross_attn_specs(cfg),
                "ln2": norm_specs(cfg), "mlp": mlp_specs(cfg)}

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        n = cfg.n_layers
        return {
            "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed_tbl"),
                       "embed", scale=cfg.d_model ** -0.5),
            "enc": stack_spec(self._enc_layer(), n),
            "enc_norm": norm_specs(cfg),
            "dec": stack_spec(self._dec_layer(), n),
            "dec_norm": norm_specs(cfg),
        }

    def init(self, generator: torch.Generator, device=None) -> "EncDecLM":
        """Materialise seeded parameters on ``device`` (the generator's
        device by default)."""
        device = device if device is not None else generator.device
        return self.set_params(init_tree(self.param_specs(), generator,
                                         self.dtype, device))

    def set_params(self, tree: Dict[str, Any]) -> "EncDecLM":
        """Install a parameter tree (nested dicts of tensors, the
        reference's paths), and the decoder's position table on its
        device."""
        self.params = ParamTree(tree)
        self._layer_views = {}
        self.dec_positions = _position_table(
            self.cfg.max_target_length, self.cfg.d_model,
            self.params["embed"].device)
        return self

    def layer_params(self, stack: str):
        """Per-layer views of the ``enc`` or ``dec`` stack; kept without
        autograd, made per call with it (as ``TransformerLM``'s)."""
        if torch.is_grad_enabled():
            return [_index(self.params[stack], i)
                    for i in range(self.cfg.n_layers)]
        if stack not in self._layer_views:
            self._layer_views[stack] = [_index(self.params[stack], i)
                                        for i in range(self.cfg.n_layers)]
        return self._layer_views[stack]

    def _remat(self, caches) -> bool:
        return (self.cfg.remat != "none" and caches is None
                and torch.is_grad_enabled())

    # -- encoder -------------------------------------------------------------
    def _enc_body(self, x, lp, positions):
        cfg = self.cfg
        h = norm_apply(lp["ln1"], x, cfg)
        mix, _ = attn.gqa_apply(lp["mix"], h, cfg=cfg, kind="enc",
                                positions=positions, cache=None)
        x = x + mix
        h = norm_apply(lp["ln2"], x, cfg)
        return constrain(x + mlp_apply(lp["mlp"], h, cfg),
                         ("batch", "seq", "embed"))

    def encode(self, frame_embeds):
        """frame_embeds: (B, S, d) stub frontend output -> (B, S, d)."""
        cfg = self.cfg
        B, S, _ = frame_embeds.shape
        x = frame_embeds.to(self.dtype)
        table = self.enc_positions
        if table is None or table.shape[0] != S or table.device != x.device:
            table = self.enc_positions = _position_table(S, cfg.d_model,
                                                         x.device)
        x = x + table.to(x.dtype)
        positions = _positions(B, S, x.device)
        remat = self._remat(None)
        for lp in self.layer_params("enc"):
            x = (checkpoint(self._enc_body, x, lp, positions,
                            use_reentrant=False) if remat
                 else self._enc_body(x, lp, positions))
        return norm_apply(self.params["enc_norm"], x, cfg)

    # -- decoder -------------------------------------------------------------
    def _dec_body(self, x, lp, kv, cache, positions, fresh_cache):
        cfg = self.cfg
        h = norm_apply(lp["ln1"], x, cfg)
        mix, _ = attn.gqa_apply(lp["self"], h, cfg=cfg, kind="attn",
                                positions=positions, cache=cache,
                                fresh_cache=fresh_cache)
        x = x + mix
        h = norm_apply(lp["lnx"], x, cfg)
        x = x + cross_attn_apply(lp["cross"], h, kv, cfg=cfg)
        h = norm_apply(lp["ln2"], x, cfg)
        return constrain(x + mlp_apply(lp["mlp"], h, cfg),
                         ("batch", "seq", "embed"))

    def cross_kv(self, enc_out):
        """Every decoder layer's cross-attention (k, v), stacked: (n, B,
        S_enc, KH, hd) each."""
        return enc_kv(self.params["dec"]["cross"], enc_out)

    def decode(self, tokens, enc_out, *, positions, caches=None,
               cross_kv=None, fresh_cache=False):
        """Returns (logits, caches, cross_kv).  caches: the stacked
        self-attention cache (``init_cache``), written in place, or None
        (training).  Every row takes the sinusoid rows of row 0's
        positions, as in the reference."""
        cfg = self.cfg
        x = self.params["embed"][tokens]
        x = x + self.dec_positions[positions[0].long()].to(x.dtype)
        if cross_kv is None:
            cross_kv = self.cross_kv(enc_out)
        ck, cv = cross_kv
        remat = self._remat(caches)
        for i, lp in enumerate(self.layer_params("dec")):
            cache = None if caches is None else _index(caches, i)
            args = (x, lp, (ck[i], cv[i]), cache, positions, fresh_cache)
            x = (checkpoint(self._dec_body, *args, use_reentrant=False)
                 if remat else self._dec_body(*args))
        x = norm_apply(self.params["dec_norm"], x, cfg)
        lg = torch.einsum("bsd,vd->bsv", x, self.params["embed"])
        return constrain(lg, ("batch", "seq", "vocab")), caches, cross_kv

    # -- public API (mirrors TransformerLM) ----------------------------------
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {'tokens', 'labels': (B, S) integer tensors,
        'frame_embeds': (B, S_enc, d)}."""
        enc_out = self.encode(batch["frame_embeds"])
        tokens = batch["tokens"]
        B, S = tokens.shape
        lg, _, _ = self.decode(tokens, enc_out,
                               positions=_positions(B, S, tokens.device))
        ce = _xent(lg, batch["labels"])
        return ce, {"ce": ce}

    def cache_specs(self, batch: int, max_len: int):
        return stack_spec(attn.gqa_cache_spec(self.cfg, "attn", batch,
                                              max_len), self.cfg.n_layers)

    def init_cache(self, batch: int, max_len: int, device=None):
        """The decoder's zeroed self-attention cache, every slot marked
        empty (pos = -1)."""
        if device is None:
            device = self.params["embed"].device
        return tree_map(
            lambda s: torch.full(s.shape, -1 if s.dtype == torch.int32 else 0,
                                 dtype=s.dtype or self.dtype, device=device),
            self.cache_specs(batch, max_len))

    def prefill(self, tokens, caches, *, frame_embeds=None):
        """Encode ``frame_embeds``, compute every layer's cross K/V, and run
        the decoder over the prompt from position 0 into ``caches``, which
        must be empty (``init_cache``) and hold the prompt, else
        ValueError.  Returns (last_logits, (caches, cross_kv))."""
        if frame_embeds is None:
            raise ValueError("an encoder-decoder prefill needs frame_embeds")
        if any_filled([caches["pos"]]):
            raise ValueError("prefill needs an empty cache (init_cache)")
        B, S = tokens.shape
        if S > caches["pos"].shape[-1]:
            raise ValueError(f"{S} tokens do not fit an attention cache of "
                             f"length {caches['pos'].shape[-1]}")
        enc_out = self.encode(frame_embeds)
        lg, caches, cross_kv = self.decode(
            tokens, enc_out, positions=_positions(B, S, tokens.device),
            caches=caches, fresh_cache=True)
        return lg[:, -1:], (caches, cross_kv)

    def decode_step(self, state, tokens, pos):
        """One decode step.  state = (caches, cross_kv) from ``prefill``;
        tokens: (B, 1); pos: (B, 1) absolute positions."""
        caches, cross_kv = state
        lg, caches, _ = self.decode(tokens, None, positions=pos,
                                    caches=caches, cross_kv=cross_kv)
        return lg, (caches, cross_kv)


__all__ = ["EncDecLM", "cross_attn_specs", "cross_attn_apply", "enc_kv"]
