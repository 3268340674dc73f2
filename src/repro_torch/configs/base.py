"""ArchSpec: a full-size config + shape applicability + reduced smoke config."""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Optional

from .config import MLACfg, ModelCfg, MoECfg, RGLRUCfg, SSMCfg


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    cfg: ModelCfg
    # shapes skipped for this arch (documented in DESIGN.md §Arch-applicability)
    skip_shapes: FrozenSet[str] = frozenset()
    # per-shape gradient-accumulation (memory control for train cells)
    microbatches: Optional[Dict[str, int]] = None
    published_params: Optional[float] = None   # total param count to assert
    param_tolerance: float = 0.08

    @property
    def name(self) -> str:
        return self.cfg.name


def reduce_cfg(cfg: ModelCfg) -> ModelCfg:
    """Tiny same-family config for CPU smoke tests (one fwd/train step)."""
    kw = dict(
        n_layers=max(len(cfg.pattern), 2) if len(cfg.pattern) <= 3 else
        len(cfg.pattern),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=0 if cfg.mlp == "none" else 256,
        vocab=512,
        window=min(cfg.window, 64),
        max_target_length=256,
        dtype="float32",
        remat="none",
    )
    if cfg.moe is not None:
        # capacity 8x: no token dropping in smoke tests, so prefill+decode
        # matches teacher forcing exactly
        kw["moe"] = MoECfg(
            n_experts=8, top_k=2, d_expert=64,
            n_shared=cfg.moe.n_shared,
            first_dense=min(cfg.moe.first_dense, 1),
            d_ff_dense=128, router_scale=cfg.moe.router_scale,
            capacity_factor=8.0)
    if cfg.mla is not None:
        kw["mla"] = MLACfg(q_lora=64, kv_lora=32, rope_dim=16, nope_dim=32,
                           v_dim=32)
    if cfg.ssm is not None:
        kw["ssm"] = SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=16,
                           n_groups=1, chunk=32)
        kw["d_model"] = 64  # d_inner=128, 8 ssd heads
    if cfg.rglru is not None:
        kw["rglru"] = RGLRUCfg(lru_width=128, conv_size=4)
    if cfg.mtp_depth:
        kw["mtp_depth"] = 1
        kw["n_layers"] = 3  # 1 dense prefix + 2 moe
    return cfg.replace(**kw)
