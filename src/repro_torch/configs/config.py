"""Model configuration — one dataclass covering all 10 assigned families.

A copy of the reference's ``models/config.py`` as plain data; the one
difference is ``attn_impl``: ``"kernel"`` (the hand-written CUDA flash
kernel on CUDA tensors) or ``"ref"`` (plain tensor ops).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0            # shared experts (DeepSeek-V3: 1)
    first_dense: int = 0         # leading dense layers (DeepSeek-V3: 3)
    d_ff_dense: int = 0          # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_scale: bool = False   # normalise top-k weights (DeepSeek sigmoid)


@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora: int = 1536
    kv_lora: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class RGLRUCfg:
    lru_width: int = 0           # 0 -> d_model
    conv_size: int = 4
    # Griffin's gates are block-diagonal with `block_heads` blocks; 0 keeps
    # dense gates (baseline).  Block-diagonal removes the gate matmul's
    # contraction over the sharded width => no per-layer all-reduce.
    block_heads: int = 0


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # layer mixing pattern: repeating unit of
    #   'attn' (global), 'local' (sliding window), 'mla', 'ssd', 'rglru'
    pattern: Tuple[str, ...] = ("attn",)
    window: int = 4096           # sliding-window size for 'local'
    local_rope_theta: float = 10000.0

    # attention details
    rope: bool = True            # Whisper: False (absolute sinusoid only)
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0   # StableLM-2: 0.25
    qk_norm: bool = False        # Gemma-3
    attn_softcap: Optional[float] = None   # Gemma-2: 50
    final_softcap: Optional[float] = None  # Gemma-2: 30
    attn_scale: Optional[float] = None     # override 1/sqrt(head_dim)
    bias: bool = False           # StarCoder2: True

    # norms / mlp
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    norm_plus_one: bool = False  # Gemma-family (1+w) RMSNorm
    post_norms: bool = False     # Gemma-2/3 post-attn/post-mlp norms
    mlp: str = "gated_silu"      # gated_silu | gelu | gated_gelu
    tie_embeddings: bool = True
    scale_embed: bool = False    # Gemma-family sqrt(d) embed scaling
    logit_bias: bool = False

    # sub-configs
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    rglru: Optional[RGLRUCfg] = None

    # encoder-decoder (whisper): n_layers applies to both stacks
    encdec: bool = False
    # multimodal frontends are STUBS: input_specs() provides precomputed
    # frame/patch embeddings of this many positions
    frontend: str = "none"       # none | audio | vision
    n_frontend_tokens: int = 0

    mtp_depth: int = 0           # DeepSeek-V3 multi-token prediction

    # compute knobs (not architecture): may be overridden per experiment
    dtype: str = "bfloat16"
    remat: str = "full"          # full | dots | none
    attn_impl: str = "kernel"    # kernel | ref
    max_target_length: int = 8192

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer mixer kinds, length n_layers."""
        kinds = []
        i = 0
        while len(kinds) < self.n_layers:
            kinds.append(self.pattern[i % len(self.pattern)])
            i += 1
        return tuple(kinds)

    def replace(self, **kw) -> "ModelCfg":
        return dataclasses.replace(self, **kw)
