"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff(expert)=512 vocab=49155; 32 experts
top-8.
"""
from .config import ModelCfg, MoECfg
from .base import ArchSpec

CFG = ModelCfg(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    pattern=("attn",), rope_theta=10000.0,
    norm="rmsnorm", mlp="gated_silu", tie_embeddings=True,
    moe=MoECfg(n_experts=32, top_k=8, d_expert=512, n_shared=0,
               first_dense=0, router_scale=False),
)

SPEC = ArchSpec(
    cfg=CFG,
    skip_shapes=frozenset({"long_500k"}),   # full attention
    microbatches={"train_4k": 4},
    published_params=1.3e9,
)
