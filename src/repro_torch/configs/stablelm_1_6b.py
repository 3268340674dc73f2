"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b].

24L d_model=2048 32H (MHA kv=32) d_ff=5632 vocab=100352; partial rotary 25%.
"""
from .config import ModelCfg
from .base import ArchSpec

CFG = ModelCfg(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab=100352,
    pattern=("attn",), rope_theta=10000.0, rope_fraction=0.25,
    norm="layernorm", mlp="gated_silu", tie_embeddings=False,
)

SPEC = ArchSpec(
    cfg=CFG,
    skip_shapes=frozenset({"long_500k"}),   # pure full attention
    microbatches={"train_4k": 4},
    published_params=1.64e9,
)
