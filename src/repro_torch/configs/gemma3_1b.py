"""Gemma-3-1B [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (MQA kv=1, head_dim 256) d_ff=6912 vocab=262144;
5 local (window 512, theta 10k) : 1 global (theta 1M); qk-norm; post-norms.
"""
from .config import ModelCfg
from .base import ArchSpec

CFG = ModelCfg(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=512, rope_theta=1000000.0, local_rope_theta=10000.0,
    qk_norm=True, post_norms=True,
    norm="rmsnorm", norm_plus_one=True, mlp="gated_gelu",
    scale_embed=True, tie_embeddings=True,
)

SPEC = ArchSpec(
    cfg=CFG,
    skip_shapes=frozenset(),  # local-dominant; global layers O(seq)/token
    microbatches={"train_4k": 4},
    published_params=1.0e9,
)
