"""Gemma-2-2B [arXiv:2408.00118; hf].

26L d_model=2304 8H (GQA kv=4, head_dim 256) d_ff=9216 vocab=256000;
alternating local (4096) / global; attn softcap 50, final softcap 30.
"""
from .config import ModelCfg
from .base import ArchSpec

CFG = ModelCfg(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256000,
    pattern=("local", "attn"), window=4096,
    attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    norm="rmsnorm", norm_plus_one=True, mlp="gated_gelu",
    scale_embed=True, tie_embeddings=True,
)

SPEC = ArchSpec(
    cfg=CFG,
    skip_shapes=frozenset(),  # half the layers are windowed
    microbatches={"train_4k": 4},
    published_params=2.6e9,
)
