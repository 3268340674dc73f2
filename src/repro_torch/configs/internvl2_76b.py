"""InternVL2-Llama3-76B LM backbone [arXiv:2404.16821].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  The InternViT-6B
vision frontend is a STUB: input_specs provides 256 precomputed patch
embeddings per sample, prepended to the text sequence.
"""
from .config import ModelCfg
from .base import ArchSpec

CFG = ModelCfg(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256,
    pattern=("attn",), rope_theta=500000.0,
    norm="rmsnorm", mlp="gated_silu", tie_embeddings=False,
    frontend="vision", n_frontend_tokens=256,
)

SPEC = ArchSpec(
    cfg=CFG,
    skip_shapes=frozenset({"long_500k"}),   # pure full attention
    microbatches={"train_4k": 16},
    published_params=70.6e9,                # LM backbone (ViT stubbed)
)
