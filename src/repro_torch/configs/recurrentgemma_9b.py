"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; RG-LRU + local
attention in a 2:1 pattern, window 2048.
"""
from .config import ModelCfg, RGLRUCfg
from .base import ArchSpec

CFG = ModelCfg(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000,
    pattern=("rglru", "rglru", "local"), window=2048,
    norm="rmsnorm", norm_plus_one=True, mlp="gated_gelu",
    scale_embed=True, tie_embeddings=True,
    rglru=RGLRUCfg(lru_width=4096, conv_size=4),
)

SPEC = ArchSpec(
    cfg=CFG,
    skip_shapes=frozenset(),                # recurrent + windowed: long OK
    microbatches={"train_4k": 8},
    published_params=9e9,
    param_tolerance=0.35,  # dense (not block-diagonal) RG-LRU gates
)
