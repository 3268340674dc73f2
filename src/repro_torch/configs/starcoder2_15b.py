"""StarCoder2-15B [arXiv:2402.19173; hf].

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152; sliding window
4096 (sub-quadratic: long_500k runs), RoPE, biases.
"""
from .config import ModelCfg
from .base import ArchSpec

CFG = ModelCfg(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab=49152,
    pattern=("local",), window=4096, rope_theta=100000.0,
    norm="layernorm", mlp="gelu", bias=True, tie_embeddings=False,
)

SPEC = ArchSpec(
    cfg=CFG,
    skip_shapes=frozenset(),                # windowed attention
    microbatches={"train_4k": 8},
    published_params=15e9,
)
