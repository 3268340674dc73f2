"""Mamba2-370M [arXiv:2405.21060].

48L d_model=1024, attention-free SSD blocks, ssm_state=128, vocab=50280.
"""
from .config import ModelCfg, SSMCfg
from .base import ArchSpec

CFG = ModelCfg(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab=50280,
    pattern=("ssd",), mlp="none",
    norm="rmsnorm", tie_embeddings=True,
    ssm=SSMCfg(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
               chunk=128),
)

SPEC = ArchSpec(
    cfg=CFG,
    skip_shapes=frozenset(),                # constant-state: runs long_500k
    microbatches={"train_4k": 4},
    published_params=370e6,
)
