"""DeepSeek-V3 671B [arXiv:2412.19437; hf].

61L d_model=7168 128H MLA d_ff(expert)=2048 vocab=129280; 1 shared + 256
routed experts, top-8, first 3 layers dense (d_ff 18432); MTP depth 1.
"""
from .config import MLACfg, ModelCfg, MoECfg
from .base import ArchSpec

CFG = ModelCfg(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab=129280, head_dim=192,   # qk head dim (nope+rope)
    pattern=("mla",), rope_theta=10000.0,
    norm="rmsnorm", mlp="gated_silu", tie_embeddings=False,
    mla=MLACfg(q_lora=1536, kv_lora=512, rope_dim=64, nope_dim=128,
               v_dim=128),
    moe=MoECfg(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
               first_dense=3, d_ff_dense=18432, router_scale=True),
    mtp_depth=1,
)

SPEC = ArchSpec(
    cfg=CFG,
    skip_shapes=frozenset({"long_500k"}),   # MLA is full attention
    microbatches={"train_4k": 32},
    published_params=671e9,
)
