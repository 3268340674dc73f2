"""Whisper-tiny [arXiv:2212.04356].

4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865; the audio conv
frontend is a STUB (input_specs provides precomputed frame embeddings).
Sinusoidal positions on both stacks (deviation: Whisper's decoder uses
learned positions; sinusoids let assigned 4k/32k lengths lower cleanly).
"""
from .config import ModelCfg
from .base import ArchSpec

CFG = ModelCfg(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab=51865,
    norm="layernorm", mlp="gelu", bias=True, rope=False,
    tie_embeddings=True, encdec=True, frontend="audio",
    max_target_length=32768,
)

SPEC = ArchSpec(
    cfg=CFG,
    skip_shapes=frozenset({"long_500k"}),   # full attention both stacks
    microbatches={"train_4k": 1},
    published_params=39e6,
    param_tolerance=0.35,  # conv frontend + learned positions stubbed out
)
