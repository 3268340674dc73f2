"""Model zoo of the PyTorch port: decoder-only LMs (the dense attention
families, Mamba-2, RecurrentGemma, the MoE families) and the
encoder-decoder backbone (Whisper)."""
from ..configs.config import MLACfg, ModelCfg, MoECfg, RGLRUCfg, SSMCfg
from .encdec import EncDecLM
from .lm import TransformerLM, build_segments


def build_model(cfg: ModelCfg):
    return EncDecLM(cfg) if cfg.encdec else TransformerLM(cfg)


__all__ = ["ModelCfg", "MoECfg", "MLACfg", "SSMCfg", "RGLRUCfg",
           "TransformerLM", "EncDecLM", "build_model", "build_segments"]
