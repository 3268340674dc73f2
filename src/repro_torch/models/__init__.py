"""Model zoo of the PyTorch port: decoder-only LMs (the dense attention
families, Mamba-2 and RecurrentGemma so far)."""
from ..configs.config import MLACfg, ModelCfg, MoECfg, RGLRUCfg, SSMCfg
from .lm import TransformerLM, build_segments


def build_model(cfg: ModelCfg) -> TransformerLM:
    if cfg.encdec:
        raise NotImplementedError("encoder-decoder: later slice of the port")
    return TransformerLM(cfg)


__all__ = ["ModelCfg", "MoECfg", "MLACfg", "SSMCfg", "RGLRUCfg",
           "TransformerLM", "build_model", "build_segments"]
