"""Architecture registry: the 10 assigned configs (+ reduced smoke variants)."""
from typing import Dict

from .base import ArchSpec, reduce_cfg
from .config import MLACfg, ModelCfg, MoECfg, RGLRUCfg, SSMCfg
from .shapes import SHAPES, ShapeCfg

from . import (deepseek_v3_671b, gemma2_2b, gemma3_1b, granite_moe_1b,
               internvl2_76b, mamba2_370m, recurrentgemma_9b, stablelm_1_6b,
               starcoder2_15b, whisper_tiny)

_MODULES = [internvl2_76b, deepseek_v3_671b, granite_moe_1b, whisper_tiny,
            mamba2_370m, recurrentgemma_9b, stablelm_1_6b, starcoder2_15b,
            gemma3_1b, gemma2_2b]

ARCHS: Dict[str, ArchSpec] = {m.SPEC.name: m.SPEC for m in _MODULES}

__all__ = ["ARCHS", "ArchSpec", "SHAPES", "ShapeCfg", "reduce_cfg",
           "ModelCfg", "MoECfg", "MLACfg", "SSMCfg", "RGLRUCfg"]
