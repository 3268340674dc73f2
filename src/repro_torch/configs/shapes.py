"""Assigned input shapes (identical across all 10 architectures).

train_*   lowers ``train_step``; prefill_* lowers ``prefill_step``;
decode_* / long_* lower ``serve_step`` (one token, KV cache of seq_len).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq: int
    global_batch: int
    kind: str                   # train | prefill | decode
    microbatches: int = 1       # train: gradient-accumulation factor


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}
