"""Where the port's entry points run: ``None`` means the card.

Every entry point that takes ``device`` resolves it here, so none of them
carries on on the CPU unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' "
            "to run on the CPU")
    return dev
