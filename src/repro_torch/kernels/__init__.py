"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.

Each kernel package: ops.py (checked wrapper, launch counter, autograd),
ref.py (plain version).  Sources live in ``repro_torch/csrc`` and are built
on first use by :mod:`._build`.
"""
from typing import Dict, Tuple


def launch_counts() -> Dict[str, Tuple[int, int]]:
    """``{kernel: (kernel launches, plain calls)}`` of every kernel's
    wrapper in this process, now."""
    from .flash_attention import ops as fa
    from .kronecker import ops as kron
    from .rglru import ops as rglru
    from .ssd import ops as ssd
    return {name: (ops.kernel_launches, ops.plain_calls)
            for name, ops in (("flash_attention_fwd", fa), ("ssd_fwd", ssd),
                              ("rglru_fwd", rglru), ("kronecker_gen", kron))}


def variant_counts() -> Dict[str, Dict[str, int]]:
    """``{kernel: {variant: kernel launches}}`` of every kernel that has
    variants, in this process, now."""
    from .flash_attention import ops as fa
    from .ssd import ops as ssd
    return {name: dict(ops.launches_by_variant)
            for name, ops in (("flash_attention_fwd", fa), ("ssd_fwd", ssd))}
