"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.

Each kernel package: ops.py (checked wrapper, launch counter, autograd),
ref.py (plain version).  Sources live in ``repro_torch/csrc`` and are built
on first use by :mod:`._build`.
"""
