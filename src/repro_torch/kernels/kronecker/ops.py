"""Public wrapper of the Kronecker generator's draw kernel.

:func:`kronecker_draws` makes the reference's src and dst bits of every
edge (``repro/graph/kronecker.py:19-34``, everything before the
permutation) from a numpy ``Generator``'s PCG64 stream.  On a CUDA device
it launches the hand-written kernel (``csrc/kronecker_gen.cu``) from the
generator's state, then moves the generator past the draws the kernel
made, and counts the launch in :data:`kernel_launches`; on the CPU it runs
the plain version (:mod:`.ref`: numpy draws in the reference's order) and
counts :data:`plain_calls`.  Either way the generator ends where the
reference's does, so its next draws (the permutation) are the reference's.
There is no fallback between the two: a CUDA call the kernel does not take
raises.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from .. import _build
from .ref import (DRAWS_PER_BIT, kronecker_draws_reference, pcg_state,
                  threshold_int)

#: launches of the CUDA kernel in this process (one per call on the card)
kernel_launches = 0
#: calls answered by the plain version (CPU)
plain_calls = 0
_count_lock = threading.Lock()


def reset_counts() -> None:
    global kernel_launches, plain_calls
    with _count_lock:
        kernel_launches = 0
        plain_calls = 0


def _count(kernel: bool) -> None:
    global kernel_launches, plain_calls
    with _count_lock:
        if kernel:
            kernel_launches += 1
        else:
            plain_calls += 1


def _lib() -> ctypes.CDLL:
    lib = _build.load("kronecker_gen")
    if lib.kronecker_gen.argtypes is None:
        lib.kronecker_gen.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int]
            + [ctypes.c_ulonglong] * 7 + [ctypes.c_void_p])
        lib.kronecker_gen.restype = ctypes.c_int
        lib.kronecker_error_string.argtypes = [ctypes.c_int]
        lib.kronecker_error_string.restype = ctypes.c_char_p
        lib.kronecker_gen_launch_shape.argtypes = [
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)]
        lib.kronecker_gen_launch_shape.restype = ctypes.c_int
    return lib


def launch_shape(m: int) -> Dict[str, int]:
    """The grid of a kernel call over ``m`` edges on the current device."""
    shape = (ctypes.c_int * 2)()
    if _lib().kronecker_gen_launch_shape(m, shape) != 0:
        raise ValueError(f"kronecker_gen: m={m} not taken")
    return {"blocks": shape[0], "threads_per_block": shape[1]}


def thresholds(ab: float, c_norm: float,
               a_norm: float) -> Tuple[int, int, int]:
    """The kernel's integer thresholds, exact forms of the host's doubles
    (``ref.threshold_int``)."""
    return tuple(threshold_int(t) for t in (ab, c_norm, a_norm))


def kronecker_gen(rng: np.random.Generator, scale: int, m: int, ab: float,
                  c_norm: float, a_norm: float,
                  device: torch.device) -> torch.Tensor:
    """Launch the kernel on ``device`` (CUDA) from ``rng``'s state; (2, m)
    int64 rows src and dst.  ``rng`` is then advanced past the
    ``DRAWS_PER_BIT * scale * m`` draws the kernel made."""
    if device.type != "cuda":
        raise ValueError(f"kronecker_gen: a CUDA device, got {device}")
    if not 1 <= scale <= 62 or m < 1:
        raise ValueError(f"kronecker_gen: scale {scale}, m {m} not taken "
                         "(1 <= scale <= 62, m >= 1)")
    s0, inc = pcg_state(rng)
    edges = torch.empty((2, m), dtype=torch.int64, device=device)
    lib = _lib()
    m64 = (1 << 64) - 1
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.kronecker_gen(
            edges[0].data_ptr(), edges[1].data_ptr(), m, scale, s0 >> 64,
            s0 & m64, inc >> 64, inc & m64,
            *thresholds(ab, c_norm, a_norm), stream)
    if rc != 0:
        msg = lib.kronecker_error_string(rc).decode()
        raise RuntimeError(f"kronecker_gen launch failed ({rc}): {msg}")
    _count(kernel=True)
    rng.bit_generator.advance(DRAWS_PER_BIT * scale * m)
    return edges


def kronecker_draws(rng: np.random.Generator, scale: int, m: int,
                    ab: float, c_norm: float, a_norm: float,
                    device=None) -> torch.Tensor:
    """(2, m) int64 on ``device``: the src and dst bits of every edge,
    drawn from ``rng`` as the reference draws them; ``rng`` ends past
    them.  The kernel on CUDA, the plain version on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return kronecker_gen(rng, scale, m, ab, c_norm, a_norm, device)
    if device.type == "cpu":
        out = kronecker_draws_reference(rng, scale, m, ab, c_norm, a_norm)
        _count(kernel=False)
        return out
    raise ValueError(f"kronecker_draws: no kernel for device {device}")
