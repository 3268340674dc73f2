"""Public wrapper of the RG-LRU recurrence kernel.

The counterpart of ``repro.kernels.rglru.ops``.  On CUDA tensors
:func:`rglru` launches the hand-written Hopper kernel
(``csrc/rglru_fwd.cu``) on the current stream and counts the launch in
:data:`kernel_launches`; on CPU tensors it runs the plain version
(:mod:`.ref`) and counts :data:`plain_calls`.  There is no fallback between
the two: a CUDA call the kernel does not take raises.

Beyond the reference's wrapper (whose ``supported`` needs T and W to be
multiples of 128) it takes any T >= 1 and any W, an initial state, and
returns the final state, which is what serving prefill needs.  The output
is float32, as the reference's is for its float32 inputs.

The kernel is a block-local segmented scan (see the note in the source);
:func:`launch_shape` reports the grid and segment length a call launches.

The backward pass recomputes the plain version under autograd, as the
reference's ``_bwd`` does: the forward is exact, so its gradients are exact
too.  A backward kernel is later work.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from .. import _build
from .ref import rglru_reference

#: launches of the CUDA kernel in this process (one per call on the card)
kernel_launches = 0
#: calls answered by the plain version (CPU tensors)
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
    lib = _build.load("rglru_fwd")
    if lib.rglru_fwd.argtypes is None:
        lib.rglru_fwd.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.rglru_fwd.restype = ctypes.c_int
        lib.rglru_error_string.argtypes = [ctypes.c_int]
        lib.rglru_error_string.restype = ctypes.c_char_p
        lib.rglru_fwd_launch_shape.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
        lib.rglru_fwd_launch_shape.restype = ctypes.c_int
    return lib


#: what :func:`launch_shape` reports, in the C function's order
LAUNCH_KEYS = ("blocks", "threads_per_block", "segment_steps", "segments",
               "spans")


def launch_shape(B: int, T: int, W: int) -> Dict[str, int]:
    """The launch of a kernel call on (B, T, W) inputs: its blocks, threads
    per block, steps per segment (L), segments per span, and spans of
    segments * L steps each block walks."""
    shape = (ctypes.c_int * len(LAUNCH_KEYS))()
    if _lib().rglru_fwd_launch_shape(B, T, W, shape) != 0:
        raise ValueError(f"rglru_fwd: shape {(B, T, W)} not taken")
    return dict(zip(LAUNCH_KEYS, shape))


def rglru_fwd(x, r, i, lam, *, h0: Optional[torch.Tensor] = None):
    """Launch the kernel.  x, r, i: (B, T, W) float32 CUDA tensors with a
    unit-stride last axis and any other strides; lam: (W,) float32
    contiguous; h0: (B, W) float32 contiguous, or None for zeros.
    Returns (h (B, T, W) float32, final state (B, W) float32)."""
    if not all(t.is_cuda and t.device == x.device for t in (x, r, i, lam)):
        devs = [str(t.device) for t in (x, r, i, lam)]
        raise ValueError("rglru_fwd: x, r, i, lam must be on one CUDA "
                         f"device, got {devs}")
    if any(t.dtype != torch.float32 for t in (x, r, i, lam)):
        raise TypeError("rglru_fwd: x, r, i, lam must be float32, got "
                        f"{[t.dtype for t in (x, r, i, lam)]}")
    if x.dim() != 3 or r.shape != x.shape or i.shape != x.shape:
        raise ValueError(f"rglru_fwd: bad shapes x {tuple(x.shape)}, r "
                         f"{tuple(r.shape)}, i {tuple(i.shape)}")
    B, T, W = x.shape
    if T < 1 or W < 1 or not 1 <= B <= 65535:
        raise ValueError(f"rglru_fwd: shape {tuple(x.shape)} not taken "
                         "(T, W >= 1, 1 <= B <= 65535)")
    if tuple(lam.shape) != (W,) or not lam.is_contiguous():
        raise ValueError(f"rglru_fwd: lam must be a contiguous ({W},) "
                         f"tensor, got {tuple(lam.shape)}")
    if any(t.stride(2) != 1 for t in (x, r, i)):
        raise ValueError("rglru_fwd: the last axis of x, r and i must have "
                         "stride 1")
    if h0 is not None and (tuple(h0.shape) != (B, W)
                           or h0.dtype != torch.float32
                           or h0.device != x.device
                           or not h0.is_contiguous()):
        raise ValueError("rglru_fwd: h0 must be a contiguous float32 "
                         f"({B}, {W}) tensor on {x.device}, got "
                         f"{tuple(h0.shape)} {h0.dtype} {h0.device}")
    h = torch.empty((B, T, W), dtype=torch.float32, device=x.device)
    fin = torch.empty((B, W), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 6)(
        *(t.stride(d) for t in (x, r, i) for d in range(2)))
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rglru_fwd(
            x.data_ptr(), r.data_ptr(), i.data_ptr(), lam.data_ptr(),
            h0.data_ptr() if h0 is not None else None, h.data_ptr(),
            fin.data_ptr(), strides, B, T, W, stream)
    if rc != 0:
        msg = lib.rglru_error_string(rc).decode()
        raise RuntimeError(f"rglru_fwd launch failed ({rc}): {msg}")
    _count(kernel=True)
    return h, fin


def _forward(x, r, i, lam, h0):
    """The kernel on CUDA, the plain version on CPU; (h, final state)."""
    if x.is_cuda:
        return rglru_fwd(x, r, i, lam.float().contiguous(), h0=h0)
    if x.device.type == "cpu":
        out = rglru_reference(x, r, i, lam, h0=h0)
        _count(kernel=False)
        return out
    raise ValueError(f"rglru: no kernel for device {x.device}")


class _RGLRU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, i, lam, h0):
        ctx.save_for_backward(x, r, i, lam, h0)
        return _forward(x, r, i, lam, h0)

    @staticmethod
    def backward(ctx, gh, gfin):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() if t is not None else None
                   for t in ctx.saved_tensors]
            h, fin = rglru_reference(*ins)
            wrt = [t for t in ins if t is not None]
            grads = iter(torch.autograd.grad((h, fin), wrt, (gh, gfin),
                                             allow_unused=True))
        return tuple(next(grads) if t is not None else None for t in ins)


def rglru(x, r, i, lam, *, h0=None, return_final_state: bool = False):
    """x, r, i: (B, T, W); lam: (W,); any T >= 1.

    Returns h (B, T, W) float32 [and the final state (B, W) float32 if
    ``return_final_state``]; ``h0`` (B, W) float32 or None for zeros."""
    h, fin = _RGLRU.apply(x.float(), r.float(), i.float(), lam, h0)
    return (h, fin) if return_final_state else h
