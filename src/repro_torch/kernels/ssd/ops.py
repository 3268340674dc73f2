"""Public wrapper of the SSD chunked-scan kernel.

The counterpart of ``repro.kernels.ssd.ops``.  On CUDA tensors :func:`ssd`
launches a hand-written Hopper kernel (``csrc/ssd_fwd.cu``) on the
current stream and counts the launch in :data:`kernel_launches` and
:data:`launches_by_variant`; on CPU tensors it runs the plain version
(:mod:`.ref`) and counts :data:`plain_calls`.  There is no fallback between
the two: a CUDA call the kernel does not take raises.

Two kernels compute the scan, and :func:`variant` picks one from the
inputs alone: ``"mma_bf16"`` (bf16 tensor cores, float32 operands split
into two bf16 halves) for bf16 inputs whose N and P are multiples of 16,
whose chunk is a multiple of 32 and whose pointers and row strides are
16-byte aligned, the serving path's case; ``"simt"`` (float32 FMAs) for
every other call, float32 included.  A launch that fails raises; no other
variant is tried.

Beyond the reference's wrapper it takes any T (the kernel masks a ragged
tail; the plain version is fed zeros past T, with dt = 0), an initial state
and returns the final state, which is what serving prefill needs.  Groups
are not repeated to heads: the kernel reads head h's group through b's and
c's strides.  The output is float32, as the reference's wrapper returns it.

The backward pass recomputes the plain version under autograd, as the
reference's ``_bwd`` does, and counts the recompute in
:data:`backward_recomputes`: the forward is exact, so its gradients are
exact too.  A backward kernel is later work.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from .. import _build
from .ref import ssd_padded_reference

#: launches of the CUDA kernel in this process (one per call on the card)
kernel_launches = 0
#: calls answered by the plain version (CPU tensors)
plain_calls = 0
VARIANTS = ("mma_bf16", "simt")
#: kernel launches in this process by variant
launches_by_variant = dict.fromkeys(VARIANTS, 0)
#: backward passes, each a recompute of the plain version under autograd
backward_recomputes = 0
_count_lock = threading.Lock()

CHUNKS = (32, 64, 96, 128)
#: the tensor-core kernel's rule, as its C entry ``ssd_fwd_mma`` checks it:
#: N and P multiples of the MMA tile (16), the chunk a multiple of 32 (its
#: running sum gives each of a warp's 32 lanes chunk / 32 steps)
MMA_TILE, MMA_CHUNK_MULTIPLE = 16, 32
MAX_STATE = 128          # N: a multiple of 8 up to 128
MAX_HEAD_DIM = 64        # P: a multiple of 4 up to 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_counts() -> None:
    global kernel_launches, plain_calls, backward_recomputes
    with _count_lock:
        kernel_launches = 0
        plain_calls = 0
        backward_recomputes = 0
        for v in VARIANTS:
            launches_by_variant[v] = 0


def _count(kernel: Optional[str]) -> None:
    """One kernel launch of variant ``kernel``, or (None) one plain call."""
    global kernel_launches, plain_calls
    with _count_lock:
        if kernel:
            kernel_launches += 1
            launches_by_variant[kernel] += 1
        else:
            plain_calls += 1


def aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's pointer and its strides along the batch, step
    and head axes are multiples of 16 bytes (the tensor-core kernel's
    16-byte ``cp.async`` loads of whole rows)."""
    return all(t.data_ptr() % 16 == 0
               and all(t.stride(i) * t.element_size() % 16 == 0
                       for i in range(3))
               for t in tensors)


def variant(dtype: torch.dtype, N: int, P: int, chunk: int,
            aligned: bool) -> str:
    """The kernel a call launches, from its inputs alone: ``"mma_bf16"``
    for bf16 with N and P multiples of :data:`MMA_TILE`, the chunk a
    multiple of :data:`MMA_CHUNK_MULTIPLE` and ``aligned`` pointers and row
    strides (see :func:`aligned`), else ``"simt"``."""
    if (dtype == torch.bfloat16 and N % MMA_TILE == 0 and P % MMA_TILE == 0
            and chunk % MMA_CHUNK_MULTIPLE == 0 and aligned):
        return "mma_bf16"
    return "simt"


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_fwd")
    if lib.ssd_fwd.argtypes is None:
        lib.ssd_fwd.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.ssd_fwd.restype = ctypes.c_int
        lib.ssd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_error_string.restype = ctypes.c_char_p
        lib.ssd_fwd_mma.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.ssd_fwd_mma.restype = ctypes.c_int
        for f in (lib.ssd_fwd_smem_bytes, lib.ssd_fwd_mma_smem_bytes):
            f.argtypes = [ctypes.c_int] * 3
            f.restype = ctypes.c_int
    return lib


def smem_bytes(N: int, P: int, chunk: int, kernel: str = "simt") -> int:
    """Dynamic shared memory (bytes) a launch of ``kernel`` (a variant) at
    these sizes asks for."""
    lib = _lib()
    f = (lib.ssd_fwd_mma_smem_bytes if kernel == "mma_bf16"
         else lib.ssd_fwd_smem_bytes)
    return f(N, P, chunk)


def ssd_fwd(x, dt, a_log, b, c, *, chunk: int,
            init_state: Optional[torch.Tensor] = None,
            kernel: Optional[str] = None):
    """Launch the kernel :func:`variant` picks.  x: (B, T, H, P) and b, c:
    (B, T, G, N), CUDA tensors of one dtype (float32 or bfloat16) with a
    unit-stride last axis and any other strides; dt: (B, T, H) float32;
    a_log: (H,) float32; init_state: (B, H, N, P) float32 contiguous, or
    None for zeros.  Returns (y (B, T, H, P) float32, final state
    (B, H, N, P) float32).

    ``kernel`` names a variant instead, to time ``"simt"`` against the
    tensor cores on the same inputs; the model path never passes it."""
    if not all(t.is_cuda and t.device == x.device
               for t in (x, dt, a_log, b, c)):
        devs = [str(t.device) for t in (x, dt, a_log, b, c)]
        raise ValueError("ssd_fwd: x, dt, a_log, b, c must be on one CUDA "
                         f"device, got {devs}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError("ssd_fwd: x, b, c must share a dtype of float32 or "
                        f"bfloat16, got {x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise TypeError(f"ssd_fwd: dt and a_log must be float32, got "
                        f"{dt.dtype}, {a_log.dtype}")
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(f"ssd_fwd: bad shapes x {tuple(x.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}")
    B, T, H, Pd = x.shape
    G, N = b.shape[2], b.shape[3]
    if (b.shape[:2] != (B, T) or tuple(dt.shape) != (B, T, H)
            or tuple(a_log.shape) != (H,) or H % G):
        raise ValueError(f"ssd_fwd: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a_log {tuple(a_log.shape)}, "
                         f"b/c {tuple(b.shape)} do not match")
    if T < 1:
        raise ValueError("ssd_fwd: T must be at least 1")
    if chunk not in CHUNKS:
        raise ValueError(f"ssd_fwd: chunk {chunk} not in {CHUNKS}")
    if N % 8 or not 8 <= N <= MAX_STATE:
        raise ValueError(f"ssd_fwd: state size {N} is not a multiple of 8 "
                         f"in [8, {MAX_STATE}]")
    if Pd % 4 or not 4 <= Pd <= MAX_HEAD_DIM:
        raise ValueError(f"ssd_fwd: head dim {Pd} is not a multiple of 4 "
                         f"in [4, {MAX_HEAD_DIM}]")
    if any(t.stride(3) != 1 for t in (x, b, c)):
        raise ValueError("ssd_fwd: the last axis of x, b and c must have "
                         "stride 1")
    if not a_log.is_contiguous():
        raise ValueError("ssd_fwd: a_log must be contiguous")
    if init_state is not None and (
            tuple(init_state.shape) != (B, H, N, Pd)
            or init_state.dtype != torch.float32
            or init_state.device != x.device
            or not init_state.is_contiguous()):
        raise ValueError("ssd_fwd: init_state must be a contiguous float32 "
                         f"({B}, {H}, {N}, {Pd}) tensor on {x.device}, got "
                         f"{tuple(init_state.shape)} {init_state.dtype} "
                         f"{init_state.device}")
    chosen = variant(x.dtype, N, Pd, chunk, aligned(x, b, c))
    if kernel is None:
        kernel = chosen
    elif kernel not in VARIANTS or (kernel == "mma_bf16"
                                    and chosen != kernel):
        raise ValueError(f"ssd_fwd: kernel {kernel!r} does not take these "
                         f"inputs (they take {chosen!r})")
    y = torch.empty((B, T, H, Pd), dtype=torch.float32, device=x.device)
    fin = torch.empty((B, H, N, Pd), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 15)(
        *(t.stride(i) for t in (x, dt, b, c, y) for i in range(3)))
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
                c.data_ptr(),
                init_state.data_ptr() if init_state is not None else None,
                y.data_ptr(), fin.data_ptr(),
                strides, B, T, H, G, N, Pd, int(chunk))
        if kernel == "mma_bf16":
            rc = lib.ssd_fwd_mma(*args, stream)
        else:
            rc = lib.ssd_fwd(*args, _DTYPES[x.dtype], stream)
    if rc != 0:
        msg = lib.ssd_error_string(rc).decode()
        raise RuntimeError(f"ssd_fwd ({kernel}) launch failed ({rc}): "
                           f"{msg}")
    _count(kernel)
    return y, fin


def _forward(x, dt, a_log, b, c, chunk, init_state):
    """The kernel on CUDA, the plain version on CPU; (y, final state)."""
    if x.is_cuda:
        return ssd_fwd(x, dt, a_log.float().contiguous(), b, c, chunk=chunk,
                       init_state=init_state)
    if x.device.type == "cpu":
        out = ssd_padded_reference(x, dt, a_log, b, c, chunk=chunk,
                                   init_state=init_state)
        _count(None)
        return out
    raise ValueError(f"ssd: no kernel for device {x.device}")


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, init_state, chunk):
        ctx.save_for_backward(x, dt, a_log, b, c, init_state)
        ctx.chunk = chunk
        return _forward(x, dt, a_log, b, c, chunk, init_state)

    @staticmethod
    def backward(ctx, gy, gfin):
        global backward_recomputes
        with _count_lock:
            backward_recomputes += 1
        x, dt, a_log, b, c, init_state = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(t.is_floating_point())
                   if t is not None else None
                   for t in (x, dt, a_log, b, c, init_state)]
            y, fin = ssd_padded_reference(*ins[:5], chunk=ctx.chunk,
                                          init_state=ins[5])
            wrt = [t for t in ins if t is not None]
            grads = iter(torch.autograd.grad((y, fin), wrt, (gy, gfin),
                                             allow_unused=True))
        return (*(next(grads) if t is not None else None for t in ins),
                None)


def ssd(x, dt, a_log, b, c, *, chunk: int = 128, init_state=None,
        return_final_state: bool = False):
    """x: (B,T,H,P); dt: (B,T,H); a_log: (H,); b,c: (B,T,G,N), any T.

    Returns y (B,T,H,P) float32 [and the final state (B,H,N,P) float32 if
    ``return_final_state``]; ``init_state`` (B,H,N,P) float32 or None."""
    y, fin = _SSD.apply(x, dt.float(), a_log, b, c, init_state, chunk)
    return (y, fin) if return_final_state else y
