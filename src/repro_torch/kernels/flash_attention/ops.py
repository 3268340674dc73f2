"""Public wrapper of the flash attention kernel.

The counterpart of ``repro.kernels.flash_attention.ops``.  The model's
layout is (B, S, H, D); the kernel indexes (B, H, S, D) through each
tensor's strides, so the model's tensors reach it as transposed views and
its output is written straight into a (B, S, H, Dv) buffer.  q and k have
head dim D, v (and the output) its own, Dv, as in the TPU kernel: the
(D, Dv) pair must be one of :data:`HEAD_DIM_PAIRS`, for which both kernels
are built (MLA's (192, 128) among them); any other pair raises.  On CUDA
tensors :func:`flash_attention` launches a hand-written Hopper kernel
(``csrc/flash_attention_fwd.cu``) on the current stream and counts the
launch once, in :data:`launches_by_kind` by variant and mask (causal or
not), from which ``kernel_launches``, ``launches_by_variant`` and
``launches_by_mask`` are summed; on CPU tensors it runs the plain version
(:mod:`.ref`) and counts :data:`plain_calls`.  There is no fallback between the two: a CUDA call the
kernel does not take raises.

Two kernels compute it, and :func:`variant` picks one from the inputs
alone: ``"mma_bf16"`` (bf16 tensor cores) for bf16 inputs with (D, Dv) in
:data:`HEAD_DIM_PAIRS` and 16-byte aligned pointers and row strides, which
is every served and trained path; ``"simt"`` (float32 FMAs) for every other
call, float32 included.  A launch that fails raises; no other variant is
tried.

The backward pass recomputes a plain version under autograd, as the
reference's ``_fa_bwd`` does (an XLA VJP of its plain attention, not a
Pallas kernel): the forward is exact, so its gradients are exact too.  Like
the reference's, it takes the dense attention below the chunked length and
``chunked_attention`` at it (``ref.use_chunked``: S >= 8192, a multiple of
2048), whose vjp runs one q chunk at a time.  Each recompute counts in
:data:`backward_by_path` by the path it took (``backward_recomputes`` is
their sum), apart from :data:`plain_calls`, so a training step on the card
shows that its forward never took the plain version.  A backward kernel is
later work.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from .. import _build
from . import ref as _ref

#: calls answered by the plain version (CPU tensors)
plain_calls = 0
VARIANTS = ("mma_bf16", "simt")
MASKS = ("causal", "noncausal")
#: launches of the CUDA kernel in this process (one per call on the card)
#: by (variant, mask): causal, or not (an encoder's)
launches_by_kind = {(v, m): 0 for v in VARIANTS for m in MASKS}
BACKWARD_PATHS = ("dense", "chunked")
#: backward passes, each a recompute of a plain version under autograd, by
#: the plain version it recomputed
backward_by_path = dict.fromkeys(BACKWARD_PATHS, 0)
_count_lock = threading.Lock()

#: the (D, Dv) pairs (q/k head dim, v head dim) both kernels are built for,
#: as ``FA_PAIRS`` in ``csrc/flash_attention_fwd.cu`` lists them (a CPU
#: test parses that table and holds the two equal): equal
#: widths, deepseek-v3's MLA (qk 128 + 64 rope, v 128) and its reduced
#: config's (32 + 16, 32)
HEAD_DIM_PAIRS = ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128),
                  (48, 32))
#: the tensor-core kernel's rule, as its C entry ``flash_attention_fwd_mma``
#: checks it: bf16 q, k, v and out, (D, Dv) in HEAD_DIM_PAIRS, and every
#: pointer and (b, h, s) stride a multiple of MMA_ALIGN bytes (its 16-byte
#: ``cp.async`` row loads)
MMA_DTYPE, MMA_ALIGN = torch.bfloat16, 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_counts() -> None:
    global plain_calls
    with _count_lock:
        plain_calls = 0
        for key in launches_by_kind:
            launches_by_kind[key] = 0
        for p in BACKWARD_PATHS:
            backward_by_path[p] = 0


def __getattr__(name):
    # sums of the one launch counter, and of the backward passes: a fresh
    # dict or int on each read
    if name == "kernel_launches":
        return sum(launches_by_kind.values())
    if name == "launches_by_variant":
        return {v: sum(launches_by_kind[v, m] for m in MASKS)
                for v in VARIANTS}
    if name == "launches_by_mask":
        return {m: sum(launches_by_kind[v, m] for v in VARIANTS)
                for m in MASKS}
    if name == "backward_recomputes":
        return sum(backward_by_path.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _count(kernel: Optional[str], causal: bool = True) -> None:
    """One kernel launch of variant ``kernel`` (causal or not), or (None)
    one plain call."""
    global plain_calls
    with _count_lock:
        if kernel:
            launches_by_kind[kernel, "causal" if causal else "noncausal"] += 1
        else:
            plain_calls += 1


def aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's pointer and its strides along the first three
    axes ((b, h, s) of the kernel's layout) are multiples of
    :data:`MMA_ALIGN` bytes."""
    return all(t.data_ptr() % MMA_ALIGN == 0
               and all(t.stride(i) * t.element_size() % MMA_ALIGN == 0
                       for i in range(3))
               for t in tensors)


def variant(dtype: torch.dtype, D: int, Dv: int, aligned: bool) -> str:
    """The kernel a call launches, from its inputs alone: ``"mma_bf16"``
    for :data:`MMA_DTYPE` with (D, Dv) in :data:`HEAD_DIM_PAIRS` and
    ``aligned`` pointers and row strides (see :func:`aligned`), else
    ``"simt"``."""
    if dtype == MMA_DTYPE and (D, Dv) in HEAD_DIM_PAIRS and aligned:
        return "mma_bf16"
    return "simt"


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_fwd")
    if lib.flash_attention_fwd.argtypes is None:
        # q, k, v, o, strides, B, H, KH, S, D, Dv, scale, causal, window,
        # softcap; then the SIMT entry's dtype, and the stream
        args = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
                + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float])
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_fwd_mma.argtypes = args + [ctypes.c_void_p]
        lib.flash_attention_fwd_mma.restype = ctypes.c_int
        lib.flash_attention_fwd_mma_smem_bytes.argtypes = [ctypes.c_int,
                                                           ctypes.c_int]
        lib.flash_attention_fwd_mma_smem_bytes.restype = ctypes.c_int
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_fwd.argtypes = args + [ctypes.c_int,
                                                   ctypes.c_void_p]
    return lib


def mma_smem_bytes(D: int, Dv: int) -> int:
    """Dynamic shared memory (bytes) a launch of the tensor-core kernel at
    head dims (D, Dv) asks for."""
    return _lib().flash_attention_fwd_mma_smem_bytes(D, Dv)


def flash_attention_fwd(q, k, v, *, scale: float, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel :func:`variant` picks.  q: (B, H, S, D); k:
    (B, KH, S, D); v: (B, KH, S, Dv), with (D, Dv) in
    :data:`HEAD_DIM_PAIRS`; CUDA tensors of one dtype (float32 or
    bfloat16), any strides with a unit-stride last axis.  Writes ``out``
    (B, H, S, Dv) (a new contiguous tensor if None, else of that shape and
    q's dtype and device with a unit-stride last axis) and returns it."""
    return _launch(None, q, k, v, scale=scale, causal=causal, window=window,
                   softcap=softcap, out=out)


def _launch(kind: Optional[str], q, k, v, *, scale: float, causal: bool,
            window: Optional[int], softcap: Optional[float],
            out: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`flash_attention_fwd` with the variant ``kind`` named (None:
    the one :func:`variant` picks), so that the SIMT kernel can be timed on
    inputs the tensor-core kernel takes; the model path never names one."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_fwd: q, k, v must share a dtype of "
                        f"float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4
            or v.shape[:3] != k.shape[:3]):
        raise ValueError(f"flash_attention_fwd: bad shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    KH, Dv = k.shape[1], v.shape[3]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, D) or H % KH:
        raise ValueError(f"flash_attention_fwd: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if (D, Dv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"flash_attention_fwd: head dims (D, Dv) = "
                         f"{(D, Dv)} not in {HEAD_DIM_PAIRS}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd: q, k, v must be on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    shape = (B, H, S, Dv)
    if out is None:
        out = torch.empty(shape, dtype=q.dtype, device=q.device)
    elif (tuple(out.shape) != shape or out.dtype != q.dtype
          or out.device != q.device):
        raise ValueError(f"flash_attention_fwd: out {tuple(out.shape)} "
                         f"{out.dtype} {out.device} is not {shape} of q's "
                         f"dtype and device")
    if any(t.stride(3) != 1 for t in (q, k, v, out)):
        raise ValueError("flash_attention_fwd: the head-dim axis of q, k, v "
                         "and out must have stride 1")
    chosen = variant(q.dtype, D, Dv, aligned(q, k, v, out))
    if kind is None:
        kind = chosen
    elif kind not in VARIANTS or (kind == "mma_bf16" and chosen != kind):
        raise ValueError(f"flash_attention_fwd: kernel {kind!r} does not "
                         f"take these inputs (they take {chosen!r})")
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                strides, B, H, KH, S, D, Dv, float(scale),
                int(bool(causal)),
                int(window) if window is not None else 0,
                float(softcap) if softcap is not None else 0.0)
        if kind == "mma_bf16":
            rc = lib.flash_attention_fwd_mma(*args, stream)
        else:
            rc = lib.flash_attention_fwd(*args, _DTYPES[q.dtype], stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_fwd ({kind}) launch failed "
                           f"({rc}): {msg}")
    _count(kind, bool(causal))
    return out


def _forward(q, k, v, scale, causal, window, softcap):
    """(B,S,H,D) in, (B,S,H,Dv) out: the kernel on CUDA, the plain version
    on CPU."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if q.is_cuda:
        out = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype,
                          device=q.device)
        flash_attention_fwd(qt, kt, vt, scale=scale, causal=causal,
                            window=window, softcap=softcap,
                            out=out.transpose(1, 2))
        return out
    if q.device.type == "cpu":
        out = _ref.attention_ref(qt, kt, vt, scale=scale, causal=causal,
                                 window=window, softcap=softcap)
        _count(None)
        return out.transpose(1, 2)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (scale, causal, window, softcap)
        return _forward(q, k, v, scale, causal, window, softcap)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        scale, causal, window, softcap = ctx.cfg
        if _ref.use_chunked(q.shape[1]):
            path = "chunked"
            gq, gk, gv = _ref.chunked_attention_vjp(
                q, k, v, g, scale=scale, window=window, cap=softcap,
                causal=causal)
        else:
            path = "dense"
            with torch.enable_grad():
                qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
                out = attention_ref(qq, kk, vv, scale=scale, causal=causal,
                                    window=window, softcap=softcap)
                gq, gk, gv = torch.autograd.grad(out, (qq, kk, vv), g)
        with _count_lock:
            backward_by_path[path] += 1
        return gq, gk, gv, None, None, None, None


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """q: (B, S, H, D); k: (B, S, KH, D); v: (B, S, KH, Dv) ->
    (B, S, H, Dv)."""
    return _FlashAttention.apply(q, k, v, scale, causal, window, softcap)


def attention_ref(q, k, v, *, scale, causal=True, window=None, softcap=None):
    """(B,S,H,D)-layout plain version."""
    out = _ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), scale=scale, causal=causal,
                             window=window, softcap=softcap)
    return out.transpose(1, 2)
