"""Parameter specs, norms, rotary embeddings: the numerics every layer shares.

The PyTorch counterpart of ``repro.models.common``.  Parameters are declared
once as :class:`P` specs with the reference's shapes and logical axes, so a
parameter tree here has the same paths and layouts as the JAX package's and
weights can be carried across leaf for leaf (:mod:`repro_torch.bridge`).
The numerics are plain functions on tensors with the reference's cast points:
norms compute in float32 and cast back, rotary computes in float32.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..tree import tree_map


@dataclasses.dataclass(frozen=True)
class P:
    """Declarative parameter spec: shape + logical axes + initializer."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | embed
    scale: Optional[float] = None  # stddev override (default: fan-in)
    dtype: Any = None              # default: model dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def stack_spec(spec_tree, n: int, axis_name: str = "layers"):
    """Prepend a stacked-layers dimension to every leaf."""
    return tree_map(
        lambda s: P((n,) + s.shape, (axis_name,) + s.axes, s.init, s.scale,
                    s.dtype), spec_tree)


def init_param(spec: P, generator: torch.Generator, dtype: torch.dtype,
               device) -> torch.Tensor:
    """The reference's init rules: zeros / ones, embed std ``scale``,
    else normal with a fan-in std.  Draws float32 from ``generator`` and
    casts, as the reference does; the numbers are this package's own."""
    dt = spec.dtype or dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init == "embed":
        std = spec.scale or 1.0
    else:
        fan_in = (spec.shape[0] if len(spec.shape) >= 2
                  else max(spec.shape[-1], 1))
        std = spec.scale if spec.scale is not None else fan_in ** -0.5
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    # in place: a second float32 copy of the largest stacked leaf would not
    # fit beside the rest of a large model's tree
    return x.mul_(std).to(dt)


def init_tree(specs, generator: torch.Generator, dtype: torch.dtype,
              device) -> Any:
    """Materialise a spec tree into tensors, drawing leaves in tree order
    from ``generator`` (which must live on ``device``)."""
    return tree_map(lambda s: init_param(s, generator, dtype, device), specs)


def abstract_tree(specs, dtype: torch.dtype) -> Any:
    """Meta tensors of a spec tree's shapes and dtypes: nothing is
    allocated (the dry-run's)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype or dtype,
                                          device="meta"), specs)


def axes_tree(specs) -> Any:
    """The logical axes of a spec tree's leaves."""
    return tree_map(lambda s: s.axes, specs)


class SpecTrees:
    """The dry-run's trees of a model with ``param_specs``,
    ``cache_specs`` and ``dtype``: meta tensors and logical axes, as the
    reference's ``abstract_params``, ``param_axes`` and
    ``abstract_cache``."""

    def abstract_params(self):
        return abstract_tree(self.param_specs(), self.dtype)

    def param_axes(self):
        return axes_tree(self.param_specs())

    def abstract_cache(self, batch: int, max_len: int):
        return abstract_tree(self.cache_specs(batch, max_len), self.dtype)


# ----------------------------------------------------------------- numerics
def rms_norm(x, w, *, eps=1e-6, plus_one=False):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (x * scale).to(dt)


def layer_norm(x, w, b, *, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(dt)


def softcap(x, cap: Optional[float]):
    """Gemma-2 style logit soft-capping."""
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def rotary(x, positions, *, theta: float = 10000.0, fraction: float = 1.0):
    """Apply RoPE to ``x`` (..., seq, heads, head_dim), half-split layout.

    ``fraction`` < 1 rotates only the leading slice of head_dim (StableLM)."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    ang = positions[..., None].float() * freqs              # (..., seq, half)
    ang = ang[..., None, :]                                  # broadcast heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = out.to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < hd else out


@functools.lru_cache(maxsize=8)
def _sinusoid_table(length: int, dim: int) -> np.ndarray:
    half = dim // 2
    freq = np.exp(-np.log(10000.0) * np.arange(half) / max(half - 1, 1))
    pos = np.arange(length)[:, None] * freq[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    table = table.astype(np.float32)
    table.flags.writeable = False
    return table


def sinusoid_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (any length), (length,
    dim) float32: computed in numpy float64 and rounded to float32, as the
    reference computes them, so the two tables are equal bit for bit.  The
    host table is kept per (length, dim); each call copies it to
    ``device``."""
    return torch.tensor(_sinusoid_table(length, dim), device=device)


def any_filled(positions) -> bool:
    """Whether any slot of these caches' ``pos`` tensors is filled (>= 0).
    A meta tensor (the dry-run's abstract cache) holds no values and
    counts as empty."""
    pos = [p for p in positions if not p.is_meta]
    return bool(pos) and bool((torch.stack([p.max() for p in pos])
                               >= 0).any())


def gelu(x):
    return F.gelu(x, approximate="tanh")


def silu(x):
    return F.silu(x)


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, i.e.
    ``max(x, 0) + log1p(exp(-|x|))``, in ``x``'s dtype."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


__all__ = ["P", "stack_spec", "init_param", "init_tree", "abstract_tree",
           "axes_tree", "SpecTrees", "any_filled",
           "rms_norm", "layer_norm", "softcap", "rotary",
           "sinusoid_positions", "gelu", "silu", "softplus"]
