"""Plain version of the Kronecker generator's draws, and an exact model of
numpy's PCG64 stream.

:func:`kronecker_draws_reference` draws with numpy in the reference's order
(``repro/graph/kronecker.py:28-34``: ``rng.random(m)`` for ``ii``, then
for ``jj``, a bit at a time) and assembles the bits with torch ops.  The
CPU path and the tests use it; nothing on the card's path does.

The rest models what the CUDA kernel (``csrc/kronecker_gen.cu``) computes,
in Python integers: the LCG step, its jump-ahead, the XSL-RR output, the
53 bits ``random()`` keeps, the index of each draw and the integer form of
each threshold.  The tests hold it to numpy's own draws.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

#: numpy's PCG64 multiplier (PCG_DEFAULT_MULTIPLIER_128)
PCG_MULT = 0x2360ED051FC65DA44385DF649FCCF645
#: ``Generator.random()`` keeps the top 53 bits of a 64-bit output
MANTISSA_SHIFT = 11
#: draws a bit of scale: m for ``ii``, then m for ``jj``
DRAWS_PER_BIT = 2
_M128 = (1 << 128) - 1
_M64 = (1 << 64) - 1


def kronecker_draws_reference(rng: np.random.Generator, scale: int, m: int,
                              ab: float, c_norm: float,
                              a_norm: float) -> torch.Tensor:
    """(2, m) int64 CPU tensor: rows src and dst before the permutation,
    drawn from ``rng`` as the reference draws them (``rng`` advances by
    ``DRAWS_PER_BIT * scale * m`` draws)."""
    edges = torch.zeros((2, m), dtype=torch.int64)
    for bit in range(scale):
        ii = rng.random(m) > ab
        jj = rng.random(m) > np.where(ii, c_norm, a_norm)
        edges[0] |= torch.from_numpy(ii).to(torch.int64) << bit
        edges[1] |= torch.from_numpy(jj).to(torch.int64) << bit
    return edges


def threshold_int(t: float) -> int:
    """The integer T with ``x * 2**-53 > t  <=>  x > T`` for every integer
    ``x`` in [0, 2**53): ``floor(t * 2**53)``, exact (a double times a
    power of two is exact)."""
    return math.floor(math.ldexp(t, 53))


def pcg_state(rng: np.random.Generator) -> Tuple[int, int]:
    """(state, increment) of ``rng``'s PCG64 bit generator."""
    st = rng.bit_generator.state
    if st["bit_generator"] != "PCG64":
        raise ValueError(f"the Kronecker kernel draws numpy's PCG64 stream, "
                         f"not {st['bit_generator']}")
    if st["has_uint32"]:
        raise ValueError("the generator holds a buffered 32-bit draw, which "
                         "a jump-ahead would drop")
    return st["state"]["state"], st["state"]["inc"]


def jump(k: int, inc: int) -> Tuple[int, int]:
    """(a, c) with k LCG steps = ``s -> a s + c`` (mod 2**128), by squaring
    the map of one step, as the kernel's ``jump``."""
    a, c, ma, mc = 1, 0, PCG_MULT, inc
    while k:
        if k & 1:
            a, c = (a * ma) & _M128, (c * ma + mc) & _M128
        ma, mc = (ma * ma) & _M128, (mc * (ma + 1)) & _M128
        k >>= 1
    return a, c


def draw53(s: int) -> int:
    """The XSL-RR output of state ``s``, shifted to the 53 bits
    ``random()`` keeps."""
    hi, lo = s >> 64, s & _M64
    x, r = hi ^ lo, hi >> 58
    return (((x >> r) | (x << ((64 - r) & 63))) & _M64) >> MANTISSA_SHIFT


def draw(s0: int, inc: int, i: int) -> int:
    """Draw ``i`` of the stream that starts at state ``s0``: the output of
    the state ``i + 1`` steps past it."""
    a, c = jump(i + 1, inc)
    return draw53((a * s0 + c) & _M128)


def draw_index(bit: int, half: int, e: int, m: int) -> int:
    """The draw of edge ``e``'s ``ii`` (half 0) or ``jj`` (half 1) at
    ``bit``."""
    return DRAWS_PER_BIT * bit * m + half * m + e


def thread_edges(t: int, stride: int, m: int, scale: int, s0: int,
                 inc: int, thresholds: Tuple[int, int, int]):
    """What thread ``t`` of a grid of ``stride`` threads writes: ``[(e,
    src, dst)]`` for edges t, t + stride, ... < m, by the kernel's own
    procedure (a jump to draw t, the map of m steps a draw, the map of
    ``stride`` steps an edge)."""
    t_ab, t_c, t_a = thresholds
    by_m, by_stride = jump(m, inc), jump(stride, inc)
    a, c = jump(t + 1, inc)
    base, out = (a * s0 + c) & _M128, []
    for e in range(t, m, stride):
        s, u, v = base, 0, 0
        for b in range(scale):
            ii = draw53(s) > t_ab
            s = (by_m[0] * s + by_m[1]) & _M128
            jj = draw53(s) > (t_c if ii else t_a)
            s = (by_m[0] * s + by_m[1]) & _M128
            u |= int(ii) << b
            v |= int(jj) << b
        out.append((e, u, v))
        base = (by_stride[0] * base + by_stride[1]) & _M128
    return out
