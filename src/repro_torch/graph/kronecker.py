"""Graph500 Kronecker (R-MAT) generator + partitioned CSR, on the device.

The port of ``repro.graph.kronecker`` (A=0.57, B=0.19, C=0.19, D=0.05,
scale s -> 2^s vertices, edgefactor 16).  It yields the reference's exact
edge list: the draws come from the same numpy PCG64 stream, made by the
Kronecker kernel on the card (``kernels/kronecker``; its plain version on
the CPU), and the permutation is the reference's own ``rng.permutation``
on the host, gathered on the device.  The CSR is built on the device and
equals the reference's rank for rank.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels.kronecker import ops as kron_ops

A, B, C = 0.57, 0.19, 0.19

#: host seconds of the permutation in this process's last
#: ``kronecker_edges`` call
permutation_seconds = 0.0


def thresholds():
    """(ab, c_norm, a_norm): the draws' thresholds as the reference
    computes them (``repro/graph/kronecker.py:29``), host doubles."""
    return A + B, C / (1 - A - B), A / (A + B)


def kronecker_edges(scale: int, edgefactor: int = 16, seed: int = 20,
                    device=None) -> torch.Tensor:
    """Returns the (2, M) int64 edge list on ``device`` (the card unless
    ``device="cpu"``; undirected; duplicates/selfloops kept as in the
    reference, filtered during CSR build)."""
    dev = resolve_device(device)
    n = 1 << scale
    m = n * edgefactor
    rng = np.random.default_rng(seed)
    edges = kron_ops.kronecker_draws(rng, scale, m, *thresholds(),
                                     device=dev)
    # permute vertex labels (deterministic) to avoid locality artifacts:
    # the reference's permutation, drawn on the host past the draws
    global permutation_seconds
    t0 = time.monotonic()
    perm = rng.permutation(n)
    permutation_seconds = time.monotonic() - t0
    perm = torch.from_numpy(perm).to(dev)
    edges[0] = perm[edges[0]]
    edges[1] = perm[edges[1]]
    return edges


@dataclasses.dataclass
class PartitionedCSR:
    """Block 1-D vertex partition across ranks; per-rank CSR of OUT edges,
    as int64 tensors on one device."""
    n_vertices: int
    n_ranks: int
    indptr: List[torch.Tensor]   # per rank, local CSR
    indices: List[torch.Tensor]
    n_edges: int

    def owner(self, v):
        """The rank owning vertex ``v`` (a tensor, numpy value or int)."""
        if isinstance(v, torch.Tensor):
            return torch.clamp_max(v // self.block, self.n_ranks - 1)
        return np.minimum(v // self.block, self.n_ranks - 1)

    @property
    def block(self):
        return -(-self.n_vertices // self.n_ranks)

    @property
    def device(self) -> torch.device:
        return self.indices[0].device

    def local_range(self, rank) -> Tuple[int, int]:
        lo = rank * self.block
        return lo, min(lo + self.block, self.n_vertices)

    def to(self, device) -> "PartitionedCSR":
        """This CSR with its tensors on ``device`` (itself if there)."""
        device = torch.device(device)
        if self.device == device:
            return self
        return dataclasses.replace(
            self, indptr=[t.to(device) for t in self.indptr],
            indices=[t.to(device) for t in self.indices])


def build_csr(edges: torch.Tensor, n_vertices: int,
              n_ranks: int) -> PartitionedCSR:
    """The reference's CSR, built on ``edges``' device: both directions,
    self-loops dropped, sorted by (src, dst) as one sort of the key
    src * n + dst (< 2^52 up to scale 26), duplicates dropped, cut into
    the block partition."""
    n = n_vertices
    e = edges[:, edges[0] != edges[1]]
    keys = torch.cat([e[0] * n + e[1], e[1] * n + e[0]])
    del e
    keys = torch.unique(keys, sorted=True)
    block = -(-n // n_ranks)
    bounds = torch.tensor([min(r * block, n) * n for r in range(n_ranks + 1)],
                          dtype=torch.int64, device=keys.device)
    cuts = torch.searchsorted(keys, bounds).tolist()
    indptr, indices = [], []
    for r in range(n_ranks):
        lo, hi = r * block, min((r + 1) * block, n)
        sel = keys[cuts[r]:cuts[r + 1]]
        s = sel // n - lo
        counts = torch.bincount(s, minlength=hi - lo)
        indptr.append(torch.cat([counts.new_zeros(1),
                                 torch.cumsum(counts, 0)]))
        indices.append(sel % n)
    return PartitionedCSR(n, n_ranks, indptr, indices,
                          n_edges=len(keys) // 2)
