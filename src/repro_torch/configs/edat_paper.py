"""The paper's OWN experiment configurations (§V, §VI), as used by the
benchmark harness — the analogue of an arch config for the runtime itself.

Scaled presets: the paper ran scale-29 Kronecker graphs on a Cray XC30 up
to 30720 cores and MONC with 16384 analytics cores; this container has one
core, so `paper` shapes are recorded for reference and `ci` shapes are what
`python -m benchmarks.run` executes by default (`--full` selects `big`).
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class BFSBench:
    scale: int                 # 2^scale vertices
    edgefactor: int
    ranks: Tuple[int, ...]
    roots: int


@dataclasses.dataclass(frozen=True)
class InsituBench:
    analytics: Tuple[int, ...]
    items_per_producer: int
    field_elems: int


BFS = {
    "ci": BFSBench(scale=12, edgefactor=16, ranks=(1, 2, 4), roots=2),
    "big": BFSBench(scale=16, edgefactor=16, ranks=(1, 2, 4, 8, 16),
                    roots=8),
    # paper §V: scale 29 (536M vertices, 8.5B edges), 1280 nodes x 24 cores
    "paper": BFSBench(scale=29, edgefactor=16,
                      ranks=(384, 768, 1536, 3072, 6144, 12288, 30720),
                      roots=64),
}

INSITU = {
    "ci": InsituBench(analytics=(1, 2, 4), items_per_producer=32,
                      field_elems=1024),
    "big": InsituBench(analytics=(1, 2, 4, 8, 16), items_per_producer=128,
                       field_elems=1024),
    # paper §VI: up to 16384 analytics cores, 1:1 with computational cores
    "paper": InsituBench(analytics=(1024, 2048, 4096, 8192, 16384),
                         items_per_producer=1024, field_elems=4096),
}
