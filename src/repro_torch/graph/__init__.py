from .kronecker import kronecker_edges, build_csr, PartitionedCSR
from .bfs import (EdatBFS, ReferenceBFS, bfs_program, default_root,
                  distributed_bfs, validate_bfs_tree)
