"""Logical-axis → mesh-axis rules (MaxText-style), with divisibility guards.

The counterpart of ``repro.sharding.rules``: the same rule sets and the
same :func:`resolve`, step for step.  Every parameter/activation dimension
carries a *logical* axis name; a rule set maps logical names to mesh axes.
``resolve`` drops a mapping whenever the dimension is not divisible by the
mesh-axis extent (e.g. 4 query heads cannot shard over a 16-way 'model'
axis — gemma3-1b), so every config builds on every mesh.

A mesh is anything with ``axis_names`` and a ``shape`` mapping from name to
size — the port's own :class:`MeshShape`, which touches no device — or a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions, read
through ``mesh_dim_names`` and ``size(i)``.  A spec is a
:class:`PartitionSpec`: a tuple of ``None | str | tuple[str, ...]``, one
entry a dimension.  :func:`placements` turns it into DTensor placements.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

AxisVal = Union[None, str, Tuple[str, ...]]

# Baseline rule set: DP over (pod, data), TP/EP over model.
DEFAULT_RULES: Dict[str, AxisVal] = {
    "batch": ("pod", "data"),
    "seq": None,
    "residual_seq": None,   # Megatron-SP: 'model' shards the residual seq
    "cache": None,
    "embed": None,
    "embed_tbl": None,   # embedding-table d-dim: never FSDP-shard
    "mlp": "model",
    "moe_mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "vocab": "model",
    "expert": "model",
    "layers": None,
    "q_lora": None,
    "kv_lora": None,
    "rec": "model",        # RG-LRU width / mamba d_inner
    "ssm_heads": "model",
    "state": None,
    "groups": None,
    "dconv": None,
    "capacity": None,
}


def with_updates(base: Dict[str, AxisVal], **kw) -> Dict[str, AxisVal]:
    out = dict(base)
    out.update(kw)
    return out


# FSDP: additionally shard the 'embed' dimension of parameters over 'data'.
def fsdp_rules(base: Dict[str, AxisVal] = None) -> Dict[str, AxisVal]:
    return with_updates(base or DEFAULT_RULES, embed="data")


# Sequence-parallel rules for long-context cells: shard the KV-cache length
# (and activation seq) over 'data'; batch stays on 'pod' only.
def sp_rules(base: Dict[str, AxisVal] = None) -> Dict[str, AxisVal]:
    return with_updates(base or DEFAULT_RULES,
                        batch=("pod",), seq="data", cache="data")


# Megatron-style sequence parallelism for training: the residual stream is
# sharded over 'model' on the sequence axis between blocks, so each TP
# partial-sum all-reduce becomes a reduce-scatter (+ all-gather before the
# next projection).
def tp_sp_rules(base: Dict[str, AxisVal] = None) -> Dict[str, AxisVal]:
    return with_updates(base or fsdp_rules(), residual_seq="model")


# Serving rules: experts spread over BOTH axes (256 experts / 256 devices),
# MLA latent dim TP-sharded; weights otherwise replicated over 'data' for
# gather-free decode.
def serve_rules(base: Dict[str, AxisVal] = None) -> Dict[str, AxisVal]:
    return with_updates(base or DEFAULT_RULES,
                        expert=("data", "model"), kv_lora="model")


# ------------------------------------------------------------------ meshes
DEFAULT_AXES = {1: ("data",), 2: ("data", "model"),
                3: ("pod", "data", "model")}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's extents and axis names, and nothing else: no device, no
    process group.  ``MeshShape((16, 16))`` is ``("data", "model")``,
    ``MeshShape((2, 16, 16))`` ``("pod", "data", "model")``."""

    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...] = ()

    def __post_init__(self):
        dims = tuple(int(n) for n in self.dims)
        names = tuple(self.axis_names) or DEFAULT_AXES.get(len(dims), ())
        if len(names) != len(dims):
            raise ValueError(f"mesh {dims} needs {len(dims)} axis names, "
                             f"got {names}")
        object.__setattr__(self, "dims", dims)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def tag(self) -> str:
        return "x".join(map(str, self.dims))


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: extent}`` in mesh order, of a :class:`MeshShape` (or
    anything with ``axis_names`` and a ``shape`` mapping) or of a named
    ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                      # a torch DeviceMesh
        return {n: mesh.size(i) for i, n in enumerate(names)}
    if not hasattr(mesh, "axis_names"):
        raise TypeError(f"{mesh!r}: a mesh needs named axes")
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


class PartitionSpec(tuple):
    """One entry a dimension: None (replicated), a mesh axis, or a tuple
    of mesh axes, which split the dimension major to minor."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def _axis_size(sizes: Dict[str, int], axis: AxisVal) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return sizes.get(axis, 0)
    n = 1
    for a in axis:
        s = sizes.get(a, 0)
        if s == 0:
            return 0
        n *= s
    return n


def resolve(shape: Sequence[int], axes: Sequence[Optional[str]],
            mesh, rules: Dict[str, AxisVal]) -> PartitionSpec:
    """PartitionSpec for one array; drops indivisible / conflicting axes."""
    sizes = mesh_axes(mesh)
    used: set = set()
    parts = []
    for dim, name in zip(shape, axes):
        val: AxisVal = rules.get(name) if name else None
        if val is not None:
            # filter to axes present in this mesh
            tup = (val,) if isinstance(val, str) else tuple(val)
            tup = tuple(a for a in tup if a in sizes)
            val = tup if tup else None
        if val is None:
            parts.append(None)
            continue
        flat = val if isinstance(val, tuple) else (val,)
        # suffix fallback: if the full product is indivisible, drop leading
        # axes one at a time (e.g. 32 experts on ('data','model') = 256
        # devices still shard over ('model',) = 16)
        chosen = None
        for start in range(len(flat)):
            cand = flat[start:]
            size = _axis_size(sizes, cand)
            if (size > 1 and dim % size == 0
                    and not any(a in used for a in cand)):
                chosen = cand
                break
        if chosen is None:
            parts.append(None)  # indivisible or conflicting: replicate
            continue
        used.update(chosen)
        parts.append(chosen if len(chosen) > 1 else chosen[0])
    return PartitionSpec(*parts)


def _entry_axes(part: AxisVal) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def placements(spec: Sequence[AxisVal], mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that splits tensor dimension d, ``Replicate()`` on the
    others.  DTensor splits a dimension over several mesh dimensions in
    mesh order, so a spec entry such as ``("pod", "data")`` must name its
    axes in mesh order; one that does not would need a strided layout, and
    raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        axes = _entry_axes(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {part!r} of dimension {d} is not "
                             f"in the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Sequence[AxisVal],
                mesh) -> Tuple[int, ...]:
    """The shard of ``shape`` that rank 0 holds under ``spec``: each
    dimension over the product of its mesh axes' extents, rounded up, as
    DTensor splits (``torch.chunk``); ``resolve``'s specs divide evenly."""
    sizes = mesh_axes(mesh)
    out = []
    for d, dim in enumerate(shape):
        part = spec[d] if d < len(spec) else None
        n = _axis_size(sizes, part)
        out.append(-(-dim // n))
    return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def tree_shardings(axes_tree, shape_tree, mesh, rules: Dict[str, AxisVal]):
    """The spec tree of a (logical axes, shaped leaves) tree pair: nested
    dicts, lists and tuples, whose leaves in ``axes_tree`` are tuples of
    axis names (``()`` for a scalar) and in ``shape_tree`` anything with a
    ``shape``."""
    if _is_axes(axes_tree):
        return resolve(shape_tree.shape, axes_tree, mesh, rules)
    if isinstance(axes_tree, dict):
        return {k: tree_shardings(v, shape_tree[k], mesh, rules)
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(tree_shardings(a, s, mesh, rules)
                               for a, s in zip(axes_tree, shape_tree))
    raise TypeError(f"not a tree of axes: {axes_tree!r}")
