"""Ambient sharding context: activation constraints inside model code.

The counterpart of ``repro.sharding.ctx``.  Model code calls
``constrain(x, logical_axes)`` at the reference's points.  Outside a
:func:`use_sharding` context, and on any tensor that is not a ``DTensor``
(every run on one device, and the dry-run's meta tensors), it returns its
input object itself; a ``DTensor`` under an active ``DeviceMesh`` is
redistributed to the placements the active rules give it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

from .rules import AxisVal, placements, resolve

_tls = threading.local()


@contextlib.contextmanager
def use_sharding(mesh, rules: Dict[str, AxisVal]):
    prev = getattr(_tls, "cur", None)
    _tls.cur = (mesh, rules)
    try:
        yield
    finally:
        _tls.cur = prev


def current() -> Optional[tuple]:
    return getattr(_tls, "cur", None)


def constrain(x, axes):
    cur = current()
    if cur is None:
        return x
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    mesh, rules = cur
    if not isinstance(x, DTensor) or not isinstance(mesh, DeviceMesh):
        return x
    spec = resolve(x.shape, axes, mesh, rules)
    return x.redistribute(mesh, placements(spec, mesh))
