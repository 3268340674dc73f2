"""``from repro_torch import edat`` — the public facade (v2).

Everything lives in :mod:`repro_torch.api`: ``Session``/``run`` (the one way
programs start), typed ``Channel``\\ s, the ``Program`` protocol,
driver-side ``Future``\\ s, collective patterns, timers, and the core /
distribution re-exports.  The v1 entry points (``Runtime.run``,
``distributed_*``) remain importable but emit DeprecationWarnings.
"""
from repro_torch.api import *  # noqa: F401,F403
from repro_torch.api import __all__ as _api_all

__all__ = list(_api_all)
