"""Once-per-call-site deprecation warnings for the v1 -> v2 API migration.

The v2 ``repro_torch.edat`` facade (``Session`` / ``edat.run``) subsumes the
v1 entry points (``Runtime.run``, ``distributed_bfs``,
``distributed_insitu``, ``distributed_train``).  Those remain as thin
shims that emit a :class:`DeprecationWarning` exactly once per call
site — deduplicated here rather than by the interpreter's warning
registry, so the guarantee holds regardless of the active warning
filters (pytest, for one, rewrites them).
"""
from __future__ import annotations

import sys
import threading
import warnings

_seen: set = set()
_mu = threading.Lock()


def warn_deprecated(message: str) -> None:
    """Emit ``message`` as a DeprecationWarning, once per calling line.

    Must be called directly from the deprecated API (one frame below the
    user's call site)."""
    f = sys._getframe(2)
    key = (f.f_code.co_filename, f.f_lineno, message)
    with _mu:
        if key in _seen:
            return
        _seen.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=3)
