"""repro_torch.net — multi-process socket transport + rank launcher.

Makes the EDAT reproduction *actually distributed*: ranks as OS processes
exchanging length-prefixed pickled frames over TCP, a rank-0 rendezvous
(:mod:`~repro_torch.net.bootstrap`), a heartbeat peer-failure detector feeding
the runtime's RANK_FAILED machinery, and a spawn-based local launcher
(:mod:`~repro_torch.net.launch`, also ``python -m repro_torch.net.launch``).

Nothing above the :class:`~repro_torch.core.transport.Transport` interface
changes: the same ``main(ctx)`` runs threads-as-ranks in one process or
SPMD across processes.
"""
from .bootstrap import bootstrap, bootstrap_from_env, bootstrap_join
from .socket_transport import SocketTransport

__all__ = ["SocketTransport", "bootstrap", "bootstrap_from_env",
           "bootstrap_join", "ProcessGroup", "launch_processes"]


def __getattr__(name):
    # lazy: `python -m repro_torch.net.launch` must be able to import the package
    # without the package importing repro_torch.net.launch first (runpy warning)
    if name in ("ProcessGroup", "launch_processes"):
        from . import launch
        return getattr(launch, name)
    raise AttributeError(name)
