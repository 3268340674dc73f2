"""Typed event channels (v2 API).

A :class:`Channel` replaces a raw event-id string everywhere an eid is
accepted (``submit`` / ``fire`` / ``wait`` / ``fire_batch`` deps and
targets).  It subclasses :class:`str`, so the runtime's routing tables,
wire frames and FIFO bookkeeping see exactly the interned id — channels
add *zero* hot-path cost over raw strings — while carrying an optional
payload type that is validated at ``fire`` time.

Raw strings keep working: an undeclared plain eid behaves as an
anonymous, untyped channel (unless the surrounding :class:`Program`
declares its channels, in which case a typo fails fast with
``KeyError`` instead of silently never matching).
"""
from __future__ import annotations

import sys
from typing import Any, Tuple, Type, Union

PayloadSpec = Union[Type[Any], Tuple[Type[Any], ...], None]


class Channel(str):
    """A typed event channel: an interned event id plus a payload type.

    ::

        GRAD = edat.Channel("grad", payload=dict)
        ctx.fire(edat.ALL, GRAD, {"rank": 0, "grads": g})   # type-checked
        ctx.submit(step, deps=[(edat.ANY, GRAD)])           # routes as "grad"

    ``payload`` is a type (or tuple of types) that ``fire`` payloads must
    satisfy; ``None`` (the default) accepts anything.  A ``None`` payload
    is always allowed — events without data are common (pure signals).

    ``durable=True`` opts just this channel into the durable task log
    (:mod:`repro_torch.durable`): its fires are journaled and replayed onto
    survivors (or an elastic replacement) if the consuming rank dies.
    Durable payloads must pickle even on the inproc transport, and
    consumers should depend on ``(ANY, channel)`` — replayed events carry
    the recovery coordinator's rank as their source.
    """

    __slots__ = ("payload", "durable")

    def __new__(cls, eid: str, payload: PayloadSpec = None,
                durable: bool = False) -> "Channel":
        if eid.startswith("__"):
            raise ValueError(
                f"channel id {eid!r} is reserved (the __-prefix namespace "
                f"belongs to runtime-internal and machine-generated events)")
        self = super().__new__(cls, sys.intern(str(eid)))
        self.payload = payload
        self.durable = bool(durable)
        return self

    # -- validation -----------------------------------------------------------
    def validate(self, data: Any) -> None:
        """Raise ``TypeError`` if ``data`` does not satisfy the channel's
        payload type.  Called by ``Context.fire`` / ``fire_batch`` before
        any termination counter is touched."""
        t = self.payload
        if t is None or data is None:
            return
        if not isinstance(data, t):
            raise TypeError(
                f"channel {str.__str__(self)!r} expects payload of type "
                f"{getattr(t, '__name__', t)}, got {type(data).__name__}")

    # -- plumbing -------------------------------------------------------------
    def __reduce__(self):
        # events carry their eid across the socket transport: reconstruct
        # as a Channel (re-interning the id) rather than a bare str
        return (Channel, (str.__str__(self), self.payload, self.durable))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        extra = ""
        if self.payload is not None:
            extra += (f", payload="
                      f"{getattr(self.payload, '__name__', self.payload)}")
        if self.durable:
            extra += ", durable=True"
        return f"Channel({str.__repr__(self)}{extra})"
