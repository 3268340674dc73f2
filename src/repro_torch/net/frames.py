"""Wire format for :class:`repro_torch.net.SocketTransport`.

Two frame layouts share one 4-byte big-endian header word:

**Plain frame** (header high bit clear): the header is the body length and
the body is one pickled Python object — always a tuple tagged with its
kind:

* ``("msg", Message)`` — a runtime :class:`~repro_torch.core.transport.Message`
  (EVENT or CONTROL);
* ``("hello", rank)`` — connection preamble identifying the dialing peer;
* ``("hb",)`` — heartbeat (liveness only, never surfaced to the runtime);
* ``("bye",)`` — clean close: the peer is shutting down deliberately, so
  the subsequent EOF must *not* be reported as a failure.

**Batch frame** (header high bit set): the writer-side coalescing layer
packs *many* messages into one frame per syscall.  The body carries a
buffer table followed by the out-of-band buffers and the main pickle —
pickle protocol 5 with ``buffer_callback``, so numpy payloads (BFS
frontiers, MONC field slices) are serialised **zero-copy**: the array
bytes are never copied into the pickle stream; on the wire they travel as
scatter/gather segments, and on the read side they are reconstructed as
views over one mutable body buffer::

    header   = (len(body)) | BATCH_BIT                  # 4 bytes
    body     = nbufs (4B) | buflen_0 (8B) ... buflen_{n-1} (8B)
             | buf_0 ... buf_{n-1} | main_pickle

Decoded batch frames are ``("msgs", [obj, ...])``.

Frames from one sender are written by a single writer (per-connection lock
or dedicated writer thread) and read by a single reader thread, so
per-(src,dst) FIFO order is exactly the TCP byte order — for batch frames,
intra-batch order is list order.

Robustness contract (fuzz-tested by ``tests/test_net_frames.py``): a
truncated stream or mid-frame EOF decodes to ``None``; a garbage header
(length beyond :data:`MAX_FRAME`) or a corrupt body raises — decoders
never block forever on a complete-but-bad byte stream.
"""
from __future__ import annotations

import pickle
import socket
import struct
from typing import Any, List, Optional, Sequence

_LEN = struct.Struct(">I")
_NBUF = struct.Struct(">I")
_BUFLEN = struct.Struct(">Q")

#: refuse absurd frames (corruption guard), 1 GiB
MAX_FRAME = 1 << 30

#: high bit of the header word marks a batch frame (MAX_FRAME leaves the
#: top two bits of the 4-byte length free)
BATCH_BIT = 0x8000_0000

MSG = "msg"
MSGS = "msgs"            # decoded batch frames: ("msgs", [obj, ...])
HELLO = "hello"
HEARTBEAT = "hb"
BYE = "bye"

# elastic join (late processes re-hosting a dead process's ranks):
JOIN = "join"                  # ("join", lead, ranks, addr) -> coordinator
WELCOME = "welcome"            # ("welcome", {...}) coordinator's acceptance
NOJOIN = "nojoin"              # ("nojoin", reason): refused, retry later
PEER_JOINED = "peer_joined"    # ("peer_joined", lead, addr): dial newcomer


def encode(obj: Any) -> bytes:
    """Serialise ``obj`` into one length-prefixed plain frame."""
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return _LEN.pack(len(data)) + data


def encode_batch(objs: Sequence[Any], oob: bool = True) -> List[Any]:
    """Serialise a sequence of objects into one batch frame, returned as a
    list of bytes-like pieces suitable for a vectored send.

    With ``oob=True`` the large buffers are pickled out-of-band: the
    returned pieces include *views* of the original payloads — zero-copy,
    so the caller must own the payloads (nobody mutates them before the
    send completes).  ``oob=False`` pickles everything in-band, producing a
    self-contained snapshot at the cost of one copy — the right mode when
    the firing task may still mutate the payload after ``fire`` returns.

    Falls back to in-band pickling for payloads whose buffers are not
    contiguous (``PickleBuffer.raw`` refuses those).
    """
    raws: List[Any] = []
    if oob:
        pbufs: List[pickle.PickleBuffer] = []
        try:
            main = pickle.dumps(list(objs), protocol=5,
                                buffer_callback=pbufs.append)
            raws = [pb.raw() for pb in pbufs]
        except Exception:
            # non-contiguous buffer or an exotic reducer: in-band pickle
            main = pickle.dumps(list(objs), protocol=pickle.HIGHEST_PROTOCOL)
            raws = []
    else:
        main = pickle.dumps(list(objs), protocol=pickle.HIGHEST_PROTOCOL)
    table = _NBUF.pack(len(raws)) + b"".join(
        _BUFLEN.pack(len(r)) for r in raws)
    body_len = len(table) + sum(len(r) for r in raws) + len(main)
    if body_len > MAX_FRAME:
        raise ValueError(f"batch frame of {body_len} bytes exceeds "
                         f"MAX_FRAME; split the batch")
    return [_LEN.pack(body_len | BATCH_BIT) + table, *raws, main]


def decode_batch_body(body) -> Any:
    """Decode a batch-frame body (without the 4-byte header) back into
    ``("msgs", [obj, ...])``.  ``body`` should be a *mutable* buffer
    (``bytearray``) so reconstructed numpy arrays are writable views.
    Raises ``ValueError`` on a corrupt buffer table."""
    mv = memoryview(body)
    n = len(mv)
    if n < _NBUF.size:
        raise ValueError("batch frame too short for buffer table")
    (nbufs,) = _NBUF.unpack_from(mv, 0)
    off = _NBUF.size
    if nbufs > (n - off) // _BUFLEN.size:
        raise ValueError(f"batch frame claims {nbufs} buffers, body too small")
    lens = []
    for _ in range(nbufs):
        (ln,) = _BUFLEN.unpack_from(mv, off)
        off += _BUFLEN.size
        lens.append(ln)
    bufs = []
    for ln in lens:
        if off + ln > n:
            raise ValueError("batch frame buffer overruns body")
        bufs.append(mv[off:off + ln])
        off += ln
    objs = pickle.loads(mv[off:], buffers=bufs)
    if not isinstance(objs, list):
        raise ValueError(f"batch frame decoded to {type(objs).__name__}, "
                         f"expected list")
    return (MSGS, objs)


def send_frame(sock: socket.socket, obj: Any) -> None:
    sock.sendall(encode(obj))


def decode_buffer(buf) -> "tuple[List[Any], int, bool]":
    """Incremental decoder over a receive buffer: decode every *complete*
    frame in ``buf`` and return ``(frames, consumed_bytes, corrupt)``.

    A partial trailing frame is simply left unconsumed (the caller appends
    more bytes and calls again); ``corrupt`` is True when the buffer holds
    a garbage header or an undecodable body — the caller must treat the
    connection as broken, after dispatching the frames decoded so far.
    Batch-frame bodies are sliced into fresh ``bytearray``\\ s, so their
    zero-copy numpy payloads stay valid (and writable) after the caller
    compacts ``buf``.
    """
    out: List[Any] = []
    off = 0
    total = len(buf)
    while True:
        if total - off < _LEN.size:
            return out, off, False
        (word,) = _LEN.unpack_from(buf, off)
        n = word & ~BATCH_BIT
        if n > MAX_FRAME:
            return out, off, True
        start = off + _LEN.size
        if total - start < n:
            return out, off, False
        body = bytearray(memoryview(buf)[start:start + n])
        off = start + n
        try:
            if word & BATCH_BIT:
                out.append(decode_batch_body(body))
            else:
                out.append(pickle.loads(body))
        except Exception:
            return out, off, True


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    """Read exactly ``n`` bytes; None on EOF (including mid-frame EOF)."""
    buf = bytearray(n)
    mv = memoryview(buf)
    got = 0
    while got < n:
        try:
            k = sock.recv_into(mv[got:])
        except OSError:
            return None
        if not k:
            return None
        got += k
    return buf


def recv_frame(sock: socket.socket) -> Optional[Any]:
    """Read one frame (plain or batch); None on EOF."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (word,) = _LEN.unpack(head)
    n = word & ~BATCH_BIT
    if n > MAX_FRAME:
        raise ValueError(f"frame length {n} exceeds MAX_FRAME")
    body = _recv_exact(sock, n)
    if body is None:
        return None
    if word & BATCH_BIT:
        return decode_batch_body(body)
    return pickle.loads(body)


def _readinto_exact(f, buf) -> bool:
    """Fill ``buf`` completely from a buffered reader; False on EOF."""
    mv = memoryview(buf)
    got = 0
    while got < len(buf):
        k = f.readinto(mv[got:])
        if not k:
            return False
        got += k
    return True


def recv_frame_buffered(f) -> Optional[Any]:
    """Like :func:`recv_frame` but over a buffered binary file object
    (``sock.makefile("rb")``) — a burst of small frames costs one syscall,
    not two per frame.  Batch-frame bodies are read into one mutable
    buffer, so zero-copy numpy payloads decode to *writable* array views
    of it."""
    head = bytearray(_LEN.size)
    if not _readinto_exact(f, head):
        return None
    (word,) = _LEN.unpack(head)
    n = word & ~BATCH_BIT
    if n > MAX_FRAME:
        raise ValueError(f"frame length {n} exceeds MAX_FRAME")
    body = bytearray(n)
    if not _readinto_exact(f, body):
        return None
    if word & BATCH_BIT:
        return decode_batch_body(body)
    return pickle.loads(body)
