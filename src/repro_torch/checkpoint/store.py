"""Checkpointing: atomic, sharded-by-leaf, restart-safe.

The counterpart of ``repro.checkpoint.store``, with its layout::

    <dir>/step_<N>/
      meta.msgpack   {step, extra}
      arrays.npz     flat {path: array} (single host container)
    <dir>/LATEST     atomic pointer file

Arrays are written via a temp directory + rename so a crash mid-save never
corrupts the latest checkpoint.  A checkpoint written by either package
restores in the other.

Two things differ from the reference's code, not from its files:

* ``meta.msgpack`` is written and read by this module's own codec for the
  subset a checkpoint's meta holds (maps, str, int, float, bool, None,
  lists), byte for byte what ``msgpack.packb`` writes; the package does not
  need ``msgpack``.
* bf16 leaves are stored as the reference's are: raw two-byte records
  (``|V2``, the bits of each value), since numpy has no bfloat16.  ``save``
  writes a ``torch.bfloat16`` tensor so, and :func:`to_tensor` reads such a
  leaf back as ``torch.bfloat16``.

Restore returns plain numpy leaves; the caller moves them to its device.
"""
from __future__ import annotations

import os
import shutil
import struct
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

BF16_RECORD = np.dtype("V2")


# ----------------------------------------------------------- meta codec
def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for maps, str, int, float, bool, None, lists
    and tuples."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, fix: int, fix_max: int, codes, out: bytearray):
    if n <= fix_max:
        out.append(fix | n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[0], n)
    else:
        out += struct.pack(">BI", codes[1], n)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xcb, obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(0xa0 | n)
        elif n < 1 << 8:
            out += struct.pack(">BB", 0xd9, n)
        elif n < 1 << 16:
            out += struct.pack(">BH", 0xda, n)
        else:
            out += struct.pack(">BI", 0xdb, n)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (0xdc, 0xdd), out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (0xde, 0xdf), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128 or -32 <= n < 0:
        out += struct.pack(">b" if n < 0 else ">B", n)
    elif n >= 0:
        for code, fmt, top in ((0xcc, "B", 8), (0xcd, "H", 16),
                               (0xce, "I", 32), (0xcf, "Q", 64)):
            if n < 1 << top:
                out += struct.pack(">B" + fmt, code, n)
                return
        raise OverflowError("Integer value out of range")
    else:
        for code, fmt, top in ((0xd0, "b", 7), (0xd1, "h", 15),
                               (0xd2, "i", 31), (0xd3, "q", 63)):
            if n >= -(1 << top):
                out += struct.pack(">B" + fmt, code, n)
                return
        raise OverflowError("Integer value out of range")


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LEN = {0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xdc: ">H", 0xdd: ">I",
        0xde: ">H", 0xdf: ">I"}


def unpackb(data: bytes):
    """``msgpack.unpackb(data)`` for what :func:`packb` writes (arrays
    come back as lists, as msgpack's do)."""
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError("extra data after the packed object")
    return obj


def _unpack(buf, i):
    code = buf[i]
    i += 1
    if code <= 0x7f:
        return code, i
    if code >= 0xe0:
        return code - 0x100, i
    if code in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[code], i
    if code in _FIXED:
        fmt = _FIXED[code]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    if code in _LEN:
        n = struct.unpack_from(_LEN[code], buf, i)[0]
        i += struct.calcsize(_LEN[code])
        kind = {0xd9: "str", 0xda: "str", 0xdb: "str", 0xdc: "list",
                0xdd: "list"}.get(code, "map")
    elif 0xa0 <= code <= 0xbf:
        n, kind = code & 0x1f, "str"
    elif 0x90 <= code <= 0x9f:
        n, kind = code & 0x0f, "list"
    elif 0x80 <= code <= 0x8f:
        n, kind = code & 0x0f, "map"
    else:
        raise ValueError(f"unsupported msgpack type 0x{code:02x}")
    if kind == "str":
        return bytes(buf[i:i + n]).decode("utf-8"), i + n
    if kind == "list":
        out = []
        for _ in range(n):
            x, i = _unpack(buf, i)
            out.append(x)
        return out, i
    m = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        m[k], i = _unpack(buf, i)
    return m, i


# ---------------------------------------------------------------- arrays
def to_numpy(x) -> np.ndarray:
    """A leaf as a host numpy array; a bf16 tensor as its ``|V2`` bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(BF16_RECORD)
        return x.numpy()
    return np.asarray(x)


def to_tensor(a, device=None, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """A restored leaf as a tensor on ``device`` (cast to ``dtype`` if
    given); a ``|V2`` leaf holds bf16 bits."""
    a = np.asarray(a)
    if a.dtype == BF16_RECORD:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))       # a writable copy
    return t.to(device=device, dtype=dtype)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/#{i}"))
        if len(tree) == 0:
            out[prefix + "/#empty"] = np.zeros((0,), np.int32)
    elif tree is None:
        out[prefix + "/#none"] = np.zeros((0,), np.int32)
    else:
        out[prefix] = to_numpy(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray], proto):
    """Rebuild using a prototype tree for structure."""
    def rec(proto, prefix):
        if isinstance(proto, dict):
            return {k: rec(v, f"{prefix}/{k}") for k, v in proto.items()}
        if isinstance(proto, (list, tuple)):
            vals = [rec(v, f"{prefix}/#{i}") for i, v in enumerate(proto)]
            return type(proto)(vals)
        if proto is None:
            return None
        return flat[prefix]
    return rec(proto, "")


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Atomic save; returns the checkpoint path.  Leaves are tensors (any
    device) or numpy arrays."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    flat = {k.lstrip("/"): v for k, v in flat.items()}  # zip-safe names
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        meta = {"step": step, "extra": extra or {}}
        with open(os.path.join(tmp, "meta.msgpack"), "wb") as f:
            f.write(packb(meta))
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic LATEST pointer
    ptr = os.path.join(ckpt_dir, "LATEST")
    with tempfile.NamedTemporaryFile("w", dir=ckpt_dir, delete=False) as f:
        f.write(f"step_{step:08d}")
        tmpname = f.name
    os.replace(tmpname, ptr)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    path = os.path.join(ckpt_dir, name)
    if not os.path.exists(path):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, proto: Any,
            step: Optional[int] = None) -> Tuple[int, Any, Dict]:
    """Restore (step, tree, extra).  ``proto`` provides the structure (e.g.
    a freshly-initialised state); leaves are numpy arrays, bf16 ones as
    ``|V2`` records (:func:`to_tensor` reads them)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.msgpack"), "rb") as f:
        meta = unpackb(f.read())
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {f"/{k}" if not k.startswith("/") else k: z[k] for k in z.files}
    tree = _unflatten(flat, proto)
    return meta["step"], tree, meta.get("extra", {})
