"""Data-only artifact serialization (.cmt / .cmtkey / .proof files).

The reference bincode-serializes commitment and proof artifacts
(main.rs:36-39, 95-108) — bincode is a data-only format: decoding can never
execute code.  This module provides the same guarantee with a small tagged
binary codec: the only decodable types are None/bool/int/bytes/str/list/
tuple plus a fixed registry of protocol dataclasses reconstructed
field-by-field.  Nothing in the byte stream can name an arbitrary class or
invoke arbitrary callables (the round-1 pickle implementation was remote
code execution on any verifier fed a malicious artifact).

Wire format (all lengths are unsigned LEB128 varints):
    00                          None
    01 / 02                     False / True
    03 <sign:1> <len> <bytes>   int (big-endian magnitude)
    04 <len> <raw>              bytes
    05 <len> <utf8>             str
    06 <count> <items...>       list
    07 <count> <items...>       tuple
    08 <name:str-payload> <count> <items...>   registered dataclass
    09 <kind:1> <width> <count> <raw>          packed non-negative int
                                               vector (fixed-width LE;
                                               kind 0=list 1=tuple;
                                               minimal width enforced)

File layout: MAGIC || version || kind (str) || payload || sha256-16 of all
preceding bytes (integrity check — corruption is caught before structural
decoding reports confusing errors).
"""

from __future__ import annotations

import hashlib
import io
from typing import Any, Dict, List, Tuple

from ..errors import DecodeError

MAGIC = b"REEFTPU1"
VERSION = 3
MAX_DEPTH = 24
MAX_INT_BYTES = 64


# ---------------------------------------------------------------------------
# registry: the ONLY classes the decoder may construct
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Tuple[type, Tuple[str, ...]]] = {}


def _register(cls: type):
    import dataclasses
    fields = tuple(f.name for f in dataclasses.fields(cls))
    _REGISTRY[cls.__name__] = (cls, fields)


_LOADED = False


def _registry() -> Dict[str, Tuple[type, Tuple[str, ...]]]:
    global _LOADED
    if not _LOADED:
        from ..backend import commitment as CM
        from ..backend import framework as FW
        from ..backend import ipa as IPA
        from ..backend import nova as NV
        from ..backend import spartan as SP
        for cls in (CM.HyraxCommitment, CM.SigmaEvalProof, CM.EqualityProof,
                    CM.NLDocCommitment, CM.ConsistencyProof,
                    IPA.IpaProof, SP.SpartanProof,
                    FW.ReefCommitment, FW.Proofs, FW.CapProof,
                    NV.RelaxedInstance):
            _register(cls)
        try:
            from ..backend import ivc as IVC
            for cls in (IVC.IVCProof, IVC.IVCCheckpoint):
                _register(cls)
        except ImportError:
            pass
        _LOADED = True
    return _REGISTRY


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

def _w_varint(out: io.BytesIO, n: int):
    assert n >= 0
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


def _pack_ints(obj):
    """(width, raw) for a homogeneous non-negative int list, else None.

    Long int vectors (the 2^20-slot doc MLE, eq tables) dominated artifact
    encode/decode at ~2us/element through the per-element tag path; the
    packed form is fixed-width little-endian with numpy bulk conversion
    for word-aligned widths.  Width is minimal for the maximum element
    (enforced on decode), keeping the encoding canonical."""
    mx = 0
    for x in obj:
        if type(x) is not int or x < 0:
            return None
        if x > mx:
            mx = x
    width = max(1, (mx.bit_length() + 7) // 8)
    if width > MAX_INT_BYTES // 2:
        return None
    if width in (1, 2, 4, 8):
        import numpy as np
        dt = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[width]
        raw = np.asarray(list(obj) if isinstance(obj, tuple) else obj,
                         dtype=dt).tobytes()
    else:
        raw = b"".join(x.to_bytes(width, "little") for x in obj)
    return width, raw


def _encode(out: io.BytesIO, obj: Any, depth: int = 0):
    assert depth < MAX_DEPTH, "artifact structure too deep"
    if obj is None:
        out.write(b"\x00")
    elif obj is False:
        out.write(b"\x01")
    elif obj is True:
        out.write(b"\x02")
    elif isinstance(obj, int):
        mag = abs(obj)
        raw = mag.to_bytes((mag.bit_length() + 7) // 8, "big") if mag else b""
        assert len(raw) <= MAX_INT_BYTES, "integer too large for artifact"
        out.write(b"\x03")
        out.write(b"\x01" if obj < 0 else b"\x00")
        _w_varint(out, len(raw))
        out.write(raw)
    elif isinstance(obj, bytes):
        out.write(b"\x04")
        _w_varint(out, len(obj))
        out.write(obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.write(b"\x05")
        _w_varint(out, len(raw))
        out.write(raw)
    elif isinstance(obj, (list, tuple)):
        packed = _pack_ints(obj) if len(obj) >= 64 else None
        if packed is not None:
            width, raw = packed
            out.write(b"\x09")
            out.write(b"\x01" if isinstance(obj, tuple) else b"\x00")
            _w_varint(out, width)
            _w_varint(out, len(obj))
            out.write(raw)
        else:
            out.write(b"\x07" if isinstance(obj, tuple) else b"\x06")
            _w_varint(out, len(obj))
            for it in obj:
                _encode(out, it, depth + 1)
    else:
        name = type(obj).__name__
        reg = _registry()
        assert name in reg, f"unregistered artifact type {name}"
        _, fields = reg[name]
        out.write(b"\x08")
        _encode(out, name, depth + 1)
        _w_varint(out, len(fields))
        for fname in fields:
            _encode(out, getattr(obj, fname), depth + 1)


# ---------------------------------------------------------------------------
# decoding (strict: every read is bounds-checked; failures -> DecodeError)
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise DecodeError("truncated artifact")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        n = 0
        shift = 0
        while True:
            b = self.byte()
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7
            if shift > 63:
                raise DecodeError("varint overflow")

    def remaining(self) -> int:
        return len(self.data) - self.pos


def _decode(r: _Reader, depth: int = 0) -> Any:
    if depth >= MAX_DEPTH:
        raise DecodeError("artifact structure too deep")
    tag = r.byte()
    if tag == 0x00:
        return None
    if tag == 0x01:
        return False
    if tag == 0x02:
        return True
    if tag == 0x03:
        sign = r.byte()
        if sign not in (0, 1):
            raise DecodeError("bad int sign byte")
        ln = r.varint()
        if ln > MAX_INT_BYTES:
            raise DecodeError("integer too large")
        raw = r.take(ln)
        if ln and raw[0] == 0:
            raise DecodeError("non-canonical int (leading zero)")
        mag = int.from_bytes(raw, "big")
        if sign and mag == 0:
            raise DecodeError("non-canonical negative zero")
        return -mag if sign else mag
    if tag == 0x04:
        return r.take(r.varint())
    if tag == 0x05:
        try:
            return r.take(r.varint()).decode("utf-8")
        except UnicodeDecodeError:
            raise DecodeError("bad utf-8 string") from None
    if tag in (0x06, 0x07):
        count = r.varint()
        if count > r.remaining():      # every item needs >= 1 byte
            raise DecodeError("list count exceeds payload")
        items = [_decode(r, depth + 1) for _ in range(count)]
        return items if tag == 0x06 else tuple(items)
    if tag == 0x09:
        kindb = r.byte()
        if kindb not in (0, 1):
            raise DecodeError("bad packed-list kind byte")
        width = r.varint()
        if not 1 <= width <= MAX_INT_BYTES // 2:
            raise DecodeError("bad packed-list width")
        count = r.varint()
        if count * width > r.remaining():
            raise DecodeError("packed list exceeds payload")
        raw = r.take(count * width)
        if width > 1 and count:
            # canonical width: some element must use the top byte
            if not any(raw[i * width + width - 1]
                       for i in range(count)):
                raise DecodeError("non-canonical packed-list width")
        if width in (1, 2, 4, 8):
            import numpy as np
            dt = {1: np.uint8, 2: np.uint16, 4: np.uint32,
                  8: np.uint64}[width]
            items = np.frombuffer(raw, dtype=dt).tolist()
        else:
            items = [int.from_bytes(raw[i * width:(i + 1) * width],
                                    "little") for i in range(count)]
        return tuple(items) if kindb else items
    if tag == 0x08:
        name = _decode(r, depth + 1)
        if not isinstance(name, str):
            raise DecodeError("object name must be a string")
        reg = _registry()
        if name not in reg:
            raise DecodeError(f"unknown artifact type {name!r}")
        cls, fields = reg[name]
        count = r.varint()
        if count != len(fields):
            raise DecodeError(f"{name}: field count mismatch")
        vals = [_decode(r, depth + 1) for _ in range(count)]
        obj = object.__new__(cls)          # no __init__/__post_init__ side
        for fname, v in zip(fields, vals):  # effects on untrusted data
            object.__setattr__(obj, fname, v)
        return obj
    raise DecodeError(f"unknown tag 0x{tag:02x}")


# ---------------------------------------------------------------------------
# file API
# ---------------------------------------------------------------------------

def dumps(kind: str, obj: Any) -> bytes:
    out = io.BytesIO()
    out.write(MAGIC)
    _w_varint(out, VERSION)
    _encode(out, kind)
    _encode(out, obj)
    body = out.getvalue()
    return body + hashlib.sha256(body).digest()[:16]


def loads(data: bytes, kind: str) -> Any:
    if len(data) < len(MAGIC) + 17 or data[:len(MAGIC)] != MAGIC:
        raise DecodeError("not a reef_tpu artifact")
    body, chk = data[:-16], data[-16:]
    if hashlib.sha256(body).digest()[:16] != chk:
        raise DecodeError("artifact checksum mismatch")
    r = _Reader(body)
    r.take(len(MAGIC))
    version = r.varint()
    if version != VERSION:
        raise DecodeError(f"artifact version {version} != {VERSION}")
    got_kind = _decode(r)
    if got_kind != kind:
        raise DecodeError(f"expected {kind} artifact, got {got_kind!r}")
    payload = _decode(r)
    if r.remaining():
        raise DecodeError("trailing bytes after payload")
    return payload


def save(path: str, kind: str, obj) -> int:
    """Atomic write (tmp + rename): a crash mid-write must never destroy
    the previous artifact — checkpoints exist precisely for the
    killed-prover case."""
    import os
    data = dumps(kind, obj)
    tmp = path + ".tmp.%d" % os.getpid()
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, path)
    return len(data)


def load(path: str, kind: str):
    with open(path, "rb") as fh:
        raw = fh.read()
    try:
        return loads(raw, kind)
    except DecodeError as e:
        raise ValueError(f"{path}: {e}") from None
