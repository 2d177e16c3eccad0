"""A plain reader of the CLI's artifact files (`.cmt`, `.proof`).

The format: the magic `REEFTPU1`, a version varint (3), the kind as a
string, the payload, then the first 16 bytes of SHA-256 over everything
before them.  A value is a tag byte: 00 None, 01 False, 02 True; 03 an
integer (a sign byte, a length varint, the big-endian magnitude); 04
bytes and 05 a UTF-8 string (a length varint and the bytes); 06 a list
and 07 a tuple (a count varint and the items); 08 a record (its type's
name as a string value, a field count varint and the fields in order);
09 a packed vector of non-negative integers (a kind byte, 0 list or 1
tuple, a width varint, a count varint, each item `width` bytes little
endian).  Varints are unsigned LEB128.

A record reads as `Record`: its fields in order in `values`, and by
name for the types the check reads (`FIELDS`; of the IVC proof its
first two).
"""

from __future__ import annotations

import hashlib
from typing import Any, List

MAGIC = b"REEFTPU1"
VERSION = 3

FIELDS = {
    "ReefCommitment": ("nldoc", "merkle_root", "orig_doc_len", "udoc_len"),
    "NLDocCommitment": ("n_vars", "commit", "doc_commit_hash", "hash_salt",
                        "_coeffs", "_blinds"),
    "HyraxCommitment": ("row_commits", "n_vars", "l_left", "l_right"),
    "Proofs": ("ivc", "consist", "cap"),
    "ConsistencyProof": ("hash_d", "v_commit", "v_prime_commit",
                         "eval_proof", "running_q", "eq_proof", "l_commit",
                         "cap_proof"),
    "IpaProof": ("Ls", "Rs", "a_final", "rho_final"),
    "EqualityProof": ("alpha", "z"),
}
# the IVC proof's first two fields; the rest is the folds' and SNARKs'
IVC_FIELDS = ("n_steps", "zn")


class Record:
    def __init__(self, name: str, values: List[Any]):
        self.name, self.values = name, values
        names = FIELDS.get(name, IVC_FIELDS if name == "IVCProof" else ())
        if name in FIELDS and len(values) != len(names):
            raise ValueError(f"{name}: {len(values)} fields, "
                             f"{len(names)} due")
        for k, v in zip(names, values):
            setattr(self, k, v)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated artifact")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def varint(self) -> int:
        n = shift = 0
        while True:
            b = self.take(1)[0]
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7

    def value(self) -> Any:
        tag = self.take(1)[0]
        if tag in (0, 1, 2):
            return (None, False, True)[tag]
        if tag == 3:
            sign = self.take(1)[0]
            mag = int.from_bytes(self.take(self.varint()), "big")
            return -mag if sign else mag
        if tag == 4:
            return self.take(self.varint())
        if tag == 5:
            return self.take(self.varint()).decode("utf-8")
        if tag in (6, 7):
            items = [self.value() for _ in range(self.varint())]
            return items if tag == 6 else tuple(items)
        if tag == 8:
            name = self.value()
            return Record(name, [self.value() for _ in range(self.varint())])
        if tag == 9:
            kind = self.take(1)[0]
            width, count = self.varint(), self.varint()
            raw = self.take(width * count)
            items = [int.from_bytes(raw[i * width:(i + 1) * width], "little")
                     for i in range(count)]
            return tuple(items) if kind else items
        raise ValueError(f"unknown tag {tag:#04x}")


def loads(data: bytes, kind: str) -> Any:
    """The payload of an artifact of `kind` ("cmt" or "proof");
    ValueError for one that is malformed or of another kind."""
    body, check = data[:-16], data[-16:]
    if not body.startswith(MAGIC) or \
            hashlib.sha256(body).digest()[:16] != check:
        raise ValueError("not an artifact, or its checksum is off")
    r = _Reader(body)
    r.take(len(MAGIC))
    if r.varint() != VERSION or r.value() != kind:
        raise ValueError(f"not a version {VERSION} {kind} artifact")
    out = r.value()
    if r.pos != len(body):
        raise ValueError("bytes after the payload")
    return out

