"""The document commitment worked out again: Hyrax over Pallas, as the
CLI's `--commit --seed S` defines it.

The document's characters become their indices in the alphabet, then
the end-of-file code (|ab| + 2) and the epsilon code (|ab| + 1), padded
with zeros to 2^k entries; chr(26) counts as end of file.  The 2^k
entries are a (2^(k // 2)) x (2^(k - k // 2)) matrix, row by row.  Row j
commits to blind_j * H + sum_c M[j][c] * G_c, with G_c the generators of
the label b"doc/vec", H that of b"reef/blind", and the blinds, then the
hash salt, drawn by Python's `random.Random(S).randrange(q)` in that
order.

The check takes one random combination of the rows (weights below 2^40
from the checker's own seed): sum_j r_j Row_j must equal
sum_c (sum_j r_j M[j][c]) G_c + (sum_j r_j blind_j) H.  A wrong row
passes with probability 2^-40.  The row hash is worked out again with
the plain Poseidon (`poseidon.row_hash`).
"""

from __future__ import annotations

import random
from typing import List, Sequence

import numpy as np

from . import curve, poseidon

EOF_CHAR = 26
R_BITS = 40

def udoc(alphabet: Sequence[int], doc: bytes) -> np.ndarray:
    """The committed vector of a document over an enumerated alphabet."""
    lut = np.full(256, -1, dtype=np.int64)
    for i, c in enumerate(alphabet):
        lut[c] = i
    n_ab = len(alphabet)
    lut[EOF_CHAR] = n_ab + 2
    codes = lut[np.frombuffer(doc, dtype=np.uint8)]
    if (codes < 0).any():
        raise ValueError("document holds a character outside the alphabet")
    body = np.concatenate([codes, [n_ab + 2, n_ab + 1]])
    n = 1 << max(1, (len(body) - 1).bit_length())
    return np.concatenate([body, np.zeros(n - len(body), dtype=np.int64)])


def mismatches(cmt, alphabet: Sequence[int], doc: bytes, seed: int,
               check_seed: int) -> List[str]:
    """What in the public commitment `cmt` (a `.cmt` artifact read by
    `artifact.loads`) differs from the document's commitment; empty when
    it is right."""
    u = udoc(alphabet, doc)
    k = len(u).bit_length() - 1
    left = k // 2
    rows, cols = 1 << left, 1 << (k - left)
    rng = random.Random(seed)
    blinds = [rng.randrange(curve.Q) for _ in range(rows)]
    salt = rng.randrange(curve.Q)
    nl = cmt.nldoc
    if nl is None:
        return ["no Hyrax commitment"]
    off = []
    if (cmt.orig_doc_len, cmt.udoc_len) != (len(doc), len(u)):
        off.append(f"lengths {(cmt.orig_doc_len, cmt.udoc_len)} != "
                   f"{(len(doc), len(u))}")
    if (nl.n_vars, nl.commit.l_left, nl.commit.l_right) != (k, left,
                                                           k - left):
        off.append(f"shape {(nl.n_vars, nl.commit.l_left)} != {(k, left)}")
    if nl.hash_salt != salt:
        off.append("hash salt")
    pts = [tuple(p) for p in nl.commit.row_commits]
    if len(pts) != rows or not all(curve.on_curve(p) for p in pts):
        off.append(f"{len(pts)} rows, {rows} due, or a row off the curve")
        return off
    rr = random.Random(check_seed)
    r = [rr.randrange(1, 1 << R_BITS) for _ in range(rows)]
    m = u.reshape(rows, cols)
    if int(m.max()) * rows << R_BITS >= 1 << 62:
        m = m.astype(object)
    col = [int(v) for v in np.array(r, dtype=m.dtype) @ m]
    lhs = curve.msm(r, pts)
    rhs = curve.add(curve.msm(col, curve.generators(b"doc/vec", cols)),
                    curve.mul(sum(a * b for a, b in zip(r, blinds)),
                              curve.hash_to_curve(b"reef/blind")))
    if curve.to_affine(lhs) != curve.to_affine(rhs):
        off.append("row commitments")
    if poseidon.row_hash(pts) != nl.doc_commit_hash:
        off.append("row hash")
    return off
