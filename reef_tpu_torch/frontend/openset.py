"""Sets of possibly-open integer ranges (char classes and skip sets).

Mirrors the observable behavior of the reference's OpenSet
(reference src/frontend/openset.rs): a sorted, merged set of ranges
``[(a, b), ..., (c, None)]`` over a domain that starts at 0 and is unbounded
above (chars are handled as unicode codepoints).  ``None`` as a range end
means open/unbounded ("*").

Used both as character classes (regex CharClass) and as skip sets over
document offsets (``.{i,j}`` / ``.*`` edges in the SAFA,
reference src/frontend/safa.rs:56 `type Skip = OpenSet<usize>`).

Implementation is my own: ranges normalized at construction (sorted by start,
overlapping/adjacent ranges merged), stored as an immutable tuple so OpenSets
are hashable (the regex AST hash-conses terms containing them).
"""

from __future__ import annotations

import functools
from typing import Iterable, Optional, Tuple

Range = Tuple[int, Optional[int]]


def _normalize(ranges: Iterable[Range]) -> Tuple[Range, ...]:
    rs = [(s, e) for (s, e) in ranges if e is None or e >= s]
    rs.sort(key=lambda r: (r[0], r[1] is not None, r[1] if r[1] is not None else 0))
    out: list[Range] = []
    for s, e in rs:
        if out:
            ps, pe = out[-1]
            if pe is None:
                # previous open range absorbs everything after ps
                continue
            if s <= pe + 1:  # overlap or adjacency: merge
                if e is None:
                    out[-1] = (ps, None)
                else:
                    out[-1] = (ps, max(pe, e))
                continue
        out.append((s, e))
    return tuple(out)


@functools.total_ordering
class OpenSet:
    """Immutable normalized set of ranges over non-negative ints."""

    __slots__ = ("ranges", "_hash")

    def __init__(self, ranges: Iterable[Range] = ()):
        object.__setattr__(self, "ranges", _normalize(ranges))
        object.__setattr__(self, "_hash", hash(self.ranges))

    # -- constructors ------------------------------------------------------
    @staticmethod
    def empty() -> "OpenSet":
        return _EMPTY

    @staticmethod
    def closed(a: int, b: int) -> "OpenSet":
        return OpenSet([(a, b)]) if b >= a else _EMPTY

    @staticmethod
    def open(a: int) -> "OpenSet":
        return OpenSet([(a, None)])

    @staticmethod
    def single(a: int) -> "OpenSet":
        return OpenSet([(a, a)])

    @staticmethod
    def nil() -> "OpenSet":
        """The {0} set (zero-length skip / epsilon)."""
        return _NIL

    @staticmethod
    def star() -> "OpenSet":
        """The [0, *] set."""
        return OpenSet([(0, None)])

    @staticmethod
    def build(items: Iterable[int]) -> "OpenSet":
        return OpenSet([(i, i) for i in items])

    # -- predicates --------------------------------------------------------
    def is_empty(self) -> bool:
        return not self.ranges

    def is_full(self) -> bool:
        return any(s == 0 and e is None for s, e in self.ranges)

    def is_open(self) -> bool:
        return any(e is None for _, e in self.ranges)

    def is_nil(self) -> bool:
        return self.is_single() == 0

    def is_nullable(self) -> bool:
        """Contains 0 as its minimum element."""
        return bool(self.ranges) and self.ranges[0][0] == 0

    def is_single(self) -> Optional[int]:
        if len(self.ranges) == 1:
            s, e = self.ranges[0]
            if e == s:
                return s
        return None

    def contains(self, c: int) -> bool:
        for s, e in self.ranges:
            if s <= c and (e is None or c <= e):
                return True
        return False

    def start(self) -> Optional[int]:
        return self.ranges[0][0] if self.ranges else None

    def first(self) -> Optional[Range]:
        return self.ranges[0] if self.ranges else None

    def max_offset(self) -> Optional[int]:
        """Largest finite bound of the last range (start if open-ended)."""
        if not self.ranges:
            return None
        s, e = self.ranges[-1]
        return s if e is None else max(s, e)

    def __len__(self) -> int:
        return len(self.ranges)

    # -- algebra -----------------------------------------------------------
    def union(self, o: "OpenSet") -> "OpenSet":
        return OpenSet(self.ranges + o.ranges)

    def intersection(self, o: "OpenSet") -> "OpenSet":
        out = []
        for s1, e1 in self.ranges:
            for s2, e2 in o.ranges:
                s = max(s1, s2)
                if e1 is None:
                    e = e2
                elif e2 is None:
                    e = e1
                else:
                    e = min(e1, e2)
                if e is None or s <= e:
                    out.append((s, e))
        return OpenSet(out)

    def negate(self) -> "OpenSet":
        """Complement within the [0, *) domain."""
        out = []
        lo = 0
        for s, e in self.ranges:
            if s > lo:
                out.append((lo, s - 1))
            if e is None:
                return OpenSet(out)
            lo = e + 1
        out.append((lo, None))
        return OpenSet(out)

    def diff(self, o: "OpenSet") -> "OpenSet":
        return self.intersection(o.negate())

    def kleene(self) -> "OpenSet":
        """EXACT Kleene closure, or None when it is not representable as a
        finite union of (possibly open) ranges.

        The reference returns [0, inf) for every non-nil set
        (openset.rs:409-415) — unsound for strided sets: ({2})* is the
        even numbers, so a `(..)*`-shaped skip must NOT become a
        jump-anywhere edge (fuzz-found over-match).  Exactly
        representable cases:
          - 1 in S                    -> [0, inf)
          - single interval [a, b], b > a (or open): the k-fold sums
            [ka, kb] merge once (k+1)a <= kb + 1 -> {0} U intervals U
            [Ka, inf)
        Anything else (e.g. the single stride {k}, k > 1, or multi-range
        sets with gcd > 1) returns None and the caller falls back to
        derivative edges, which are always sound."""
        if self.is_empty() or self.is_nil():
            return OpenSet.nil()
        if self.contains(1):
            return OpenSet([(0, None)])
        if len(self.ranges) == 1:
            a, b = self.ranges[0]
            if b is None:
                return OpenSet([(0, 0), (a, None)])
            if b > a:
                out = [(0, 0)]
                k = 1
                while (k + 1) * a > k * b + 1:
                    out.append((k * a, k * b))
                    k += 1
                out.append((k * a, None))
                return OpenSet(out)
        return None

    # -- usize (skip offset) arithmetic ------------------------------------
    def app(self, o: "OpenSet") -> "OpenSet":
        """Minkowski sum: {a+b | a in self, b in o} (skip concatenation)."""
        out = []
        for s1, e1 in self.ranges:
            for s2, e2 in o.ranges:
                e = None if (e1 is None or e2 is None) else e1 + e2
                out.append((s1 + s2, e))
        return OpenSet(out)

    def times(self, n: int) -> "OpenSet":
        """n-fold Minkowski sum.  Closed form for a single range (the sum
        of n copies of an interval is an interval); binary doubling
        (O(log n) sums) otherwise — the naive n-iteration loop made
        `.{976}`-scale DNA skips an O(doc) frontend cost."""
        if self.is_empty():
            return _EMPTY
        if n == 0:
            return OpenSet.nil()
        if len(self.ranges) == 1:
            s, e = self.ranges[0]
            return OpenSet([(s * n, None if e is None else e * n)])
        r = OpenSet.nil()
        base = self
        m = n
        while m:
            if m & 1:
                r = r.app(base)
            m >>= 1
            if m:
                base = base.app(base)
        return r

    def repeat(self, i: int, j: int) -> "OpenSet":
        if self.is_empty() and i == 0:
            return OpenSet.nil()
        if self.is_empty() or j < i:
            return _EMPTY
        if i == j:
            return self.times(i)
        t = self.times(i)
        acc = t
        for _ in range(i, j):
            t = t.app(self)
            acc = acc.union(t)
        return acc

    # -- iteration ---------------------------------------------------------
    def __iter__(self):
        """Iterate members in increasing order (unbounded if open!)."""
        ranges = list(self.ranges)
        i = 0
        while i < len(ranges):
            s, e = ranges[i]
            v = s
            while e is None or v <= e:
                yield v
                v += 1
            i += 1

    def iter_bounded(self, bound: int):
        """Members <= bound, in increasing order (safe for open sets)."""
        for s, e in self.ranges:
            hi = bound if e is None else min(e, bound)
            for v in range(s, hi + 1):
                yield v

    # -- dunder ------------------------------------------------------------
    def __eq__(self, o):
        return isinstance(o, OpenSet) and self.ranges == o.ranges

    def __lt__(self, o):
        key = lambda rs: tuple((s, e is None, e if e is not None else -1) for s, e in rs)
        return key(self.ranges) < key(o.ranges)

    def __hash__(self):
        return self._hash

    def __repr__(self):
        if self.is_nil():
            return "ε"
        parts = []
        for s, e in self.ranges:
            if e is None:
                parts.append(f"{s}-*")
            elif e == s:
                parts.append(f"{s}")
            else:
                parts.append(f"{s}-{e}")
        return "[" + ", ".join(parts) + "]" if parts else "∅"


_EMPTY = OpenSet.__new__(OpenSet)
object.__setattr__(_EMPTY, "ranges", ())
object.__setattr__(_EMPTY, "_hash", hash(()))

_NIL = OpenSet([(0, 0)])
