"""Hash-consed regex AST with algebraic smart constructors and derivatives.

Mirrors the observable semantics of the reference's RegexF
(reference src/frontend/regex/mod.rs): terms
{Nil, Dot, CharClass, App, Alt, And, Range, Star}, a partial subset order
`partial_le` driving simplification, nullability, Brzozowski derivatives, and
skip extraction (`.`, `.{i,j}`, `.*` prefixes become cursor-jump Skip sets,
mod.rs:318-350).  `And(a, b)` encodes the lookahead conjunction `(?=a)b`.

Hash-consing: every term is interned in a module-global table so structural
equality is pointer equality; each term carries a stable intern id used as the
total order (the reference's ord.rs serves the same canonicalization role —
only self-consistency matters, the verifier re-derives everything).
"""

from __future__ import annotations

from typing import Optional, Tuple

from .openset import OpenSet

# variant tags
NIL, DOT, CHARCLASS, APP, ALT, AND, RANGE, STAR = range(8)
_TAG_NAMES = ["Nil", "Dot", "CharClass", "App", "Alt", "And", "Range", "Star"]

_TABLE: dict = {}
_COUNTER = [0]


class Regex:
    """Interned regex term.  Compare with `is` / `==` (same thing here)."""

    __slots__ = ("tag", "a", "b", "lo", "hi", "cc", "uid", "_null")

    def __repr__(self):
        t = self.tag
        if t == NIL:
            return "ε"
        if t == DOT:
            return "."
        if t == CHARCLASS:
            if self.cc.is_empty():
                return "∅"
            parts = []
            for s, e in self.cc.ranges:
                cs = chr(s) if 32 <= s < 127 else f"\\x{s:02x}"
                if e is None:
                    parts.append(f"{cs}-*")
                elif e == s:
                    parts.append(cs)
                else:
                    ce = chr(e) if 32 <= e < 127 else f"\\x{e:02x}"
                    parts.append(f"{cs}-{ce}")
            return "[" + "".join(parts) + "]"
        if t == APP:
            return f"{self.a!r}{self.b!r}"
        if t == ALT:
            return f"({self.a!r} | {self.b!r})"
        if t == AND:
            return f"(?={self.a!r}){self.b!r}"
        if t == STAR:
            inner = repr(self.a)
            return f"({inner})*" if self.a.tag in (APP, ALT, AND, STAR) else f"{inner}*"
        if t == RANGE:
            if self.lo == 0 and self.hi == 1:
                return f"{self.a!r}?"
            if self.lo == self.hi:
                return f"{self.a!r}{{{self.lo}}}"
            return f"{self.a!r}{{{self.lo},{self.hi}}}"
        return "?"


def _mk(tag, a=None, b=None, lo=0, hi=0, cc=None) -> Regex:
    key = (tag, id(a) if a is not None else None, id(b) if b is not None else None,
           lo, hi, cc)
    r = _TABLE.get(key)
    if r is None:
        r = Regex.__new__(Regex)
        r.tag, r.a, r.b, r.lo, r.hi, r.cc = tag, a, b, lo, hi, cc
        r.uid = _COUNTER[0]
        r._null = None
        _COUNTER[0] += 1
        _TABLE[key] = r
    return r


def reset_terms() -> None:
    """Forget every interned term and every cached derivative, as in a
    fresh process.  The intern ids order the canonical forms (`simpl`'s
    sorted alternatives, the SAFA's fork children); `safa.from_regex`
    resets before each build.  Terms built before a reset must not be
    combined with terms built after it."""
    _TABLE.clear()
    _COUNTER[0] = 0
    _DERIV_CACHE.clear()
    _BOUNDS_CACHE.clear()


# ---------------------------------------------------------------------------
# raw constructors (used by the parser; `simpl` applies the smart ones)
# ---------------------------------------------------------------------------

def nil() -> Regex:
    return _mk(NIL)


def dot() -> Regex:
    return _mk(DOT)


def empty() -> Regex:
    return _mk(CHARCLASS, cc=OpenSet.empty())


def charclass_raw(cc: OpenSet) -> Regex:
    return _mk(CHARCLASS, cc=cc)


def character(c) -> Regex:
    cp = ord(c) if isinstance(c, str) else int(c)
    return _mk(CHARCLASS, cc=OpenSet.single(cp))


def charclass(cc: OpenSet) -> Regex:
    """Class constructor with full/empty canonicalization (mod.rs:107-123)."""
    if cc.negate().is_empty():
        return dot()
    if cc.is_empty():
        return empty()
    return _mk(CHARCLASS, cc=cc)


def app_raw(a: Regex, b: Regex) -> Regex:
    return _mk(APP, a, b)


def alt_raw(a: Regex, b: Regex) -> Regex:
    return _mk(ALT, a, b)


def and_raw(a: Regex, b: Regex) -> Regex:
    return _mk(AND, a, b)


def range_raw(a: Regex, lo: int, hi: int) -> Regex:
    return _mk(RANGE, a, lo=lo, hi=hi)


def star_raw(a: Regex) -> Regex:
    return _mk(STAR, a)


def is_empty(r: Regex) -> bool:
    return r.tag == CHARCLASS and r.cc.is_empty()


def is_nil(r: Regex) -> bool:
    return r.tag == NIL


# ---------------------------------------------------------------------------
# nullability
# ---------------------------------------------------------------------------

def nullable(r: Regex) -> bool:
    if r._null is None:
        t = r.tag
        if t == NIL or t == STAR:
            v = True
        elif t == RANGE:
            v = r.lo == 0
        elif t in (DOT, CHARCLASS):
            v = False
        elif t in (AND, APP):
            v = nullable(r.a) and nullable(r.b)
        elif t == ALT:
            v = nullable(r.a) or nullable(r.b)
        else:
            v = False
        r._null = v
    return r._null


# ---------------------------------------------------------------------------
# partial subset order (mod.rs:128-171)
# ---------------------------------------------------------------------------

def partial_le(a: Regex, b: Regex) -> bool:
    if is_empty(a):
        return True
    if a is b:
        return True
    if a.tag == CHARCLASS and b.tag == DOT:
        return True
    if a.tag == NIL and nullable(b):
        return True
    if a.tag == RANGE and b.tag == STAR and a.lo == 0 and partial_le(a.a, b.a):
        return True
    if (a.tag == RANGE and b.tag == RANGE and partial_le(a.a, b.a)
            and a.lo >= b.lo and a.hi <= b.hi):
        return True
    if a.tag == STAR and b.tag == STAR:
        return partial_le(a.a, b.a)
    if a.tag == ALT and partial_le(a.a, b) and partial_le(a.b, b):
        return True
    if b.tag == ALT and (partial_le(a, b.a) or partial_le(a, b.b)):
        return True
    if (a.tag == APP and b.tag == APP and partial_le(a.a, b.a)
            and partial_le(b.a, a.a)):
        return partial_le(a.b, b.b)
    return False


def partial_eq(a: Regex, b: Regex) -> bool:
    return partial_le(a, b) and partial_le(b, a)


# ---------------------------------------------------------------------------
# smart constructors (mod.rs:174-299)
# ---------------------------------------------------------------------------

def dotstar() -> Regex:
    return star(dot())


def _ends_with_dotstar(r: Regex) -> bool:
    if r.tag == STAR and r.a.tag == DOT:
        return True
    return r.tag == APP and _ends_with_dotstar(r.b)


def and_(a: Regex, b: Regex) -> Regex:
    """Lookahead conjunction (?=a)b == L(a . Sigma*) INTERSECT L(b).

    The arm is suffixed with .* FIRST and every absorption rule compares
    the SUFFIXED arm: the reference applies `x & .* -> x` and the
    partial-order absorptions to the raw arm before suffixing
    (mod.rs:174-191), so `(?=c|b).*` collapsed to the single-char class
    [bc] and rejected longer matching documents (fuzz-found; we diverge
    for correctness)."""
    if is_empty(a) or is_empty(b):
        return empty()
    if b.tag == AND:
        return and_(and_(a, b.a), b.b)
    ax = a if _ends_with_dotstar(a) else app(a, dotstar())
    if partial_le(ax, b):
        return ax
    if partial_le(b, ax):
        return b
    if b.tag == STAR and b.a.tag == DOT:
        return ax
    if ax.tag == STAR and ax.a.tag == DOT:
        return b
    return _mk(AND, ax, b)


def app(a: Regex, b: Regex) -> Regex:
    if b.tag == NIL:
        return a
    if a.tag == NIL:
        return b
    if is_empty(a) or is_empty(b):
        return empty()
    # Range & star index math
    if a.tag == RANGE and partial_eq(a.a, b):
        return range_(a.a, a.lo + 1, a.hi + 1)
    if b.tag == RANGE and partial_eq(b.a, a):
        return range_(b.a, b.lo + 1, b.hi + 1)
    if a.tag == RANGE and b.tag == RANGE and partial_eq(a.a, b.a):
        return range_(a.a, a.lo + b.lo, a.hi + b.hi)
    if a.tag == STAR and b.tag == STAR:
        if partial_le(a.a, b.a):
            return b
        if partial_le(b.a, a.a):
            return a
    # And distributivity: (x & y)c == (x.*) & yc
    if a.tag == AND:
        return and_(app(a.a, dotstar()), app(a.b, b))
    # Left-associative app
    if b.tag == APP:
        return app(app(a, b.a), b.b)
    # reference "CHEAT": try to merge a's tail with b, else raw
    if a.tag == APP:
        l = app(a.b, b)
        if l.tag == APP and l.a is a.b and l.b is b:
            return _mk(APP, a, b)
        return app(a.a, l)
    return _mk(APP, a, b)


def alt(a: Regex, b: Regex) -> Regex:
    """Canonical alternation: flatten to leaves, merge char classes,
    absorb by the partial order, sort by uid, rebuild right-nested.

    The reference's rewrite pair (right-flatten + "smaller term left" swap,
    mod.rs:234-249) does not terminate under an intern-order total order:
    every rebuilt node mints a LARGER uid, so a swapped result re-triggers
    flattening forever (fuzz-found on `[a-b]*([a-b][a-b]*|[b].)`
    derivatives).  Building the canonical form in one pass preserves the
    same algebra (idempotence, class union, absorption, a stable order)
    and terminates by construction."""
    leaves: list = []
    stack = [b, a]
    while stack:
        r = stack.pop()
        if r.tag == ALT:
            stack.append(r.b)
            stack.append(r.a)
        else:
            leaves.append(r)
    ccs = [l for l in leaves if l.tag == CHARCLASS]
    rest = [l for l in leaves if l.tag != CHARCLASS]
    if ccs:
        cc = ccs[0].cc
        for o in ccs[1:]:
            cc = cc.union(o.cc)
        rest.append(charclass(cc))
    uniq: list = []
    for x in rest:
        if not any(x is y for y in uniq):
            uniq.append(x)
    kept: list = []
    for i, x in enumerate(uniq):
        drop = False
        for j, y in enumerate(uniq):
            if i == j:
                continue
            if partial_le(x, y):
                if not partial_le(y, x) or j < i:
                    drop = True    # strictly subsumed, or equivalent dup
                    break
        if not drop:
            kept.append(x)
    if not kept:
        return empty()
    if len(kept) == 1:
        return kept[0]
    kept.sort(key=lambda r: r.uid)
    out = kept[-1]
    for r in reversed(kept[:-1]):
        out = _mk(ALT, r, out)
    return out


def star(a: Regex) -> Regex:
    if a.tag in (STAR, NIL):
        return a
    if is_empty(a):
        return nil()
    if a.tag == RANGE and a.lo <= 1 <= a.hi:
        return star(a.a)
    return _mk(STAR, a)


def range_(a: Regex, lo: int, hi: int) -> Regex:
    assert lo <= hi, f"Range indices must be 0 <= {lo} <= {hi}"
    if lo == 0 and hi == 0:
        return nil()                   # X{0,0} == empty match, even X = r*
    if a.tag in (STAR, NIL):
        return a
    if lo == 1 and hi == 1:
        return a
    if is_empty(a):
        return empty()
    if lo > 0 and nullable(a):
        # a nullable body can supply empty copies, so {lo,hi} == {0,hi}
        # (e.g. (b?){2} matches "").  The reference's Range keeps lo and
        # declares Range(_, lo>0, _) non-nullable (mod.rs:284-309),
        # diverging from real regex semantics — fuzz-found.
        lo = 0
    return _mk(RANGE, a, lo=lo, hi=hi)


def not_(a: Regex) -> Regex:
    if a.tag == CHARCLASS:
        return charclass_raw(a.cc.negate())
    raise NotImplementedError(f"Negation of {a!r} not implemented")


def starplus(a: Regex, n: int) -> Regex:
    return app(range_(a, 0, n), star(a))


def alts(rs) -> Regex:
    out = empty()
    for r in reversed(list(rs)):
        out = alt(r, out)
    return out


def repeat(a: Regex, i: int) -> Regex:
    return range_(a, i, i)


def simpl(r: Regex) -> Regex:
    t = r.tag
    if t in (NIL, DOT, CHARCLASS):
        return r
    if t == APP:
        return app(simpl(r.a), simpl(r.b))
    if t == ALT:
        return alt(simpl(r.a), simpl(r.b))
    if t == STAR:
        return star(simpl(r.a))
    if t == AND:
        return and_(simpl(r.a), simpl(r.b))
    if t == RANGE:
        return range_(simpl(r.a), r.lo, r.hi)
    raise AssertionError


# ---------------------------------------------------------------------------
# derivatives + skip extraction
# ---------------------------------------------------------------------------

def _range_pred(a: Regex, lo: int, hi: int) -> Regex:
    """a{lo,hi} with one iteration consumed (mod.rs:352-361)."""
    if lo == 0 and hi == 0:
        return nil()
    if lo == 0:
        return range_(a, 0, hi - 1)
    return range_(a, lo - 1, hi - 1)


_DERIV_CACHE: dict = {}


def deriv(r: Regex, c: int) -> Regex:
    """Brzozowski derivative by codepoint c (mod.rs:392-416)."""
    key = (id(r), c)
    got = _DERIV_CACHE.get(key)
    if got is not None:
        return got
    t = r.tag
    if t == NIL:
        out = empty()
    elif t == CHARCLASS:
        out = nil() if r.cc.contains(c) else empty()
    elif t == DOT:
        out = nil()
    elif t == APP:
        if nullable(r.a):
            out = alt(app(deriv(r.a, c), r.b), deriv(r.b, c))
        else:
            out = app(deriv(r.a, c), r.b)
    elif t == ALT:
        out = alt(deriv(r.a, c), deriv(r.b, c))
    elif t == AND:
        out = and_(deriv(r.a, c), deriv(r.b, c))
    elif t == STAR:
        out = app(deriv(r.a, c), star(r.a))
    elif t == RANGE:
        if r.lo == 0 and r.hi == 0:
            out = empty()
        else:
            pred = _range_pred(r.a, r.lo, r.hi)
            if nullable(r.a):
                out = alt(app(deriv(r.a, c), pred), deriv(pred, c))
            else:
                out = app(deriv(r.a, c), pred)
    else:
        raise AssertionError
    _DERIV_CACHE[key] = out
    return out


def extract_skip(r: Regex) -> Optional[Tuple[OpenSet, Regex]]:
    """Split a leading `.`/`.{i,j}`/`.*` prefix into a Skip set + remainder
    (mod.rs:318-350).  Returns None if r has no skip prefix."""
    t = r.tag
    if t == DOT:
        return OpenSet.single(1), nil()
    if t == STAR:
        got = extract_skip(r.a)
        if got is None:
            return None
        sa, rem = got
        if is_nil(rem):
            closure = sa.kleene()
            if closure is None:        # strided star: not a skip
                return None
            return closure, nil()
        return None
    if t == RANGE:
        got = extract_skip(r.a)
        if got is None:
            return None
        sa, rem = got
        if is_nil(rem):
            return sa.repeat(r.lo, r.hi), nil()
        return None
    if t == APP:
        got = extract_skip(r.a)
        if got is None:
            return None
        pa, rema = got
        gotb = extract_skip(r.b)
        if gotb is not None and is_nil(rema):
            pb, remb = gotb
            return pa.app(pb), remb
        return pa, app(rema, r.b)
    return None


def accepts_any(r: Regex, ab) -> bool:
    return all(nullable(deriv(r, c)) for c in ab)


# ---------------------------------------------------------------------------
# derivative classes (range-compressed edges for non-enumerable alphabets)
# ---------------------------------------------------------------------------

MAX_CODEPOINT = 0x10FFFF

_BOUNDS_CACHE: dict = {}


def _char_boundaries(r: Regex) -> frozenset:
    """Codepoints where deriv(r, ·) can change: the start of every range of
    every CharClass in r, plus one-past-the-end of every closed range
    (Owens–Reppy–Turon derivative classes: between consecutive boundaries
    every class-membership test — the only way a char enters deriv — is
    constant)."""
    got = _BOUNDS_CACHE.get(r.uid)
    if got is not None:
        return got
    t = r.tag
    if t == CHARCLASS:
        bs = set()
        for a, b in r.cc.ranges:
            bs.add(a)
            if b is not None:
                bs.add(b + 1)
        out = frozenset(bs)
    elif t in (NIL, DOT):
        out = frozenset()
    elif t in (APP, ALT, AND):
        out = _char_boundaries(r.a) | _char_boundaries(r.b)
    elif t in (STAR, RANGE):
        out = _char_boundaries(r.a)
    else:
        raise AssertionError
    _BOUNDS_CACHE[r.uid] = out
    return out


def deriv_classes(r: Regex, max_cp: int = MAX_CODEPOINT):
    """Partition [0, max_cp] into maximal ranges with constant derivative:
    yields (lo, hi, deriv) with derivs hash-consed (adjacent cells whose
    derivatives intern to the same node are merged).  The alphabet is
    never enumerated — the partition size is bounded by the number of
    distinct range endpoints in r's char classes."""
    cuts = sorted({0, max_cp + 1}
                  | {b for b in _char_boundaries(r) if 0 < b <= max_cp})
    out = []
    for lo, nxt in zip(cuts, cuts[1:]):
        d = deriv(r, lo)
        if out and out[-1][2] is d and out[-1][1] + 1 == lo:
            out[-1] = (out[-1][0], nxt - 1, d)
        else:
            out.append((lo, nxt - 1, d))
    return out
