"""DNF sets for Antimirov derivatives (reference: src/frontend/regex/dnf.rs).

`OrSet` is a set of conjunctions (`AndSet`s) of regex terms — disjunctive
normal form over hash-consed regexes, keyed by intern uid."""

from __future__ import annotations

from typing import Callable, FrozenSet, Iterable

from . import regex as R


class OrSet:
    """Frozen set of AndSets (each a frozenset of Regex terms)."""

    __slots__ = ("sets",)

    def __init__(self, sets: Iterable[FrozenSet] = ()):
        self.sets = frozenset(sets)

    @staticmethod
    def empty() -> "OrSet":
        return OrSet()

    @staticmethod
    def single(r: R.Regex) -> "OrSet":
        return OrSet([frozenset([r])])

    def or_(self, o: "OrSet") -> "OrSet":
        return OrSet(self.sets | o.sets)

    def and_(self, o: "OrSet") -> "OrSet":
        return OrSet([a | b for a in self.sets for b in o.sets])

    def map(self, fn: Callable[[R.Regex], R.Regex]) -> "OrSet":
        return OrSet([frozenset(fn(r) for r in a) for a in self.sets])

    def flatten(self) -> R.Regex:
        """Collapse to a single regex: OR of ANDs."""
        terms = []
        for a in sorted(self.sets, key=lambda s: sorted(x.uid for x in s)):
            rs = sorted(a, key=lambda x: x.uid)
            conj = rs[0]
            for r in rs[1:]:
                conj = R.and_(conj, r)
            terms.append(conj)
        return R.alts(terms)

    def __eq__(self, o):
        return isinstance(o, OrSet) and self.sets == o.sets

    def __hash__(self):
        return hash(self.sets)

    def __repr__(self):
        return "OrSet(%r)" % (self.sets,)


def aderiv(r: R.Regex, c: int) -> OrSet:
    """Generalized Antimirov derivative (regex/mod.rs:364-390)."""
    t = r.tag
    if t == R.NIL:
        return OrSet.empty()
    if t == R.CHARCLASS:
        return OrSet.single(R.nil()) if r.cc.contains(c) else OrSet.empty()
    if t == R.DOT:
        return OrSet.single(R.nil())
    if t == R.APP:
        if R.nullable(r.a):
            return aderiv(r.a, c).map(lambda x: R.app(x, r.b)) \
                .or_(aderiv(r.b, c))
        return aderiv(r.a, c).map(lambda x: R.app(x, r.b))
    if t == R.ALT:
        return aderiv(r.a, c).or_(aderiv(r.b, c))
    if t == R.AND:
        return aderiv(r.a, c).and_(aderiv(r.b, c))
    if t == R.STAR:
        return aderiv(r.a, c).map(lambda x: R.app(x, r))
    if t == R.RANGE:
        if r.lo == 0 and r.hi == 0:
            return OrSet.empty()
        pred = R._range_pred(r.a, r.lo, r.hi)
        if R.nullable(r.a):
            return aderiv(r.a, c).map(lambda x: R.app(x, pred)) \
                .or_(aderiv(pred, c))
        return aderiv(r.a, c).map(lambda x: R.app(x, pred))
    raise AssertionError
