"""Regex string -> AST, with Reef's top-level anchor preprocessing.

Replaces the reference's fancy-regex/regex-syntax parser pipeline
(reference src/frontend/regex/parser.rs) with Python's own sre parser
(`re._parser`).  Behavior contracts mirrored:

  - anchor preprocessing (parser.rs:14-43): `^r$` -> r, `^r` -> r.*,
    `r$` -> .*r, `r` -> .*r.*  (anchors themselves parse to Nil);
  - lookahead folding (parser.rs:45-55): in a concatenation, `(?=a)b`
    becomes And(a, b) over the right-fold of the remainder; lookbehind
    `(?<=a)b` becomes App(a, b);
  - the parser builds RAW nodes (no smart-constructor simplification);
    `re.simpl` / `regex.simpl` normalizes afterwards, as in the reference
    (main.rs:57 `re::simpl(re::new(..))`).

Char classes use ASCII interpretations of \\d \\w \\s; a class whose top
range reaches 0x10FFFF becomes open-ended (parser.rs:100-107).
"""

from __future__ import annotations

import re as _re
import re._parser as sre

from . import regex as R
from .openset import OpenSet

MAXREPEAT = sre.MAXREPEAT
_MAX_CP = 0x10FFFF

_CATEGORY_RANGES = {
    sre.CATEGORY_DIGIT: [(ord("0"), ord("9"))],
    sre.CATEGORY_NOT_DIGIT: None,  # computed by negation
    sre.CATEGORY_WORD: [(ord("0"), ord("9")), (ord("A"), ord("Z")),
                        (ord("_"), ord("_")), (ord("a"), ord("z"))],
    sre.CATEGORY_NOT_WORD: None,
    sre.CATEGORY_SPACE: [(9, 13), (32, 32)],
    sre.CATEGORY_NOT_SPACE: None,
}
_CATEGORY_NEG = {
    sre.CATEGORY_NOT_DIGIT: sre.CATEGORY_DIGIT,
    sre.CATEGORY_NOT_WORD: sre.CATEGORY_WORD,
    sre.CATEGORY_NOT_SPACE: sre.CATEGORY_SPACE,
}


def parse(rstr: str) -> R.Regex:
    """Parse with top-level anchor preprocessing (the reference's
    RegexParser::parse + to_regex_top)."""
    tree = sre.parse(rstr)
    return _to_regex_top(list(tree))


def _is_start_anchor(item) -> bool:
    return item[0] == sre.AT and item[1] in (sre.AT_BEGINNING, sre.AT_BEGINNING_STRING)


def _is_end_anchor(item) -> bool:
    return item[0] == sre.AT and item[1] in (sre.AT_END, sre.AT_END_STRING)


def _to_regex_top(items: list) -> R.Regex:
    # unwrap a single top-level group
    while len(items) == 1 and items[0][0] == sre.SUBPATTERN:
        items = list(items[0][1][3])
    inner = _concat(items)
    if not (items and _is_start_anchor(items[0])):
        inner = R.app(R.dotstar(), inner)
    if not (items and _is_end_anchor(items[-1])):
        inner = R.app(inner, R.dotstar())
    return inner


def _concat(items: list) -> R.Regex:
    """Right-fold with lookahead handling (parser.rs try_fold_right +
    shallow_app)."""
    acc = R.nil()
    for item in reversed(items):
        acc = _shallow_app(item, acc)
    return acc


def _shallow_app(item, acc: R.Regex) -> R.Regex:
    op, av = item
    if op == sre.ASSERT:  # lookarounds: (direction, subpattern)
        direction, sub = av
        if direction >= 0:  # lookahead
            return R.and_raw(_concat(list(sub)), acc)
        return R.app_raw(_concat(list(sub)), acc)  # lookbehind, as reference
    if op == sre.SUBPATTERN:
        sub = list(av[3])
        if len(sub) == 1:
            return _shallow_app(sub[0], acc)
        return R.app_raw(_concat(sub), acc)
    return R.app_raw(_to_regex(item), acc)


def _class_from_items(items) -> OpenSet:
    ranges = []
    for it in items:
        op, av = it
        if op == sre.LITERAL:
            ranges.append((av, av))
        elif op == sre.RANGE:
            ranges.append((av[0], av[1]))
        elif op == sre.CATEGORY:
            base = _CATEGORY_RANGES.get(av)
            if base is None:
                pos = _CATEGORY_NEG.get(av)
                if pos is None:
                    raise ValueError(f"Unsupported class category {av}")
                cc = OpenSet(_CATEGORY_RANGES[pos]).negate()
                cc = cc.intersection(OpenSet.closed(0, _MAX_CP))
                ranges.extend(cc.ranges)
            else:
                ranges.extend(base)
        else:
            raise ValueError(f"Unsupported class item {op}")
    return OpenSet(ranges)


def _openify(cc: OpenSet) -> OpenSet:
    """A class reaching the max codepoint becomes open-ended
    (parser.rs:100-105)."""
    out = []
    for s, e in cc.ranges:
        if e == _MAX_CP:
            out.append((s, None))
        else:
            out.append((s, e))
    return OpenSet(out)


def _to_regex(item) -> R.Regex:
    op, av = item
    if op == sre.LITERAL:
        return R.character(av)
    if op == sre.NOT_LITERAL:
        return R.charclass(_openify(OpenSet.single(av).negate()
                                    .intersection(OpenSet.closed(0, _MAX_CP))))
    if op == sre.ANY:
        return R.dot()
    if op == sre.AT:
        return R.nil()
    if op == sre.IN:
        items = list(av)
        negate = bool(items) and items[0][0] == sre.NEGATE
        if negate:
            items = items[1:]
        cc = _class_from_items(items)
        if negate:
            cc = cc.negate().intersection(OpenSet.closed(0, _MAX_CP))
        return R.charclass(_openify(cc))
    if op == sre.BRANCH:
        # (None, [subpattern...]); right-fold raw Alt with empty init
        acc = R.empty()
        for sub in reversed(list(av[1])):
            acc = R.alt_raw(_concat(list(sub)), acc)
        return acc
    if op in (sre.MAX_REPEAT, sre.MIN_REPEAT):
        lo, hi, sub = av
        inner = _concat(list(sub))
        if lo == 0 and hi == MAXREPEAT:
            return R.star_raw(inner)
        if hi == MAXREPEAT:
            return R.app_raw(R.repeat(inner, lo), R.star_raw(inner))
        return R.range_raw(inner, lo, hi)
    if op == sre.SUBPATTERN:
        return _concat(list(av[3]))
    if op == sre.ASSERT:
        direction, sub = av
        return _concat(list(sub))
    raise ValueError(f"Unsupported regex construct: {op}")


def new(rstr: str) -> R.Regex:
    return parse(rstr)
