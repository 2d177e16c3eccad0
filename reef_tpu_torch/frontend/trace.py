"""Matching traces: the solver's output path (reference: src/trace.rs).

A TraceElem records one edge taken: (from_node, edge, to_node, from_cur,
to_cur).  Edges are the SAFA edge labels: ("c", codepoint) for a character
step, ("r", OpenSet-of-codepoints) for a char-CLASS step (full-unicode
alphabets compress the per-char derivative edges into ranges; the table
encodes them as (char_lo, char_hi) rows with an in-circuit range check),
or ("s", OpenSet) for a skip/epsilon step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from .openset import OpenSet


@dataclass(frozen=True)
class TraceElem:
    from_node: int
    edge: Tuple[str, object]
    to_node: int
    from_cur: int
    to_cur: int

    @property
    def is_char(self) -> bool:
        return self.edge[0] == "c"

    @property
    def is_class(self) -> bool:
        return self.edge[0] == "r"

    @property
    def consumes(self) -> bool:
        """True for edges that consume exactly one document char."""
        return self.edge[0] in ("c", "r")

    @property
    def is_skip(self) -> bool:
        return self.edge[0] == "s"

    def is_nil(self) -> bool:
        return self.is_skip and self.edge[1].is_nil()

    def sort_key(self):
        # reference TraceElem Ord compares to_node only (trace.rs:52-62)
        return self.to_node

    def __repr__(self):
        lbl = chr(self.edge[1]) if self.is_char else repr(self.edge[1])
        return (f"{{{self.from_node} -[{lbl}]-> {self.to_node} "
                f"@ Doc[{self.from_cur}-{self.to_cur}]}}")


Trace = List[TraceElem]


def char_edge(c: int) -> Tuple[str, int]:
    return ("c", c)


def class_edge(cc: OpenSet) -> Tuple[str, OpenSet]:
    """One consuming edge for a whole derivative class (range-compressed)."""
    return ("r", cc)


def skip_edge(s: OpenSet) -> Tuple[str, OpenSet]:
    return ("s", s)


def epsilon() -> Tuple[str, OpenSet]:
    return ("s", OpenSet.nil())
