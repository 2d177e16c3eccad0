"""Whether a document matches a regex, by Python's `re`: the statement
that a proof claims.  The benchmark's regexes are anchored at the start
(`^`) and end in `.*`, where `re.search` and the proof system's
whole-document match agree; `.` takes every byte (DOTALL)."""

from __future__ import annotations

import re


def matches(regex: str, doc: bytes) -> bool:
    return re.search(regex, doc.decode("latin-1"), re.DOTALL) is not None
