"""The one traffic generator: a configuration's documents and a mix's
cycles of requests, all drawn from the run's seed.

A configuration gives the document: `doc_bytes` bytes drawn uniformly
from `fill`, ending in `motif`.  A mix (`traffic/<name>.json`) gives:

- `roles`: the requests of one cycle, in order (`commit`, `prove`,
  `verify`);
- `new_doc`: true when each cycle commits a document of its own; false
  when one document is committed in set-up and every cycle proves
  against it;
- `query`: `suffix`, the motif where the document ends
  (`^.{n-m}MOTIF.*`), or `substring`, the m bytes of the document at a
  seeded offset, no offset twice in a run (`^.{off}MOTIF.*`);
- `warmup_cycles`: the cycles of set-up, of the window's shape on seeds
  the window never uses.

Every seed gives the same sizes and the same number of requests per
cycle; only the bytes, the offsets and the commitment seeds move.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List

import numpy as np

MASK64 = (1 << 64) - 1
# stream tags of the seed sequence
DOC, WARM, QUERY, COMMIT, SHARED = 1, 2, 3, 4, 5


@dataclass
class Cycle:
    index: int                  # -1, -2, ...: set-up's cycles
    doc_key: tuple              # the stream the document is drawn from
    regex: str
    commit_seed: int            # the CLI's --seed of this cycle's commit
    roles: List[str]


class Traffic:
    def __init__(self, config: dict, mix: dict, seed: int):
        self.config, self.mix = config, mix
        self.seed = seed & MASK64
        self.n = int(config["doc_bytes"])
        self.motif = config["motif"]
        if not re.fullmatch(r"[A-Za-z0-9]+", self.motif):
            raise ValueError("the motif must be letters and digits")
        if mix["query"] not in ("suffix", "substring"):
            raise ValueError(f"unknown query kind {mix['query']!r}")
        self._used: set = set()
        self._doc: tuple = ((), b"")
        self._queries = self._rng(QUERY)
        warm = self._rng(WARM)
        self._warm_offs = [self._offset(warm)
                           for _ in range(int(mix["warmup_cycles"]))]

    def _rng(self, *tags) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            [self.seed, *tags]))

    def _draw_seed(self, *tags) -> int:
        return int(self._rng(*tags).integers(0, 1 << 62))

    def document(self, key: tuple) -> bytes:
        if self._doc[0] != key:
            fill = np.frombuffer(self.config["fill"].encode(),
                                 dtype=np.uint8)
            body = fill[self._rng(*key).integers(0, len(fill),
                                                 self.n - len(self.motif))]
            self._doc = (key, body.tobytes() + self.motif.encode())
        return self._doc[1]

    def _offset(self, rng: np.random.Generator) -> int:
        while True:
            off = int(rng.integers(1, self.n - len(self.motif) + 1))
            if off not in self._used:
                self._used.add(off)
                return off

    def _regex(self, key: tuple, off: int) -> str:
        if self.mix["query"] == "suffix":
            return f"^.{{{self.n - len(self.motif)}}}{self.motif}.*"
        q = self.document(key)[off:off + len(self.motif)].decode()
        return f"^.{{{off}}}{q}.*"

    def _cycle(self, index: int, tag: int, off: int) -> Cycle:
        tags = (tag, index & MASK64)
        key = (DOC,) + tags if self.mix["new_doc"] else (SHARED,)
        return Cycle(index, key, self._regex(key, off),
                     self._draw_seed(COMMIT, *tags), list(self.mix["roles"]))

    def setup_commit(self) -> Cycle:
        """The commitment of the shared document (mixes without
        `new_doc`): made in set-up, before the warm-up cycles."""
        return Cycle(-1, (SHARED,), "", self._draw_seed(COMMIT, SHARED),
                     ["commit"])

    def warmup(self) -> List[Cycle]:
        """The set-up's cycles, numbered -1, -2, ..."""
        return [self._cycle(-1 - k, WARM, off)
                for k, off in enumerate(self._warm_offs)]

    def cycle(self, index: int) -> Cycle:
        off = (self._offset(self._queries)
               if self.mix["query"] == "substring" else 0)
        return self._cycle(index, DOC, off)
