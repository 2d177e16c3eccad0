"""∀/∃ node tags for SAFA states (reference: src/frontend/quantifier.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class Quant:
    inner: Any
    is_and: bool

    @staticmethod
    def and_(inner) -> "Quant":
        return Quant(inner, True)

    @staticmethod
    def or_(inner) -> "Quant":
        return Quant(inner, False)

    @property
    def is_or(self) -> bool:
        return not self.is_and

    def get(self):
        return self.inner

    def negate(self) -> "Quant":
        return Quant(self.inner, not self.is_and)

    def __repr__(self):
        return ("∀ " if self.is_and else "∃ ") + repr(self.inner)
