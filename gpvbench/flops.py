"""Work counted from shapes, for any model: the arithmetic of a product
(`_mm`, `_mha`), a convolution's output size (`_out`), one kernel's work
item (`Launch`: its bytes and operations), and the least device time of a
list of work items at the card's peaks (`launches_bound_ms`).

What a model's calls are made of is its family's (`counts/<family>.py`,
found through `family.counts`): the model FLOPs of its calls and its
kernels' work items.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

from .peaks import bound


def _out(n: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def _mm(m, k, n) -> float:
    return 2.0 * m * k * n


def _mha(tq, tk, d) -> float:
    """Projections, both attention products and the output projection."""
    return _mm(tq, d, d) * 2 + _mm(tk, d, d) * 2 + 2 * _mm(tq, tk, d)


class Launch(NamedTuple):
    name: str
    b: int
    tq: int
    tk: int
    heads: int
    dh: int
    masked: bool       # a (b, tk) key validity is read
    calls: int
    both: bool = False  # K2: both directions in one launch (tq x tk, tk x tq)

    def bytes(self, elt: int = 2) -> float:
        if self.both:  # six inputs, both contexts written, two masks read
            n = (3 * self.tk + 3 * self.tq + self.tq + self.tk)
            return (self.b * n * self.heads * self.dh * elt
                    + (self.b * self.tk if self.masked else 0))
        return ((2 * self.tq + 2 * self.tk) * self.b * self.heads * self.dh
                * elt + (self.b * self.tk if self.masked else 0))

    def flops(self) -> float:
        f = 4.0 * self.b * self.heads * self.tq * self.tk * self.dh
        return 2 * f if self.both else f


def launches_bound_ms(launches: Sequence, dtype: str = "bfloat16") -> float:
    """The least device ms of a call's work items: each item's `calls`
    times its bytes (`bytes(elt)`) or operations (`flops()`) at the card's
    peak, whichever takes longer."""
    elt = 2 if dtype == "bfloat16" else 4
    return sum(x.calls * bound(x.bytes(elt), x.flops(), dtype)["bound_ms"]
               for x in launches)
