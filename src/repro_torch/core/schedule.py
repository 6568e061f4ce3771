"""The one bucket schedule driving the peel (exact + Alg. 2 approx).

Counterpart of ``repro.core.schedule``.  The port drives its peel rounds
from the host, so the schedule is plain Python over ints: the carry is a
triple ``(bucket index, rounds in bucket, level)`` and ``next_level`` takes
the round's minimum live degree as an int.

exact:  the level is the running max of the current minimum degree.
approx: geometric buckets with upper bound floor((C(s,r)+delta)(1+delta)^(i+1))
        and a per-bucket round cap of ceil(log n / log(1 + delta/C(s,r)))
        rounds (Alg. 2 line 17).  The power (1+delta)^(i+1) is taken in
        float64 from the float32 base and rounded once to float32, then
        multiplied by float32 Cb and floored, saturating at 2^31-1: that
        matches the reference's XLA float32 ``pow`` at every bucket index
        tested (0..399 for C(s,r) in {1,3,4,6}, delta in {0.1,0.5,1.0}),
        where numpy's float32 ``power`` is one ulp off often enough that the
        floor differs from index 37 on (delta=0.5; 116 for C=3, delta=0.1).
"""
from __future__ import annotations

import dataclasses
from math import log
from typing import Tuple

import numpy as np

Carry = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class PeelSchedule:
    """Static bucket schedule. exact: level tracks the running min.
    approx: geometric buckets (C(s,r)+delta)(1+delta)^i with a round cap."""

    kind: str  # "exact" | "approx"
    s_choose_r: int = 1
    delta: float = 0.1
    n: int = 1

    def init_carry(self) -> Carry:
        # (bucket index i, rounds_in_bucket, current level)
        return (0, 0, 0)

    def cap(self) -> int:
        return max(1, int(np.ceil(log(max(self.n, 2))
                                  / log(1.0 + self.delta / self.s_choose_r))))

    def upper(self, ix: int) -> int:
        """floor(Cb * (1+delta)^(ix+1)) in float32, as the reference."""
        cb = np.float32(self.s_choose_r + self.delta)
        base = np.float64(np.float32(1.0 + self.delta))
        with np.errstate(over="ignore"):
            v = np.floor(cb * np.float32(base ** (ix + 1)))
        return int(min(float(v), 2 ** 31 - 1))

    def next_level(self, sched: Carry, dmin: int) -> Tuple[Carry, int]:
        """Advance the carry for one round; returns (carry, peel level).

        The returned level always satisfies level >= dmin, so the clique
        attaining the minimum degree is peelable every round.
        """
        i, rib, level = sched
        if self.kind == "exact":
            level = max(level, int(dmin))
            return (i, rib, level), level
        cap = self.cap()
        # advance buckets until dmin fits and the round cap is not exceeded
        while dmin > self.upper(i) or rib >= cap:
            i, rib = i + 1, 0
        level = self.upper(i)
        return (i, rib + 1, level), level
