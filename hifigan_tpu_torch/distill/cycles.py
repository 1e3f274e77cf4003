"""Batch-mixing cycle calculation (a copy of ``hifigan_tpu/distill/cycles.py``).

Capability parity with reference speech_distillation/cycle_calculator.py —
given batch size ``a`` and total mix size ``b``, produce cycle segment
lengths ``(c_1..c_n)`` such that rolling segment ``i`` (1-based) by ``i``
positions yields an invertible "mixing" permutation where every mixed item
is paired with a *different* item. Validity contract (cycle_calculator.py:5-18):

  sum(c) == b;  c_i >= min_cycle;  c_i > i;  c_i <= a;
  not (c_i % i == 0 and c_i // i < min_cycle)

The reference finds a solution by brute-force remainder redistribution; we
use a simpler deterministic search satisfying the same contract (the choice
among valid tuples is unconstrained — any valid tuple gives an invertible,
derangement-like mix).
"""

from __future__ import annotations


def cycles_valid(cycles, a: int, b: int, min_cycle: int = 3) -> bool:
    """The reference's validity predicate (cycle_calculator.py:5-18)."""
    if sum(cycles) != b:
        return False
    for index, cycle in enumerate(cycles):
        index = index + 1
        if cycle < min_cycle:
            return False
        if cycle <= index:
            return False
        if cycle > a:
            return False
        if cycle % index == 0 and cycle // index < min_cycle:
            return False
    return True


def _feasible(a: int, b: int, min_cycle: int) -> bool:
    assert a >= min_cycle
    common_divisors = [a % cycle == 0 for cycle in range(2, min_cycle)].count(True)
    return a * a - a - common_divisors >= b


def calculate_cycles(a: int, b: int, min_cycle: int = 3) -> tuple[int, ...]:
    """Find a valid cycle tuple for (batch=a, mix=b) or raise AssertionError."""
    assert a >= min_cycle
    assert _feasible(a, b, min_cycle), "Cycle sequence could not be calculated!"

    max_n = min(b // min_cycle, a - 1)
    for n in range(1, max_n + 1):
        # candidate values per position i (1-based): the contract per slot
        def slot_ok(i: int, c: int) -> bool:
            return (
                min_cycle <= c <= a
                and c > i
                and not (c % i == 0 and c // i < min_cycle)
            )

        # depth-first search, preferring large cycles first (fewer segments
        # of near-batch size, like the reference's fill-with-a strategy)
        def dfs(i: int, remaining: int, acc: list[int]):
            if i > n:
                return acc if remaining == 0 else None
            slots_left = n - i
            for c in range(min(a, remaining - slots_left * min_cycle), min_cycle - 1, -1):
                if not slot_ok(i, c):
                    continue
                if remaining - c < (slots_left) * min_cycle and slots_left > 0:
                    continue
                if slots_left == 0 and remaining != c:
                    continue
                got = dfs(i + 1, remaining - c, acc + [c])
                if got is not None:
                    return got
            return None

        got = dfs(1, b, [])
        if got is not None and cycles_valid(got, a, b, min_cycle):
            return tuple(got)
    raise AssertionError("Cycle sequence could not be calculated!")
