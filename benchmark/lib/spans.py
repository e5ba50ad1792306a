"""Host spans recorded by the benchmark around its calls into the program.

A span is (name, start, end) on ``time.time_ns()``, the clock that
``torch.profiler``'s events carry, so a traced run can put device events
and host spans side by side. Spans nest; each keeps its depth. Recording
one costs two clock reads and an append.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import List, Tuple


class Spans:
    """Spans of one run, in memory."""

    def __init__(self):
        self.records: List[Tuple[str, int, int, int]] = []
        self._depth = 0

    @contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            self.records.append((name, self._depth, t0, time.time_ns()))

    def clear(self) -> None:
        self.records.clear()

    def durations_ms(self, name: str) -> List[float]:
        """Every duration of span ``name``, in ms, in the order they ended."""
        return [(t1 - t0) / 1e6 for n, _, t0, t1 in self.records
                if n == name]

